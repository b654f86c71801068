"""Deterministic hash-projection embedder — offline stand-in for Nomic Embed.

The paper embeds with nomic-embed-text-v1.5 truncated to 128 dims
(Matryoshka).  That model is unavailable offline, so the framework ships a
deterministic embedder with the properties the paper's algebra and behavioral
suites actually rely on:

* fixed-length L2-normalized vectors,
* Matryoshka-style truncation (any prefix of dims is a valid embedding),
* token overlap => higher cosine similarity (bag of hashed token vectors),
* full determinism across processes (blake2b-seeded Gaussian directions).

DESIGN.md records this as a changed assumption: algebraic correctness is
embedder-independent; behavioral metrics are validated in direction/band.
"""

from __future__ import annotations

import hashlib
import re
from functools import lru_cache
from typing import List, Sequence

import numpy as np

_TOKEN_RE = re.compile(r"[a-z0-9]+")
_FULL_DIM = 256  # pre-truncation dimension (Matryoshka parent space)


def _token_seed(token: str, salt: str) -> int:
    digest = hashlib.blake2b(
        f"{salt}\x00{token}".encode("utf-8"), digest_size=8
    ).digest()
    return int.from_bytes(digest, "little")


@lru_cache(maxsize=1 << 16)
def _token_vector(token: str, salt: str, full_dim: int) -> np.ndarray:
    rng = np.random.Generator(np.random.PCG64(_token_seed(token, salt)))
    v = rng.standard_normal(full_dim).astype(np.float32)
    # Matryoshka-style importance taper: earlier dims carry more signal, so
    # truncation keeps most of the norm (mirrors MRL training incentives).
    taper = (1.0 / np.sqrt(1.0 + np.arange(full_dim) / 64.0)).astype(np.float32)
    return v * taper


class HashEmbedder:
    """text -> (dim,) float32 unit vector. Callable; batch via embed_batch."""

    def __init__(self, dim: int = 128, salt: str = "flexvec", full_dim: int = _FULL_DIM):
        if dim > full_dim:
            raise ValueError(f"dim {dim} exceeds parent space {full_dim}")
        self.dim = dim
        self.salt = salt
        self.full_dim = full_dim

    def tokens(self, text: str) -> List[str]:
        return _TOKEN_RE.findall(text.lower())

    def embed_full(self, text: str) -> np.ndarray:
        toks = self.tokens(text)
        if not toks:
            return np.zeros(self.full_dim, dtype=np.float32)
        acc = np.zeros(self.full_dim, dtype=np.float32)
        for t in toks:
            acc += _token_vector(t, self.salt, self.full_dim)
        return acc

    def __call__(self, text: str) -> np.ndarray:
        return self.truncate(self.embed_full(text), self.dim)

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        for i, t in enumerate(texts):
            out[i] = self(t)
        return out

    @staticmethod
    def truncate(full: np.ndarray, dim: int) -> np.ndarray:
        """Matryoshka truncation: take a prefix, renormalize."""
        v = np.asarray(full, dtype=np.float32)[..., :dim]
        nrm = np.sqrt((v * v).sum(axis=-1, keepdims=True))
        return np.where(nrm > 1e-12, v / np.maximum(nrm, 1e-12), v)
