"""The benchmark's corpus: a vectorised copy of the port's synthetic
coding-session generator (``repro_torch/data/corpus.py``) and of its
hash embedder (``repro_torch/embed/hashing.py``).

The shares are the generator's: the same topic vocabularies, the same
weights over the descriptive, implementation and neutral clusters, the
same chunk-type shares, the same words a chunk draws from its topic,
from the query-overlap words and from its cluster's shared words, and
the same session structure (``n // sessions`` chunks a session, 30 s
apart, the session's start uniform over ``days``).  The draws are made
column by column with NumPy instead of chunk by chunk, so the rows differ
from the port's for one seed while their distribution is the same
(``perfbench/tests`` holds the shares to the port's generator).

An embedding is the sum of the hashed token vectors of a chunk's words,
truncated to ``dim`` and L2-normalised, as ``HashEmbedder`` computes it;
here the sum is one product of a (rows, vocabulary) count matrix with the
(vocabulary, dim) token table.  Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
from functools import lru_cache
from typing import Dict, List, Optional

import numpy as np

SECONDS_PER_DAY = 86400.0
_TOKEN_RE = re.compile(r"[a-z0-9]+")
FULL_DIM = 256
SALT = "flexvec"

OVERLAP = ["system", "works", "architecture", "how", "the", "overview"]
DESCRIPTIVE_SHARED = [
    "website", "landing", "page", "design", "tagline",
    "documentation", "readme", "community", "post", "draft", "copy",
]
IMPLEMENTATION_SHARED = ["implementation", "internal", "logic", "code"]
DESCRIPTIVE_TOPICS = [
    ("ui_style", ["website", "landing", "page", "design", "style", "layout", "css", "iteration"]),
    ("tagline", ["marketing", "tagline", "draft", "copy", "headline", "brand", "positioning"]),
    ("docs_site", ["documentation", "readme", "site", "structure", "guide", "tutorial"]),
    ("positioning", ["product", "positioning", "discussion", "market", "pitch", "story"]),
    ("community", ["community", "post", "announcement", "launch", "blog", "share"]),
]
IMPLEMENTATION_TOPICS = [
    ("identity", ["identity", "layer", "data", "model", "uuid", "provenance", "tracking"]),
    ("server", ["server", "lifecycle", "debugging", "restart", "socket", "operations"]),
    ("worker", ["background", "worker", "failure", "analysis", "queue", "retry"]),
    ("rendering", ["rendering", "pipeline", "implementation", "frame", "buffer", "draw"]),
    ("platform", ["platform", "detection", "branching", "logic", "linux", "darwin"]),
]
NEUTRAL_TOPICS = [
    ("auth", ["auth", "token", "jwt", "login", "session", "oauth", "refresh"]),
    ("database", ["database", "sqlite", "storage", "schema", "migration", "index"]),
    ("search", ["search", "retrieval", "embedding", "vector", "score", "ranking"]),
    ("testing", ["test", "pytest", "assert", "fixture", "coverage", "mock"]),
    ("deploy", ["deploy", "release", "docker", "build", "publish", "version"]),
    ("files", ["file", "path", "snapshot", "diff", "edit", "patch"]),
]
CLUSTERS = [("descriptive", DESCRIPTIVE_TOPICS),
            ("implementation", IMPLEMENTATION_TOPICS),
            ("neutral", NEUTRAL_TOPICS)]
CLUSTER_WEIGHTS = (0.42, 0.13, 0.45)
PROJECTS = ["core", "website", "cli", "infra"]
TOOLS = ["read", "edit", "bash", "grep", "write"]
CHUNK_TYPES = ["user_prompt", "assistant", "tool_call", "file"]
TYPE_WEIGHTS = (0.2, 0.45, 0.25, 0.1)
ASSISTANT_REPEATS = 4   # assistant bodies are their words four times over

TOPICS = [t for _, topics in CLUSTERS for t in topics]
TOPIC_CLUSTER = np.asarray([c for c, (_, topics) in enumerate(CLUSTERS)
                            for _ in topics])
VOCAB: List[str] = sorted({w for _, words in TOPICS for w in words}
                          | set(OVERLAP) | set(DESCRIPTIVE_SHARED)
                          | set(IMPLEMENTATION_SHARED))
WORD_ID = {w: i for i, w in enumerate(VOCAB)}


# -- the embedder (a copy of repro_torch/embed/hashing.py) -------------------


def _token_seed(token: str, salt: str) -> int:
    digest = hashlib.blake2b(f"{salt}\x00{token}".encode("utf-8"),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little")


@lru_cache(maxsize=1 << 16)
def token_vector(token: str, salt: str = SALT,
                 full_dim: int = FULL_DIM) -> np.ndarray:
    rng = np.random.Generator(np.random.PCG64(_token_seed(token, salt)))
    v = rng.standard_normal(full_dim).astype(np.float32)
    taper = (1.0 / np.sqrt(1.0 + np.arange(full_dim) / 64.0)).astype(np.float32)
    return v * taper


def truncate(full: np.ndarray, dim: int) -> np.ndarray:
    v = np.asarray(full, dtype=np.float32)[..., :dim]
    nrm = np.sqrt((v * v).sum(axis=-1, keepdims=True))
    return np.where(nrm > 1e-12, v / np.maximum(nrm, 1e-12), v)


def embed(text: str, dim: int) -> np.ndarray:
    """text -> (dim,) float32: the hashed token vectors summed in token
    order in float32, truncated, normalised (``HashEmbedder.__call__``)."""
    acc = np.zeros(FULL_DIM, dtype=np.float32)
    for t in _TOKEN_RE.findall(text.lower()):
        acc += token_vector(t)
    return truncate(acc, dim)


def token_table(dim: int) -> np.ndarray:
    """(len(VOCAB), dim) float32: each word's vector's first ``dim``."""
    return np.stack([token_vector(w)[:dim] for w in VOCAB])


# -- the generator -----------------------------------------------------------


@dataclasses.dataclass
class Corpus:
    """Rows as arrays: ``ids`` (n,), ``matrix`` (n, dim) float32 unit rows,
    ``timestamps`` (n,) float64; the chunk metadata the SQL store holds
    (``session`` (n,), ``ctype``, ``topic``, ``position``, the sessions'
    ``projects``); ``words`` (n, slots) word ids, -1 past a row's end,
    for the rows' text."""

    ids: np.ndarray
    matrix: np.ndarray
    timestamps: np.ndarray
    session: np.ndarray
    position: np.ndarray
    ctype: np.ndarray
    topic: np.ndarray
    projects: np.ndarray
    words: np.ndarray
    tool: np.ndarray
    file_no: np.ndarray

    @property
    def n(self) -> int:
        return int(self.ids.size)


def _draw_slots(rng, n: int, lo: int, hi: int, pool: np.ndarray,
                pool_len: np.ndarray) -> np.ndarray:
    """(n, hi - 1) word ids: a count uniform on [lo, hi) a row, each word
    uniform over the row's pool (``pool`` (n, w) padded, ``pool_len``
    (n,)); -1 past the count."""
    width = hi - 1
    count = rng.integers(lo, hi, n)
    pick = (rng.random((n, width)) * pool_len[:, None]).astype(np.int64)
    out = np.take_along_axis(pool, pick, axis=1)
    out[np.arange(width)[None, :] >= count[:, None]] = -1
    return out


def _padded(lists) -> np.ndarray:
    width = max(len(x) for x in lists)
    out = np.full((len(lists), width), -1, np.int64)
    for i, x in enumerate(lists):
        out[i, :len(x)] = [WORD_ID[w] for w in x]
    return out


def generate(n: int, n_sessions: int, days: float, seed: int, now: float,
             dim: int, *, block: int = 1 << 17) -> Corpus:
    """``n`` chunks in ``n_sessions`` sessions over ``days`` days before
    ``now``, from ``seed``."""
    rng = np.random.default_rng([int(seed), 0])
    per = max(1, n // n_sessions)
    counts = np.full(n_sessions, per, np.int64)
    counts[:max(0, n - per * n_sessions)] += 1
    session = np.repeat(np.arange(n_sessions), counts)[:n]
    starts = np.searchsorted(session, np.arange(n_sessions))
    position = np.arange(n) - starts[session]
    projects = rng.integers(len(PROJECTS), size=n_sessions)
    t0 = now - rng.uniform(0.0, days * SECONDS_PER_DAY, n_sessions)
    timestamps = t0[session] + position * 30.0

    cluster = rng.choice(3, size=n, p=CLUSTER_WEIGHTS)
    n_in = np.asarray([len(t) for _, t in CLUSTERS])
    first = np.concatenate([[0], np.cumsum(n_in)[:-1]])
    topic = first[cluster] + (rng.random(n) * n_in[cluster]).astype(np.int64)
    ctype = rng.choice(4, size=n, p=TYPE_WEIGHTS)
    tool = rng.integers(len(TOOLS), size=n)
    file_no = rng.integers(20, size=n)

    vocab = _padded([w for _, w in TOPICS])
    vlen = np.asarray([len(w) for _, w in TOPICS])
    topic_words = _draw_slots(rng, n, 6, 14, vocab[topic], vlen[topic])
    overlap = _padded([OVERLAP])[0]
    grouped = cluster < 2
    lo = np.where(grouped, 2, 0)
    hi = np.where(grouped, 5, 2)
    ov_count = lo + (rng.random(n) * (hi - lo)).astype(np.int64)
    ov = overlap[(rng.random((n, 4)) * overlap.size).astype(np.int64)]
    ov[np.arange(4)[None, :] >= ov_count[:, None]] = -1
    shared = _padded([DESCRIPTIVE_SHARED, IMPLEMENTATION_SHARED, ["the"]])
    slen = np.asarray([len(DESCRIPTIVE_SHARED), len(IMPLEMENTATION_SHARED), 1])
    sh_lo = np.asarray([4, 1, 0])[cluster]
    sh_hi = np.asarray([9, 3, 0])[cluster]
    sh_count = sh_lo + (rng.random(n) * (sh_hi - sh_lo)).astype(np.int64)
    sh = np.take_along_axis(
        shared[cluster],
        (rng.random((n, 8)) * slen[cluster][:, None]).astype(np.int64),
        axis=1)
    sh[np.arange(8)[None, :] >= sh_count[:, None]] = -1
    words = np.concatenate([topic_words, ov, sh], axis=1)
    # a chunk's words in a random order, the unused slots last
    key = rng.random(words.shape) + (words < 0)
    words = np.take_along_axis(words, np.argsort(key, axis=1), axis=1)

    table = token_table(dim)
    reps = np.where(ctype == CHUNK_TYPES.index("assistant"),
                    ASSISTANT_REPEATS, 1).astype(np.float32)
    matrix = np.empty((n, dim), np.float32)
    v = len(VOCAB)
    for a in range(0, n, block):
        w = words[a:a + block]
        rows = np.repeat(np.arange(w.shape[0]), w.shape[1])
        flat = w.reshape(-1)
        ok = flat >= 0
        cnt = np.bincount(rows[ok] * v + flat[ok],
                          minlength=w.shape[0] * v).astype(np.float32)
        cnt = cnt.reshape(w.shape[0], v) * reps[a:a + block, None]
        matrix[a:a + block] = truncate(cnt @ table, dim)
    return Corpus(ids=np.arange(n, dtype=np.int64), matrix=matrix,
                  timestamps=timestamps, session=session, position=position,
                  ctype=ctype, topic=topic, projects=projects, words=words,
                  tool=tool, file_no=file_no)


def texts(corpus: Corpus) -> List[str]:
    """Each chunk's content, as the port's generator writes it."""
    vocab = np.asarray(VOCAB, dtype=object)
    out = []
    rep = CHUNK_TYPES.index("assistant")
    for row, t in zip(corpus.words, corpus.ctype):
        body = " ".join(vocab[row[row >= 0]])
        out.append(" ".join([body] * ASSISTANT_REPEATS) if t == rep else body)
    return out


def sql_rows(corpus: Corpus) -> Dict[str, list]:
    """``chunks``: (id, session_id, type, content, created_at, position,
    project, tool_name, file, ext) rows; ``sources``: (session_id, project,
    title, start_time, end_time, message_count) rows."""
    content = texts(corpus)
    sid = [f"s{s:06d}" for s in range(corpus.projects.size)]
    chunks = []
    tool_t = CHUNK_TYPES.index("tool_call")
    file_t = CHUNK_TYPES.index("file")
    for i in range(corpus.n):
        s = int(corpus.session[i])
        t = int(corpus.ctype[i])
        tname = TOPICS[int(corpus.topic[i])][0]
        fpath = (f"src/{tname}/{tname}_{int(corpus.file_no[i])}.py"
                 if t == file_t else None)
        chunks.append((i, sid[s], CHUNK_TYPES[t], content[i],
                       float(corpus.timestamps[i]), int(corpus.position[i]),
                       PROJECTS[int(corpus.projects[s])],
                       TOOLS[int(corpus.tool[i])] if t == tool_t else None,
                       fpath, "py" if fpath else None))
    first = np.searchsorted(corpus.session, np.arange(len(sid)))
    last = np.searchsorted(corpus.session, np.arange(len(sid)), side="right")
    sources = [(sid[s], PROJECTS[int(corpus.projects[s])], f"session {sid[s]}",
                float(corpus.timestamps[first[s]]),
                float(corpus.timestamps[last[s] - 1]), int(last[s] - first[s]))
               for s in range(len(sid)) if last[s] > first[s]]
    return {"chunks": chunks, "sources": sources}


def tombstones(n: int, share: float, seed: int) -> np.ndarray:
    """(n,) bool, True = live: ``share`` of the rows deleted, from ``seed``."""
    return np.random.default_rng([int(seed), 3]).random(n) >= share


def segment_bounds(n: int, cuts: List[float]) -> List[tuple]:
    """Row ranges of the segments cut at the cumulative shares ``cuts``."""
    edges = [0] + [int(round(n * c)) for c in cuts]
    return list(zip(edges[:-1], edges[1:]))


def topic_words(cluster: Optional[str] = None) -> List[List[str]]:
    """Each topic's vocabulary, of one cluster or of all."""
    return [words for c, topics in CLUSTERS if cluster in (None, c)
            for _, words in topics]
