"""Synthetic production corpus — AI coding session history (paper §1).

Mirrors the paper's production corpus structurally: chunks (user_prompt /
assistant / tool_call / file) grouped into sessions with project, timestamps,
tool names and file paths. Content is generated from topic vocabularies with
a deliberately *dominant descriptive cluster* and a *buried implementation
cluster* sharing vocabulary — the structure §5.1's suppression case study
depends on.
"""

from __future__ import annotations

import dataclasses
import sqlite3
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.embed import HashEmbedder
from repro_torch.sqlio import schema as schema_mod
from repro_torch.sqlio.presets import register_presets

# Topic vocabularies. 'overlap' words appear in both clusters (and in the
# §5.1 query), which is exactly why baseline cosine cannot separate them.
_OVERLAP = ["system", "works", "architecture", "how", "the", "overview"]

# Words shared ACROSS descriptive topics (marketing copy and docs genuinely
# share vocabulary); this intra-cluster correlation is what lets the two
# suppress: directions of §5.1 cover the whole descriptive cluster, the same
# way a real embedding space correlates same-genre content.
_DESCRIPTIVE_SHARED = [
    "website", "landing", "page", "design", "tagline",
    "documentation", "readme", "community", "post", "draft", "copy",
]
_IMPLEMENTATION_SHARED = ["implementation", "internal", "logic", "code"]

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

PROJECTS = ["core", "website", "cli", "infra"]
TOOLS = ["read", "edit", "bash", "grep", "write"]
CHUNK_TYPES = ["user_prompt", "assistant", "tool_call", "file"]
# Descriptive cluster is LARGER (paper: 'the descriptive cluster is typically
# larger') — weights over (descriptive, implementation, neutral).
CLUSTER_WEIGHTS = (0.42, 0.13, 0.45)


@dataclasses.dataclass
class Chunk:
    id: int
    session_id: str
    type: str
    content: str
    created_at: float
    position: int
    project: str
    tool_name: Optional[str]
    file: Optional[str]
    ext: Optional[str]
    topic: str
    cluster: str  # descriptive|implementation|neutral

    def row(self) -> tuple:
        return (
            self.id, self.session_id, self.type, self.content, self.created_at,
            self.position, self.project, self.tool_name, self.file, self.ext,
        )


def generate_corpus(
    n_chunks: int = 240_000,
    n_sessions: int = 4_000,
    days: float = 180.0,
    seed: int = 0,
    now: float = 1_770_000_000.0,
) -> List[Chunk]:
    rng = np.random.Generator(np.random.PCG64(seed))
    clusters = [
        ("descriptive", DESCRIPTIVE_TOPICS),
        ("implementation", IMPLEMENTATION_TOPICS),
        ("neutral", NEUTRAL_TOPICS),
    ]
    chunks: List[Chunk] = []
    per_session = max(1, n_chunks // n_sessions)
    cid = 0
    for s in range(n_sessions):
        session_id = f"s{s:06d}"
        project = PROJECTS[int(rng.integers(len(PROJECTS)))]
        t0 = now - float(rng.uniform(0, days * 86400.0))
        n_in_session = per_session + (1 if s < n_chunks - per_session * n_sessions else 0)
        for pos in range(n_in_session):
            if cid >= n_chunks:
                break
            ci = int(rng.choice(3, p=CLUSTER_WEIGHTS))
            cluster_name, topics = clusters[ci]
            tname, vocab = topics[int(rng.integers(len(topics)))]
            ctype = CHUNK_TYPES[int(rng.choice(4, p=[0.2, 0.45, 0.25, 0.1]))]
            content = _make_content(rng, vocab, cluster_name, ctype)
            tool = TOOLS[int(rng.integers(len(TOOLS)))] if ctype == "tool_call" else None
            fpath = f"src/{tname}/{tname}_{int(rng.integers(20))}.py" if ctype == "file" else None
            chunks.append(
                Chunk(
                    id=cid, session_id=session_id, type=ctype, content=content,
                    created_at=t0 + pos * 30.0, position=pos, project=project,
                    tool_name=tool, file=fpath, ext="py" if fpath else None,
                    topic=tname, cluster=cluster_name,
                )
            )
            cid += 1
    return chunks


def _make_content(rng: np.random.Generator, vocab: Sequence[str], cluster: str, ctype: str) -> str:
    n_topic = int(rng.integers(6, 14))
    words = [vocab[int(rng.integers(len(vocab)))] for _ in range(n_topic)]
    # Both descriptive and implementation clusters use the query's vocabulary
    # (paper §5.1: 'use the same vocabulary'); descriptive uses MORE of it,
    # which is what makes it dominate baseline cosine ranking.
    # Paper §5.1: the clusters 'use the same vocabulary' — per-doc query
    # overlap is drawn from the SAME distribution; the descriptive cluster
    # dominates baseline top-K through its larger SIZE (order statistics),
    # which is exactly the failure mode suppression exists to fix.
    n_overlap = int(rng.integers(2, 5)) if cluster in ("descriptive", "implementation") \
        else int(rng.integers(0, 2))
    words += [_OVERLAP[int(rng.integers(len(_OVERLAP)))] for _ in range(n_overlap)]
    if cluster == "descriptive":
        shared = _DESCRIPTIVE_SHARED
        n_shared = int(rng.integers(4, 9))
    elif cluster == "implementation":
        shared = _IMPLEMENTATION_SHARED
        n_shared = int(rng.integers(1, 3))
    else:
        shared, n_shared = [], 0
    words += [shared[int(rng.integers(len(shared)))] for _ in range(n_shared)]
    rng.shuffle(words)  # type: ignore[arg-type]
    body = " ".join(words)
    if ctype == "assistant":
        # long-form so `length(content) > 300` pre-filters keep them
        body = (body + " ") * 4
    return body.strip()


def build_database(
    conn: sqlite3.Connection,
    chunks: Sequence[Chunk],
    embedder: Optional[HashEmbedder] = None,
    description: str = "Agentic coding conversation history. Sessions, messages, tool calls, and output.",
) -> np.ndarray:
    """Create schema, insert chunks + sources + embeddings. Returns matrix."""
    embedder = embedder or HashEmbedder(128)
    schema_mod.build_schema(conn, description)
    register_presets(conn)

    sessions: dict = {}
    for c in chunks:
        st = sessions.setdefault(
            c.session_id, [c.project, f"session {c.session_id}", c.created_at, c.created_at, 0]
        )
        st[2] = min(st[2], c.created_at)
        st[3] = max(st[3], c.created_at)
        st[4] += 1
    schema_mod.insert_sources(
        conn, [(sid, *vals) for sid, vals in sessions.items()]
    )

    matrix = embedder.embed_batch([c.content for c in chunks])
    B = 20_000
    for i in range(0, len(chunks), B):
        schema_mod.insert_chunks(
            conn, [c.row() for c in chunks[i : i + B]], matrix[i : i + B]
        )
    return matrix
