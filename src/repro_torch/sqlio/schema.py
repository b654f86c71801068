"""Production schema (paper Appendix D): raw tables, views, FTS5, embeddings.

Single SQLite database; each chunk is one indexed unit (message, tool call,
or file snapshot); each source is a session. Embeddings live in a BLOB column
and are loaded into the in-memory matrix at startup (paper §3.2).
"""

from __future__ import annotations

import sqlite3
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

SCHEMA_SQL = """
CREATE TABLE IF NOT EXISTS _meta (key TEXT PRIMARY KEY, value TEXT);

CREATE TABLE IF NOT EXISTS _raw_sources (
    session_id   TEXT PRIMARY KEY,
    project      TEXT,
    title        TEXT,
    start_time   REAL,
    end_time     REAL,
    message_count INTEGER DEFAULT 0
);

CREATE TABLE IF NOT EXISTS _raw_chunks (
    id          INTEGER PRIMARY KEY,
    session_id  TEXT REFERENCES _raw_sources(session_id),
    type        TEXT,            -- user_prompt|assistant|tool_call|file
    content     TEXT,
    created_at  REAL,            -- unix seconds
    position    INTEGER,
    project     TEXT,
    tool_name   TEXT,
    file        TEXT,
    ext         TEXT,
    embedding   BLOB             -- float32 little-endian, d dims
);

CREATE TABLE IF NOT EXISTS _presets (
    name        TEXT PRIMARY KEY,
    description TEXT,
    params      TEXT,
    sql         TEXT
);

CREATE INDEX IF NOT EXISTS idx_chunks_type    ON _raw_chunks(type);
CREATE INDEX IF NOT EXISTS idx_chunks_project ON _raw_chunks(project);
CREATE INDEX IF NOT EXISTS idx_chunks_created ON _raw_chunks(created_at);
CREATE INDEX IF NOT EXISTS idx_chunks_session ON _raw_chunks(session_id);

CREATE VIEW IF NOT EXISTS chunks AS
    SELECT id, content, created_at AS timestamp, created_at, type, session_id,
           position, project, tool_name, file, ext
    FROM _raw_chunks;

CREATE VIEW IF NOT EXISTS messages AS
    SELECT c.id, c.content, c.created_at AS timestamp, c.created_at,
           c.session_id, c.position, c.project, s.title, s.message_count,
           c.tool_name, c.type
    FROM _raw_chunks c JOIN _raw_sources s USING (session_id)
    WHERE c.type IN ('user_prompt', 'assistant', 'tool_call');

CREATE VIEW IF NOT EXISTS files AS
    SELECT id, content, created_at AS timestamp, created_at, session_id,
           file, ext, position AS chunk_position
    FROM _raw_chunks WHERE type = 'file';

CREATE VIEW IF NOT EXISTS sessions AS
    SELECT s.session_id, s.project, s.title, s.message_count,
           s.start_time, s.end_time,
           (s.end_time - s.start_time) AS duration,
           COUNT(c.id) AS chunk_count
    FROM _raw_sources s LEFT JOIN _raw_chunks c USING (session_id)
    GROUP BY s.session_id;
"""

FTS_SQL = """
CREATE VIRTUAL TABLE IF NOT EXISTS chunks_fts USING fts5(
    content, content='_raw_chunks', content_rowid='id'
);
"""


def build_schema(conn: sqlite3.Connection, description: str = "") -> None:
    conn.executescript(SCHEMA_SQL)
    conn.executescript(FTS_SQL)
    conn.execute(
        "INSERT OR REPLACE INTO _meta (key, value) VALUES ('description', ?)",
        (description or "Agentic coding conversation history.",),
    )
    conn.commit()


def insert_chunks(
    conn: sqlite3.Connection,
    rows: Iterable[tuple],
    embeddings: Optional[np.ndarray] = None,
) -> None:
    """rows: (id, session_id, type, content, created_at, position, project,
    tool_name, file, ext); embeddings: (n, d) float32 aligned with rows."""
    rows = list(rows)
    blobs: Sequence[Optional[bytes]]
    if embeddings is not None:
        emb = np.ascontiguousarray(embeddings, dtype=np.float32)
        assert emb.shape[0] == len(rows), "rows/embeddings misaligned"
        blobs = [emb[i].tobytes() for i in range(len(rows))]
    else:
        blobs = [None] * len(rows)
    conn.executemany(
        "INSERT OR REPLACE INTO _raw_chunks "
        "(id, session_id, type, content, created_at, position, project,"
        " tool_name, file, ext, embedding) VALUES (?,?,?,?,?,?,?,?,?,?,?)",
        [r + (b,) for r, b in zip(rows, blobs)],
    )
    # external-content FTS5 needs explicit sync
    conn.executemany(
        "INSERT INTO chunks_fts (rowid, content) VALUES (?, ?)",
        [(r[0], r[3]) for r in rows],
    )
    conn.commit()


def delete_chunks(
    conn: sqlite3.Connection,
    ids: Sequence[int],
    *,
    fts_table: str = "chunks_fts",
) -> List[int]:
    """Remove chunks (rows + FTS sync). Returns the ids actually removed.

    The FTS5 index is external-content, so the 'delete' command needs the
    old content; rows are fetched first.  Callers keep the VectorCache in
    sync by tombstoning the same ids (``cache.delete(ids)``) — only the
    touched segments' masks change.
    """
    ids = [int(i) for i in ids]
    if not ids:
        return []
    ph = ",".join("?" * len(ids))
    rows = conn.execute(
        f"SELECT id, content FROM _raw_chunks WHERE id IN ({ph})", ids
    ).fetchall()
    conn.executemany(
        f"INSERT INTO {fts_table} ({fts_table}, rowid, content) "
        f"VALUES ('delete', ?, ?)",
        [(r[0], r[1] or "") for r in rows],
    )
    conn.executemany(
        "DELETE FROM _raw_chunks WHERE id = ?", [(r[0],) for r in rows]
    )
    conn.commit()
    return [r[0] for r in rows]


def insert_sources(conn: sqlite3.Connection, rows: Iterable[tuple]) -> None:
    """rows: (session_id, project, title, start_time, end_time, message_count)"""
    conn.executemany(
        "INSERT OR REPLACE INTO _raw_sources "
        "(session_id, project, title, start_time, end_time, message_count)"
        " VALUES (?,?,?,?,?,?)",
        rows,
    )
    conn.commit()


def load_embedding_matrix(
    conn: sqlite3.Connection, dim: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Startup load (paper §3.2): -> (ids, matrix, created_at)."""
    cur = conn.execute(
        "SELECT id, embedding, created_at FROM _raw_chunks "
        "WHERE embedding IS NOT NULL ORDER BY id"
    )
    ids, vecs, ts = [], [], []
    for cid, blob, created in cur:
        ids.append(cid)
        vecs.append(np.frombuffer(blob, dtype=np.float32, count=dim))
        ts.append(created or 0.0)
    if not ids:
        return (
            np.zeros(0, np.int64),
            np.zeros((0, dim), np.float32),
            np.zeros(0, np.float64),
        )
    return (
        np.asarray(ids, np.int64),
        np.stack(vecs).astype(np.float32),
        np.asarray(ts, np.float64),
    )
