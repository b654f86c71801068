"""SQL presets (paper §3.1, Appendices C/D).

``@orient`` is a multi-query SQL script; each ``-- @query:`` section produces
one key of the output. ``pragma_table_info()`` discovers view columns at
runtime so schema changes propagate without updating agent instructions.
"""

from __future__ import annotations

import sqlite3
from typing import Dict, List, Optional, Tuple

ORIENT_SQL = """
-- @query: now
SELECT datetime('now', 'localtime') as now,
       'UTC' || printf('%+d',
         cast((julianday('now', 'localtime')
               - julianday('now')) * 24 as integer)) as timezone;

-- @query: about
SELECT value as description FROM _meta WHERE key = 'description';

-- @query: shape
SELECT 'chunks' as what, COUNT(*) as n FROM _raw_chunks
UNION ALL
SELECT 'sources', COUNT(*) FROM _raw_sources;

-- @query: query_surface
SELECT 'view' as kind, m.name as name,
       GROUP_CONCAT(p.name, ', ') as columns,
       CASE m.name
         WHEN 'chunks' THEN 'UNIFIED surface -- all chunks. type: user_prompt|assistant|tool_call|file.'
         WHEN 'messages' THEN 'Message chunks only.'
         WHEN 'sessions' THEN 'Sources with graph intelligence.'
         ELSE ''
       END as note
FROM sqlite_master m, pragma_table_info(m.name) p
WHERE m.type = 'view'
GROUP BY m.name
UNION ALL
SELECT 'table_function', 'vec_ops', 'id, score, snippet',
       'Semantic retrieval with token grammar -- use after FROM/JOIN.'
UNION ALL
SELECT 'table_function', 'keyword', 'id, score, snippet',
       'FTS5 keyword search (scores min-max normalized).'
UNION ALL
SELECT 'table_function', 'hybrid_search', 'id, score, snippet',
       'HYBRID_SEARCH(''query''[, weight]) -- weight*vector + (1-weight)*bm25, fused on device.'
UNION ALL
SELECT 'table_function', 'vector_search', 'id, score, snippet',
       'VECTOR_SEARCH(''query'') -- pure-vector baseline (plain text, no grammar).'
ORDER BY kind, name;

-- @query: presets
SELECT name, description, params FROM _presets ORDER BY name;
"""

DIGEST_SQL = """
-- @query: digest
SELECT date(created_at, 'unixepoch') AS day, project,
       COUNT(*) AS chunks,
       SUM(type = 'assistant') AS assistant_msgs,
       SUM(type = 'tool_call') AS tool_calls
FROM _raw_chunks
WHERE created_at > strftime('%s', 'now') - :days * 86400
GROUP BY day, project ORDER BY day DESC, chunks DESC;
"""

FILE_SQL = """
-- @query: file_sessions
SELECT DISTINCT c.session_id, s.project, s.title,
       datetime(s.start_time, 'unixepoch') AS started
FROM _raw_chunks c JOIN _raw_sources s USING (session_id)
WHERE c.file LIKE :path OR c.content LIKE :path
ORDER BY s.start_time DESC LIMIT 50;
"""

SPRINTS_SQL = """
-- @query: sprints
WITH ordered AS (
    SELECT session_id, start_time,
           start_time - LAG(start_time) OVER (ORDER BY start_time) AS gap
    FROM _raw_sources
)
SELECT session_id, datetime(start_time, 'unixepoch') AS started,
       CASE WHEN gap IS NULL OR gap > 6 * 3600 THEN 1 ELSE 0 END AS sprint_start
FROM ordered ORDER BY start_time;
"""

PRESETS: Dict[str, Tuple[str, str, str]] = {
    # name -> (description, params, sql script)
    "@orient": ("Full cell orientation", "", ORIENT_SQL),
    "@digest": ("Multi-day activity summary", "days=7", DIGEST_SQL),
    "@file": ("Sessions that touched a file", "path required", FILE_SQL),
    "@sprints": ("Work sprints detected by 6h gaps", "", SPRINTS_SQL),
}


def register_presets(conn: sqlite3.Connection) -> None:
    conn.executemany(
        "INSERT OR REPLACE INTO _presets (name, description, params, sql)"
        " VALUES (?,?,?,?)",
        [(n, d, p, s) for n, (d, p, s) in PRESETS.items()],
    )
    conn.commit()


def run_preset(
    conn: sqlite3.Connection,
    name: str,
    params: Optional[Dict[str, object]] = None,
) -> Dict[str, Tuple[List[str], List[tuple]]]:
    """Execute a multi-query preset script -> {query_key: (cols, rows)}."""
    if name not in PRESETS:
        row = conn.execute("SELECT sql FROM _presets WHERE name = ?", (name,)).fetchone()
        if row is None:
            raise KeyError(f"unknown preset {name}")
        script = row[0]
    else:
        script = PRESETS[name][2]

    out: Dict[str, Tuple[List[str], List[tuple]]] = {}
    key = None
    buf: List[str] = []

    def flush() -> None:
        nonlocal buf
        sql = "\n".join(buf).strip()
        buf = []
        if not key or not sql:
            return
        for stmt in _split_statements(sql):
            cur = conn.execute(stmt, params or {})
            cols = [d[0] for d in cur.description] if cur.description else []
            prev = out.get(key, (cols, []))
            out[key] = (cols, prev[1] + cur.fetchall())

    for line in script.splitlines():
        if line.strip().startswith("-- @query:"):
            flush()
            key = line.split(":", 1)[1].strip()
        else:
            buf.append(line)
    flush()
    return out


def _split_statements(sql: str) -> List[str]:
    """Split on top-level semicolons (quote-aware, minimal)."""
    parts, depth, start, i, n = [], 0, 0, 0, len(sql)
    while i < n:
        c = sql[i]
        if c == "'":
            i += 1
            while i < n and not (sql[i] == "'" and (i + 1 >= n or sql[i + 1] != "'")):
                i += 2 if sql[i] == "'" else 1
        elif c == ";" and depth == 0:
            parts.append(sql[start:i])
            start = i + 1
        elif c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        i += 1
    tail = sql[start:].strip()
    if tail:
        parts.append(tail)
    return [p.strip() for p in parts if p.strip()]
