"""Query materializer (paper contribution #1, §3.2).

``vec_ops()`` and ``keyword()`` are NOT SQLite functions or virtual tables.
They are pseudo-functions recognized here, *before* SQLite sees the query:

1. scan the agent's SQL for pseudo-function calls in FROM/JOIN position
   (a quote-aware scanner, not a full SQL parser — paper §7 Limitations),
2. dispatch each call to its engine (the ``ExecutionBackend`` registry's
   fused score->select stage for ``vec_ops`` — only top-``pool`` candidate
   rows come back from the backend, never full score arrays — FTS5 for
   ``keyword``), running the embedded Phase-1 pre-filter SQL first,
3. write each result to a temp table,
4. rewrite the statement to reference the temp tables,
5. hand the rewritten statement to SQLite (Phase 3 composition),
6. drop the temp tables once the statement has returned or failed.

Failure mode is an explicit ``MaterializeError`` (the agent retries), never
silent misexecution.

Live-corpus ingest (the delta surface): ``INSERT INTO chunks ...`` and
``DELETE FROM chunks ...`` are recognized and routed — the row change
applies to SQLite (``_raw_chunks`` + FTS5 sync), missing embeddings are
computed from ``content`` via the cache's embed function, and the
VectorCache ingests/tombstones the same ids, invalidating nothing but the
touched segment (warm segments keep their device residency and compiled
plans).  Every other write statement stays rejected.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import re
import sqlite3
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

# Monotonic across all Materializer instances sharing a connection: temp
# tables live on the CONNECTION, so names must be process-unique.
_TEMP_IDS = itertools.count(1)

from repro_torch import spans
from repro_torch.core import grammar
from repro_torch.core import modulations as M
from repro_torch.core.backends import ExecutionBackend, get_backend
from repro_torch.core.vectorcache import VectorCache

# scanned case-insensitively; the canonical (lowercase) spelling is what
# PseudoCall.func carries
_PSEUDO_FUNCS = ("vec_ops", "vector_search", "keyword", "hybrid_search")
_READONLY_RE = re.compile(r"^\s*(SELECT|WITH)\b", re.IGNORECASE)
# the ingest surface: writes against the `chunks` view ONLY (`\b` keeps
# `_raw_chunks` and friends rejected by the read-only check below)
_INSERT_CHUNKS_RE = re.compile(r"^(\s*INSERT\s+INTO\s+)chunks\b",
                               re.IGNORECASE)
_DELETE_CHUNKS_RE = re.compile(r"^\s*DELETE\s+FROM\s+chunks\b",
                               re.IGNORECASE)


class MaterializeError(RuntimeError):
    """Explicit rewrite/execution failure surfaced to the agent via MCP."""


@dataclasses.dataclass
class PseudoCall:
    func: str            # 'vec_ops' | 'vector_search' | 'keyword' | 'hybrid_search'
    args: List[Union[str, float]]  # decoded string/numeric literal arguments
    start: int           # span of the call in the original SQL text
    end: int


# ---------------------------------------------------------------------------
# Quote-aware scanning
# ---------------------------------------------------------------------------


def _scan_calls(sql: str) -> List[PseudoCall]:
    """Find pseudo-function calls at the top level of the statement.

    Respects single-quoted SQL strings (with '' escapes) so that e.g. a
    pre-filter argument containing ``type = ''assistant''`` does not confuse
    the paren matcher. Nested pseudo-calls inside the *arguments* are not
    expanded (the Phase-1 subquery is plain SQL by construction).
    """
    calls: List[PseudoCall] = []
    low = sql.lower()  # case-insensitive match (HYBRID_SEARCH == hybrid_search)
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c == "'":
            i = _skip_string(sql, i)
            continue
        matched = None
        for name in _PSEUDO_FUNCS:
            if low.startswith(name, i) and _is_word_boundary(sql, i, len(name)):
                j = i + len(name)
                while j < n and sql[j] in " \t\n":
                    j += 1
                if j < n and sql[j] == "(":
                    matched = (name, j)
                break
        if matched is None:
            i += 1
            continue
        name, open_paren = matched
        close = _match_paren(sql, open_paren)
        args = _split_args(sql[open_paren + 1 : close])
        calls.append(PseudoCall(func=name, args=args, start=i, end=close + 1))
        i = close + 1
    return calls


def _skip_string(sql: str, i: int) -> int:
    """i points at an opening quote; return index just past the string."""
    j = i + 1
    n = len(sql)
    while j < n:
        if sql[j] == "'":
            if j + 1 < n and sql[j + 1] == "'":
                j += 2
                continue
            return j + 1
        j += 1
    raise MaterializeError(f"unterminated string literal at offset {i}")


def _is_word_boundary(sql: str, i: int, length: int) -> bool:
    before_ok = i == 0 or not (sql[i - 1].isalnum() or sql[i - 1] == "_")
    j = i + length
    after_ok = j >= len(sql) or not (sql[j].isalnum() or sql[j] == "_")
    return before_ok and after_ok


def _match_paren(sql: str, open_paren: int) -> int:
    depth = 0
    i = open_paren
    n = len(sql)
    while i < n:
        c = sql[i]
        if c == "'":
            i = _skip_string(sql, i)
            continue
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
            if depth == 0:
                return i
        i += 1
    raise MaterializeError(f"unbalanced parentheses at offset {open_paren}")


def _split_args(body: str) -> List[Union[str, float]]:
    """Split top-level comma-separated literal arguments and decode.

    String literals decode to str; bare numeric literals (the
    ``HYBRID_SEARCH('q', 0.7)`` weight) decode to float.  Anything else
    stays an explicit error.
    """
    args: List[str] = []
    i, n = 0, len(body)
    depth = 0
    start = 0
    while i < n:
        c = body[i]
        if c == "'":
            i = _skip_string(body, i)
            continue
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        elif c == "," and depth == 0:
            args.append(body[start:i])
            start = i + 1
        i += 1
    tail = body[start:].strip()
    if tail or args:
        args.append(body[start:])
    decoded: List[Union[str, float]] = []
    for a in args:
        a = a.strip()
        if a.startswith("'") and a.endswith("'") and len(a) >= 2:
            decoded.append(a[1:-1].replace("''", "'"))
            continue
        try:
            decoded.append(float(a))
        except ValueError:
            raise MaterializeError(
                "pseudo-function arguments must be string literals "
                f"(or numeric literals), got: {a[:60]!r}"
            ) from None
    return decoded


# ---------------------------------------------------------------------------
# The materializer
# ---------------------------------------------------------------------------


class Materializer:
    """Rewrites agent SQL, dispatching pseudo-functions to their engines."""

    def __init__(
        self,
        conn: sqlite3.Connection,
        cache: Optional[VectorCache] = None,
        *,
        fts_table: str = "chunks_fts",
        now: Optional[float] = None,
        engine: Union[str, ExecutionBackend] = "reference",
        serving=None,
        lock=None,
    ) -> None:
        self.conn = conn
        # held around every use of ``conn``, never across a vector search:
        # callers that share one connection between threads (the service's
        # flex_search_async, its ingest and delete) pass the same lock, so
        # two statements never interleave on it (Python's sqlite3 shares
        # one prepared statement between threads running the same SQL)
        self.lock = threading.RLock() if lock is None else lock
        self.cache = cache
        self.fts_table = fts_table
        self.now = now
        # resolve through the shared backend registry up front so an unknown
        # engine fails at construction, not mid-rewrite
        self.engine = get_backend(engine)
        # optional async batched engine: when attached, vec_ops base
        # rankings route through it so SQL-surface queries — filtered ones
        # included — micro-batch and pipeline with all other traffic
        # instead of scoring synchronously on this thread
        self.serving = serving
        # result tables this materializer made on ``conn``, and of them
        # those it dropped again (``execute`` drops its own; a table made
        # by a bare ``rewrite`` stays for its caller)
        self.temp_tables = 0
        self.temp_tables_dropped = 0

    # -- public API ----------------------------------------------------------

    def execute(
        self, sql: str, params: Sequence = ()
    ) -> Tuple[List[str], List[tuple]]:
        """Full 3-phase execution. Returns (column names, rows).

        ``INSERT INTO chunks`` / ``DELETE FROM chunks`` route to the
        delta-ingest surface (SQLite + FTS + VectorCache stay in sync);
        all other statements must be read-only SELECT/WITH.
        """
        if _INSERT_CHUNKS_RE.match(sql):
            with self.lock:
                return self._execute_ingest_insert(sql, params)
        if _DELETE_CHUNKS_RE.match(sql):
            with self.lock:
                return self._execute_ingest_delete(sql, params)
        made: List[str] = []
        try:
            rewritten = self._rewrite(sql, made)
            if not _READONLY_RE.match(rewritten):
                raise MaterializeError(
                    "only read-only SELECT/WITH statements are allowed")
            with self.lock, spans.span("sql.statement"):
                try:
                    try:
                        cur = self.conn.execute(rewritten, params)
                    except sqlite3.Error as e:
                        raise MaterializeError(
                            f"SQL error after rewrite: {e}") from e
                    cols = ([d[0] for d in cur.description]
                            if cur.description else [])
                    return cols, cur.fetchall()
                finally:
                    self._drop(made)
        finally:
            if made:   # a pseudo-call or the read-only check failed first
                with self.lock:
                    self._drop(made)

    def rewrite(self, sql: str) -> str:
        """Phases 1+2: materialize every pseudo-call, rewrite references.

        The result tables stay on the connection for the caller to drop;
        :meth:`execute` drops its own.
        """
        return self._rewrite(sql, [])

    def _rewrite(self, sql: str, made: List[str]) -> str:
        """:meth:`rewrite`, adding each result table it creates to
        ``made`` as soon as the table exists."""
        calls = _scan_calls(sql)
        out = []
        pos = 0
        for call in calls:
            ref = self._materialize(call, made)
            out.append(sql[pos : call.start])
            out.append(ref)
            pos = call.end
        out.append(sql[pos:])
        return "".join(out)

    def _drop(self, made: List[str]) -> None:
        """Drops the result tables named in ``made`` and empties it; the
        caller holds the lock."""
        while made:
            self.conn.execute(f"DROP TABLE {made.pop()}")
            self.temp_tables_dropped += 1

    # -- dispatch ------------------------------------------------------------

    def _materialize(self, call: PseudoCall, made: List[str]) -> str:
        """Materializes one pseudo-call; returns what the statement reads
        in its place."""
        if call.func == "vec_ops":
            return self._materialize_vec_ops(call, made)
        if call.func == "keyword":
            return self._materialize_keyword(call, made)
        if call.func == "hybrid_search":
            return self._materialize_hybrid_search(call, made)
        if call.func == "vector_search":
            return self._materialize_vector_search(call, made)
        raise MaterializeError(f"unknown pseudo-function {call.func}")

    def _fresh_table(self, prefix: str, columns: str,
                     made: List[str]) -> str:
        """Creates a new result table of ``columns``, counts it in
        ``temp_tables`` and adds it to ``made``; the caller holds the
        lock."""
        name = f"_{prefix}_{next(_TEMP_IDS)}"
        self.conn.execute(f"CREATE TEMP TABLE {name} ({columns})")
        self.temp_tables += 1
        made.append(name)
        return name

    def _materialize_vec_ops(self, call: PseudoCall, made: List[str]) -> str:
        if not 1 <= len(call.args) <= 2:
            raise MaterializeError(
                f"vec_ops expects 1-2 string arguments, got {len(call.args)}"
            )
        tokens = call.args[0]
        if not isinstance(tokens, str):
            raise MaterializeError("vec_ops: token argument must be a string")
        prefilter_sql = None
        if len(call.args) == 2:
            if not isinstance(call.args[1], str):
                raise MaterializeError("vec_ops: pre-filter must be a string")
            prefilter_sql = call.args[1]
        return self._materialize_search("vec_ops", made, tokens=tokens,
                                        prefilter_sql=prefilter_sql)

    def _materialize_hybrid_search(self, call: PseudoCall,
                                   made: List[str]) -> str:
        """``HYBRID_SEARCH('query'[, weight])`` — weighted lexical+vector
        fusion sugar: one text drives BOTH legs (``similar:`` through the
        fused device pipeline, ``keyword:`` through FTS5/BM25), fused as
        ``weight*vector + (1-weight)*minmax(bm25)`` on device."""
        if self.cache is None:
            raise MaterializeError("hybrid_search: no VectorCache attached")
        if not 1 <= len(call.args) <= 2:
            raise MaterializeError(
                f"hybrid_search expects ('query'[, weight]), got {len(call.args)} args"
            )
        query = call.args[0]
        if not isinstance(query, str) or not query.strip():
            raise MaterializeError(
                "hybrid_search: first argument must be the query string")
        weight = M.DEFAULT_FUSE_WEIGHT
        if len(call.args) == 2:
            if not isinstance(call.args[1], float):
                raise MaterializeError(
                    "hybrid_search: weight must be a numeric literal")
            weight = call.args[1]
            if not 0.0 <= weight <= 1.0:
                raise MaterializeError(
                    f"hybrid_search: weight must be in [0, 1], got {weight}")
        parsed = grammar.ParsedTokens(similar=query, keyword=query,
                                      fuse_mode="weighted",
                                      fuse_weight=weight)
        return self._materialize_search("hybrid", made, parsed=parsed,
                                        label=query)

    def _materialize_vector_search(self, call: PseudoCall,
                                   made: List[str]) -> str:
        """``VECTOR_SEARCH('query')`` — pure-vector sugar (plain text, no
        grammar tokens): the hybrid surface's baseline counterpart."""
        if self.cache is None:
            raise MaterializeError("vector_search: no VectorCache attached")
        if len(call.args) != 1 or not isinstance(call.args[0], str) \
                or not call.args[0].strip():
            raise MaterializeError(
                "vector_search expects exactly one query string")
        parsed = grammar.ParsedTokens(similar=call.args[0])
        return self._materialize_search("vector", made, parsed=parsed,
                                        label=call.args[0])

    def _materialize_search(
        self,
        kind: str,
        made: List[str],
        *,
        tokens: Optional[str] = None,
        parsed: Optional["grammar.ParsedTokens"] = None,
        prefilter_sql: Optional[str] = None,
        label: Optional[str] = None,
    ) -> str:
        """Shared Phase-1+2 entry behind every retrieval pseudo-call.

        Materializes the search's own columns ``(id, score[, cluster,
        central])`` — scores min-max normalized over the result set
        (monotone: orderings are unchanged) — and returns the unified
        result contract ``(id, score, snippet[, cluster, central])`` over
        them (:func:`_with_snippet`).
        """
        if self.cache is None:
            raise MaterializeError(f"{kind}: no VectorCache attached")
        candidate_ids = None
        if prefilter_sql is not None and prefilter_sql.strip():
            if not _READONLY_RE.match(prefilter_sql):
                raise MaterializeError(f"{kind} pre-filter must be a SELECT")
            with self.lock, spans.span("sql.prefilter"):
                try:
                    rows = self.conn.execute(prefilter_sql).fetchall()
                except sqlite3.Error as e:
                    raise MaterializeError(
                        f"pre-filter SQL failed: {e}") from e
                candidate_ids = [r[0] for r in rows]
                if not candidate_ids:
                    # Paper §7: malformed pre-filters returning no rows are
                    # an agent error class; we surface an EMPTY result,
                    # not a crash.
                    table = self._fresh_table(
                        kind, "id INTEGER PRIMARY KEY, score REAL", made)
                    return _with_snippet(table, ["id", "score"])

        try:
            plan = None
            if parsed is not None:
                with spans.span("parse"):
                    plan = grammar.build_plan(
                        parsed, self.cache.embed_fn,
                        self.cache.embeddings_for_ids, self._lexical_scores)
            base_search = None
            if self.serving is not None:
                # hand the parsed plan over so admission skips the
                # duplicate parse+embed of the same tokens
                req_tokens = tokens if tokens is not None else (label or "")
                base_search = (lambda p, k: self.serving.search(
                    req_tokens, k=k, candidate_ids=candidate_ids, plan=p))
            cols, results = self.cache.search_full(
                tokens, candidate_ids, now=self.now, engine=self.engine,
                base_search=base_search, lexical_fn=self._lexical_scores,
                plan=plan,
            )
        except Exception as e:  # grammar errors -> explicit failure
            raise MaterializeError(f"{kind} failed: {e}") from e

        # the unified result-row contract: score min-max normalized,
        # structural columns (§3.2) after it; the snippet is the
        # statement's to join
        if results:
            norm = M.minmax_normalize(
                np.asarray([r[1] for r in results], np.float32))
            results = [(r[0], float(v)) + tuple(r[2:])
                       for r, v in zip(results, norm)]

        decls = {"id": "INTEGER PRIMARY KEY", "score": "REAL",
                 "cluster": "INTEGER", "central": "REAL"}
        col_sql = ", ".join(f"{c} {decls[c]}" for c in cols)
        ph = ",".join("?" * len(cols))
        with self.lock, spans.span("sql.temp_table"):
            table = self._fresh_table(kind, col_sql, made)
            self.conn.executemany(
                f"INSERT OR REPLACE INTO {table} ({', '.join(cols)}) "
                f"VALUES ({ph})",
                results,
            )
        return _with_snippet(table, cols)

    def _materialize_keyword(self, call: PseudoCall, made: List[str]) -> str:
        """``keyword('term')``: FTS5 hits with their stored highlighted
        excerpt as ``snippet`` (not a content prefix, so no join)."""
        if len(call.args) != 1 or not isinstance(call.args[0], str):
            raise MaterializeError("keyword expects exactly one string argument")
        term = call.args[0]
        with self.lock:
            table = self._fresh_table(
                "kw", "id INTEGER PRIMARY KEY, score REAL, snippet TEXT", made)
            rows = self._fts_query(term)
            if rows:
                # unified contract: min-max normalized scores, same (id,
                # score, snippet) shape as every other retrieval
                # pseudo-call
                norm = M.minmax_normalize(
                    np.asarray([r[1] for r in rows], np.float32))
                rows = [(r[0], float(v), r[2]) for r, v in zip(rows, norm)]
            self.conn.executemany(
                f"INSERT OR REPLACE INTO {table} (id, score, snippet) "
                f"VALUES (?, ?, ?)",
                rows,
            )
        return table

    # -- delta ingest (INSERT/DELETE against the chunks view) ----------------

    def _execute_ingest_insert(
        self, sql: str, params: Sequence
    ) -> Tuple[List[str], List[tuple]]:
        """``INSERT INTO chunks ...`` -> _raw_chunks + FTS + cache segment.

        The statement runs against the base table (column names are the
        base-table ones, e.g. ``created_at``); a temp trigger captures the
        inserted ids whatever the INSERT's shape (VALUES lists, SELECT
        feeds).  Rows arriving without an embedding are embedded from
        ``content``; the batch then seals ONE new VectorCache segment —
        nothing else re-uploads or re-traces.
        """
        if self.cache is None:
            raise MaterializeError("ingest: no VectorCache attached")
        rewritten = _INSERT_CHUNKS_RE.sub(r"\g<1>_raw_chunks", sql, count=1)
        log = f"_ingest_log_{next(_TEMP_IDS)}"
        trig = f"_ingest_tr_{next(_TEMP_IDS)}"
        # everything up to the cache ingest runs inside ONE transaction:
        # any failure rolls the row changes back, so SQLite, FTS and the
        # vector store can never diverge (and the agent's retry of the
        # same INSERT works instead of hitting a PK conflict)
        try:
            self.conn.execute(f"CREATE TEMP TABLE {log} (id INTEGER)")
            self.conn.execute(
                f"CREATE TEMP TRIGGER {trig} AFTER INSERT ON _raw_chunks "
                f"BEGIN INSERT INTO {log} VALUES (new.id); END"
            )
            try:
                self.conn.execute(rewritten, params)
                ids = [r[0] for r in
                       self.conn.execute(f"SELECT id FROM {log}").fetchall()]
            finally:
                self.conn.execute(f"DROP TRIGGER {trig}")
                self.conn.execute(f"DROP TABLE {log}")
            if not ids:
                return ["id"], []
            ph = ",".join("?" * len(ids))
            rows = self.conn.execute(
                f"SELECT id, content, created_at, embedding FROM _raw_chunks "
                f"WHERE id IN ({ph}) ORDER BY id", ids
            ).fetchall()
            # queued-worker path: with a serving engine carrying a
            # background vectorizer, rows WITHOUT embeddings enqueue for
            # batch embedding in the scheduler's idle gaps (the INSERT
            # returns after enqueue — no inline embedder round-trip on the
            # SQL path); rows WITH embeddings still seal a segment now.
            # Without a vectorizer the legacy inline embed applies.
            vectorize = (self.serving is not None
                         and getattr(self.serving, "vectorizer", None)
                         is not None)
            ready: List[tuple] = []
            queued: List[Tuple[int, str, Optional[float]]] = []
            blob_updates = []
            emb_rows: List[np.ndarray] = []
            for cid, content, created, blob in rows:
                if blob is not None:
                    emb_rows.append(np.frombuffer(
                        blob, dtype=np.float32, count=self.cache.dim))
                    ready.append((cid, content, created))
                elif vectorize:
                    queued.append((cid, content or "", created))
                else:
                    if self.cache.embed_fn is None:
                        raise MaterializeError(
                            "ingest: rows without embeddings need an embed "
                            "function on the cache"
                        )
                    vec = np.asarray(self.cache.embed_fn(content or ""),
                                     dtype=np.float32)
                    emb_rows.append(vec)
                    blob_updates.append((vec.tobytes(), cid))
                    ready.append((cid, content, created))
            if blob_updates:
                self.conn.executemany(
                    "UPDATE _raw_chunks SET embedding = ? WHERE id = ?",
                    blob_updates,
                )
            # external-content FTS5 needs explicit sync (queued rows too:
            # the lexical leg serves them before their embedding lands)
            self.conn.executemany(
                f"INSERT INTO {self.fts_table} (rowid, content) "
                f"VALUES (?, ?)",
                [(r[0], r[1] or "") for r in rows],
            )
            if ready:
                emb = np.stack(emb_rows).astype(np.float32, copy=False)
                self.cache.ingest(
                    [r[0] for r in ready], emb,
                    [r[2] or 0.0 for r in ready]
                    if self.cache.store.has_timestamps
                    or not self.cache.store.n_segments else None,
                )
            if queued:
                # LAST step before commit: a full queue (backpressure)
                # rolls the whole INSERT back, and nothing fallible runs
                # after the rows are journaled as accepted
                try:
                    self.serving.enqueue_ingest(queued)
                except RuntimeError as e:
                    raise MaterializeError(
                        f"ingest enqueue failed: {e}") from e
        except (sqlite3.Error, ValueError) as e:
            self.conn.rollback()
            raise MaterializeError(f"ingest INSERT failed: {e}") from e
        except MaterializeError:
            self.conn.rollback()
            raise
        self.conn.commit()
        return ["id"], [(r[0],) for r in rows]

    def _execute_ingest_delete(
        self, sql: str, params: Sequence
    ) -> Tuple[List[str], List[tuple]]:
        """``DELETE FROM chunks [WHERE ...]`` -> rows out of SQLite + FTS,
        tombstones into the VectorCache (only the touched segments' masks
        change — no re-upload, no re-trace, no view rebuild elsewhere)."""
        from repro_torch.sqlio.schema import delete_chunks

        m = _DELETE_CHUNKS_RE.match(sql)
        predicate = sql[m.end():]  # WHERE clause, view column names work
        try:
            ids = [r[0] for r in self.conn.execute(
                f"SELECT id FROM chunks {predicate}", params).fetchall()]
        except sqlite3.Error as e:
            raise MaterializeError(f"ingest DELETE failed: {e}") from e
        removed = delete_chunks(self.conn, ids, fts_table=self.fts_table)
        if self.cache is not None and removed:
            self.cache.delete(removed)
        if removed and self.serving is not None:
            vec = getattr(self.serving, "vectorizer", None)
            if vec is not None:
                # a row may still be queued for background embedding: the
                # DELETE must not let the worker resurrect it later
                vec.queue.discard(removed)
        return ["id"], [(i,) for i in removed]

    def _fts_query(self, term: str, limit: int = M.DEFAULT_POOL) -> List[tuple]:
        """FTS5 BM25 with automatic fallback quoting for special chars.

        ``limit`` comes from the plan's ``pool:`` width on the hybrid path
        (formerly a hardcoded 500 that silently truncated wide pools).
        """
        with self.lock:
            return fts_query(self.conn, term, limit=limit,
                             fts_table=self.fts_table)

    def _lexical_scores(self, term: str, limit: int) -> Tuple[np.ndarray, np.ndarray]:
        """``grammar.LexicalFn``: keyword text + pool width -> BM25 hits.

        Returns ``(ids desc-by-bm25, min-max normalized scores in [0,1])``
        — the lexical leg every ``keyword:`` / ``HYBRID_SEARCH`` plan built
        through this materializer fuses on device.
        """
        rows = self._fts_query(term, limit=limit)
        if not rows:
            return (np.empty(0, dtype=np.int64),
                    np.empty(0, dtype=np.float32))
        ids = np.asarray([r[0] for r in rows], dtype=np.int64)
        scores = M.minmax_normalize(
            np.asarray([r[1] for r in rows], np.float32))
        return ids, scores


def _with_snippet(table: str, cols: Sequence[str]) -> str:
    """The unified result contract ``(id, score, snippet[, cluster,
    central])`` over a result table of the search's own ``cols``: a
    subquery that joins ``snippet``, a content prefix, in the statement.
    Where SQLite flattens the subquery into the statement (it does for
    ``SELECT ... FROM vec_ops(...) v ...``), it reads a snippet only for
    the rows the statement reads, and leaves the join out where the
    statement reads none (the join is on ``_raw_chunks``'s primary key).
    Rows come in the table's id order.
    """
    sel = ["t.id AS id", "t.score AS score",
           "substr(c.content, 1, 96) AS snippet"]
    sel += [f"t.{c} AS {c}" for c in cols[2:]]
    return (f"(SELECT {', '.join(sel)} FROM {table} t "
            f"LEFT JOIN _raw_chunks c ON c.id = t.id)")


def fts_query(
    conn: sqlite3.Connection,
    term: str,
    limit: int = M.DEFAULT_POOL,
    fts_table: str = "chunks_fts",
) -> List[tuple]:
    """FTS5 BM25 query: ``(rowid, -bm25 rank, snippet)`` desc by rank.

    Module-level so serving-layer lexical resolvers (RetrievalService) can
    share the exact quoting/fallback semantics without a Materializer.
    """
    fts = fts_table
    sql = (
        f"SELECT rowid, -bm25({fts}) AS rank, "
        f"snippet({fts}, -1, '[', ']', '…', 12) "
        f"FROM {fts} WHERE {fts} MATCH ? ORDER BY rank DESC LIMIT ?"
    )
    try:
        return conn.execute(sql, (term, int(limit))).fetchall()
    except sqlite3.OperationalError:
        # Fallback quoting (paper Appendix B): dots/operators in the term
        # break FTS5 syntax; quote each whitespace token and retry.
        quoted = " ".join(f'"{t}"' for t in term.split())
        try:
            return conn.execute(sql, (quoted, int(limit))).fetchall()
        except sqlite3.OperationalError as e:
            raise MaterializeError(f"keyword: FTS5 rejected {term!r}: {e}") from e
