"""RetrievalService — the agent-facing surface (paper: FLEX via MCP).

One endpoint, two parameters (paper Appendix B): ``flex_search(query)``
where query is SQL (routed through the materializer) or an ``@preset``.
Errors come back as explicit structured failures so the agent can rewrite
and retry — never silent misexecution (paper §7).

Live corpora: ``INSERT INTO chunks`` / ``DELETE FROM chunks`` through
``flex_search`` (or the direct :meth:`RetrievalService.ingest` /
:meth:`RetrievalService.delete` methods) keep SQLite, FTS5 and the
segmented VectorCache in sync — only the touched segment changes.
:meth:`stats` surfaces query/error counts plus the engine's PlanCache
(hit/trace/eviction) and device-upload counters, the store shape, and the
Phase-1 ``prefilter`` router counters (``routed_masked`` /
``routed_gather`` / ``mask_build_ms``).

Async serving: :meth:`serving` attaches the continuous-batching
:class:`~repro_torch.serve.engine.BatchedRetrievalEngine` (admission queue with
backpressure, per-request priorities/deadlines, pipelined device/host
overlap) over the SAME VectorCache, and the ``*_async`` variants
(:meth:`search_async`, :meth:`flex_search_async`, :meth:`ingest_async`,
:meth:`delete_async`) make every entry point awaitable without blocking
the caller's event loop.  Once attached, :meth:`stats` grows a
``serving`` section — queue depth, rejections, deadline misses, the
pipeline-overlap counter, idle-gap compactions.
"""

from __future__ import annotations

import asyncio
import dataclasses
import sqlite3
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.backends import (ExecutionBackend, HopperBackend,
                                       get_backend)
from repro_torch.core.materializer import MaterializeError, Materializer
from repro_torch.core.vectorcache import VectorCache
from repro_torch.embed import HashEmbedder
from repro_torch.sqlio.presets import run_preset
from repro_torch.sqlio.schema import (delete_chunks, insert_chunks,
                                load_embedding_matrix)


@dataclasses.dataclass
class SearchResult:
    ok: bool
    columns: List[str] = dataclasses.field(default_factory=list)
    rows: List[tuple] = dataclasses.field(default_factory=list)
    error: Optional[str] = None
    latency_ms: float = 0.0


class RetrievalService:
    """SQLite + VectorCache + Materializer behind one search call."""

    def __init__(
        self,
        conn: sqlite3.Connection,
        dim: int = 128,
        embedder: Optional[HashEmbedder] = None,
        now: Optional[float] = None,
        engine: Union[str, ExecutionBackend, None] = None,
        *,
        store_path: Optional[Any] = None,
        fault_plan: Optional[Any] = None,
    ):
        self.conn = conn
        self.embedder = embedder or HashEmbedder(dim)
        ids, matrix, ts = load_embedding_matrix(conn, dim)
        self._fault_plan = fault_plan
        # the FTS5/BM25 resolver behind every keyword:/fuse: plan built
        # through this service — shares the materializer's quoting fallback
        if store_path is not None:
            # durable mode: the segment store journals every mutation to
            # ``store_path`` and recovers from its snapshot + delta on
            # open; the SQLite matrix seeds it only when the journal is
            # brand-new (afterwards the journal IS the vector-store truth)
            from repro_torch.core.segments import SegmentedCorpusStore

            store = SegmentedCorpusStore.open(
                store_path, dim=dim, fault_plan=fault_plan)
            if store.n_rows == 0 and len(ids):
                store.append(ids, matrix, ts)
            self.cache = VectorCache(embed_fn=self.embedder, store=store,
                                     lexical_fn=self._lexical_scores)
        else:
            self.cache = VectorCache(ids, matrix, ts, self.embedder,
                                     lexical_fn=self._lexical_scores)
        self.now = now
        # one registry resolve for the service lifetime; every Materializer
        # this service builds shares the same backend instance — including
        # its device-resident corpus cache and compiled PlanCache, so
        # repeated queries with the same plan structure never retrace.
        # No engine means the Hopper kernels on the card: a CPU run asks
        # for it (HopperBackend("cpu") or a numpy engine name)
        self.engine = HopperBackend() if engine is None else get_backend(engine)
        self.query_count = 0
        self.error_count = 0
        self._serving = None  # lazy BatchedRetrievalEngine (see serving())
        self._serving_lock = threading.Lock()
        self._shard_group = None  # lazy ProcessGroup (see shard_group())

    def flex_search(self, query: str, params: Sequence = ()) -> SearchResult:
        """SQL or @preset -> rows. The agent's single endpoint.

        ``params`` are standard SQLite positional bind parameters for the
        (rewritten) statement — same contract as ``Materializer.execute``,
        so parameterized SQL no longer needs a hand-built Materializer.
        """
        t0 = time.time()
        self.query_count += 1
        try:
            if query.strip().startswith("@"):
                name = query.strip().split()[0]
                out = run_preset(self.conn, name)
                rows: List[tuple] = []
                cols = ["section", "data"]
                for key, (c, r) in out.items():
                    rows.append((key, {"columns": c, "rows": r}))
                return SearchResult(True, cols, rows,
                                    latency_ms=(time.time() - t0) * 1e3)
            mz = Materializer(self.conn, self.cache, now=self.now,
                              engine=self.engine, serving=self._serving)
            cols, rows = mz.execute(query, params)
            return SearchResult(True, cols, rows,
                                latency_ms=(time.time() - t0) * 1e3)
        except (MaterializeError, sqlite3.Error, KeyError) as e:
            # explicit failure -> the agent rewrites and retries (paper §7)
            self.error_count += 1
            return SearchResult(False, error=f"{type(e).__name__}: {e}",
                                latency_ms=(time.time() - t0) * 1e3)

    def search(
        self,
        tokens: str,
        k: Optional[int] = 10,
        *,
        priority: int = 0,
        deadline_ms: Optional[float] = None,
        candidate_ids: Optional[Sequence[int]] = None,
    ) -> List[Tuple[int, float]]:
        """Synchronous token search — the blocking mirror of
        :meth:`search_async` (same signature minus ``await``).  Routes
        through the attached batched engine when :meth:`serving` has been
        called (priorities/deadlines/batching apply); otherwise runs the
        direct VectorCache path, where ``priority``/``deadline_ms`` have
        no queue to act on and are accepted for signature parity.
        """
        if self._serving is not None:
            return self._serving.search(
                tokens, k, priority=priority, deadline_ms=deadline_ms,
                candidate_ids=candidate_ids)
        if self._shard_group is not None:
            from repro_torch.core import grammar

            plan = grammar.parse(tokens, self.cache.embed_fn,
                                 self.cache.embeddings_for_ids,
                                 self.cache.lexical_fn)
            results = self._shard_group.search_plan(
                plan, candidate_ids, now=self.now)
            return results if k is None else results[:k]
        results = self.cache.search(
            tokens, candidate_ids=candidate_ids, now=self.now,
            engine=self.engine)
        return results if k is None else results[:k]

    def _lexical_scores(self, term: str, limit: int) -> Tuple[np.ndarray, np.ndarray]:
        """``grammar.LexicalFn`` over this service's FTS5 table: keyword
        text + pool width -> (ids desc-by-bm25, min-max scores)."""
        from repro_torch.core.materializer import fts_query

        rows = fts_query(self.conn, term, limit=limit)
        if not rows:
            return (np.empty(0, dtype=np.int64),
                    np.empty(0, dtype=np.float32))
        ids = np.asarray([r[0] for r in rows], dtype=np.int64)
        from repro_torch.core import modulations as M
        return ids, M.minmax_normalize(
            np.asarray([r[1] for r in rows], np.float32))

    # -- async serving surface ----------------------------------------------

    def serving(
        self,
        *,
        vectorize: bool = True,
        ingest_queue: int = 1024,
        ingest_batch: int = 64,
        ingest_max_attempts: int = 5,
        ingest_base_backoff_s: float = 0.05,
        **engine_kwargs,
    ) -> "Any":
        """The service's continuous-batching engine, created on first use
        over the same VectorCache (same store, same compiled plans, same
        backend — batched and direct rankings stay bit-identical).

        Unless ``vectorize=False``, the engine carries a background
        ingest vectorizer: ``INSERT INTO chunks`` rows arriving without
        embeddings enqueue (bounded at ``ingest_queue`` rows —
        backpressure, not unbounded memory) and embed in batches of
        ``ingest_batch`` in the scheduler's idle gaps, retrying embedder
        failures with exponential backoff up to ``ingest_max_attempts``
        before dead-lettering.  Rows recovered from a journal as
        enqueued-but-never-embedded are re-adopted here.

        ``engine_kwargs`` (``max_batch``, ``max_wait_ms``, ``max_queue``,
        ``pipeline``, ``compaction``, ...) apply only on first creation.
        """
        with self._serving_lock:  # two racing first calls = one engine
            if self._serving is None:
                from repro_torch.serve.engine import BatchedRetrievalEngine

                vec = None
                if vectorize:
                    from repro_torch.serve.vectorizer import (IngestQueue,
                                                        VectorizerWorker)

                    store = self.cache.store
                    vec = VectorizerWorker(
                        IngestQueue(ingest_queue),
                        self.embedder,
                        self._vectorizer_sink,
                        batch_size=ingest_batch,
                        max_attempts=ingest_max_attempts,
                        base_backoff_s=ingest_base_backoff_s,
                        journal=store.journal,
                        fault_plan=self._fault_plan,
                    )
                    vec.adopt(store.recovered_pending,
                              store.recovered_dead_letters)
                    store.recovered_pending = []
                    store.recovered_dead_letters = []
                self._serving = BatchedRetrievalEngine(
                    self.cache, now=self.now, engine=self.engine,
                    shard_group=self._shard_group, vectorizer=vec,
                    **engine_kwargs)
            return self._serving

    def _vectorizer_sink(self, ids: List[int], vecs: np.ndarray,
                         ts: List[Optional[float]]) -> None:
        """Vectorizer batch -> sealed cache segment (+ shard mirror),
        with the same timestamp-presence policy as the inline path."""
        store = self.cache.store
        use_ts = store.has_timestamps or not store.n_segments
        stamps = [t or 0.0 for t in ts] if use_ts else None
        self.cache.ingest(ids, vecs, stamps)
        if self._shard_group is not None:
            self._shard_group.append(ids, vecs, stamps)

    def shard_group(self, *args: Any, **kwargs: Any) -> "Any":
        """Cross-process shard groups need ``dist.procgroup``, which this
        package does not have yet: the GPU shard workers are a later slice
        of the port.  Raises until then."""
        raise NotImplementedError(
            "RetrievalService.shard_group needs repro_torch.dist.procgroup "
            "(GPU shard workers), a later slice of the port")

    async def search_async(
        self,
        tokens: str,
        k: Optional[int] = 10,
        *,
        priority: int = 0,
        deadline_ms: Optional[float] = None,
        candidate_ids: Optional[Sequence[int]] = None,
    ) -> List[Tuple[int, float]]:
        """Awaitable token search through the batched engine: admission
        (with backpressure), micro-batching, pipelined scoring — without
        ever blocking the caller's event loop.  ``candidate_ids`` is the
        Phase-1 pre-filter output; filtered requests batch and route
        (masked-device vs gather-host) like every other request."""
        return await self.serving().asearch(
            tokens, k, priority=priority, deadline_ms=deadline_ms,
            candidate_ids=candidate_ids)

    async def flex_search_async(self, query: str) -> SearchResult:
        """Awaitable ``flex_search`` (SQL / @preset): the materializer is
        synchronous SQLite, so it runs on a worker thread."""
        return await asyncio.to_thread(self.flex_search, query)

    async def ingest_async(
        self,
        rows: Sequence[tuple],
        embeddings: Optional[np.ndarray] = None,
    ) -> int:
        """Awaitable :meth:`ingest` — the store lock may briefly wait for
        an in-flight scoring pass, so keep it off the event loop."""
        return await asyncio.to_thread(self.ingest, rows, embeddings)

    async def delete_async(self, ids: Sequence[int]) -> int:
        """Awaitable :meth:`delete` (same reasoning as ingest_async)."""
        return await asyncio.to_thread(self.delete, ids)

    def close(self) -> None:
        """Shut down the attached serving engine and the shard group's
        worker replicas — WITHOUT dropping accepted ingest: the engine's
        close flushes the vectorizer queue (every queued INSERT either
        embeds or dead-letters within its retry budget), and a journaled
        store writes a final checkpoint so the next open recovers the
        exact serving state with zero replay."""
        serving, self._serving = self._serving, None
        if serving is not None:
            serving.close()
        store = self.cache.store
        if store.journal is not None:
            vec = serving.vectorizer if serving is not None else None
            if vec is not None:
                pending = vec.queue.snapshot_rows()  # empty unless a
                #             sink failure interrupted the close flush
                dead = vec.dead_letters
            else:
                pending = store.recovered_pending
                dead = store.recovered_dead_letters
            store.checkpoint(pending=pending, dead_letters=dead)
            store.journal.close()
        if self._shard_group is not None:
            self._shard_group.close()
            self._shard_group = None

    # -- live-corpus entry points -------------------------------------------

    def ingest(
        self,
        rows: Sequence[tuple],
        embeddings: Optional[np.ndarray] = None,
    ) -> int:
        """Append chunk rows (the ``insert_chunks`` tuple shape) to SQLite
        + FTS and seal them as ONE new VectorCache segment.  Missing
        embeddings are computed from content.  Returns rows ingested."""
        rows = list(rows)
        if not rows:
            return 0
        # validate BEFORE touching SQLite: a duplicate live id would
        # otherwise REPLACE the row, desyncing FTS and the vector store
        dupes = [int(r[0]) for r in rows if int(r[0]) in self.cache.store]
        if dupes:
            raise ValueError(
                f"ingest: ids already live in the corpus: {dupes[:10]}"
                + ("..." if len(dupes) > 10 else "")
            )
        if embeddings is None:
            embeddings = np.stack(
                [self.embedder(r[3] or "") for r in rows]
            ).astype(np.float32)
        insert_chunks(self.conn, rows, embeddings)
        self.cache.ingest(
            [r[0] for r in rows], embeddings,
            [r[4] or 0.0 for r in rows],
        )
        if self._shard_group is not None:
            self._shard_group.append(
                [r[0] for r in rows], embeddings,
                [r[4] or 0.0 for r in rows])
        return len(rows)

    def delete(self, ids: Sequence[int]) -> int:
        """Remove chunks from SQLite + FTS, tombstone them in the cache."""
        removed = delete_chunks(self.conn, ids)
        if removed:
            self.cache.delete(removed)
            if self._shard_group is not None:
                self._shard_group.delete(removed)
        return len(removed)

    def stats(self) -> Dict[str, Any]:
        """Serving + storage + device-cache counters, one dict.

        ``device_cache`` (uploads/hits/evictions) appears when the resolved
        backend keeps device-resident segments.
        ``serving`` (queue_depth / rejected / deadline_misses /
        overlapped_batches / compactions_run) appears once the async
        batched engine is attached via :meth:`serving`.  ``prefilter``
        (threshold / routed_masked / routed_panel / routed_gather /
        mask_build_ms) is the Phase-1 selectivity router's ledger.
        ``fused`` (device_mmr / host_pool_transfers / panel_batches)
        tracks how often Phase-2 finished entirely on device and how
        often a host pool round-trip was still needed.
        """
        out: Dict[str, Any] = {
            "engine": self.engine.name,
            "queries": self.query_count,
            "errors": self.error_count,
            "store": self.cache.store.stats(),
            "prefilter": self.cache.prefilter.stats(),
            "fused": self.cache.fused.stats(),
        }
        if self._serving is not None:
            out["serving"] = self._serving.stats()
        vec = (self._serving.vectorizer
               if self._serving is not None else None)
        store = self.cache.store
        if vec is not None or store.journal is not None:
            # the durable-ingest ledger: queue/worker counters plus the
            # journal's recovery cost (records replayed at the last open,
            # bytes a crash right now would have to replay)
            ingest: Dict[str, Any] = {
                "queued": 0, "in_queue": 0, "rejected": 0, "embedded": 0,
                "batches": 0, "retries": 0, "dead_letter": 0,
            }
            if vec is not None:
                ingest.update(vec.stats())
            ingest["recovered_records"] = store.recovered_records
            ingest["journal_bytes"] = (
                store.journal.journal_bytes
                if store.journal is not None else 0)
            ingest["checkpoints"] = store.checkpoints
            out["ingest"] = ingest
        if self._shard_group is not None:
            # topology + per-shard memory/latency rows (the million-chunk
            # capacity ledger: each shard reports its scoring-resident
            # bytes and last fan-out pass latency)
            out["shard_group"] = self._shard_group.stats()
        plan_cache = getattr(self.engine, "plan_cache", None)
        if plan_cache is not None:
            out["plan_cache"] = plan_cache.stats()
        dev_stats = getattr(self.engine, "device_cache_stats", None)
        if dev_stats is not None:
            out["device_cache"] = dev_stats()
        return out
