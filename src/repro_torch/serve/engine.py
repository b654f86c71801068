"""Async continuous-batching serving engine (request micro-batching + pipelining).

The paper serves one agent query at a time (desktop MCP).  At fleet scale,
queries are MICRO-BATCHED so the corpus matrix is streamed once per batch
(pem_score's (d, B) query panel) — the arithmetic-intensity argument in
DESIGN.md §2.1 — and successive batches are PIPELINED: the Phase-2 path
splits into a device pass (``score_select_segments``: per-segment fused
score->select under the store lock) and a host tail
(``finalize_segment_candidates``: gather + MMR + id resolution over the
immutable segment snapshot, no lock needed), and the scheduler overlaps
the host tail of batch *i* with the device pass of batch *i+1* instead of
serializing behind it (Vextra's middleware argument: admission decoupled
from backend execution; Bruch frames re-ranking as a separable stage).

The core is an **asyncio event loop** on a private thread:

* **admission** — ``search`` (sync facade, thread-safe from any thread)
  and ``asearch`` (awaitable from any event loop) enqueue a
  :class:`Request`.  The queue is BOUNDED: past ``max_queue`` in-flight
  requests, admission rejects immediately with :class:`QueueFullError`
  (backpressure beats unbounded latency).  Parsing/validation happens AT
  admission, on the caller's thread: a bad request (grammar error, decay
  without timestamps) fails fast without ever consuming a queue slot,
  parse work spreads across client threads instead of serializing on the
  device stage, and the device pass stays dominated by the GIL-releasing
  matmul — which is what makes the stage overlap real parallelism.
* **collect** — the scheduler lingers after the first arrival (up to
  ``max_batch``), then drops requests whose deadline already passed
  (:class:`DeadlineExceededError`, counted in ``deadline_misses``) and
  serves the rest highest-``priority``-first (FIFO within a priority).
  With ``adaptive_window`` (default) the linger is a QUIESCENCE GAP
  learned online — an EWMA of inter-arrival deltas, clamped to
  [0.05 ms, 4·``max_wait_ms``] with a hard cap at 8·``max_wait_ms`` —
  so bursty closed-loop load keeps folding into one cohort while a lone
  request closes its window as soon as arrivals quiesce, instead of the
  fixed ``max_wait_ms`` fragmenting cohorts (``adaptive_window=False``
  restores the fixed window exactly).
* **pipeline** — one device pass and one host tail may be in flight at
  once (two single-thread executors); ``overlapped_batches`` counts
  batches whose device pass ran while the previous tail was still
  finishing.  With ``async_dispatch`` (default) the dispatch is REAL
  async: the scheduler submits the device pass as a future and returns
  to admission immediately — the loop thread is free DURING the pass,
  so the next cohort keeps forming while the device crunches (the
  admission window stays open until the device frees;
  ``overlapped_collects`` counts windows held open that way) and a
  completion task chains device future → host tail in batch order.
  ``async_dispatch=False`` keeps the await-in-dispatch pipeline step.
  ``pipeline=False`` reproduces the PRE-ASYNC synchronous core
  faithfully — parsing serialized inside the serve loop (not at
  admission) and the host tail serialized behind the device pass, the
  old one-thread strict collect→score→finalize phasing — kept as the
  benchmark comparator (`serve_throughput`) and conservative fallback.
* **idle gaps** — between batches the scheduler runs store maintenance:
  a :class:`~repro_torch.core.segments.CompactionPolicy`, when configured,
  folds sparse/fragmented segments.  Compaction shares the device
  executor AND the store lock with the scoring pass, so it can never
  land inside one.

Latency accounting uses ``time.monotonic()`` end to end, so an NTP step
can't produce negative or inflated latencies.  ``close()`` drains the
queue: every request not yet served fails with :class:`EngineClosedError`
instead of hanging into its timeout.

Phase-1 filtered queries are first-class batch citizens: ``search`` /
``asearch`` take ``candidate_ids`` and the device stage groups requests
by canonical candidate set — unfiltered requests share one segment pass,
each distinct filter shares one :func:`score_select_prefiltered` call
(the cache's selectivity router picks masked-device vs gather-host), and
every group produces the same ``(global_rows, scores)`` contract, so the
host tail and the pipeline overlap are untouched.

Live corpora: :meth:`ingest` and :meth:`delete` append/tombstone chunks
between batches (the store lock spans one device pass, so a mutation
never lands inside a batch).  Failure isolation is per request: a bad
request (grammar error, decay without timestamps) fails ONLY that
request; a backend failure fails its batch loudly.  Scoring routes
through the shared :mod:`repro_torch.core.backends` dispatch — the same device
pass + host tail as the direct ``VectorCache`` engine, so batched and
direct rankings are bit-identical.
"""

from __future__ import annotations

import asyncio
import concurrent.futures as cf
import dataclasses
import itertools
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.backends import (ExecutionBackend, HopperBackend,
                                       finalize_fusion,
                                       finalize_segment_candidates,
                                       fusion_bias_arrays, get_backend,
                                       score_select_filter_panel,
                                       score_select_prefiltered,
                                       score_select_segments)
from repro_torch.core import modulations as M
from repro_torch.core.grammar import parse
from repro_torch.core.segments import CompactionPolicy
from repro_torch.core.vectorcache import VectorCache

__all__ = [
    "BatchedRetrievalEngine",
    "Request",
    "EngineClosedError",
    "QueueFullError",
    "DeadlineExceededError",
]

_IDLE_TICK_S = 0.05  # scheduler wake period when the queue is empty


class EngineClosedError(RuntimeError):
    """The engine was closed; the request was drained, not served."""


class QueueFullError(RuntimeError):
    """Admission rejected: the bounded queue is at capacity (backpressure)."""


class DeadlineExceededError(TimeoutError):
    """The request's deadline passed before a batch could serve it."""


_seq = itertools.count()


@dataclasses.dataclass
class Request:
    tokens: str
    k: Optional[int] = 10              # None = the parsed plan's pool size
    priority: int = 0                  # higher serves sooner at collect time
    deadline_ms: Optional[float] = None  # relative to enqueue; None = never
    # Phase-1 pre-filter output; canonicalized (unique, sorted) at
    # construction on the CALLER's thread so identical filters from
    # different clients group into one scoring call at the device stage
    candidate_ids: Optional[np.ndarray] = None
    # monotonic clock: NTP steps can't produce negative/inflated latencies
    enqueued_at: float = dataclasses.field(default_factory=time.monotonic)
    latency_ms: float = 0.0
    plan: Optional[Any] = None         # parsed at admission (see _submit)
    seq: int = dataclasses.field(default_factory=lambda: next(_seq))
    future: "cf.Future[List[Tuple[int, float]]]" = dataclasses.field(
        default_factory=cf.Future)

    def __post_init__(self) -> None:
        if self.candidate_ids is None:
            self._filter_key = None
        else:
            arr = (self.candidate_ids
                   if isinstance(self.candidate_ids, np.ndarray)
                   else np.asarray(list(self.candidate_ids), dtype=np.int64))
            self.candidate_ids = np.unique(arr.astype(np.int64, copy=False))
            self._filter_key = self.candidate_ids.tobytes()

    @property
    def filter_key(self) -> Optional[bytes]:
        """Batch-grouping key: requests with the same canonical candidate
        set share one filtered scoring call (None = unfiltered); computed
        once at admission, not per batch."""
        return self._filter_key

    def apply_plan_filter(self) -> None:
        """``fuse:filter`` plans promote their lexical FTS hit set to the
        Phase-1 candidate set (intersecting any SQL pre-filter) — called
        once the plan is known, so the device stage groups sharp-keyword
        hybrids by hit set and routes them through the selectivity-aware
        prefilter exactly like SQL-filtered requests."""
        if self.plan is None:
            return
        cand = M.filter_candidate_ids(self.plan, self.candidate_ids)
        if cand is not self.candidate_ids:
            self.candidate_ids = np.unique(
                np.asarray(cand, dtype=np.int64))
            self._filter_key = self.candidate_ids.tobytes()

    def expired(self, now_monotonic: float) -> bool:
        if self.deadline_ms is None:
            return False
        return (now_monotonic - self.enqueued_at) * 1e3 > self.deadline_ms


@dataclasses.dataclass
class _TailWork:
    """One batch's hand-off from the device pass to the host tail."""

    requests: List[Request]
    plans: List[Any]
    segments: Tuple  # immutable snapshot; safe to read without the lock
    ks: List[int]
    selected: List[Tuple[np.ndarray, np.ndarray]]
    mmr_done: bool = False  # device pass already finished diversity on device
    # shard-group fan-out: ``selected`` holds FINAL per-request result
    # lists (ids resolved, diversity and rrf done at the coordinator);
    # the tail only truncates to each request's k and delivers
    final: bool = False


class BatchedRetrievalEngine:
    """Continuous-batching retrieval engine with a sync facade.

    ``search()`` keeps the original thread-safe blocking contract (the
    materializer path and every existing caller work unchanged);
    ``asearch()`` is the awaitable entry point for async servers.
    """

    def __init__(
        self,
        cache: VectorCache,
        max_batch: int = 32,
        max_wait_ms: float = 2.0,
        now: Optional[float] = None,
        engine: Union[str, ExecutionBackend, None] = None,
        *,
        max_queue: int = 256,
        pipeline: bool = True,
        async_dispatch: bool = True,
        adaptive_window: bool = True,
        compaction: Optional[CompactionPolicy] = None,
        shard_group: Optional[Any] = None,
        vectorizer: Optional[Any] = None,
    ):
        self.cache = cache
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.now = now
        # no engine means the Hopper kernels on the card (see RetrievalService)
        self.backend = HopperBackend() if engine is None else get_backend(engine)
        self.max_queue = max_queue
        self.pipeline = pipeline
        # real async dispatch rides the pipeline split; the sync-core
        # comparator keeps its strict one-thread phasing
        self.async_dispatch = bool(async_dispatch and pipeline)
        self.adaptive_window = adaptive_window
        self.compaction = compaction
        # cross-process shard router (a ProcessGroup, a later slice of the port):
        # when attached, the device stage fans each collected batch out to
        # one replica per shard and merges with the exact-union contract
        # instead of scoring the local cache; admission, batching,
        # priorities and the pipeline overlap are unchanged
        self.shard_group = shard_group
        # background ingest vectorizer (repro_torch.serve.vectorizer.
        # VectorizerWorker): when attached, the materializer enqueues
        # missing-embedding INSERT rows here and the idle-gap hook (next
        # to compaction) drains them in batches through the embedder
        self.vectorizer = vectorizer

        # counters (single-writer or benign int bumps, same as the store's)
        self.batches_served = 0
        self.requests_served = 0
        self.rejected = 0            # admissions refused at capacity
        self.shed_low_priority = 0   # queued requests evicted for a
        #                              higher-priority newcomer at capacity
        self.deadline_misses = 0     # requests expired at collect time
        self.overlapped_batches = 0  # device pass ran while prev tail ran
        self.overlapped_collects = 0  # admission windows held open on a
        #                               busy device (async dispatch)
        self.windows_extended = 0    # adaptive windows that outlingered base
        self.compactions_run = 0     # idle-gap compactions that folded
        self.vectorizer_drains = 0   # idle-gap vectorizer batches ingested

        self._depth = 0              # queued, not yet collected into a batch
        self._queued: Dict[int, Request] = {}  # seq -> queued request, the
        #                              shedding candidate set (admission lock)
        self._admission_lock = threading.Lock()
        self._closed = False         # no new admissions (set by close())
        self._closing = False        # loop-confined shutdown flag
        self._done = threading.Event()

        self._pending: List[Request] = []       # loop-confined
        self._arrival = asyncio.Event()         # loop-confined
        self._tail_fut: Optional[asyncio.Future] = None
        # async-dispatch state (loop-confined except _tail_running, which
        # the tail thread clears when its host tail actually finishes)
        self._dev_fut: Optional[asyncio.Future] = None
        self._finish_task: Optional[asyncio.Task] = None
        self._tail_running = False
        # adaptive window state: EWMA of inter-arrival gaps (ms); None
        # until the first delta lands, so the static base stays in force
        self._gap_ms: Optional[float] = None
        self._last_arrival_t: Optional[float] = None

        # one thread per pipeline stage: the device pass and the host tail
        # each get a dedicated executor, so exactly one of each runs at a
        # time and the two stages genuinely overlap
        self._dev_pool = cf.ThreadPoolExecutor(
            1, thread_name_prefix="flexvec-device")
        self._tail_pool = cf.ThreadPoolExecutor(
            1, thread_name_prefix="flexvec-tail")

        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, name="flexvec-scheduler",
            daemon=True)
        self._thread.start()
        self._scheduler_fut = asyncio.run_coroutine_threadsafe(
            self._scheduler(), self._loop)

    # -- public API ----------------------------------------------------------

    def search(
        self,
        tokens: str,
        k: Optional[int] = 10,
        timeout: float = 30.0,
        *,
        priority: int = 0,
        deadline_ms: Optional[float] = None,
        candidate_ids: Optional[Sequence[int]] = None,
        plan: Optional[Any] = None,
    ) -> List[Tuple[int, float]]:
        """Blocking search (thread-safe).  Raises :class:`QueueFullError`
        at capacity, :class:`DeadlineExceededError` past ``deadline_ms``,
        :class:`EngineClosedError` after :meth:`close`.

        ``candidate_ids`` is the Phase-1 pre-filter output (None = full
        corpus); filtered requests batch and pipeline like everything
        else, routed masked-device vs gather-host by the cache's
        selectivity router.  ``k=None`` serves the plan's full pool.
        ``plan`` hands over an already-parsed ModulationPlan for
        ``tokens`` — admission skips re-parsing (the materializer uses
        this so SQL-surface queries don't pay the parse+embed twice)."""
        req = Request(tokens=tokens, k=k, priority=priority,
                      deadline_ms=deadline_ms, candidate_ids=candidate_ids,
                      plan=plan)
        self._submit(req)
        try:
            return req.future.result(timeout)
        except DeadlineExceededError:
            raise
        except cf.TimeoutError:
            raise TimeoutError("retrieval request timed out") from None

    async def asearch(
        self,
        tokens: str,
        k: Optional[int] = 10,
        *,
        priority: int = 0,
        deadline_ms: Optional[float] = None,
        candidate_ids: Optional[Sequence[int]] = None,
        plan: Optional[Any] = None,
    ) -> List[Tuple[int, float]]:
        """Awaitable search: usable from ANY event loop (the engine runs
        its own private loop; results cross via the request future)."""
        req = Request(tokens=tokens, k=k, priority=priority,
                      deadline_ms=deadline_ms, candidate_ids=candidate_ids,
                      plan=plan)
        self._submit(req)
        return await asyncio.wrap_future(req.future)

    def close(self) -> None:
        """Stop the scheduler and DRAIN the queue: every request not yet
        served fails with :class:`EngineClosedError` immediately — nothing
        hangs into its timeout.  Pending ingest is NOT dropped: the
        vectorizer queue is flushed (every accepted row either embeds or
        dead-letters within its retry budget) before the executors stop."""
        with self._admission_lock:
            if self._closed:
                return
            self._closed = True
        try:
            self._loop.call_soon_threadsafe(self._signal_close)
        except RuntimeError:  # loop already stopped
            pass
        self._done.wait(timeout=30.0)
        self._thread.join(timeout=2.0)
        if self.vectorizer is not None:
            # the scheduler has stopped (no concurrent idle-gap drain);
            # flush on the closing thread so accepted INSERTs land
            self.vectorizer.flush()
        if not self._thread.is_alive():
            # closing the loop makes a racing _submit's
            # call_soon_threadsafe raise (-> EngineClosedError) instead
            # of silently enqueueing onto a dead loop, and releases the
            # loop's fds
            self._loop.close()
        self._dev_pool.shutdown(wait=False)
        self._tail_pool.shutdown(wait=False)

    def ingest(
        self,
        ids: Sequence[int],
        matrix: np.ndarray,
        timestamps: Optional[Sequence[float]] = None,
        *,
        normalized: bool = False,
    ):
        """Append chunks as one sealed segment; lands between batches
        (the store lock spans one device pass). Returns the new segment.
        An attached shard group mirrors the append (each shard normalizes
        its slice row-wise, so replicas match the cache bit for bit)."""
        seg = self.cache.ingest(ids, matrix, timestamps,
                                normalized=normalized)
        if self.shard_group is not None:
            self.shard_group.append(ids, matrix, timestamps,
                                    normalized=normalized)
        return seg

    def delete(self, ids: Sequence[int], *, strict: bool = False) -> int:
        """Tombstone chunks between batches; returns rows tombstoned.
        Rows still waiting in the ingest queue are discarded too — a
        DELETE racing a not-yet-embedded INSERT must not resurrect it."""
        removed = self.cache.delete(ids, strict=strict)
        if self.vectorizer is not None:
            self.vectorizer.queue.discard(ids)
        if self.shard_group is not None:
            self.shard_group.delete(ids)
        return removed

    def enqueue_ingest(self, rows: Sequence[Tuple[int, str,
                                                  Optional[float]]]) -> int:
        """Admit ``(chunk_id, content, timestamp)`` rows to the background
        vectorizer (the materializer's INSERT path when embeddings are
        missing).  Raises :class:`~repro_torch.serve.vectorizer.
        IngestQueueFullError` at capacity — ingest backpressure surfaces
        to the SQL caller like admission backpressure does to search."""
        if self.vectorizer is None:
            raise RuntimeError(
                "enqueue_ingest: engine has no vectorizer attached")
        return self.vectorizer.enqueue(rows)

    @property
    def queue_depth(self) -> int:
        """Requests admitted but not yet collected into a batch."""
        with self._admission_lock:
            return self._depth

    def stats(self) -> Dict[str, int]:
        """Serving counters (surfaced via ``RetrievalService.stats()``)."""
        return {
            "queue_depth": self.queue_depth,
            "max_queue": self.max_queue,
            "batches_served": self.batches_served,
            "requests_served": self.requests_served,
            "rejected": self.rejected,
            "shed_low_priority": self.shed_low_priority,
            "deadline_misses": self.deadline_misses,
            "overlapped_batches": self.overlapped_batches,
            "overlapped_collects": self.overlapped_collects,
            "windows_extended": self.windows_extended,
            "window_ms": round(self._window_s() * 1e3, 3),
            "async_dispatch": self.async_dispatch,
            "adaptive_window": self.adaptive_window,
            "compactions_run": self.compactions_run,
            "vectorizer_drains": self.vectorizer_drains,
        }

    # -- admission -----------------------------------------------------------

    def _submit(self, req: Request) -> None:
        with self._admission_lock:
            if self._closed:
                raise EngineClosedError("engine is closed")
            if self._depth >= self.max_queue:
                # priority-aware shedding: at capacity, evict the lowest-
                # priority queued request (newest arrival among ties) and
                # hand its slot to the newcomer; the newcomer is rejected
                # only if it is itself lowest.  Selection, eviction and
                # the victim's failure all happen under the admission
                # lock, so collect (which pops under the same lock) can
                # never serve an evicted request.
                victim: Optional[Request] = None
                if self._queued:
                    low = min(self._queued.values(),
                              key=lambda r: (r.priority, -r.seq))
                    if low.priority < req.priority:
                        victim = low
                if victim is None:
                    self.rejected += 1
                    raise QueueFullError(
                        f"admission queue at capacity ({self.max_queue}); "
                        f"retry with backoff")
                del self._queued[victim.seq]
                self.shed_low_priority += 1
                self._fail(victim, QueueFullError(
                    f"shed at capacity for a priority-{req.priority} "
                    f"request (this request was priority {victim.priority})"),
                    count_depth=False)  # its slot transfers to the newcomer
            else:
                self._depth += 1  # slot reserved before the (costly) parse
            self._queued[req.seq] = req
        try:
            if req.plan is not None:
                # pre-parsed plan handed over (materializer path): skip
                # the duplicate parse+embed, but still validate at
                # admission so a bad request fails fast in BOTH modes
                self._validate(req.plan)
            elif self.pipeline:
                # parse + validate on the CALLER's thread: bad requests
                # fail fast (no queue slot held), parse work spreads
                # across client threads instead of serializing on the
                # device stage, which stays matmul-dominated.  The sync-
                # core comparator keeps the legacy behavior (parse inside
                # the serve loop, errors delivered via the future).
                req.plan = self._parse(req)
            req.apply_plan_filter()
        except Exception:
            self._release_slot(req)
            raise
        try:
            self._loop.call_soon_threadsafe(self._admit, req)
        except RuntimeError:  # loop closed between the check and the call
            self._release_slot(req)
            raise EngineClosedError("engine is closed") from None

    def _release_slot(self, req: Request) -> None:
        """Free one admission slot and drop the request from the shedding
        candidate set (no-op on the latter if collect already took it)."""
        with self._admission_lock:
            self._depth -= 1
            self._queued.pop(req.seq, None)

    def _parse(self, req: Request):
        plan = parse(req.tokens, self.cache.embed_fn,
                     self.cache.embeddings_for_ids,
                     self.cache.lexical_fn)
        self._validate(plan)
        return plan

    def _validate(self, plan) -> None:
        if plan.decay is not None and not self.cache.store.has_timestamps:
            raise ValueError("decay: requires timestamps in the cache")

    def _window_s(self) -> float:
        """Current admission-window linger in seconds: the static base, or
        the learned quiescence gap clamped to [0.05 ms, 4·base]."""
        if not self.adaptive_window or self._gap_ms is None:
            return self.max_wait_ms / 1e3
        return min(max(self._gap_ms, 0.05), self.max_wait_ms * 4) / 1e3

    def _admit(self, req: Request) -> None:  # loop thread
        if self._closing:
            self._fail(req, EngineClosedError(
                "engine closed before the request was served"))
            return
        t = self._loop.time()
        last = self._last_arrival_t
        self._last_arrival_t = t
        if self.adaptive_window and last is not None:
            delta_ms = (t - last) * 1e3
            # a gap past the hard cap is a NEW burst, not a cadence
            # sample — folding it in would freeze the window wide open
            if delta_ms <= self.max_wait_ms * 8:
                g = self._gap_ms
                self._gap_ms = (delta_ms if g is None
                                else g + 0.2 * (delta_ms - g))
        self._pending.append(req)
        self._arrival.set()

    def _signal_close(self) -> None:  # loop thread
        self._closing = True
        self._arrival.set()

    # -- scheduler (loop thread) ---------------------------------------------

    async def _scheduler(self) -> None:
        try:
            while not self._closing:
                batch = await self._collect()
                if self._closing:
                    # already depth-decremented at collect; fail in place
                    for req in batch:
                        self._fail(req, EngineClosedError(
                            "engine closed before the request was served"),
                            count_depth=False)
                    break
                if not batch:
                    await self._idle_maintenance()
                    continue
                await self._dispatch(batch)
        finally:
            pending, self._pending = self._pending, []
            for req in pending:
                if req.future.done():
                    continue  # shed at admission; slot already transferred
                self._fail(req, EngineClosedError(
                    "engine closed before the request was served"))
            if self._finish_task is not None:
                # async dispatch: the completion chain delivers the last
                # in-flight batch (device future -> host tail) — drain it
                try:
                    await self._finish_task
                except Exception:
                    pass
            if self._tail_fut is not None:
                try:
                    await self._tail_fut
                except Exception:
                    pass
            self._done.set()
            self._loop.call_soon(self._loop.stop)

    async def _collect(self) -> List[Request]:
        """One admission window: first arrival, then linger (fixed
        ``max_wait_ms``, or the learned quiescence gap per arrival when
        ``adaptive_window`` — close as soon as arrivals quiesce, hard cap
        8·base); under async dispatch a busy device HOLDS the window open
        (arrivals keep folding into this cohort — queuing a micro-batch
        behind the pass would only fragment it); expire deadlines; pick
        the highest-priority ``max_batch`` (FIFO within a priority)."""
        if not self._pending:
            self._arrival.clear()
            try:
                await asyncio.wait_for(self._arrival.wait(), _IDLE_TICK_S)
            except asyncio.TimeoutError:
                return []
        if self._closing:
            return []
        start = self._loop.time()
        base_s = self.max_wait_ms / 1e3
        deadline = start + base_s
        hard_deadline = start + base_s * 8
        while len(self._pending) < self.max_batch:
            now_t = self._loop.time()
            if self.adaptive_window:
                # each arrival re-arms a quiescence gap: the window stays
                # open while the burst keeps delivering, closes one gap
                # after it stops
                deadline = min(now_t + self._window_s(), hard_deadline)
            remaining = deadline - now_t
            if remaining <= 0:
                break
            self._arrival.clear()
            try:
                await asyncio.wait_for(self._arrival.wait(), remaining)
            except asyncio.TimeoutError:
                break
            if self._closing:
                return []
        if self.adaptive_window and self._loop.time() - start > base_s:
            self.windows_extended += 1

        if self.async_dispatch:
            dev = self._dev_fut
            if dev is not None and not dev.done():
                if self._pending:
                    self.overlapped_collects += 1
                try:
                    await dev  # arrivals keep appending while we wait
                except Exception:
                    pass  # the completion chain fails that batch

        now_mono = time.monotonic()
        live: List[Request] = []
        expired: List[Request] = []
        with self._admission_lock:
            # partition under the admission lock: a request shed by a
            # concurrent _submit has a done future (set under this same
            # lock) and is dropped here without touching its slot — that
            # slot now belongs to the newcomer that evicted it
            for req in self._pending:
                if req.future.done():
                    continue
                (expired if req.expired(now_mono) else live).append(req)
            live.sort(key=lambda r: (-r.priority, r.seq))
            batch, rest = live[:self.max_batch], live[self.max_batch:]
            self._depth -= len(batch) + len(expired)
            for req in batch:
                self._queued.pop(req.seq, None)
            for req in expired:
                self._queued.pop(req.seq, None)
        self._pending = rest
        for req in expired:
            self.deadline_misses += 1
            self._fail(req, DeadlineExceededError(
                f"deadline of {req.deadline_ms:.1f} ms passed before the "
                f"request reached a batch"), count_depth=False)
        return batch

    async def _idle_maintenance(self) -> None:
        """Store maintenance in the scheduler's idle gaps.  Both the
        ingest vectorizer drain and compaction run on the DEVICE executor
        and take the store lock, so neither can land inside a scoring
        pass — and never even queues behind one mid-batch, because the
        executor is busy exactly then."""
        if self._dev_fut is not None and not self._dev_fut.done():
            # async dispatch: a pass is in flight on the device executor —
            # don't queue maintenance behind it, the next idle gap will do
            return
        vec = self.vectorizer
        if vec is not None and vec.has_due():
            ingested = await self._loop.run_in_executor(
                self._dev_pool, vec.drain_once)
            if ingested:
                self.vectorizer_drains += 1
        policy = self.compaction
        if policy is None:
            return
        store = self.cache.store
        if not policy.should_compact(store):
            return
        folded = await self._loop.run_in_executor(
            self._dev_pool, store.maybe_compact, policy)
        if folded:
            self.compactions_run += 1

    async def _dispatch(self, batch: List[Request]) -> None:
        """Two-stage pipeline step: run this batch's device pass while the
        PREVIOUS batch's host tail is (possibly) still finishing.

        Async mode submits the device pass as a FUTURE and returns to the
        scheduler immediately — the loop thread is free during the pass
        (admission keeps forming the next cohort) and a completion task
        chains device future → host tail, tails strictly in batch order,
        at most one tail outstanding."""
        if self.async_dispatch:
            prev_finish = self._finish_task
            dev_fut = self._loop.run_in_executor(
                self._dev_pool, self._device_stage_async, batch)
            self._dev_fut = dev_fut
            self._finish_task = self._loop.create_task(
                self._finish_batch(batch, dev_fut, prev_finish))
            return
        prev_tail = self._tail_fut
        overlapped = prev_tail is not None and not prev_tail.done()
        try:
            work = await self._loop.run_in_executor(
                self._dev_pool, self._device_stage, batch)
        except Exception as e:  # defensive: _device_stage fails per request
            for req in batch:
                if not req.future.done():
                    self._fail(req, e, count_depth=False)
            return
        if overlapped:
            self.overlapped_batches += 1
        if prev_tail is not None:
            # bound the pipeline at ONE outstanding tail (keeps memory and
            # result latency bounded if tails ever run slower than passes)
            try:
                await prev_tail
            except Exception:
                pass
            self._tail_fut = None
        if work is None:
            return
        self._tail_fut = self._loop.run_in_executor(
            self._tail_pool, self._host_tail, work)
        if not self.pipeline:
            # synchronous-core comparator: serialize tail behind the pass
            try:
                await self._tail_fut
            except Exception:
                pass
            self._tail_fut = None

    async def _finish_batch(self, batch: List[Request],
                            dev_fut: asyncio.Future,
                            prev_finish: Optional[asyncio.Task]) -> None:
        """Async-dispatch completion chain: await this batch's device
        future, then the previous batch's chain (tails launch strictly in
        batch order), then the previous tail itself (at most ONE tail
        outstanding, same bound as the legacy step), then hand off to the
        host tail executor."""
        try:
            work = await dev_fut
        except Exception as e:  # defensive: _device_stage fails per request
            if prev_finish is not None:
                try:
                    await prev_finish
                except Exception:
                    pass
            for req in batch:
                if not req.future.done():
                    self._fail(req, e, count_depth=False)
            return
        if prev_finish is not None:
            try:
                await prev_finish
            except Exception:
                pass
        prev_tail = self._tail_fut
        if prev_tail is not None:
            try:
                await prev_tail
            except Exception:
                pass
            self._tail_fut = None
        if work is None:
            return
        # flag raised on the LOOP thread before the submit, cleared by the
        # tail thread when the tail truly finishes: the next device stage
        # reads it at ITS start, so the overlap counter measures real
        # device-pass/host-tail concurrency, not dispatch bookkeeping
        self._tail_running = True
        self._tail_fut = self._loop.run_in_executor(
            self._tail_pool, self._run_tail, work)

    # -- pipeline stages (executor threads) ----------------------------------

    def _device_stage_async(self, batch: List[Request]) -> Optional[_TailWork]:
        if self._tail_running:
            self.overlapped_batches += 1
        return self._device_stage(batch)

    def _run_tail(self, work: _TailWork) -> None:
        try:
            self._host_tail(work)
        finally:
            self._tail_running = False

    def _device_stage(self, batch: List[Request]) -> Optional[_TailWork]:
        """One fused backend pass: fold every request's (admission-parsed)
        plan into the (d, B) panels and run the segment-aware
        ``score_select_segments`` — every segment is scored ONCE for the
        whole batch (tombstones masked on device) and only per-request
        candidate lists come back (the (N, B) panel never leaves the
        backend).  This stage is matmul-dominated (parse happened at
        admission), so it releases the GIL while the previous batch's
        host tail finishes — that is the pipeline's overlap.  In
        sync-core mode requests arrive unparsed and parse HERE,
        serially, exactly like the legacy one-thread engine."""
        store = self.cache.store
        live: List[Request] = []
        plans: List[Any] = []
        for req in batch:
            if req.plan is None:  # sync-core comparator: parse in-loop
                try:
                    req.plan = self._parse(req)
                    req.apply_plan_filter()
                except Exception as e:  # bad request: fail it, keep the batch
                    self._fail(req, e, count_depth=False)
                    continue
            live.append(req)
            plans.append(req.plan)

        self.batches_served += 1
        if not live:
            return None

        ref = self.now if self.now is not None else time.time()
        if self.shard_group is not None:
            # shard-router fan-out: the whole collected batch goes to one
            # replica per shard as ONE plan cohort (heterogeneous filters
            # ride each shard's mask panel) and comes back merged + final
            # — the host tail only truncates to each request's k
            try:
                n_live = self.shard_group.n_live
                ks = []
                for req in live:
                    k_req = req.k if req.k is not None else req.plan.pool
                    f = req.plan.fusion
                    if f is not None and f.mode == "rrf":
                        k_req = max(k_req, req.plan.pool)
                    ks.append(min(k_req, n_live))
                results = self.shard_group.search_plan_batch(
                    plans, [req.candidate_ids for req in live],
                    now=ref, ks=ks)
            except Exception as e:  # group failure: fail the batch loudly
                for req in live:
                    self._fail(req, e, count_depth=False)
                return None
            return _TailWork(live, plans, (), ks, results,
                             mmr_done=True, final=True)
        try:
            # the lock spans snapshot + scoring: ingest/delete/compaction
            # land BETWEEN batches, never inside one
            with store.lock:
                segs = store.segments
                n_live = store.n_live
                ks = []
                for req in live:
                    k_req = req.k if req.k is not None else req.plan.pool
                    f = req.plan.fusion
                    if f is not None and f.mode == "rrf":
                        # rrf fuses on host over the POOL-width vector
                        # ranking (parity with the direct path); the tail
                        # truncates back to the request's k afterwards
                        k_req = max(k_req, req.plan.pool)
                    ks.append(min(k_req, n_live))
                # group by Phase-1 filter: unfiltered requests share one
                # segment pass; each distinct candidate set shares one
                # routed (masked-device / gather-host) pass — identical
                # filters from different clients fold into one call
                groups: "OrderedDict[Optional[bytes], List[int]]"
                groups = OrderedDict()
                for j, req in enumerate(live):
                    groups.setdefault(req.filter_key, []).append(j)
                router = self.cache.prefilter
                counters = self.cache.fused
                selected: List = [None] * len(live)
                counts = [None if key is None
                          else int(live[idxs[0]].candidate_ids.size)
                          for key, idxs in groups.items()]
                if router.use_panel(counts, n_live):
                    # heterogeneous-filter cohort: ONE batched (N, B)
                    # mask-panel pass for the whole batch instead of one
                    # pass per distinct filter — unfiltered requests ride
                    # along as all-live columns, so the cohort never
                    # splits (see score_select_filter_panel)
                    selected = score_select_filter_panel(
                        self.backend, store, segs, plans, ks,
                        [req.candidate_ids for req in live], now=ref,
                        router=router, counters=counters,
                        score_bias=fusion_bias_arrays(store, segs, plans))
                else:
                    for key, idxs in groups.items():
                        g_plans = [plans[j] for j in idxs]
                        g_ks = [ks[j] for j in idxs]
                        # hybrid requests ride the batch as a sparse
                        # additive score panel (None when the group has
                        # no weighted-fusion plans — the common case)
                        g_bias = fusion_bias_arrays(store, segs, g_plans)
                        if key is None:
                            # the batch IS a cohort: one fused (d, 2·Q)
                            # panel per segment pass, pow2 Q-bucketed on
                            # device backends so varying cohort sizes
                            # share executables
                            sel = score_select_segments(
                                self.backend, segs, g_plans, g_ks, now=ref,
                                counters=counters, score_bias=g_bias,
                                cohort=True)
                        else:
                            sel = score_select_prefiltered(
                                self.backend, store, segs, g_plans, g_ks,
                                live[idxs[0]].candidate_ids, now=ref,
                                router=router, weight=len(idxs),
                                counters=counters, score_bias=g_bias)
                        for j, s in zip(idxs, sel):
                            selected[j] = s
        except Exception as e:  # backend failure: fail the whole batch loudly
            for req in live:
                self._fail(req, e, count_depth=False)
            return None
        return _TailWork(live, plans, segs, ks, selected,
                         mmr_done=self.backend.device_mmr)

    def _host_tail(self, work: _TailWork) -> None:
        """Finish each request over the immutable segment snapshot (no
        lock): gather the candidate pool, truncate/MMR, resolve ids —
        exactly :func:`finalize_segment_candidates`, the same host tail
        the direct path runs, called per request so one bad finish fails
        only its request.

        Results are computed for the WHOLE batch first and delivered in
        one burst at the end: each delivery wakes a (possibly closed-loop)
        client whose next admission parse grabs the GIL, so delivering
        mid-loop would let those parses convoy against the remaining MMR
        work.  Delivered at the end, the wake-up storm lands during the
        next batch's GIL-releasing device pass instead."""
        if work.final:
            # shard-group results arrive final (diversity + fusion done at
            # the coordinator, pool-width like the direct path): hand back k
            for req, res in zip(work.requests, work.selected):
                self._finish(req, res if req.k is None else res[:req.k])
            return
        done: List[Tuple[Request, Optional[List[Tuple[int, float]]],
                         Optional[Exception]]] = []
        for req, plan, k, sel in zip(work.requests, work.plans, work.ks,
                                     work.selected):
            try:
                (results,) = finalize_segment_candidates(
                    work.segments, [plan], [k], [sel],
                    mmr_done=work.mmr_done, counters=self.cache.fused)
                # fuse:rrf finishes on host (rank fusion is not a linear
                # bias); weighted fusion already happened on device
                results = finalize_fusion(
                    plan, results, k, store=self.cache.store,
                    candidate_ids=req.candidate_ids)
                if req.k is not None:
                    # rrf requests score at pool width; hand back k
                    results = results[:req.k]
                done.append((req, results, None))
            except Exception as e:
                done.append((req, None, e))
        for req, results, err in done:
            if err is not None:
                self._fail(req, err, count_depth=False)
            else:
                self._finish(req, results)

    # -- completion ----------------------------------------------------------

    def _fail(self, req: Request, err: Exception, *,
              count_depth: bool = True) -> None:
        req.latency_ms = (time.monotonic() - req.enqueued_at) * 1e3
        if count_depth:
            self._release_slot(req)
        try:
            req.future.set_exception(err)
        except cf.InvalidStateError:  # pragma: no cover - already completed
            pass

    def _finish(self, req: Request, result: List[Tuple[int, float]]) -> None:
        req.latency_ms = (time.monotonic() - req.enqueued_at) * 1e3
        self.requests_served += 1
        try:
            req.future.set_result(result)
        except cf.InvalidStateError:  # pragma: no cover - already completed
            pass
