"""Background ingest vectorizer: bounded queue + batching embed worker.

The materializer used to embed missing vectors synchronously inside
``INSERT INTO chunks`` — every insert paid an embedder round-trip, and an
embedder outage failed the write path.  Production vector stores decouple
the two (timescale pgai's vectorizer and p8k8's ``embedding_queue`` both
run trigger -> queue -> batching worker): the INSERT *enqueues* and
returns, and a background worker drains the queue in batches through the
embedder, with retry/backoff on failure.

* :class:`IngestQueue` — a bounded FIFO of :class:`PendingChunk` rows.
  ``put`` raises :class:`IngestQueueFullError` at capacity (backpressure
  surfaces to the SQL caller instead of unbounded memory growth).
* :class:`VectorizerWorker` — drains due rows in batches through an
  ``embed_fn`` and hands ``(ids, vectors, timestamps)`` to a sink
  (``VectorCache.ingest``).  A failed batch retries with exponential
  backoff + deterministic jitter; rows exhausting ``max_attempts`` spill
  to a **dead-letter list** (journaled, visible in ``stats()``, never
  retried again) so one poison row can't wedge the queue.

The worker owns NO thread: the serving scheduler's idle-gap hook (where
compaction already runs) calls :meth:`VectorizerWorker.drain_once`, so
embedding happens between request batches on the same executor that owns
the store lock's device pass.  ``clock`` is injectable — the backoff
schedule is tested against a fake clock, not wall time.

Durability: when the owning store has a journal, accepted rows are
journaled as ``enqueue`` records (and dead letters as ``dead_letter``),
so a crash cannot silently drop an acknowledged INSERT —
``SegmentedCorpusStore.open`` resurfaces them in ``recovered_pending``.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.journal import FaultPlan, StoreJournal

__all__ = [
    "EmbedderError",
    "IngestQueueFullError",
    "PendingChunk",
    "IngestQueue",
    "VectorizerWorker",
]

Row = Tuple[int, str, Optional[float]]


class IngestQueueFullError(RuntimeError):
    """The bounded ingest queue is at capacity (backpressure)."""


class EmbedderError(RuntimeError):
    """Injected/propagated embedder failure (retryable)."""


@dataclasses.dataclass
class PendingChunk:
    """One enqueued row awaiting embedding."""

    chunk_id: int
    content: str
    timestamp: Optional[float]
    attempts: int = 0
    due_at: float = 0.0  # worker-clock time when (re)eligible

    @property
    def row(self) -> Row:
        return (self.chunk_id, self.content, self.timestamp)


class IngestQueue:
    """Bounded, thread-safe FIFO of pending rows.

    Retried rows rejoin at the BACK with a future ``due_at`` (their
    backoff), so fresh rows are not starved behind a failing batch.
    """

    def __init__(self, maxsize: int = 1024) -> None:
        self.maxsize = int(maxsize)
        self._items: List[PendingChunk] = []
        self._lock = threading.Lock()
        self.accepted = 0
        self.rejected = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def put(self, rows: Sequence[Row]) -> int:
        """Enqueue ``rows``; all-or-nothing at capacity."""
        rows = list(rows)
        with self._lock:
            if len(self._items) + len(rows) > self.maxsize:
                self.rejected += len(rows)
                raise IngestQueueFullError(
                    f"ingest queue full ({len(self._items)}/{self.maxsize}; "
                    f"{len(rows)} offered)")
            for cid, content, ts in rows:
                self._items.append(PendingChunk(int(cid), content, ts))
            self.accepted += len(rows)
            return len(rows)

    def requeue(self, items: Sequence[PendingChunk]) -> None:
        """Put retried items back (never counts against capacity — they
        already held a slot)."""
        with self._lock:
            self._items.extend(items)

    def take_due(self, now: float, limit: int) -> List[PendingChunk]:
        """Pop up to ``limit`` items with ``due_at <= now``, FIFO order."""
        out: List[PendingChunk] = []
        with self._lock:
            rest: List[PendingChunk] = []
            for item in self._items:
                if len(out) < limit and item.due_at <= now:
                    out.append(item)
                else:
                    rest.append(item)
            self._items = rest
        return out

    def has_due(self, now: float) -> bool:
        with self._lock:
            return any(i.due_at <= now for i in self._items)

    def discard(self, ids: Sequence[int]) -> int:
        """Drop pending rows whose chunk id is in ``ids`` (a DELETE racing
        the not-yet-embedded row must not resurrect it)."""
        drop = {int(i) for i in ids}
        with self._lock:
            before = len(self._items)
            self._items = [i for i in self._items if i.chunk_id not in drop]
            return before - len(self._items)

    def snapshot_rows(self) -> List[Row]:
        """Current pending rows (for checkpointing into a snapshot)."""
        with self._lock:
            return [i.row for i in self._items]


class VectorizerWorker:
    """Batch-embedding worker with retry/backoff and a dead-letter list.

    ``sink(ids, vectors, timestamps)`` receives each successfully embedded
    batch (wired to ``VectorCache.ingest`` by the service).  All methods
    are safe to call from the scheduler's executor thread AND from a
    closing thread (the queue is internally locked; ``drain_once`` itself
    is serialized by ``_drain_lock``).
    """

    def __init__(
        self,
        queue: IngestQueue,
        embed_fn: Callable[[str], np.ndarray],
        sink: Callable[[List[int], np.ndarray, List[Optional[float]]], Any],
        *,
        batch_size: int = 64,
        max_attempts: int = 5,
        base_backoff_s: float = 0.05,
        max_backoff_s: float = 5.0,
        jitter: float = 0.25,
        clock: Callable[[], float] = time.monotonic,
        seed: int = 0,
        journal: Optional[StoreJournal] = None,
        fault_plan: Optional[FaultPlan] = None,
    ) -> None:
        self.queue = queue
        self.embed_fn = embed_fn
        self.sink = sink
        self.batch_size = int(batch_size)
        self.max_attempts = int(max_attempts)
        self.base_backoff_s = float(base_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.jitter = float(jitter)
        self.clock = clock
        self.journal = journal
        self.fault_plan = fault_plan
        self._rng = random.Random(seed)
        self._drain_lock = threading.Lock()
        self.embedded = 0
        self.batches = 0
        self.retries = 0
        self.dead_letters: List[Dict[str, Any]] = []

    # -- intake --------------------------------------------------------------

    def enqueue(self, rows: Sequence[Row]) -> int:
        """Admit ``rows`` (raises :class:`IngestQueueFullError` at
        capacity) and journal them so an accepted INSERT survives a
        crash before its background embed lands."""
        n = self.queue.put(rows)
        if self.journal is not None and n:
            self.journal.append_record(
                "enqueue", {"rows": [tuple(r) for r in rows]})
        return n

    def adopt(self, rows: Sequence[Row],
              dead_letters: Sequence[Dict[str, Any]] = ()) -> int:
        """Re-admit rows recovered from a journal (already journaled —
        not re-journaled) plus any recovered dead letters."""
        self.dead_letters.extend(dict(d) for d in dead_letters)
        if not rows:
            return 0
        return self.queue.put(rows)

    # -- the drain path ------------------------------------------------------

    def backoff_s(self, attempts: int) -> float:
        """Exponential backoff with multiplicative jitter for the
        ``attempts``-th failure: ``base * 2^(attempts-1)`` capped at
        ``max_backoff_s``, times ``1 + U(0, jitter)``."""
        delay = min(self.max_backoff_s,
                    self.base_backoff_s * (2.0 ** max(0, attempts - 1)))
        if self.jitter > 0.0:
            delay *= 1.0 + self.jitter * self._rng.random()
        return delay

    def has_due(self, now: Optional[float] = None) -> bool:
        return self.queue.has_due(self.clock() if now is None else now)

    def pending(self) -> int:
        return len(self.queue)

    def drain_once(self, now: Optional[float] = None) -> int:
        """Embed + ingest ONE due batch; returns rows ingested (0 when
        nothing was due or the batch failed and went back for retry)."""
        with self._drain_lock:
            now = self.clock() if now is None else now
            batch = self.queue.take_due(now, self.batch_size)
            if not batch:
                return 0
            try:
                if (self.fault_plan is not None
                        and self.fault_plan.take_embed_failure()):
                    raise EmbedderError("injected embedder failure")
                vecs = np.stack([
                    np.asarray(self.embed_fn(c.content), dtype=np.float32)
                    for c in batch
                ])
            except Exception as err:  # noqa: BLE001 - any embed error retries
                self._handle_failure(batch, now, err)
                return 0
            if self.fault_plan is not None:
                self.fault_plan.reach("vectorizer:post-embed")
            self.sink([c.chunk_id for c in batch], vecs,
                      [c.timestamp for c in batch])
            self.embedded += len(batch)
            self.batches += 1
            return len(batch)

    def _handle_failure(self, batch: List[PendingChunk], now: float,
                        err: Exception) -> None:
        retry: List[PendingChunk] = []
        dead: List[PendingChunk] = []
        for item in batch:
            item.attempts += 1
            if item.attempts >= self.max_attempts:
                dead.append(item)
            else:
                item.due_at = now + self.backoff_s(item.attempts)
                retry.append(item)
        if retry:
            self.retries += len(retry)
            self.queue.requeue(retry)
        if dead:
            rows = [{
                "chunk_id": item.chunk_id,
                "content": item.content,
                "timestamp": item.timestamp,
                "attempts": item.attempts,
                "error": repr(err),
            } for item in dead]
            self.dead_letters.extend(rows)
            if self.journal is not None:
                self.journal.append_record("dead_letter", {"rows": rows})

    def flush(self) -> int:
        """Drive the queue to empty, ignoring backoff due-times (used by
        ``close()``): every pending row either ingests or exhausts its
        retry budget into the dead-letter list.  Returns rows ingested."""
        total = 0
        # each non-ingesting round burns one attempt per due row, so the
        # loop is bounded by max_attempts rounds even for poison rows
        while len(self.queue):
            total += self.drain_once(now=float("inf"))
        return total

    def stats(self) -> Dict[str, int]:
        return {
            "queued": self.queue.accepted,
            "in_queue": len(self.queue),
            "rejected": self.queue.rejected,
            "embedded": self.embedded,
            "batches": self.batches,
            "retries": self.retries,
            "dead_letter": len(self.dead_letters),
        }
