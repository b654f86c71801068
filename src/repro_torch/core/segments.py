"""Segmented corpus store: append-only segments + tombstones (live corpora).

The paper's VectorCache holds the corpus embedding matrix as ONE immutable
array, so any mutation means a full re-upload / re-normalize / re-trace.
Production vector stores treat ingest as first-class (pgai keeps embeddings
continuously in sync with table mutations; the vector-database survey
[Ma et al. 2023] names segment-based storage with tombstoning as the
standard design for mutable collections).  This module is that design:

* :class:`CorpusSegment` — a SEALED batch of rows (ids, L2-normalized
  matrix, timestamps) plus a tombstone bitmask.  The arrays never change
  after sealing (device caches key on array identity); only tombstone bits
  flip.
* :class:`SegmentedCorpusStore` — an ordered list of segments with a
  global id -> (segment, row) index.  ``append`` seals a new segment,
  ``delete`` flips tombstones, ``compact`` merges small/sparse segments
  into a fresh sealed segment.

Scoring stays exact: every backend scores each segment independently
(tombstones masked to -inf before selection) and the per-segment top-k
merge (``repro_torch.core.backends.score_select_segments``) reproduces the
monolithic result bit-for-bit — the same two-stage union-merge shape
a sharded scorer uses across device shards, applied across segments.  A monolithic corpus is just a one-segment store.

Global row addressing: a row is identified by its offset in the
concatenation of ALL segment rows (tombstoned rows included, so offsets
never shift under deletes).  :func:`gather_rows` / :func:`gather_ids`
resolve global rows against a segment-list snapshot.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import modulations as M
from repro_torch.core.journal import (
    FaultPlan,
    JournalRecord,
    StoreJournal,
    recover_pending,
)

__all__ = [
    "CorpusSegment",
    "CompactionPolicy",
    "SegmentedCorpusStore",
    "segment_offsets",
    "gather_rows",
    "gather_ids",
    "gather_days",
    "store_from_arrays",
    "pack_bf16",
    "unpack_bf16",
]

SECONDS_PER_DAY = 86400.0


def pack_bf16(matrix: np.ndarray) -> np.ndarray:
    """float32 rows -> bfloat16 bit patterns stored as uint16.

    bfloat16 is the TOP 16 bits of the IEEE float32 layout (same exponent
    range, 7 mantissa bits), so packing is one shift — no scale factors,
    no codebook — and halves the bytes a scoring pass has to stream.  On
    the bandwidth-bound million-chunk corpus that byte halving IS the
    speedup (the matmul is memory-bound); the reference package's
    ``dist.procgroup`` shard workers score blocked bf16 panels with this layout.  Truncation
    (round-toward-zero) keeps pack deterministic and order-free.
    """
    m = np.ascontiguousarray(matrix, dtype=np.float32)
    return (m.view(np.uint32) >> np.uint32(16)).astype(np.uint16)


def unpack_bf16(codes: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
    """uint16 bf16 codes -> float32, exact bit-pattern restoration.

    The inverse shift of :func:`pack_bf16`: every decoded float32 is
    EXACTLY the bf16 value (low mantissa bits zero), so decode is
    lossless given the codes and repeated decodes are bit-identical.
    ``out`` accepts a reusable (same-shape) uint32 scratch buffer so a
    blocked scoring loop never reallocates; the returned array is a view
    of it.
    """
    codes = np.asarray(codes, dtype=np.uint16)
    if out is None:
        out = np.empty(codes.shape, dtype=np.uint32)
    np.left_shift(codes, np.uint32(16), out=out, casting="unsafe")
    return out.view(np.float32)


@dataclasses.dataclass(eq=False)  # identity equality: fields hold arrays
class CorpusSegment:
    """One sealed batch of corpus rows.

    ``ids``/``matrix``/``timestamps`` are immutable after sealing — the
    device-resident matrix caches key on ``id(matrix)``, so a warm segment
    never re-uploads.  Deletes only flip ``tombstones`` bits (and bump
    ``n_dead``); the dead rows are masked to -inf at scoring time and
    physically dropped at :meth:`SegmentedCorpusStore.compact`.
    """

    seg_id: int
    ids: np.ndarray                       # (n,) int64 chunk ids
    matrix: np.ndarray                    # (n, d) float32, L2-normalized
    timestamps: Optional[np.ndarray]      # (n,) float64 unix seconds, or None
    tombstones: np.ndarray                # (n,) bool, True = deleted
    n_dead: int = 0

    @property
    def n_rows(self) -> int:
        return int(self.ids.shape[0])

    @property
    def live_count(self) -> int:
        return self.n_rows - self.n_dead

    @property
    def live_fraction(self) -> float:
        return self.live_count / self.n_rows if self.n_rows else 0.0

    @property
    def live_mask(self) -> np.ndarray:
        """Fresh (n,) bool array, True = live (a copy: safe to ship off)."""
        return ~self.tombstones

    def days_ago(self, now: float) -> Optional[np.ndarray]:
        """Per-row age in days at ``now`` (None when timestamps absent)."""
        if self.timestamps is None:
            return None
        return ages_in_days(self.timestamps, now)


def ages_in_days(timestamps: np.ndarray, now: float) -> np.ndarray:
    """(n,) f32 age in days at ``now`` of rows stamped ``timestamps``
    (unix seconds); a row newer than ``now`` is 0 days old."""
    return np.maximum((now - timestamps) / SECONDS_PER_DAY,
                      0.0).astype(np.float32)


def segment_offsets(segments: Sequence[CorpusSegment]) -> np.ndarray:
    """(S+1,) cumulative row starts: segment i spans [off[i], off[i+1])."""
    off = np.zeros(len(segments) + 1, dtype=np.int64)
    for i, seg in enumerate(segments):
        off[i + 1] = off[i] + seg.n_rows
    return off


def _locate(segments: Sequence[CorpusSegment], global_rows: np.ndarray):
    off = segment_offsets(segments)
    gidx = np.asarray(global_rows, dtype=np.int64)
    seg_idx = np.searchsorted(off, gidx, side="right") - 1
    return seg_idx, gidx - off[seg_idx]


def gather_rows(
    segments: Sequence[CorpusSegment], global_rows: np.ndarray
) -> np.ndarray:
    """Embedding rows for global row offsets (order-preserving gather)."""
    gidx = np.asarray(global_rows, dtype=np.int64)
    if gidx.size == 0:
        dim = segments[0].matrix.shape[1] if segments else 0
        return np.zeros((0, dim), dtype=np.float32)
    seg_idx, local = _locate(segments, gidx)
    out = np.empty((gidx.size, segments[0].matrix.shape[1]), dtype=np.float32)
    for s in np.unique(seg_idx):
        sel = seg_idx == s
        out[sel] = segments[s].matrix[local[sel]]
    return out


def gather_ids(
    segments: Sequence[CorpusSegment], global_rows: np.ndarray
) -> np.ndarray:
    """Chunk ids for global row offsets (order-preserving gather)."""
    gidx = np.asarray(global_rows, dtype=np.int64)
    if gidx.size == 0:
        return np.zeros(0, dtype=np.int64)
    seg_idx, local = _locate(segments, gidx)
    out = np.empty(gidx.size, dtype=np.int64)
    for s in np.unique(seg_idx):
        sel = seg_idx == s
        out[sel] = segments[s].ids[local[sel]]
    return out


def gather_days(
    segments: Sequence[CorpusSegment], global_rows: np.ndarray, now: float
) -> Optional[np.ndarray]:
    """Per-row age in days at ``now`` for global row offsets (None when the
    segments carry no timestamps — decay plans are rejected upstream)."""
    if not segments or segments[0].timestamps is None:
        return None
    gidx = np.asarray(global_rows, dtype=np.int64)
    if gidx.size == 0:
        return np.zeros(0, dtype=np.float32)
    seg_idx, local = _locate(segments, gidx)
    ts = np.empty(gidx.size, dtype=np.float64)
    for s in np.unique(seg_idx):
        sel = seg_idx == s
        ts[sel] = segments[s].timestamps[local[sel]]
    return ages_in_days(ts, now)


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    """Background-compaction heuristic (ROADMAP follow-on to delta ingest).

    Two pressures, matching how a live store degrades:

    * **liveness** — a segment whose live fraction fell below
      ``min_live_fraction`` wastes score/mask work on dead rows every
      batch; fold it.
    * **segment count** — many small fully-live segments (a stream of
      delta appends) cost one scoring launch + one merge slot each; when
      the store exceeds ``max_segments``, merge the SMALLEST segments
      (fewest rows re-uploaded/re-traced) down to the cap.

    The policy only picks victims; :meth:`SegmentedCorpusStore.maybe_compact`
    folds them under the store lock, so a compaction can never land inside
    a scoring pass (the device pass holds the same lock).  The serving
    scheduler (:mod:`repro_torch.serve.engine`) invokes it in idle gaps between
    batches.
    """

    min_live_fraction: float = 0.7
    max_segments: int = 8

    def should_compact(self, store: "SegmentedCorpusStore") -> bool:
        """Cheap lock-free check the scheduler runs each idle tick; a True
        here is re-validated under the lock by :meth:`victims`."""
        segs = store._segments
        if len(segs) > self.max_segments:
            return True
        return any(s.n_rows and s.live_fraction < self.min_live_fraction
                   for s in segs)

    def victims(self, segments: Sequence[CorpusSegment]) -> List[CorpusSegment]:
        """Segments to fold into one fresh sealed segment (may be empty)."""
        victims = [s for s in segments
                   if s.n_rows and s.live_fraction < self.min_live_fraction]
        # count pressure: folding m victims yields <= 1 merged segment,
        # so keep adding the smallest until the post-fold count fits
        if len(segments) > self.max_segments:
            chosen = set(id(s) for s in victims)
            by_size = sorted((s for s in segments if s.n_rows),
                             key=lambda s: s.n_rows)
            for s in by_size:
                if len(segments) - len(victims) + 1 <= self.max_segments:
                    break
                if id(s) not in chosen:
                    victims.append(s)
                    chosen.add(id(s))
            # keep store order so the merged segment lands predictably
            order = {id(s): i for i, s in enumerate(segments)}
            victims.sort(key=lambda s: order[id(s)])
        return victims if len(victims) > 1 or any(
            s.n_dead for s in victims) else []


class SegmentedCorpusStore:
    """Ordered immutable segments + tombstones + a global id index.

    Thread model: mutations (``append``/``delete``/``compact``) take
    ``self.lock`` internally; readers that need a consistent scoring pass
    (the batched engine, ``VectorCache.search_plan``) hold ``self.lock``
    across snapshot + scoring, so ingest is usable *between* batches
    without torn reads.  ``version`` bumps on every mutation — consumers
    (the VectorCache live view) use it for cheap invalidation.

    Durability: pass ``journal=`` (a :class:`~repro_torch.core.journal.
    StoreJournal`) and every mutation is journaled + fsync'd BEFORE it is
    applied in memory — an acknowledged write survives a crash at any
    point.  :meth:`open` recovers a store from its journal directory
    (snapshot + post-snapshot delta replay, torn-tail tolerant);
    :meth:`checkpoint` writes a fresh snapshot and rotates the journal so
    the next recovery replays only the records since.
    """

    def __init__(self, dim: int, *,
                 journal: Optional[StoreJournal] = None) -> None:
        self.dim = int(dim)
        self._segments: List[CorpusSegment] = []
        self._loc: Dict[int, Tuple[CorpusSegment, int]] = {}
        self.lock = threading.RLock()
        self.version = 0
        self._next_seg_id = 0
        self.appends = 0
        self.deletes = 0
        self.compactions = 0
        self.journal = journal
        self.checkpoints = 0
        self.recovered_records = 0
        self.recovered_pending: List[Tuple[int, str, Optional[float]]] = []
        self.recovered_dead_letters: List[Dict[str, Any]] = []

    # -- introspection -------------------------------------------------------

    @property
    def segments(self) -> Tuple[CorpusSegment, ...]:
        """Snapshot of the segment list (the list itself never mutates in
        place; compact swaps in a new list under the lock)."""
        with self.lock:
            return tuple(self._segments)

    @property
    def n_segments(self) -> int:
        return len(self._segments)

    @property
    def n_rows(self) -> int:
        """Physical rows, tombstoned included."""
        return sum(s.n_rows for s in self._segments)

    @property
    def n_live(self) -> int:
        return sum(s.live_count for s in self._segments)

    @property
    def has_timestamps(self) -> bool:
        segs = self._segments
        return bool(segs) and all(s.timestamps is not None for s in segs)

    def stats(self) -> Dict[str, int]:
        with self.lock:
            out = {
                "segments": self.n_segments,
                "rows": self.n_rows,
                "live": self.n_live,
                "tombstoned": self.n_rows - self.n_live,
                "appends": self.appends,
                "deletes": self.deletes,
                "compactions": self.compactions,
                "version": self.version,
            }
            if self.journal is not None:
                out["checkpoints"] = self.checkpoints
                out["recovered_records"] = self.recovered_records
                out["journal_bytes"] = self.journal.journal_bytes
            return out

    def _fault(self, point: str) -> None:
        """Hit a FaultPlan crash point (no-op without an attached plan)."""
        if self.journal is not None and self.journal.fault_plan is not None:
            self.journal.fault_plan.reach(point)

    # -- mutations -----------------------------------------------------------

    def append(
        self,
        ids: Sequence[int],
        matrix: np.ndarray,
        timestamps: Optional[Sequence[float]] = None,
        *,
        normalized: bool = False,
    ) -> Optional[CorpusSegment]:
        """Seal ``(ids, matrix, timestamps)`` as a new segment.

        An empty append is a no-op returning None.  Re-appending an id that
        was tombstoned is allowed (the index moves to the new row); a LIVE
        duplicate id is an error.  Timestamp presence must match the rest
        of the store (decay scoring is all-or-nothing).
        """
        ids_arr = np.asarray(ids, dtype=np.int64)
        matrix = np.asarray(matrix, dtype=np.float32)
        if matrix.ndim != 2 or matrix.shape[0] != ids_arr.shape[0]:
            raise ValueError(
                f"matrix shape {matrix.shape} inconsistent with "
                f"{len(ids_arr)} ids"
            )
        if matrix.shape[0] and matrix.shape[1] != self.dim:
            raise ValueError(
                f"segment dim {matrix.shape[1]} != store dim {self.dim}"
            )
        if ids_arr.size == 0:
            return None
        ts = (np.asarray(timestamps, dtype=np.float64)
              if timestamps is not None else None)
        if ts is not None and ts.shape[0] != ids_arr.shape[0]:
            raise ValueError("timestamps misaligned with ids")
        with self.lock:
            if self._segments:
                have_ts = self._segments[0].timestamps is not None
                if have_ts != (ts is not None):
                    raise ValueError(
                        "timestamp presence must match the existing store "
                        f"(store has timestamps: {have_ts})"
                    )
            dupes = [int(i) for i in ids_arr if int(i) in self._loc]
            if dupes:
                raise ValueError(
                    f"append: ids already live in the store: {dupes[:10]}"
                    + ("..." if len(dupes) > 10 else "")
                )
            if not normalized:
                matrix = np.asarray(M.l2_normalize(matrix), dtype=np.float32)
            if self.journal is not None:
                # WAL-first: the POST-normalization matrix is journaled so
                # replay (normalized=True) reseals bit-identical rows
                self.journal.append_record("append", {
                    "seg_id": self._next_seg_id,
                    "ids": ids_arr,
                    "matrix": matrix,
                    "timestamps": ts,
                })
                self._fault("append:post-journal")
            return self._seal(ids_arr, matrix, ts)

    def _seal(
        self,
        ids_arr: np.ndarray,
        matrix: np.ndarray,
        ts: Optional[np.ndarray],
    ) -> CorpusSegment:
        """Seal a validated, normalized batch (caller holds the lock)."""
        seg = CorpusSegment(
            seg_id=self._next_seg_id,
            ids=ids_arr,
            matrix=matrix,
            timestamps=ts,
            tombstones=np.zeros(ids_arr.shape[0], dtype=bool),
        )
        self._next_seg_id += 1
        self._segments = self._segments + [seg]
        for row, cid in enumerate(ids_arr):
            self._loc[int(cid)] = (seg, row)
        self.version += 1
        self.appends += 1
        return seg

    def delete(self, ids: Sequence[int], *, strict: bool = False) -> int:
        """Tombstone ``ids``; returns how many rows were newly tombstoned.

        Unknown (or already-deleted) ids are ignored unless ``strict``.
        """
        with self.lock:
            missing: List[int] = []
            to_flip: List[int] = []
            seen: set = set()
            for cid in ids:
                cid = int(cid)
                if cid in seen or cid not in self._loc:
                    missing.append(cid)
                else:
                    seen.add(cid)
                    to_flip.append(cid)
            if missing and strict:
                raise KeyError(
                    f"delete: ids not live in the store: {missing[:10]}"
                    + ("..." if len(missing) > 10 else "")
                )
            if not to_flip:
                return 0
            if self.journal is not None:
                self.journal.append_record(
                    "delete", {"ids": np.asarray(to_flip, dtype=np.int64)})
                self._fault("delete:post-journal")
            for cid in to_flip:
                seg, row = self._loc.pop(cid)
                seg.tombstones[row] = True
                seg.n_dead += 1
            self.version += 1
            self.deletes += 1
            return len(to_flip)

    def compact(self, min_live_fraction: float = 1.0) -> int:
        """Merge sparse segments: every segment whose live fraction is
        below ``min_live_fraction`` is folded (dead rows dropped) into one
        fresh sealed segment, inserted at the first victim's position.
        Fully-dead segments are simply removed.  Returns the number of
        source segments compacted away.

        ``compact(1.0)`` (the default) rewrites every segment that has ANY
        tombstone — full garbage collection.
        """
        with self.lock:
            victims = [s for s in self._segments
                       if s.n_rows and s.live_fraction < min_live_fraction]
            return self._fold(victims)

    def maybe_compact(self, policy: CompactionPolicy) -> int:
        """Apply ``policy`` if it names victims; returns segments folded.

        Takes the store lock for the victim choice AND the fold, so the
        decision can't race a concurrent append/delete — and since the
        scoring device pass holds the same lock, a compaction triggered
        from the serving scheduler's idle gaps can never land inside a
        scoring pass.
        """
        with self.lock:
            return self._fold(policy.victims(self._segments))

    def _fold(self, victims: List[CorpusSegment]) -> int:
        """Merge ``victims`` (dead rows dropped) into one fresh sealed
        segment at the first victim's position; caller holds the lock."""
        if not victims:
            return 0
        if self.journal is not None:
            # the fold is deterministic given the victims' seg_ids, so the
            # record carries only those; replay redoes the merge itself
            self.journal.append_record("compact", {
                "victims": [s.seg_id for s in victims],
                "merged_seg_id": self._next_seg_id,
            })
            self._fault("compact:post-journal")
        return self._apply_fold(victims)

    def _apply_fold(self, victims: List[CorpusSegment]) -> int:
        keep = [s for s in self._segments if s not in victims]
        first_at = self._segments.index(victims[0])
        insert_at = sum(1 for s in self._segments[:first_at]
                        if s not in victims)
        live_parts = [s for s in victims if s.live_count]
        merged: Optional[CorpusSegment] = None
        if live_parts:
            ids = np.concatenate([s.ids[s.live_mask] for s in live_parts])
            mat = np.concatenate(
                [s.matrix[s.live_mask] for s in live_parts])
            ts = None
            if live_parts[0].timestamps is not None:
                ts = np.concatenate(
                    [s.timestamps[s.live_mask] for s in live_parts])
            merged = CorpusSegment(
                seg_id=self._next_seg_id,
                ids=ids,
                matrix=np.ascontiguousarray(mat),
                timestamps=ts,
                tombstones=np.zeros(ids.shape[0], dtype=bool),
            )
            self._next_seg_id += 1
            for row, cid in enumerate(ids):
                self._loc[int(cid)] = (merged, row)
            keep.insert(insert_at, merged)
        self._segments = keep
        self.version += 1
        self.compactions += 1
        return len(victims)

    # -- durability: open / checkpoint / replay ------------------------------

    @classmethod
    def open(
        cls,
        path: os.PathLike,
        dim: Optional[int] = None,
        *,
        fault_plan: Optional[FaultPlan] = None,
        fsync: bool = True,
    ) -> "SegmentedCorpusStore":
        """Open (or create) a journal-backed store at ``path``.

        Recovery = load the last snapshot (if any) + replay only the
        post-snapshot journal delta; ``recovered_records`` counts the
        replayed records (the O(delta) pin) and a torn/truncated tail
        record is tolerated (replay stops cleanly before it).  Rows that
        were enqueued for background embedding but never embedded
        resurface in ``recovered_pending`` (with any ``recovered_dead_
        letters``) for the vectorizer to re-adopt.  ``dim`` is required
        only for a brand-new (empty) journal directory.
        """
        journal = StoreJournal(path, fault_plan=fault_plan, fsync=fsync)
        snap = journal.load_snapshot()
        after = int(snap["seq"]) if snap is not None else -1
        records = list(journal.replay(after_seq=after))
        journal.truncate_torn_tail()
        if snap is not None:
            if dim is not None and int(snap["dim"]) != int(dim):
                raise ValueError(
                    f"open: dim {dim} != snapshot dim {snap['dim']}")
            store = cls(int(snap["dim"]))
            store._restore_snapshot(snap)
        else:
            if dim is None:
                for rec in records:
                    if rec.kind == "append":
                        dim = int(rec.payload["matrix"].shape[1])
                        break
            if dim is None:
                raise ValueError(
                    "open: empty journal directory needs an explicit dim")
            store = cls(int(dim))
        # journal attaches AFTER replay so re-applied records don't re-journal
        for rec in records:
            store._apply_record(rec)
        store.recovered_records = len(records)
        pending, dead = recover_pending(
            snap, records, set(store._loc.keys()))
        store.recovered_pending = pending
        store.recovered_dead_letters = dead
        store.journal = journal
        return store

    def checkpoint(
        self,
        pending: Sequence[Tuple[int, str, Optional[float]]] = (),
        dead_letters: Sequence[Dict[str, Any]] = (),
    ) -> None:
        """Snapshot the full sealed-segment state and rotate the journal.

        ``pending``/``dead_letters`` carry the vectorizer's not-yet-
        embedded queue into the snapshot (their journal records rotate
        away with everything else).  After a checkpoint, recovery replays
        only records written since — keep calling it periodically and
        recovery stays O(delta).
        """
        if self.journal is None:
            raise RuntimeError("checkpoint: store has no journal attached")
        with self.lock:
            state = {
                "dim": self.dim,
                "next_seg_id": self._next_seg_id,
                "version": self.version,
                "appends": self.appends,
                "deletes": self.deletes,
                "compactions": self.compactions,
                "segments": [
                    {
                        "seg_id": s.seg_id,
                        "ids": s.ids,
                        "matrix": s.matrix,
                        "timestamps": s.timestamps,
                        "tombstones": s.tombstones,
                        "n_dead": s.n_dead,
                    }
                    for s in self._segments
                ],
                "pending": [tuple(r) for r in pending],
                "dead_letters": [dict(d) for d in dead_letters],
            }
            self.journal.write_snapshot(state)
            self.checkpoints += 1

    def _restore_snapshot(self, snap: Dict[str, Any]) -> None:
        with self.lock:
            segs: List[CorpusSegment] = []
            for s in snap["segments"]:
                segs.append(CorpusSegment(
                    seg_id=int(s["seg_id"]),
                    ids=s["ids"],
                    matrix=s["matrix"],
                    timestamps=s["timestamps"],
                    tombstones=s["tombstones"],
                    n_dead=int(s["n_dead"]),
                ))
            self._segments = segs
            self._loc = {}
            for seg in segs:
                for row in np.nonzero(~seg.tombstones)[0]:
                    self._loc[int(seg.ids[row])] = (seg, int(row))
            self._next_seg_id = int(snap["next_seg_id"])
            self.version = int(snap["version"])
            self.appends = int(snap["appends"])
            self.deletes = int(snap["deletes"])
            self.compactions = int(snap["compactions"])

    def _apply_record(self, rec: JournalRecord) -> None:
        """Re-apply one journal record during recovery (journal detached,
        so nothing is re-journaled; replay is deterministic and the
        journaled seg_ids double as a divergence check)."""
        kind, p = rec.kind, rec.payload
        if kind == "append":
            seg = self.append(
                p["ids"], p["matrix"], p["timestamps"], normalized=True)
            if seg is not None and seg.seg_id != int(p["seg_id"]):
                raise ValueError(
                    f"replay divergence: sealed seg_id {seg.seg_id} != "
                    f"journaled {p['seg_id']}")
        elif kind == "delete":
            self.delete(p["ids"])
        elif kind == "compact":
            want = {int(v) for v in p["victims"]}
            with self.lock:
                victims = [s for s in self._segments if s.seg_id in want]
                if len(victims) != len(want):
                    raise ValueError(
                        f"replay divergence: compaction victims {sorted(want)} "
                        f"not all present")
                self._fold(victims)
        elif kind in ("enqueue", "dead_letter"):
            pass  # ingest-queue records; folded in by recover_pending
        else:
            raise ValueError(f"unknown journal record kind {kind!r}")

    # -- id lookups ----------------------------------------------------------

    def __contains__(self, chunk_id: int) -> bool:
        return int(chunk_id) in self._loc

    def embedding_for_id(self, chunk_id: int) -> Optional[np.ndarray]:
        loc = self._loc.get(int(chunk_id))
        if loc is None:
            return None
        seg, row = loc
        return seg.matrix[row]

    def gather_embeddings(
        self, chunk_ids: Sequence[int]
    ) -> Tuple[np.ndarray, List[int]]:
        """Embedding rows for ``chunk_ids`` straight off the id index —
        no live-view materialization (the view concatenates EVERY live row
        just to gather a handful).  Returns ``(rows, missing)`` where
        ``rows`` stacks the found ids' embeddings in request order and
        ``missing`` lists ids not live in the store (non-strict: the
        caller decides whether that is an error)."""
        rows: List[np.ndarray] = []
        missing: List[int] = []
        with self.lock:
            for cid in chunk_ids:
                loc = self._loc.get(int(cid))
                if loc is None:
                    missing.append(int(cid))
                else:
                    seg, row = loc
                    rows.append(seg.matrix[row])
        mat = (np.stack(rows).astype(np.float32, copy=False) if rows
               else np.zeros((0, self.dim), dtype=np.float32))
        return mat, missing

    # -- Phase-1 candidate lookups (the filtered-retrieval batch APIs) -------

    def candidate_masks(
        self,
        candidate_ids: np.ndarray,
        segments: Optional[Sequence[CorpusSegment]] = None,
    ) -> Tuple[List[Optional[np.ndarray]], int]:
        """Batch candidate lookup: id set -> per-segment row bitmasks.

        ``masks[i]`` is a ``(segments[i].n_rows,)`` bool array, True on the
        LIVE rows whose chunk id is in ``candidate_ids`` — candidates ∧
        ¬tombstones, ready to hand to ``score_select``'s ``mask`` argument
        so the warm device-resident segment matrices score with
        non-candidates at -inf instead of gathering a scratch sub-corpus.
        Segments holding no candidate stay ``None`` (skipped entirely by
        the segment pass).  Returns ``(masks, n_matched)``.

        Non-strict by construction: ids unknown to the store — including
        ids tombstoned between the Phase-1 SQL and this lookup — simply
        never set a bit.  The scan is vectorized (``np.isin`` per sealed
        ``ids`` array), so cost is O(corpus), independent of how the ids
        scatter across segments — the selectivity router only takes this
        path when the candidate set is a large fraction of the corpus.
        """
        cand = np.asarray(candidate_ids, dtype=np.int64)
        if segments is None:
            segments = self.segments
        masks: List[Optional[np.ndarray]] = []
        matched = 0
        for seg in segments:
            if cand.size == 0 or seg.n_rows == 0 or not seg.live_count:
                masks.append(None)
                continue
            m = np.isin(seg.ids, cand)
            if seg.n_dead:
                m &= seg.live_mask
            hits = int(np.count_nonzero(m))
            if hits == 0:
                masks.append(None)
            else:
                masks.append(m)
                matched += hits
        return masks, matched

    def candidate_mask_panel(
        self,
        candidate_sets: Sequence[Optional[np.ndarray]],
        segments: Optional[Sequence[CorpusSegment]] = None,
    ) -> Tuple[List[Optional[np.ndarray]], int]:
        """Heterogeneous-filter batch lookup: B candidate sets -> per-
        segment ``(n_rows, B)`` bool PANELS, column ``j`` True on the live
        rows whose chunk id is in ``candidate_sets[j]``.

        The per-plan generalization of :meth:`candidate_masks` — a batch
        whose requests carry B DIFFERENT Phase-1 filters shares one
        batched matmul + masked selection instead of one scoring pass per
        distinct filter.  ``candidate_sets[j] is None`` means request
        ``j`` is UNFILTERED: its column is the plain live mask (all-ones
        minus tombstones), so a mixed filtered/unfiltered cohort never
        splits.  Segments where no filtered column has a hit AND there is
        no unfiltered column stay ``None`` (skipped by the segment
        pass); ``n_matched`` counts the filtered columns' set bits.

        Non-strict exactly like :meth:`candidate_masks`: unknown or
        tombstoned ids never set a bit.  Duplicate ids within a set are
        harmless (``np.isin`` semantics).
        """
        if segments is None:
            segments = self.segments
        sets = [None if c is None else np.asarray(c, dtype=np.int64)
                for c in candidate_sets]
        panels: List[Optional[np.ndarray]] = []
        matched = 0
        for seg in segments:
            if seg.n_rows == 0 or not seg.live_count:
                panels.append(None)
                continue
            live = seg.live_mask
            panel = np.empty((seg.n_rows, len(sets)), dtype=bool)
            hits = 0
            for j, cand in enumerate(sets):
                if cand is None:
                    panel[:, j] = live
                    continue
                col = np.isin(seg.ids, cand)
                if seg.n_dead:
                    col &= live
                panel[:, j] = col
                hits += int(np.count_nonzero(col))
            matched += hits
            if hits == 0 and all(c is not None for c in sets):
                panels.append(None)
            else:
                panels.append(panel)
        return panels, matched

    def locate_rows(
        self,
        candidate_ids: np.ndarray,
        segments: Sequence[CorpusSegment],
    ) -> np.ndarray:
        """Global row offsets (ascending) of the live candidate ids within
        the ``segments`` snapshot — the gather-path counterpart of
        :meth:`candidate_masks`.  O(candidates) via the id index, so a
        highly selective Phase-1 filter resolves without touching the rest
        of the corpus.  Non-strict: unknown/tombstoned ids are dropped, and
        ids living in a segment not part of the snapshot (compacted away
        after it was taken) are dropped too.  Ascending order is the
        canonical tie order — it matches the masked path's segment-major
        merge bit for bit."""
        off = segment_offsets(segments)
        seg_index = {id(s): i for i, s in enumerate(segments)}
        rows: List[int] = []
        with self.lock:
            for cid in np.asarray(candidate_ids, dtype=np.int64):
                loc = self._loc.get(int(cid))
                if loc is None:
                    continue
                i = seg_index.get(id(loc[0]))
                if i is None:
                    continue
                rows.append(int(off[i]) + loc[1])
        rows.sort()
        return np.asarray(rows, dtype=np.int64)

    def score_bias_arrays(
        self,
        ids: np.ndarray,
        values: np.ndarray,
        segments: Optional[Sequence[CorpusSegment]] = None,
    ) -> Tuple[List[Optional[np.ndarray]], int]:
        """Sparse per-id score values -> dense per-segment (n,) float32
        additive-bias arrays aligned with ``segments`` — the hybrid
        lexical leg's ``score_bias`` input for the segmented passes.

        The scatter resolves through the id index (O(len(ids)), like
        :meth:`locate_rows`), never a corpus scan.  Segments holding no
        scored id stay None (zero bias, nothing allocated).  Non-strict:
        unknown / tombstoned / out-of-snapshot ids are dropped — the
        second return is how many ids actually landed.
        """
        with self.lock:
            if segments is None:
                segments = list(self.segments)
            seg_index = {id(s): i for i, s in enumerate(segments)}
            arrays: List[Optional[np.ndarray]] = [None] * len(segments)
            matched = 0
            for cid, val in zip(np.asarray(ids, dtype=np.int64),
                                np.asarray(values, dtype=np.float32)):
                loc = self._loc.get(int(cid))
                if loc is None:
                    continue
                i = seg_index.get(id(loc[0]))
                if i is None:
                    continue
                if arrays[i] is None:
                    arrays[i] = np.zeros(segments[i].n_rows, np.float32)
                arrays[i][loc[1]] = val
                matched += 1
        return arrays, matched


def store_from_arrays(
    segments: Sequence[Dict[str, Optional[np.ndarray]]],
) -> SegmentedCorpusStore:
    """Rebuild a store from plain per-segment arrays, one dict per segment.

    Each dict holds ``ids`` (n,), ``matrix`` (n, d) L2-normalized float32,
    ``timestamps`` (n,) float64 or None, and ``live_mask`` (n,) bool (True
    = live).  The result has the same segment boundaries, the same row
    order and the same tombstones, so a store exported to numpy elsewhere
    scores here on identical global rows.  Matrices are taken as given
    (no re-normalization), like a journal replay.
    """
    if not segments:
        raise ValueError("store_from_arrays: no segments")
    store = SegmentedCorpusStore(dim=np.asarray(segments[0]["matrix"]).shape[1])
    for part in segments:
        seg = store.append(part["ids"], part["matrix"], part["timestamps"],
                           normalized=True)
        live = np.asarray(part["live_mask"], dtype=bool)
        if seg is None or live.shape != (seg.n_rows,):
            raise ValueError("store_from_arrays: live_mask misaligned with ids")
        store.delete(seg.ids[~live])
    return store
