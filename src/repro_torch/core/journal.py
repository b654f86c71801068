"""Write-ahead journal + snapshots: crash-durable segment stores.

The paper's store is memory-only — a process crash loses every append
since startup and recovery means re-embedding / re-ingesting the whole
corpus (O(corpus)).  The vector-database survey (Ma et al., 2023) names
durable storage with *incremental* recovery as the defining gap between
a retrieval kernel and a retrieval system; this module closes it with
the classic WAL shape:

* every mutation is journaled (fsync'd) BEFORE it is applied in memory,
  so an acknowledged write survives a crash at any later point;
* a **snapshot** (atomic tmp + fsync + rename) captures the full sealed-
  segment state plus the journal sequence number it covers, after which
  the journal is rotated — recovery loads the snapshot and replays only
  records with ``seq > snapshot.seq`` (O(delta), not O(corpus));
* the journal's record framing is ``<u32 length, u32 crc32>`` + payload,
  so a **torn tail** (crash mid-write) is detected and tolerated: replay
  stops cleanly at the first truncated/corrupt record instead of
  propagating garbage.

The journal is *generic*: records are ``(seq, kind, payload)`` tuples and
the snapshot body is an opaque dict, so :class:`repro_torch.core.segments.
SegmentedCorpusStore` journals ``append``/``delete``/``compact`` records
while a cross-process shard group reuses the same file
format for its coordinator routing state, and the ingest vectorizer
(:mod:`repro_torch.serve.vectorizer`) journals ``enqueue``/``dead_letter``
records into the owning store's journal so queued-but-not-yet-embedded
rows survive a crash too.

:class:`FaultPlan` is the deterministic fault-injection harness: named
crash/error points (``append:post-journal``, ``compact:post-journal``,
``journal:torn-tail``, ``snapshot:pre-rename``, ...) are threaded through
the store and the vectorizer worker so every recovery path is exercised
by tests rather than luck.
"""

from __future__ import annotations

import dataclasses
import io
import os
import pickle
import struct
import zlib
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "InjectedCrash",
    "FaultPlan",
    "JournalRecord",
    "StoreJournal",
]

_FRAME = struct.Struct("<II")  # payload length, crc32(payload)
_PICKLE_PROTO = 4

JOURNAL_NAME = "journal.wal"
SNAPSHOT_NAME = "snapshot.bin"


class InjectedCrash(RuntimeError):
    """Raised by :meth:`FaultPlan.reach` at the configured crash point.

    Simulates the process dying mid-operation: the exception unwinds out
    of the store/worker WITHOUT any cleanup, leaving the on-disk journal
    exactly as a real crash would.  Tests catch it, drop the in-memory
    store, and recover from disk.
    """


@dataclasses.dataclass
class FaultPlan:
    """Deterministic fault injection for the durability test harness.

    ``crash_at`` names ONE crash point; the first time execution reaches
    it, :class:`InjectedCrash` is raised.  Known points:

    * ``append:post-journal``  — append journaled+fsync'd, segment NOT
      yet sealed in memory (the "post-journal-pre-seal" window);
    * ``delete:post-journal``  — delete journaled, tombstones NOT flipped;
    * ``compact:post-journal`` — compaction journaled, fold NOT applied
      (the "mid-compaction" window: recovery must redo the fold);
    * ``journal:torn-tail``    — the NEXT journal record is written only
      partially (``torn_tail_bytes`` of it) before the crash, exercising
      the length+crc framing's torn-record tolerance;
    * ``snapshot:pre-rename``  — snapshot tmp file written, atomic rename
      NOT done (recovery uses the previous snapshot + full journal);
    * ``snapshot:post-rename`` — snapshot renamed into place, journal NOT
      yet rotated (recovery must skip ``seq <= snapshot.seq`` records);
    * ``vectorizer:post-embed`` — a vectorizer batch embedded but NOT yet
      ingested (recovery re-enqueues the journaled pending rows).

    ``embed_failures`` makes the embedder raise that many times before
    succeeding — the retry/backoff/dead-letter path's error injector
    (consumed via :meth:`take_embed_failure`).  ``fired`` records every
    point reached, so tests can assert the plan actually triggered.
    """

    crash_at: Optional[str] = None
    torn_tail_bytes: Optional[int] = None
    embed_failures: int = 0
    fired: List[str] = dataclasses.field(default_factory=list)

    def reach(self, point: str) -> None:
        """Record reaching ``point``; crash if the plan says so."""
        self.fired.append(point)
        if self.crash_at == point:
            self.crash_at = None  # one-shot: recovery must not re-crash
            raise InjectedCrash(point)

    def tears_next_write(self) -> bool:
        """True when the next journal write should be torn (partial)."""
        return self.crash_at == "journal:torn-tail"

    def take_embed_failure(self) -> bool:
        """Consume one injected embedder failure (True = raise now)."""
        if self.embed_failures > 0:
            self.embed_failures -= 1
            self.fired.append("embed:failure")
            return True
        return False


@dataclasses.dataclass(frozen=True)
class JournalRecord:
    """One replayed journal record."""

    seq: int
    kind: str
    payload: Dict[str, Any]


class StoreJournal:
    """Per-store write-ahead journal + snapshot pair in one directory.

    Layout: ``<dir>/journal.wal`` (framed records) and
    ``<dir>/snapshot.bin`` (one framed record holding the pickled state
    dict, always complete thanks to the atomic rename).  ``seq`` is a
    monotonic record counter that NEVER resets — snapshot rotation
    filters replay by ``seq``, so a stale journal left behind by a crash
    between snapshot-rename and journal-truncate is harmless.

    Durability knob: ``fsync=False`` skips the per-record fsync (still
    crash-*consistent* via framing, no longer power-fail durable) — used
    by benchmarks to measure the journaling CPU cost separately from the
    disk flush.
    """

    def __init__(
        self,
        path: os.PathLike,
        *,
        fault_plan: Optional[FaultPlan] = None,
        fsync: bool = True,
    ) -> None:
        self.dir = Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.journal_path = self.dir / JOURNAL_NAME
        self.snapshot_path = self.dir / SNAPSHOT_NAME
        self.fault_plan = fault_plan
        self.fsync = fsync
        self.seq = 0                # next seq to assign
        self.records_written = 0
        self.snapshots_written = 0
        self.torn_tail_dropped = 0  # records dropped at replay
        self._clean_end: Optional[int] = None  # byte offset replay trusts
        self._fh: Optional[io.BufferedWriter] = None

    # -- framing -------------------------------------------------------------

    @staticmethod
    def _frame(payload: bytes) -> bytes:
        return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload

    def _open_for_append(self) -> io.BufferedWriter:
        if self._fh is None or self._fh.closed:
            self._fh = open(self.journal_path, "ab")
        return self._fh

    def _sync(self, fh) -> None:
        fh.flush()
        if self.fsync:
            os.fsync(fh.fileno())

    def _sync_dir(self) -> None:
        if not self.fsync:
            return
        try:
            dfd = os.open(self.dir, os.O_RDONLY)
        except OSError:  # pragma: no cover - platform without dir fds
            return
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    # -- the write path ------------------------------------------------------

    def append_record(self, kind: str, payload: Dict[str, Any]) -> int:
        """Frame, write and fsync one record; returns its seq.

        WAL discipline is the CALLER's job: journal first, apply in
        memory second.  A :class:`FaultPlan` with ``journal:torn-tail``
        writes only a prefix of the frame (simulating power loss mid
        ``write(2)``) and then crashes.
        """
        seq = self.seq
        data = pickle.dumps((seq, kind, payload), protocol=_PICKLE_PROTO)
        framed = self._frame(data)
        fh = self._open_for_append()
        plan = self.fault_plan
        if plan is not None and plan.tears_next_write():
            keep = plan.torn_tail_bytes
            if keep is None:
                keep = len(framed) // 2  # mid-payload by default
            keep = max(1, min(len(framed) - 1, int(keep)))
            fh.write(framed[:keep])
            self._sync(fh)
            plan.reach("journal:torn-tail")
            raise AssertionError("torn-tail plan must crash")  # pragma: no cover
        fh.write(framed)
        self._sync(fh)
        self.seq = seq + 1
        self.records_written += 1
        return seq

    # -- the read path -------------------------------------------------------

    def replay(self, after_seq: int = -1) -> Iterator[JournalRecord]:
        """Yield intact records with ``seq > after_seq``, in order.

        Stops cleanly at the first truncated or checksum-corrupt record
        (the torn tail a crash mid-write leaves behind); anything after a
        torn record is untrustworthy and ignored.  Advances ``self.seq``
        past the highest seq seen so subsequent writes keep the monotonic
        ordering.
        """
        if not self.journal_path.exists():
            self._clean_end = 0
            return
        raw = self.journal_path.read_bytes()
        off = 0
        self._clean_end = 0
        while off < len(raw):
            if off + _FRAME.size > len(raw):
                self.torn_tail_dropped += 1
                break
            length, crc = _FRAME.unpack_from(raw, off)
            start = off + _FRAME.size
            end = start + length
            if end > len(raw):
                self.torn_tail_dropped += 1
                break
            payload = raw[start:end]
            if zlib.crc32(payload) != crc:
                self.torn_tail_dropped += 1
                break
            seq, kind, body = pickle.loads(payload)
            off = end
            self._clean_end = off
            if seq >= self.seq:
                self.seq = seq + 1
            if seq > after_seq:
                yield JournalRecord(seq=seq, kind=kind, payload=body)

    def truncate_torn_tail(self) -> None:
        """Drop the torn bytes a crash mid-write left at the journal tail.

        Must run after :meth:`replay` and before any new write — records
        appended AFTER untruncated garbage would be unreachable by the
        next replay (it stops at the first corrupt frame).
        """
        if self._clean_end is None or not self.journal_path.exists():
            return
        if self.journal_path.stat().st_size > self._clean_end:
            with open(self.journal_path, "r+b") as fh:
                fh.truncate(self._clean_end)
                self._sync(fh)

    # -- snapshots -----------------------------------------------------------

    def write_snapshot(self, state: Dict[str, Any]) -> None:
        """Atomically persist ``state`` and rotate the journal.

        ``state`` gains a ``"seq"`` key (the last seq this snapshot
        covers); recovery replays only records after it.  Write order is
        tmp + fsync -> rename -> dir fsync -> truncate journal, with
        crash points between the steps — a crash anywhere leaves either
        the old snapshot + full journal or the new snapshot + a journal
        whose records are filtered out by seq.
        """
        state = dict(state)
        state["seq"] = self.seq - 1
        data = pickle.dumps(state, protocol=_PICKLE_PROTO)
        tmp = self.snapshot_path.with_suffix(".tmp")
        with open(tmp, "wb") as fh:
            fh.write(self._frame(data))
            self._sync(fh)
        plan = self.fault_plan
        if plan is not None:
            plan.reach("snapshot:pre-rename")
        os.replace(tmp, self.snapshot_path)
        self._sync_dir()
        if plan is not None:
            plan.reach("snapshot:post-rename")
        # rotate: all journaled state is now covered by the snapshot
        if self._fh is not None and not self._fh.closed:
            self._fh.close()
            self._fh = None
        with open(self.journal_path, "wb") as fh:
            self._sync(fh)
        self._sync_dir()
        self.snapshots_written += 1

    def load_snapshot(self) -> Optional[Dict[str, Any]]:
        """The last complete snapshot state, or None.

        The rename is atomic, so a present ``snapshot.bin`` is complete;
        the frame crc is still verified (bit rot, partial copies) and a
        corrupt snapshot raises rather than silently recovering empty.
        """
        if not self.snapshot_path.exists():
            return None
        raw = self.snapshot_path.read_bytes()
        if len(raw) < _FRAME.size:
            raise ValueError(f"snapshot {self.snapshot_path} truncated")
        length, crc = _FRAME.unpack_from(raw, 0)
        payload = raw[_FRAME.size:_FRAME.size + length]
        if len(payload) != length or zlib.crc32(payload) != crc:
            raise ValueError(f"snapshot {self.snapshot_path} corrupt")
        state = pickle.loads(payload)
        # resume the monotonic seq PAST the snapshot: after a checkpoint
        # rotates the journal empty, a reopened writer would otherwise
        # restart at seq 0 and its records would be filtered out by the
        # next recovery's ``replay(after_seq=snapshot.seq)``.
        self.seq = max(self.seq, int(state.get("seq", -1)) + 1)
        return state

    # -- introspection -------------------------------------------------------

    @property
    def journal_bytes(self) -> int:
        """Current journal file size (the replay cost proxy)."""
        try:
            return self.journal_path.stat().st_size
        except OSError:
            return 0

    def stats(self) -> Dict[str, int]:
        return {
            "seq": self.seq,
            "records_written": self.records_written,
            "snapshots_written": self.snapshots_written,
            "torn_tail_dropped": self.torn_tail_dropped,
            "journal_bytes": self.journal_bytes,
        }

    def close(self) -> None:
        if self._fh is not None and not self._fh.closed:
            self._fh.close()
        self._fh = None


def recover_pending(
    snapshot: Optional[Dict[str, Any]],
    records: List[JournalRecord],
    live_ids: "set[int]",
) -> Tuple[List[Tuple[int, str, Optional[float]]], List[Dict[str, Any]]]:
    """Reconstruct the not-yet-embedded ingest queue from a journal.

    ``enqueue`` records add rows; a row leaves the pending set when its
    id turns up live in the recovered store (an ``append`` record landed
    after it — the vectorizer embedded it) or a ``dead_letter`` record
    names it.  Returns ``(pending_rows, dead_letters)`` in enqueue order.
    """
    pending: Dict[int, Tuple[int, str, Optional[float]]] = {}
    dead: Dict[int, Dict[str, Any]] = {}
    if snapshot:
        for row in snapshot.get("pending", []):
            pending[int(row[0])] = (int(row[0]), row[1], row[2])
        for dl in snapshot.get("dead_letters", []):
            dead[int(dl["chunk_id"])] = dict(dl)
    for rec in records:
        if rec.kind == "enqueue":
            for row in rec.payload["rows"]:
                pending[int(row[0])] = (int(row[0]), row[1], row[2])
        elif rec.kind == "dead_letter":
            for dl in rec.payload["rows"]:
                dead[int(dl["chunk_id"])] = dict(dl)
                pending.pop(int(dl["chunk_id"]), None)
    out = [row for cid, row in pending.items()
           if cid not in live_ids and cid not in dead]
    return out, list(dead.values())
