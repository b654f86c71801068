"""Cross-process shard groups: million-chunk retrieval on one box.

The port of ``repro.dist.procgroup``.  :mod:`repro_torch.dist.pem_sharded`
distributes the PEM pass across ranks of a ``torch.distributed`` group.
This module is the other axis the paper's production story needs: a
:class:`ProcessGroup` that partitions the corpus across OS processes (or
threads, or inline workers), each shard owning its own
:class:`~repro_torch.core.segments.SegmentedCorpusStore` and scoring on
its own device — so per-shard scoring-resident memory, not one process's
or one card's, is the binding constraint at 1M+ chunks.

Design:

* :class:`ShardWorker` — one shard replica.  Owns a segmented store plus
  a scoring backend and answers ``local_pass`` batches: the full
  segmented pass (:func:`score_select_segments`, candidate mask panels,
  hybrid score bias) over ITS rows only, returning per-plan
  top-``width`` candidates in chunk-id space (plus pool embeddings for
  diverse plans).  ``engine="hopper"`` (the default) scores through a
  :class:`~repro_torch.core.backends.HopperBackend` on the worker's
  ``device`` — the pem_score and topk kernels on a card, shard s on
  ``cuda:{s % device_count}`` — or, with ``device="cpu"``, through their
  plain versions.  A registered numpy engine (``"fused-numpy"``) keeps
  the reference's pure-BLAS worker, bit for bit.
* ``dtype="f32b"`` workers score simple (no-filter, no-lexical) plans
  over the live f32 rows, cached per store version: the numpy worker
  with the reference's BLOCKED single-stream pass (cache-sized row
  blocks against one fused ``(d, 2B)`` panel), the Hopper worker with one
  ``pem_score`` launch, which streams the corpus once per batch whatever
  its plans.  ``dtype="bf16"`` workers keep the truncated
  :func:`~repro_torch.core.segments.pack_bf16` codes of their live rows —
  on a card uploaded as uint16 and viewed as bfloat16, never rounded —
  HALF the resident scoring bytes.  Filtered / hybrid plans take the
  exact f32 path on both.
* :class:`ProcessGroup` — the coordinator/router.  Fans a batch of plans
  out to one replica per shard, then merges with the SAME exact-union
  contract as ``union_merge_topk``: every shard's local top-``width``
  provably contains its share of the global top-``width``, and the merge
  re-sorts by ``(score desc, global insertion rank asc)`` — the
  insertion rank IS the monolithic store's row order (absent
  compaction), so the merged ranking, tie order included, equals a
  monolithic :meth:`~repro_torch.core.vectorcache.VectorCache.search_plan`
  over the same rows (bit for bit with numpy workers, pinned in
  tests/test_torch_procgroup.py).  Diverse plans merge their oversample
  pools and finish with the :func:`mmr_host` oracle at the coordinator;
  ``fuse:rrf`` fuses at the coordinator exactly like
  :func:`finalize_fusion`.

One caveat about "bit-identical" for numpy workers: BLAS GEMM scores the
last ``n mod M_block`` rows of a matrix with a tail microkernel whose
accumulation order differs from the full-block kernel by 1-2 ulp, so a
row's score bits depend (only) on whether it lands in a full M-block.
Per-shard scores therefore match the monolith exactly when every sealed
slice's row count is a multiple of the M-block (32 covers the common
kernels); the parity suites pin that aligned contract.  The Hopper
kernel reduces each row along d in one fixed order wherever the row
lands, so its shard scores do not depend on the partition.

Transports: ``inline`` (serial in-process calls — the deterministic
default for tests), ``thread`` (one fan-out thread per replica; BLAS and
the kernel launches release the GIL, so shards genuinely overlap and
nothing is copied), ``process`` (one OS process per replica,
length-prefixed pickle over a ``multiprocessing.Pipe``).  A numpy worker
process starts by fork where the platform has it, as the reference's
does; a Hopper worker process starts by spawn, because CUDA cannot start
in a forked child once the parent has used it.  The merge math is
transport-independent; parity suites run the same cases across all three.
"""

from __future__ import annotations

import concurrent.futures as cf
import functools
import multiprocessing as mp
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core import modulations as M
from repro_torch.core.backends import (HopperBackend, _kernel_device,
                                       fusion_bias_arrays, get_backend,
                                       mmr_host,
                                       score_select_segments,
                                       selection_width, top_idx)
from repro_torch.core.journal import StoreJournal
from repro_torch.core.segments import (SECONDS_PER_DAY, SegmentedCorpusStore,
                                       gather_ids, gather_rows, pack_bf16,
                                       unpack_bf16)

__all__ = ["ShardWorker", "ProcessGroup"]

_TRANSPORTS = ("inline", "thread", "process")
_DTYPES = ("f32", "f32b", "bf16")

# blocked-pass row-block defaults: f32b wants L2-resident blocks (the
# small-kernel GEMM never packs, so the only traffic is the one stream);
# bf16 amortizes its decode scratch over bigger blocks
_BLOCK_DEFAULTS = {"f32b": 1536, "bf16": 16384, "f32": 16384}


class ShardWorker:
    """One shard replica: a segmented store + a scoring backend.

    ``local_pass`` is the whole per-shard pipeline — candidate mask
    panel, hybrid bias scatter, fused score->select, exact per-segment
    union merge — restricted to this shard's rows, so the coordinator's
    cross-shard merge composes with the intra-shard one the same way
    ``union_merge_topk`` composes across devices.

    ``engine="hopper"`` builds a :class:`HopperBackend` on ``device``
    (in the worker's own process for the ``process`` transport); any
    other engine is a registry name and ``device`` is unused.
    """

    def __init__(
        self,
        shard_id: int,
        dim: int,
        *,
        engine: str = "hopper",
        device: str = "cuda",
        dtype: str = "f32",
        block: Optional[int] = None,
        replica: int = 0,
        journal_dir: Optional[str] = None,
        fsync: bool = True,
    ) -> None:
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {_DTYPES}, got {dtype!r}")
        self.shard_id = int(shard_id)
        self.replica = int(replica)
        if journal_dir is not None:
            # each replica owns its own journal subdir, so every replica
            # recovers its shard slice independently after a crash
            self.store = SegmentedCorpusStore.open(
                os.path.join(journal_dir,
                             f"shard{self.shard_id}-r{self.replica}"),
                dim, fsync=fsync)
        else:
            self.store = SegmentedCorpusStore(dim)
        self.backend = (HopperBackend(device) if engine == "hopper"
                        else get_backend(engine))
        # the Hopper worker scores its fast modes through the kernels; a
        # numpy worker runs the reference's blocked pass
        self.on_device = engine == "hopper"
        self.dtype = dtype
        self.block = int(block) if block else _BLOCK_DEFAULTS[dtype]
        self.passes = 0
        self.last_pass_ms = 0.0
        self.total_pass_ms = 0.0
        # one blocked pass = ONE trip of this shard's corpus through RAM,
        # whether it served one query or a whole cohort — the counter the
        # cohort-throughput scenario pins (Q queries, one stream)
        self.corpus_streams = 0
        self.cohort_passes = 0   # blocked passes that served >1 plan
        self.cohort_plans = 0    # plans served by those cohort passes
        # (store version, codes, global rows, timestamps) — rebuilt lazily
        # on mutation, like the VectorCache live view
        self._packed: Optional[Tuple] = None
        # the f32b analogue: (version, f32 live rows, global rows, ts)
        self._livef32: Optional[Tuple] = None

    # -- mutations ------------------------------------------------------------

    def append(
        self,
        ids: np.ndarray,
        matrix: np.ndarray,
        timestamps: Optional[np.ndarray] = None,
        *,
        normalized: bool = False,
    ) -> int:
        """Seal this shard's slice of a group append; returns live rows."""
        self.store.append(ids, matrix, timestamps, normalized=normalized)
        return self.store.n_live

    def delete(self, ids: Sequence[int]) -> int:
        return self.store.delete(ids)

    def compact(self, min_live_fraction: float = 1.0) -> int:
        return self.store.compact(min_live_fraction)

    # -- durability -----------------------------------------------------------

    def live_ids(self) -> np.ndarray:
        """This replica's live chunk ids (coordinator reconciliation)."""
        with self.store.lock:
            segs = self.store.segments
            if not segs:
                return np.empty(0, dtype=np.int64)
            return np.concatenate([s.ids[s.live_mask] for s in segs])

    def checkpoint(self) -> int:
        """Snapshot + rotate this replica's journal (no-op unjournaled)."""
        if self.store.journal is None:
            return 0
        self.store.checkpoint()
        return self.store.checkpoints

    def close(self) -> None:
        if self.store.journal is not None:
            self.store.journal.close()

    # -- scoring --------------------------------------------------------------

    def local_pass(
        self,
        plans: Sequence[M.ModulationPlan],
        ks: Sequence[int],
        now: float,
        candidate_sets: Optional[Sequence[Optional[np.ndarray]]] = None,
    ) -> List[Dict[str, Any]]:
        """Score ``plans`` over this shard; per-plan top-``width`` results.

        Returns one dict per plan: ``ids`` (chunk ids, merged local
        order), ``scores`` (descending, local ties by row order),
        ``elig`` (this shard's eligible-row count for the plan — the
        coordinator sums these to pin global selection widths exactly),
        and for diverse plans ``pool`` (the f32 pool embeddings, row-
        aligned with ``ids``, for the coordinator's ``mmr_host`` finish).
        """
        t0 = time.perf_counter()
        nplans = len(plans)
        with self.store.lock:
            segs = self.store.segments
            panels = None
            if candidate_sets is not None and any(
                    c is not None for c in candidate_sets):
                panels, _ = self.store.candidate_mask_panel(
                    candidate_sets, segs)
            elig = np.zeros(nplans, dtype=np.int64)
            if panels is None:
                elig[:] = sum(s.live_count for s in segs)
            else:
                for panel in panels:
                    if panel is not None:
                        elig += np.count_nonzero(panel, axis=0)
            if self._fast_ok(plans, panels):
                sel = self._fast_pass(segs, plans, ks, now)
            else:
                bias = fusion_bias_arrays(self.store, segs, plans)
                # diverse plans come back as their oversample pools: MMR
                # is global, so it runs at the coordinator, never per shard
                sel = score_select_segments(
                    self.backend, segs, plans, ks, now=now,
                    candidate_masks=panels, score_bias=bias,
                    device_mmr=False)
        out: List[Dict[str, Any]] = []
        for j, ((gidx, gv), plan) in enumerate(zip(sel, plans)):
            entry: Dict[str, Any] = {
                "ids": gather_ids(segs, gidx),
                "scores": np.asarray(gv, dtype=np.float32),
                "elig": int(elig[j]),
            }
            if plan.diverse is not None:
                entry["pool"] = (gather_rows(segs, gidx) if gidx.size else
                                 np.zeros((0, self.store.dim), np.float32))
            out.append(entry)
        dt = (time.perf_counter() - t0) * 1e3
        self.passes += 1
        self.last_pass_ms = dt
        self.total_pass_ms += dt
        return out

    def _fast_ok(self, plans, panels) -> bool:
        """The blocked pass serves only the plain shapes (no Phase-1
        panel, no lexical bias); everything else takes the exact f32
        path off the same store."""
        return (self.dtype in ("f32b", "bf16") and panels is None
                and all(p.lexical is None for p in plans))

    def _packed_view(self, segs):
        """(codes, global_rows, timestamps) over this shard's LIVE rows,
        cached per store version — the bf16 analogue of the live view."""
        ver = self.store.version
        if self._packed is not None and self._packed[0] == ver:
            return self._packed[1:]
        codes_parts: List[np.ndarray] = []
        row_parts: List[np.ndarray] = []
        ts_parts: List[np.ndarray] = []
        has_ts = bool(segs) and segs[0].timestamps is not None
        off = 0
        for s in segs:
            if s.n_rows and s.live_count:
                if s.n_dead:
                    live = np.flatnonzero(s.live_mask)
                    codes_parts.append(pack_bf16(s.matrix[live]))
                    if has_ts:
                        ts_parts.append(s.timestamps[live])
                else:
                    live = np.arange(s.n_rows, dtype=np.int64)
                    codes_parts.append(pack_bf16(s.matrix))
                    if has_ts:
                        ts_parts.append(s.timestamps)
                row_parts.append(live + off)
            off += s.n_rows
        if codes_parts:
            codes = np.concatenate(codes_parts)
            rows = np.concatenate(row_parts)
            ts = np.concatenate(ts_parts) if has_ts else None
        else:
            codes = np.zeros((0, self.store.dim), dtype=np.uint16)
            rows = np.zeros(0, dtype=np.int64)
            ts = None
        self._replace_view("_packed", (ver, codes, rows, ts))
        return codes, rows, ts

    def _live_view(self, segs):
        """(f32 rows, global rows, timestamps) over this shard's LIVE
        rows, cached per store version — the ``f32b`` blocked pass's
        input.  The common shape (one sealed slice, no tombstones) is a
        zero-copy view of the segment matrix; multi-segment or
        tombstoned shards pay one gather per store version."""
        ver = self.store.version
        if self._livef32 is not None and self._livef32[0] == ver:
            return self._livef32[1:]
        mat_parts: List[np.ndarray] = []
        row_parts: List[np.ndarray] = []
        ts_parts: List[np.ndarray] = []
        has_ts = bool(segs) and segs[0].timestamps is not None
        off = 0
        for s in segs:
            if s.n_rows and s.live_count:
                if s.n_dead:
                    live = np.flatnonzero(s.live_mask)
                    mat_parts.append(s.matrix[live])
                    if has_ts:
                        ts_parts.append(s.timestamps[live])
                else:
                    live = np.arange(s.n_rows, dtype=np.int64)
                    mat_parts.append(s.matrix)
                    if has_ts:
                        ts_parts.append(s.timestamps)
                row_parts.append(live + off)
            off += s.n_rows
        if not mat_parts:
            mat = np.zeros((0, self.store.dim), dtype=np.float32)
            rows = np.zeros(0, dtype=np.int64)
            ts = None
        elif len(mat_parts) == 1:  # np.concatenate always copies
            mat, rows = mat_parts[0], row_parts[0]
            ts = ts_parts[0] if has_ts else None
        else:
            mat = np.concatenate(mat_parts)
            rows = np.concatenate(row_parts)
            ts = np.concatenate(ts_parts) if has_ts else None
        self._replace_view("_livef32", (ver, mat, rows, ts))
        return mat, rows, ts

    def _replace_view(self, attr: str, view: Tuple) -> None:
        """Swap in a rebuilt scoring view; a Hopper worker releases the
        old view's device copy now (its rows are stale for good) unless
        it is a segment matrix the exact path still scores."""
        old = getattr(self, attr)
        setattr(self, attr, view)
        if (self.on_device and old is not None and old[1] is not view[1]
                and not any(old[1] is seg.matrix
                            for seg in self.store.segments)):
            self.backend.drop_device_matrix(old[1])

    def _fast_pass(self, segs, plans, ks, now):
        """Blocked single-stream pass over the live rows: ONE trip of the
        corpus through RAM serves every plan in the call.

        Q == 1 keeps the original shape — one ``(d, 2)`` panel GEMM per
        cache-resident block (pre column scaled by decay, plus the sup
        column).  Q > 1 is COHORT mode: the block loop moves outermost
        and every plan scores the SAME resident block with its own
        ``(d, 2)`` panel before the stream advances, so the corpus
        streams from RAM once per cohort instead of once per query.  The
        cohort deliberately does NOT widen the GEMM to ``(d, 2Q)``: BLAS
        per-column bits depend on the panel width (and on ragged tail
        shapes), so a wide panel could not be bit-identical to the
        serial pass — reordering the loops keeps every plan's GEMM call
        (operand shapes, block boundaries, accumulation order) exactly
        the serial pass's, which is what makes cohort rankings
        bit-identical to Q serial queries.  The block is L2-resident, so
        plan 2..Q hit cache, not RAM.  ``bf16`` decodes each packed
        block into the f32 scratch ONCE per cohort (decode amortizes
        across Q the same way the stream does)."""
        if self.dtype == "bf16":
            codes, rows, ts = self._packed_view(segs)
            n = int(codes.shape[0])
        else:
            mat, rows, ts = self._live_view(segs)
            n = int(mat.shape[0])
        nplans = len(plans)
        empty = (np.empty(0, np.int64), np.empty(0, np.float32))
        if n == 0:
            return [empty for _ in plans]
        days = None
        if any(p.decay is not None for p in plans):
            if ts is None:
                raise ValueError(
                    "decay: modulation requires per-chunk timestamps")
            days = np.maximum(
                (now - ts) / SECONDS_PER_DAY, 0.0).astype(np.float32)
        if self.on_device:
            # one pem_score launch scores the whole cohort over the
            # resident view (the bf16 codes as bfloat16): the corpus
            # streams once per call, then topk selects each plan's pool
            self.corpus_streams += 1
            if nplans > 1:
                self.cohort_passes += 1
                self.cohort_plans += nplans
            sel = self.backend.score_select(
                codes if self.dtype == "bf16" else mat, days, plans,
                [min(int(k), n) for k in ks], fused_mmr=False)
            return [(rows[idx], vals) for idx, vals in sel]
        q_pre, q_sup = M.fold_plans(plans)
        block = max(1, self.block)
        scratch = (np.empty((min(block, n), self.store.dim), dtype=np.uint32)
                   if self.dtype == "bf16" else None)
        self.corpus_streams += 1  # one stream serves the whole call
        if nplans == 1:
            plan0 = plans[0]
            qcat = np.ascontiguousarray(
                np.concatenate([q_pre, q_sup], axis=1), dtype=np.float32)
            col1 = np.empty(n, dtype=np.float32)
            for s in range(0, n, block):
                e = min(n, s + block)
                f = (unpack_bf16(codes[s:e], out=scratch[: e - s])
                     if scratch is not None else mat[s:e])
                res = f @ qcat
                out = res[:, 0]
                if plan0.decay is not None:
                    out *= 1.0 / (
                        1.0 + days[s:e] / plan0.decay.half_life_days)
                out += res[:, 1]
                col1[s:e] = out
            cols = [col1]
        else:
            self.cohort_passes += 1
            self.cohort_plans += nplans
            # per-plan contiguous (d, 2) panels — pairs[j] is exactly the
            # qcat the serial pass would build for plan j alone
            pairs = np.ascontiguousarray(
                np.stack([q_pre.T, q_sup.T], axis=2), dtype=np.float32)
            # the decay factor column is shared within a half-life group,
            # so the combine vectorizes across the whole cohort in the
            # common uniform-half-life case and degrades to per-plan rows
            # only for genuinely mixed cohorts
            hl_groups: Dict[Optional[float], List[int]] = {}
            for j, p in enumerate(plans):
                hl = (None if p.decay is None
                      else float(p.decay.half_life_days))
                hl_groups.setdefault(hl, []).append(j)
            bm = min(block, n)
            rb = np.empty((nplans, bm, 2), dtype=np.float32)
            tmp = np.empty((nplans, bm), dtype=np.float32)
            # plan-major scores: per-plan top-k reads a contiguous row
            # instead of paying a strided copy per column
            scores = np.empty((nplans, n), dtype=np.float32)
            for s in range(0, n, block):
                e = min(n, s + block)
                m = e - s
                f = (unpack_bf16(codes[s:e], out=scratch[:m])
                     if scratch is not None else mat[s:e])
                for j in range(nplans):
                    np.matmul(f, pairs[j], out=rb[j, :m])
                pre, sup = rb[:, :m, 0], rb[:, :m, 1]
                out = scores[:, s:e]
                for hl, js in hl_groups.items():
                    if hl is None:
                        for j in js:
                            np.add(pre[j], sup[j], out=out[j])
                        continue
                    dec = 1.0 / (1.0 + days[s:e] / hl)
                    if len(js) == nplans:
                        np.multiply(pre, dec, out=tmp[:, :m])
                        np.add(tmp[:, :m], sup, out=out)
                    else:
                        for j in js:
                            np.multiply(pre[j], dec, out=tmp[j, :m])
                            np.add(tmp[j, :m], sup[j], out=out[j])
            cols = list(scores)
        sel = []
        for j, (plan, k) in enumerate(zip(plans, ks)):
            w = selection_width(plan, min(int(k), n), n)
            if w == 0:
                sel.append(empty)
                continue
            col = cols[j]
            idx = top_idx(col, w)
            sel.append((rows[idx], col[idx]))
        return sel

    # -- introspection --------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Per-shard memory + latency row (``ProcessGroup.stats()``)."""
        st = self.store.stats()
        matrix_bytes = sum(s.matrix.nbytes for s in self.store.segments)
        codes_bytes = (int(self._packed[1].nbytes)
                       if self._packed is not None else 0)
        if self.dtype == "f32b" and self._livef32 is not None:
            scoring_bytes = int(self._livef32[1].nbytes)
        elif self.dtype == "bf16" and codes_bytes:
            scoring_bytes = codes_bytes
        else:
            scoring_bytes = int(matrix_bytes)
        out = {
            "shard": self.shard_id,
            "dtype": self.dtype,
            "rows": st["rows"],
            "live": st["live"],
            "segments": st["segments"],
            "matrix_bytes": int(matrix_bytes),
            "codes_bytes": codes_bytes,
            # what a scoring pass actually streams: the packed codes for
            # a warm bf16 worker, the (usually zero-copy) live f32 view
            # for f32b, the f32 segment matrices otherwise
            "scoring_bytes": scoring_bytes,
            "passes": self.passes,
            "last_pass_ms": round(self.last_pass_ms, 3),
            "total_pass_ms": round(self.total_pass_ms, 3),
            "corpus_streams": self.corpus_streams,
            "cohort_passes": self.cohort_passes,
            "cohort_plans": self.cohort_plans,
            # what this shard holds resident on its card for scoring
            # (segment matrices, the live view or the bf16 codes)
            "device": str(self.backend.device) if self.on_device else "host",
            "device_bytes": (self.backend.device_cache_stats()["bytes"]
                             if self.on_device else 0),
        }
        for key in ("checkpoints", "recovered_records", "journal_bytes"):
            if key in st:
                out[key] = st[key]
        return out


    def kernel_launches(self, reset: bool = False) -> Dict[str, int]:
        """The kernel wrappers' launch counts in THIS worker's process
        (every worker of an inline or thread group shares its process's);
        ``reset=True`` zeroes them after reading."""
        from repro_torch.kernels.mmr.ops import mmr_select
        from repro_torch.kernels.pem_score.ops import pem_score
        from repro_torch.kernels.topk.ops import topk

        out = {"pem_score": pem_score.launches, "topk": topk.launches,
               "mmr": mmr_select.launches}
        if reset:
            pem_score.launches = topk.launches = mmr_select.launches = 0
            pem_score.stamped_launches = 0
        return out


# -- transports ---------------------------------------------------------------


class _LocalClient:
    """In-process replica (the ``inline`` and ``thread`` transports —
    thread parallelism lives in the group's fan-out pool, not here)."""

    def __init__(self, shard_id: int, replica: int, dim: int,
                 opts: Dict[str, Any]) -> None:
        self.worker = ShardWorker(shard_id, dim, replica=replica, **opts)

    def call(self, method: str, *args, **kwargs):
        return getattr(self.worker, method)(*args, **kwargs)

    def close(self) -> None:
        self.worker.close()


def _worker_loop(conn, shard_id: int, replica: int, dim: int,
                 opts: Dict[str, Any]) -> None:
    """Child-process server: one ShardWorker, pickle-RPC over a Pipe.
    A Hopper worker builds its backend (and reaches its card) here, in
    the child."""
    worker = ShardWorker(shard_id, dim, replica=replica, **opts)
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            method, args, kwargs = msg
            try:
                conn.send((True, getattr(worker, method)(*args, **kwargs)))
            except Exception as e:  # ship the failure, keep serving
                conn.send((False, f"{type(e).__name__}: {e}"))
    except (EOFError, KeyboardInterrupt):
        pass
    finally:
        worker.close()
        conn.close()


class _ProcessClient:
    """One OS-process replica behind a Pipe.  A numpy worker starts by
    fork where the platform has it (the corpus arrays and imported
    modules are shared copy-on-write at start); a Hopper worker starts by
    spawn — CUDA cannot start in a forked child once the parent has used
    it, nor do torch's thread pools survive a fork — so everything it is
    sent pickles, and it imports the port afresh."""

    def __init__(self, shard_id: int, replica: int, dim: int,
                 opts: Dict[str, Any]) -> None:
        if opts.get("engine") == "hopper":
            method = "spawn"
        else:
            method = ("fork" if "fork" in mp.get_all_start_methods()
                      else mp.get_start_method(allow_none=False))
        ctx = mp.get_context(method)
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(
            target=_worker_loop, args=(child, shard_id, replica, dim, opts),
            daemon=True)
        self._proc.start()
        child.close()
        self._lock = threading.Lock()  # one in-flight RPC per replica

    def call(self, method: str, *args, **kwargs):
        with self._lock:
            self._conn.send((method, args, kwargs))
            ok, res = self._conn.recv()
        if not ok:
            raise RuntimeError(f"shard worker failed: {res}")
        return res

    def close(self) -> None:
        try:
            with self._lock:
                self._conn.send(None)
            self._proc.join(timeout=5.0)
        except (OSError, ValueError):
            pass
        finally:
            try:
                self._conn.close()
            except OSError:
                pass
            if self._proc.is_alive():
                self._proc.terminate()


def _shard_devices(device: str, n_shards: int) -> List[str]:
    """Each shard's device for Hopper workers: a card without an index
    deals shards round-robin over the visible cards; raises when a card
    is asked for and none is present (before any worker starts)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        count = torch.cuda.device_count()
        return [f"cuda:{s % count}" for s in range(n_shards)]
    return [str(_kernel_device(dev, "ProcessGroup"))] * n_shards


# -- the coordinator ----------------------------------------------------------


class ProcessGroup:
    """Shard-replica router: partition, fan out, merge exactly.

    Rows are dealt round-robin across ``n_shards`` at append time (so any
    append pattern stays balanced) and every id's GLOBAL insertion rank
    is recorded — that rank is the monolithic store's row order, which is
    the monolithic merge's tie rule, so the coordinator's
    ``lexsort((ranks, -scores))`` reproduces the monolithic stable sort
    bit for bit.  ``replicas`` > 1 keeps identical copies of every shard
    and round-robins queries across them (each replica applies every
    mutation, so any replica can serve any query).

    Exactness contract (the cross-shard analogue of ``union_merge_topk``):
    each shard returns its top-``min(width, local_eligible)`` candidates,
    the merged valid count is therefore exactly ``min(width,
    total_eligible)``, and diverse pools finish with the same
    :func:`mmr_host` oracle / ``fuse:rrf`` with the same
    :func:`finalize_fusion` recipe the monolithic host tail runs.
    Shard-local compaction is allowed but may reorder exact ties at the
    selection-width boundary relative to a never-compacted monolith (the
    parity suites pin the uncompacted contract).

    ``engine="hopper"`` (the default) gives every worker a
    :class:`HopperBackend`: on the card by default, shard s on
    ``cuda:{s % device_count}`` (a device with an index pins every shard
    to it), or the kernels' plain versions with ``device="cpu"``.  A
    registry name (``"fused-numpy"``) gives the reference's numpy
    workers.  Asking for a card on a machine without one raises.
    """

    def __init__(
        self,
        dim: int,
        n_shards: int = 4,
        *,
        replicas: int = 1,
        transport: str = "inline",
        dtype: str = "f32",
        engine: str = "hopper",
        device: str = "cuda",
        block: Optional[int] = None,
        journal_dir: Optional[str] = None,
        fsync: bool = True,
    ) -> None:
        if transport not in _TRANSPORTS:
            raise ValueError(
                f"transport must be one of {_TRANSPORTS}, got {transport!r}")
        if n_shards < 1 or replicas < 1:
            raise ValueError("n_shards and replicas must be >= 1")
        self.dim = int(dim)
        self.n_shards = int(n_shards)
        self.replicas = int(replicas)
        self.transport = transport
        self.dtype = dtype
        self.journal_dir = None if journal_dir is None else str(journal_dir)
        opts = {"engine": engine, "dtype": dtype, "block": block}
        if self.journal_dir is not None:
            os.makedirs(self.journal_dir, exist_ok=True)
            opts["journal_dir"] = self.journal_dir
            opts["fsync"] = fsync
        devices = (_shard_devices(device, self.n_shards)
                   if engine == "hopper" else [None] * self.n_shards)
        #: each shard's device ("cuda:1", "cpu"), None for numpy workers
        self.devices = devices
        mk = _ProcessClient if transport == "process" else _LocalClient
        self._clients = [
            [mk(s, r, dim, opts if devices[s] is None
                else {**opts, "device": devices[s]})
             for r in range(self.replicas)]
            for s in range(self.n_shards)]
        self._pool = (None if transport == "inline" else cf.ThreadPoolExecutor(
            self.n_shards * self.replicas,
            thread_name_prefix="flexvec-shard"))
        self._rank: Dict[int, int] = {}      # id -> global insertion order
        self._shard_of: Dict[int, int] = {}  # LIVE id -> owning shard
        self._row_counter = 0
        self._has_ts: Optional[bool] = None
        self._rr = 0
        self._lock = threading.Lock()
        self.searches = 0
        self.last_fanout_ms = 0.0
        self.last_merge_ms = 0.0
        # replica-aware failover: a replica whose TRANSPORT dies (pipe
        # EOF/OSError — not an application error, which propagates) is
        # marked dead and the call retries the shard's survivors;
        # ``failovers`` counts query calls served by a non-preferred
        # replica because the preferred one was (or just went) dead
        self._dead = [[False] * self.replicas for _ in range(self.n_shards)]
        self._fail_lock = threading.Lock()
        self.failovers = 0
        self._closed = False
        # coordinator journal: group-level append/delete records (row ->
        # shard routing + insertion ranks) so open() rebuilds the merge
        # bookkeeping without rescanning every shard
        self.journal = (None if self.journal_dir is None else StoreJournal(
            os.path.join(self.journal_dir, "coordinator"), fsync=fsync))
        self.checkpoints = 0
        self.recovered_records = 0
        self.reconciled_drops = 0
        if self.journal is not None:
            self._recover()

    # -- lifecycle ------------------------------------------------------------

    @classmethod
    def build(
        cls,
        ids: Sequence[int],
        matrix: np.ndarray,
        timestamps: Optional[Sequence[float]] = None,
        *,
        normalized: bool = False,
        **kwargs,
    ) -> "ProcessGroup":
        """Group over an existing corpus (the serve-layer attach path)."""
        matrix = np.asarray(matrix, dtype=np.float32)
        group = cls(dim=matrix.shape[1] if matrix.ndim == 2 else 0, **kwargs)
        group.append(ids, matrix, timestamps, normalized=normalized)
        return group

    @classmethod
    def open(cls, journal_dir: str, dim: int, **kwargs) -> "ProcessGroup":
        """Recover a journaled group: every shard replica reopens its
        store from its own journal subdir, the coordinator replays its
        group-level journal to rebuild the routing/rank maps, and rows
        caught in the crash window (fanned out but never coordinator-
        acknowledged, or the reverse for deletes) are reconciled away.
        ``n_shards``/``replicas``/``dtype`` must match the writer's."""
        return cls(dim, journal_dir=journal_dir, **kwargs)

    def _recover(self) -> None:
        """Coordinator recovery: snapshot + delta replay, then reconcile
        the routing maps against what the shard stores actually hold.

        The acknowledgement order is shards-first (each worker journals
        WAL-first inside its own ``append``), coordinator journal second.
        So after a crash either side may be ahead by one un-acked
        mutation; the coordinator journal is the source of truth for what
        was ACKED, and both directions converge to it:

        * a row live on a shard but absent from the coordinator map was
          never acknowledged -> tombstone it on that replica;
        * a row the coordinator maps but some replica lacks was hit by an
          un-acked delete -> drop it from the map (and from any replica
          that still holds it, via the same orphan pass).
        """
        snap = self.journal.load_snapshot()
        if snap is not None:
            self._rank = {int(k): int(v) for k, v in snap["rank"].items()}
            self._shard_of = {int(k): int(v)
                              for k, v in snap["shard_of"].items()}
            self._row_counter = int(snap["row_counter"])
            self._has_ts = snap["has_ts"]
        after = int(snap["seq"]) if snap is not None else -1
        records = list(self.journal.replay(after_seq=after))
        self.journal.truncate_torn_tail()
        for rec in records:
            p = rec.payload
            if rec.kind == "group_append":
                base = int(p["base"])
                for j, (cid, s) in enumerate(zip(p["ids"], p["shards"])):
                    self._rank[int(cid)] = base + j
                    self._shard_of[int(cid)] = int(s)
                self._row_counter = max(self._row_counter,
                                        base + len(p["ids"]))
                self._has_ts = bool(p["has_ts"])
            elif rec.kind == "group_delete":
                for cid in p["ids"]:
                    self._shard_of.pop(int(cid), None)
        self.recovered_records = len(records)
        # reconcile: coordinator map vs the recovered shard stores
        coord: List[Set[int]] = [set() for _ in range(self.n_shards)]
        for cid, s in self._shard_of.items():
            coord[s].add(cid)
        live = [[{int(i) for i in self._clients[s][r].call("live_ids")}
                 for r in range(self.replicas)]
                for s in range(self.n_shards)]
        ghosts: Set[int] = set()
        for s in range(self.n_shards):
            for r in range(self.replicas):
                ghosts |= coord[s] - live[s][r]
        for cid in ghosts:
            self._shard_of.pop(cid, None)
        dropped: Set[int] = set(ghosts)
        for s in range(self.n_shards):
            keep = coord[s] - ghosts
            for r in range(self.replicas):
                orphans = live[s][r] - keep
                if orphans:
                    dropped |= orphans
                    self._clients[s][r].call(
                        "delete",
                        np.asarray(sorted(orphans), dtype=np.int64))
        self.reconciled_drops = len(dropped)

    def checkpoint(self) -> int:
        """Snapshot the coordinator maps AND every shard replica's store,
        rotating all journals — the next :meth:`open` replays only the
        records written since.  Returns coordinator checkpoints so far."""
        if self.journal is None:
            return 0
        calls = [functools.partial(self._mutation_call, s, r, "checkpoint")
                 for s in range(self.n_shards)
                 for r in range(self.replicas)]
        self._fanout(calls)
        with self._lock:
            self.journal.write_snapshot({
                "rank": dict(self._rank),
                "shard_of": dict(self._shard_of),
                "row_counter": self._row_counter,
                "has_ts": self._has_ts,
            })
            self.checkpoints += 1
        return self.checkpoints

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        if self.journal is not None:
            self.journal.close()
        for row in self._clients:
            for client in row:
                client.close()

    def __enter__(self) -> "ProcessGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- corpus mutations -----------------------------------------------------

    @property
    def n_live(self) -> int:
        return len(self._shard_of)

    def append(
        self,
        ids: Sequence[int],
        matrix: np.ndarray,
        timestamps: Optional[Sequence[float]] = None,
        *,
        normalized: bool = False,
    ) -> int:
        """Deal rows round-robin across shards (every replica appends its
        shard's slice); rows keep their global insertion rank."""
        ids_arr = np.asarray(ids, dtype=np.int64)
        matrix = np.asarray(matrix, dtype=np.float32)
        if matrix.ndim != 2 or matrix.shape[0] != ids_arr.shape[0]:
            raise ValueError(
                f"matrix shape {matrix.shape} inconsistent with "
                f"{len(ids_arr)} ids")
        if ids_arr.size == 0:
            return 0
        ts = (np.asarray(timestamps, dtype=np.float64)
              if timestamps is not None else None)
        if ts is not None and ts.shape[0] != ids_arr.shape[0]:
            raise ValueError("timestamps misaligned with ids")
        with self._lock:
            if self._has_ts is not None and self._has_ts != (ts is not None):
                raise ValueError(
                    "timestamp presence must match the existing group "
                    f"(group has timestamps: {self._has_ts})")
            uniq, counts = np.unique(ids_arr, return_counts=True)
            dupes = [int(i) for i in uniq[counts > 1]]
            dupes += [int(i) for i in ids_arr if int(i) in self._shard_of]
            if dupes:
                raise ValueError(
                    f"append: ids already live in the group: {dupes[:10]}"
                    + ("..." if len(dupes) > 10 else ""))
            shard = (self._row_counter
                     + np.arange(ids_arr.size, dtype=np.int64)) % self.n_shards
            calls = []
            for s in range(self.n_shards):
                rows = np.flatnonzero(shard == s)
                if rows.size == 0:
                    continue
                part = (ids_arr[rows], np.ascontiguousarray(matrix[rows]),
                        None if ts is None else ts[rows])
                for r in range(self.replicas):
                    calls.append(functools.partial(
                        self._mutation_call, s, r, "append", *part,
                        normalized=normalized))
            self._fanout(calls)
            # shards ack first (each worker journals WAL-first); the
            # coordinator record IS the group-level acknowledgement —
            # open() drops shard rows that never reached this line
            if self.journal is not None:
                self.journal.append_record("group_append", {
                    "ids": [int(i) for i in ids_arr],
                    "shards": [int(s_) for s_ in shard],
                    "base": int(self._row_counter),
                    "has_ts": ts is not None,
                })
            for j, cid in enumerate(ids_arr):
                self._rank[int(cid)] = self._row_counter + j
                self._shard_of[int(cid)] = int(shard[j])
            self._row_counter += int(ids_arr.size)
            self._has_ts = ts is not None
        return int(ids_arr.size)

    def delete(self, ids: Sequence[int]) -> int:
        """Tombstone ids on their owning shards (all replicas); returns
        rows newly tombstoned.  Unknown ids are ignored (non-strict)."""
        with self._lock:
            by_shard: Dict[int, List[int]] = {}
            for cid in ids:
                s = self._shard_of.get(int(cid))
                if s is not None:
                    by_shard.setdefault(s, []).append(int(cid))
            if not by_shard:
                return 0
            calls = []
            bases = []  # (shard, index of its first replica's result)
            for s, victims in by_shard.items():
                arr = np.asarray(victims, dtype=np.int64)
                bases.append(len(calls))
                for r in range(self.replicas):
                    calls.append(functools.partial(
                        self._mutation_call, s, r, "delete", arr))
            results = self._fanout(calls)
            if self.journal is not None:
                self.journal.append_record("group_delete", {
                    "ids": [cid for victims in by_shard.values()
                            for cid in victims]})
            for victims in by_shard.values():
                for cid in victims:
                    del self._shard_of[cid]
            # per shard: the first SURVIVING replica's count (dead
            # replicas return None)
            return int(sum(
                next((results[b + r] for r in range(self.replicas)
                      if results[b + r] is not None), 0)
                for b in bases))

    def compact(self, min_live_fraction: float = 1.0) -> int:
        """Shard-local GC on every replica; returns segments folded
        (first surviving replica per shard)."""
        calls = [functools.partial(self._mutation_call, s, r, "compact",
                                   min_live_fraction)
                 for s in range(self.n_shards)
                 for r in range(self.replicas)]
        results = self._fanout(calls)
        return int(sum(
            next((results[s * self.replicas + r]
                  for r in range(self.replicas)
                  if results[s * self.replicas + r] is not None), 0)
            for s in range(self.n_shards)))

    # -- search ---------------------------------------------------------------

    def search_plan(
        self,
        plan: M.ModulationPlan,
        candidate_ids: Optional[Sequence[int]] = None,
        *,
        now: Optional[float] = None,
        k: Optional[int] = None,
    ) -> List[Tuple[int, float]]:
        """Single-plan mirror of ``VectorCache.search_plan`` (pool-width
        ranking unless ``k`` narrows it)."""
        ks = None if k is None else [k]
        (out,) = self.search_plan_batch(
            [plan], [candidate_ids], now=now, ks=ks)
        return out

    def search_plan_batch(
        self,
        plans: Sequence[M.ModulationPlan],
        candidate_sets: Optional[Sequence[Optional[Sequence[int]]]] = None,
        *,
        now: Optional[float] = None,
        ks: Optional[Sequence[int]] = None,
    ) -> List[List[Tuple[int, float]]]:
        """Fan a plan cohort out to one replica per shard, merge exactly.

        ``candidate_sets[j]`` is plan ``j``'s Phase-1 candidate id set
        (None = full corpus) — heterogeneous filters ride each shard's
        (n, B) mask panel, same as the batched engine.  ``ks[j]`` is the
        final candidate count (default ``min(plan.pool, n_live)``, the
        direct-path contract).
        """
        nplans = len(plans)
        ref = time.time() if now is None else now
        if candidate_sets is None:
            candidate_sets = [None] * nplans
        if len(candidate_sets) != nplans:
            raise ValueError("candidate_sets misaligned with plans")
        cands: List[Optional[np.ndarray]] = []
        for plan, c in zip(plans, candidate_sets):
            # fuse:filter promotes the lexical hit set to the Phase-1
            # candidate set, intersecting any SQL filter — identical to
            # the VectorCache.search_plan routing
            c = M.filter_candidate_ids(plan, c)
            if c is not None and not isinstance(c, np.ndarray):
                c = np.asarray(list(c), dtype=np.int64)
            cands.append(c)
        n_live = self.n_live
        ks_eff = ([min(p.pool, n_live) for p in plans] if ks is None
                  else [min(int(k), n_live) for k in ks])
        with self._lock:
            r = self._rr
            self._rr = (self._rr + 1) % self.replicas
        self.searches += 1
        t0 = time.perf_counter()
        # the whole plan cohort ships to ONE replica per shard in ONE RPC,
        # so each shard's corpus streams once per cohort (see _fast_pass);
        # a dead replica fails over to the shard's survivors
        calls = [functools.partial(self._call_failover, s, r, "local_pass",
                                   list(plans), ks_eff, ref, cands)
                 for s in range(self.n_shards)]
        parts = self._fanout(calls)
        t1 = time.perf_counter()
        self.last_fanout_ms = (t1 - t0) * 1e3

        results: List[List[Tuple[int, float]]] = []
        for j, (plan, k) in enumerate(zip(plans, ks_eff)):
            ids = np.concatenate([p[j]["ids"] for p in parts])
            vals = np.concatenate([p[j]["scores"] for p in parts])
            if ids.size == 0:
                results.append([])
                continue
            elig = int(sum(p[j]["elig"] for p in parts))
            ranks = np.fromiter((self._rank[int(i)] for i in ids),
                                np.int64, ids.size)
            # primary: score descending; ties: insertion rank ascending —
            # exactly the monolithic merge's stable sort over row order
            order = np.lexsort((ranks, -vals))
            if plan.diverse is not None:
                w = selection_width(plan, min(k, elig), elig)
                order = order[:w]
                kf = max(0, min(k, int(order.size)))
                if kf == 0:
                    results.append([])
                    continue
                pool_ids = ids[order]
                pool_vals = vals[order]
                pool_emb = np.concatenate(
                    [p[j]["pool"] for p in parts])[order]
                sel = mmr_host(pool_emb, pool_vals, kf, plan.diverse.lam)
                out = [(int(i), float(v))
                       for i, v in zip(pool_ids[sel], pool_vals[sel])]
            else:
                order = order[:k]
                out = [(int(i), float(v))
                       for i, v in zip(ids[order], vals[order])]
            results.append(self._finalize_rrf(plan, out, k, cands[j]))
        self.last_merge_ms = (time.perf_counter() - t1) * 1e3
        return results

    def _finalize_rrf(self, plan, results, k, cand):
        """Coordinator-side ``finalize_fusion``: identical recipe, with
        live-membership resolved from the group's id->shard index."""
        f = plan.fusion
        if f is None or f.mode != "rrf" or plan.lexical is None:
            return results
        lex = np.asarray(plan.lexical.ids, np.int64)
        if cand is not None:
            lex = lex[np.isin(lex, cand)]
        lex_ids = [int(i) for i in lex if int(i) in self._shard_of]
        fused = M.rrf_fuse([i for i, _ in results], lex_ids, f.rrf_k)
        return [(int(i), float(s)) for i, s in fused[:max(0, k)]]

    # -- plumbing -------------------------------------------------------------

    #: a replica whose transport raises one of these is DEAD (the pipe
    #: closed under it); application errors ship as (False, msg) and
    #: surface as RuntimeError, which propagates — never fails over
    _TRANSPORT_ERRORS = (EOFError, OSError)

    def _mark_dead(self, s: int, r: int) -> None:
        with self._fail_lock:
            self._dead[s][r] = True
        try:
            self._clients[s][r].close()
        except Exception:
            pass

    def _call_failover(self, s: int, r: int, method: str, *args, **kwargs):
        """Query-path call: try the preferred replica ``r``, fail over
        across the shard's survivors on transport death.  Raises only
        when the shard has NO surviving replica."""
        last: Optional[BaseException] = None
        for attempt in range(self.replicas):
            rr = (r + attempt) % self.replicas
            if self._dead[s][rr]:
                continue
            try:
                res = self._clients[s][rr].call(method, *args, **kwargs)
            except self._TRANSPORT_ERRORS as e:
                self._mark_dead(s, rr)
                last = e
                continue
            if attempt:  # served by a survivor, not the preferred replica
                with self._fail_lock:
                    self.failovers += 1
            return res
        raise RuntimeError(
            f"shard {s}: no surviving replicas"
            + (f" (last transport error: {last!r})" if last else ""))

    def _mutation_call(self, s: int, r: int, method: str, *args, **kwargs):
        """Mutation-path call: every LIVE replica applies the mutation;
        a dead one is skipped (returns None — it can never serve a query
        again, so missing the write is safe).  Raises only when the death
        leaves the shard with zero survivors: the shard's rows would be
        gone, which no retry can hide."""
        if self._dead[s][r]:
            return None
        try:
            return self._clients[s][r].call(method, *args, **kwargs)
        except self._TRANSPORT_ERRORS:
            self._mark_dead(s, r)
            if not any(not d for d in self._dead[s]):
                raise RuntimeError(f"shard {s}: no surviving replicas")
            return None

    def _fanout(self, thunks):
        if self._pool is None:
            return [t() for t in thunks]
        futs = [self._pool.submit(t) for t in thunks]
        return [f.result() for f in futs]

    def stats(self) -> Dict[str, Any]:
        """Topology + per-shard memory/latency rows (every live replica),
        plus the failover ledger and per-shard row skew (round-robin
        dealing assumes uniform rows; deletes can unbalance shards, and
        the slowest — biggest — shard bounds every fan-out)."""
        shard_rows = []
        live_per_shard: List[int] = []
        streams = 0
        for s in range(self.n_shards):
            first: Optional[Dict[str, Any]] = None
            for r_i in range(self.replicas):
                if self._dead[s][r_i]:
                    continue
                try:
                    row = dict(self._clients[s][r_i].call("stats"))
                except self._TRANSPORT_ERRORS:
                    self._mark_dead(s, r_i)
                    continue
                row["replica"] = r_i
                shard_rows.append(row)
                if first is None:
                    first = row
            live_per_shard.append(0 if first is None else int(first["live"]))
            streams += 0 if first is None else int(
                first.get("corpus_streams", 0))
        max_live = max(live_per_shard, default=0)
        min_live = min(live_per_shard, default=0)
        journal = ({} if self.journal is None else {
            "checkpoints": self.checkpoints,
            "recovered_records": self.recovered_records,
            "reconciled_drops": self.reconciled_drops,
            "journal_bytes": self.journal.journal_bytes,
        })
        return {
            "n_shards": self.n_shards,
            "replicas": self.replicas,
            "transport": self.transport,
            "dtype": self.dtype,
            "live": self.n_live,
            "rows": self._row_counter,
            "searches": self.searches,
            "last_fanout_ms": round(self.last_fanout_ms, 3),
            "last_merge_ms": round(self.last_merge_ms, 3),
            "failovers": self.failovers,
            "dead_replicas": sum(d for row in self._dead for d in row),
            "row_skew": {
                "max_live": int(max_live),
                "min_live": int(min_live),
                "spread": int(max_live - min_live),
                "ratio": round(max_live / min_live, 3) if min_live else None,
            },
            "corpus_streams": streams,
            "shards": shard_rows,
            **journal,
        }
