"""ExecutionBackend — the single engine-dispatch seam (all Phase-2 paths).

The port of ``repro.core.backends``: every consumer resolves a backend and
calls the same primitives:

    score(matrix, days_ago, plan)                    -> (N,)   one request
    score_panel(matrix, days_ago, plans)             -> (N, B) a micro-batch
    score_select(matrix, days_ago, plans, ks, mask=) -> per-plan top candidates
    score_select_segments(backend, segments, ...)    -> segmented corpus pass
    score_select_prefiltered(backend, store, ...)    -> Phase-1 filtered pass
    score_select_filter_panel(backend, store, ...)   -> heterogeneous-filter
                                                        batch via one (N, B)
                                                        mask panel

``score_select`` is the fused score->select stage: it returns ONLY the
top-:func:`selection_width` candidate ``(indices, scores)`` per plan.  On
:class:`HopperBackend` the whole chain runs on the card with no host hop:
the ``pem_score`` kernel writes the (B, N) score panel, the ``topk`` kernel
selects each plan's pool from it, and for diverse plans the ``mmr`` kernel
selects the final k over that pool, so only final candidates come back.
The host finishing stage (:func:`finalize_candidates`: truncate, or the
:func:`mmr_host` oracle over the oversampled pool) is shared by every
host-path consumer, so batched and direct paths rank identically.

Backends:

    reference-numpy  paper-faithful, one matvec per direction (Table 1)
    fused-numpy      folded two-matvec formulation (one corpus stream)
    HopperBackend    pem_score -> topk -> mmr kernels on the card
                     (``device="cpu"`` runs their plain versions)

The numpy backends are registered by name and keep the host path (full
panel + numpy selection), the oracle the Hopper backend is held against.
:class:`HopperBackend` needs a device, so callers construct it and pass
the instance; :func:`get_backend` passes instances straight through.

Live corpora (`repro_torch.core.segments`) score through
:func:`score_select_segments`: each segment scores independently (its
tombstones masked to -inf ON DEVICE via ``score_select``'s ``mask``
argument, before selection), per-segment top-k candidates merge on the
host, and the result is bit-identical to a monolithic store.  The
per-array device matrix cache (:class:`_DeviceMatrixMixin`) holds one
entry per warm segment, so appending a segment uploads ONLY the delta.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import modulations as M

__all__ = [
    "ExecutionBackend",
    "HopperBackend",
    "PlanStructure",
    "get_backend",
    "register_backend",
    "list_backends",
    "select_candidates",
    "selection_width",
    "finalize_candidates",
    "score_select_segments",
    "score_select_cohort",
    "score_select_prefiltered",
    "score_select_filter_panel",
    "finalize_segment_candidates",
    "PrefilterRouter",
    "FusedCounters",
    "mmr_host",
    "plan_fusion_bias",
    "fusion_bias_arrays",
    "finalize_fusion",
]

Candidates = Tuple[np.ndarray, np.ndarray]  # (indices, scores), descending


def _require_days(plan: M.ModulationPlan, days_ago: Optional[np.ndarray]) -> None:
    if plan.decay is not None and days_ago is None:
        raise ValueError("decay: modulation requires per-chunk timestamps")


def _decay_column(days_ago: np.ndarray, half_life: float) -> np.ndarray:
    return 1.0 / (1.0 + days_ago / half_life)


def _pow2_bucket(x: int) -> int:
    """0 for x<=0, else the next power of two >= x (trace-bounding pad)."""
    if x <= 0:
        return 0
    return 1 << (x - 1).bit_length()


def _empty_candidates() -> Candidates:
    return np.empty(0, np.int64), np.empty(0, np.float32)


def _slice_candidates(idx: np.ndarray, vals: np.ndarray,
                      widths: Sequence[int]) -> List[Candidates]:
    """Host tail of the device ``score_select``: slice each plan's prefix
    of the fetched (B, width) blocks (rows are sorted descending, so the
    first w are its top-w)."""
    return [(idx[j, :w].astype(np.int64), vals[j, :w])
            for j, w in enumerate(widths)]


def mmr_host(
    pool_embeds: np.ndarray,
    pool_scores: np.ndarray,
    k: int,
    lam: float,
) -> np.ndarray:
    """Host MMR over an oversampled candidate pool -> selection positions.

    THE oracle every fused device-MMR path (:class:`_DeviceMMRMixin`, the
    ``kernels/mmr`` kernel chain) is held against, and the path the numpy
    backends keep.  The single call site of
    ``modulations.mmr_select_np`` — :func:`finalize_candidates` and
    :func:`select_candidates` both finish diversity here.
    """
    return M.mmr_select_np(pool_embeds, pool_scores, k, lam)



@dataclasses.dataclass
class FusedCounters:
    """Fused-Phase-2 observability (``RetrievalService.stats()["fused"]``).

    ``device_mmr`` counts diverse plans finished by on-device MMR — the
    oversample pool never crossed to the host.  ``host_pool_transfers``
    counts diverse plans that DID ship their pool back for the
    :func:`mmr_host` oracle; a regression back to host MMR shows up here
    before it shows up as latency.  ``panel_batches`` counts batched
    (N, B) mask-panel passes that served a heterogeneous-filter cohort in
    ONE device scoring pass instead of one per distinct filter.  Benign
    int bumps, same convention as the store's counters.
    """

    device_mmr: int = 0
    host_pool_transfers: int = 0
    panel_batches: int = 0

    def stats(self) -> Dict[str, int]:
        return {
            "device_mmr": self.device_mmr,
            "host_pool_transfers": self.host_pool_transfers,
            "panel_batches": self.panel_batches,
        }


# -1e30 stands in for -inf in MMR relevance (0 * -inf is NaN): the mmr
# kernel pins padded and taken slots to it (kernels/mmr/ref.py NEG)
_MMR_NEG = -1e30


def _pool_widths(widths, mask, n: int, batch: int) -> np.ndarray:
    """Per-plan TRUE pool widths (padded to ``batch``): each plan's
    selection width clamped to its eligible-row count, so top-k padding
    and -inf masked slots can never enter a fused-MMR pool."""
    if mask is None:
        live = np.full(len(widths), n, dtype=np.int64)
    elif mask.ndim == 2:
        live = np.count_nonzero(mask, axis=0).astype(np.int64)
    else:
        live = np.full(len(widths), int(np.count_nonzero(mask)),
                       dtype=np.int64)
    pw = np.minimum(np.asarray(widths, np.int64), live)
    if batch > len(widths):
        pw = np.pad(pw, (0, batch - len(widths)))
    return pw.astype(np.int32)


def _to_device(array: np.ndarray, device):
    """Host array -> tensor on ``device`` (no copy on the CPU)."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


class _DeviceMatrixMixin:
    """Per-array device-resident corpus cache (bounded, LRU).

    A segmented store scores one launch per segment, so the cache holds
    SEVERAL resident tensors at once — keyed on array identity — instead
    of a single slot: appending a 10k-chunk segment to a warm 240k corpus
    uploads ONLY the new segment while every sealed segment stays on
    ``self.device``.  ``uploads`` counts host->device copies.
    """

    _DEV_CACHE_SIZE = 32

    uploads = 0        # host->device copies performed
    dev_hits = 0       # calls served from the resident cache
    dev_evictions = 0  # LRU evictions

    def _device_matrix(self, matrix: np.ndarray):
        cache: "OrderedDict[int, Tuple[np.ndarray, object]]"
        cache = self.__dict__.setdefault("_dev_cache", OrderedDict())
        key = id(matrix)
        entry = cache.get(key)
        # the stored source reference guards against id() reuse after gc
        if entry is not None and entry[0] is matrix:
            cache.move_to_end(key)
            self.dev_hits += 1
            return entry[1]
        dev = _to_device(np.asarray(matrix, np.float32), self.device)
        cache[key] = (matrix, dev)
        cache.move_to_end(key)
        self.uploads += 1
        while len(cache) > self._DEV_CACHE_SIZE:
            cache.popitem(last=False)
            self.dev_evictions += 1
        return dev

    def device_cache_stats(self) -> Dict[str, int]:
        return {
            "entries": len(self.__dict__.get("_dev_cache", ())),
            "uploads": self.uploads,
            "hits": self.dev_hits,
            "evictions": self.dev_evictions,
        }


class _DeviceMMRMixin:
    """Fused on-device MMR for diverse plans.

    Inside ``score_select`` the chain runs the ``kernels/mmr`` kernel after
    top-k, so diverse plans return only the final k ``(indices, scores)``
    — the oversample pool never crosses the device boundary.  For the
    merged per-segment pool, :meth:`mmr_pool_segments_batch` gathers the
    pool embeddings ON DEVICE (``index_select``) from the warm resident
    segment matrices and runs one kernel launch for the whole cohort.
    Every path reproduces the :func:`mmr_host` oracle: same greedy argmax,
    same first-occurrence tie-breaking, and the returned scores are the
    RELEVANCE scores at the selected positions (exactly what the host
    finishing stage returns).
    """

    device_mmr = True

    def _use_mmr(self, plans, fused_mmr: Optional[bool]) -> bool:
        if not (self.device_mmr if fused_mmr is None else bool(fused_mmr)):
            return False
        return any(p.diverse is not None for p in plans)

    def _gather_pool_device(self, segments, gidx: np.ndarray):
        """Device-resident (pool, d) embeddings for merged global rows,
        gathered segment by segment from the warm resident matrices."""
        import torch

        from repro_torch.core.segments import segment_offsets

        off = segment_offsets(segments)
        seg_idx = np.searchsorted(off, gidx, side="right") - 1
        local = gidx - off[seg_idx]
        out = torch.empty((gidx.size, segments[0].matrix.shape[1]),
                          dtype=torch.float32, device=self.device)
        for s in np.unique(seg_idx):
            pos = np.flatnonzero(seg_idx == s)
            rows = self._device_matrix(segments[s].matrix).index_select(
                0, _to_device(local[pos], self.device))
            out.index_copy_(0, _to_device(pos, self.device), rows)
        return out

    def mmr_pool_segments_batch(self, segments, pools, ks, lams):
        """One device call for a COHORT of merged diverse pools.

        ``pools`` is a list of per-plan ``(gidx, vals)`` merged unions,
        ``ks``/``lams`` the matching final counts and MMR lambdas.  Every
        pool pads to the cohort's widest (padding carries rel = NEG) and
        the whole (B, width, d) stack runs through ONE ``mmr`` kernel
        launch with a per-plan lambda vector — one device sync for the
        batch.  Returns per-plan selection-position arrays (empty for
        k == 0 pools).
        """
        from repro_torch.kernels.mmr.ops import mmr_select

        sizes = [int(g.size) for g, _ in pools]
        ks = [max(0, min(int(k), s)) for k, s in zip(ks, sizes)]
        live = [j for j, (s, k) in enumerate(zip(sizes, ks)) if s and k]
        out = [np.empty(0, np.int64)] * len(pools)
        if not live:
            return out
        width = max(sizes[j] for j in live)
        dim = segments[0].matrix.shape[1]
        # one gather for every pool, scattered into the padded stack
        gidx = np.concatenate([np.asarray(pools[j][0], np.int64)
                               for j in live])
        slots = np.concatenate([row * width + np.arange(sizes[j])
                                for row, j in enumerate(live)])
        emb = self._gather_pool_device(segments, gidx)
        stack = emb.new_zeros((len(live) * width, dim))
        stack.index_copy_(0, _to_device(slots, self.device), emb)
        rel = np.full((len(live), width), _MMR_NEG, np.float32)
        for row, j in enumerate(live):
            rel[row, :sizes[j]] = pools[j][1]
        sel, _ = mmr_select(
            stack.view(len(live), width, dim), _to_device(rel, self.device),
            max(ks[j] for j in live),
            _to_device(np.asarray([lams[j] for j in live], np.float32),
                       self.device))
        sel = sel.cpu().numpy()
        for row, j in enumerate(live):
            out[j] = sel[row, :ks[j]].astype(np.int64)
        return out


# ---------------------------------------------------------------------------
# Plan structure
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanStructure:
    """The *shape* of a scoring micro-batch, as the reference package
    keys its compiled graphs on it.

    The Hopper kernels take exact shapes and compile nothing per call, so
    the port reads one field: ``width``, the pow2-bucketed top-k width,
    which makes the Hopper backend select exactly as wide a pool as the
    reference's device backends do.  Suppress count, top-k width and the
    corpus row count are bucketed (padded up to powers of two).
    """

    batch: int            # B — number of plans folded into the panel
    n_rows: int           # DEVICE row count: corpus rows pow2-bucketed
    has_decay: bool       # decay factor branch present in the graph
    suppress_bucket: int  # max suppress count, padded to a power of two
    width: int            # static top-k width (pow2-bucketed, <= n_rows)
    mmr_k: int = 0        # in-graph MMR step count (pow2; 0 = no MMR tail)
    panel: bool = False   # (N, B) per-plan mask panel; batch pow2-bucketed
    bias: bool = False    # additive (N, B) score-bias panel (hybrid fusion)

    @classmethod
    def of(
        cls,
        plans: Sequence[M.ModulationPlan],
        widths: Sequence[int],
        n_rows: int,
        *,
        ks: Optional[Sequence[int]] = None,
        device_mmr: bool = False,
        panel: bool = False,
        bias: bool = False,
        cohort: bool = False,
    ) -> "PlanStructure":
        """``cohort=True`` pow2-buckets the BATCH axis even without a
        mask panel — the multi-query cohort path's trace bound: a stream
        of varying admitted-batch sizes (Q = 3, then 5, then 4 ...) pads
        into pow2 query-panel buckets and compiles one graph per bucket
        instead of one per Q (padded columns carry zero queries and are
        never sliced out into results)."""
        max_sup = max((len(p.suppress) for p in plans), default=0)
        w = max(widths, default=0)
        bucket = max(_pow2_bucket(n_rows), 1)
        width = min(max(_pow2_bucket(w), 1), bucket)
        mmr_k = 0
        if device_mmr and ks is not None and any(
                p.diverse is not None for p in plans):
            k_max = max((min(max(k, 0), n_rows) for k in ks), default=0)
            mmr_k = min(max(_pow2_bucket(k_max), 1), width)
        return cls(
            batch=(max(_pow2_bucket(len(plans)), 1) if (panel or cohort)
                   else len(plans)),
            n_rows=bucket,
            has_decay=any(p.decay is not None for p in plans),
            suppress_bucket=_pow2_bucket(max_sup),
            width=width,
            mmr_k=mmr_k,
            panel=panel,
            bias=bias,
        )


# ---------------------------------------------------------------------------
# The backend contract
# ---------------------------------------------------------------------------


class ExecutionBackend:
    """One Phase-2 scoring implementation.

    Subclasses implement :meth:`score_panel`; :meth:`score` defaults to the
    single-column case.  :meth:`score_select` is the fused score->select
    stage — the base implementation is the host path (full panel + numpy
    top-k), which the numpy backends keep so everything stays anchored to
    the reference oracle; device backends override it to select on device
    and return only (pool,)-sized candidate arrays to the host.
    """

    name: str = "?"
    #: True when the backend finishes diverse plans with on-device MMR
    #: inside its fused chain — diverse plans then return the FINAL k, not
    #: the oversample pool (see :class:`_DeviceMMRMixin`)
    device_mmr: bool = False

    def score(
        self,
        matrix: np.ndarray,
        days_ago: Optional[np.ndarray],
        plan: M.ModulationPlan,
    ) -> np.ndarray:
        return self.score_panel(matrix, days_ago, [plan])[:, 0]

    def score_panel(
        self,
        matrix: np.ndarray,
        days_ago: Optional[np.ndarray],
        plans: Sequence[M.ModulationPlan],
    ) -> np.ndarray:
        raise NotImplementedError

    def score_select(
        self,
        matrix: np.ndarray,
        days_ago: Optional[np.ndarray],
        plans: Sequence[M.ModulationPlan],
        ks: Sequence[int],
        *,
        mask: Optional[np.ndarray] = None,
        fused_mmr: Optional[bool] = None,
        score_bias: Optional[np.ndarray] = None,
        cohort: bool = False,
    ) -> List[Candidates]:
        """Fused score->select: per-plan ``(indices, scores)`` of the top
        ``selection_width(plan, k, N)`` candidates, descending by score.

        ``cohort=True`` marks a multi-query cohort call (several admitted
        queries folded into one panel).  The reference's compiled device
        backends bucket their batch axis on it; nothing here compiles per
        batch size, so the flag is accepted (one signature everywhere)
        and ignored.

        ``score_bias`` is an optional additive score panel — (N,) shared
        by every plan or (N, B) per-plan — added to the modulated scores
        ON DEVICE before masking and selection (the hybrid lexical leg:
        sparse ``(1-w) * minmax(bm25)`` values, zero elsewhere).  Diverse
        plans run MMR over the BIASED relevance, so fusion happens before
        selection on every path.

        ``ks[j]`` is the final candidate count requested for plan ``j``;
        diverse plans return the oversampled MMR pool (the caller finishes
        with :func:`finalize_candidates`) — UNLESS the backend fuses MMR
        on device (``self.device_mmr``; see :class:`_DeviceMMRMixin`), in
        which case diverse plans come back as the final k, MMR-ordered,
        with relevance scores.  ``fused_mmr`` overrides per call: None
        defers to ``self.device_mmr``, False forces the host-pool
        contract (the equivalence suites and benches use it to compare
        both paths on one backend); the host-path backends ignore it.

        ``mask`` is an optional bool array, True = live — either (N,)
        shared by every plan, or an (N, B) panel giving each plan its OWN
        eligible rows (the heterogeneous-filter batch path).  Masked rows
        score -inf BEFORE selection (tombstoned segment rows never reach a
        candidate list with a real score — device backends apply the mask
        on device).  When fewer than ``w`` rows are eligible, the -inf
        entries trail the result; :func:`score_select_segments` filters
        them.
        """
        panel = self.score_panel(matrix, days_ago, plans)
        n = panel.shape[0]
        out: List[Candidates] = []
        for j, (plan, k) in enumerate(zip(plans, ks)):
            w = selection_width(plan, k, n)
            if w == 0:
                out.append(_empty_candidates())
                continue
            col = panel[:, j]
            if score_bias is not None:
                b = score_bias[:, j] if score_bias.ndim == 2 else score_bias
                col = col + b  # new array: the panel is never mutated
            if mask is not None:
                m = mask[:, j] if mask.ndim == 2 else mask
                col = np.where(m, col, -np.inf)
            idx = top_idx(col, w)
            out.append((idx, col[idx].astype(np.float32, copy=False)))
        return out

    def __repr__(self) -> str:  # pragma: no cover
        return f"<ExecutionBackend {self.name}>"


class ReferenceNumpyBackend(ExecutionBackend):
    """Paper-faithful: one matvec per direction, exactly Table 1."""

    name = "reference-numpy"

    def score(self, matrix, days_ago, plan):
        return np.asarray(M.modulate_scores(matrix, days_ago, plan))

    def score_panel(self, matrix, days_ago, plans):
        cols = [self.score(matrix, days_ago, p) for p in plans]
        return np.stack(cols, axis=1)


class FusedNumpyBackend(ExecutionBackend):
    """Folded two-matvec formulation: the corpus matrix streams once.

    scores[:, j] = decay_j * (M @ q_pre[:, j]) + M @ q_sup[:, j]
    with per-request decay half-lives applied column-wise.
    """

    name = "fused-numpy"

    def score(self, matrix, days_ago, plan):
        return np.asarray(M.fused_modulate_scores(matrix, days_ago, plan))

    def score_panel(self, matrix, days_ago, plans):
        for p in plans:
            _require_days(p, days_ago)
        q_pre, q_sup = M.fold_plans(plans)
        out = matrix @ q_pre                            # ONE pass (N, B)
        # decay touches only its own columns (strided but rare); the sup
        # add stays one contiguous vectorized op over the whole panel —
        # a per-column `out[:, j] = col + sup[:, j]` loop costs ~40% of
        # the matmuls again in strided traffic at panel widths
        for j, plan in enumerate(plans):
            if plan.decay is not None:
                out[:, j] *= _decay_column(days_ago, plan.decay.half_life_days)
        out += matrix @ q_sup
        return out


class HopperBackend(_DeviceMMRMixin, _DeviceMatrixMixin, ExecutionBackend):
    """The Hopper kernels (``repro_torch.kernels.pem_score`` + ``topk`` +
    ``mmr``): the port of the reference's ``PallasBackend``.

    ``device="cuda"`` (the default) launches the CUDA kernels and raises on
    a machine without a card; ``device="cpu"`` runs the same chain through
    the kernels' plain versions.  The scoring kernel takes one decay
    column per launch, so requests group by half-life and each group
    scores in one launch, writing its rows of a (B, N) panel that the
    top-k kernel reads in place; the ``mmr`` kernel then selects over
    every diverse plan's device-resident pool in one launch.  No host hop
    anywhere in the chain: only final candidates come back.
    """

    name = "hopper"

    def __init__(self, device: str = "cuda") -> None:
        import torch

        dev = torch.device(device)
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"HopperBackend: no kernels for device {dev}")
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "HopperBackend: no CUDA device; pass device='cpu' to "
                    "run the kernels' plain versions")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev

    def _grouped_panel(self, matrix, days_ago, plans):
        """Device-resident (B, N) score panel, rows in plan order."""
        import torch

        from repro_torch.kernels.pem_score.ops import pem_score

        q_pre, q_sup = M.fold_plans(plans)
        mat = self._device_matrix(matrix)
        groups: Dict[Optional[float], List[int]] = {}
        for j, plan in enumerate(plans):
            hl = plan.decay.half_life_days if plan.decay is not None else None
            groups.setdefault(hl, []).append(j)

        panel = torch.empty((len(plans), matrix.shape[0]),
                            dtype=torch.float32, device=self.device)
        order: List[int] = []
        for hl, cols in groups.items():
            decay = None
            if hl is not None:
                decay = _to_device(
                    np.asarray(_decay_column(days_ago, hl), np.float32),
                    self.device)
            rows = panel[len(order):len(order) + len(cols)]
            # the transposed view takes the (N, B) scores the kernel
            # computes straight into the (B, N) rows top-k reads
            pem_score(mat,
                      _to_device(np.asarray(q_pre[:, cols], np.float32),
                                 self.device),
                      _to_device(np.asarray(q_sup[:, cols], np.float32),
                                 self.device),
                      decay, out=rows.T)
            order.extend(cols)
        if order != list(range(len(plans))):
            panel = panel[_to_device(np.argsort(np.asarray(order)),
                                     self.device)]
        return panel

    def score_panel(self, matrix, days_ago, plans):
        for p in plans:
            _require_days(p, days_ago)
        panel = self._grouped_panel(matrix, days_ago, plans)
        return np.ascontiguousarray(panel.T.cpu().numpy())

    def score_select(self, matrix, days_ago, plans, ks, *, mask=None,
                     fused_mmr=None, score_bias=None, cohort=False):
        # the kernels take exact shapes (nothing compiled per batch size),
        # so the cohort flag has nothing to bucket here
        import torch

        from repro_torch.kernels.topk.ops import topk

        for p in plans:
            _require_days(p, days_ago)
        n = matrix.shape[0]
        if n == 0:
            return [_empty_candidates() for _ in plans]
        widths = [selection_width(p, k, n) for p, k in zip(plans, ks)]
        # the reference's pow2 width bucket, clamped to the real row count
        w_stat = min(PlanStructure.of(plans, widths, n).width, n)
        panel = self._grouped_panel(matrix, days_ago, plans)
        if score_bias is not None:
            # hybrid lexical leg: additive fusion on the device-resident
            # panel, before mask/top-k
            b = _to_device(np.asarray(score_bias, np.float32), self.device)
            panel = panel + (b.T if b.ndim == 2 else b[None, :])
        if mask is not None:
            # tombstones (or each plan's candidate-panel column) drop out
            # on device, before the top-k kernel
            m = _to_device(np.asarray(mask, bool), self.device)
            panel = torch.where(m.T if m.ndim == 2 else m[None, :], panel,
                                float("-inf"))
        v, i = topk(panel, w_stat)
        if not self._use_mmr(plans, fused_mmr):
            return _slice_candidates(i.cpu().numpy(), v.cpu().numpy(),
                                     widths)
        # fused diverse tail: ONE mmr launch over every diverse plan's
        # device-resident pool (per-plan lambdas; a plan's slots past its
        # true pool width carry NEG) — only the final k come back
        from repro_torch.kernels.mmr.ops import mmr_select

        pool_w = _pool_widths(widths, mask, n, len(plans))
        kf = [min(max(k, 0), int(pw)) for k, pw in zip(ks, pool_w)]
        div = [j for j, p in enumerate(plans)
               if p.diverse is not None and kf[j] > 0]
        picks = None
        if div:
            rows = _to_device(np.asarray(div, np.int64), self.device)
            width = int(pool_w[div].max())
            pool_i = i.index_select(0, rows)[:, :width].long()
            pool_v = v.index_select(0, rows)[:, :width]
            live = (torch.arange(width, device=self.device)[None, :]
                    < _to_device(pool_w[div].astype(np.int64),
                                 self.device)[:, None])
            emb = self._device_matrix(matrix).index_select(
                0, pool_i.reshape(-1)).view(len(div), width, -1)
            lams = _to_device(np.asarray(
                [plans[j].diverse.lam for j in div], np.float32), self.device)
            sel, _ = mmr_select(emb, torch.where(live, pool_v, _MMR_NEG),
                                max(kf[j] for j in div), lams)
            sel = sel.long()
            picks = (torch.gather(pool_i, 1, sel).cpu().numpy(),
                     torch.gather(pool_v, 1, sel).cpu().numpy())
        out = _slice_candidates(i.cpu().numpy(), v.cpu().numpy(), widths)
        for j, p in enumerate(plans):
            if p.diverse is not None and kf[j] == 0:
                out[j] = _empty_candidates()
        for row, j in enumerate(div):
            out[j] = (picks[0][row, :kf[j]].astype(np.int64),
                      picks[1][row, :kf[j]])
        return out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ExecutionBackend] = {}
_ALIASES = {
    # the seed's public engine strings keep working
    "reference": "reference-numpy",
    "fused": "fused-numpy",
}


def register_backend(backend: ExecutionBackend) -> ExecutionBackend:
    _REGISTRY[backend.name] = backend
    return backend


register_backend(ReferenceNumpyBackend())
register_backend(FusedNumpyBackend())


def list_backends() -> List[str]:
    """Canonical names of every registered backend."""
    return sorted(_REGISTRY)


def get_backend(engine: Union[str, ExecutionBackend]) -> ExecutionBackend:
    """Resolve an engine name (or pass an ExecutionBackend through)."""
    if isinstance(engine, ExecutionBackend):
        return engine
    name = _ALIASES.get(engine, engine)
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown engine {engine!r}; known: {list_backends()} "
            f"(aliases: {sorted(_ALIASES)})"
        ) from None


# ---------------------------------------------------------------------------
# Shared selection (identical ranking on batched and direct paths)
# ---------------------------------------------------------------------------


def top_idx(scores: np.ndarray, k: int) -> np.ndarray:
    """Indices of the top-k scores, sorted descending (argpartition+sort).

    Ties break toward the SMALLEST index — the same rule as
    ``jax.lax.top_k`` and the stable merges built on top of this, so the
    numpy and device backends agree bit-for-bit on tied scores and a
    cross-shard merge keyed on global row order reproduces the
    monolithic ranking exactly.  ``argpartition`` alone picks an
    arbitrary member set when ties straddle the k boundary, so the
    boundary value's members are re-resolved by index explicitly (two
    extra O(n) scans, negligible next to the scoring matmul).
    """
    if k >= scores.shape[0]:
        return np.argsort(-scores, kind="stable")
    part = np.argpartition(-scores, k)[:k]
    vstar = scores[part].min()  # the k-th largest value
    strictly = np.flatnonzero(scores > vstar)
    ties = np.flatnonzero(scores == vstar)
    members = np.concatenate([strictly, ties[: k - strictly.size]])
    return members[np.argsort(-scores[members], kind="stable")]


def selection_width(plan: M.ModulationPlan, k: int, n: int) -> int:
    """Candidates a backend must return for (plan, k) over n rows.

    Plain plans need exactly k; diverse plans need the MMR oversample pool
    ``oversample * max(k, plan.pool)`` so a small-k request (batched path)
    and a pool-sized request (direct path) draw from the same pool — MMR's
    greedy selection is prefix-consistent, so their rankings agree.
    """
    k = max(0, min(k, n))
    if k == 0:
        return 0
    if plan.diverse is not None:
        return min(plan.diverse.oversample * max(k, plan.pool), n)
    return k


def finalize_candidates(
    matrix: np.ndarray,
    idx: np.ndarray,
    scores: np.ndarray,
    k: int,
    plan: M.ModulationPlan,
) -> Candidates:
    """Host finishing stage over backend-returned candidates.

    Truncates a plain top-k pool to k, or runs MMR over the oversampled
    pool for diverse plans.  Produces exactly what
    :func:`select_candidates` yields on the full score array (same
    indices, same order), but only ever touches (pool,)-sized inputs.
    """
    k = max(0, min(k, idx.shape[0]))
    if k == 0:
        return idx[:0], scores[:0]
    if plan.diverse is not None:
        sel = mmr_host(matrix[idx], scores, k, plan.diverse.lam)
        return idx[sel], scores[sel]
    return idx[:k], scores[:k]


def score_select_segments(
    backend: Union[str, "ExecutionBackend"],
    segments: Sequence,
    plans: Sequence[M.ModulationPlan],
    ks: Sequence[int],
    *,
    now: Optional[float] = None,
    candidate_masks: Optional[Sequence[Optional[np.ndarray]]] = None,
    device_mmr: Optional[bool] = None,
    counters: Optional[FusedCounters] = None,
    score_bias: Optional[Sequence[Optional[np.ndarray]]] = None,
    cohort: bool = False,
) -> List[Candidates]:
    """Fused score->select over a SEGMENTED corpus (core.segments).

    This is the DEVICE PASS of the segmented pipeline — the stage that
    touches device memory (per-segment scoring + on-device selection).
    Its host counterpart is :func:`finalize_segment_candidates` (gather +
    truncate/MMR + id resolution), which needs only the immutable segment
    snapshot — never the store lock or the device — so a serving core can
    overlap the host tail of batch *i* with the device pass of batch
    *i+1* (the async engine in :mod:`repro_torch.serve.engine` does exactly
    that).

    Each segment scores independently through ``backend.score_select``
    (its tombstones masked to -inf on device before selection), then the
    per-segment top-k candidates merge on the host — the same two-stage
    union-merge shape ``dist/pem_sharded.union_merge_topk`` applies across
    device shards, applied across segments: every segment's local top-w
    provably contains its share of the global top-w, so the merge is
    exact.  Returns per-plan ``(global_rows, scores)`` where global rows
    offset into the concatenation of ALL segment rows (tombstoned rows
    included, so offsets are stable under deletes); resolve them with
    ``segments.gather_rows`` / ``segments.gather_ids``.

    Tie-breaking matches the monolithic path bit-for-bit: within a
    segment both ``top_idx`` and ``jax.lax.top_k`` prefer the smallest
    row, and the merge's stable sort keeps segment-major order, which IS
    global row order.

    ``ks[j]`` is the final candidate count for plan ``j``; diverse plans
    come back as the oversampled MMR pool (callers finish with
    :func:`finalize_candidates` over gathered candidate embeddings),
    exactly like the monolithic ``score_select`` — UNLESS the backend
    fuses MMR on device (``backend.device_mmr`` and ``device_mmr`` is not
    forced False), in which case EVERY diverse plan is device-finalized:
    the fast path fuses MMR into the scoring chain, and the per-segment
    path runs :meth:`_DeviceMMRMixin.mmr_pool_segments_batch` over the merged
    pool (gathered from the warm resident segment matrices, never the
    host).  Callers can then finish with ``mmr_done=backend.device_mmr``.

    ``candidate_masks`` is the Phase-1 filtered-retrieval hook: per-segment
    bool masks (``SegmentedCorpusStore.candidate_masks``; None = segment
    holds no candidate, skipped entirely) — or per-segment (n, B) PANELS
    (``SegmentedCorpusStore.candidate_mask_panel``) giving each plan its
    own candidate column for heterogeneous-filter batches.  Each mask
    composes with the segment's tombstones — candidates ∧ live score,
    everything else hits -inf ON DEVICE before selection — so a
    pre-filtered query scores the same warm device-resident segment
    matrices as an unfiltered one: zero per-query gather, zero per-query
    upload, plan-cache row buckets unchanged.  Selection widths shrink to
    each plan's eligible-row count, and the union merge is bit-identical
    to host-gathering the candidate rows (in global-row order) and
    scoring them monolithically.

    ``score_bias`` is the hybrid-fusion hook: per-segment additive score
    arrays aligned with ``segments`` (None = zero bias; (n,) shared or
    (n, B) per-plan — ``SegmentedCorpusStore.score_bias_arrays`` /
    :func:`fusion_bias_arrays` build them), added on device before
    masking and selection.  A candidate-mask skip stays a skip: the
    Phase-1 filter is hard, bias only re-ranks eligible rows.
    """
    from repro_torch.core.segments import segment_offsets

    backend = get_backend(backend)
    if candidate_masks is not None and len(candidate_masks) != len(segments):
        raise ValueError("candidate_masks misaligned with segments")
    if score_bias is not None and len(score_bias) != len(segments):
        raise ValueError("score_bias misaligned with segments")
    nplans = len(plans)
    # per-segment eligible mask: candidates ∧ live (None = every row);
    # per-PLAN eligible counts — a (n, B) panel gives every plan its own
    # column, so counts (and selection widths) differ per plan
    scored: List[Tuple[int, object, Optional[np.ndarray], np.ndarray]] = []
    elig = np.zeros(nplans, dtype=np.int64)
    for i, s in enumerate(segments):
        if not s.n_rows or not s.live_count:
            continue
        if candidate_masks is not None:
            cm = candidate_masks[i]
            if cm is None:
                continue
            if cm.ndim == 2:
                m = (cm & s.live_mask[:, None]) if s.n_dead else cm
                c = np.count_nonzero(m, axis=0).astype(np.int64)
                if not c.any():
                    continue
                if int(c.min()) == s.n_rows:
                    m = None  # every plan sees every row: unmasked shape
            else:
                m = (cm & s.live_mask) if s.n_dead else cm
                c1 = int(np.count_nonzero(m))
                if c1 == 0:
                    continue
                if c1 == s.n_rows:
                    m = None  # every row eligible: the unmasked fast shape
                c = np.full(nplans, c1, dtype=np.int64)
        else:
            m = s.live_mask if s.n_dead else None
            c = np.full(nplans, s.live_count, dtype=np.int64)
        scored.append((i, s, m, c))
        elig += c
    if not scored or not nplans:
        return [_empty_candidates() for _ in plans]
    if now is None:
        now = time.time()
    offsets = segment_offsets(segments)
    use_mmr = (backend.device_mmr and device_mmr is not False
               and any(p.diverse is not None for p in plans))

    # fast path: one segment with every row eligible IS the monolithic
    # corpus — same call, same candidates, zero segmentation overhead
    # (device-MMR backends finish diverse plans inside the fused chain)
    if len(scored) == 1 and scored[0][2] is None:
        i, seg, _, c = scored[0]
        n_el = int(c[0])
        out = backend.score_select(
            seg.matrix, seg.days_ago(now), plans,
            [min(k, n_el) for k in ks], fused_mmr=device_mmr,
            score_bias=None if score_bias is None else score_bias[i],
            cohort=cohort)
        if use_mmr and counters is not None:
            counters.device_mmr += sum(
                1 for p, k in zip(plans, ks)
                if p.diverse is not None and min(k, n_el) > 0)
        if offsets[i]:
            out = [(idx + offsets[i], vals) for idx, vals in out]
        return out

    # per-plan GLOBAL selection widths over each plan's ELIGIBLE rows
    # (diverse oversampling applies once, at corpus level; per-segment
    # requests are plain top-w)
    ks_eff = [min(k, int(e)) for k, e in zip(ks, elig)]
    widths = [selection_width(p, ke, int(e))
              for p, ke, e in zip(plans, ks_eff, elig)]
    seg_plans = [dataclasses.replace(p, diverse=None)
                 if p.diverse is not None else p for p in plans]

    parts: List[List[Candidates]] = []
    for i, seg, m, _ in scored:
        sel = backend.score_select(
            seg.matrix, seg.days_ago(now), seg_plans, widths, mask=m,
            score_bias=None if score_bias is None else score_bias[i],
            cohort=cohort)
        parts.append([(idx + offsets[i], vals) for idx, vals in sel])

    merged: List[Candidates] = []
    for j, w in enumerate(widths):
        if w == 0:
            merged.append(_empty_candidates())
            continue
        cat_i = np.concatenate([p[j][0] for p in parts])
        cat_v = np.concatenate([p[j][1] for p in parts])
        live = ~np.isneginf(cat_v)  # mask/padding leakage ends here
        cat_i, cat_v = cat_i[live], cat_v[live]
        order = np.argsort(-cat_v, kind="stable")[:w]
        merged.append((cat_i[order], cat_v[order]))

    if use_mmr:
        # merged-pool fused diverse tail: the union-merged pool equals
        # the monolithic oversample pool, so device MMR over it (pool
        # embeddings gathered from the warm resident segment matrices)
        # is exact — diverse plans leave here final-k, never as a pool.
        # The whole diverse cohort pads into ONE batched device call
        # (mmr_pool_segments_batch) instead of one sync per plan.
        div = [j for j, p in enumerate(plans)
               if p.diverse is not None and merged[j][0].size]
        if div:
            sels = backend.mmr_pool_segments_batch(
                segments, [merged[j] for j in div],
                [min(ks_eff[j], int(merged[j][0].size)) for j in div],
                [plans[j].diverse.lam for j in div])
            for j, sel in zip(div, sels):
                gidx, gv = merged[j]
                merged[j] = (gidx[sel], gv[sel])
            if counters is not None:
                counters.device_mmr += 1
    return merged


def score_select_cohort(
    backend: Union[str, "ExecutionBackend"],
    segments: Sequence,
    plans: Sequence[M.ModulationPlan],
    ks: Sequence[int],
    *,
    now: Optional[float] = None,
    candidate_masks: Optional[Sequence[Optional[np.ndarray]]] = None,
    device_mmr: Optional[bool] = None,
    counters: Optional[FusedCounters] = None,
    score_bias: Optional[Sequence[Optional[np.ndarray]]] = None,
) -> List[Candidates]:
    """Cohort-panel score->select: one device pass for a MULTI-QUERY batch.

    ``plans`` here is a cohort — one plan per admitted query, folded into
    one fused ``(d, 2·Q)`` query panel so each segment matrix streams
    through device memory once per cohort instead of once per query.
    Execution is :func:`score_select_segments` with ``cohort=True``.
    Rankings equal Q serial single-plan calls on the same snapshot:
    cohort mode reorders loops, not the per-row arithmetic.
    """
    return score_select_segments(
        backend, segments, plans, ks, now=now,
        candidate_masks=candidate_masks, device_mmr=device_mmr,
        counters=counters, score_bias=score_bias, cohort=True)


@dataclasses.dataclass
class PrefilterRouter:
    """Selectivity-aware router for Phase-1 filtered retrieval.

    Two ways to score a pre-filtered sub-corpus, with opposite cost
    shapes (Bruch, *Foundations of Vector Retrieval* §filtered search):

    * **masked-device** — score the warm device-resident segment matrices
      with non-candidates masked to -inf before selection.  Cost is
      O(corpus) but every byte is already on device: zero gather, zero
      upload, plan-cache hits preserved.  Wins when the filter is weak
      (candidates are a large fraction of the corpus).
    * **gather-host** — resolve the candidate rows through the id index
      (O(candidates)), gather them into a scratch matrix and score that.
      Pays a host gather + device upload + (first time) a trace per row
      bucket EVERY query, but touches only candidate rows.  Wins when the
      filter is sharp (a few hundred rows out of a million).

    The router picks per query on REQUESTED selectivity — unique
    candidate count over live rows — against the crossover threshold.
    ``mask_threshold`` seeds it statically (the measured crossover lives
    in ``BENCH_pem.json``'s ``prefilter_backends`` scenario); with
    ``adaptive`` on, the router then LEARNS the crossover from its own
    recorded timing samples: masked cost is bandwidth-bound in live rows
    (≈ ``a·n_live``), gather cost is linear in candidates
    (≈ ``b·n_candidates``), so masked wins once ``a·n_live ≤
    b·n_candidates`` — i.e. at selectivity ≥ ``a/b``.  Until BOTH arms
    have ``min_samples`` recorded passes the static seed stays in force,
    and the learned value is clamped to [0.01, 0.9] so one degenerate
    timing sample can't pin the router to a single arm.  Counters are
    benign int/float bumps (same convention as the store's) surfaced
    through ``RetrievalService.stats()["prefilter"]``.
    """

    mask_threshold: float = 0.2  # static seed: selectivity where masked wins
    adaptive: bool = True        # learn the crossover from timing samples
    min_samples: int = 5         # per-arm passes before the learned value arms
    routed_masked: int = 0       # queries served by the masked-device path
    routed_gather: int = 0       # queries served by the gather-host path
    routed_panel: int = 0        # queries served by a batched (N, B) panel
    mask_build_ms: float = 0.0   # cumulative candidate-mask build time
    masked_ms: float = 0.0       # cumulative masked-arm scoring time
    masked_rows: int = 0         # cumulative live rows swept by masked passes
    masked_samples: int = 0
    gather_ms: float = 0.0       # cumulative gather-arm scoring time
    gather_rows: int = 0         # cumulative candidate rows gathered+scored
    gather_samples: int = 0
    # routed_* count QUERIES: a batched scoring call serving n folded
    # identical filters bumps by n (score_select_prefiltered's weight=),
    # and a panel pass serving a B-request cohort bumps routed_panel by B

    def record_masked(self, ms: float, n_live: int) -> None:
        if ms >= 0.0 and n_live > 0:
            self.masked_ms += ms
            self.masked_rows += n_live
            self.masked_samples += 1

    def record_gather(self, ms: float, n_candidates: int) -> None:
        if ms >= 0.0 and n_candidates > 0:
            self.gather_ms += ms
            self.gather_rows += n_candidates
            self.gather_samples += 1

    def effective_threshold(self) -> float:
        if (not self.adaptive
                or self.masked_samples < self.min_samples
                or self.gather_samples < self.min_samples
                or not self.masked_rows or not self.gather_rows
                or self.gather_ms <= 0.0):
            return self.mask_threshold
        a = self.masked_ms / self.masked_rows    # ms per live row swept
        b = self.gather_ms / self.gather_rows    # ms per candidate gathered
        return min(max(a / b, 0.01), 0.9)

    def use_masked(self, n_candidates: int, n_live: int) -> bool:
        return (n_live > 0
                and n_candidates >= self.effective_threshold() * n_live)

    def use_panel(
        self,
        candidate_counts: Sequence[Optional[int]],
        n_live: int,
    ) -> bool:
        """The batched-panel arm: serve a heterogeneous-filter cohort with
        ONE (N, B) mask-panel pass when at least two of its distinct
        filter groups would each cost a full-corpus device pass anyway —
        an unfiltered group (``None``) or a filter the masked arm would
        take.  One batched matmul then replaces those passes outright.
        Below that, per-group dispatch stays (sharp filters keep the
        cheap O(candidates) gather path)."""
        if len(candidate_counts) < 2:
            return False
        full = sum(1 for c in candidate_counts
                   if c is None or self.use_masked(int(c), n_live))
        return full >= 2

    def stats(self) -> Dict[str, Union[int, float]]:
        return {
            "threshold": self.mask_threshold,
            "threshold_effective": round(self.effective_threshold(), 4),
            "routed_masked": self.routed_masked,
            "routed_gather": self.routed_gather,
            "routed_panel": self.routed_panel,
            "mask_build_ms": round(self.mask_build_ms, 3),
            "masked_samples": self.masked_samples,
            "gather_samples": self.gather_samples,
        }


def score_select_prefiltered(
    backend: Union[str, "ExecutionBackend"],
    store,
    segments: Sequence,
    plans: Sequence[M.ModulationPlan],
    ks: Sequence[int],
    candidate_ids: Sequence[int],
    *,
    now: Optional[float] = None,
    router: Optional[PrefilterRouter] = None,
    weight: int = 1,
    device_mmr: Optional[bool] = None,
    counters: Optional[FusedCounters] = None,
    score_bias: Optional[Sequence[Optional[np.ndarray]]] = None,
) -> List[Candidates]:
    """Device pass for a Phase-1 FILTERED micro-batch (one candidate set
    shared by every plan in the call).  ``weight`` is how many QUERIES
    this call serves (the batched engine folds identical filters into one
    call), so the router's counters stay per-query on every path.

    Routes through ``router`` (masked-device vs gather-host, see
    :class:`PrefilterRouter`) and returns per-plan ``(global_rows,
    scores)`` — the same contract as :func:`score_select_segments`, so
    :func:`finalize_segment_candidates` finishes both filtered and
    unfiltered batches identically.  Callers needing a consistent pass
    hold ``store.lock`` across snapshot + this call, exactly like the
    unfiltered pass.

    Non-strict on both routes: candidate ids deleted between the Phase-1
    SQL and this pass (or never known) are silently dropped —
    ``candidate_masks`` never sets their bit, ``locate_rows`` skips them.
    Duplicates collapse (``np.unique``), and ties break by global row on
    both routes, so the two are bit-identical.
    """
    from repro_torch.core.segments import gather_days, gather_rows

    backend = get_backend(backend)
    # avoid python-int boxing for array inputs (the engine already hands
    # over the canonical unique-sorted array from Request admission; the
    # sortedness check below then skips the redundant O(c log c) sort)
    cand = (candidate_ids if isinstance(candidate_ids, np.ndarray)
            else np.asarray(list(candidate_ids), dtype=np.int64))
    cand = cand.astype(np.int64, copy=False).ravel()
    if cand.size > 1 and not np.all(cand[1:] > cand[:-1]):
        cand = np.unique(cand)
    n_live = sum(s.live_count for s in segments)
    if cand.size == 0 or n_live == 0:
        return [_empty_candidates() for _ in plans]
    if router is None:
        router = PrefilterRouter()
    if now is None:
        now = time.time()

    if router.use_masked(int(cand.size), n_live):
        t0 = time.perf_counter()
        masks, matched = store.candidate_masks(cand, segments)
        router.mask_build_ms += (time.perf_counter() - t0) * 1e3
        router.routed_masked += weight
        if matched == 0:
            return [_empty_candidates() for _ in plans]
        t0 = time.perf_counter()
        out = score_select_segments(
            backend, segments, plans, ks, now=now, candidate_masks=masks,
            device_mmr=device_mmr, counters=counters,
            score_bias=score_bias)
        # adaptive crossover: the masked arm's cost scales with the live
        # rows it sweeps, regardless of how few candidates survive
        router.record_masked((time.perf_counter() - t0) * 1e3, n_live)
        return out

    router.routed_gather += weight
    rows = store.locate_rows(cand, segments)
    if rows.size == 0:
        return [_empty_candidates() for _ in plans]
    t0 = time.perf_counter()
    sub = gather_rows(segments, rows)
    days = gather_days(segments, rows, now)
    ks_eff = [min(k, int(rows.size)) for k in ks]
    sub_bias = (None if score_bias is None
                else _gather_bias(score_bias, segments, rows))
    sel = backend.score_select(sub, days, plans, ks_eff,
                               fused_mmr=device_mmr, score_bias=sub_bias)
    # the gather arm pays resolve+gather+upload+score per candidate row
    router.record_gather((time.perf_counter() - t0) * 1e3, int(rows.size))
    if (counters is not None and backend.device_mmr
            and device_mmr is not False):
        counters.device_mmr += sum(
            1 for p, k in zip(plans, ks_eff)
            if p.diverse is not None and k > 0)
    return [(rows[idx], vals) for idx, vals in sel]


def score_select_filter_panel(
    backend: Union[str, "ExecutionBackend"],
    store,
    segments: Sequence,
    plans: Sequence[M.ModulationPlan],
    ks: Sequence[int],
    candidate_sets: Sequence[Optional[Sequence[int]]],
    *,
    now: Optional[float] = None,
    router: Optional[PrefilterRouter] = None,
    counters: Optional[FusedCounters] = None,
    device_mmr: Optional[bool] = None,
    score_bias: Optional[Sequence[Optional[np.ndarray]]] = None,
) -> List[Candidates]:
    """Device pass for a HETEROGENEOUS-filter micro-batch: one plan per
    request, each with its OWN Phase-1 candidate set (None = unfiltered).

    Instead of one scoring pass per distinct filter, builds a per-plan
    (N, B) candidate-mask panel (``SegmentedCorpusStore.
    candidate_mask_panel`` — an unfiltered request rides along as the
    all-live column, so a mixed cohort never splits) and runs ONE batched
    :func:`score_select_segments` pass over the warm segment matrices:
    one matmul + masked selection for the whole cohort.  Returns the same
    per-plan ``(global_rows, scores)`` contract as every other pass,
    and each plan's ranking is bit-identical to dispatching its filter
    through :func:`score_select_prefiltered` on its own.  The batched
    engine consults :meth:`PrefilterRouter.use_panel` first —
    sharp-filter-only cohorts stay on per-group gather dispatch.
    """
    backend = get_backend(backend)
    if now is None:
        now = time.time()
    t0 = time.perf_counter()
    panels, matched = store.candidate_mask_panel(candidate_sets, segments)
    if router is not None:
        router.mask_build_ms += (time.perf_counter() - t0) * 1e3
        router.routed_panel += len(plans)
    if counters is not None:
        counters.panel_batches += 1
    if all(p is None for p in panels):
        return [_empty_candidates() for _ in plans]
    return score_select_segments(
        backend, segments, plans, ks, now=now, candidate_masks=panels,
        device_mmr=device_mmr, counters=counters, score_bias=score_bias)


def _gather_bias(
    bias_arrays: Sequence[Optional[np.ndarray]],
    segments: Sequence,
    rows: np.ndarray,
) -> np.ndarray:
    """Per-segment bias arrays -> bias values at GLOBAL rows (the gather
    route's counterpart of ``gather_rows``: the sub-matrix is scored with
    the matching sub-bias)."""
    from repro_torch.core.segments import segment_offsets

    off = segment_offsets(segments)
    seg_idx = np.searchsorted(off, rows, side="right") - 1
    local = rows - off[seg_idx]
    width = next((a.shape[1] for a in bias_arrays
                  if a is not None and a.ndim == 2), None)
    out = (np.zeros(rows.size, np.float32) if width is None
           else np.zeros((rows.size, width), np.float32))
    for s in np.unique(seg_idx):
        arr = bias_arrays[s]
        if arr is None:
            continue
        take = seg_idx == s
        vals = arr[local[take]]
        if width is not None and vals.ndim == 1:
            vals = np.repeat(vals[:, None], width, axis=1)
        out[take] = vals
    return out


def plan_fusion_bias(
    plan: M.ModulationPlan,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """One plan's sparse lexical score contribution: ``(chunk_ids,
    (1-w) * minmax(bm25))`` — or None when nothing rides on device
    (no fusion, RRF mode, empty lexical hits, or w == 1.0: the guard
    that keeps ``fuse:weighted,1.0`` bit-identical to the unfused path).
    ``fuse:filter,W`` plans with W < 1 fuse the same way — the hit set
    is already the Phase-1 candidate set, the bias just re-ranks within
    it.
    """
    f = plan.fusion
    if (f is None or f.mode not in ("weighted", "filter")
            or plan.lexical is None
            or plan.lexical.ids.size == 0 or f.weight == 1.0):
        return None
    vals = ((1.0 - f.weight)
            * np.asarray(plan.lexical.scores, np.float32))
    return plan.lexical.ids, vals.astype(np.float32, copy=False)


def fusion_bias_arrays(
    store,
    segments: Sequence,
    plans: Sequence[M.ModulationPlan],
) -> Optional[List[Optional[np.ndarray]]]:
    """Per-segment additive score arrays for a micro-batch's lexical legs
    — the ``score_bias`` input of every segmented pass.  None when no
    plan contributes a device-fused bias; otherwise one entry per
    segment: (n,) for a single-plan call, (n, B) zero-filled panels when
    several plans fuse different keyword queries in one batch.
    """
    per_plan = [plan_fusion_bias(p) for p in plans]
    if all(b is None for b in per_plan):
        return None
    if len(plans) == 1:
        ids, vals = per_plan[0]
        arrays, _ = store.score_bias_arrays(ids, vals, segments)
        return arrays
    out: List[Optional[np.ndarray]] = [None] * len(segments)
    for j, b in enumerate(per_plan):
        if b is None:
            continue
        cols, _ = store.score_bias_arrays(b[0], b[1], segments)
        for i, col in enumerate(cols):
            if col is None:
                continue
            if out[i] is None:
                out[i] = np.zeros((segments[i].n_rows, len(plans)),
                                  np.float32)
            out[i][:, j] = col
    return out


def finalize_fusion(
    plan: M.ModulationPlan,
    results: List[Tuple[int, float]],
    k: int,
    *,
    store=None,
    candidate_ids: Optional[Sequence[int]] = None,
) -> List[Tuple[int, float]]:
    """Host finishing stage for RANK fusion (``fuse:rrf,K``) — a no-op
    for every other plan.  RRF is not linear in scores, so it cannot ride
    the device bias: the device pass runs pure-vector, and this fuses its
    ranked list with the lexical list via ``modulations.rrf_fuse``.

    The lexical ids are clipped to the Phase-1 candidate set (the filter
    stays hard under fusion) and to live store membership (ids deleted
    since the FTS query — or FTS rows the vector store never held — are
    dropped, matching the non-strict prefilter contract).
    """
    f = plan.fusion
    if f is None or f.mode != "rrf" or plan.lexical is None:
        return results
    lex = np.asarray(plan.lexical.ids, np.int64)
    if candidate_ids is not None:
        cand = (candidate_ids if isinstance(candidate_ids, np.ndarray)
                else np.asarray(list(candidate_ids), dtype=np.int64))
        lex = lex[np.isin(lex, cand)]
    if store is not None:
        lex = np.asarray([i for i in lex if int(i) in store], np.int64)
    fused = M.rrf_fuse([i for i, _ in results], [int(i) for i in lex],
                       f.rrf_k)
    return [(int(i), float(s)) for i, s in fused[:max(0, k)]]


def finalize_segment_candidates(
    segments: Sequence,
    plans: Sequence[M.ModulationPlan],
    ks: Sequence[int],
    selected: Sequence[Candidates],
    *,
    mmr_done: bool = False,
    counters: Optional[FusedCounters] = None,
) -> List[List[Tuple[int, float]]]:
    """HOST TAIL of the segmented pipeline — the separable counterpart of
    :func:`score_select_segments` (the device pass).

    Takes the per-plan ``(global_rows, scores)`` candidates the device
    pass produced and finishes them on the host: truncate plain top-k,
    or — for diverse plans — gather the (pool,)-sized candidate
    embeddings and run the :func:`mmr_host` oracle over the oversampled
    pool, then resolve global rows to chunk ids.  Returns per-plan
    ``[(chunk_id, score), ...]`` descending — the shape every serving
    surface hands back.

    ``mmr_done=True`` declares that the device pass already finished
    diversity on device (``backend.device_mmr`` paths): diverse plans
    then truncate exactly like plain ones, and NO pool embedding gather
    happens at all — the pool never crossed the device boundary, and
    ``counters.host_pool_transfers`` stays untouched.

    Reads ONLY the immutable segment arrays of the snapshot it is given
    (sealed ids/matrix never change; compaction swaps the store's list
    but old segments stay valid), so it is safe to run WITHOUT the store
    lock, concurrently with the next batch's device pass — that overlap
    is the async engine's pipeline win.  Every consumer (direct
    ``VectorCache.search_plan``, the batched engine) calls this one
    function, so batched and direct rankings stay bit-identical.
    """
    from repro_torch.core.segments import gather_ids, gather_rows

    out: List[List[Tuple[int, float]]] = []
    for plan, k, (gidx, vals) in zip(plans, ks, selected):
        if gidx.size == 0:
            out.append([])
            continue
        if plan.diverse is not None and not mmr_done:
            # host-oracle finishing: gather the oversample pool and run
            # mmr_host — the transfer the fused device paths avoid
            pool_emb = gather_rows(segments, gidx)
            loc, final_vals = finalize_candidates(
                pool_emb, np.arange(gidx.size, dtype=np.int64), vals, k,
                plan)
            if counters is not None:
                counters.host_pool_transfers += 1
            chunk_ids = gather_ids(segments, gidx[loc])
        else:
            # plain top-k — or a diverse plan the device already
            # finished — truncates; no pool embedding gather at all
            kf = max(0, min(k, int(gidx.size)))
            chunk_ids = gather_ids(segments, gidx[:kf])
            final_vals = vals[:kf]
        out.append([(int(i), float(v))
                    for i, v in zip(chunk_ids, final_vals)])
    return out


def select_candidates(
    matrix: np.ndarray,
    scores: np.ndarray,
    k: int,
    plan: M.ModulationPlan,
) -> np.ndarray:
    """Top-k (or MMR-diverse) row selection over a FULL host score array.

    The host-path reference for :meth:`ExecutionBackend.score_select` +
    :func:`finalize_candidates`; kept as the oracle the fused paths are
    pinned against.
    """
    n = scores.shape[0]
    k = min(k, n)
    if k <= 0:
        return np.empty(0, dtype=np.int64)
    if plan.diverse is not None:
        over = selection_width(plan, k, n)
        pool_idx = top_idx(scores, over)
        sel = mmr_host(matrix[pool_idx], scores[pool_idx], k,
                       plan.diverse.lam)
        return pool_idx[sel]
    return top_idx(scores, k)