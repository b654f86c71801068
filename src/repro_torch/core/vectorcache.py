"""VectorCache — the production Phase-2 engine (paper §3.4.1).

Holds the corpus embeddings in memory (the paper's core requirement) —
now as a :class:`~repro_torch.core.segments.SegmentedCorpusStore` rather than
one monolithic array, so a live corpus (append / tombstone / compact)
never forces a full re-upload or re-trace: a monolithic corpus is just a
one-segment store, and the legacy ``VectorCache(ids, matrix, ts)``
constructor still builds exactly that.

Execution is dispatched through the :mod:`repro_torch.core.backends` registry
via the fused ``score_select`` stage — full-corpus searches route through
:func:`~repro_torch.core.backends.score_select_segments` (per-segment scoring
with on-device tombstone masking + exact union merge), so only
(pool,)-sized candidate lists ever come back from the backend.  Phase-1
pre-filtered searches route through
:func:`~repro_torch.core.backends.score_select_prefiltered`: a selectivity-aware
:class:`~repro_torch.core.backends.PrefilterRouter` picks masked-device scoring
(candidates ∧ live masked to -inf over the SAME warm segment matrices —
zero per-query gather/upload) or host-gathering the candidate rows when
the filter is sharp, bit-identical either way.
``engine`` accepts any registered backend name (``reference-numpy``,
``fused-numpy``; the seed's ``"reference"``/``"fused"`` aliases keep
working) or an :class:`~repro_torch.core.backends.ExecutionBackend`
instance such as :class:`~repro_torch.core.backends.HopperBackend`.  All
backends are algebraically identical (held against each other and against
the reference package in tests/test_torch_backends.py).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch import spans
from repro_torch.core import grammar
from repro_torch.core import modulations as M
from repro_torch.core.backends import (ExecutionBackend, PrefilterRouter,
                                 finalize_fusion,
                                 finalize_segment_candidates, fusion_bias_arrays,
                                 get_backend,
                                 FusedCounters, score_select_prefiltered,
                                 score_select_segments)
from repro_torch.core.segments import SegmentedCorpusStore

Engine = Union[str, ExecutionBackend]


class VectorCache:
    """Segmented in-memory corpus + token-grammar search (paper VectorCache).

    ``ids``/``matrix``/``timestamps`` remain available as properties — the
    LIVE view (tombstoned rows dropped), rebuilt lazily when the store
    version changes and zero-copy for a fully-live single segment — so
    every monolithic consumer (benchmarks, structural operators, Phase-1
    pre-filter sub-corpus scoring) keeps working unchanged.
    """

    def __init__(
        self,
        ids: Sequence[int] = (),
        matrix: Optional[np.ndarray] = None,
        timestamps: Optional[Sequence[float]] = None,
        embed_fn: Optional[grammar.EmbedFn] = None,
        *,
        normalized: bool = False,
        store: Optional[SegmentedCorpusStore] = None,
        prefilter: Optional[PrefilterRouter] = None,
        lexical_fn: Optional[grammar.LexicalFn] = None,
    ) -> None:
        if store is not None:
            if matrix is not None or len(ids):
                raise ValueError("pass either (ids, matrix) or store=, not both")
            self.store = store
        else:
            if matrix is None:
                raise ValueError("VectorCache requires a matrix or a store")
            matrix = np.asarray(matrix, dtype=np.float32)
            if matrix.ndim != 2 or matrix.shape[0] != len(ids):
                raise ValueError(
                    f"matrix shape {matrix.shape} inconsistent with "
                    f"{len(ids)} ids"
                )
            self.store = SegmentedCorpusStore(dim=matrix.shape[1])
            self.store.append(ids, matrix, timestamps, normalized=normalized)
        self.embed_fn = embed_fn
        # keyword: resolver for hybrid fusion — (text, pool) -> (ids,
        # minmax bm25 scores).  RetrievalService wires an FTS5-backed one;
        # None makes keyword: queries raise an explicit GrammarError.
        self.lexical_fn = lexical_fn
        # Phase-1 filtered retrieval: the selectivity-aware router (shared
        # with the batched engine, so direct and batched filtered queries
        # route — and count — identically)
        self.prefilter = prefilter or PrefilterRouter()
        # fused-Phase-2 counters (device MMR vs host pool transfers, panel
        # batches) — shared with the batched engine for the same reason
        self.fused = FusedCounters()
        self._view: Optional[Tuple] = None
        self._view_version = -1

    @property
    def dim(self) -> int:
        return self.store.dim

    # -- live view (monolithic compatibility surface) ------------------------

    def _live_view(self):
        store = self.store
        with store.lock:
            if self._view is not None and self._view_version == store.version:
                return self._view
            segs = [s for s in store.segments if s.live_count]
            if not segs:
                view = (np.zeros(0, np.int64),
                        np.zeros((0, store.dim), np.float32),
                        None, {})
            elif len(segs) == 1 and segs[0].n_dead == 0:
                seg = segs[0]  # zero-copy: the segment IS the view
                view = (seg.ids, seg.matrix, seg.timestamps,
                        {int(i): r for r, i in enumerate(seg.ids)})
            else:
                live = [s.live_mask for s in segs]
                ids = np.concatenate([s.ids[m] for s, m in zip(segs, live)])
                mat = np.concatenate(
                    [s.matrix[m] for s, m in zip(segs, live)])
                ts = None
                if segs[0].timestamps is not None:
                    ts = np.concatenate(
                        [s.timestamps[m] for s, m in zip(segs, live)])
                view = (ids, mat, ts,
                        {int(i): r for r, i in enumerate(ids)})
            self._view = view
            self._view_version = store.version
            return view

    @property
    def ids(self) -> np.ndarray:
        return self._live_view()[0]

    @property
    def matrix(self) -> np.ndarray:
        return self._live_view()[1]

    @property
    def timestamps(self) -> Optional[np.ndarray]:
        return self._live_view()[2]

    @property
    def _row_of_id(self) -> Dict[int, int]:
        return self._live_view()[3]

    # -- ingest / delete (the live-corpus entry points) ----------------------

    def ingest(
        self,
        ids: Sequence[int],
        matrix: np.ndarray,
        timestamps: Optional[Sequence[float]] = None,
        *,
        normalized: bool = False,
    ):
        """Append a batch as one new sealed segment (warm segments keep
        their device residency and compiled plans). Returns the segment."""
        return self.store.append(ids, matrix, timestamps,
                                 normalized=normalized)

    def delete(self, ids: Sequence[int], *, strict: bool = False) -> int:
        """Tombstone chunks; only the touched segments' masks change."""
        return self.store.delete(ids, strict=strict)

    def compact(self, min_live_fraction: float = 1.0) -> int:
        """Merge sparse segments (see SegmentedCorpusStore.compact)."""
        return self.store.compact(min_live_fraction)

    # -- id <-> row helpers --------------------------------------------------

    def rows_for_ids(
        self, chunk_ids: Sequence[int], *, strict: bool = False
    ) -> np.ndarray:
        """Live-view rows for ``chunk_ids``; unknown ids are dropped, or —
        with ``strict=True`` — raise a KeyError naming the missing ids."""
        row_of_id = self._row_of_id
        rows: List[int] = []
        missing: List[int] = []
        for i in chunk_ids:
            row = row_of_id.get(int(i))
            if row is None:
                missing.append(int(i))
            else:
                rows.append(row)
        if missing and strict:
            raise KeyError(
                f"ids not in the cache: {missing[:10]}"
                + (f" (+{len(missing) - 10} more)" if len(missing) > 10
                   else "")
            )
        return np.asarray(rows, dtype=np.int64)

    def embeddings_for_ids(self, chunk_ids: Sequence[int]) -> np.ndarray:
        # straight off the store's id index under its lock — no live-view
        # materialization (the view concatenates EVERY live row just to
        # gather a handful), and no torn view/version reads while the
        # engine's idle-gap compaction rebuilds segments
        rows, missing = self.store.gather_embeddings(chunk_ids)
        if rows.shape[0] == 0:
            requested = [int(i) for i in chunk_ids]
            raise grammar.GrammarError(
                f"centroid: none of the {len(requested)} requested ids "
                f"exist in the cache (missing: {requested[:10]}"
                + (f" +{len(requested) - 10} more)" if len(requested) > 10
                   else ")")
            )
        return rows

    # -- the search entry point ----------------------------------------------

    def search(
        self,
        tokens: str,
        candidate_ids: Optional[Sequence[int]] = None,
        *,
        now: Optional[float] = None,
        engine: Engine = "reference",
        embed_fn: Optional[grammar.EmbedFn] = None,
        lexical_fn: Optional[grammar.LexicalFn] = None,
    ) -> List[Tuple[int, float]]:
        """Run Phase 2: parse tokens, score candidates, select top-pool.

        ``candidate_ids`` is the Phase-1 pre-filter output (None = full
        corpus, the paper's fallback for unstructured corpora). Returns
        ``[(chunk_id, score), ...]`` sorted by descending score — exactly the
        rows the materializer writes to the temp table.
        """
        embedder = embed_fn or self.embed_fn
        if embedder is None:
            raise ValueError("VectorCache.search requires an embed function")
        with spans.root("search"):
            with spans.span("parse"):
                plan = grammar.parse(tokens, embedder, self.embeddings_for_ids,
                                     lexical_fn or self.lexical_fn)
            return self.search_plan(plan, candidate_ids, now=now,
                                    engine=engine)

    def search_full(
        self,
        tokens: Optional[str] = None,
        candidate_ids: Optional[Sequence[int]] = None,
        *,
        now: Optional[float] = None,
        engine: Engine = "reference",
        base_search=None,
        lexical_fn: Optional[grammar.LexicalFn] = None,
        plan: Optional[M.ModulationPlan] = None,
    ):
        """Like :meth:`search` but also computes the §3.2 STRUCTURAL
        operators (`cluster:K`, `central`) over the selected candidates.
        Returns (column_names, rows) — the materializer's temp-table shape.

        ``base_search(plan, k)``, when given, produces the base ranking in
        place of :meth:`search_plan` — the materializer uses it to route
        queries through the async batched engine so SQL-surface traffic
        micro-batches and pipelines with everything else.  ``plan`` skips
        parsing entirely (the HYBRID_SEARCH / VECTOR_SEARCH pseudo-calls
        build their plans directly); ``lexical_fn`` overrides the cache's
        keyword resolver (the materializer injects its FTS5-backed one).
        """
        if plan is None:
            if tokens is None:
                raise ValueError("search_full requires tokens or a plan")
            if self.embed_fn is None:
                raise ValueError(
                    "VectorCache.search_full requires an embed function")
            with spans.span("parse"):
                plan = grammar.parse(tokens, self.embed_fn,
                                     self.embeddings_for_ids,
                                     lexical_fn or self.lexical_fn)
        if base_search is not None:
            base = base_search(plan, plan.pool)
        else:
            base = self.search_plan(plan, candidate_ids, now=now,
                                    engine=engine)
        # ONE column-assembly block shared by the early-return and
        # structural paths (they previously each built their own)
        cols = ["id", "score"]
        if plan.cluster is not None:
            cols.append("cluster")
        if plan.central:
            cols.append("central")
        if len(cols) == 2 or not base:
            return cols, base
        from repro_torch.core import structural

        # gather the <=pool selected rows straight off the store's id
        # index — materializing the full live-view matrix for this gather
        # cost O(corpus) per structural query; a racing delete between
        # scoring and this gather just drops the affected rows
        embeds, missing = self.store.gather_embeddings([i for i, _ in base])
        if missing:
            gone = set(missing)
            base = [r for r in base if int(r[0]) not in gone]
            if not base:
                return cols, base
        extra = []
        if plan.cluster is not None:
            extra.append(structural.kmeans_labels(embeds, plan.cluster))
        if plan.central:
            extra.append(structural.centrality(embeds))
        rows = [
            tuple(r) + tuple(float(e[i]) if e.dtype.kind == "f" else int(e[i])
                             for e in extra)
            for i, r in enumerate(base)
        ]
        return cols, rows

    def search_plan(
        self,
        plan: M.ModulationPlan,
        candidate_ids: Optional[Sequence[int]] = None,
        *,
        now: Optional[float] = None,
        engine: Engine = "reference",
    ) -> List[Tuple[int, float]]:
        backend = get_backend(engine)
        ref = time.time() if now is None else now

        # fuse:filter plans promote the lexical FTS hit set to the
        # Phase-1 candidate set (intersecting an existing SQL filter),
        # so the selectivity-aware prefilter router below applies to
        # the lexical leg exactly as to a SQL pre-filter
        candidate_ids = M.filter_candidate_ids(plan, candidate_ids)

        if candidate_ids is not None:
            # Phase-1 pre-filtered query: the selectivity-aware router
            # (self.prefilter) picks masked-device scoring of the warm
            # per-segment matrices vs gathering the candidate rows into a
            # scratch matrix — same device-pass/host-tail split as the
            # full-corpus path, same lock discipline.  Non-strict: ids
            # deleted between the Phase-1 SQL and this pass drop silently.
            with spans.span("device_pass"), self.store.lock:
                segs = self.store.segments
                n_live = self.store.n_live
                if (plan.decay is not None
                        and not self.store.has_timestamps):
                    raise ValueError("decay: requires timestamps in the cache")
                k = min(plan.pool, n_live)
                bias = fusion_bias_arrays(self.store, segs, [plan])
                selected = score_select_prefiltered(
                    backend, self.store, segs, [plan], [k], candidate_ids,
                    now=ref, router=self.prefilter, counters=self.fused,
                    score_bias=bias)
            with spans.span("host_tail"):
                (results,) = finalize_segment_candidates(
                    segs, [plan], [k], selected,
                    mmr_done=backend.device_mmr, counters=self.fused)
                return finalize_fusion(plan, results, k, store=self.store,
                                       candidate_ids=candidate_ids)

        # Full corpus: the two-stage segmented pipeline.  The DEVICE PASS
        # (score_select_segments) runs under the store lock so ingest /
        # delete land between searches, never inside one; the HOST TAIL
        # (finalize_segment_candidates: gather + MMR + id resolution)
        # needs only the immutable segment snapshot, so it runs outside
        # the lock — the same split the async engine pipelines.
        with spans.span("device_pass"), self.store.lock:
            segs = self.store.segments
            if plan.decay is not None and not self.store.has_timestamps:
                raise ValueError("decay: requires timestamps in the cache")
            n_live = self.store.n_live
            k = min(plan.pool, n_live)
            bias = fusion_bias_arrays(self.store, segs, [plan])
            selected = score_select_segments(
                backend, segs, [plan], [k], now=ref, counters=self.fused,
                score_bias=bias)
        with spans.span("host_tail"):
            (results,) = finalize_segment_candidates(
                segs, [plan], [k], selected, mmr_done=backend.device_mmr,
                counters=self.fused)
            return finalize_fusion(plan, results, k, store=self.store)
