"""Filtered retrieval through the selectivity router: the port against the
reference, on the CPU.

The same seeded corpus, segmentations, tombstones and Phase-1 candidate
sets go through ``repro`` and ``repro_torch`` (``tests/torch_harness.py``
pairs their backends: ``PallasBackend`` in interpret mode with
``HopperBackend("cpu")``, ``JitJaxBackend`` with ``TorchBackend("cpu")``,
the reference's ``ShardedBackend`` with the port's on three CPU shards,
and fused-numpy in both).  Ids must be equal in order, ties included,
scores within 1e-5, and the router's counters equal where the reference
pins them: both arms (masked-device, gather-host) over every segmentation
x tombstone overlap, the ``>=`` boundary, candidates deleted between the
phases, the masked arm's zero uploads on a warm store, a cohort of
different filters in one (N, B) panel pass through the batched engine,
``vec_ops`` with a SQL prefilter through the service and its engine, and
the adaptive threshold learned from the arms' timing samples.
"""

import asyncio
import concurrent.futures as cf

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_harness import (ENGINES, NOW, PACKAGES, R, T, corpus,  # noqa: E402
                           database, engine, gate_backend, make_cache,
                           same_ranking, same_rows, store_from_splits,
                           wait_for)

MASKED = dict(mask_threshold=0.0)   # router kwargs forcing each arm
GATHER = dict(mask_threshold=2.0)
ARMS = {"masked": MASKED, "gather": GATHER}

SEGMENTATIONS = {
    "one-segment": ([230], ()),
    "three-segments": ([100, 60, 70], tuple(range(40, 80)) + (150, 229)),
    "ragged": ([5, 120, 25, 60, 20], tuple(range(0, 230, 7))),
}
# overlapping the tombstones, with duplicates and ids the store never saw
CANDIDATES = tuple(range(0, 230, 2)) + (41, 41, 151, 9999, 10_000)


def _plan(P, *, diverse=True, decay=True):
    emb = P.Hash(32)
    q = P.M.l2_normalize(emb("how the retrieval system works"))
    a = P.M.l2_normalize(emb("prototype sketch"))
    b = P.M.l2_normalize(emb("production deployment"))
    x1 = P.M.l2_normalize(emb("website landing page"))
    return P.M.ModulationPlan(
        query=q, trajectory=P.M.TrajectorySpec(direction=b - a),
        decay=P.M.DecaySpec(half_life_days=14.0) if decay else None,
        suppress=(P.M.SuppressSpec(direction=x1),),
        diverse=P.M.DiverseSpec() if diverse else None, pool=25)


def _vc(P, store, **router):
    return P.V.VectorCache(store=store, embed_fn=P.Hash(32),
                           prefilter=P.B.PrefilterRouter(**router))


@pytest.mark.parametrize("key", ENGINES)
@pytest.mark.parametrize("seg", SEGMENTATIONS)
@pytest.mark.parametrize("arm", ARMS)
def test_filtered_search_matches_reference(key, seg, arm):
    """Each router arm, plain and diverse, over every segmentation with
    tombstones under the candidate set."""
    splits, deleted = SEGMENTATIONS[seg]
    mat, ts = corpus()
    for diverse in (False, True):
        out = {}
        for P in PACKAGES:
            vc = _vc(P, store_from_splits(P, mat, ts, splits, deleted),
                     **ARMS[arm])
            out[P.name] = vc.search_plan(_plan(P, diverse=diverse),
                                         CANDIDATES, now=NOW,
                                         engine=engine(P, key))
            routed = (vc.prefilter.routed_masked, vc.prefilter.routed_gather)
            assert routed == ((1, 0) if arm == "masked" else (0, 1))
        assert out["repro_torch"]
        same_ranking(out["repro_torch"], out["repro"])


@pytest.mark.parametrize("key", ENGINES)
def test_filtered_store_without_timestamps_matches_reference(key):
    mat, _ = corpus(seed=11)
    cands = tuple(range(1, 230, 3))
    for kwargs in (MASKED, GATHER):
        out = {}
        for P in PACKAGES:
            store = P.S.SegmentedCorpusStore(dim=32)
            store.append(np.arange(100), mat[:100], None, normalized=True)
            store.append(np.arange(100, 230), mat[100:], None,
                         normalized=True)
            out[P.name] = _vc(P, store, **kwargs).search_plan(
                _plan(P, diverse=False, decay=False), cands, now=NOW,
                engine=engine(P, key))
        same_ranking(out["repro_torch"], out["repro"])


def _boundary_walk(P, threshold):
    """The reference's boundary sequence; the router's counters after each
    step (and whether the mask build time moved)."""
    mat, ts = corpus(n=200, seed=5)
    router = P.B.PrefilterRouter(mask_threshold=threshold)
    vc = P.V.VectorCache(store=store_from_splits(P, mat, ts, [200]),
                         embed_fn=P.Hash(32), prefilter=router)
    plan = _plan(P, diverse=False)
    steps = []
    n = int(np.ceil(threshold * 200))
    for cands in (list(range(n)), list(range(n - 1)),
                  list(range(n - 1)) * 3, None):
        built = router.mask_build_ms
        vc.search_plan(plan, cands, now=NOW, engine="fused-numpy")
        steps.append((router.routed_masked, router.routed_gather,
                      router.mask_build_ms > built))
    return steps


@pytest.mark.parametrize("threshold", [0.3, 0.2, 0.55])
def test_router_boundary_matches_reference(threshold):
    """``>=`` on unique candidates over live rows: at the threshold the
    masked arm, one below it the gather arm, duplicates collapse, and an
    unfiltered query never asks the router."""
    want = _boundary_walk(R, threshold)
    assert want == [(1, 0, True), (1, 1, False), (1, 2, False),
                    (1, 2, False)]
    assert _boundary_walk(T, threshold) == want


@pytest.mark.parametrize("key", ENGINES)
@pytest.mark.parametrize("arm", ARMS)
def test_candidates_deleted_between_phases_match_reference(key, arm):
    """Ids tombstoned between the Phase-1 SQL and the scoring pass drop on
    both arms; an all-dead candidate set yields []."""
    mat, ts = corpus(seed=19)
    candidates = list(range(0, 230, 2))
    out = {}
    for P in PACKAGES:
        vc = _vc(P, store_from_splits(P, mat, ts, [120, 110]), **ARMS[arm])
        be = engine(P, key)
        vc.delete(candidates[:30])
        got = vc.search_plan(_plan(P), candidates, now=NOW, engine=be)
        vc.delete(candidates)
        out[P.name] = (got, vc.search_plan(_plan(P), candidates, now=NOW,
                                           engine=be))
    assert out["repro_torch"][0]
    assert not set(candidates[:30]) & {i for i, _ in out["repro_torch"][0]}
    same_ranking(out["repro_torch"][0], out["repro"][0])
    assert out["repro_torch"][1] == out["repro"][1] == []


@pytest.mark.parametrize("key", ["hopper", "torch"])
def test_masked_arm_uploads_nothing_on_a_warm_store(key):
    """Filtered queries on the masked arm score the resident segment
    matrices: no upload, no live view; the gather arm uploads its scratch
    matrix every query.  The port's upload counts equal the reference's."""
    mat, ts = corpus(n=300, seed=23)
    out = {}
    for P in PACKAGES:
        be = engine(P, key)
        vc = _vc(P, store_from_splits(P, mat, ts, [200, 100]), **MASKED)
        plan = _plan(P, diverse=False)
        for _ in range(2):
            vc.search_plan(plan, now=NOW, engine=be)
        warm = be.uploads
        cache = getattr(be, "plan_cache", None)  # TorchBackend, JitJax
        builds = cache and cache.builds
        got = [vc.search_plan(plan, list(range(lo, 300, 2)), now=NOW,
                              engine=be) for lo in (0, 10, 20)]
        masked = be.uploads - warm
        no_build = (cache and cache.builds) == builds
        vc.prefilter = P.B.PrefilterRouter(**GATHER)
        for _ in range(2):
            got.append(vc.search_plan(plan, list(range(0, 300, 2)), now=NOW,
                                      engine=be))
        out[P.name] = (warm, masked, be.uploads - warm - masked, no_build,
                       vc._view is None, got)
    r, t = out["repro"], out["repro_torch"]
    assert t[:5] == r[:5] == (2, 0, 2, True, True)
    for g, w in zip(t[5], r[5]):
        same_ranking(g, w)


@pytest.mark.parametrize("key", ["fused", "hopper"])
def test_engine_serves_a_cohort_of_filters_in_one_panel_pass(key):
    """Five requests with different filters (two sets, a third, none)
    collected into one batch behind a parked request: one (N, B) panel
    pass, the router's panel counter +5, and every ranking equal to the
    reference's and to the port's direct path."""

    def run(P):
        emb = P.Hash(64)
        texts = [f"item group {i % 5} tail {i}" for i in range(150)]
        vc = P.V.VectorCache(np.arange(150), emb.embed_batch(texts),
                             np.linspace(0, 89 * 86400, 150), emb)
        gate = gate_backend(P, key)
        eng = P.E.BatchedRetrievalEngine(vc, max_batch=8, max_wait_ms=1.0,
                                         now=NOW, engine=gate)
        cand_a, cand_b = list(range(0, 150, 2)), list(range(0, 150, 3))
        specs = [("similar:group 1 tail", cand_a),
                 ("similar:group 2 tail", cand_a),
                 ("similar:group 1 tail", cand_b),
                 ("similar:group 3 tail", None),
                 ("similar:group 4 tail", None)]
        try:
            with cf.ThreadPoolExecutor(7) as ex:
                dummy = ex.submit(eng.search, "similar:group 0 tail", 3)
                assert gate.entered.wait(timeout=10.0)
                futs = [ex.submit(eng.search, q, 5, 20.0, candidate_ids=c)
                        for q, c in specs]
                assert wait_for(lambda: eng.queue_depth == len(specs))
                before = (vc.prefilter.routed_panel,
                          vc.prefilter.routed_masked
                          + vc.prefilter.routed_gather,
                          vc.fused.panel_batches)
                gate.release.set()
                dummy.result(20.0)
                results = [f.result(20.0) for f in futs]
            seen = (eng.batches_served,
                    vc.prefilter.routed_panel - before[0],
                    vc.prefilter.routed_masked + vc.prefilter.routed_gather
                    - before[1], vc.fused.panel_batches - before[2],
                    gate.calls)
            direct = [vc.search(q, c, now=NOW, engine="fused-numpy")[:5]
                      for q, c in specs]
        finally:
            eng.close()
        return seen, results, direct

    r_seen, r_res, _ = run(R)
    t_seen, t_res, t_direct = run(T)
    assert t_seen == r_seen == (2, 5, 0, 1, 2)
    for got, want, direct in zip(t_res, r_res, t_direct):
        same_ranking(got, want)
        assert [i for i, _ in got] == [i for i, _ in direct]


def test_asearch_threads_candidate_ids_like_the_reference():
    out = {}
    for P in PACKAGES:
        emb = P.Hash(64)
        texts = [f"doc topic {i % 7} body {i}" for i in range(90)]
        vc = P.V.VectorCache(np.arange(90), emb.embed_batch(texts),
                             np.linspace(0, 89 * 86400, 90), emb)
        eng = P.E.BatchedRetrievalEngine(vc, max_batch=4, now=NOW,
                                         engine="fused-numpy")
        try:
            out[P.name] = asyncio.run(eng.asearch(
                "similar:doc topic 3 body", 6,
                candidate_ids=list(range(0, 90, 2))))
        finally:
            eng.close()
    assert all(i % 2 == 0 for i, _ in out["repro_torch"])
    same_ranking(out["repro_torch"], out["repro"])


VEC_OPS_FILTERED = (
    "SELECT v.id, v.score FROM vec_ops("
    "'similar:server lifecycle pool:20',"
    "'SELECT id FROM chunks WHERE type = ''assistant''') v "
    "ORDER BY v.score DESC LIMIT 5")


@pytest.mark.parametrize("key", ["fused", "hopper", "torch"])
def test_vec_ops_prefilter_through_service_and_engine(key):
    """``vec_ops`` with a SQL prefilter: the same rows direct and through
    the serving engine, in both packages, with one parse per query and
    the router's counters in the service's stats."""
    out = {}
    for P in PACKAGES:
        conn, emb = database(P, 200, 10, 9, 64)
        svc = P.R.RetrievalService(conn, dim=64, embedder=emb,
                                   now=1_770_000_000.0,
                                   engine=engine(P, key))
        try:
            direct = svc.flex_search(VEC_OPS_FILTERED)
            assert direct.ok, direct.error
            svc.serving(max_batch=8)
            calls = []
            inner = svc.cache.embed_fn
            svc.cache.embed_fn = lambda text: calls.append(text) or inner(
                text)
            batched = svc.flex_search(VEC_OPS_FILTERED)
            svc.cache.embed_fn = inner
            assert batched.ok, batched.error
            st = svc.stats()
            out[P.name] = (direct.rows, batched.rows, len(calls),
                           {k: st["prefilter"][k] for k in (
                               "routed_masked", "routed_gather",
                               "routed_panel")},
                           st["serving"]["requests_served"])
        finally:
            svc.close()
    r, t = out["repro"], out["repro_torch"]
    same_rows(t[0], r[0])
    same_rows(t[1], t[0], tol=0.0)
    assert t[2:] == r[2:]
    assert t[2] == 1 and sum(t[3].values()) >= 2 and t[4] >= 1


def test_structural_tail_on_a_filter_matches_reference():
    mat, ts = corpus(seed=29)
    out = {}
    for P in PACKAGES:
        vc = P.V.VectorCache(store=store_from_splits(
            P, mat, ts, [100, 130], deleted=(3, 104)), embed_fn=P.Hash(32))
        out[P.name] = vc.search_full(
            "similar:how the retrieval system works cluster:3 central "
            "pool:12", list(range(0, 230, 2)), now=NOW,
            engine=engine(P, "hopper" if P is T else "torch"))
        assert vc._view is None
    (r_cols, r_rows), (t_cols, t_rows) = out["repro"], out["repro_torch"]
    assert t_cols == r_cols == ["id", "score", "cluster", "central"]
    assert t_rows and all(int(row[0]) % 2 == 0 for row in t_rows)
    same_rows(t_rows, r_rows)


@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("cands", [[], [777, 888]], ids=["empty", "unknown"])
def test_prefiltered_pass_on_empty_and_unknown_sets(arm, cands):
    mat, ts = corpus(n=50, seed=31)
    out = {}
    for P in PACKAGES:
        store = store_from_splits(P, mat, ts, [50])
        router = P.B.PrefilterRouter(**ARMS[arm])
        res = P.B.score_select_prefiltered(
            "fused-numpy", store, store.segments, [_plan(P, diverse=False)],
            [10], cands, now=NOW, router=router)
        out[P.name] = ([o[0].size for o in res], router.routed_masked,
                       router.routed_gather, router.masked_samples,
                       router.gather_samples)
    assert out["repro_torch"] == out["repro"]
    assert out["repro_torch"][0] == [0]


# -- the adaptive threshold ----------------------------------------------------

# (router kwargs, [(arm, ms, rows), ...] in order)
SAMPLES = {
    "warming": (dict(mask_threshold=0.25, min_samples=3),
                [("m", 10.0, 100_000)] * 3 + [("g", 1.0, 1_000)] * 3),
    "one-arm-cold": (dict(mask_threshold=0.25, min_samples=3),
                     [("m", 10.0, 100_000)] * 3 + [("g", 1.0, 1_000)] * 2),
    "clamp-high": (dict(min_samples=1),
                   [("m", 100.0, 100), ("g", 0.001, 10_000)]),
    "clamp-low": (dict(min_samples=1),
                  [("m", 0.0001, 1_000_000), ("g", 100.0, 10)]),
    "opt-out": (dict(adaptive=False, min_samples=1),
                [("m", 100.0, 100), ("g", 0.001, 10_000)]),
    "degenerate": (dict(min_samples=1), [("m", 1.0, 0), ("g", -1.0, 100)]),
}


@pytest.mark.parametrize("case", SAMPLES)
def test_adaptive_threshold_matches_reference(case):
    """The same timing samples give the same learned crossover, the same
    routing at and beside it, and the same stats."""
    kwargs, samples = SAMPLES[case]
    out = {}
    for P in PACKAGES:
        r = P.B.PrefilterRouter(**kwargs)
        for arm, ms, rows in samples:
            (r.record_masked if arm == "m" else r.record_gather)(ms, rows)
        th = r.effective_threshold()
        out[P.name] = (th, r.stats(), r.masked_samples, r.gather_samples,
                       [r.use_masked(c, 100_000) for c in (
                           int(th * 100_000) - 1, int(np.ceil(th * 100_000)),
                           100_000, 0)])
    assert out["repro_torch"] == out["repro"]


def test_prefiltered_passes_record_timing_samples_like_the_reference():
    """Both arms feed the model from the real pass: the masked arm its
    live rows swept, the gather arm its candidates; an empty pass records
    nothing."""
    mat, ts = corpus(n=200, seed=9)
    out = {}
    for P in PACKAGES:
        store = store_from_splits(P, mat, ts, [200])
        router = P.B.PrefilterRouter(mask_threshold=0.3)
        vc = P.V.VectorCache(store=store, embed_fn=P.Hash(32),
                             prefilter=router)
        plan = _plan(P, diverse=False)
        seen = []
        for cands in (list(range(100)), list(range(10)), [777_777]):
            if cands == [777_777]:
                P.B.score_select_prefiltered(
                    "fused-numpy", store, store.segments, [plan], [10],
                    cands, now=NOW, router=router)
            else:
                vc.search_plan(plan, cands, now=NOW, engine="fused-numpy")
            seen.append((router.masked_samples, router.masked_rows,
                         router.masked_ms > 0.0, router.gather_samples,
                         router.gather_rows, router.gather_ms > 0.0))
        out[P.name] = seen
    assert out["repro_torch"] == out["repro"]
    assert out["repro_torch"][-1] == (1, 200, True, 1, 10, True)


def test_router_learns_a_crossover_from_its_passes():
    """Enough passes of each arm on a warm store arm the learned value in
    both packages, inside the [0.01, 0.9] clamp."""
    mat, ts = corpus(n=230, seed=41)
    for P in PACKAGES:
        router = P.B.PrefilterRouter(min_samples=3)
        vc = P.V.VectorCache(store=store_from_splits(P, mat, ts, [120, 110]),
                             embed_fn=P.Hash(32), prefilter=router)
        plan = _plan(P)
        for cands in ([list(range(0, 230, 2))] * 3
                      + [list(range(0, 230, 23))] * 3):
            vc.search_plan(plan, cands, now=NOW, engine=engine(P, "hopper"))
        assert router.masked_samples == router.gather_samples == 3
        assert 0.01 <= router.effective_threshold() <= 0.9
        assert router.stats()["threshold"] == 0.2

