"""``HopperBackend`` and ``TorchBackend`` against the reference package's
backends, on the CPU.

``HopperBackend("cpu")`` runs the port's whole score -> select -> MMR chain
through the kernels' plain versions; ``TorchBackend("cpu")`` runs it as
plain library calls, one function per plan structure, the counterpart of
the reference's ``JitJaxBackend``.  The same seeded numpy corpus and the
same token strings (each package parses them with its own, bit-identical
``HashEmbedder``) go through the reference's ``PallasBackend`` (interpret
mode), ``JitJaxBackend`` and ``fused-numpy``.  Candidate indices must be
equal and scores agree to 1e-5 (f32 products summed in another order), for
plain, decay, suppress, trajectory and diverse plans, with device MMR and
with the host-pool contract (``fused_mmr=False``), under (N,) and (N, B)
masks and score bias, over a segmented store with tombstones carried
across by ``store_from_arrays``, and in cohorts.  ``TorchBackend``'s
``PlanCache`` keeps the reference's contract: no rebuild across query
texts, one build per new suppress bucket, decay presence structural,
cohorts bucketed, and none for a masked query on a warm store.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import backends as RB  # noqa: E402
from repro.core import modulations as RM  # noqa: E402
from repro.core.grammar import parse as r_parse  # noqa: E402
from repro.core.segments import SegmentedCorpusStore  # noqa: E402
from repro.embed import HashEmbedder as RHash  # noqa: E402
from repro_torch.core import backends as TB  # noqa: E402
from repro_torch.core import modulations as TM  # noqa: E402
from repro_torch.core.grammar import parse as t_parse  # noqa: E402
from repro_torch.core.segments import store_from_arrays  # noqa: E402
from repro_torch.embed import HashEmbedder as THash  # noqa: E402

D = 32
NOW = 90 * 86400.0
TOKENS = [
    "similar:how the retrieval system works",
    "similar:how the retrieval system works decay:21",
    "similar:auth token flow suppress:website landing page",
    "similar:rendering pipeline from:prototype sketch to:production deployment",
    "similar:how the retrieval system works decay:7 diverse pool:20",
    "similar:database migration suppress:marketing copy diverse pool:15",
]
KS = [7, 10, 5, 9, 6, 8]
TOL = 1e-5
# each port backend and its reference counterpart
PORTS = {"hopper": (TB.HopperBackend, "pallas"),
         "torch": (TB.TorchBackend, "jit-jax")}


def _corpus(n=230, seed=7):
    rng = np.random.default_rng(seed)
    mat = rng.standard_normal((n, D)).astype(np.float32)
    mat /= np.linalg.norm(mat, axis=1, keepdims=True)
    days = rng.uniform(0.0, 60.0, n).astype(np.float32)
    return mat, days, rng


def _plans(lam0=False):
    """The same plans in both packages; ``lam0`` turns the last diverse
    plan's lambda to 0 (pure diversity)."""
    r = [r_parse(t, RHash(D)) for t in TOKENS]
    t = [t_parse(t, THash(D)) for t in TOKENS]
    if lam0:
        r[-1] = dataclasses.replace(r[-1], diverse=RM.DiverseSpec(lam=0.0))
        t[-1] = dataclasses.replace(t[-1], diverse=TM.DiverseSpec(lam=0.0))
    return r, t


def _assert_same(got, want):
    assert len(got) == len(want)
    for (gi, gv), (wi, wv) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))
        np.testing.assert_allclose(np.asarray(gv, np.float32),
                                   np.asarray(wv, np.float32), atol=TOL)


def _masks(rng, n, b):
    return {"none": None,
            "shared": rng.random(n) > 0.3,
            "panel": rng.random((n, b)) > 0.4}


def _bias(rng, n, b, kind):
    if kind is None:
        return None
    shape = (n,) if kind == "shared" else (n, b)
    bias = np.zeros(shape, np.float32)
    hit = rng.random(shape) > 0.9
    bias[hit] = rng.uniform(0.0, 0.5, int(hit.sum())).astype(np.float32)
    return bias


@pytest.mark.parametrize("mask_kind", ["none", "shared", "panel"])
@pytest.mark.parametrize("bias_kind", [None, "shared", "panel"])
@pytest.mark.parametrize("fused_mmr", [None, False])
@pytest.mark.parametrize("port", sorted(PORTS))
def test_score_select_matches_reference(mask_kind, bias_kind, fused_mmr,
                                        port):
    mat, days, rng = _corpus()
    r_plans, t_plans = _plans(lam0=fused_mmr is None)
    mask = _masks(rng, mat.shape[0], len(KS))[mask_kind]
    bias = _bias(rng, mat.shape[0], len(KS), bias_kind)
    kw = dict(mask=mask, fused_mmr=fused_mmr, score_bias=bias)
    got = PORTS[port][0]("cpu").score_select(mat, days, t_plans, KS, **kw)
    for name in ("pallas", "jit-jax"):
        want = RB.get_backend(name).score_select(mat, days, r_plans, KS, **kw)
        _assert_same(got, want)
    if fused_mmr is False:
        # the host-pool contract: the numpy oracle returns the same pools
        want = RB.get_backend("fused-numpy").score_select(
            mat, days, r_plans, KS, **kw)
        _assert_same(got, want)


def test_device_mmr_equals_the_host_oracle():
    """Diverse plans finished on the device equal the numpy pool finished
    by the host MMR oracle (``finalize_candidates``)."""
    mat, days, _ = _corpus(seed=3)
    r_plans, t_plans = _plans(lam0=True)
    got = TB.HopperBackend("cpu").score_select(mat, days, t_plans, KS)
    pools = RB.get_backend("fused-numpy").score_select(mat, days, r_plans, KS)
    for plan, k, (gi, gv), (pi, pv) in zip(r_plans, KS, got, pools):
        wi, wv = RB.finalize_candidates(mat, pi, pv, k, plan)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gv, wv, atol=TOL)


def test_score_panel_matches_fused_numpy():
    mat, days, _ = _corpus(seed=5)
    r_plans, t_plans = _plans()
    got = TB.HopperBackend("cpu").score_panel(mat, days, t_plans)
    want = RB.get_backend("fused-numpy").score_panel(mat, days, r_plans)
    np.testing.assert_allclose(got, want, atol=TOL)


def _reference_store(mat, days, splits, deleted):
    ts = NOW - days.astype(np.float64) * 86400.0
    store = SegmentedCorpusStore(dim=D)
    start = 0
    for size in splits:
        store.append(np.arange(start, start + size), mat[start:start + size],
                     ts[start:start + size], normalized=True)
        start += size
    store.delete(deleted)
    return store


def _export(segments):
    """A store's segments as plain numpy arrays — the only thing that
    crosses from the reference package to the port."""
    return [{"ids": np.array(s.ids), "matrix": np.array(s.matrix),
             "timestamps": np.array(s.timestamps),
             "live_mask": np.array(s.live_mask)} for s in segments]


def test_store_from_arrays_keeps_layout_and_tombstones():
    mat, days, rng = _corpus(n=300, seed=9)
    ref = _reference_store(mat, days, [120, 100, 80],
                           rng.choice(300, 40, replace=False))
    port = store_from_arrays(_export(ref.segments))
    assert port.n_segments == ref.n_segments and port.n_live == ref.n_live
    for a, b in zip(port.segments, ref.segments):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.matrix, b.matrix)
        np.testing.assert_array_equal(a.tombstones, b.tombstones)
        assert a.n_dead == b.n_dead
    with pytest.raises(ValueError):
        store_from_arrays([{**_export(ref.segments)[0],
                            "live_mask": np.ones(3, bool)}])


@pytest.mark.parametrize("device_mmr", [None, False])
@pytest.mark.parametrize("port", sorted(PORTS))
def test_segments_match_reference(device_mmr, port):
    mat, days, rng = _corpus(n=300, seed=11)
    ref = _reference_store(mat, days, [120, 100, 80],
                           rng.choice(300, 30, replace=False))
    store = store_from_arrays(_export(ref.segments))
    r_plans, t_plans = _plans(lam0=True)
    make, counterpart = PORTS[port]
    backend = make("cpu")
    got = TB.score_select_segments(backend, store.segments, t_plans, KS,
                                   now=NOW, device_mmr=device_mmr)
    want = RB.score_select_segments(counterpart, ref.segments, r_plans, KS,
                                    now=NOW, device_mmr=device_mmr)
    _assert_same(got, want)
    done = backend.device_mmr and device_mmr is not False
    final = TB.finalize_segment_candidates(store.segments, t_plans, KS, got,
                                           mmr_done=done)
    oracle = RB.finalize_segment_candidates(
        ref.segments, r_plans, KS,
        RB.score_select_segments("fused-numpy", ref.segments, r_plans, KS,
                                 now=NOW))
    for g, w in zip(final, oracle):
        assert [i for i, _ in g] == [i for i, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   atol=TOL)


@pytest.mark.parametrize("port", sorted(PORTS))
def test_merged_pool_mmr_is_one_launch_for_the_cohort(port, monkeypatch):
    """Diverse plans with different lambdas over a multi-segment store
    finish in ONE MMR call for the cohort, equal to the host oracle:
    ``HopperBackend`` calls K3 once inside its segment chain (no merged
    pool crosses to the host), ``TorchBackend`` makes one merged-pool
    call."""
    from repro_torch.kernels.mmr import ops as mmr_ops

    mat, days, rng = _corpus(n=300, seed=13)
    ref = _reference_store(mat, days, [150, 150],
                           rng.choice(300, 20, replace=False))
    store = store_from_arrays(_export(ref.segments))
    r_plans, t_plans = _plans(lam0=True)
    div = [4, 5]
    r_div = [r_plans[j] for j in div]
    t_div = [t_plans[j] for j in div]
    ks = [KS[j] for j in div]
    backend = PORTS[port][0]("cpu")
    calls, mmr_calls, k3_calls = [], [], []
    batch = backend.mmr_pool_segments_batch
    backend.mmr_pool_segments_batch = lambda *a: calls.append(1) or batch(*a)
    pool_mmr = backend._pool_mmr
    backend._pool_mmr = lambda *a: mmr_calls.append(1) or pool_mmr(*a)
    k3 = mmr_ops.mmr_select
    monkeypatch.setattr(mmr_ops, "mmr_select",
                        lambda *a: k3_calls.append(a[0].shape[0]) or k3(*a))
    got = TB.score_select_segments(backend, store.segments, t_div, ks,
                                   now=NOW)
    if port == "hopper":
        assert backend.segment_chain
        assert not calls and not mmr_calls
        assert k3_calls == [len(div)]   # one K3 call, both plans' pools
    else:
        assert len(calls) == 1 and len(mmr_calls) == 1
    want = RB.score_select_segments("jit-jax", ref.segments, r_div, ks,
                                    now=NOW)
    _assert_same(got, want)


MIXED_DECAY = {
    "interleaved": ["decay:7", "decay:21", "", "decay:30", "decay:7", "",
                    "decay:21", "decay:30"],
    "grouped": ["decay:7", "decay:7", "decay:21", "decay:21", "decay:30",
                "decay:30", "", ""],
    "reversed": ["", "decay:30", "decay:21", "decay:7"],
}


def _mixed_plans(order):
    topics = ["how the retrieval system works", "auth token flow",
              "rendering pipeline", "database migration"]
    toks = [f"similar:{topics[j % len(topics)]} {dec}".strip()
            for j, dec in enumerate(MIXED_DECAY[order])]
    return ([r_parse(t, RHash(D)) for t in toks],
            [t_parse(t, THash(D)) for t in toks])


@pytest.mark.parametrize("order", sorted(MIXED_DECAY))
def test_mixed_half_lives_score_in_one_launch_in_plan_order(order,
                                                            monkeypatch):
    """A batch mixing decay:7, decay:21, decay:30 and no decay: the panel
    equals the reference PallasBackend's (which groups by half-life) in
    plan order, and the port calls the scoring kernel once for it."""
    from repro_torch.kernels.pem_score import ops

    mat, days, _ = _corpus(seed=17)
    r_plans, t_plans = _mixed_plans(order)
    calls = []
    real = ops.pem_score

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(ops, "pem_score", counted)
    backend = TB.HopperBackend("cpu")
    got = backend.score_panel(mat, days, t_plans)
    want = RB.get_backend("pallas").score_panel(mat, days, r_plans)
    np.testing.assert_allclose(got, want, atol=TOL)
    assert len(calls) == 1
    ks = [5] * len(t_plans)
    got_sel = backend.score_select(mat, days, t_plans, ks)
    assert len(calls) == 2
    _assert_same(got_sel, RB.get_backend("pallas").score_select(
        mat, days, r_plans, ks))


# -- TorchBackend: cohorts and the PlanCache contract ---------------------------


def _cohort_store(n=256, seed=19):
    mat, days, _ = _corpus(n=n, seed=seed)
    ref = _reference_store(mat, days, [n], [])
    return ref, store_from_arrays(_export(ref.segments))


def _topic_plans(count, offset=0, extra=" pool:40"):
    toks = [f"similar:topic {offset + j} filler{extra}" for j in range(count)]
    return ([r_parse(t, RHash(D)) for t in toks],
            [t_parse(t, THash(D)) for t in toks])


@pytest.mark.parametrize("extra", [" pool:40", " decay:14 diverse pool:12"])
def test_torch_cohort_matches_jit_jax(extra):
    """A cohort (the batch axis pow2-bucketed) equals the reference's
    jit-jax cohort id for id; Q = 3 and Q = 4 share one function, and
    without the flag each Q is its own structure."""
    ref, store = _cohort_store()
    be = TB.TorchBackend("cpu")
    for q, off in ((3, 0), (4, 3)):
        r_plans, t_plans = _topic_plans(q, off, extra)
        got = TB.score_select_cohort(be, store.segments, t_plans, [10] * q,
                                     now=NOW)
        want = RB.score_select_cohort(RB.JitJaxBackend(), ref.segments,
                                      r_plans, [10] * q, now=NOW)
        _assert_same(got, want)
    assert be.plan_cache.builds == 1  # both cohorts in the Q = 4 bucket
    exact = TB.TorchBackend("cpu")
    for q in (3, 4):
        TB.score_select_segments(exact, store.segments,
                                 _topic_plans(q, extra=extra)[1], [10] * q,
                                 now=NOW)
    assert exact.plan_cache.builds == 2


def _plan(text="how the retrieval system works", *, n_suppress=2,
          decay=True):
    emb = THash(D)
    return TM.ModulationPlan(
        query=TM.l2_normalize(emb(text)),
        trajectory=TM.TrajectorySpec(
            direction=TM.l2_normalize(emb("production deployment"))
            - TM.l2_normalize(emb("prototype sketch"))),
        decay=TM.DecaySpec(half_life_days=30.0) if decay else None,
        suppress=tuple(
            TM.SuppressSpec(direction=TM.l2_normalize(
                emb(f"noise concept {i}")), weight=0.5 - 0.1 * i)
            for i in range(n_suppress)),
        pool=30)


def test_torch_plan_cache_no_rebuild_across_distinct_texts():
    mat, days, _ = _corpus(seed=37)
    be = TB.TorchBackend("cpu")
    for text in ("alpha query text", "beta entirely different words",
                 "gamma third phrasing"):
        be.score_select(mat, days, [_plan(text)], [10])
    assert (be.plan_cache.builds, be.plan_cache.hits,
            be.plan_cache.traces) == (1, 2, 1)


def test_torch_plan_cache_builds_once_per_suppress_bucket():
    mat, days, _ = _corpus(seed=41)
    be = TB.TorchBackend("cpu")
    traces = []
    for text, n_sup in (("t", 1), ("other text", 1), ("t", 2), ("t", 3),
                        ("t", 4), ("t", 0)):
        be.score_select(mat, days, [_plan(text, n_suppress=n_sup)], [10])
        traces.append(be.plan_cache.traces)
    # 1 -> 1 reuses; 2 builds; 3 and 4 share bucket 4; 0 drops the
    # second product
    assert traces == [1, 1, 2, 3, 3, 4]


def test_torch_plan_cache_decay_presence_is_structural():
    mat, days, _ = _corpus(seed=43)
    be = TB.TorchBackend("cpu")
    be.score_select(mat, days, [_plan(decay=True)], [10])
    be.score_select(mat, days, [_plan(decay=False)], [10])
    assert be.plan_cache.traces == 2
    p = _plan(decay=True)  # another half-life is data, not structure
    be.score_select(mat, days, [dataclasses.replace(
        p, decay=TM.DecaySpec(half_life_days=7.0))], [10])
    assert be.plan_cache.traces == 2


def test_torch_plan_cache_lru_eviction_bounds_functions():
    cache = TB.PlanCache(lambda s: ("fn", s), maxsize=2)
    keys = [TB.PlanStructure.of([_plan()], [10], n) for n in (100, 300, 600)]
    cache.get(keys[0])
    cache.get(keys[1])
    cache.get(keys[0])  # a hit refreshes keys[0]
    cache.get(keys[2])  # evicts keys[1], the least recent
    assert cache.stats() == {"entries": 2, "hits": 1, "builds": 3,
                             "evictions": 1, "traces": 0}
    cache.get(keys[0])
    assert cache.hits == 2


def test_torch_masked_query_on_a_warm_store_uploads_and_builds_nothing():
    """A masked filtered query scores the warm resident segment matrices:
    no new upload, no new function, no live view."""
    from repro_torch.core.backends import PrefilterRouter
    from repro_torch.core.vectorcache import VectorCache

    mat, days, _ = _corpus(n=300, seed=23)
    ref = _reference_store(mat, days, [200, 100], [])
    be = TB.TorchBackend("cpu")
    vc = VectorCache(store=store_from_arrays(_export(ref.segments)),
                     embed_fn=THash(D),
                     prefilter=PrefilterRouter(mask_threshold=0.0))
    plan = _plan()
    for _ in range(2):  # warm: one upload a segment
        vc.search_plan(plan, now=NOW, engine=be)
    uploads, traces = be.uploads, be.plan_cache.traces
    assert vc._view is None
    for lo in (0, 10, 20):  # several filters, one structure
        assert vc.search_plan(plan, list(range(lo, 300, 2)), now=NOW,
                              engine=be)
    assert (be.uploads, be.plan_cache.traces) == (uploads, traces)
    assert vc._view is None


def test_service_stats_report_the_torch_plan_cache():
    import sqlite3

    from repro_torch.serve.retrieval import RetrievalService
    from repro_torch.sqlio.schema import build_schema

    conn = sqlite3.connect(":memory:")
    build_schema(conn, "empty")
    svc = RetrievalService(conn, dim=8, engine=TB.TorchBackend("cpu"))
    assert svc.stats()["plan_cache"] == {"entries": 0, "hits": 0,
                                         "builds": 0, "evictions": 0,
                                         "traces": 0}


def test_torch_backend_launches_no_kernel(monkeypatch):
    """The library yardstick calls none of the three kernel wrappers."""
    from repro_torch.kernels.mmr import ops as mmr_ops
    from repro_torch.kernels.pem_score import ops as pem_ops
    from repro_torch.kernels.topk import ops as topk_ops

    def refuse(*a, **kw):
        raise AssertionError("TorchBackend called a kernel wrapper")

    for mod, name in ((pem_ops, "pem_score"), (topk_ops, "topk"),
                      (mmr_ops, "mmr_select")):
        monkeypatch.setattr(mod, name, refuse)
    mat, days, rng = _corpus(n=300, seed=29)
    ref = _reference_store(mat, days, [150, 150],
                           rng.choice(300, 20, replace=False))
    store = store_from_arrays(_export(ref.segments))
    r_plans, t_plans = _plans(lam0=True)
    got = TB.score_select_segments(TB.TorchBackend("cpu"), store.segments,
                                   t_plans, KS, now=NOW)
    _assert_same(got, RB.score_select_segments("jit-jax", ref.segments,
                                               r_plans, KS, now=NOW))


def test_torch_backend_refuses_tf32(monkeypatch):
    """The yardstick's products are full f32: with TF32 matmuls switched
    on it refuses to be built, and it never switches them itself."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        TB.TorchBackend("cpu")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    TB.TorchBackend("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
