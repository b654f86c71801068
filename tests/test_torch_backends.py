"""``HopperBackend`` against the reference package's backends, on the CPU.

``HopperBackend("cpu")`` runs the port's whole score -> select -> MMR chain
through the kernels' plain versions.  The same seeded numpy corpus and the
same token strings (each package parses them with its own, bit-identical
``HashEmbedder``) go through the reference's ``PallasBackend`` (interpret
mode), ``JitJaxBackend`` and ``fused-numpy``.  Candidate indices must be
equal and scores agree to 1e-5 (f32 products summed in another order), for
plain, decay, suppress, trajectory and diverse plans, with device MMR and
with the host-pool contract (``fused_mmr=False``), under (N,) and (N, B)
masks and score bias, and over a segmented store with tombstones carried
across by ``store_from_arrays``.
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
def test_score_select_matches_reference(mask_kind, bias_kind, fused_mmr):
    mat, days, rng = _corpus()
    r_plans, t_plans = _plans(lam0=fused_mmr is None)
    mask = _masks(rng, mat.shape[0], len(KS))[mask_kind]
    bias = _bias(rng, mat.shape[0], len(KS), bias_kind)
    kw = dict(mask=mask, fused_mmr=fused_mmr, score_bias=bias)
    got = TB.HopperBackend("cpu").score_select(mat, days, t_plans, KS, **kw)
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
def test_segments_match_reference(device_mmr):
    mat, days, rng = _corpus(n=300, seed=11)
    ref = _reference_store(mat, days, [120, 100, 80],
                           rng.choice(300, 30, replace=False))
    port = store_from_arrays(_export(ref.segments))
    r_plans, t_plans = _plans(lam0=True)
    backend = TB.HopperBackend("cpu")
    got = TB.score_select_segments(backend, port.segments, t_plans, KS,
                                   now=NOW, device_mmr=device_mmr)
    want = RB.score_select_segments("pallas", ref.segments, r_plans, KS,
                                    now=NOW, device_mmr=device_mmr)
    _assert_same(got, want)
    done = backend.device_mmr and device_mmr is not False
    final = TB.finalize_segment_candidates(port.segments, t_plans, KS, got,
                                           mmr_done=done)
    oracle = RB.finalize_segment_candidates(
        ref.segments, r_plans, KS,
        RB.score_select_segments("fused-numpy", ref.segments, r_plans, KS,
                                 now=NOW))
    for g, w in zip(final, oracle):
        assert [i for i, _ in g] == [i for i, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   atol=TOL)


def test_merged_pool_mmr_is_one_launch_for_the_cohort():
    """Diverse plans with different lambdas over a multi-segment store
    finish in ONE merged-pool call, equal to the host oracle."""
    mat, days, rng = _corpus(n=300, seed=13)
    ref = _reference_store(mat, days, [150, 150],
                           rng.choice(300, 20, replace=False))
    port = store_from_arrays(_export(ref.segments))
    r_plans, t_plans = _plans(lam0=True)
    div = [4, 5]
    r_div = [r_plans[j] for j in div]
    t_div = [t_plans[j] for j in div]
    ks = [KS[j] for j in div]
    backend = TB.HopperBackend("cpu")
    calls = []
    batch = backend.mmr_pool_segments_batch
    backend.mmr_pool_segments_batch = lambda *a: calls.append(1) or batch(*a)
    got = TB.score_select_segments(backend, port.segments, t_div, ks, now=NOW)
    assert len(calls) == 1
    want = RB.score_select_segments("jit-jax", ref.segments, r_div, ks,
                                    now=NOW)
    _assert_same(got, want)
