"""The Hopper kernels against their plain versions, on the card.

Needs an NVIDIA card with CUDA: every test skips elsewhere (the decision
is made inside the ``cuda`` fixture, so every worker collects the same
tests).  Run on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Shapes are the main path's: the 240k x 128 production corpus with B in
{1, 32}, the pow2 pool width 2048 of ``diverse pool:500``, and its MMR
over 1500 candidates with k = 500.  Scores agree to 1e-5 in f32 (2e-2
with a bf16 corpus) with the plain version on the same card; selections
agree exactly.  Imports no JAX.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.mmr.ops import NEG, mmr_select  # noqa: E402
from repro_torch.kernels.mmr.ref import mmr_ref  # noqa: E402
from repro_torch.kernels.pem_score.ops import pem_score  # noqa: E402
from repro_torch.kernels.pem_score.ref import pem_score_ref  # noqa: E402
from repro_torch.kernels.topk.ops import topk  # noqa: E402
from repro_torch.kernels.topk.ref import topk_ref  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA; run with -m gpu on one")
    return torch.device("cuda")


def _unit_rows(gen, *shape, device):
    e = torch.randn(*shape, generator=gen, device=device)
    return e / e.norm(dim=-1, keepdim=True)


@pytest.mark.parametrize("b", [1, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pem_score_matches_plain(cuda, b, dtype):
    gen = torch.Generator(device=cuda).manual_seed(b)
    n, d = 240_000, 128
    m = _unit_rows(gen, n, d, device=cuda).to(dtype)
    qp = torch.randn(d, b, generator=gen, device=cuda)
    qs = torch.randn(d, b, generator=gen, device=cuda) * 0.3
    decay = 1.0 / (1.0 + torch.rand(n, generator=gen, device=cuda) * 10)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    before = pem_score.launches
    for dec in (decay, None):
        want = pem_score_ref(m, qp, qs,
                             torch.ones(n, device=cuda) if dec is None else dec)
        got = pem_score(m, qp, qs, dec)
        panel = torch.empty((b, n), device=cuda)
        pem_score(m, qp, qs, dec, out=panel.T)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)
        torch.testing.assert_close(panel.T, want, atol=tol, rtol=tol)
    assert pem_score.launches == before + 4


@pytest.mark.parametrize("b,n,k", [(32, 240_000, 2048), (1, 240_000, 2048),
                                   (1, 1_000_448, 16), (3, 5000, 500)])
def test_topk_matches_plain(cuda, b, n, k):
    gen = torch.Generator(device=cuda).manual_seed(n + k)
    s = torch.randn(b, n, generator=gen, device=cuda)
    s[0, ::3] = float("-inf")  # masked rows ride along as -inf
    v, i = topk(s, k)
    vr, ir = topk_ref(s, k)
    torch.cuda.synchronize()
    assert torch.equal(i, ir) and torch.equal(v, vr)


def test_topk_ties_neg_inf_and_signed_zeros(cuda):
    row = torch.tensor([-1.0, 3.0, 3.0, -5.0, 0.0, -0.0, float("-inf")],
                       device=cuda)
    s = row.repeat(4, 3000)
    s[1] = float("-inf")       # a fully masked row
    s[2, 100:] = float("-inf")  # fewer live entries than k
    for k in (10, 700, 4096):
        v, i = topk(s, k)
        vr, ir = topk_ref(s, k)
        torch.cuda.synchronize()
        assert torch.equal(i, ir) and torch.equal(v, vr)
        assert all(len(set(r.tolist())) == k for r in i.cpu())


def adversarial_rows(gen, n, k, device):
    """Five rows that stress the radix select's tie handling: fully
    masked, 100 live entries, constant, 64 quantized levels (thousands of
    ties straddle the k-th key), and a boundary inside +0.0 / -0.0."""
    s = torch.full((5, n), float("-inf"), device=device)
    s[1, torch.randperm(n, generator=gen, device=device)[:100]] = torch.randn(
        100, generator=gen, device=device)
    s[2] = 0.5
    s[3] = torch.floor(torch.rand(n, generator=gen, device=device) * 64) / 64
    half = min(k // 2, n // 4)  # positives, then 2 * half signed zeros
    s[4] = -1.0
    s[4, :half] = torch.rand(half, generator=gen, device=device) + 0.1
    plus = max(k - half - 7, 0)  # the k-th key is the 7th -0.0
    s[4, half:half + plus] = 0.0
    s[4, half + plus:3 * half] = -0.0
    return s[:, torch.randperm(n, generator=gen, device=device)]


@pytest.mark.parametrize("n,k", [(20_000, 10), (20_000, 2048),
                                 (20_000, 8192), (1000, 2048)])
def test_topk_adversarial_ties_match_plain(cuda, n, k):
    gen = torch.Generator(device=cuda).manual_seed(n + k)
    s = adversarial_rows(gen, n, k, cuda)
    before = topk.launches
    v, i = topk(s, k)
    vr, ir = topk_ref(s, k)
    torch.cuda.synchronize()
    assert torch.equal(i, ir) and torch.equal(v, vr)
    assert topk.launches > before
    assert all(len(set(r.tolist())) == k for r in i.cpu())


def test_topk_with_no_columns_returns_neg_inf_padding(cuda):
    s = torch.empty((3, 0), device=cuda)
    v, i = topk(s, 5)
    vr, ir = topk_ref(s, 5)
    torch.cuda.synchronize()
    assert torch.equal(i, ir) and torch.equal(v, vr)


def test_topk_reads_a_strided_view(cuda):
    gen = torch.Generator(device=cuda).manual_seed(7)
    panel = torch.randn(50_000, 8, generator=gen, device=cuda)
    v, i = topk(panel.T, 300)
    vr, ir = topk_ref(panel.T.contiguous(), 300)
    torch.cuda.synchronize()
    assert torch.equal(i, ir) and torch.equal(v, vr)


@pytest.mark.parametrize("lam", [0.7, 0.0, 1.0])
def test_mmr_matches_plain(cuda, lam):
    gen = torch.Generator(device=cuda).manual_seed(11)
    b, n, pool, d, k = 4, 2048, 1500, 128, 500
    e = _unit_rows(gen, b, n, d, device=cuda)
    rel = torch.randn(b, n, generator=gen, device=cuda)
    rel[:, pool:] = NEG  # the pow2 bucket's padding
    idx, val = mmr_select(e, rel, k, lam)
    ir, vr = mmr_ref(e, rel, k, torch.full((b,), lam, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(idx, ir)
    torch.testing.assert_close(val, vr, atol=1e-5, rtol=1e-5)
    assert int(idx.max()) < pool


@pytest.mark.parametrize("lam", [0.7, 0.0, 1.0])
@pytest.mark.parametrize("d", [128, 254])
def test_mmr_pool_beyond_shared_memory_matches_plain(cuda, lam, d):
    """A pool larger than the cluster's shared memory holds: the rows that
    do not fit are read from global memory by the same kernel."""
    from repro_torch.kernels.mmr import kernel

    gen = torch.Generator(device=cuda).manual_seed(13)
    b, n, pool, k = 2, 8192, 6000, 100
    shape = kernel.shape(n, d + (-d) % 4)
    assert shape["max_active_clusters"] > 0
    assert shape["rows_in_smem"] * shape["cluster"] < pool
    e = _unit_rows(gen, b, n, d, device=cuda)
    rel = torch.randn(b, n, generator=gen, device=cuda)
    rel[:, pool:] = NEG
    idx, val = mmr_select(e, rel, k, lam)
    ir, vr = mmr_ref(e, rel, k, torch.full((b,), lam, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(idx, ir)
    torch.testing.assert_close(val, vr, atol=1e-5, rtol=1e-5)


def test_mmr_full_ties_match_plain(cuda):
    """Equal relevance and identical rows: every step is a tie across the
    cluster's CTAs, so the smallest slot must win each time."""
    gen = torch.Generator(device=cuda).manual_seed(19)
    row = _unit_rows(gen, 1, 1, 64, device=cuda)
    e = row.repeat(2, 300, 1)
    rel = torch.full((2, 300), 0.5, device=cuda)
    idx, val = mmr_select(e, rel, 40, 0.7)
    ir, vr = mmr_ref(e, rel, 40, torch.full((2,), 0.7, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(idx, ir)
    torch.testing.assert_close(val, vr, atol=1e-5, rtol=1e-5)


def test_mmr_exhausted_pool_matches_plain(cuda):
    """k above the live slots: once every live slot is taken the reference
    returns slot 0 at NEG, and so must the kernel."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    b, n, live, d, k = 3, 50, 20, 32, 30
    e = _unit_rows(gen, b, n, d, device=cuda)
    rel = torch.randn(b, n, generator=gen, device=cuda)
    rel[:, live:] = NEG
    idx, val = mmr_select(e, rel, k, 0.7)
    ir, vr = mmr_ref(e, rel, k, torch.full((b,), 0.7, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(idx, ir)
    torch.testing.assert_close(val, vr, atol=1e-5, rtol=1e-5)


def test_hopper_backend_matches_plain_chain(cuda):
    """The whole score -> select -> MMR chain on the card against the same
    backend on the CPU (the kernels' plain versions) over a segmented
    store with tombstones."""
    from repro_torch.core import modulations as M
    from repro_torch.core.backends import (HopperBackend,
                                           score_select_segments)
    from repro_torch.core.grammar import parse
    from repro_torch.core.segments import store_from_arrays
    from repro_torch.embed import HashEmbedder

    rng = np.random.default_rng(0)
    n, d, now = 30_000, 128, 1_770_000_000.0
    mat = rng.standard_normal((n, d)).astype(np.float32)
    mat /= np.linalg.norm(mat, axis=1, keepdims=True)
    ts = now - rng.uniform(0, 90, n) * 86400.0
    live = rng.random(n) > 0.05
    cuts = [0, 12_000, 25_000, n]
    store = store_from_arrays([
        {"ids": np.arange(a, b), "matrix": mat[a:b], "timestamps": ts[a:b],
         "live_mask": live[a:b]} for a, b in zip(cuts, cuts[1:])])
    emb = HashEmbedder(d)
    plans = [parse(t, emb) for t in (
        "similar:how the system works decay:30 diverse pool:200",
        "similar:auth token suppress:website design",
        "similar:rendering pipeline from:sketch to:production diverse",
    )]
    plans[2] = dataclasses.replace(plans[2], diverse=M.DiverseSpec(lam=0.0))
    ks = [50, 10, 30]
    got = score_select_segments(HopperBackend("cuda"), store.segments,
                                plans, ks, now=now)
    want = score_select_segments(HopperBackend("cpu"), store.segments,
                                 plans, ks, now=now)
    for (gi, gv), (wi, wv) in zip(got, want):
        _assert_same_ranking(gi, gv, wi, wv)


def _assert_same_ranking(gi, gv, wi, wv, tol=1e-5):
    """Scores agree to ``tol`` position by position, and ids agree except
    inside a near tie: the card and the CPU sum the 128 products of a
    score in different orders, so two scores closer than that may swap."""
    assert gi.shape == wi.shape
    np.testing.assert_allclose(gv, wv, atol=tol)
    for p in np.flatnonzero(gi != wi):
        near = np.flatnonzero(np.abs(wv - wv[p]) <= tol)
        assert gi[p] in set(wi[near].tolist()), (p, gi[p], wi[p])
