"""The Hopper kernels against their plain versions, on the card.

Needs an NVIDIA card with CUDA: every test skips elsewhere (the decision
is made inside the ``cuda`` fixture, so every worker collects the same
tests).  Run on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Shapes are the main path's: the 240k x 128 production corpus with B in
{1, 32}, the pow2 pool width 2048 of ``diverse pool:500``, and its MMR
over 1500 candidates with k = 500.  Scores agree to 1e-5 in f32 (2e-2
with a bf16 corpus) with the plain version on the same card; selections
agree exactly.  The filtered, hybrid and write paths' inputs are here
too: equal rows scoring bit-equal in any block, a masked (N, B) filter
panel, a bias panel, a store of 40 delta segments (more than the device
cache holds) and a diverse pool shorter than its bucket, each against
``HopperBackend("cpu")``.  Imports no JAX.
"""

import dataclasses
import os

import numpy as np
import pytest

# cuBLAS is deterministic only with a fixed workspace, read when its first
# handle is made: set before any test runs a product (the trainer's
# resume test runs under torch.use_deterministic_algorithms)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

torch = pytest.importorskip("torch")

from repro_torch.kernels.mmr.ops import NEG, mmr_select  # noqa: E402
from repro_torch.kernels.mmr.ref import mmr_ref  # noqa: E402
from repro_torch.kernels.pem_score.ops import pem_score  # noqa: E402
from repro_torch.kernels.pem_score.ref import (  # noqa: E402
    pem_score_days_ref, pem_score_ref)
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


def _check_pem(m, qp, qs, tol, *, decay=None, days=None, hl=None,
               scale=None):
    """One kernel call into a fresh (N, B) tensor and one into a (B, N)
    panel's transpose, each against the plain version; each call is one
    launch.  ``scale`` (N,) widens the tolerance row by row, for rows
    whose products are that large."""
    n, b = m.shape[0], qp.shape[1]
    if days is not None:
        want = pem_score_days_ref(m, qp, qs, days, hl)
        kw = dict(days_ago=days, half_lives=hl)
    else:
        want = pem_score_ref(m, qp, qs, torch.ones(n, device=m.device)
                             if decay is None else decay)
        kw = {}
    before = pem_score.launches
    got = pem_score(m, qp, qs, decay, **kw)
    panel = torch.full((b, n), float("nan"), device=m.device)
    pem_score(m, qp, qs, decay, out=panel.T, **kw)
    torch.cuda.synchronize()
    assert pem_score.launches == before + 2
    bound = tol + tol * want.abs()
    if scale is not None:
        bound = bound * torch.clamp(scale, min=1.0)[:, None]
    for res in (got, panel.T):
        err = (res - want).abs()
        assert bool((err <= bound).all()), float(err.max())


@pytest.mark.parametrize("b", [1, 3, 8, 9, 32, 33, 64, 130])
def test_pem_score_ragged_rows_every_width(cuda, b):
    """240,001 rows (a ragged last tile) at every product width and query
    chunking the kernel has: 8, 16, 32, 64 columns; 1, 2, 3 or 5 chunks;
    the split query resident or restaged per tile."""
    gen = torch.Generator(device=cuda).manual_seed(100 + b)
    n, d = 240_001, 128
    m = _unit_rows(gen, n, d, device=cuda)
    qp = torch.randn(d, b, generator=gen, device=cuda)
    qs = torch.randn(d, b, generator=gen, device=cuda) * 0.3
    decay = 1.0 / (1.0 + torch.rand(n, generator=gen, device=cuda) * 10)
    _check_pem(m, qp, qs, 1e-5, decay=decay)
    _check_pem(m.to(torch.bfloat16), qp, qs, 2e-2, decay=decay)


@pytest.mark.parametrize("d,b", [(64, 9), (68, 3), (68, 33), (4, 2)])
def test_pem_score_narrow_depths(cuda, d, b):
    """Depths short of a 32-wide box (the ragged d edge, zero-filled by
    TMA)."""
    gen = torch.Generator(device=cuda).manual_seed(d * 1000 + b)
    n = 50_017
    m = _unit_rows(gen, n, d, device=cuda)
    qp = torch.randn(d, b, generator=gen, device=cuda)
    qs = torch.randn(d, b, generator=gen, device=cuda) * 0.3
    _check_pem(m, qp, qs, 1e-5)
    if d % 8 == 0:
        _check_pem(m.to(torch.bfloat16), qp, qs, 2e-2)
    else:
        with pytest.raises(ValueError, match="16-byte rows"):
            pem_score(m.to(torch.bfloat16), qp, qs)


@pytest.mark.parametrize("d,b", [(256, 1), (256, 16), (256, 17), (256, 64),
                                 (200, 3), (132, 33)])
def test_pem_score_wide_depths(cuda, d, b):
    """Depths past 128 (a two-tower model's 256-wide item vectors): eight
    boxes a row, a two-stage ring, and past B = 16 the product narrowed
    until a restaged query chunk fits beside it; the ragged d edge of 200
    and 132 zero-filled by TMA.  Both factor forms, f32 and bf16."""
    gen = torch.Generator(device=cuda).manual_seed(d * 1000 + b)
    n = 100_003
    m = _unit_rows(gen, n, d, device=cuda)
    qp = torch.randn(d, b, generator=gen, device=cuda)
    qs = torch.randn(d, b, generator=gen, device=cuda) * 0.3
    decay = 1.0 / (1.0 + torch.rand(n, generator=gen, device=cuda) * 10)
    days = torch.rand(n, generator=gen, device=cuda) * 90
    hl = torch.full((b,), 30.0, device=cuda)
    _check_pem(m, qp, qs, 1e-5, decay=decay)
    _check_pem(m, qp, qs, 1e-5, days=days, hl=hl)
    if d % 8 == 0:
        _check_pem(m.to(torch.bfloat16), qp, qs, 2e-2, days=days, hl=hl)
    with pytest.raises(ValueError, match="d <= 256"):
        pem_score(torch.zeros(8, 260, device=cuda),
                  torch.zeros(260, 1, device=cuda),
                  torch.zeros(260, 1, device=cuda))


@pytest.mark.parametrize("b", [1, 32])
def test_pem_score_large_rows_keep_f32_accuracy(cuda, b):
    """Rows with norms up to 1e3: plain TF32 would be off by ~1e-3 of the
    row's scale there; the split (hi + lo) products hold the f32
    tolerance, scaled by the row's norm as any f32 sum's error is."""
    gen = torch.Generator(device=cuda).manual_seed(7 + b)
    n, d = 100_003, 128
    norms = 10.0 ** (torch.rand(n, generator=gen, device=cuda) * 3)
    m = _unit_rows(gen, n, d, device=cuda) * norms[:, None]
    qp = torch.randn(d, b, generator=gen, device=cuda) / d ** 0.5
    qs = torch.randn(d, b, generator=gen, device=cuda) * 0.1 / d ** 0.5
    _check_pem(m, qp, qs, 1e-5, scale=norms)


@pytest.mark.parametrize("b", [5, 32, 33])
def test_pem_score_per_plan_half_lives(cuda, b):
    """The days_ago / half_lives form, with +inf (no decay) columns, in
    one launch, against its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(300 + b)
    n, d = 240_001, 128
    m = _unit_rows(gen, n, d, device=cuda)
    qp = torch.randn(d, b, generator=gen, device=cuda)
    qs = torch.randn(d, b, generator=gen, device=cuda) * 0.3
    days = torch.rand(n, generator=gen, device=cuda) * 180
    hl = torch.tensor([7.0, 14.0, 30.0, 90.0, float("inf")],
                      device=cuda).repeat(b)[:b]
    _check_pem(m, qp, qs, 1e-5, days=days, hl=hl)
    _check_pem(m.to(torch.bfloat16), qp, qs, 2e-2, days=days, hl=hl)
    # a +inf column is exactly the no-decay score
    out = pem_score(m, qp, qs, days_ago=days, half_lives=hl)
    plain = pem_score(m, qp, qs)
    torch.cuda.synchronize()
    inf = torch.isinf(hl)
    assert torch.equal(out[:, inf], plain[:, inf])


def test_pem_score_decay_factors_are_bit_equal(cuda):
    """With every row e_0, q_pre[0] = 1 and q_sup = 0 the kernel returns
    its per-plan factor itself: it equals the correctly rounded f32
    1 / (1 + days / half_life) bit for bit, over ages from 0 to 10^6 days
    and half-lives from 0.3 to 365 and +inf."""
    from repro_torch.kernels.pem_score.ref import decay_factors

    gen = torch.Generator(device=cuda).manual_seed(11)
    n, d = 240_001, 128
    days = torch.cat([torch.rand(n - 4, generator=gen, device=cuda) * 400,
                      torch.tensor([0.0, 1e-3, 7.0, 1e6], device=cuda)])
    hl = torch.tensor([7.0, 14.0, 30.0, 90.0, float("inf"), 0.3, 21.0,
                       365.0, 1.5, 1e-3], device=cuda)
    m = torch.zeros(n, d, device=cuda)
    m[:, 0] = 1.0
    qp = torch.zeros(d, hl.numel(), device=cuda)
    qp[0] = 1.0
    got = pem_score(m, qp, torch.zeros_like(qp), days_ago=days,
                    half_lives=hl)
    want = decay_factors(days, hl)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 8, 32, 64])
def test_pem_score_stamped_ages_are_bit_equal(cuda, b, dtype, d):
    """K1's timestamps form (the ages formed in its epilogue from f64
    unix seconds) gives the panel its days_ago form gives fed the host's
    ``CorpusSegment.days_ago``, bit for bit (a NaN meets a NaN): over
    ages planted on f32 ties and boundaries, rows newer than ``now`` and
    at it, decades, a NaN timestamp, a ragged n, and mixed half-lives
    with +inf.  Each call is one launch; the stamped one counts."""
    from stamp_cases import NOW, host_ages, planted_stamps, same_bits_or_nan

    n = 50_001
    ts = planted_stamps(n, seed=b * 1000 + d)
    gen = torch.Generator(device=cuda).manual_seed(b * 1000 + d)
    m = _unit_rows(gen, n, d, device=cuda).to(dtype)
    qp = torch.randn(d, b, generator=gen, device=cuda)
    qs = torch.randn(d, b, generator=gen, device=cuda) * 0.3
    hl = torch.tensor([7.0, 14.0, 30.0, 90.0, float("inf"), 0.3, 365.0,
                       1.5], device=cuda).repeat(8)[:b]
    before = (pem_score.launches, pem_score.stamped_launches)
    stamped = torch.full((b, n), float("nan"), device=cuda)
    pem_score(m, qp, qs, out=stamped.T,
              timestamps=torch.from_numpy(ts).to(cuda), now=NOW,
              half_lives=hl)
    days = pem_score(m, qp, qs,
                     days_ago=torch.from_numpy(host_ages(ts)).to(cuda),
                     half_lives=hl)
    torch.cuda.synchronize()
    assert (pem_score.launches, pem_score.stamped_launches) == (
        before[0] + 2, before[1] + 1)
    assert bool(torch.isnan(days[:, 0]).any())   # the NaN row, at b = 1
    same_bits_or_nan(stamped.T.cpu().numpy(), days.cpu().numpy())


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


def _masked(gen, live_counts, n, device):
    """Scores -inf but at each row's live columns, masked as HopperBackend
    masks a filter batch: the column-major ``torch.where(mask.T, ...)``."""
    b = len(live_counts)
    mask = torch.zeros((n, b), dtype=torch.bool, device=device)
    for r, live in enumerate(live_counts):
        mask[torch.randperm(n, generator=gen, device=device)[:live], r] = True
    panel = torch.randn(b, n, generator=gen, device=device)
    return torch.where(mask.T, panel, float("-inf"))


@pytest.mark.parametrize("layout", ["column-major", "row-major"])
def test_topk_masked_panel_matches_plain(cuda, layout):
    """A filter batch's (32, 240000) panel at K = 2,048: rows with fewer
    than K live keys (v* is -inf), exactly K, and more, in the layout the
    mask gives and row-major; six launches either way (the first pass
    copies the column-major panel row-major)."""
    gen = torch.Generator(device=cuda).manual_seed(37)
    k = 2048
    live = [50] * 20 + [0, k - 1, k, k + 1] + [6_000, 24_000, 48_000,
                                                60_000, 107_800, 10_000,
                                                20_000, 240_000]
    s = _masked(gen, live, 240_000, cuda)
    if layout == "row-major":
        s = s.contiguous()
    before = topk.launches
    v, i = topk(s, k)
    launches = topk.launches - before
    vr, ir = topk_ref(s, k)
    torch.cuda.synchronize()
    assert torch.equal(i, ir) and torch.equal(v, vr)
    assert launches == 6
    assert all(len(set(r.tolist())) == k for r in i.cpu())


@pytest.mark.parametrize("live", [50, 2047, 2048, 5000])
def test_topk_masked_single_row_matches_plain(cuda, live):
    gen = torch.Generator(device=cuda).manual_seed(41 + live)
    s = _masked(gen, [live], 240_000, cuda)
    v, i = topk(s, 2048)
    vr, ir = topk_ref(s, 2048)
    torch.cuda.synchronize()
    assert torch.equal(i, ir) and torch.equal(v, vr)


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
    """A pool larger than the cluster's registers and shared memory hold:
    the rows that do not fit are read from global memory by the same
    kernel."""
    from repro_torch.kernels.mmr import kernel

    gen = torch.Generator(device=cuda).manual_seed(13)
    b, n, pool, k = 2, 24_576, 20_000, 100
    shape = kernel.shape(b, n, d + (-d) % 4, live=pool)
    assert shape["max_active_clusters"] > 0
    assert shape["global_rows"] > 0
    e = _unit_rows(gen, b, n, d, device=cuda)
    rel = torch.randn(b, n, generator=gen, device=cuda)
    rel[:, pool:] = NEG
    idx, val = mmr_select(e, rel, k, lam)
    ir, vr = mmr_ref(e, rel, k, torch.full((b,), lam, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(idx, ir)
    torch.testing.assert_close(val, vr, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("lam", [0.7, 0.0])
def test_mmr_flexvec_batch_runs_in_one_wave(cuda, lam):
    """flexvec's batch: 64 pools of 1500 live rows in a 2048 bucket,
    d = 128, k = 500, all resident at once (one wave), every live row on
    chip; indices equal to the plain version's."""
    from repro_torch.kernels.mmr import kernel

    gen = torch.Generator(device=cuda).manual_seed(23)
    b, n, pool, d, k = 64, 2048, 1500, 128, 500
    shape = kernel.shape(b, n, d, live=pool)
    assert shape["waves"] == 1 and shape["global_rows"] == 0
    e = _unit_rows(gen, b, n, d, device=cuda)
    rel = torch.randn(b, n, generator=gen, device=cuda) * 0.1
    rel[:, pool:] = NEG
    idx, val = mmr_select(e, rel, k, lam)
    ir, vr = mmr_ref(e, rel, k, torch.full((b,), lam, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(idx, ir)
    torch.testing.assert_close(val, vr, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,n,d", [(4, 2048, 128), (64, 1500, 128),
                                   (1, 2048, 256)])
def test_plain_gram_is_a_column_order_fma_chain(cuda, b, n, d):
    """K3's picks equal the plain version's because K3 computes each dot
    as one fused multiply-add chain in column order, which is how the
    plain version's f32 gram (``torch.bmm``, cuBLAS) rounds each entry on
    the H100: emulated here in f64 (each product exact, each sum rounded
    to f32) for 64 rows of the gram, at the pools' shapes."""
    gen = torch.Generator(device=cuda).manual_seed(43)
    e = _unit_rows(gen, b, n, d, device=cuda)
    gram = torch.bmm(e, e.transpose(1, 2))[:, :64]
    head, rows = e[:, :64].double(), e.double()
    acc = torch.zeros(b, 64, n, dtype=torch.float64, device=cuda)
    for x in range(d):
        acc = (head[:, :, x, None] * rows[:, None, :, x] + acc).float().double()
    assert torch.equal(acc.float(), gram)


@pytest.mark.parametrize("b", [1, 8])
def test_mmr_wide_rows_match_plain(cuda, b):
    """d = 256 (two-tower's item vectors): 4 register rows a group, the
    rest in shared memory."""
    gen = torch.Generator(device=cuda).manual_seed(29 + b)
    n, pool, d, k = 2048, 1500, 256, 500
    e = _unit_rows(gen, b, n, d, device=cuda)
    rel = torch.randn(b, n, generator=gen, device=cuda) * 0.1
    rel[:, pool:] = NEG
    lam = torch.linspace(0.0, 1.0, b, device=cuda)
    idx, val = mmr_select(e, rel, k, lam)
    ir, vr = mmr_ref(e, rel, k, lam)
    torch.cuda.synchronize()
    assert torch.equal(idx, ir)
    torch.testing.assert_close(val, vr, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cluster", [None, 1])
def test_mmr_pool_of_6000_matches_plain(cuda, cluster):
    """(2, 8192, 6000): on chip at the plan's 8 CTAs a query, and through
    the global-row path at one CTA a query (5,488 rows a step from global
    memory)."""
    from repro_torch.kernels.mmr import kernel

    gen = torch.Generator(device=cuda).manual_seed(31)
    b, n, pool, d, k = 2, 8192, 6000, 128, 100
    shape = kernel.shape(b, n, d, live=pool, cluster=cluster)
    assert (shape["global_rows"] > 0) == (cluster == 1)
    e = _unit_rows(gen, b, n, d, device=cuda)
    rel = torch.randn(b, n, generator=gen, device=cuda)
    rel[:, pool:] = NEG
    lam = torch.full((b,), 0.7, device=cuda)
    idx = torch.empty((b, k), dtype=torch.int32, device=cuda)
    val = torch.empty((b, k), device=cuda)
    kernel.launch(e, rel, lam, k, idx, val, cluster=cluster)
    ir, vr = mmr_ref(e, rel, k, lam)
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


def _tombstoned_store_and_plans():
    """A 30,000 x 128 store in three segments with 5% tombstones, and
    three plans: decay + diverse, suppress, trajectory + diverse at
    lambda 0; (store, plans, ks, now)."""
    from repro_torch.core import modulations as M
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
    return store, plans, [50, 10, 30], now


def test_hopper_backend_matches_plain_chain(cuda):
    """The whole score -> select -> MMR chain on the card against the same
    backend on the CPU (the kernels' plain versions) over a segmented
    store with tombstones."""
    from repro_torch.core.backends import (HopperBackend,
                                           score_select_segments)

    store, plans, ks, now = _tombstoned_store_and_plans()
    got = score_select_segments(HopperBackend("cuda"), store.segments,
                                plans, ks, now=now)
    want = score_select_segments(HopperBackend("cpu"), store.segments,
                                 plans, ks, now=now)
    for (gi, gv), (wi, wv) in zip(got, want):
        _assert_same_ranking(gi, gv, wi, wv)


def test_torch_backend_equals_hopper_on_the_card(cuda):
    """``TorchBackend("cuda")`` (library calls, no kernel launched) against
    ``HopperBackend("cuda")`` on the same plans and store."""
    from repro_torch.core.backends import (HopperBackend, TorchBackend,
                                           score_select_segments)

    store, plans, ks, now = _tombstoned_store_and_plans()
    before = (pem_score.launches, topk.launches, mmr_select.launches)
    torch_be = TorchBackend("cuda")
    got = score_select_segments(torch_be, store.segments, plans, ks, now=now)
    again = score_select_segments(torch_be, store.segments, plans, ks,
                                  now=now)
    assert (pem_score.launches, topk.launches, mmr_select.launches) == before
    assert torch_be.plan_cache.stats()["traces"] == len(torch_be.plan_cache)
    assert torch_be.plan_cache.hits > 0
    want = score_select_segments(HopperBackend("cuda"), store.segments,
                                 plans, ks, now=now)
    for (gi, gv), (ai, av), (wi, wv) in zip(got, again, want):
        np.testing.assert_array_equal(gi, ai)
        _assert_same_ranking(gi, gv, wi, wv)


def test_behavioral_suite_on_the_card(cuda):
    """Tables 5-6 on nfcorpus-like at its full 3,633 rows: both engines on
    the card against fused-numpy on the same cache, ids equal but for
    near ties, figures equal at the printed precision, and every diverse
    search through the mmr kernel on HopperBackend."""
    from repro_torch.bench import behavioral as BH
    from repro_torch.core.backends import HopperBackend, TorchBackend

    suite = BH.setup("nfcorpus-like")
    want = BH.run_dataset("nfcorpus-like", "fused-numpy", suite=suite)
    for engine in (HopperBackend("cuda"), TorchBackend("cuda")):
        k3 = mmr_select.launches
        got = BH.run_dataset("nfcorpus-like", engine, suite=suite)
        if engine.name == "hopper":
            assert mmr_select.launches - k3 >= BH.N_QUERIES
        else:
            assert mmr_select.launches == k3
        for plan in BH.PLANS:
            for g, w in zip(got["rankings"][plan], want["rankings"][plan]):
                _assert_same_ranking(*(np.asarray(c) for c in zip(*g)),
                                     *(np.asarray(c) for c in zip(*w)))
        assert BH.table5_rows(got) == BH.table5_rows(want)
        assert BH.table6_row(got) == BH.table6_row(want)


def _assert_same_ranking(gi, gv, wi, wv, tol=1e-5):
    """Scores agree to ``tol`` position by position, and ids agree except
    inside a near tie: the card and the CPU sum the 128 products of a
    score in different orders, so two scores closer than that may swap."""
    assert gi.shape == wi.shape
    np.testing.assert_allclose(gv, wv, atol=tol)
    for p in np.flatnonzero(gi != wi):
        near = np.flatnonzero(np.abs(wv - wv[p]) <= tol)
        assert gi[p] in set(wi[near].tolist()), (p, gi[p], wi[p])


def test_hopper_backend_scores_mixed_half_lives_in_one_launch(cuda):
    """A batch mixing decay:7, decay:30 and no decay: one scoring launch
    per score_select on the card, rankings equal to the plain chain."""
    from repro_torch.core.backends import HopperBackend
    from repro_torch.core.grammar import parse
    from repro_torch.embed import HashEmbedder

    rng = np.random.default_rng(5)
    n, d = 50_000, 128
    mat = rng.standard_normal((n, d)).astype(np.float32)
    mat /= np.linalg.norm(mat, axis=1, keepdims=True)
    days = rng.uniform(0, 120, n).astype(np.float32)
    emb = HashEmbedder(d)
    plans = [parse(t, emb) for t in (
        "similar:server lifecycle decay:7",
        "similar:auth token",
        "similar:rendering pipeline decay:30 diverse pool:100",
        "similar:database migration decay:7 suppress:website design",
        "similar:identity provenance decay:30",
    )]
    ks = [20, 10, 30, 15, 25]
    backend = HopperBackend("cuda")
    before = pem_score.launches
    got = backend.score_select(mat, days, plans, ks)
    assert pem_score.launches == before + 1
    want = HopperBackend("cpu").score_select(mat, days, plans, ks)
    for (gi, gv), (wi, wv) in zip(got, want):
        _assert_same_ranking(gi, gv, wi, wv)


# -- sharded scoring and shard workers on the card ---------------------------

SHARD_TOKENS = (
    "similar:server lifecycle decay:7",
    "similar:auth token suppress:website design",
    "similar:rendering pipeline decay:30 diverse pool:100",
    "similar:identity provenance from:sketch to:production diverse",
)


def _sharded_corpus(n, d, seed, tie_rows=()):
    """Unit rows and ages; every row in ``tie_rows`` is the same one-hot
    vector with the same age, so its scores tie exactly in any order of
    summation."""
    rng = np.random.default_rng(seed)
    mat = rng.standard_normal((n, d)).astype(np.float32)
    mat /= np.linalg.norm(mat, axis=1, keepdims=True)
    days = rng.uniform(0, 120, n).astype(np.float32)
    for r in tie_rows:
        mat[r] = 0.0
        mat[r, 3] = 1.0
        days[r] = 5.0
    return mat, days


@pytest.mark.parametrize("masked", [False, True])
def test_sharded_backend_equals_hopper_on_the_card(cuda, masked):
    """Four shards on one card against the monolithic backend on the same
    rows: ids equal and scores bit-equal (the scoring kernel reduces each
    row in one order, whatever block holds it), diverse plans included."""
    from repro_torch.core.backends import HopperBackend, ShardedBackend
    from repro_torch.core.grammar import parse
    from repro_torch.embed import HashEmbedder

    n, d = 50_001, 128
    mat, days = _sharded_corpus(n, d, 11)
    emb = HashEmbedder(d)
    plans = [parse(t, emb) for t in SHARD_TOKENS]
    ks = [20, 10, 30, 25]
    rng = np.random.default_rng(12)
    mask = rng.random(n) > 0.1 if masked else None
    if masked:
        mask[: -(-n // 4)] = False  # the first shard holds no live row
    got = ShardedBackend([cuda.type + ":0"] * 4).score_select(
        mat, days, plans, ks, mask=mask)
    want = HopperBackend("cuda").score_select(mat, days, plans, ks,
                                              mask=mask)
    for (gi, gv), (wi, wv) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gv, wv)


def test_sharded_backend_boundary_ties_on_the_card(cuda):
    """Equal scores that straddle every shard boundary go to the smallest
    global row, as on the monolith and in the plain chain."""
    from repro_torch.core.backends import HopperBackend, ShardedBackend
    from repro_torch.core.grammar import parse
    from repro_torch.embed import HashEmbedder

    n, d, s = 40_000, 128, 4
    step = -(-n // s)
    ties = [r for b in range(1, s) for r in (b * step - 2, b * step - 1,
                                             b * step, b * step + 1)]
    mat, days = _sharded_corpus(n, d, 13, ties)
    q = np.zeros(d, np.float32)
    q[3] = 1.0  # the tie rows score highest
    emb = HashEmbedder(d)
    plan = dataclasses.replace(parse("similar:server lifecycle", emb),
                               query=q)
    got = ShardedBackend(["cuda:0"] * s).score_select(mat, days, [plan],
                                                      [30])
    want = HopperBackend("cuda").score_select(mat, days, [plan], [30])
    plain = ShardedBackend(["cpu"] * s).score_select(mat, days, [plan],
                                                     [30])
    np.testing.assert_array_equal(got[0][0], want[0][0])
    np.testing.assert_array_equal(got[0][0], plain[0][0])
    tied = [int(r) for r in got[0][0] if int(r) in set(ties)]
    assert tied == sorted(tied)


def test_spawned_shard_group_on_the_card(cuda):
    """Two spawned workers, each scoring its shard with the kernels on the
    card, against the fused-numpy monolith on the same rows."""
    from repro_torch.core.grammar import parse
    from repro_torch.core.vectorcache import VectorCache
    from repro_torch.dist.procgroup import ProcessGroup
    from repro_torch.embed import HashEmbedder

    n, d, now = 20_000, 128, 1_770_000_000.0
    mat, days = _sharded_corpus(n, d, 14)
    ids = np.arange(n, dtype=np.int64)
    ts = now - days.astype(np.float64) * 86400.0
    emb = HashEmbedder(d)
    vc = VectorCache(ids, mat, ts, emb)
    with ProcessGroup.build(ids, mat, ts, normalized=True, n_shards=2,
                            transport="process", engine="hopper",
                            device="cuda") as g:
        assert {s["device"] for s in g.stats()["shards"]} <= {
            f"cuda:{j}" for j in range(torch.cuda.device_count())}
        for tokens in SHARD_TOKENS:
            plan = parse(tokens, emb)
            got = g.search_plan(plan, now=now)
            want = vc.search_plan(plan, now=now, engine="fused-numpy")
            if plan.diverse is None:
                _assert_same_ranking(
                    np.array([i for i, _ in got]),
                    np.array([v for _, v in got], np.float32),
                    np.array([i for i, _ in want]),
                    np.array([v for _, v in want], np.float32))
            else:
                _assert_same_mmr_ranking(got, want)
        assert all(s["device_bytes"] > 0 for s in g.stats()["shards"])


def _assert_same_mmr_ranking(got, want, tol=1e-5):
    """An MMR-ordered (id, relevance) list: the same ids, each with its
    relevance within ``tol``, in the same order except swaps of two
    neighbours.  Relevance a few ulps off (the card's products against
    BLAS's) can turn a near tie of two greedy MMR values either way; the
    two picks then trade places, as ``chip_smoke.py`` allows."""
    gi, wi = [i for i, _ in got], [i for i, _ in want]
    assert sorted(gi) == sorted(wi)
    score = dict(want)
    assert max(abs(v - score[i]) for i, v in got) <= tol
    p = 0
    while p < len(gi):
        if gi[p] != wi[p]:
            assert gi[p:p + 2] == wi[p:p + 2][::-1], (p, gi[p:p + 3],
                                                      wi[p:p + 3])
            p += 1
        p += 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flexvec_step_matches_plain(cuda, dtype):
    """``configs/flexvec.pem_serve_step`` on the card (K1 into the panel,
    one K2 call, the pool's gather, K3) against its plain version on the
    same tensors: 20,000 rows, B = 8, over = 300, pool = 50."""
    from repro_torch.configs.flexvec import (pem_serve_step,
                                             pem_serve_step_plain)

    gen = torch.Generator(device=cuda).manual_seed(21)
    n, b = 20_000, 8
    corpus = _unit_rows(gen, n, 128, device=cuda).to(dtype)
    days = torch.rand(n, generator=gen, device=cuda) * 90
    q = torch.randn(128, b, generator=gen, device=cuda)

    def counts():
        return pem_score.launches, topk.launches, mmr_select.launches

    before = counts()
    gi, gv = pem_serve_step(corpus, days, q, -0.5 * q, pool=50, over=300)
    launches = tuple(a - c for a, c in zip(counts(), before))
    wi, wv = pem_serve_step_plain(corpus, days, q, -0.5 * q, pool=50,
                                  over=300)
    torch.cuda.synchronize()
    assert launches == (1, 6, 1)  # a top-k call is six launches
    for r in range(b):
        _assert_same_mmr_ranking(list(zip(gi[r].tolist(), gv[r].tolist())),
                                 list(zip(wi[r].tolist(), wv[r].tolist())))


def test_two_tower_retrieval_step_on_the_card(cuda):
    """The two-tower ``retrieval_cand`` step at the smoke config widened
    to the published 256-wide tower output, on the card: the user tower,
    then K1 over 20,000 seeded unit candidates at d = 256 with decay:30,
    K2 for 1,500, the pool's rows, K3 for 500 (one K1 launch, one top-k
    call of six launches, one K3 launch), against the same step on the
    kernels' plain versions: picks equal but for adjacent swaps of near
    ties, scores within 1e-5."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.flexvec import pem_serve_step_plain
    from repro_torch.configs.recsys_archs import retrieval_step, smoke_data
    from repro_torch.dist.sharding import default_rules
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import recsys as R

    arch = get_arch("two-tower-retrieval")
    cfg = dataclasses.replace(arch.smoke_cfg, tower_mlp=(64, 256))
    rules = default_rules(make_local_mesh("cuda"))
    params = arch._init(cfg, 0, device=cuda)
    batch = {k: v[:1] for k, v in smoke_data(arch.arch_id, cfg, 1,
                                             cuda).items()}
    gen = torch.Generator(device=cuda).manual_seed(22)
    cand = _unit_rows(gen, 20_000, 256, device=cuda)
    days = torch.rand(20_000, generator=gen, device=cuda) * 90

    def counts():
        return pem_score.launches, topk.launches, mmr_select.launches

    before = counts()
    gi, gv = retrieval_step(params, batch, cand, days, cfg, rules)
    launches = tuple(a - c for a, c in zip(counts(), before))
    with torch.no_grad():
        u = R.user_tower(params, batch, cfg, rules).T.contiguous()
    wi, wv = pem_serve_step_plain(cand, days, u, torch.zeros_like(u),
                                  pool=500, over=1500)
    torch.cuda.synchronize()
    assert launches == (1, 6, 1)
    assert gi.shape == (1, 500)
    _assert_same_mmr_ranking(list(zip(gi[0].tolist(), gv[0].tolist())),
                             list(zip(wi[0].tolist(), wv[0].tolist())))


def _dlrm_arch(vocab_cap=None):
    """dlrm-mlperf's arch at its published widths, every vocabulary
    capped at ``vocab_cap`` when one is given."""
    import copy

    from repro_torch.configs import get_arch

    arch = copy.copy(get_arch("dlrm-mlperf"))
    if vocab_cap is not None:
        arch.cfg = dataclasses.replace(arch.cfg, vocab_sizes=tuple(
            min(v, vocab_cap) for v in arch.cfg.vocab_sizes))
    return arch


def _dlrm_serve(arch, params, b, device, shards=4):
    """serve_p99's step (``RecsysArch.build``) over ``params`` on a seeded
    batch of ``b``: (logits, the batch)."""
    import torch.utils._pytree as pytree

    from repro_torch.configs.recsys_archs import smoke_data
    from repro_torch.dist.sharding import AbstractMesh, default_rules

    mesh = AbstractMesh((1, shards), ("data", "model"))
    rules = default_rules(mesh)
    batch = smoke_data(arch.arch_id, arch.cfg, b, device, seed=1)
    spec = arch.build("serve_p99", mesh, rules)
    with torch.no_grad():
        return spec.fn(*pytree.tree_leaves(params), *batch.values()), batch


def test_dlrm_four_shards_on_one_card(cuda):
    """Four row blocks of every table of at least 4,096 rows on cuda:0
    (published widths, vocabularies capped at 65,536): the placed init
    equals the whole one, and serve_p99's logits at 4,096 are bit-equal to
    the whole-table forward's, placed by the init or by ``place``."""
    from repro_torch.dist.sharding import (AbstractMesh, RowShardedTable,
                                           default_rules)
    from repro_torch.models import recsys as R

    arch = _dlrm_arch(65_536)
    whole = R.dlrm_init(arch.cfg, 0, device="cuda:0")
    placed = R.dlrm_init(arch.cfg, 0, device="cuda:0",
                         devices=["cuda:0"] * 4)
    assert sum(isinstance(t, RowShardedTable)
               for t in placed["tables"]) == 15
    for w, t in zip(whole["tables"], placed["tables"]):
        if isinstance(t, RowShardedTable):
            t = torch.cat(t.blocks)
        assert torch.equal(w, t)
    got, batch = _dlrm_serve(arch, placed, 4_096, "cuda:0")
    want, _ = _dlrm_serve(arch, whole, 4_096, "cuda:0")
    again = arch.place(whole, default_rules(AbstractMesh(
        (1, 4), ("data", "model"))), ["cuda:0"] * 4)
    assert torch.equal(got, want)
    assert torch.equal(_dlrm_serve(arch, again, 4_096, "cuda:0")[0], want)


def test_bf16_worker_views_the_codes_on_the_card(cuda):
    """A bf16 shard's resident corpus is the truncated pack_bf16 codes
    viewed as bfloat16, not the f32 rows rounded to nearest."""
    from repro_torch.core.grammar import parse
    from repro_torch.core.segments import pack_bf16
    from repro_torch.dist.procgroup import ShardWorker
    from repro_torch.embed import HashEmbedder

    n, d, now = 4096, 128, 1_770_000_000.0
    mat, days = _sharded_corpus(n, d, 15)
    w = ShardWorker(0, d, engine="hopper", device="cuda", dtype="bf16")
    w.append(np.arange(n), mat, now - days * 86400.0, normalized=True)
    w.local_pass([parse("similar:auth token decay:30", HashEmbedder(d))],
                 [10], now)
    codes, _, _ = w._packed_view(w.store.segments)
    dev = w.backend._device_matrix(codes)
    assert dev.dtype == torch.bfloat16 and dev.device.type == "cuda"
    np.testing.assert_array_equal(
        dev.view(torch.int16).cpu().numpy().view(np.uint16), pack_bf16(mat))
    rounded = torch.from_numpy(mat).to(torch.bfloat16)
    assert not torch.equal(rounded.view(torch.int16).cuda(),
                           dev.view(torch.int16))


# -- the LM family on the card -------------------------------------------------


@pytest.mark.parametrize("arch_id", ["internlm2-1.8b", "granite-moe-1b-a400m"])
def test_lm_engine_equals_sequential_decode_on_the_card(cuda, arch_id):
    """The continuous-batching engine (six requests, three slots) against
    one-request prefill + decode on the card, smoke config, f32 with TF32
    off: token ids equal."""
    from repro_torch.configs import get_arch
    from repro_torch.dist.sharding import AbstractMesh, default_rules
    from repro_torch.models import transformer as T
    from repro_torch.serve.lm_engine import DecodeRequest, LMDecodeEngine

    cfg = get_arch(arch_id).smoke_cfg
    rules = default_rules(AbstractMesh((1, 1), ("data", "model")))
    params = T.init_params(cfg, 0)
    assert params["embed"].device.type == "cuda"
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(3, 9, 6)]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        eng = LMDecodeEngine(cfg, params, rules, n_slots=3, max_ctx=48)
        reqs = [DecodeRequest(prompt=p, max_new_tokens=6) for p in prompts]
        eng.run(list(reqs))
        for p, r in zip(prompts, reqs):
            logits, cache = T.prefill_step(
                params, torch.from_numpy(p)[None].to(cuda), cfg, rules)
            big = T.make_cache(cfg, 1, 48)
            for b, c in zip(big, cache):
                b[:, :, :len(p)] = c
            toks = [int(torch.argmax(logits[0]))]
            for ln in range(len(p), len(p) + 6):
                lg, big = T.decode_step(
                    params, torch.tensor([[toks[-1]]], device=cuda), big, ln,
                    cfg, rules)
                toks.append(int(torch.argmax(lg[0])))
            assert r.tokens == toks
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def test_lm_trainer_on_the_card_resumes_bit_for_bit(cuda, tmp_path):
    """The launcher's trainer at smoke size on the card: the loss falls
    over 8 steps, and a run resumed from step 4's checkpoint ends with
    the uninterrupted run's params bit for bit (deterministic algorithms;
    CUBLAS_WORKSPACE_CONFIG set when the module loads)."""
    import argparse

    from repro_torch.configs import get_arch
    from repro_torch.dist.sharding import AbstractMesh, default_rules
    from repro_torch.launch.train import build_parser, lm_trainer

    arch = get_arch("internlm2-1.8b")
    rules = default_rules(AbstractMesh((1, 1), ("data", "model")))

    def trainer(ckpt_dir=None):
        argv = ["--arch", arch.arch_id, "--steps", "8", "--batch", "4",
                "--seq", "32", "--ckpt-every", "4"]
        args = build_parser().parse_args(argv + (
            ["--ckpt-dir", str(ckpt_dir)] if ckpt_dir else []))
        assert isinstance(args, argparse.Namespace) and args.device == "cuda"
        return lm_trainer(arch, args, rules)

    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        whole = trainer()
        hist = whole.run()["history"]
        assert np.isfinite([h["loss"] for h in hist]).all()
        assert hist[-1]["loss"] < hist[0]["loss"]
        first = trainer(tmp_path)
        first.run(4)
        again = trainer(tmp_path)
        assert again.try_resume() and again.step == 4
        again.run()
    finally:
        torch.use_deterministic_algorithms(det)
    for name, w in whole.params["layers"].items():
        assert torch.equal(w, again.params["layers"][name]), name
    assert torch.equal(whole.params["embed"], again.params["embed"])


# -- four cards: one shard a card (skip on fewer) -----------------------------


@pytest.fixture
def four_cards(cuda):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards; run with -m gpu on a four-card host")
    return [f"cuda:{j}" for j in range(4)]


_NCCL_RANKS = """
import sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, world, store, data, out):
    from repro_torch.dist.pem_sharded import make_pem_topk
    torch.cuda.set_device(rank)
    d = np.load(data)
    n_local = d["corpus"].shape[0] // world
    rows = slice(rank * n_local, (rank + 1) * n_local)
    dist.init_process_group("nccl", init_method="file://" + store,
                            rank=rank, world_size=world)
    try:
        dev = torch.device("cuda", rank)
        i, v = make_pem_topk(int(d["k"]), half_life=30.0)(
            torch.from_numpy(d["corpus"][rows]).to(dev),
            torch.from_numpy(d["days"][rows]).to(dev),
            torch.from_numpy(d["qp"]).to(dev),
            torch.from_numpy(d["qs"]).to(dev))
        np.savez(f"{out}.{rank}.npz", i=i.cpu().numpy(), v=v.cpu().numpy())
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    world = int(sys.argv[1])
    mp.spawn(run, args=(world, *sys.argv[2:5]), nprocs=world, join=True)
"""


def test_make_pem_topk_on_four_nccl_ranks(four_cards, tmp_path):
    """Four NCCL ranks, a card each, a quarter of the rows each: every
    rank returns the one-rank result on one card bit for bit."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.dist.pem_sharded import make_pem_topk

    rng = np.random.default_rng(16)
    n, d, b, k = 400_000, 128, 8, 500
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    days = rng.uniform(0, 120, n).astype(np.float32)
    qp = (rng.standard_normal((d, b)) / d ** 0.5).astype(np.float32)
    qs = (rng.standard_normal((d, b)) * 0.1).astype(np.float32)
    data = tmp_path / "inputs.npz"
    np.savez(data, corpus=corpus, days=days, qp=qp, qs=qs, k=k)
    script = tmp_path / "ranks.py"
    script.write_text(_NCCL_RANKS)
    src = Path(__file__).resolve().parents[1] / "src"
    r = subprocess.run(
        [sys.executable, str(script), "4", str(tmp_path / "store"),
         str(data), str(tmp_path / "out")],
        env=dict(os.environ, PYTHONPATH=str(src)), capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    dev = torch.device("cuda", 0)
    wi, wv = make_pem_topk(k, half_life=30.0)(
        *(torch.from_numpy(a).to(dev) for a in (corpus, days, qp, qs)))
    for rank in range(4):
        got = np.load(f"{tmp_path / 'out'}.{rank}.npz")
        np.testing.assert_array_equal(got["i"], wi.cpu().numpy())
        np.testing.assert_array_equal(got["v"], wv.cpu().numpy())


def test_sharded_backend_one_shard_a_card(four_cards):
    """Four shards on four cards against the monolith on one: ids equal,
    scores bit-equal, diverse plans finished on the lead card."""
    from repro_torch.core.backends import HopperBackend, ShardedBackend
    from repro_torch.core.grammar import parse
    from repro_torch.embed import HashEmbedder

    n, d = 120_001, 128
    mat, days = _sharded_corpus(n, d, 17)
    emb = HashEmbedder(d)
    plans = [parse(t, emb) for t in SHARD_TOKENS]
    ks = [20, 10, 30, 25]
    mask = np.random.default_rng(18).random(n) > 0.1
    backend = ShardedBackend(four_cards)
    got = backend.score_select(mat, days, plans, ks, mask=mask)
    want = HopperBackend("cuda:0").score_select(mat, days, plans, ks,
                                                mask=mask)
    for (gi, gv), (wi, wv) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gv, wv)
    blocks = backend._device_matrix(mat)
    assert [str(block.device) for _, block in blocks] == four_cards


def test_shard_group_one_worker_a_card(four_cards):
    """A process group with one spawned worker a card (the default
    dealing), against the same group's thread workers and the
    fused-numpy monolith."""
    from repro_torch.core.grammar import parse
    from repro_torch.core.vectorcache import VectorCache
    from repro_torch.dist.procgroup import ProcessGroup
    from repro_torch.embed import HashEmbedder

    n, d, now = 40_000, 128, 1_770_000_000.0
    mat, days = _sharded_corpus(n, d, 19)
    ids = np.arange(n, dtype=np.int64)
    ts = now - days.astype(np.float64) * 86400.0
    emb = HashEmbedder(d)
    vc = VectorCache(ids, mat, ts, emb)
    with ProcessGroup.build(ids, mat, ts, normalized=True, n_shards=4,
                            transport="process") as g, \
            ProcessGroup.build(ids, mat, ts, normalized=True, n_shards=4,
                               transport="thread") as t:
        assert g.devices == t.devices == four_cards
        assert [s["device"] for s in g.stats()["shards"]] == four_cards
        for tokens in SHARD_TOKENS:
            plan = parse(tokens, emb)
            got = g.search_plan(plan, now=now)
            assert got == t.search_plan(plan, now=now)
            want = vc.search_plan(plan, now=now, engine="fused-numpy")
            if plan.diverse is None:
                _assert_same_ranking(
                    np.array([i for i, _ in got]),
                    np.array([v for _, v in got], np.float32),
                    np.array([i for i, _ in want]),
                    np.array([v for _, v in want], np.float32))
            else:
                _assert_same_mmr_ranking(got, want)


def test_dlrm_published_tables_one_block_a_card(four_cards):
    """dlrm-mlperf's published tables (96.14 GB) row-sharded one block a
    card: serve_p99's logits at 512 bit-equal to the unsharded forward
    over compact tables of the batch's rows, gathered from the blocks by
    plain indexing."""
    from repro_torch.dist.sharding import (AbstractMesh, RowShardedTable,
                                           default_rules)
    from repro_torch.models import recsys as R

    arch = _dlrm_arch()
    params = R.dlrm_init(arch.cfg, 0, device=four_cards[0],
                         devices=four_cards)
    sharded = [t for t in params["tables"] if isinstance(t, RowShardedTable)]
    assert len(sharded) == 15
    for t in sharded:
        assert [str(b.device) for b in t.blocks] == four_cards
    got, batch = _dlrm_serve(arch, params, 512, four_cards[0])
    tables, cols = [], []
    for i, t in enumerate(params["tables"]):
        u, inv = torch.unique(batch["sparse"][:, i].long(),
                              return_inverse=True)
        if isinstance(t, RowShardedTable):
            rows = torch.stack([t.blocks[j // t.block][j % t.block].to(
                u.device) for j in u.tolist()])
        else:
            rows = t[u]
        tables.append(rows)
        cols.append(inv.to(batch["sparse"].dtype))
    compact = dict(params, tables=tables)
    with torch.no_grad():
        want = R.dlrm_forward(compact, dict(batch, sparse=torch.stack(
            cols, dim=1)), arch.cfg, default_rules(AbstractMesh(
                (1, 4), ("data", "model"))))
    assert torch.equal(got, want)


# -- filtered, hybrid and delta-segment inputs --------------------------------


def test_pem_score_duplicate_rows_bit_equal_in_any_block(cuda):
    """Equal rows score bit-equal on the card whatever block holds them and
    wherever they sit in it: in blocks of 6, 1, 13 and 24 rows, and
    planted at scattered positions of a 50,001-row corpus split into
    shard blocks of unequal length (the sharded path's tie order rests
    on this)."""
    rng = np.random.default_rng(5)
    d, b = 128, 5
    base = rng.standard_normal((8, d)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    mat = torch.from_numpy(np.concatenate([base] * 3)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((d, b)).astype(np.float32)
                         ).to(cuda)
    qs = -0.3 * q
    days = torch.full((24,), 7.0, device=cuda)
    hl = torch.tensor([7.0, 30.0, float("inf"), 14.0, 90.0], device=cuda)
    whole = pem_score(mat, q, qs, days_ago=days, half_lives=hl)
    for lo, hi in ((0, 6), (6, 12), (12, 18), (18, 24), (3, 4), (11, 24)):
        # copies: TMA reads the rows and ages from 16-byte aligned starts
        part = pem_score(mat[lo:hi].clone(), q, qs,
                         days_ago=days[lo:hi].clone(), half_lives=hl)
        assert torch.equal(part, whole[lo:hi])
    assert torch.equal(whole[:8], whole[8:16])
    assert torch.equal(whole[:8], whole[16:])

    n = 50_001
    big = rng.standard_normal((n, d)).astype(np.float32)
    big /= np.linalg.norm(big, axis=1, keepdims=True)
    spots = [0, 97, 12_497, 25_002, 37_500, 49_993]  # two straddle a cut
    for s in spots:
        big[s:s + 8] = base
    big_t = torch.from_numpy(big).to(cuda)
    ages = torch.full((n,), 7.0, device=cuda)
    full = pem_score(big_t, q, qs, days_ago=ages, half_lives=hl)
    want = whole[:8]
    for s in spots:
        assert torch.equal(full[s:s + 8], want)
    for cuts in ((0, 12_501, 25_002, 37_503, n), (0, 9, 30_000, n)):
        for lo, hi in zip(cuts, cuts[1:]):
            part = pem_score(big_t[lo:hi].clone(), q, qs,
                             days_ago=ages[lo:hi].clone(), half_lives=hl)
            assert torch.equal(part, full[lo:hi])


def _filter_sets(n, seed):
    """Candidate sets of every selectivity, one a plan: a sharp 40-row
    set, 10%, 45% with ids the store never saw, none (unfiltered)."""
    rng = np.random.default_rng(seed)
    return [np.sort(rng.choice(n, 40, replace=False)),
            np.flatnonzero(rng.random(n) < 0.10),
            np.concatenate([np.flatnonzero(rng.random(n) < 0.45),
                            [n + 5, n + 9]]),
            None]


def test_hopper_masked_filter_panel_equals_plain(cuda):
    """A heterogeneous-filter cohort through one (N, B) mask panel: one K1
    launch a segment, rankings equal to the plain chain's."""
    from repro_torch.core.backends import (HopperBackend,
                                           score_select_filter_panel)

    store, plans, ks, now = _tombstoned_store_and_plans()
    plans = plans + plans[:1]
    ks = ks + [20]
    sets = _filter_sets(30_000, 3)
    before = pem_score.launches
    got = score_select_filter_panel(HopperBackend("cuda"), store,
                                    store.segments, plans, ks, sets, now=now)
    assert pem_score.launches - before == store.n_segments
    want = score_select_filter_panel(HopperBackend("cpu"), store,
                                     store.segments, plans, ks, sets,
                                     now=now)
    for (gi, gv), (wi, wv) in zip(got, want):
        _assert_same_ranking(gi, gv, wi, wv)


def test_hopper_hybrid_bias_panel_equals_plain(cuda):
    """Plans fusing different keyword legs in one batch: the (N, B) bias
    panel rides the device panel before the mask and top-k."""
    from repro_torch.core.backends import (HopperBackend,
                                           fusion_bias_arrays,
                                           score_select_segments)
    from repro_torch.core.grammar import parse
    from repro_torch.embed import HashEmbedder

    store, _, _, now = _tombstoned_store_and_plans()
    rng = np.random.default_rng(8)

    def lexical(seed):
        ids = np.random.default_rng(seed).choice(30_000, 300, replace=False)
        scores = np.sort(rng.random(300).astype(np.float32))[::-1]
        return lambda text, pool: (ids[:pool].astype(np.int64),
                                   scores[:pool].copy())

    emb = HashEmbedder(128)
    plans = [parse(t, emb, lexical_fn=lexical(s)) for s, t in enumerate((
        "similar:server lifecycle keyword:restart fuse:weighted,0.6",
        "similar:auth token decay:30 keyword:token fuse:weighted,0.3 pool:200",
        "similar:rendering pipeline keyword:frame fuse:weighted,0.8 diverse",
        "similar:database migration decay:14"))]
    ks = [20, 50, 10, 15]
    bias = fusion_bias_arrays(store, store.segments, plans)
    assert bias is not None and all(b.ndim == 2 for b in bias if b is not None)
    got = score_select_segments(HopperBackend("cuda"), store.segments,
                                plans, ks, now=now, score_bias=bias)
    want = score_select_segments(HopperBackend("cpu"), store.segments, plans,
                                 ks, now=now, score_bias=bias)
    for (gi, gv), (wi, wv) in zip(got, want):
        _assert_same_ranking(gi, gv, wi, wv)


def test_hopper_forty_delta_segments_past_the_device_cache(cuda):
    """A store of 40 delta segments, more than the device cache's 32
    entries: every query walks them all (each misses and uploads again),
    and rankings stay equal to the plain chain's."""
    from repro_torch.core.backends import HopperBackend
    from repro_torch.core.grammar import parse
    from repro_torch.core.segments import store_from_arrays
    from repro_torch.core.vectorcache import VectorCache
    from repro_torch.embed import HashEmbedder

    rng = np.random.default_rng(40)
    n, d, now = 40 * 256, 128, 1_770_000_000.0
    mat = rng.standard_normal((n, d)).astype(np.float32)
    mat /= np.linalg.norm(mat, axis=1, keepdims=True)
    ts = now - rng.uniform(0, 90, n) * 86400.0
    live = rng.random(n) > 0.05
    store = store_from_arrays([
        {"ids": np.arange(a, a + 256), "matrix": mat[a:a + 256],
         "timestamps": ts[a:a + 256], "live_mask": live[a:a + 256]}
        for a in range(0, n, 256)])
    assert store.n_segments == 40
    cache = VectorCache(store=store, embed_fn=HashEmbedder(d))
    backend = HopperBackend("cuda")
    tokens = ("similar:how the system works suppress:website design "
              "decay:30 diverse pool:100")
    for _ in range(2):
        before = (pem_score.launches, backend.uploads)
        got = cache.search(tokens, now=now, engine=backend)
        assert pem_score.launches - before[0] == 40
    # the LRU cycle misses on every segment, and the diverse pool's
    # gather uploads again the segments its rows lie in
    assert backend.uploads - before[1] >= 40
    assert backend.device_cache_stats()["entries"] == 32
    want = cache.search(tokens, now=now, engine=HopperBackend("cpu"))
    oracle = cache.search(tokens, now=now, engine="fused")
    _assert_same_ranking(np.array([i for i, _ in got]),
                         np.array([v for _, v in got]),
                         np.array([i for i, _ in want]),
                         np.array([v for _, v in want]))
    assert [i for i, _ in want] == [i for i, _ in oracle]


def test_hopper_diverse_query_on_a_pool_shorter_than_its_bucket(cuda):
    """A sharp filter leaves 37 live rows for a ``diverse pool:500`` query:
    K3 runs on a pool far shorter than its 2048 bucket, through both
    router arms, equal to the plain chain."""
    from repro_torch.core.backends import HopperBackend, PrefilterRouter
    from repro_torch.core.vectorcache import VectorCache
    from repro_torch.embed import HashEmbedder

    store, _, _, now = _tombstoned_store_and_plans()
    rng = np.random.default_rng(37)
    live_ids = store.segments[0].ids[store.segments[0].live_mask]
    cands = np.sort(rng.choice(live_ids, 37, replace=False))
    tokens = ("similar:how the system works decay:30 diverse pool:500")
    for threshold in (0.0, 2.0):  # the masked arm, then the gather arm
        got = {}
        for dev in ("cuda", "cpu"):
            vc = VectorCache(store=store, embed_fn=HashEmbedder(128),
                             prefilter=PrefilterRouter(
                                 mask_threshold=threshold, adaptive=False))
            before = mmr_select.launches
            got[dev] = vc.search(tokens, cands, now=now,
                                 engine=HopperBackend(dev))
            if dev == "cuda":
                assert mmr_select.launches - before == 1
        assert len(got["cuda"]) == 37
        _assert_same_ranking(*(np.array(c) for r in (got["cuda"],
                                                      got["cpu"])
                               for c in zip(*r)))


def _spans_under_the_tracer(monkeypatch, config, mix_name, seed):
    """Eight requests of ``mix_name`` on ``config`` at 20,000 rows under
    the benchmark's ``Tracer``, with spans recording and again with the
    recorder's check patched off: the spans recorded and the two traces'
    summaries, each read against the launch counters' change."""
    import sys
    import time
    import types
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    if str(root / "perfbench") not in sys.path:
        sys.path.insert(0, str(root / "perfbench"))
    import run as bench_run
    from harness import spec, traffic
    from harness.trace import Tracer

    from repro_torch import spans

    bench = spec.load(root)
    built = bench_run.build(root, bench, config, seed, "cuda",
                            {"chunks": 20_000, "sessions": 400})
    mix = spec.traffic(root, mix_name)
    call = built.system.entry(mix)
    stream = traffic.QueryStream(mix, seed)
    queries = [stream.request(i) for i in range(8)]
    for q in queries[:3]:
        call(q)
    torch.cuda.synchronize()

    def traced():
        tracer, records = Tracer(), []
        before = built.system.counters()
        with tracer:
            with tracer.window():
                for q in queries:
                    t0 = time.perf_counter()
                    call(q)
                    records.append(types.SimpleNamespace(
                        start=t0, end=time.perf_counter()))
                torch.cuda.synchronize()
        after = built.system.counters()
        return tracer.read(records, {k: after[k] - before[k] for k in after})

    try:
        monkeypatch.setattr(spans, "RECORDER", spans.Recorder())
        on = traced()
        recorded = spans.snapshot()
        assert sum(s.parent < 0 for s in recorded.spans) == len(queries)
        monkeypatch.setattr(spans, "profiling", lambda: False)
        off = traced()
        assert spans.snapshot() == recorded
    finally:
        built.system.release()
    names = {s.name for s in recorded.spans}
    for summary in (on, off):
        assert 0.0 < summary["busy_s"] <= summary["window_s"]
        assert not names & set(summary["seconds"])
        assert not any("annotation" in op for op in summary["seconds"])
    assert set(on["seconds"]) == set(off["seconds"])
    return recorded


def test_spans_stay_off_the_device_trace(cuda, monkeypatch):
    """Composed queries through ``flex_search`` under the benchmark's
    ``Tracer``, with spans recording and again with the recorder's check
    patched off: the device trace reads a busy time inside its window and
    the same device ops either way, and no span reaches it."""
    recorded = _spans_under_the_tracer(monkeypatch, "corpus_240k",
                                       "sql_composed", 2**31 + 41)
    assert not {"segment_pass", "segment_merge", "segment_mmr"} & {
        s.name for s in recorded.spans}


def test_segment_spans_stay_off_the_device_trace(cuda, monkeypatch):
    """The same on the live store's segmented pass (``live_240k`` cut to
    20,000 rows: 8 segments, 1% tombstoned): its segment spans record,
    8 passes a request, and none reaches the device trace."""
    from repro_torch import spans

    recorded = _spans_under_the_tracer(monkeypatch, "live_240k",
                                       "composed_diverse", 2**31 + 43)
    assert spans.count_per_request(recorded, ["segment_pass"]) == 8
    assert spans.count_per_request(recorded, ["segment_mmr"]) == 1


def test_live_store_matches_the_plain_reference(cuda):
    """The benchmark's ``live_240k`` at its published size (240,000 x 128
    f32 in a base and 7 deltas, 1% tombstoned) through ``VectorCache``
    on the card: the first 64 requests of a seed's ``composed_diverse``
    stream against ``repro_torch.reference_live`` (float64 over the live
    rows of the joined segments), ids equal but for adjacent swaps of
    near MMR ties, relevance within 1e-5; no tombstoned row returned; 8
    K1, 6 K2 (one call over the segment-major panel) and 1 K3 launches a
    request."""
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    if str(root / "perfbench") not in sys.path:
        sys.path.insert(0, str(root / "perfbench"))
    import run as bench_run
    from harness import corpus as C
    from harness import spec, traffic

    from repro_torch.core import grammar
    from repro_torch.core import modulations as M
    from repro_torch.reference_live import LiveReference

    seed = 2**31 + 34
    bench = spec.load(root)
    built = bench_run.build(root, bench, "live_240k", seed, "cuda")
    config, corpus, live = built.config, built.corpus, built.live
    assert [s.n_rows for s in built.system.cache.store.segments] == [
        b - a for a, b in C.segment_bounds(corpus.n, config["segments"])]
    # each row is tombstoned with probability 0.01: about 2,400 of them
    assert corpus.n == 240_000 and 2_200 < int((~live).sum()) < 2_600
    mix = spec.traffic(root, "composed_diverse")
    call = built.system.entry(mix)
    embed = built.system.cache.embed_fn
    stream = traffic.QueryStream(mix, seed)
    tokens = [stream.request(i) for i in range(64)]
    call(tokens[0])
    before = (pem_score.launches, topk.launches, mmr_select.launches)
    try:
        got = [call(t) for t in tokens]
        torch.cuda.synchronize()
        launches = tuple(a - b for a, b in zip(
            (pem_score.launches, topk.launches, mmr_select.launches),
            before))
    finally:
        built.system.release()
    assert launches == (8 * 64, 6 * 64, 64)
    ref = LiveReference([
        {"ids": corpus.ids[a:b], "matrix": corpus.matrix[a:b],
         "timestamps": corpus.timestamps[a:b], "live_mask": live[a:b]}
        for a, b in C.segment_bounds(corpus.n, config["segments"])],
        float(config["now"]))
    k = int(mix["k"])
    for t, rows in zip(tokens, got):
        plan = grammar.parse(t, embed)
        q_pre, q_sup = M.fold_plans([plan])
        ids, scores = ref.search(
            q_pre[:, 0], q_sup[:, 0], plan.decay.half_life_days,
            k=plan.pool, pool=plan.pool, diverse=True, lam=plan.diverse.lam)
        assert len(rows) == k
        assert live[np.asarray([i for i, _ in rows])].all()
        _assert_same_mmr_ranking(
            rows, list(zip(ids[:k].tolist(), scores[:k].tolist())))


def test_live_store_chain_equals_the_loop_on_the_card(cuda):
    """``live_240k`` at its published size, 64 requests of a seed's
    ``composed_diverse`` stream: the general branch as one chain over the
    segment-major panel gives the pass a segment's answers bit for bit
    (ids and score bits), and one request costs 8 K1, 6 K2 and 1 K3
    launches (the loop's: 8, 48, 1), every K1 forming its segment's ages
    from the resident timestamps (8 ``stamped_launches``)."""
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    if str(root / "perfbench") not in sys.path:
        sys.path.insert(0, str(root / "perfbench"))
    import run as bench_run
    from harness import spec, traffic

    from repro_torch.core.backends import HopperBackend

    class LoopHopper(HopperBackend):
        segment_chain = False

    seed = 2**31 + 35
    bench = spec.load(root)
    built = bench_run.build(root, bench, "live_240k", seed, "cuda")
    mix = spec.traffic(root, "composed_diverse")
    stream = traffic.QueryStream(mix, seed)
    tokens = [stream.request(i) for i in range(64)]
    cache, now = built.system.cache, built.system.now
    chain, loop = HopperBackend("cuda"), LoopHopper("cuda")

    def launches():
        return (pem_score.launches, pem_score.stamped_launches,
                topk.launches, mmr_select.launches)

    try:
        for backend in (chain, loop):   # warm each backend's resident cache
            cache.search(tokens[0], now=now, engine=backend)
        counts = {}
        for name, backend in (("chain", chain), ("loop", loop)):
            torch.cuda.synchronize()
            before = launches()
            cache.search(tokens[1], now=now, engine=backend)
            torch.cuda.synchronize()
            counts[name] = tuple(a - b for a, b in zip(launches(), before))
        got = [cache.search(t, now=now, engine=chain) for t in tokens]
        want = [cache.search(t, now=now, engine=loop) for t in tokens]
        assert cache.fused.segment_chains >= 65
        assert cache.fused.segment_loops >= 65
    finally:
        built.system.release()
    assert counts == {"chain": (8, 8, 6, 1), "loop": (8, 8, 48, 1)}
    for g, w in zip(got, want):
        assert [i for i, _ in g] == [i for i, _ in w]
        assert (np.asarray([v for _, v in g], np.float32).view(np.uint32)
                == np.asarray([v for _, v in w], np.float32)
                .view(np.uint32)).all()


@pytest.mark.parametrize("kind", ["cohort", "panel_masks", "masks_and_bias"])
def test_segment_chain_cohorts_equal_the_loop_on_the_card(cuda, kind):
    """A 40,000-row store in ``live_240k``'s proportions (8 segments, 1%
    tombstoned), a cohort of 16 plans mixing half-lives and lambdas, half
    diverse: unmasked (the engine's cohort), under (n, B) candidate
    panels with one segment skipped (the filter batch), and under 1-D
    masks with an (n, B) bias (hybrid).  The chain's answers equal the
    pass a segment's bit for bit."""
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    if str(root / "perfbench") not in sys.path:
        sys.path.insert(0, str(root / "perfbench"))
    from harness import corpus as C
    from harness import spec

    from repro_torch.core import backends as B
    from repro_torch.core import grammar
    from repro_torch.core import modulations as M
    from repro_torch.core.segments import store_from_arrays
    from repro_torch.embed import HashEmbedder

    class LoopHopper(B.HopperBackend):
        segment_chain = False

    n, d, now, batch = 40_000, 128, 1_770_000_000.0, 16
    config = spec.config(root, spec.load(root), "live_240k")
    rng = np.random.default_rng(35)
    m = rng.standard_normal((n, d)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    ts = now - rng.uniform(0.0, 180 * 86400.0, n)
    live = rng.random(n) >= 0.01
    store = store_from_arrays([
        {"ids": np.arange(a, b), "matrix": m[a:b], "timestamps": ts[a:b],
         "live_mask": live[a:b]}
        for a, b in C.segment_bounds(n, config["segments"])])
    embed = HashEmbedder(d)
    topics = ["segment merge", "flash attention", "sql endpoint",
              "device cache"]
    plans = []
    for j in range(batch):
        mods = [f"decay:{(7, 14, 30, 90)[j % 4]}" if j % 5 else "",
                "diverse" if j % 2 else ""]
        plan = grammar.parse(" ".join([f"similar:{topics[j % 4]}"] + mods),
                             embed)
        if plan.diverse is not None:
            plan = dataclasses.replace(plan, diverse=M.DiverseSpec(
                lam=(0.7, 0.3, 0.0, 0.9)[j % 4]))
        plans.append(plan)
    ks = [10 + 7 * j for j in range(batch)]
    kw = {}
    segs = store.segments
    if kind == "panel_masks":
        kw["candidate_masks"] = [
            None if s == 2 else rng.random((seg.n_rows, batch)) < 0.3
            for s, seg in enumerate(segs)]
    elif kind == "masks_and_bias":
        kw["candidate_masks"] = [rng.random(seg.n_rows) < 0.5 for seg in segs]
        bias = []
        for seg in segs:
            b = np.zeros((seg.n_rows, batch), np.float32)
            hit = rng.random(b.shape) < 0.1
            b[hit] = rng.uniform(0.0, 0.5, int(hit.sum()))
            bias.append(b)
        kw["score_bias"] = bias
    got = B.score_select_segments(B.HopperBackend("cuda"), segs, plans, ks,
                                  now=now, cohort=True, **kw)
    want = B.score_select_segments(LoopHopper("cuda"), segs, plans, ks,
                                   now=now, cohort=True, **kw)
    for (gi, gv), (wi, wv) in zip(got, want):
        assert gi.size
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(np.asarray(gv, np.float32).view(
            np.uint32), np.asarray(wv, np.float32).view(np.uint32))
