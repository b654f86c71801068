"""The port's kernel wrappers against the reference package's kernels.

On the CPU each wrapper in ``repro_torch.kernels`` runs its plain PyTorch
version (the CUDA kernels themselves are held against those on the card,
tests/test_torch_gpu.py and chip_smoke.py).  Here the same seeded numpy
inputs go through the Pallas kernels in interpret mode, their jnp
oracles and ``mmr_select_np``, reusing the sweeps of tests/test_kernels.py.
Scores agree to 1e-5 in f32 and 2e-2 with a bf16 corpus (bf16 inputs,
f32 accumulation, summed in another order); selections agree exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.backends import _decay_column as r_decay_column  # noqa: E402
from repro.core.modulations import mmr_select_np  # noqa: E402
from repro.kernels.mmr.ops import mmr_select as jax_mmr_select  # noqa: E402
from repro.kernels.mmr.ref import mmr_ref as jax_mmr_ref  # noqa: E402
from repro.kernels.pem_score.ops import pem_score as jax_pem_score  # noqa: E402
from repro.kernels.topk.ops import topk as jax_topk  # noqa: E402
from repro.kernels.topk.ref import topk_ref as jax_topk_ref  # noqa: E402
from repro_torch.kernels.mmr.ops import NEG, mmr_select  # noqa: E402
from repro_torch.kernels.pem_score.ops import pem_score  # noqa: E402
from repro_torch.kernels.pem_score.ref import decay_factors  # noqa: E402
from repro_torch.kernels.topk.ops import topk  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _unit_rows(rng, *shape):
    e = rng.standard_normal(shape).astype(np.float32)
    return e / np.linalg.norm(e, axis=-1, keepdims=True)


@pytest.mark.parametrize("n", [100, 1000, 2049])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_decay", [True, False])
def test_pem_score_matches_pallas(n, d, b, dtype, with_decay):
    rng = np.random.default_rng(n * 7 + d + b)
    jdt, tdt, tol = DTYPES[dtype]
    m = _unit_rows(rng, n, d)
    qp = rng.standard_normal((d, b)).astype(np.float32)
    qs = (rng.standard_normal((d, b)) * 0.3).astype(np.float32)
    decay = ((1.0 / (1.0 + rng.random(n) * 10)).astype(np.float32)
             if with_decay else None)
    want = jax_pem_score(jnp.asarray(m, jdt), jnp.asarray(qp), jnp.asarray(qs),
                         None if decay is None else jnp.asarray(decay),
                         interpret=True, block_n=256, block_b=128)
    got = pem_score(torch.from_numpy(m).to(tdt), torch.from_numpy(qp),
                    torch.from_numpy(qs),
                    None if decay is None else torch.from_numpy(decay))
    assert got.shape == (n, b) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def test_pem_score_writes_a_transposed_view():
    """out= takes the (N, B) scores into a (B, N) panel's transpose, the
    layout the backend hands to top-k."""
    rng = np.random.default_rng(3)
    m = torch.from_numpy(_unit_rows(rng, 300, 32))
    qp = torch.from_numpy(rng.standard_normal((32, 4)).astype(np.float32))
    qs = torch.zeros((32, 4))
    panel = torch.full((4, 300), float("nan"))
    pem_score(m, qp, qs, None, out=panel.T)
    np.testing.assert_allclose(panel.numpy(), (m @ qp).T.numpy(), atol=1e-5)


HALF_LIVES = [7.0, np.inf, 21.0, 30.0, 0.3]


@pytest.mark.parametrize("n,d,b", [(300, 32, 5), (1000, 64, 7),
                                   (2049, 128, 10)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pem_score_half_lives_match_pallas_group_by_group(n, d, b, dtype):
    """The per-plan form (days_ago, half_lives) in one call equals the
    Pallas kernel run once per half-life group with that group's decay
    column, column for column (+inf half-life: the kernel's no-decay
    call)."""
    rng = np.random.default_rng(n + d + b)
    jdt, tdt, tol = DTYPES[dtype]
    m = _unit_rows(rng, n, d)
    qp = rng.standard_normal((d, b)).astype(np.float32)
    qs = (rng.standard_normal((d, b)) * 0.3).astype(np.float32)
    days = rng.uniform(0.0, 90.0, n).astype(np.float32)
    hl = np.array([HALF_LIVES[j % len(HALF_LIVES)] for j in range(b)],
                  np.float32)
    got = pem_score(torch.from_numpy(m).to(tdt), torch.from_numpy(qp),
                    torch.from_numpy(qs), days_ago=torch.from_numpy(days),
                    half_lives=torch.from_numpy(hl)).numpy()
    for h in np.unique(hl):
        cols = np.flatnonzero(hl == h)
        decay = (None if np.isinf(h) else
                 jnp.asarray(r_decay_column(days, float(h))))
        want = jax_pem_score(jnp.asarray(m, jdt), jnp.asarray(qp[:, cols]),
                             jnp.asarray(qs[:, cols]), decay,
                             interpret=True, block_n=256, block_b=128)
        np.testing.assert_allclose(got[:, cols], np.asarray(want), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("half_life", [7.0, 14.0, 21.0, 30.0, 90.0, 0.3])
def test_decay_factors_are_bit_equal_to_the_reference_column(half_life):
    """The per-plan factor (computed on the card in the kernel's epilogue
    with correctly rounded f32 operations) equals the reference's numpy
    ``_decay_column`` bit for bit; +inf gives exactly 1."""
    rng = np.random.default_rng(int(half_life * 10))
    days = np.concatenate([rng.uniform(0.0, 400.0, 20_000),
                           [0.0, 1e-3, 1e6]]).astype(np.float32)
    hl = np.array([half_life, np.inf], np.float32)
    got = decay_factors(torch.from_numpy(days), torch.from_numpy(hl)).numpy()
    want = np.asarray(r_decay_column(days, half_life), np.float32)
    assert want.dtype == np.float32
    np.testing.assert_array_equal(got[:, 0].view(np.uint32),
                                  want.view(np.uint32))
    assert np.all(got[:, 1] == 1.0)


def test_pem_score_decay_forms_are_exclusive():
    m = torch.zeros((10, 8))
    q = torch.zeros((8, 2))
    ts = torch.zeros(10, dtype=torch.float64)
    with pytest.raises(ValueError, match="exclusive"):
        pem_score(m, q, q, torch.ones(10), days_ago=torch.zeros(10),
                  half_lives=torch.ones(2))
    with pytest.raises(ValueError, match="together"):
        pem_score(m, q, q, days_ago=torch.zeros(10))
    # the timestamps form: with neither other form, now and half-lives
    # with it, float64
    with pytest.raises(ValueError, match="exclusive"):
        pem_score(m, q, q, torch.ones(10), timestamps=ts, now=1.0,
                  half_lives=torch.ones(2))
    with pytest.raises(ValueError, match="exclusive"):
        pem_score(m, q, q, days_ago=torch.zeros(10), timestamps=ts, now=1.0,
                  half_lives=torch.ones(2))
    with pytest.raises(ValueError, match="together"):
        pem_score(m, q, q, timestamps=ts, half_lives=torch.ones(2))
    with pytest.raises(ValueError, match="together"):
        pem_score(m, q, q, timestamps=ts, now=1.0)
    with pytest.raises(ValueError, match="float64"):
        pem_score(m, q, q, timestamps=ts.float(), now=1.0,
                  half_lives=torch.ones(2))


def test_ages_from_stamps_are_the_hosts_bit_for_bit():
    """The plain version's ages from timestamps equal the host's
    ``CorpusSegment.days_ago`` bit for bit over planted f32 ties and
    boundaries, rows newer than ``now``, decades and a NaN; so its
    timestamps form scores as its ``days_ago`` form fed the host's
    ages, and, launching nothing, counts nothing."""
    from repro_torch.kernels.pem_score.ref import ages_from_stamps
    from stamp_cases import NOW, host_ages, planted_stamps, same_bits_or_nan

    ts = planted_stamps(8_001, seed=37)
    want = host_ages(ts)
    same_bits_or_nan(ages_from_stamps(torch.from_numpy(ts), NOW).numpy(),
                     want)
    rng = np.random.default_rng(37)
    m = torch.from_numpy(_unit_rows(rng, ts.size, 32))
    qp = torch.from_numpy(rng.standard_normal((32, 6)).astype(np.float32))
    qs = torch.from_numpy(rng.standard_normal((32, 6)).astype(np.float32))
    hl = torch.tensor([7.0, 14.0, 30.0, 90.0, np.inf, 0.3])
    before = (pem_score.launches, pem_score.stamped_launches)
    got = pem_score(m, qp, qs, timestamps=torch.from_numpy(ts), now=NOW,
                    half_lives=hl)
    assert (pem_score.launches, pem_score.stamped_launches) == before
    same_bits_or_nan(got.numpy(), pem_score(
        m, qp, qs, days_ago=torch.from_numpy(want), half_lives=hl).numpy())


def _check_topk(s: np.ndarray, k: int, block_n: int):
    vk, ik = jax_topk(jnp.asarray(s), k, interpret=True, block_n=block_n)
    vr, ir = jax_topk_ref(jnp.asarray(s), k)
    v, i = topk(torch.from_numpy(s), k)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(v.numpy(), np.asarray(vr))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ir))
    np.testing.assert_array_equal(v.numpy(), np.asarray(vk))
    # the Pallas kernel's running buffer starts at (-inf, -1), so its -inf
    # ties keep index -1; lax.top_k (above) is the rule for those
    live = np.isfinite(np.asarray(vk))
    np.testing.assert_array_equal(i.numpy()[live], np.asarray(ik)[live])
    for row in i.numpy():
        assert len(set(row.tolist())) == len(row)


@pytest.mark.parametrize("n,k", [(1000, 1), (1000, 37), (5000, 500),
                                 (100, 100)])
def test_topk_matches_pallas(n, k):
    rng = np.random.default_rng(n + k)
    _check_topk(rng.standard_normal((4, n)).astype(np.float32), k, 512)


def test_topk_ties_go_to_the_smallest_index():
    s = np.tile(np.array([-1.0, 3.0, 3.0, -5.0, 0.0], np.float32), (2, 40))
    _check_topk(s, 10, 128)


def test_topk_masked_rows_and_neg_inf_padding():
    """-inf masked entries tie among themselves: smallest index first,
    also when k reaches past the live entries."""
    rng = np.random.default_rng(11)
    s = rng.standard_normal((4, 300)).astype(np.float32)
    s[0, :] = -np.inf                 # a fully masked row
    s[1, ::2] = -np.inf               # half masked
    s[2, 250:] = -np.inf              # masked tail
    s[3, :] = np.round(s[3, :])       # heavy ties
    _check_topk(s, 200, 128)


MMR_SWEEP = [(64, 8, 32), (200, 50, 128), (300, 17, 64)]


@pytest.mark.parametrize("n,k,d", MMR_SWEEP)
@pytest.mark.parametrize("lam", [0.7, 0.0, 1.0])
def test_mmr_matches_pallas_ref_and_numpy(n, k, d, lam):
    rng = np.random.default_rng(n + k + d)
    e = _unit_rows(rng, 2, n, d)
    rel = rng.standard_normal((2, n)).astype(np.float32)
    idx, _ = mmr_select(torch.from_numpy(e), torch.from_numpy(rel), k, lam)
    ik, _ = jax_mmr_select(jnp.asarray(e), jnp.asarray(rel), k, lam,
                           interpret=True)
    ir, _ = jax_mmr_ref(jnp.asarray(e), jnp.asarray(rel), k, lam)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ik))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ir))
    for b in range(2):
        np.testing.assert_array_equal(idx.numpy()[b],
                                      mmr_select_np(e[b], rel[b], k, lam))


@pytest.mark.parametrize("lam", [0.7, 0.0, 1.0])
def test_mmr_neg_padding_is_never_selected(lam):
    """Slots with rel = NEG are padding at every lambda (lam = 0 zeroes
    the relevance term, the masking after the blend keeps them out)."""
    rng = np.random.default_rng(5)
    n, live, k, d = 96, 70, 40, 32
    e = _unit_rows(rng, 2, n, d)
    rel = rng.standard_normal((2, n)).astype(np.float32)
    rel[:, live:] = NEG
    idx, _ = mmr_select(torch.from_numpy(e), torch.from_numpy(rel), k, lam)
    ik, _ = jax_mmr_select(jnp.asarray(e), jnp.asarray(rel), k, lam,
                           interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ik))
    assert idx.numpy().max() < live
    for b in range(2):
        np.testing.assert_array_equal(
            idx.numpy()[b], mmr_select_np(e[b, :live], rel[b, :live], k, lam))


def test_mmr_lambda_vector_equals_per_row_scalars():
    rng = np.random.default_rng(9)
    e = torch.from_numpy(_unit_rows(rng, 3, 80, 16))
    rel = torch.from_numpy(rng.standard_normal((3, 80)).astype(np.float32))
    lams = [0.7, 0.0, 1.0]
    idx, val = mmr_select(e, rel, 12, torch.tensor(lams))
    for b, lam in enumerate(lams):
        ib, vb = mmr_select(e[b:b + 1], rel[b:b + 1], 12, lam)
        np.testing.assert_array_equal(idx[b].numpy(), ib[0].numpy())
        # a batched and a single product sum in different orders
        np.testing.assert_allclose(val[b].numpy(), vb[0].numpy(), atol=1e-6)


def _adversarial_scores(case: str) -> tuple:
    """(scores (4, n) f32, k) for one adversarial top-k case: the inputs
    the radix select's tie handling has to get right on the card."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "full_row_ties":
        s = np.full((4, 600), 0.25, np.float32)
        s[1] = -np.inf                        # a fully masked row
        s[2] = 0.0
        s[3, ::2] = -0.0                      # signed zeros tie as well
        return s, 130
    if case == "k_above_live":
        s = np.full((4, 500), -np.inf, np.float32)
        for r in range(4):
            live = rng.choice(500, 20 + 10 * r, replace=False)
            s[r, live] = rng.standard_normal(live.size)
        return s, 64
    if case == "quantized_boundary":
        s = (np.floor(rng.random((4, 1000)) * 16) / 16).astype(np.float32)
        return s, 150  # about 60 ties a level: the 150th key sits in one
    if case == "signed_zeros_boundary":
        s = np.full((4, 400), -1.0, np.float32)
        s[:, :50] = rng.random((4, 50)) + 0.1
        s[:, 50:93] = 0.0                     # the 100th key is a -0.0
        s[:, 93:150] = -0.0
        return s[:, rng.permutation(400)], 100
    assert case == "n_not_multiple_of_8"
    s = rng.standard_normal((4, 1003)).astype(np.float32)
    s[0, ::7] = -np.inf
    return s, 77


@pytest.mark.parametrize("case", ["full_row_ties", "k_above_live",
                                  "quantized_boundary", "signed_zeros_boundary",
                                  "n_not_multiple_of_8"])
def test_topk_adversarial_ties_match_pallas(case):
    """The plain version, which the card's radix select is held to, against
    lax.top_k and the Pallas kernel on inputs full of ties."""
    s, k = _adversarial_scores(case)
    _check_topk(s, k, 128)


def _adversarial_pool(case: str) -> tuple:
    """(embeds (2, n, d), rel (2, n), k) for one adversarial MMR case."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "full_ties":  # equal relevance, identical rows: every step ties
        e = np.tile(_unit_rows(rng, 1, 1, 16), (2, 40, 1))
        return e, np.full((2, 40), 0.5, np.float32), 12
    if case == "quantized_rel":
        e = _unit_rows(rng, 2, 150, 32)
        return e, (np.floor(rng.random((2, 150)) * 4) / 4).astype(np.float32), 30
    if case == "whole_pool":
        e = _unit_rows(rng, 2, 40, 8)
        return e, rng.standard_normal((2, 40)).astype(np.float32), 40
    assert case == "n_not_multiple_of_8"
    e = _unit_rows(rng, 2, 203, 24)
    return e, rng.standard_normal((2, 203)).astype(np.float32), 50


@pytest.mark.parametrize("lam", [0.7, 0.0, 1.0])
@pytest.mark.parametrize("case", ["full_ties", "quantized_rel", "whole_pool",
                                  "n_not_multiple_of_8"])
def test_mmr_adversarial_ties_match_pallas(case, lam):
    """The plain version, which the card's cluster kernel is held to,
    against the Pallas kernel, its jnp oracle and mmr_select_np where ties
    decide every pick."""
    e, rel, k = _adversarial_pool(case)
    idx, val = mmr_select(torch.from_numpy(e), torch.from_numpy(rel), k, lam)
    ik, vk = jax_mmr_select(jnp.asarray(e), jnp.asarray(rel), k, lam,
                            interpret=True)
    ir, _ = jax_mmr_ref(jnp.asarray(e), jnp.asarray(rel), k, lam)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ik))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ir))
    np.testing.assert_allclose(val.numpy(), np.asarray(vk), atol=1e-5)
    for b in range(2):
        np.testing.assert_array_equal(idx.numpy()[b],
                                      mmr_select_np(e[b], rel[b], k, lam))
