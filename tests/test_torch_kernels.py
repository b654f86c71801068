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

from repro.core.modulations import mmr_select_np  # noqa: E402
from repro.kernels.mmr.ops import mmr_select as jax_mmr_select  # noqa: E402
from repro.kernels.mmr.ref import mmr_ref as jax_mmr_ref  # noqa: E402
from repro.kernels.pem_score.ops import pem_score as jax_pem_score  # noqa: E402
from repro.kernels.topk.ops import topk as jax_topk  # noqa: E402
from repro.kernels.topk.ref import topk_ref as jax_topk_ref  # noqa: E402
from repro_torch.kernels.mmr.ops import NEG, mmr_select  # noqa: E402
from repro_torch.kernels.pem_score.ops import pem_score  # noqa: E402
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
