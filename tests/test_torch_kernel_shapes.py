"""The inputs and launch shapes of the redesigned K2 and K3 on the CPU.

K2 over -inf-masked panels (rows with fewer, exactly and more than K live
keys; the column-major layout a filter batch's ``torch.where`` gives) and
K3 over a batch of pools with mixed lambdas and live counts: the port's
wrappers (their plain versions here, which the card's kernels are held to
exactly) against the Pallas kernels in interpret mode and ``lax.top_k``.
Then K3's launch plan (``kernels/mmr/kernel.plan``) at the H100's figures
(132 SMs, 227 KB of shared memory a CTA, 64K registers an SM, of which
the kernel's 384 threads keep a row of 128 each, and the clusters of each
size the card keeps resident): B = 64 pools of a 2048 bucket at d = 128
in one wave, rows read from global memory only past the on-chip room.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.modulations import mmr_select_np  # noqa: E402
from repro.kernels.mmr.ops import mmr_select as jax_mmr_select  # noqa: E402
from repro.kernels.topk.ops import topk as jax_topk  # noqa: E402
from repro_torch.kernels.mmr import kernel as mmr_kernel  # noqa: E402
from repro_torch.kernels.mmr.ops import NEG, mmr_select  # noqa: E402
from repro_torch.kernels.topk.ops import topk  # noqa: E402

H100 = mmr_kernel.H100


def _masked_panel(rng, n, live_counts):
    """(len(live_counts), n) scores, -inf but at each row's live columns,
    made as HopperBackend masks a filter batch: ``torch.where`` over an
    (N, B) mask's transpose, a column-major panel."""
    b = len(live_counts)
    mask = np.zeros((n, b), bool)
    for r, live in enumerate(live_counts):
        mask[rng.choice(n, live, replace=False), r] = True
    panel = rng.standard_normal((b, n)).astype(np.float32)
    return torch.where(torch.from_numpy(mask).T, torch.from_numpy(panel),
                       float("-inf"))


@pytest.mark.parametrize("k", [64, 200])
def test_topk_masked_panel_matches_pallas_and_lax(k):
    """Rows below, at and above k live keys (and a fully masked row), in
    the filter batch's column-major layout: values and indices equal to
    ``lax.top_k``'s, values to the Pallas kernel's; -inf ties go to the
    smallest columns."""
    rng = np.random.default_rng(k)
    n = 3000
    live = [5, k - 1, k, k + 1, 0, 700, n]
    s = _masked_panel(rng, n, live)
    assert s.stride() == (1, len(live))  # column-major, as the card sees it
    v, i = topk(s, k)
    want_v, want_i = jax.lax.top_k(jnp.asarray(s.contiguous().numpy()), k)
    np.testing.assert_array_equal(v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    vk, _ = jax_topk(jnp.asarray(s.contiguous().numpy()), k, interpret=True,
                     block_n=512)
    np.testing.assert_array_equal(v.numpy(), np.asarray(vk))
    for r, c in enumerate(live):
        got = i.numpy()[r]
        assert len(set(got.tolist())) == k
        if c < k:  # the k - c ties at -inf are the smallest masked columns
            masked = np.flatnonzero(~np.isfinite(s[r].numpy()))[:k - c]
            np.testing.assert_array_equal(np.sort(got[c:]), masked)


def test_mmr_batch_of_pools_mixed_lambdas_matches_pallas():
    """Ten pools in one call, each with its own lambda and live count
    (padding rel = NEG past it), against the Pallas kernel in interpret
    mode run per lambda on that lambda's pools, and ``mmr_select_np``."""
    rng = np.random.default_rng(27)
    b, n, d, k = 10, 160, 32, 24
    lams = np.array([0.7, 0.0, 1.0, 0.3, 0.7, 0.5, 0.0, 0.9, 0.7, 1.0],
                    np.float32)
    lives = [160, 24, 100, 30, 159, 64, 140, 25, 90, 120]
    e = rng.standard_normal((b, n, d)).astype(np.float32)
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    rel = rng.standard_normal((b, n)).astype(np.float32)
    for r, live in enumerate(lives):
        rel[r, live:] = NEG
    idx, val = mmr_select(torch.from_numpy(e), torch.from_numpy(rel), k,
                          torch.from_numpy(lams))
    for lam in np.unique(lams):
        rows = np.flatnonzero(lams == lam)
        ik, vk = jax_mmr_select(jnp.asarray(e[rows]), jnp.asarray(rel[rows]),
                                k, float(lam), interpret=True)
        np.testing.assert_array_equal(idx.numpy()[rows], np.asarray(ik))
        np.testing.assert_allclose(val.numpy()[rows], np.asarray(vk),
                                   atol=1e-5)
    for r, live in enumerate(lives):
        np.testing.assert_array_equal(
            idx.numpy()[r],
            mmr_select_np(e[r, :live], rel[r, :live], k, float(lams[r])))


def test_mmr_plan_runs_flexvec_batch_in_one_wave():
    """B = 64 pools of 1500 live rows in a 2048 bucket, d = 128: 2 CTAs a
    query on 128 of the 132 SMs, every live row on chip (384 in
    registers, one a thread, and at least 366 in shared memory a CTA)."""
    p = mmr_kernel.plan(64, 2048, 128, live=1500, **H100)
    assert p["cluster"] == 2 and p["waves"] == 1
    assert 64 * p["cluster"] <= 132
    assert p["reg_rows"] == 384 and p["smem_rows"] >= 750 - 384
    assert p["global_rows"] == 0
    assert p["smem_bytes"] <= H100["smem_optin"] - H100["static_smem"]


@pytest.mark.parametrize("live,global_rows", [(1500, 0), (1574, 0),
                                              (1576, 1), (2048, 237)])
def test_mmr_plan_reads_global_rows_only_past_capacity(live, global_rows):
    """At B = 64 a CTA holds 787 rows on chip: rows come from global
    memory only once a query's live rows pass 2 x 787."""
    p = mmr_kernel.plan(64, 2048, 128, live=live, **H100)
    assert p["reg_rows"] + p["smem_rows"] == 787 and p["waves"] == 1
    assert p["global_rows"] == global_rows


@pytest.mark.parametrize("b,cluster", [(1, 16), (7, 16), (8, 8), (15, 8),
                                       (16, 4), (30, 4), (31, 2), (64, 2),
                                       (66, 2), (67, 1), (132, 1)])
def test_mmr_plan_widest_cluster_in_one_wave(b, cluster):
    """The widest cluster up to 16 whose clusters the card keeps resident
    B at once (7 of 16 CTAs, 15 of 8, 30 of 4, 66 of 2 on the H100), so
    every query is resident at once."""
    p = mmr_kernel.plan(b, 2048, 128, **H100)
    assert p["cluster"] == cluster and p["waves"] == 1


def test_mmr_plan_past_the_card_takes_waves():
    p = mmr_kernel.plan(200, 2048, 128, live=1500, **H100)
    assert p["cluster"] == 1 and p["waves"] == 2
    assert p["global_rows"] == 1500 - 384 - p["smem_rows"]


@pytest.mark.parametrize("n", [8192, 25000])
def test_mmr_plan_state_sets_the_narrowest_cluster(n):
    """A slot's 12 bytes of state stay within half the shared memory
    that the buffers leave: a pool of 25000 (MAX_POOL) takes at least 4
    CTAs a query, also at a batch wide enough for one CTA a query."""
    p = mmr_kernel.plan(132, n, 128, **H100)
    state = mmr_kernel.STATE_BYTES * -(-n // p["cluster"])
    assert state <= (H100["smem_optin"] - H100["static_smem"]) // 2
    assert p["cluster"] == (1 if n == 8192 else 4)
    assert p["smem_bytes"] <= H100["smem_optin"] - H100["static_smem"]


@pytest.mark.parametrize("b,d,reg", [(64, 128, 384), (64, 32, 0),
                                     (64, 132, 0), (64, 256, 0),
                                     (1, 128, 0), (8, 256, 0)])
def test_mmr_plan_register_rows_only_where_shared_memory_falls_short(b, d,
                                                                    reg):
    """A thread keeps one row in registers (128 of them, 384 threads) only
    where d <= 128 and a CTA's share of the bucket does not fit in shared
    memory: flexvec's B = 64 at d = 128, not at d = 32, nor B = 1's 128
    slots a CTA (256 threads)."""
    p = mmr_kernel.plan(b, 2048, d, **H100)
    assert p["reg_rows"] == reg
    assert p["smem_bytes"] <= H100["smem_optin"] - H100["static_smem"]
    if reg == 0:
        assert p["smem_rows"] == -(-2048 // p["cluster"]) or d > 128


def test_mmr_plan_given_cluster_is_kept():
    p = mmr_kernel.plan(1, 2048, 128, live=1500, cluster=2, **H100)
    assert p["cluster"] == 2 and p["global_rows"] == 0
