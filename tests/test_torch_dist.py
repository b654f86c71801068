"""Sharded scoring in the port against the reference package, on the CPU.

``repro_torch.dist.pem_sharded`` and ``ShardedBackend(["cpu"] * S)`` run
the kernels' plain versions on S row shards; the reference's
``pem_topk_reference``, its ``sharded`` backend (one host device here),
``jit-jax`` and ``fused-numpy`` see the same seeded numpy inputs and the
same token strings (each package parses them with its own, bit-identical
``HashEmbedder``).  Indices must be equal, scores within 1e-5 (f32
products summed in another order), for S = 1..4 shards, with exact ties
planted across every shard boundary (one-hot rows with equal ages: their
scores tie in any order of summation), a shard with no live row, (N,) and
(N, B) masks, a hybrid bias, and diverse plans through the payload merge
and the MMR kernel's plain version at lambda 0, 0.3, 0.7 and 1.  The
collective form runs on 2 and 4 gloo CPU ranks in a subprocess.  Rows
repeated three times tie exactly whatever shard block holds them, so MMR
picks the first occurrence at S = 1..4, as the reference's sharded backend
does over as many forced host devices (also in a subprocess).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import backends as RB  # noqa: E402
from repro.core import modulations as RM  # noqa: E402
from repro.core.grammar import parse as r_parse  # noqa: E402
from repro.core.segments import SegmentedCorpusStore  # noqa: E402
from repro.dist.pem_sharded import pem_topk_reference as r_pem_topk  # noqa: E402
from repro.embed import HashEmbedder as RHash  # noqa: E402
from repro_torch.core import backends as TB  # noqa: E402
from repro_torch.core import modulations as TM  # noqa: E402
from repro_torch.core.grammar import parse as t_parse  # noqa: E402
from repro_torch.core.segments import store_from_arrays  # noqa: E402
from repro_torch.dist import pem_sharded as TP  # noqa: E402
from repro_torch.embed import HashEmbedder as THash  # noqa: E402
from repro_torch.kernels.pem_score.ops import pem_score  # noqa: E402
from repro_torch.kernels.topk.ops import topk  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
D = 32
N = 230
NOW = 90 * 86400.0
TOL = 1e-5
TOKENS = [
    "similar:how the retrieval system works",
    "similar:how the retrieval system works decay:21",
    "similar:auth token flow suppress:website landing page",
    "similar:rendering pipeline from:prototype sketch to:production deployment",
    "similar:how the retrieval system works decay:7 diverse pool:20",
    "similar:database migration suppress:marketing copy diverse pool:15",
]
KS = [7, 10, 5, 9, 6, 8]
SHARDS = [1, 2, 3, 4]


def _boundary_rows(n, shards=(2, 3, 4)):
    """Rows on both sides of every shard boundary of ``ShardedBackend``'s
    ceil(n / S) split, for each S."""
    rows = set()
    for s in shards:
        step = -(-n // s)
        for b in range(1, s):
            rows |= {b * step - 1, b * step}
    return sorted(r for r in rows if r < n)


def _corpus(n=N, seed=7, ties=True):
    """Unit rows and ages; with ``ties`` the boundary rows are one one-hot
    vector, on the axis the first plan's query weighs most, with age 0."""
    rng = np.random.default_rng(seed)
    mat = rng.standard_normal((n, D)).astype(np.float32)
    mat /= np.linalg.norm(mat, axis=1, keepdims=True)
    days = rng.uniform(0.0, 60.0, n).astype(np.float32)
    if ties:
        axis = int(np.argmax(THash(D)(TOKENS[0].split(":", 1)[1])))
        for r in _boundary_rows(n):
            mat[r] = 0.0
            mat[r, axis] = 1.0
            days[r] = 0.0
    return mat, days, rng


def _plans(lam=None):
    r = [r_parse(t, RHash(D)) for t in TOKENS]
    t = [t_parse(t, THash(D)) for t in TOKENS]
    if lam is not None:
        r[-1] = dataclasses.replace(r[-1], diverse=RM.DiverseSpec(lam=lam))
        t[-1] = dataclasses.replace(t[-1], diverse=TM.DiverseSpec(lam=lam))
    return r, t


def _assert_same(got, want):
    assert len(got) == len(want)
    for (gi, gv), (wi, wv) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))
        np.testing.assert_allclose(np.asarray(gv, np.float32),
                                   np.asarray(wv, np.float32), atol=TOL)


def _mask(kind, rng, n, b, shards):
    if kind == "none":
        return None
    if kind == "shared":
        return rng.random(n) > 0.3
    if kind == "panel":
        return rng.random((n, b)) > 0.4
    # "dead shard": the second shard holds no live row (at S = 1, the
    # second half of the one shard), the rest keep 80%.  A batch with no
    # live row at all is left out: its -inf padding has no order callers
    # read, and the reference's device-MMR graph fills it with row 0
    m = rng.random(n) > 0.2
    step = -(-n // max(shards, 2))
    m[step:2 * step] = False
    return m


# -- pem_sharded --------------------------------------------------------------


def _pem_inputs(n=1020, d=32, b=4, seed=3):
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    days = rng.uniform(0, 60, n).astype(np.float32)
    qp = rng.standard_normal((d, b)).astype(np.float32)
    qs = rng.standard_normal((d, b)).astype(np.float32)
    # exact ties across every boundary of 2, 3 and 4 equal shards: one-hot
    # rows on the axis every query weighs most, equal ages
    qp[5] = 20.0
    for r in _boundary_rows(n):
        corpus[r] = 0.0
        corpus[r, 5] = 1.0
        days[r] = 10.0
    return corpus, days, qp, qs


def _jax_reference(corpus, days, qp, qs, k, half_life=30.0):
    i, v = r_pem_topk(jnp.asarray(corpus), jnp.asarray(days),
                      jnp.asarray(qp), jnp.asarray(qs), k,
                      half_life=half_life)
    return np.asarray(i), np.asarray(v)


def test_pem_topk_reference_matches_jax():
    corpus, days, qp, qs = _pem_inputs()
    wi, wv = _jax_reference(corpus, days, qp, qs, 40)
    gi, gv = TP.pem_topk_reference(
        torch.from_numpy(corpus), torch.from_numpy(days),
        torch.from_numpy(qp), torch.from_numpy(qs), 40, half_life=30.0)
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_allclose(gv.numpy(), wv, atol=TOL)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("k", [40, 300])
def test_merge_shard_major_matches_jax_reference(shards, k):
    """Each shard's local top-k (the kernels' plain versions), stacked
    shard-major and merged, equals the reference's unsharded top-k, tie
    order across the boundaries included; the payload rides along."""
    corpus, days, qp, qs = _pem_inputs()
    n, b = corpus.shape[0], qp.shape[1]
    n_local = n // shards
    cand_v, cand_i, cand_p = [], [], []
    for s in range(shards):
        rows = slice(s * n_local, (s + 1) * n_local)
        block = torch.from_numpy(corpus[rows])
        panel = torch.empty((b, n_local))
        pem_score(block, torch.from_numpy(qp), torch.from_numpy(qs),
                  days_ago=torch.from_numpy(days[rows]),
                  half_lives=torch.full((b,), 30.0), out=panel.T)
        v, i = topk(panel, min(k, n_local))
        cand_v.append(v)
        cand_i.append(i.long() + s * n_local)
        cand_p.append(block[i.long()])
    gi, gv, gp = TP.merge_shard_major(torch.stack(cand_v),
                                      torch.stack(cand_i), k,
                                      torch.stack(cand_p))
    wi, wv = _jax_reference(corpus, days, qp, qs, k)
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_allclose(gv.numpy(), wv, atol=TOL)
    np.testing.assert_array_equal(gp.numpy(), corpus[gi.numpy()])
    tied = [r for r in gi[0].tolist() if r in set(_boundary_rows(n))]
    assert tied == _boundary_rows(n)  # all of them, in row order


def test_make_pem_topk_without_a_group_is_one_rank():
    corpus, days, qp, qs = _pem_inputs()
    fn = TP.make_pem_topk(64, half_life=21.0)
    gi, gv = fn(*(torch.from_numpy(a) for a in (corpus, days, qp, qs)))
    wi, wv = _jax_reference(corpus, days, qp, qs, 64, half_life=21.0)
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_allclose(gv.numpy(), wv, atol=TOL)


_RANKS = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, world, store, data, out):
        from repro_torch.dist.pem_sharded import (make_pem_topk,
                                                  union_merge_topk_payload)
        d = np.load(data)
        n_local = d["corpus"].shape[0] // world
        rows = slice(rank * n_local, (rank + 1) * n_local)
        dist.init_process_group("gloo", init_method="file://" + store,
                                rank=rank, world_size=world)
        try:
            local = [torch.from_numpy(d[k][rows]) for k in ("corpus", "days")]
            qp, qs = torch.from_numpy(d["qp"]), torch.from_numpy(d["qs"])
            k = int(d["k"])
            i, v = make_pem_topk(k, half_life=30.0)(*local, qp, qs)
            # the payload form: each rank gathers its own pool rows
            from repro_torch.kernels.pem_score.ops import pem_score
            from repro_torch.kernels.topk.ops import topk
            panel = torch.empty((qp.shape[1], n_local))
            pem_score(*local[:1], qp, qs, days_ago=local[1],
                      half_lives=torch.full((qp.shape[1],), 30.0),
                      out=panel.T)
            lv, li = topk(panel, min(k, n_local))
            pi, pv, pp = union_merge_topk_payload(
                lv, li.long() + rank * n_local, local[0][li.long()], k)
            np.savez(f"{out}.{rank}.npz", i=i.numpy(), v=v.numpy(),
                     pi=pi.numpy(), pv=pv.numpy(), pp=pp.numpy())
        finally:
            dist.destroy_process_group()

    if __name__ == "__main__":
        world = int(sys.argv[1])
        mp.spawn(run, args=(world, *sys.argv[2:5]), nprocs=world, join=True)
""")


@pytest.mark.parametrize("world", [2, 4])
def test_make_pem_topk_on_gloo_ranks(tmp_path, world):
    """The collective path on ``world`` CPU ranks (gloo, a FileStore under
    tmp_path, spawned in a subprocess with its own timeout): every rank
    returns the reference's top-k, and the payload merge carries each
    winner's own row."""
    corpus, days, qp, qs = _pem_inputs()
    k = 300
    data = tmp_path / "inputs.npz"
    np.savez(data, corpus=corpus, days=days, qp=qp, qs=qs, k=k)
    script = tmp_path / "ranks.py"
    script.write_text(_RANKS)
    out = tmp_path / "out"
    r = subprocess.run(
        [sys.executable, str(script), str(world), str(tmp_path / "store"),
         str(data), str(out)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    wi, wv = _jax_reference(corpus, days, qp, qs, k)
    for rank in range(world):
        got = np.load(f"{out}.{rank}.npz")
        np.testing.assert_array_equal(got["i"], wi)
        np.testing.assert_allclose(got["v"], wv, atol=TOL)
        np.testing.assert_array_equal(got["pi"], wi)
        np.testing.assert_array_equal(got["pp"], corpus[wi])


# -- ShardedBackend -----------------------------------------------------------


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("mask_kind", ["none", "shared", "panel",
                                       "dead shard"])
@pytest.mark.parametrize("biased", [False, True])
def test_sharded_backend_matches_reference(shards, mask_kind, biased):
    mat, days, rng = _corpus()
    r_plans, t_plans = _plans(lam=0.0)
    mask = _mask(mask_kind, rng, N, len(KS), shards)
    bias = None
    if biased:
        bias = np.zeros((N, len(KS)), np.float32)
        hit = rng.random(bias.shape) > 0.9
        bias[hit] = rng.uniform(0.0, 0.5, int(hit.sum())).astype(np.float32)
    kw = dict(mask=mask, score_bias=bias)
    backend = TB.ShardedBackend(["cpu"] * shards)
    assert backend.name == "sharded" and backend.n_shards == shards
    got = backend.score_select(mat, days, t_plans, KS, **kw)
    for name in ("sharded", "jit-jax"):
        _assert_same(got, RB.get_backend(name).score_select(
            mat, days, r_plans, KS, **kw))
    # the host-pool contract against the numpy oracle
    _assert_same(backend.score_select(mat, days, t_plans, KS,
                                      fused_mmr=False, **kw),
                 RB.get_backend("fused-numpy").score_select(
                     mat, days, r_plans, KS, **kw))
    if mask_kind == "none" and not biased:
        # the planted ties made the first plan's top 7, in row order
        tied = [int(i) for i in got[0][0] if int(i) in _boundary_rows(N)]
        assert len(tied) >= 2 and tied == sorted(tied)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("lam", [0.0, 0.3, 0.7, 1.0])
def test_sharded_diverse_plans_match_reference(shards, lam):
    """Diverse plans: the shards' pool rows ride the merge as its payload
    and the MMR kernel's plain version finishes them on the lead device;
    equal to the reference's sharded backend and to the numpy pools
    finished by the host MMR oracle."""
    mat, days, rng = _corpus(seed=3)
    r_plans, t_plans = _plans(lam=lam)
    mask = rng.random(N) > 0.2
    got = TB.ShardedBackend(["cpu"] * shards).score_select(
        mat, days, t_plans, KS, mask=mask)
    _assert_same(got, RB.get_backend("sharded").score_select(
        mat, days, r_plans, KS, mask=mask))
    pools = RB.get_backend("fused-numpy").score_select(mat, days, r_plans,
                                                       KS, mask=mask)
    for plan, k, (gi, gv), (pi, pv) in zip(r_plans, KS, got, pools):
        wi, wv = RB.finalize_candidates(mat, pi, pv, k, plan)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gv, wv, atol=TOL)


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


@pytest.mark.parametrize("shards", [2, 3])
def test_sharded_segments_match_reference(shards):
    """A segmented store with tombstones: every segment splits over the
    shards, diverse plans finish in one merged-pool MMR call whose pool
    rows each shard gathers for itself."""
    mat, days, rng = _corpus(n=300, seed=11)
    ref = _reference_store(mat, days, [120, 100, 80],
                           rng.choice(300, 30, replace=False))
    port = store_from_arrays([
        {"ids": np.array(s.ids), "matrix": np.array(s.matrix),
         "timestamps": np.array(s.timestamps),
         "live_mask": np.array(s.live_mask)} for s in ref.segments])
    r_plans, t_plans = _plans(lam=0.3)
    got = TB.score_select_segments(TB.ShardedBackend(["cpu"] * shards),
                                   port.segments, t_plans, KS, now=NOW)
    want = RB.score_select_segments("sharded", ref.segments, r_plans, KS,
                                    now=NOW)
    _assert_same(got, want)


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_score_panel_matches_reference(shards):
    mat, days, _ = _corpus(seed=5)
    r_plans, t_plans = _plans()
    got = TB.ShardedBackend(["cpu"] * shards).score_panel(mat, days, t_plans)
    want = RB.get_backend("sharded").score_panel(mat, days, r_plans)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_sharded_backend_keeps_its_blocks_resident():
    """One upload a matrix (S blocks), each block on its own shard's
    device, and no row past the corpus ever enters a result."""
    mat, days, _ = _corpus(n=10, seed=9, ties=False)
    _, t_plans = _plans()
    backend = TB.ShardedBackend(["cpu"] * 4)  # blocks of 3, 3, 3 and 1
    for _ in range(2):
        out = backend.score_select(mat, days, t_plans, [10] * len(t_plans))
    st = backend.device_cache_stats()
    assert st["uploads"] == 1 and st["hits"] == 1
    assert st["bytes"] == mat.nbytes
    for idx, vals in out:
        assert idx.max() < 10 and np.isfinite(vals).all()


# -- duplicate rows across shard blocks ---------------------------------------

_TIED_SHARDS = textwrap.dedent("""
    import sys

    import numpy as np

    from repro.core import modulations as M
    from repro.core.backends import get_backend
    from repro.embed import HashEmbedder
    import jax

    assert len(jax.devices()) == int(sys.argv[2])
    data = np.load(sys.argv[1])
    plan = M.ModulationPlan(query=M.l2_normalize(HashEmbedder(32)("tied query")),
                            diverse=M.DiverseSpec(lam=0.5), pool=8)
    (idx, vals), = get_backend("sharded").score_select(
        data["mat"], data["days"], [plan], [8])
    np.savez(sys.argv[3], i=np.asarray(idx), v=np.asarray(vals))
""")


def _tied_rows():
    """8 unit rows, each repeated 3 times: every score ties 3 ways."""
    rng = np.random.default_rng(5)
    base = rng.standard_normal((8, D)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    mat = np.concatenate([base, base, base])
    return mat, np.zeros(mat.shape[0], np.float32)


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_duplicate_rows_tie_to_the_first(tmp_path, shards):
    """Equal rows score equal whatever shard block holds them, so MMR's
    exact ties go to the first occurrence at every shard count: the
    reference's ``ShardedBackend`` on ``shards`` forced host devices (in a
    subprocess, where the device count can be set) and the port's on
    ``["cpu"] * shards`` pick the same rows."""
    mat, days = _tied_rows()
    data = tmp_path / "tied.npz"
    np.savez(data, mat=mat, days=days)
    script = tmp_path / "tied.py"
    script.write_text(_TIED_SHARDS)
    out = tmp_path / "out.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count="
               f"{shards}")
    r = subprocess.run([sys.executable, str(script), str(data), str(shards),
                        str(out)], env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    want = np.load(out)
    plan = TM.ModulationPlan(query=TM.l2_normalize(THash(D)("tied query")),
                             diverse=TM.DiverseSpec(lam=0.5), pool=8)
    (idx, vals), = TB.ShardedBackend(["cpu"] * shards).score_select(
        mat, days, [plan], [8])
    assert list(idx) == [5, 2, 3, 4, 0, 1, 7, 6]
    np.testing.assert_array_equal(idx, want["i"])
    np.testing.assert_allclose(vals, want["v"], atol=TOL)


@pytest.mark.parametrize("b", [1, 3, 32])
def test_plain_scores_of_a_row_do_not_depend_on_its_block(b):
    """The plain K1 gives a row the same bits in a block of any length."""
    mat, days = _tied_rows()
    q = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (D, b)).astype(np.float32))
    whole = pem_score(torch.from_numpy(mat), q, -q, torch.from_numpy(days))
    for lo, hi in ((0, 6), (6, 12), (12, 18), (18, 24), (3, 4), (11, 24)):
        part = pem_score(torch.from_numpy(mat[lo:hi]), q, -q,
                         torch.from_numpy(days[lo:hi]))
        np.testing.assert_array_equal(part.numpy(), whole[lo:hi].numpy())
    np.testing.assert_array_equal(whole[:8].numpy(), whole[8:16].numpy())
    np.testing.assert_array_equal(whole[:8].numpy(), whole[16:].numpy())
