"""The port's flexvec architecture entry against the reference, on the CPU.

``repro_torch.configs.flexvec.pem_serve_step`` and JAX's
``repro.configs.flexvec.pem_serve_step`` see the same seeded numpy inputs
(a unit-normal corpus, ages uniform on 0-90 days, q normal and
q_sup = -0.5 q) at two sizes.  In f32 the picks are equal id for id and
their scores agree to 1e-5 (the products summed in another order); with a
bf16 corpus (both sides round the same f32 values to the same bf16 bits)
scores agree to 2e-2, the JAX suites' bf16 tolerance, and the two pick
sets share at least all but one id.  The ``two_stage`` build runs on 2 and
4 gloo CPU ranks in a subprocess and must equal the one-stage step bit
for bit, also with the MMR batch split over the ranks (``mmr_shards``).
Sharding rules, cells and the cost arithmetic must equal the reference's
for every cell and variant (the reference's rules built over
``jax.sharding.AbstractMesh``, which needs no devices).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh as JaxAbstractMesh  # noqa: E402

from repro.configs import ASSIGNED as R_ASSIGNED  # noqa: E402
from repro.configs import get_arch as R_get_arch  # noqa: E402
from repro.configs import flexvec as RF  # noqa: E402
from repro.dist import tuned as RT  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.configs import flexvec as TF  # noqa: E402
from repro_torch.configs import lm as TL  # noqa: E402
from repro_torch.models import transformer as TT_model  # noqa: E402
from repro_torch.dist import tuned as TT  # noqa: E402
from repro_torch.dist.sharding import AbstractMesh  # noqa: E402
from repro_torch.kernels.mmr.ops import mmr_select  # noqa: E402
from repro_torch.kernels.pem_score.ops import pem_score  # noqa: E402
from repro_torch.kernels.topk.ops import topk  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (make_local_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.roofline.analysis import (HW, KernelWork,  # noqa: E402
                                           RooflineReport, analyze)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
BF16_TOL = 2e-2
LM_IDS = ["granite-34b", "minitron-4b", "internlm2-1.8b",
          "granite-moe-1b-a400m", "qwen3-moe-235b-a22b"]
SIZES = {"n512": dict(n=512, b=2, over=24, pool=8),
         "n4096": dict(n=4096, b=8, over=64, pool=16)}


def _inputs(n, b, seed=0):
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((n, TF.DIM)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    days = rng.uniform(0.0, 90.0, n).astype(np.float32)
    q = rng.standard_normal((TF.DIM, b)).astype(np.float32)
    return corpus, days, q, (-0.5 * q).astype(np.float32)


def _port_step(corpus, days, q, qs, dtype, pool, over):
    i, v = TF.pem_serve_step(torch.from_numpy(corpus).to(dtype),
                             torch.from_numpy(days), torch.from_numpy(q),
                             torch.from_numpy(qs), pool=pool, over=over)
    return i.numpy(), v.numpy()


# -- pem_serve_step -----------------------------------------------------------


@pytest.mark.parametrize("size", sorted(SIZES))
def test_pem_serve_step_matches_jax_f32(size):
    s = SIZES[size]
    corpus, days, q, qs = _inputs(s["n"], s["b"])
    wi, wv = RF.pem_serve_step(jnp.asarray(corpus), jnp.asarray(days),
                               jnp.asarray(q), jnp.asarray(qs),
                               pool=s["pool"], over=s["over"])
    gi, gv = _port_step(corpus, days, q, qs, torch.float32, s["pool"],
                        s["over"])
    assert gi.shape == (s["b"], s["pool"]) and gi.dtype == np.int32
    np.testing.assert_array_equal(gi, np.asarray(wi))
    np.testing.assert_allclose(gv, np.asarray(wv), atol=TOL)


@pytest.mark.parametrize("size", sorted(SIZES))
def test_pem_serve_step_matches_jax_bf16(size):
    s = SIZES[size]
    corpus, days, q, qs = _inputs(s["n"], s["b"], seed=1)
    wi, wv = RF.pem_serve_step(jnp.asarray(corpus).astype(jnp.bfloat16),
                               jnp.asarray(days), jnp.asarray(q),
                               jnp.asarray(qs), pool=s["pool"],
                               over=s["over"])
    gi, gv = _port_step(corpus, days, q, qs, torch.bfloat16, s["pool"],
                        s["over"])
    wi, wv = np.asarray(wi), np.asarray(wv)
    for row in range(s["b"]):
        shared = set(gi[row].tolist()) & set(wi[row].tolist())
        assert len(shared) >= s["pool"] - 1, (row, gi[row], wi[row])
        score = dict(zip(wi[row].tolist(), wv[row].tolist()))
        for r, v in zip(gi[row].tolist(), gv[row].tolist()):
            if r in score:
                assert abs(v - score[r]) <= BF16_TOL
    np.testing.assert_allclose(np.sort(gv, axis=1), np.sort(wv, axis=1),
                               atol=BF16_TOL)


def test_smoke_run_passes_the_reference_smoke_assertions():
    out = TC.get_arch("flexvec").smoke_run()
    assert np.isfinite(out["loss"])
    assert out["idx_shape"] == (2, 8)
    assert out["val_finite"]


def test_step_on_meta_returns_shapes_and_launches_nothing():
    before = (pem_score.launches, topk.launches, mmr_select.launches)
    m = torch.device("meta")
    i, v = TF.pem_serve_step(torch.empty(1000, 128, device=m),
                             torch.empty(1000, device=m),
                             torch.empty(128, 64, device=m),
                             torch.empty(128, 64, device=m),
                             pool=500, over=600)
    assert i.device.type == v.device.type == "meta"
    assert tuple(i.shape) == tuple(v.shape) == (64, 500)
    assert i.dtype == torch.int32 and v.dtype == torch.float32
    assert (pem_score.launches, topk.launches, mmr_select.launches) == before
    # a shape the kernels refuse fails on meta as on the card
    with pytest.raises(ValueError, match="k <= n"):
        TF.pem_serve_step(torch.empty(1000, 128, device=m),
                          torch.empty(1000, device=m),
                          torch.empty(128, 4, device=m),
                          torch.empty(128, 4, device=m), pool=50, over=40)
    with pytest.raises(ValueError, match="d <= 128"):
        pem_score(torch.empty(10, 256, device=m), torch.empty(256, 2, device=m),
                  torch.empty(256, 2, device=m))


# -- two_stage and mmr_shards on gloo ranks ------------------------------------

_RANKS = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, world, store, data, out, mmr_shards):
        from repro_torch.configs import flexvec as F
        from repro_torch.dist.tuned import get_rules
        from repro_torch.launch.mesh import make_local_mesh

        d = np.load(data)
        F.SHAPES["gloo"] = dict(n=int(d["n"]), batch=int(d["b"]),
                                pool=int(d["pool"]), over=int(d["over"]))
        dist.init_process_group("gloo", init_method="file://" + store,
                                rank=rank, world_size=world)
        try:
            mesh = make_local_mesh("cpu")
            rules = get_rules("default", mesh)
            assert rules.size_of("corpus") == world
            arch = F.FlexvecArch(two_stage=True)
            arch.mmr_shards = mmr_shards
            spec = arch.build("gloo", mesh, rules)
            assert spec.per_device
            blocks = []
            for a, name in zip(spec.args, ("corpus", "days", "q", "qs")):
                full = torch.from_numpy(d[name])
                assert tuple(full.shape) == tuple(a.shape)
                rows = rules.block_shape(a.shape, a.spec)[0]
                if a.spec[0] is not None:  # row-sharded: this rank's block
                    full = full[rank * rows:(rank + 1) * rows]
                blocks.append(full.contiguous())
            i, v = spec.fn(*blocks)
            np.savez(f"{out}.{rank}.npz", i=i.numpy(), v=v.numpy())
        finally:
            dist.destroy_process_group()

    if __name__ == "__main__":
        world, mmr_shards = int(sys.argv[1]), int(sys.argv[5])
        mp.spawn(run, args=(world, *sys.argv[2:5], mmr_shards),
                 nprocs=world, join=True)
""")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mmr_shards", [1, 2])
def test_two_stage_on_gloo_ranks_is_bit_equal_to_one_stage(tmp_path, world,
                                                          mmr_shards):
    """Every rank scores its block, merges the union, sums the pool's rows
    over the ranks and selects (its share of the batch with mmr_shards >
    1); every rank's picks must equal the one-stage step's bit for bit."""
    n, b, pool, over = 1024, 8, 8, 48
    corpus, days, q, qs = _inputs(n, b, seed=2)
    data = tmp_path / "inputs.npz"
    np.savez(data, corpus=corpus, days=days, q=q, qs=qs, n=n, b=b,
             pool=pool, over=over)
    script = tmp_path / "ranks.py"
    script.write_text(_RANKS)
    out = tmp_path / "out"
    r = subprocess.run(
        [sys.executable, str(script), str(world), str(tmp_path / "store"),
         str(data), str(out), str(mmr_shards)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=150)
    assert r.returncode == 0, r.stderr[-3000:]
    wi, wv = _port_step(corpus, days, q, qs, torch.float32, pool, over)
    for rank in range(world):
        got = np.load(f"{out}.{rank}.npz")
        np.testing.assert_array_equal(got["i"], wi.astype(np.int64))
        np.testing.assert_array_equal(got["v"].view(np.int32),
                                      wv.view(np.int32))


# -- cells, costs and rules against the reference ------------------------------


@pytest.mark.parametrize("shape", sorted(RF.SHAPES))
@pytest.mark.parametrize("mmr_vmem", [False, True])
@pytest.mark.parametrize("mmr_shards", [1, 16])
def test_cells_and_costs_match_jax(shape, mmr_vmem, mmr_shards):
    assert TF.SHAPES == RF.SHAPES and TF.DIM == RF.DIM
    ra = RF.FlexvecArch(mmr_vmem=mmr_vmem)
    ta = TF.FlexvecArch(mmr_vmem=mmr_vmem)
    ra.mmr_shards = ta.mmr_shards = mmr_shards
    rc, tc = ra.cells()[shape], ta.cells()[shape]
    assert (tc.name, tc.kind, tc.desc, tc.skip_reason,
            tc.beyond_assignment) == (rc.name, rc.kind, rc.desc,
                                      rc.skip_reason, rc.beyond_assignment)
    assert set(ta.cells()) == set(ra.cells())
    assert ta.model_flops(shape) == ra.model_flops(shape)
    for chips in (256, 512):
        assert ta.cost_corrections(shape, chips) == \
            ra.cost_corrections(shape, chips)
    assert (ta.family, ta.source, ta.arch_id) == (ra.family, ra.source,
                                                  ra.arch_id)


def _jax_rules(variant, multi_pod):
    if multi_pod:
        mesh = JaxAbstractMesh((2, 16, 16), ("pod", "data", "model"))
    else:
        mesh = JaxAbstractMesh((16, 16), ("data", "model"))
    return RT.get_rules(variant, mesh)


@pytest.mark.parametrize("variant", ["default", "corpus_all",
                                     "serve_weights"])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_sharding_rules_match_jax(variant, multi_pod):
    want = _jax_rules(variant, multi_pod)
    got = TT.get_rules(variant, make_production_mesh(multi_pod=multi_pod))
    assert set(got.rules) == set(want.rules)
    dims = (1, 16, 32, 64, 500, 49155, 67_108_864)
    for name in want.rules:
        assert got.size_of(name) == want.size_of(name), name
        assert got.spec(name) == tuple(want.spec(name)), name
        assert got.spec(name, None) == tuple(want.spec(name, None)), name
        for dim in dims:
            assert got.if_divisible(name, dim) == want.if_divisible(name, dim)
    assert got.spec() == tuple(want.spec()) == ()
    assert got.spec("corpus", "batch", None) == tuple(
        want.spec("corpus", "batch", None))
    assert got.size_of(None) == want.size_of(None) == 1
    with pytest.raises(KeyError, match="unknown logical axis"):
        got.spec("nope")


def test_unknown_rules_variant_raises():
    with pytest.raises(KeyError, match="unknown rules variant"):
        TT.get_rules("fastest", make_production_mesh())


def test_block_shape_divides_each_dim_by_its_mesh_axes():
    rules = TT.get_rules("corpus_all", make_production_mesh(multi_pod=True))
    assert rules.block_shape((67_108_864, 128), rules.spec("corpus", None)) \
        == (131_072, 128)
    assert rules.block_shape((64, 8), rules.spec("batch")) == (2, 8)
    with pytest.raises(ValueError, match="does not split"):
        rules.block_shape((1000, 128), rules.spec("corpus", None))


# -- meshes and the registry ----------------------------------------------------


def test_meshes_match_jax_and_importing_touches_nothing():
    for multi_pod in (False, True):
        got = make_production_mesh(multi_pod=multi_pod)
        want = (JaxAbstractMesh((2, 16, 16), ("pod", "data", "model"))
                if multi_pod else JaxAbstractMesh((16, 16), ("data", "model")))
        assert got.axis_names == tuple(want.axis_names)
        assert got.shape == dict(want.shape)
        assert got.size == (512 if multi_pod else 256)
    code = ("import torch, torch.distributed as dist\n"
            "import repro_torch.launch.mesh, repro_torch.launch.dryrun\n"
            "import repro_torch.configs\n"
            "print(torch.cuda.is_initialized(), dist.is_initialized())\n")
    r = subprocess.run([sys.executable, "-c", code],
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["False", "False"]


def test_local_mesh_is_the_card_unless_the_cpu_is_asked():
    assert make_local_mesh("cpu") == AbstractMesh((1, 1), ("data", "model"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_local_mesh()


def test_registry_holds_flexvec_and_names_the_unported():
    assert TC.ASSIGNED == R_ASSIGNED and len(TC.ASSIGNED) == 10
    assert set(TC.REGISTRY) == {"flexvec"} | set(LM_IDS)
    assert isinstance(TC.get_arch("flexvec"), TF.FlexvecArch)
    for aid in LM_IDS:
        arch, ref = TC.get_arch(aid), R_get_arch(aid)
        assert isinstance(arch, TL.LMArch) and arch.family == "lm"
        assert {n: dataclasses.asdict(c) for n, c in arch.cells().items()} \
            == {n: dataclasses.asdict(c) for n, c in ref.cells().items()}
        for shape in arch.cells():
            assert arch.model_flops(shape) == ref.model_flops(shape)
    for aid in set(TC.ASSIGNED) - set(LM_IDS):
        with pytest.raises(KeyError, match="Queue 1 item 5"):
            TC.get_arch(aid)
    with pytest.raises(KeyError, match="unknown arch"):
        TC.get_arch("nope")


# -- roofline -------------------------------------------------------------------


def test_h100_figures_and_three_terms():
    assert (HW.peak_flops, HW.tf32_flops, HW.f32_flops) == (989e12, 495e12,
                                                            67e12)
    assert (HW.hbm_bw, HW.link_bw) == (3.35e12, 450e9)
    rep = RooflineReport(
        arch="x", shape="y", mesh="16x16", chips=256,
        hlo_flops=256 * 989e12 * 0.25,        # 0.25 s of bf16 compute
        hlo_bytes=256 * 3.35e12 * 0.5,        # 0.5 s of HBM
        collective_bytes=256 * 450e9 * 1.0,   # 1 s of NVLink
        collective_by_op={}, model_flops=256 * 989e12 * 0.2,
    )
    assert abs(rep.t_compute - 0.25) < 1e-12
    assert abs(rep.t_memory - 0.5) < 1e-12
    assert abs(rep.t_collective - 1.0) < 1e-12
    assert rep.bottleneck == "collective"
    assert abs(rep.useful_flops_ratio - 0.8) < 1e-12
    assert abs(rep.roofline_fraction - 0.2) < 1e-12


def test_analyze_scales_per_device_counts_to_the_fleet():
    rep = analyze("a", "s", "16x16", 256, 10.0, 20.0, 5.0,
                  {"all-gather": 3.0, "all-reduce": 2.0}, model_flops=1000.0)
    assert rep.hlo_flops == 10.0 * 256
    assert rep.hlo_bytes == 20.0 * 256
    assert rep.collective_bytes == 5.0 * 256
    assert rep.collective_by_op == {"all-gather": 768, "all-reduce": 512}
    assert rep.bottleneck == "collective"  # 1280 B over 450 GB/s a link


def test_kernel_bounds_at_h100_figures():
    """K1 at corpus_1m: 772,065,536 bytes (corpus 512 MB, panel 256 MB,
    ages 4 MB, queries 64 KB) over 3.35 TB/s; three split-TF32 products of
    2 * 1e6 * 128 * 128 over 495 TFLOP/s."""
    k1 = TF.pem_score_work(1_000_000, 128, 64, 4)
    assert k1.nbytes == 772_065_536
    assert abs(HW.bound_s(k1) - 772_065_536 / 3.35e12) < 1e-15
    assert abs(HW.ops_s(k1) - 3 * 4.0 * 1e6 * 128 * 64 / 495e12) < 1e-15
    assert HW.bound_by(k1) == "bytes"
    k3 = TF.mmr_work(64, 1500, 500, 128)
    assert k3.flops == 2.0 * 64 * 500 * 1500 * 128
    assert HW.bound_by(k3) == "operations"
    assert abs(HW.bound_s(k3) - k3.flops / 67e12) < 1e-15
    assert HW.bound_s(KernelWork(flops=1.0, nbytes=0.0, peak="bf16")) == \
        1.0 / 989e12


# -- the dry run ---------------------------------------------------------------


@pytest.mark.parametrize("two_stage", [False, True])
@pytest.mark.parametrize("rules_name", ["default", "corpus_all"])
def test_run_cell_reports_the_arch_count(two_stage, rules_name):
    arch = TF.FlexvecArch(two_stage=two_stage)
    out = dryrun.run_cell("flexvec", "corpus_240k", False, rules_name,
                          arch_obj=arch)
    rules = TT.get_rules(rules_name, make_production_mesh())
    cost = arch.step_cost("corpus_240k", rules)
    assert out["chips"] == 256 and out["mesh"] == "16x16"
    assert out["hlo_flops"] == cost.flops * 256
    assert out["hlo_bytes"] == cost.nbytes * 256
    assert out["collective_bytes"] == cost.collective_bytes * 256
    assert out["model_flops"] == arch.model_flops("corpus_240k")
    assert out["outputs"] == [[64, 500], [64, 500]]
    assert set(out["kernels"]) >= {"pem_score", "topk", "gather", "mmr"}
    shards = rules.size_of("corpus")
    n_local = -(-240_000 // shards)
    mem = out["per_device_memory"]
    assert mem["argument_size_in_bytes"] == n_local * (128 * 4 + 4) \
        + 2 * 128 * 64 * 4
    assert out["cost_corrections"]["flops"] == \
        arch.cost_corrections("corpus_240k", 256)[0]
    # the two-stage merge moves shards*over*B candidates, not the panel
    gathered = out["collective_by_op"]["all-gather"] / 256
    assert gathered == (shards * 1500 * 64 * 12 if two_stage
                        else shards * n_local * 64 * 4)


def test_run_cell_fails_on_a_shape_the_kernels_refuse(monkeypatch):
    monkeypatch.setitem(TF.SHAPES, "bad", dict(n=4096, batch=8, pool=600,
                                               over=500))
    with pytest.raises(ValueError, match="k <= n"):
        dryrun.run_cell("flexvec", "bad", False)


def test_dryrun_cli_runs_without_a_card():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "flexvec", "--shape", "corpus_1m"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout)
    assert (out["arch"], out["shape"], out["mesh"]) == ("flexvec",
                                                        "corpus_1m", "16x16")
    assert out["hlo_flops"] > 0 and out["bottleneck"] in (
        "compute", "memory", "collective")


def test_drive_all_and_the_report_tables(tmp_path, monkeypatch):
    from repro_torch.roofline.report import (collective_mix_table,
                                             dryrun_table, load_cells,
                                             roofline_table)

    # the reference's rule: each ported arch's assigned cells, then the
    # cells beyond the assignment (long_500k, skipped per assignment but
    # run; flexvec's)
    assert dryrun.cell_list() == (
        [(a, s) for a in LM_IDS
         for s in ("train_4k", "prefill_32k", "decode_32k")]
        + [(a, "long_500k") for a in LM_IDS]
        + [("flexvec", s) for s in TF.SHAPES])
    # the sweep's mechanics over flexvec's cells and one LM decode cell
    # (every LM cell runs in test_lm_cells_run_on_both_meshes)
    cells_run = [("internlm2-1.8b", "decode_32k")] + [
        ("flexvec", s) for s in TF.SHAPES]
    monkeypatch.setattr(dryrun, "cell_list", lambda: cells_run)
    dryrun.drive_all(report_dir=tmp_path)
    files = sorted(p.name for p in tmp_path.glob("*.json"))
    assert files == sorted(f"{a}__{s}__{m}.json" for a, s in cells_run
                           for m in ("16x16", "2x16x16"))
    cells = load_cells(tmp_path)
    assert len(cells) == 8 and not any("error" in c for c in cells)
    table = roofline_table(cells)
    assert table.count("| flexvec |") == 3 and "**collective**" in table
    assert table.count("| internlm2-1.8b |") == 1
    assert dryrun_table(cells).count("| flexvec |") == 6
    assert collective_mix_table(cells).count("| flexvec |") == 6


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_lm_cells_run_on_both_meshes(arch_id):
    """Every cell of the arch, on 16x16 and 2x16x16, at its published
    widths and two layers (the meta run's time grows with the depth; the
    count is the step's, layer for layer).  Each step runs on meta tensors
    of the global shapes; its outputs are what the step returns."""
    base = TC.get_arch(arch_id)
    arch = TL.LMArch(arch_id, base.source,
                     dataclasses.replace(base.cfg, n_layers=2), base.smoke_cfg)
    cfg = arch.cfg
    n_leaves = 3 + len(TT_model.param_shapes(cfg)["layers"])
    for shape, cell in arch.cells().items():
        s = TL.LM_SHAPES[shape]
        for multi_pod in (False, True):
            out = dryrun.run_cell(arch_id, shape, multi_pod, arch_obj=arch)
            rules = TT.get_rules("default",
                                 make_production_mesh(multi_pod=multi_pod))
            cost = arch.step_cost(shape, rules)
            chips = 512 if multi_pod else 256
            assert out["hlo_flops"] == cost.flops * chips > 0
            assert out["collective_bytes"] == cost.collective_bytes * chips
            assert out["skip_reason"] == cell.skip_reason
            assert out["beyond_assignment"] == (shape == "long_500k")
            kv = [2, s["batch"], s["seq"], cfg.n_kv_heads, cfg.head_dim]
            if s["kind"] == "train":
                assert out["outputs"][-2:] == [[], []]     # loss, grad norm
                assert len(out["outputs"]) == 3 * n_leaves + 2
                assert {"adamw", "loss", "attention"} <= set(out["kernels"])
                assert "reduce-scatter" in out["collective_by_op"]
            elif s["kind"] == "prefill":
                assert out["outputs"] == [[s["batch"], cfg.vocab], kv, kv]
            else:
                assert out["outputs"] == [[s["batch"], cfg.vocab], kv, kv]
            assert ("moe" in out["kernels"]) == (cfg.moe is not None)
