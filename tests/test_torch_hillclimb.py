"""The port's hillclimb iterations against the reference's
arithmetic, on the CPU with no card and no JAX compile.

Each of the seven flexvec iterations runs the port's dry run
(``run_cell`` over the abstract production mesh) and writes its JSON in
the dry run's schema.  Its cell, its sharding rules and its
``cost_corrections`` must equal the reference's ``FlexvecArch`` built
with the same knobs (``src/repro/launch/hillclimb.py``, mirrored in
``REFERENCE_KNOBS``) and the reference's rules over
``jax.sharding.AbstractMesh``, which needs no devices.  The four LM
iterations (qwen3-1/-2, granite-1/-2) write their reports with the
reference's configs and knobs, and each moves its count the way its knob
should.  The reference's hillclimb module itself is not imported: it
forces 512 host devices on import.
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh as JaxAbstractMesh  # noqa: E402

from repro.configs import flexvec as RF  # noqa: E402
from repro.dist import tuned as RT  # noqa: E402
from repro_torch.dist import tuned as TT  # noqa: E402
from repro_torch.launch import dryrun, hillclimb  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

# src/repro/launch/hillclimb.py: (shape, multi_pod, FlexvecArch kwargs,
# mmr_shards), all on the corpus_all rules
_ALL = dict(dtype=jnp.bfloat16, mmr_vmem=True, two_stage=True)
REFERENCE_KNOBS = {
    "flexvec-1": ("corpus_1m", False, {}, 1),
    "flexvec-2": ("corpus_1m", False, dict(dtype=jnp.bfloat16), 1),
    "flexvec-3": ("corpus_1m", False,
                  dict(dtype=jnp.bfloat16, mmr_vmem=True), 1),
    "flexvec-4": ("corpus_1m", False, _ALL, 1),
    "flexvec-6": ("corpus_1m", False, _ALL, 16),
    "flexvec-67m": ("corpus_67m", False, _ALL, 16),
    "flexvec-67m-multipod": ("corpus_67m", True, _ALL, 16),
}


def test_the_iterations_are_the_reference_flexvec_ones():
    assert list(hillclimb.ITERATIONS) == list(REFERENCE_KNOBS)


@pytest.mark.parametrize("name", list(REFERENCE_KNOBS))
def test_iteration_matches_the_reference_arithmetic(name, tmp_path,
                                                   monkeypatch, capsys):
    shape, multi_pod, knobs, mmr_shards = REFERENCE_KNOBS[name]
    monkeypatch.setattr(hillclimb, "PERF_DIR", tmp_path)
    out = hillclimb.run_iteration(name)
    assert capsys.readouterr().out.startswith(f"[{name}] bottleneck=")
    written = json.loads((tmp_path / f"{name}.json").read_text())
    schema = dryrun.run_cell("flexvec", shape, multi_pod, "corpus_all")
    assert set(written) == set(schema) == set(out)
    assert (written["shape"], written["rules"], written["mesh"]) == (
        shape, "corpus_all", "2x16x16" if multi_pod else "16x16")
    assert written["outputs"] == [list(o) for o in out["outputs"]]

    port = hillclimb.arch_for(name)
    ref = RF.FlexvecArch(**knobs)
    ref.mmr_shards = mmr_shards
    assert port.dtype == (torch.bfloat16 if "dtype" in knobs
                          else torch.float32)
    assert (port.mmr_vmem, port.two_stage, port.mmr_shards) == (
        ref.mmr_vmem, ref.two_stage, ref.mmr_shards)
    pc, rc = port.cells()[shape], ref.cells()[shape]
    assert (pc.name, pc.kind, pc.desc, pc.skip_reason,
            pc.beyond_assignment) == (rc.name, rc.kind, rc.desc,
                                      rc.skip_reason, rc.beyond_assignment)
    chips = 512 if multi_pod else 256
    assert written["chips"] == chips
    assert written["cost_corrections"] == dict(zip(
        ("flops", "bytes"), ref.cost_corrections(shape, chips)))
    assert written["model_flops"] == ref.model_flops(shape)

    mesh = (JaxAbstractMesh((2, 16, 16), ("pod", "data", "model"))
            if multi_pod else JaxAbstractMesh((16, 16), ("data", "model")))
    want = RT.get_rules("corpus_all", mesh)
    got = TT.get_rules("corpus_all", make_production_mesh(multi_pod=multi_pod))
    assert set(got.rules) == set(want.rules)
    for axis in want.rules:
        assert got.spec(axis) == tuple(want.spec(axis)), axis
        assert got.size_of(axis) == want.size_of(axis), axis


def test_main_writes_every_report(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(hillclimb, "PERF_DIR", tmp_path)
    monkeypatch.setattr("sys.argv", ["hillclimb", "flexvec-1", "flexvec-6"])
    hillclimb.main()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "flexvec-1.json", "flexvec-6.json"]
    assert capsys.readouterr().out.count("bottleneck=") == 2


# src/repro/launch/hillclimb.py: (arch, shape, rules, LMConfig changes),
# and the count each knob should move: (iteration or default cell it is
# compared with, what is counted)
REFERENCE_LM_KNOBS = {
    "qwen3-1": ("qwen3-moe-235b-a22b", "decode_32k", "serve_weights", {}),
    "qwen3-2": ("qwen3-moe-235b-a22b", "decode_32k", "serve_weights",
                {"decode_group": 8}),
    "granite-1": ("granite-34b", "train_4k", "default",
                  {"remat_policy": "dots"}),
    "granite-2": ("granite-34b", "train_4k", "default", {"remat": False}),
}
LOWER_THAN = {"qwen3-1": ("default", "collective_bytes"),
              "qwen3-2": ("qwen3-1", "moe_flops"),
              "granite-1": ("default", "flops"),
              "granite-2": ("granite-1", "flops")}


def _count(arch, shape, rules_name, what):
    cost = arch.step_cost(shape, TT.get_rules(rules_name,
                                              make_production_mesh()))
    return {"collective_bytes": cost.collective_bytes, "flops": cost.flops,
            "moe_flops": cost.kernels.get("moe") and cost.kernels["moe"].flops
            }[what]


@pytest.mark.parametrize("name", ["qwen3-1", "qwen3-2", "granite-1",
                                  "granite-2"])
def test_lm_iteration_writes_its_report_and_moves_its_count(name, tmp_path,
                                                           monkeypatch):
    from repro.configs import get_arch as R_get_arch
    from repro_torch.configs import get_arch

    arch_id, shape, rules_name, changes = REFERENCE_LM_KNOBS[name]
    monkeypatch.setattr(hillclimb, "PERF_DIR", tmp_path)
    out = hillclimb.run_iteration(name)
    written = json.loads((tmp_path / f"{name}.json").read_text())
    assert (written["arch"], written["shape"], written["rules"],
            written["mesh"]) == (arch_id, shape, rules_name, "16x16")
    assert written["hlo_flops"] == out["hlo_flops"] > 0

    port = hillclimb.arch_for(name)
    ref_cfg = R_get_arch(arch_id).cfg
    ref_moe = ref_cfg.moe and dataclasses.replace(
        ref_cfg.moe, **{k: v for k, v in changes.items() if k == "decode_group"})
    ref_cfg = dataclasses.replace(
        ref_cfg, moe=ref_moe,
        **{k: v for k, v in changes.items() if k != "decode_group"})
    for field in ("n_layers", "d_model", "remat", "remat_policy"):
        assert getattr(port.cfg, field) == getattr(ref_cfg, field), field
    if ref_moe is not None:
        assert port.cfg.moe.decode_group == ref_moe.decode_group
    assert written["model_flops"] == R_get_arch(arch_id).model_flops(shape)

    base, what = LOWER_THAN[name]
    other = get_arch(arch_id) if base == "default" else hillclimb.arch_for(base)
    other_rules = "default" if base == "default" else \
        REFERENCE_LM_KNOBS[base][2]
    assert _count(port, shape, rules_name, what) < \
        _count(other, shape, other_rules, what)
    with pytest.raises(KeyError, match="unknown hillclimb iteration"):
        hillclimb.run_iteration("flexvec-5")
