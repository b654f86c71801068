"""The port's flexvec hillclimb iterations against the reference's
arithmetic, on the CPU with no card and no JAX compile.

Each of the seven flexvec iterations runs the port's dry run
(``run_cell`` over the abstract production mesh) and writes its JSON in
the dry run's schema.  Its cell, its sharding rules and its
``cost_corrections`` must equal the reference's ``FlexvecArch`` built
with the same knobs (``src/repro/launch/hillclimb.py``, mirrored in
``REFERENCE_KNOBS``) and the reference's rules over
``jax.sharding.AbstractMesh``, which needs no devices.  The reference's
hillclimb module itself is not imported: it forces 512 host devices on
import.
"""

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


@pytest.mark.parametrize("name", ["qwen3-1", "qwen3-2", "granite-1",
                                  "granite-2"])
def test_lm_iterations_wait_for_queue_1_item_4(name, tmp_path, monkeypatch):
    monkeypatch.setattr(hillclimb, "PERF_DIR", tmp_path)
    with pytest.raises(KeyError, match="Queue 1 item 4"):
        hillclimb.run_iteration(name)
    assert not list(tmp_path.iterdir())
    with pytest.raises(KeyError, match="unknown hillclimb iteration"):
        hillclimb.run_iteration("flexvec-5")
