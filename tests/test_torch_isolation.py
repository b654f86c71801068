"""The port stands alone: no JAX, nothing of ``repro``, the card by default.

* A fresh interpreter imports every ``repro_torch`` module and finds
  neither ``jax`` nor any ``repro`` or ``benchmarks`` module loaded.
* No source of the port (nor ``chip_smoke.py``, which drives it on the
  card) imports JAX, the reference package or its benchmarks.
* The entry points default to the card and raise where there is none,
  instead of running on the CPU.
* A spawned shard worker, which imports the port afresh, loads neither.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_modules_load_no_jax_and_no_reference():
    mods = _port_modules()
    assert {"repro_torch.core.backends", "repro_torch.dist",
            "repro_torch.dist.pem_sharded", "repro_torch.dist.procgroup",
            "repro_torch.dist.sharding", "repro_torch.dist.tuned",
            "repro_torch.configs", "repro_torch.configs.flexvec",
            "repro_torch.roofline.analysis", "repro_torch.launch.mesh",
            "repro_torch.launch.dryrun", "repro_torch.metrics",
            "repro_torch.metrics.ranking", "repro_torch.data.beir",
            "repro_torch.bench.behavioral",
            "repro_torch.launch.hillclimb", "repro_torch.models.layers",
            "repro_torch.models.transformer", "repro_torch.train.optimizer",
            "repro_torch.train.loop", "repro_torch.train.checkpoint",
            "repro_torch.train.elastic", "repro_torch.data.loader",
            "repro_torch.serve.lm_engine", "repro_torch.configs.lm",
            "repro_torch.launch.train", "repro_torch.models.pna",
            "repro_torch.models.recsys", "repro_torch.data.graph",
            "repro_torch.data.recsys", "repro_torch.configs.gnn",
            "repro_torch.configs.recsys_archs"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'repro', 'benchmarks'))\n"
        "print(len(sys.modules) and ','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"loaded: {out.stdout.strip()}"


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)"
    r"|from\s+repro\b(?!_)|import\s+benchmarks\b|from\s+benchmarks\b)",
    re.M)


def test_port_sources_import_no_jax_and_no_reference():
    sources = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(p.relative_to(ROOT)) for p in sources
                 if _FORBIDDEN.search(p.read_text())]
    assert offenders == []


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run there")
    import sqlite3

    from repro_torch.bench import behavioral
    from repro_torch.core.backends import (HopperBackend, ShardedBackend,
                                           TorchBackend)
    from repro_torch.core.vectorcache import VectorCache
    from repro_torch.dist.procgroup import ProcessGroup
    from repro_torch.serve.engine import BatchedRetrievalEngine
    from repro_torch.serve.retrieval import RetrievalService
    from repro_torch.sqlio.schema import build_schema

    with pytest.raises(RuntimeError, match="no CUDA device"):
        HopperBackend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HopperBackend("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBackend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBackend("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        behavioral.run(datasets=["nfcorpus-like"])
    conn = sqlite3.connect(":memory:")
    build_schema(conn, "empty")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RetrievalService(conn, dim=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedRetrievalEngine(VectorCache([1], np.ones((1, 8), np.float32)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedBackend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedBackend(["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProcessGroup(8, 2)
    svc = RetrievalService(conn, dim=8, engine="fused-numpy")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svc.shard_group(2)
    # the LM: params, caches and the engine (on its params' device)
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.serve.lm_engine import LMDecodeEngine

    cfg = get_arch("internlm2-1.8b").smoke_cfg
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.make_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.params_from_numpy({"embed": np.zeros((2, 2), np.float32)}, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LMDecodeEngine(cfg, T.init_params(cfg), None)
    engine = LMDecodeEngine(cfg, T.init_params(cfg, device="cpu"), None)
    assert engine.cache[0].device.type == "cpu"
    # the GNN and recsys families: params and the archs' smoke paths
    from repro_torch.models import pna, recsys

    with pytest.raises(RuntimeError, match="no CUDA device"):
        pna.init_params(get_arch("pna")._cfg(
            {"d_feat": 8, "n_classes": 2, "task": "node"}))
    for arch_id in ("bst", "autoint", "dlrm-mlperf", "two-tower-retrieval"):
        arch = get_arch(arch_id)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            arch._init(arch.smoke_cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recsys.params_from_numpy({"w": np.zeros((2, 2), np.float32)},
                                 get_arch("bst").smoke_cfg)
    for arch_id in ("pna", "bst"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_arch(arch_id).smoke_run()
    for cli in (["repro_torch.launch.serve", "--chunks", "50"],
                ["repro_torch.bench.behavioral", "--datasets",
                 "nfcorpus-like"],
                ["repro_torch.launch.train", "--arch", "internlm2-1.8b",
                 "--steps", "1"],
                ["repro_torch.launch.train", "--arch", "pna"],
                ["repro_torch.launch.train", "--arch", "two-tower-retrieval"]):
        out = subprocess.run(
            [sys.executable, "-m", *cli],
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            capture_output=True, text=True, timeout=120)
        assert out.returncode != 0 and "no CUDA device" in out.stderr


class _Elsewhere(torch.Tensor):
    """A tensor's metadata on a device no kernel serves (the meta device
    is the dry run's: the wrappers return shapes there).  Any operation
    on it raises, so a wrapper must refuse it before touching it."""

    @staticmethod
    def __new__(cls, *shape):
        return torch.Tensor._make_wrapper_subclass(
            cls, shape, dtype=torch.float32, device=torch.device("ipu"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} ran on a device without a kernel")


def test_wrappers_raise_on_a_device_without_a_kernel():
    from repro_torch.kernels.mmr.ops import mmr_select
    from repro_torch.kernels.pem_score.ops import pem_score
    from repro_torch.kernels.topk.ops import topk

    with pytest.raises(ValueError, match="no kernel"):
        pem_score(_Elsewhere(4, 8), _Elsewhere(8, 2), _Elsewhere(8, 2))
    with pytest.raises(ValueError, match="no kernel"):
        topk(_Elsewhere(2, 10), 3)
    with pytest.raises(ValueError, match="no kernel"):
        mmr_select(_Elsewhere(1, 10, 8), _Elsewhere(1, 10), 3)


def test_spawned_workers_import_no_jax_and_no_reference(tmp_path):
    """A spawned Hopper worker imports the port afresh; with ``jax`` and
    ``repro`` shadowed by modules that raise on import, a process group
    still builds and serves."""
    for name in ("jax", "repro"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            f"raise ImportError('{name} imported by the port')\n")
    code = (
        "import numpy as np\n"
        "from repro_torch.core.grammar import parse\n"
        "from repro_torch.dist.procgroup import ProcessGroup\n"
        "from repro_torch.embed import HashEmbedder\n"
        "if __name__ == '__main__':\n"
        "    e = HashEmbedder(16)\n"
        "    m = e.embed_batch([f'row {i}' for i in range(64)])\n"
        "    with ProcessGroup.build(np.arange(64), m, n_shards=2,\n"
        "                            transport='process', engine='hopper',\n"
        "                            device='cpu') as g:\n"
        "        out = g.search_plan(parse('similar:row 3 pool:5', e))\n"
        "    print(len(out))\n"
    )
    script = tmp_path / "spawn_check.py"
    script.write_text(code)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(ROOT / "src")]))
    r = subprocess.run([sys.executable, str(script)], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "5"
