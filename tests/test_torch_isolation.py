"""The port stands alone: no JAX, nothing of ``repro``, the card by default.

* A fresh interpreter imports every ``repro_torch`` module and finds
  neither ``jax`` nor any ``repro`` module loaded.
* No source of the port (nor ``chip_smoke.py``, which drives it on the
  card) imports JAX or the reference package.
* The entry points default to the card and raise where there is none,
  instead of running on the CPU.
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
    assert "repro_torch.core.backends" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith('jax.') or m == 'repro'"
        " or m.startswith('repro.'))\n"
        "print(len(sys.modules) and ','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"loaded: {out.stdout.strip()}"


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)"
    r"|from\s+repro\b(?!_))", re.M)


def test_port_sources_import_no_jax_and_no_reference():
    sources = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(p.relative_to(ROOT)) for p in sources
                 if _FORBIDDEN.search(p.read_text())]
    assert offenders == []


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run there")
    import sqlite3

    from repro_torch.core.backends import HopperBackend
    from repro_torch.core.vectorcache import VectorCache
    from repro_torch.serve.engine import BatchedRetrievalEngine
    from repro_torch.serve.retrieval import RetrievalService
    from repro_torch.sqlio.schema import build_schema

    with pytest.raises(RuntimeError, match="no CUDA device"):
        HopperBackend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HopperBackend("cuda")
    conn = sqlite3.connect(":memory:")
    build_schema(conn, "empty")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RetrievalService(conn, dim=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedRetrievalEngine(VectorCache([1], np.ones((1, 8), np.float32)))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--chunks", "50"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_wrappers_raise_on_a_device_without_a_kernel():
    from repro_torch.kernels.mmr.ops import mmr_select
    from repro_torch.kernels.pem_score.ops import pem_score
    from repro_torch.kernels.topk.ops import topk

    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no kernel"):
        pem_score(torch.empty(4, 8, device=meta), torch.empty(8, 2, device=meta),
                  torch.empty(8, 2, device=meta))
    with pytest.raises(ValueError, match="no kernel"):
        topk(torch.empty(2, 10, device=meta), 3)
    with pytest.raises(ValueError, match="no kernel"):
        mmr_select(torch.empty(1, 10, 8, device=meta),
                   torch.empty(1, 10, device=meta), 3)
