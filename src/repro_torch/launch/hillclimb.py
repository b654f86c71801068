"""Perf hillclimb: the flexvec iterations, each one dry-run cell.

The port of ``repro.launch.hillclimb``'s flexvec part.  Each iteration is
one call of :func:`repro_torch.launch.dryrun.run_cell` with a
:class:`~repro_torch.configs.flexvec.FlexvecArch` variant over the
abstract production mesh: the step runs on the meta device and is counted
at the H100's figures, so no card is needed.

    python -m repro_torch.launch.hillclimb [iteration ...]   # default: all

Iterations (the reference's names and knobs):
    flexvec-1   corpus_all rules    (score on 256 devices, not 16)
    flexvec-2   + bf16 corpus       (halve the scoring stream)
    flexvec-3   + mmr_vmem          (the MMR pool counted as resident)
    flexvec-4   + two_stage         (shard-local top-k, union merge)
    flexvec-6   + mmr_shards = 16   (the MMR batch split over 'batch')
    flexvec-67m, flexvec-67m-multipod
                everything above on the 67M-chunk corpus, one pod / two

In the port ``mmr_vmem`` changes only ``cost_corrections``
(``configs/flexvec.py``, ``FlexvecArch.cost_corrections``): it counts the
pool as read once instead of every step, and changes no kernel, since K3
keeps the pool in its cluster's shared memory either way.  ``corpus_all``
maps the corpus over both mesh axes, which the abstract meshes take; a
``DeviceMesh`` with both axes above 1 refuses it (``dist/sharding.py``),
so the hillclimb runs on abstract meshes only.  The ``qwen3-*`` and
``granite-*`` iterations wait for ROADMAP Queue 1 item 4 and raise
``KeyError``.

Each iteration writes ``reports/perf/torch/<name>.json`` in the dry run's
schema and prints the reference's one-line summary.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, Tuple

import torch

PERF_DIR = Path(__file__).resolve().parents[3] / "reports" / "perf" / "torch"

# name -> (shape, multi_pod, FlexvecArch knobs, mmr_shards); every
# iteration runs the corpus_all rules
_ALL = dict(dtype=torch.bfloat16, mmr_vmem=True, two_stage=True)
ITERATIONS: Dict[str, Tuple[str, bool, dict, int]] = {
    "flexvec-1": ("corpus_1m", False, {}, 1),
    "flexvec-2": ("corpus_1m", False, dict(dtype=torch.bfloat16), 1),
    "flexvec-3": ("corpus_1m", False,
                  dict(dtype=torch.bfloat16, mmr_vmem=True), 1),
    "flexvec-4": ("corpus_1m", False, _ALL, 1),
    "flexvec-6": ("corpus_1m", False, _ALL, 16),
    "flexvec-67m": ("corpus_67m", False, _ALL, 16),
    "flexvec-67m-multipod": ("corpus_67m", True, _ALL, 16),
}
RULES = "corpus_all"


def arch_for(name: str):
    """The :class:`FlexvecArch` variant of iteration ``name``."""
    from repro_torch.configs.flexvec import FlexvecArch

    if name not in ITERATIONS:
        if name.startswith(("qwen3-", "granite-")):
            raise KeyError(f"hillclimb iteration {name!r} is not ported yet: "
                           f"the LM iterations wait for ROADMAP Queue 1 "
                           f"item 4")
        raise KeyError(f"unknown hillclimb iteration {name!r}; known: "
                       f"{sorted(ITERATIONS)}")
    _, _, knobs, mmr_shards = ITERATIONS[name]
    arch = FlexvecArch(**knobs)
    arch.mmr_shards = mmr_shards
    return arch


def run_iteration(name: str) -> dict:
    """Run iteration ``name``, write its JSON under :data:`PERF_DIR` and
    print its summary line; returns the report."""
    from repro_torch.launch.dryrun import run_cell

    arch = arch_for(name)
    shape, multi_pod, _, _ = ITERATIONS[name]
    out = run_cell("flexvec", shape, multi_pod, RULES, arch_obj=arch)
    PERF_DIR.mkdir(parents=True, exist_ok=True)
    (PERF_DIR / f"{name}.json").write_text(
        json.dumps(out, indent=2, default=str))
    print(f"[{name}] bottleneck={out['bottleneck']} "
          f"t_comp={out['t_compute_s']:.4g}s t_mem={out['t_memory_s']:.4g}s "
          f"t_coll={out['t_collective_s']:.4g}s "
          f"useful={out.get('useful_flops_ratio')} "
          f"frac={out['roofline_fraction']:.5f}", flush=True)
    return out


def main() -> None:
    for name in sys.argv[1:] or list(ITERATIONS):
        run_iteration(name)


if __name__ == "__main__":
    main()
