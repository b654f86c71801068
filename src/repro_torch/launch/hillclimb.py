"""Perf hillclimb: the reference's iterations, each one dry-run cell.

The port of ``repro.launch.hillclimb``.  Each iteration is one call of
:func:`repro_torch.launch.dryrun.run_cell` with a variant of a
:class:`~repro_torch.configs.flexvec.FlexvecArch` or an
:class:`~repro_torch.configs.lm.LMArch` over the abstract production
mesh: the step runs on the meta device and is counted at the H100's
figures, so no card is needed.

    python -m repro_torch.launch.hillclimb [iteration ...]   # default: all

Iterations (the reference's names and knobs):
    flexvec-1   corpus_all rules    (score on 256 devices, not 16)
    flexvec-2   + bf16 corpus       (halve the scoring stream)
    flexvec-3   + mmr_vmem          (the MMR pool counted as resident)
    flexvec-4   + two_stage         (shard-local top-k, union merge)
    flexvec-6   + mmr_shards = 16   (the MMR batch split over 'batch')
    flexvec-67m, flexvec-67m-multipod
                everything above on the 67M-chunk corpus, one pod / two
    qwen3-1     serve_weights rules (EP x TP resident weights for decode)
    qwen3-2     + decode_group = 8  (MoE slots shrink 8x at decode)
    granite-1   remat_policy = dots (stop recomputing the projections)
    granite-2   remat off           (the flops floor; memory counted)

In the port ``mmr_vmem`` changes only ``cost_corrections``
(``configs/flexvec.py``, ``FlexvecArch.cost_corrections``): it counts the
pool as read once instead of every step, and changes no kernel, since K3
keeps the pool in its cluster's shared memory either way.  ``corpus_all``
maps the corpus over both mesh axes, which the abstract meshes take; a
``DeviceMesh`` with both axes above 1 refuses it (``dist/sharding.py``),
so the hillclimb runs on abstract meshes only.

Each iteration writes ``reports/perf/torch/<name>.json`` in the dry run's
schema and prints the reference's one-line summary.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path
from typing import Callable, Dict, Tuple

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

# name -> (arch, shape, rules, LMConfig changes); single-pod mesh
LM_ITERATIONS: Dict[str, Tuple[str, str, str, Callable]] = {
    "qwen3-1": ("qwen3-moe-235b-a22b", "decode_32k", "serve_weights",
                lambda cfg: cfg),
    "qwen3-2": ("qwen3-moe-235b-a22b", "decode_32k", "serve_weights",
                lambda cfg: dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, decode_group=8))),
    "granite-1": ("granite-34b", "train_4k", "default",
                  lambda cfg: dataclasses.replace(cfg, remat_policy="dots")),
    "granite-2": ("granite-34b", "train_4k", "default",
                  lambda cfg: dataclasses.replace(cfg, remat=False)),
}


def arch_for(name: str):
    """The architecture variant of iteration ``name``."""
    if name in LM_ITERATIONS:
        from repro_torch.configs import get_arch
        from repro_torch.configs.lm import LMArch

        arch_id, _, _, change = LM_ITERATIONS[name]
        base = get_arch(arch_id)
        return LMArch(arch_id, base.source, change(base.cfg), base.smoke_cfg)
    from repro_torch.configs.flexvec import FlexvecArch

    if name not in ITERATIONS:
        raise KeyError(f"unknown hillclimb iteration {name!r}; known: "
                       f"{sorted(ITERATIONS) + sorted(LM_ITERATIONS)}")
    _, _, knobs, mmr_shards = ITERATIONS[name]
    arch = FlexvecArch(**knobs)
    arch.mmr_shards = mmr_shards
    return arch


def run_iteration(name: str) -> dict:
    """Run iteration ``name``, write its JSON under :data:`PERF_DIR` and
    print its summary line; returns the report."""
    from repro_torch.launch.dryrun import run_cell

    arch = arch_for(name)
    if name in LM_ITERATIONS:
        arch_id, shape, rules, _ = LM_ITERATIONS[name]
        out = run_cell(arch_id, shape, False, rules, arch_obj=arch)
    else:
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
    for name in sys.argv[1:] or list(ITERATIONS) + list(LM_ITERATIONS):
        run_iteration(name)


if __name__ == "__main__":
    main()
