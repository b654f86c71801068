"""Architecture registry: ``--arch <id>`` resolves here.

The port of ``repro.configs``: the paper's own retrieval config
(flexvec) and the five assigned LM architectures are ported; the GNN and
recsys architectures are not yet (ROADMAP Queue 1 item 5), and asking for
one raises.  Each ArchSpec knows its cells, a reduced smoke config, its
own count of each step's work, and how to build (step_fn, meta inputs)
for the dry run and the card.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.flexvec import FLEXVEC_ARCHS
from repro_torch.configs.lm import LM_ARCHS

REGISTRY: Dict[str, ArchSpec] = {a.arch_id: a for a in LM_ARCHS + FLEXVEC_ARCHS}

ASSIGNED = [
    "granite-34b", "minitron-4b", "internlm2-1.8b",
    "granite-moe-1b-a400m", "qwen3-moe-235b-a22b",
    "pna",
    "bst", "autoint", "dlrm-mlperf", "two-tower-retrieval",
]


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id in REGISTRY:
        return REGISTRY[arch_id]
    if arch_id in ASSIGNED:
        raise KeyError(f"arch {arch_id!r} is not ported yet: the GNN and "
                       f"recsys architectures wait for ROADMAP Queue 1 item 5")
    raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}")
