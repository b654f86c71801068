"""Architecture registry: ``--arch <id>`` resolves here.

The port of ``repro.configs``: the ten assigned architectures (five LM,
PNA, four recsys) and the paper's own retrieval config (flexvec).  Each
ArchSpec knows its cells, a reduced smoke config, its own count of each
step's work, and how to build (step_fn, meta inputs) for the dry run and
the card.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.flexvec import FLEXVEC_ARCHS
from repro_torch.configs.gnn import GNN_ARCHS
from repro_torch.configs.lm import LM_ARCHS
from repro_torch.configs.recsys_archs import RECSYS_ARCHS

REGISTRY: Dict[str, ArchSpec] = {
    a.arch_id: a
    for a in (*LM_ARCHS, *GNN_ARCHS, *RECSYS_ARCHS, *FLEXVEC_ARCHS)}

ASSIGNED = [
    "granite-34b", "minitron-4b", "internlm2-1.8b",
    "granite-moe-1b-a400m", "qwen3-moe-235b-a22b",
    "pna",
    "bst", "autoint", "dlrm-mlperf", "two-tower-retrieval",
]


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]
