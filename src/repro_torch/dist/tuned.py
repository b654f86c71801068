"""Named sharding-rule variants (the hillclimb's tuning axis).

The port of ``repro.dist.tuned``.

``default``       — FSDP x TP baseline (dist/sharding.py).
``corpus_all``    — flexvec corpus rows over EVERY mesh axis, not just
                    'data': scoring runs on all 256 devices instead of 16
                    (67M chunks -> 134 MB a device).
``serve_weights`` — MoE expert-FFN columns over 'data' so serving weights
                    are fully resident (EP x TP), eliminating the per-step
                    FSDP all-gather during decode.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.dist.sharding import ShardingRules, default_rules, mesh_shape


def get_rules(name: str, mesh: Any) -> ShardingRules:
    """Resolve a rules variant by name for the given mesh."""
    base = default_rules(mesh)
    if name == "default":
        return base
    if name == "corpus_all":
        return _replace(base, corpus=tuple(mesh_shape(mesh)))
    if name == "serve_weights":
        return _replace(base, moe_ff="data")
    raise KeyError(
        f"unknown rules variant {name!r}; known: default, corpus_all, serve_weights"
    )


def _replace(rules: ShardingRules, **updates) -> ShardingRules:
    merged = dict(rules.rules)
    merged.update(updates)
    return dataclasses.replace(rules, rules=merged)
