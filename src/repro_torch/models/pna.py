"""PNA — Principal Neighbourhood Aggregation [arXiv:2004.05718].

The port of ``repro.models.pna``.  Multi-aggregator message passing: per
node, the in-neighbour messages are reduced with {mean, max, min, std} and
each aggregate is scaled by {identity, amplification, attenuation} degree
scalers — 12 aggregate blocks per layer, concatenated with the node state
and mixed by a linear update.

The reference's ``jax.ops.segment_sum/max/min`` over the edge index are
``index_add`` and ``scatter_reduce`` here.  A max or min segment starts
from -inf or +inf (JAX's identities), so an empty segment comes out as
JAX's does before the clean-up, and the backward of ``scatter_reduce``
splits a segment's gradient evenly among the messages that tie for its
max or min, as JAX's scatter-max does (ties are common: after the ReLU
many messages are exactly 0).  Padded edges point at a sink node
(``data/graph.py``) and carry ``edge_mask`` 0.

On the card ``index_add`` sums with atomics in no fixed order, so a PNA
loss there is not bit-reproducible from run to run.

Entry points run on the card unless the caller asks for the CPU
(``init_params(..., device="cpu")``); a missing card raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import ShardingRules, constrain
from repro_torch.models import Draws, params_from_numpy  # noqa: F401

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str
    n_layers: int = 4
    d_hidden: int = 75
    d_feat: int = 128
    n_classes: int = 16
    task: str = "node"            # node | graph
    n_graphs: int = 1             # graph task: graphs per batch (static)
    delta: float = 2.5            # mean log-degree normalizer (PNA eq. 5)
    dtype: torch.dtype = torch.float32


AGGS = ("mean", "max", "min", "std")
N_SCALERS = 3  # identity, amplification, attenuation


def param_shapes(cfg: PNAConfig) -> Params:
    """The params tree's shapes (the reference's ``init_params`` tree)."""
    d = cfg.d_hidden
    return {
        "embed_w": (cfg.d_feat, d), "embed_b": (d,),
        "layers": [{"msg_w": (2 * d, d), "msg_b": (d,),
                    "upd_w": (d + len(AGGS) * N_SCALERS * d, d),
                    "upd_b": (d,)} for _ in range(cfg.n_layers)],
        "readout_w": (d, cfg.n_classes), "readout_b": (cfg.n_classes,),
    }


def init_params(cfg: PNAConfig, seed: int = 0, *,
                device: Any = "cuda") -> Params:
    """Seeded params in ``cfg.dtype``: biases zero, each matrix He-normal
    (N(0, 2 / fan_in)), drawn in tree order by one generator on
    ``device`` (empty on the meta device).  The draws differ from the
    reference's ``jax.random``; to hold the two against each other, carry
    the reference's params across with :func:`params_from_numpy`."""
    draw = Draws(seed, device, cfg.dtype)

    def conv(tree):
        if isinstance(tree, list):
            return [conv(t) for t in tree]
        return {k: conv(v) if isinstance(v, (dict, list))
                else draw.normal(v, (2.0 / v[0]) ** 0.5) if len(v) == 2
                else draw.zeros(v) for k, v in tree.items()}

    return conv(param_shapes(cfg))


def _segment_extreme(vals, dst, n_nodes, reduce):
    """``jax.ops.segment_max`` / ``segment_min``: each segment starts at
    the reduction's identity (-inf / +inf), so an empty one keeps it."""
    fill = float("-inf") if reduce == "amax" else float("inf")
    out = torch.full((n_nodes, vals.shape[1]), fill, dtype=vals.dtype,
                     device=vals.device)
    return out.scatter_reduce(0, dst[:, None].expand_as(vals), vals, reduce,
                              include_self=True)


def _segment_reduce(msgs, dst, n_nodes, edge_w):
    """All four PNA aggregators in one pass over the edge list."""
    msgs = msgs * edge_w[:, None]
    d = msgs.shape[1]
    s = msgs.new_zeros((n_nodes, d)).index_add(0, dst, msgs)
    cnt = edge_w.new_zeros((n_nodes,)).index_add(0, dst, edge_w)
    deg = torch.clamp(cnt, min=1.0)[:, None]
    mean = s / deg
    sq = msgs.new_zeros((n_nodes, d)).index_add(0, dst, msgs * msgs) / deg
    std = torch.sqrt(F.relu(sq - mean * mean) + 1e-5)
    # max/min: mask padded edges to +/- sentinels, then clean empties
    big = 1e30
    real = edge_w[:, None] > 0
    mx = _segment_extreme(torch.where(real, msgs, -big), dst, n_nodes, "amax")
    mn = _segment_extreme(torch.where(real, msgs, big), dst, n_nodes, "amin")
    empty = (cnt < 0.5)[:, None]
    mx = torch.where(empty | (mx <= -big), 0.0, mx)
    mn = torch.where(empty | (mn >= big), 0.0, mn)
    return mean, mx, mn, std, cnt


def pna_layer(h, lp, edge_src, edge_dst, edge_w, cfg: PNAConfig):
    n = h.shape[0]
    m_in = torch.cat([h.index_select(0, edge_src),
                      h.index_select(0, edge_dst)], dim=-1)     # (E, 2d)
    msgs = F.relu(m_in @ lp["msg_w"] + lp["msg_b"])             # (E, d)
    mean, mx, mn, std, cnt = _segment_reduce(msgs, edge_dst, n, edge_w)
    agg = torch.cat([mean, mx, mn, std], dim=-1)                # (N, 4d)
    logd = torch.log1p(cnt)[:, None]
    amp = logd / cfg.delta
    att = cfg.delta / torch.clamp(logd, min=1e-5)
    scaled = torch.cat([agg, agg * amp, agg * att], dim=-1)     # (N, 12d)
    upd_in = torch.cat([h, scaled], dim=-1)
    return F.relu(upd_in @ lp["upd_w"] + lp["upd_b"]) + h       # residual


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: PNAConfig,
            rules: ShardingRules) -> torch.Tensor:
    feats = batch["feats"].to(cfg.dtype)
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    edge_w = batch["edge_mask"].to(cfg.dtype)
    h = F.relu(feats @ params["embed_w"] + params["embed_b"])
    h = constrain(h, rules, "nodes", None)
    for lp in params["layers"]:
        h = pna_layer(h, lp, src, dst, edge_w, cfg)
        h = constrain(h, rules, "nodes", None)
    if cfg.task == "graph":
        gid = batch["graph_ids"].long()
        w = batch["node_mask"].to(cfg.dtype)[:, None]
        pooled = h.new_zeros((cfg.n_graphs, h.shape[1])).index_add(
            0, gid, h * w)
        cnt = w.new_zeros((cfg.n_graphs, 1)).index_add(0, gid, w)
        pooled = pooled / torch.clamp(cnt, min=1.0)              # mean pool
        return pooled @ params["readout_w"] + params["readout_b"]  # (G, C)
    return h @ params["readout_w"] + params["readout_b"]          # (N, C)


def loss_fn(params, batch, cfg: PNAConfig, rules: ShardingRules) -> torch.Tensor:
    logits = forward(params, batch, cfg, rules).to(torch.float32)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels[:, None])[:, 0]
    ce = logz - gold
    if cfg.task == "graph":
        return ce.mean()
    w = batch["node_mask"].to(torch.float32)
    return torch.sum(ce * w) / torch.clamp(torch.sum(w), min=1.0)
