"""PNA — Principal Neighbourhood Aggregation [arXiv:2004.05718].

The port of ``repro.models.pna``.  Multi-aggregator message passing: per
node, the in-neighbour messages are reduced with {mean, max, min, std} and
each aggregate is scaled by {identity, amplification, attenuation} degree
scalers — 12 aggregate blocks per layer, concatenated with the node state
and mixed by a linear update.

The reference's ``jax.ops.segment_sum/max/min`` over the edge index are
``index_add`` and ``scatter_reduce`` here.  A max or min segment starts
from -inf or +inf (JAX's identities), so an empty one comes out as JAX's
does before the clean-up, and the gradient of a max or min is split
evenly among the messages that tie for it, as JAX's scatter-max does
(ties are common: after the ReLU many messages are exactly 0).  Padded
edges point at a sink node (``data/graph.py``) and carry ``edge_mask`` 0.

Two paths compute the same layer, chosen from the shapes alone.  The
whole-edge path holds every edge's message at once, and autograd keeps
about ``_edge_bytes(d)`` a layer for each edge for the backward.  Where
that passes ``EDGE_BUDGET`` (ogb_products' 61.9M edges: about 120 GB a
layer), :func:`forward` takes the edge-chunked path instead:
:class:`_ChunkedAggregate` walks the edges in chunks of ``EDGE_BUDGET``
bytes, folds each chunk's messages into node-sized sums, running maxima
and minima and counts of the messages tied for them, and saves nothing
edge-sized but the graph's own index vectors; its backward recomputes
each chunk's messages with the same boundaries, shapes and operations, so
they are bit-equal to the forward's and the ties are found again.  Each
layer then runs under ``torch.utils.checkpoint``, so a step keeps only
the layers' inputs and the node side is recomputed too.  Smaller graphs
(every other cell) take the whole-edge path.

On the card ``index_add`` sums with atomics in no fixed order, so a PNA
loss there is not bit-reproducible from run to run, on either path.

Entry points run on the card unless the caller asks for the CPU
(``init_params(..., device="cpu")``); a missing card raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


BIG = 1e30   # the reference's sentinel for padded edges in max and min


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
    real = edge_w[:, None] > 0
    mx = _segment_extreme(torch.where(real, msgs, -BIG), dst, n_nodes, "amax")
    mn = _segment_extreme(torch.where(real, msgs, BIG), dst, n_nodes, "amin")
    empty = (cnt < 0.5)[:, None]
    mx = torch.where(empty | (mx <= -BIG), 0.0, mx)
    mn = torch.where(empty | (mn >= BIG), 0.0, mn)
    return mean, mx, mn, std, cnt


def _message_inputs(h, src, dst):
    return torch.cat([h.index_select(0, src), h.index_select(0, dst)],
                     dim=-1)                                    # (E, 2d)


def _messages(h, msg_w, msg_b, src, dst, edge_w):
    """The edge-chunked path's messages of the edges given,
    ``relu([h[src] || h[dst]] @ msg_w + msg_b) * edge_w`` as the
    whole-edge path computes them, with the inputs and the product before
    the ReLU that the backward needs."""
    m_in = _message_inputs(h, src, dst)
    z = m_in @ msg_w + msg_b
    return m_in, z, F.relu(z) * edge_w[:, None]


def _fold_extreme(run, ties, vals, dst, reduce):
    """Fold a chunk's masked messages ``vals`` into the running segment
    extreme ``run`` (in place) and ``ties``, the count of messages equal
    to it: a segment whose extreme the chunk beats restarts its count."""
    old = run.clone()
    run.scatter_reduce_(0, dst[:, None].expand_as(vals), vals, reduce,
                        include_self=True)
    ties.mul_(run == old).index_add_(
        0, dst, (vals == run.index_select(0, dst)).to(ties.dtype))


class _ChunkedAggregate(torch.autograd.Function):
    """The message product and the four aggregators of one layer, as
    ``_messages`` then ``_segment_reduce`` compute them, over the edges in
    chunks of ``chunk``.  The forward keeps node-sized sums of the
    messages and of their squares, the in-edge count, running maxima and
    minima and the counts of messages tied for them; it saves ``h``, the
    params, the index vectors and those node-sized results.  The backward
    recomputes each chunk's messages as the forward made them (the same
    boundaries, shapes and operations, so the same bits: a tie found in
    the forward is found again), routes the four aggregates' gradients to
    them, a max's or min's split evenly among its ties, and adds the
    gradients of ``h``, ``msg_w`` and ``msg_b`` chunk by chunk."""

    @staticmethod
    def forward(ctx, h, msg_w, msg_b, src, dst, edge_w, chunk):
        n, d = h.shape[0], msg_w.shape[1]
        s, sq, mx_ties, mn_ties = (h.new_zeros((n, d)) for _ in range(4))
        mx = h.new_full((n, d), float("-inf"))
        mn = h.new_full((n, d), float("inf"))
        for lo in range(0, src.shape[0], chunk):
            c_dst, c_w = dst[lo:lo + chunk], edge_w[lo:lo + chunk]
            msgs = _messages(h, msg_w, msg_b, src[lo:lo + chunk], c_dst,
                             c_w)[2]
            s.index_add_(0, c_dst, msgs)
            sq.index_add_(0, c_dst, msgs * msgs)
            real = c_w[:, None] > 0
            _fold_extreme(mx, mx_ties, torch.where(real, msgs, -BIG), c_dst,
                          "amax")
            _fold_extreme(mn, mn_ties, torch.where(real, msgs, BIG), c_dst,
                          "amin")
            del msgs, real
        cnt = edge_w.new_zeros((n,)).index_add(0, dst, edge_w)
        deg = torch.clamp(cnt, min=1.0)[:, None]
        mean = s / deg
        sq = sq / deg
        std = torch.sqrt(F.relu(sq - mean * mean) + 1e-5)
        empty = (cnt < 0.5)[:, None]
        out_mx = torch.where(empty | (mx <= -BIG), 0.0, mx)
        out_mn = torch.where(empty | (mn >= BIG), 0.0, mn)
        ctx.chunk = chunk
        ctx.save_for_backward(h, msg_w, msg_b, src, dst, edge_w, cnt, mean,
                              sq, std, mx, mn, mx_ties, mn_ties)
        ctx.mark_non_differentiable(cnt)
        return mean, out_mx, out_mn, std, cnt

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_mean, g_mx, g_mn, g_std, _g_cnt):
        (h, msg_w, msg_b, src, dst, edge_w, cnt, mean, sq, std, mx, mn,
         mx_ties, mn_ties) = ctx.saved_tensors
        d, chunk = msg_w.shape[1], ctx.chunk
        deg = torch.clamp(cnt, min=1.0)[:, None]
        # std = sqrt(relu(sq - mean^2) + 1e-5), sq = sum(m^2) / deg,
        # mean = sum(m) / deg: node-sized gradients of the two sums
        g_var = g_std * 0.5 / std * (sq - mean * mean > 0)
        g_s = (g_mean - 2.0 * mean * g_var) / deg
        g_sq = g_var / deg
        # a cleaned segment (empty, or only padded edges) takes none
        empty = (cnt < 0.5)[:, None]
        g_mx = torch.where(empty | (mx <= -BIG), 0.0, g_mx / mx_ties)
        g_mn = torch.where(empty | (mn >= BIG), 0.0, g_mn / mn_ties)
        g_h = torch.zeros_like(h)
        g_w = torch.zeros_like(msg_w)
        g_b = torch.zeros_like(msg_b)
        for lo in range(0, src.shape[0], chunk):
            c_src, c_dst = src[lo:lo + chunk], dst[lo:lo + chunk]
            c_w = edge_w[lo:lo + chunk]
            m_in, z, msgs = _messages(h, msg_w, msg_b, c_src, c_dst, c_w)
            real = c_w[:, None] > 0
            g = g_s.index_select(0, c_dst)
            g += 2.0 * msgs * g_sq.index_select(0, c_dst)
            g += torch.where(torch.where(real, msgs, -BIG)
                             == mx.index_select(0, c_dst),
                             g_mx.index_select(0, c_dst), 0.0)
            g += torch.where(torch.where(real, msgs, BIG)
                             == mn.index_select(0, c_dst),
                             g_mn.index_select(0, c_dst), 0.0)
            del msgs, real
            g *= c_w[:, None]
            g = torch.where(z > 0, g, 0.0)            # back through the ReLU
            del z
            g_w.addmm_(m_in.t(), g)
            g_b += g.sum(0)
            g_in = g @ msg_w.t()                                  # (C, 2d)
            del m_in, g
            g_h.index_add_(0, c_src, g_in[:, :d])
            g_h.index_add_(0, c_dst, g_in[:, d:])
            del g_in
        return g_h, g_w, g_b, None, None, None, None


# Bytes of edge-sized temporaries a layer may hold: past it the layer
# takes the edge-chunked path, in chunks of about this many bytes
EDGE_BUDGET = 4 << 30


def _edge_bytes(d: int, esize: int) -> int:
    """The whole-edge path's temporaries an edge, for one layer: the
    message inputs (2d), the product, the messages, their squares, the
    two masked copies (5d), and two boolean masks (d each)."""
    return 7 * d * esize + 2 * d


def edge_chunk(n_edges: int, d: int, dtype: torch.dtype,
               budget: float = EDGE_BUDGET) -> Optional[int]:
    """Edges a chunk on the edge-chunked path, or None where the
    whole-edge path's temporaries fit ``budget``: from the shapes alone."""
    per_edge = _edge_bytes(d, torch.finfo(dtype).bits // 8)
    if n_edges * per_edge <= budget:
        return None
    return max(1, int(budget // per_edge))


def pna_layer(h, lp, edge_src, edge_dst, edge_w, cfg: PNAConfig,
              chunk: Optional[int] = None):
    """One layer; ``chunk`` edges at a time (:class:`_ChunkedAggregate`)
    or, where it is None, all at once."""
    n = h.shape[0]
    if chunk is None:
        msgs = F.relu(_message_inputs(h, edge_src, edge_dst) @ lp["msg_w"]
                      + lp["msg_b"])                            # (E, d)
        mean, mx, mn, std, cnt = _segment_reduce(msgs, edge_dst, n, edge_w)
    else:
        mean, mx, mn, std, cnt = _ChunkedAggregate.apply(
            h, lp["msg_w"], lp["msg_b"], edge_src, edge_dst, edge_w, chunk)
    agg = torch.cat([mean, mx, mn, std], dim=-1)                # (N, 4d)
    logd = torch.log1p(cnt)[:, None]
    amp = logd / cfg.delta
    att = cfg.delta / torch.clamp(logd, min=1e-5)
    scaled = torch.cat([agg, agg * amp, agg * att], dim=-1)     # (N, 12d)
    upd_in = torch.cat([h, scaled], dim=-1)
    return F.relu(upd_in @ lp["upd_w"] + lp["upd_b"]) + h       # residual


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: PNAConfig,
            rules: ShardingRules, edge_budget: float = EDGE_BUDGET
            ) -> torch.Tensor:
    """Logits of every node, or of every graph of a graph task.  Where the
    whole-edge path's temporaries pass ``edge_budget`` (see
    :func:`edge_chunk`), each layer takes the edge-chunked path under
    ``torch.utils.checkpoint``."""
    feats = batch["feats"].to(cfg.dtype)
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    edge_w = batch["edge_mask"].to(cfg.dtype)
    chunk = edge_chunk(src.shape[0], cfg.d_hidden, cfg.dtype, edge_budget)
    h = F.relu(feats @ params["embed_w"] + params["embed_b"])
    h = constrain(h, rules, "nodes", None)
    for lp in params["layers"]:
        if chunk is None:
            h = pna_layer(h, lp, src, dst, edge_w, cfg)
        else:
            h = checkpoint(pna_layer, h, lp, src, dst, edge_w, cfg, chunk,
                           use_reentrant=False, preserve_rng_state=False)
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


def loss_fn(params, batch, cfg: PNAConfig, rules: ShardingRules,
            edge_budget: float = EDGE_BUDGET) -> torch.Tensor:
    logits = forward(params, batch, cfg, rules,
                     edge_budget).to(torch.float32)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels[:, None])[:, 0]
    ce = logz - gold
    if cfg.task == "graph":
        return ce.mean()
    w = batch["node_mask"].to(torch.float32)
    return torch.sum(ce * w) / torch.clamp(torch.sum(w), min=1.0)
