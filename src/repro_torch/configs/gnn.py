"""PNA architecture cells [arXiv:2004.05718].

The port of ``repro.configs.gnn``.  Shapes (assignment):
    full_graph_sm  n=2,708  e=10,556   d_feat=1,433 (Cora-scale, full batch)
    minibatch_lg   n=232,965 e=114.6M  seeds=1,024 fanout 15-10 (Reddit-scale,
                   REAL neighbor sampler -> padded subgraph, static shapes)
    ogb_products   n=2,449,029 e=61.9M d_feat=100 (full-batch-large)
    molecule       30 nodes / 64 edges x batch 128 (graph-level task)

``build`` gives each cell's train step over meta tensors of the global
shapes (the reference's ``pjit`` view); the dry run runs it on the meta
device.  :meth:`PNAArch.step_cost` is the port's own count of one
device's step (:func:`pna_step_cost`).

ogb_products trains on one card: its 61,859,328 padded edges pass
``models.pna.EDGE_BUDGET``, so ``pna.forward`` takes the edge-chunked
path (33 chunks of 1,908,874 edges in f32, each layer recomputed under
``torch.utils.checkpoint``, the messages recomputed bit-equal in the
backward), where the whole-edge path would keep about 120 GB a layer.
The other three cells take the whole-edge path.  On the card
``index_add`` adds with atomics, so PNA's loss is not bit-reproducible.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch.configs.base import (ArchSpec, LoweredSpec, ShapeCell, meta,
                                      named_leaves, train_spec)
from repro_torch.data.graph import (CSRGraph, _max_edges, _max_nodes,
                                    make_graph, make_molecule_batch,
                                    sample_subgraph)
from repro_torch.dist.sharding import ShardingRules, default_rules
from repro_torch.models import pna
from repro_torch.roofline.analysis import KernelWork, StepCost
from repro_torch.train.optimizer import loss_and_grads

GNN_SHAPES: Dict[str, Dict[str, Any]] = {
    "full_graph_sm": dict(kind="train", n=2708, e=10556, d_feat=1433,
                          n_classes=7, task="node"),
    "minibatch_lg": dict(kind="train", seeds=1024, fanouts=(15, 10), d_feat=602,
                         n_classes=41, task="node"),
    "ogb_products": dict(kind="train", n=2_449_029, e=61_859_140, d_feat=100,
                         n_classes=47, task="node"),
    "molecule": dict(kind="train", batch=128, nodes=30, edges=64, d_feat=28,
                     n_classes=2, task="graph"),
}


def _round512(x: int) -> int:
    """Pad node/edge budgets to a 512 multiple so they shard evenly on any
    production mesh axis combination. Padding is masked (sink node), exactly
    as the data pipeline pads sampled subgraphs (data/graph.py)."""
    return (x + 511) // 512 * 512


def _shape_dims(s: Dict[str, Any]):
    if "seeds" in s:
        n = _max_nodes(s["seeds"], s["fanouts"]) + 1
        e = _max_edges(s["seeds"], s["fanouts"])
    elif "batch" in s:
        n, e = s["batch"] * s["nodes"], s["batch"] * s["edges"]
    else:
        n, e = s["n"], s["e"]
    return _round512(n), _round512(e)


def graph_batch(g, device: Any) -> Dict[str, torch.Tensor]:
    """A ``GraphBatch``'s arrays as the model's batch on ``device``."""
    out = {k: torch.from_numpy(getattr(g, k)).to(device)
           for k in ("feats", "edge_src", "edge_dst", "labels", "node_mask",
                     "edge_mask")}
    if g.graph_ids is not None:
        out["graph_ids"] = torch.from_numpy(g.graph_ids).to(device)
    return out


def pna_step_cost(cfg: pna.PNAConfig, n: int, e: int, n_out: int,
                  rules: ShardingRules) -> StepCost:
    """One device's count of a PNA train step over n nodes and e edges
    (``n_out`` readout rows: the nodes, or the graphs of a graph task),
    nodes and edges sharded by the rules' 'nodes' and 'edges' axes.

    Work, each kernel over the device's rows, three passes (forward and two
    for backward): the feature embedding; per layer the message product
    over (h_src || h_dst) (the two gathered rows in, the messages out), the
    four segment reductions (the messages read once, the (n, 4d) aggregates
    written) and the update product over (h || 12 scaled aggregates); the
    readout and the loss; then AdamW over every (replicated) param.
    Collectives: per layer each device all-gathers h for its edges' rows
    and reduce-scatters the aggregates to the nodes' owners (backward: the
    reverse pair), and the params' gradients are all-reduced over the
    data axes.  Temporaries: each layer's saved activations."""
    d, F, C, L = cfg.d_hidden, cfg.d_feat, cfg.n_classes, cfg.n_layers
    dn, de = rules.size_of("nodes"), rules.size_of("edges")
    n_l, e_l = n / dn, e / de
    out_l = n_out / dn if cfg.task == "node" else n_out
    n_params = sum(int(np.prod(s))
                   for _, s in named_leaves(pna.param_shapes(cfg)))
    passes = 3.0

    def work(flops, nbytes):
        return KernelWork(flops=flops * passes, nbytes=nbytes * passes)

    kernels = {
        "embed": work(2.0 * n_l * F * d, 4.0 * (n_l * F + F * d + n_l * d)),
        "message": work(L * 2.0 * e_l * 2 * d * d,
                        L * 4.0 * (e_l * 2 * d + 2 * d * d + e_l * d)),
        "aggregate": work(L * 6.0 * e_l * d,
                          L * 4.0 * (e_l * d + 2 * e_l + 4 * n_l * d)),
        "update": work(L * 2.0 * n_l * 13 * d * d,
                       L * 4.0 * (n_l * 13 * d + 13 * d * d + n_l * d)),
        "readout": work(2.0 * out_l * d * C,
                        4.0 * (n_l * d + d * C + out_l * C)),
        "loss": work(4.0 * out_l * C, 4.0 * out_l * C),
        "adamw": KernelWork(flops=14.0 * n_params,
                            nbytes=n_params * (3 * 4 + 16)),
    }
    coll: Dict[str, float] = {}
    if dn > 1:
        coll["all-gather"] = 2.0 * L * n_l * d * 4 * (dn - 1)
        coll["reduce-scatter"] = 2.0 * L * n_l * 4 * d * 4 * (dn - 1)
        coll["all-reduce"] = 2.0 * n_params * 4 * (dn - 1) / dn
    temp = 4.0 * (n_l * (F + d) + L * (3 * e_l * d + 26 * n_l * d))
    return StepCost(kernels=kernels, collectives=coll, temp_bytes=temp)


class PNAArch(ArchSpec):
    family = "gnn"

    def __init__(self):
        self.arch_id = "pna"
        self.source = "arXiv:2004.05718; paper"
        self.n_layers = 4
        self.d_hidden = 75

    def cells(self) -> Dict[str, ShapeCell]:
        out = {}
        for name, s in GNN_SHAPES.items():
            n, e = _shape_dims(s)
            out[name] = ShapeCell(name=name, kind="train",
                                  desc=f"nodes={n} edges={e} d_feat={s['d_feat']}")
        return out

    def model_flops(self, shape: str) -> float:
        s = GNN_SHAPES[shape]
        n, e = _shape_dims(s)
        d = self.d_hidden
        per_layer = 2.0 * e * (2 * d) * d + 2.0 * n * (13 * d) * d
        fwd = (2.0 * n * s["d_feat"] * d
               + self.n_layers * per_layer
               + 2.0 * n * d * s["n_classes"])
        return 3.0 * fwd  # train step (fwd + bwd)

    def _cfg(self, s: Dict[str, Any]) -> pna.PNAConfig:
        return pna.PNAConfig(
            name="pna", n_layers=self.n_layers, d_hidden=self.d_hidden,
            d_feat=s["d_feat"], n_classes=s["n_classes"], task=s["task"],
            n_graphs=s.get("batch", 1),
        )

    def step_cost(self, shape: str, rules: ShardingRules) -> StepCost:
        s = GNN_SHAPES[shape]
        n, e = _shape_dims(s)
        n_out = s["batch"] if s["task"] == "graph" else n
        return pna_step_cost(self._cfg(s), n, e, n_out, rules)

    def build(self, shape: str, mesh: Any, rules: ShardingRules) -> LoweredSpec:
        s = GNN_SHAPES[shape]
        cfg = self._cfg(s)
        n, e = _shape_dims(s)
        params = pna.init_params(cfg, device="meta")
        specs = pytree.tree_map(lambda _: rules.spec(), params)  # tiny
        i32, f32 = torch.int32, torch.float32
        node = s["task"] == "node"
        batch = {
            "feats": meta((n, s["d_feat"]), f32, rules.spec("nodes", None)),
            "edge_src": meta((e,), i32, rules.spec("edges")),
            "edge_dst": meta((e,), i32, rules.spec("edges")),
            "labels": meta((n if node else s["batch"],), i32,
                           rules.spec("nodes" if node else None)),
            "node_mask": meta((n,), torch.bool, rules.spec("nodes")),
            "edge_mask": meta((e,), torch.bool, rules.spec("edges")),
        }
        if not node:
            batch["graph_ids"] = meta((n,), i32, rules.spec("nodes"))
        return train_spec(lambda p, b: pna.loss_fn(p, b, cfg, rules), params,
                          specs, batch, f"pna/{shape}")

    def smoke_run(self, device: Any = "cuda") -> Dict[str, Any]:
        """The reference's smoke path on ``device`` (the card unless the
        caller asks for the CPU): a node-task loss and its gradients on a
        subgraph drawn by the real sampler, and a graph-task forward and
        loss on a molecule batch."""
        from repro_torch.launch.mesh import make_local_mesh

        rules = default_rules(make_local_mesh(device))
        out: Dict[str, Any] = {}
        # node task on a small graph THROUGH the real sampler
        g = make_graph(400, 1600, 24, n_classes=5, seed=0)
        csr = CSRGraph(400, g.edge_src, g.edge_dst)
        sub = sample_subgraph(g, csr, np.arange(32), [4, 3],
                              np.random.default_rng(0))
        cfg = pna.PNAConfig(name="pna-smoke", n_layers=2, d_hidden=16,
                            d_feat=24, n_classes=5)
        params = pna.init_params(cfg, 0, device=device)
        loss, grads = loss_and_grads(
            lambda p, b: pna.loss_fn(p, b, cfg, rules), params,
            graph_batch(sub, device))
        out["loss"] = float(loss)
        out["grad_finite"] = all(bool(torch.isfinite(x).all())
                                 for x in pytree.tree_leaves(grads))
        # graph task
        mol = make_molecule_batch(8, 10, 20, 24, n_classes=5, seed=1)
        cfg_g = dataclasses.replace(cfg, task="graph", n_graphs=8)
        mb = graph_batch(mol, device)
        with torch.no_grad():
            logits = pna.forward(params, mb, cfg_g, rules)
            out["graph_logits_shape"] = tuple(logits.shape)
            out["graph_loss"] = float(pna.loss_fn(params, mb, cfg_g, rules))
        return out


GNN_ARCHS = [PNAArch()]
