"""Graph data substrate: synthetic graphs + a real neighbor sampler.

The port of ``repro.data.graph``, a copy (but for the CSR's sort, by
16-bit radix passes): numpy only, array for array equal to the
reference's from the same seeds.  Graphs are (edge_index
(2,E), feats, labels) with segment reductions in the model
(``models/pna.py``).  The sampler produces PADDED subgraphs (static
shapes), as the reference's jitted step needs; padding is masked via a
sink node.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class GraphBatch:
    """Padded, jit-ready graph. Sink node at index n_nodes-1 absorbs padding."""

    feats: np.ndarray        # (N, F) float32
    edge_src: np.ndarray     # (E,) int32 — padded edges point at the sink
    edge_dst: np.ndarray     # (E,) int32
    labels: np.ndarray       # (N,) int32 node labels, or (G,) graph labels
    node_mask: np.ndarray    # (N,) bool — real (non-padding) nodes
    edge_mask: np.ndarray    # (E,) bool
    graph_ids: Optional[np.ndarray] = None  # (N,) int32 for batched graphs
    n_graphs: int = 1


def make_graph(
    n_nodes: int,
    n_edges: int,
    d_feat: int,
    n_classes: int = 16,
    seed: int = 0,
    power_law: bool = True,
) -> GraphBatch:
    """Synthetic featured graph with power-law-ish degree and label-correlated
    features (so training actually reduces loss in smoke tests)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    centers = rng.standard_normal((n_classes, d_feat)).astype(np.float32)
    feats = centers[labels] + 0.5 * rng.standard_normal((n_nodes, d_feat)).astype(np.float32)
    if power_law:
        w = 1.0 / (1.0 + np.arange(n_nodes)) ** 0.5
        p = w / w.sum()
        dst = rng.choice(n_nodes, size=n_edges, p=p).astype(np.int32)
    else:
        dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    return GraphBatch(
        feats=feats,
        edge_src=src,
        edge_dst=dst,
        labels=labels,
        node_mask=np.ones(n_nodes, bool),
        edge_mask=np.ones(n_edges, bool),
    )


def make_molecule_batch(
    batch: int, nodes_per_graph: int, edges_per_graph: int, d_feat: int,
    n_classes: int = 2, seed: int = 0,
) -> GraphBatch:
    """Batched small graphs (molecule regime): block-diagonal edge index."""
    rng = np.random.Generator(np.random.PCG64(seed))
    N = batch * nodes_per_graph
    E = batch * edges_per_graph
    feats = rng.standard_normal((N, d_feat)).astype(np.float32)
    offs = np.repeat(np.arange(batch) * nodes_per_graph, edges_per_graph)
    src = (rng.integers(0, nodes_per_graph, E) + offs).astype(np.int32)
    dst = (rng.integers(0, nodes_per_graph, E) + offs).astype(np.int32)
    graph_ids = np.repeat(np.arange(batch), nodes_per_graph).astype(np.int32)
    labels = rng.integers(0, n_classes, batch).astype(np.int32)
    return GraphBatch(
        feats=feats, edge_src=src, edge_dst=dst, labels=labels,
        node_mask=np.ones(N, bool), edge_mask=np.ones(E, bool),
        graph_ids=graph_ids, n_graphs=batch,
    )


def _stable_order(keys: np.ndarray) -> np.ndarray:
    """``np.argsort(keys, kind="stable")`` for non-negative int32 keys, as
    two stable passes over 16-bit halves (low, then high), each of which
    numpy sorts by radix: at 114.6M edges several times faster than the
    merge sort numpy takes for 32-bit keys, and the same permutation."""
    lo = np.argsort((keys & 0xFFFF).astype(np.uint16), kind="stable")
    hi = (keys[lo] >> 16).astype(np.uint16)
    return lo[np.argsort(hi, kind="stable")]


class CSRGraph:
    """CSR adjacency for neighbor sampling (built once, host-side)."""

    def __init__(self, n_nodes: int, edge_src: np.ndarray, edge_dst: np.ndarray):
        order = _stable_order(edge_dst)
        self.nbr = edge_src[order].astype(np.int32)  # in-neighbors of dst
        counts = np.bincount(edge_dst, minlength=n_nodes)
        self.indptr = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(counts, out=self.indptr[1:])
        self.n_nodes = n_nodes

    def sample_neighbors(self, nodes: np.ndarray, fanout: int, rng) -> np.ndarray:
        """Uniform with replacement; isolated nodes self-loop. (len, fanout)."""
        out = np.empty((len(nodes), fanout), np.int32)
        for i, v in enumerate(nodes):
            lo, hi = self.indptr[v], self.indptr[v + 1]
            if hi > lo:
                out[i] = self.nbr[rng.integers(lo, hi, fanout)]
            else:
                out[i] = v
        return out


def sample_subgraph(
    graph: GraphBatch,
    csr: CSRGraph,
    seeds: np.ndarray,
    fanouts: Sequence[int],
    rng: np.random.Generator,
) -> GraphBatch:
    """GraphSAGE-style layered sampling -> padded subgraph with STATIC shapes
    (max_nodes = seeds*(1+f1+f1*f2+...), max_edges = seeds*(f1+f1*f2+...)).
    The returned subgraph is relabeled 0..N-1 with a sink node at N-1."""
    layers: List[np.ndarray] = [seeds.astype(np.int32)]
    edges_src: List[np.ndarray] = []
    edges_dst: List[np.ndarray] = []
    frontier = seeds.astype(np.int32)
    for f in fanouts:
        nbrs = csr.sample_neighbors(frontier, f, rng)        # (len, f)
        src = nbrs.reshape(-1)
        dst = np.repeat(frontier, f)
        edges_src.append(src)
        edges_dst.append(dst)
        frontier = src
        layers.append(src)

    all_nodes = np.concatenate(layers)
    uniq, inv = np.unique(all_nodes, return_inverse=True)

    # static budgets
    max_nodes = _max_nodes(len(seeds), fanouts) + 1          # +1 sink
    max_edges = _max_edges(len(seeds), fanouts)
    n_real = len(uniq)
    assert n_real < max_nodes, (n_real, max_nodes)

    remap = {int(g): i for i, g in enumerate(uniq)}
    src = np.concatenate(edges_src)
    dst = np.concatenate(edges_dst)
    src_l = np.fromiter((remap[int(s)] for s in src), np.int32, len(src))
    dst_l = np.fromiter((remap[int(d)] for d in dst), np.int32, len(dst))

    sink = max_nodes - 1
    feats = np.zeros((max_nodes, graph.feats.shape[1]), np.float32)
    feats[:n_real] = graph.feats[uniq]
    labels = np.zeros(max_nodes, np.int32)
    labels[:n_real] = graph.labels[uniq]
    node_mask = np.zeros(max_nodes, bool)
    # supervise ONLY seed nodes (standard sampled-training objective)
    seed_local = np.fromiter((remap[int(s)] for s in seeds), np.int32, len(seeds))
    node_mask[seed_local] = True

    e_src = np.full(max_edges, sink, np.int32)
    e_dst = np.full(max_edges, sink, np.int32)
    e_mask = np.zeros(max_edges, bool)
    e_src[: len(src_l)] = src_l
    e_dst[: len(dst_l)] = dst_l
    e_mask[: len(src_l)] = True
    return GraphBatch(
        feats=feats, edge_src=e_src, edge_dst=e_dst, labels=labels,
        node_mask=node_mask, edge_mask=e_mask,
    )


def _max_nodes(n_seeds: int, fanouts: Sequence[int]) -> int:
    total, layer = n_seeds, n_seeds
    for f in fanouts:
        layer *= f
        total += layer
    return total


def _max_edges(n_seeds: int, fanouts: Sequence[int]) -> int:
    total, layer = 0, n_seeds
    for f in fanouts:
        layer *= f
        total += layer
    return total
