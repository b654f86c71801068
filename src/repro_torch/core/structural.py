"""Structural operators (paper §3.2): per-query clustering and centrality.

Because Phase 2 operates on a numpy array, the operator surface extends
beyond scoring: these compute over the SELECTED candidate set and expose
results as additional temp-table columns for Phase 3 composition
('cluster:K' and 'central' tokens). The paper introduces these but does
not evaluate them; here they are first-class and tested.
"""

from __future__ import annotations

import numpy as np


def kmeans_labels(embeds: np.ndarray, k: int, iters: int = 10,
                  seed: int = 0) -> np.ndarray:
    """Deterministic Lloyd k-means on L2-normalized rows -> (n,) int32.

    k-means++-style farthest-first init (deterministic: starts from the
    first row) keeps clusters stable across runs for the same pool."""
    n = embeds.shape[0]
    k = max(1, min(k, n))
    centers = np.empty((k, embeds.shape[1]), np.float32)
    centers[0] = embeds[0]
    for c in range(1, k):
        sim = np.max(embeds @ centers[:c].T, axis=1)
        centers[c] = embeds[int(np.argmin(sim))]      # farthest point
    labels = np.zeros(n, np.int32)
    for _ in range(iters):
        labels = np.argmax(embeds @ centers.T, axis=1).astype(np.int32)
        for c in range(k):
            mask = labels == c
            if mask.any():
                v = embeds[mask].mean(axis=0)
                centers[c] = v / max(float(np.linalg.norm(v)), 1e-9)
    return labels


def centrality(embeds: np.ndarray) -> np.ndarray:
    """Degree centrality in the candidate similarity graph: mean cosine of
    each candidate to the rest of the pool. (n,) float32 in [-1, 1]."""
    n = embeds.shape[0]
    if n <= 1:
        return np.zeros(n, np.float32)
    sim = embeds @ embeds.T
    return ((sim.sum(axis=1) - 1.0) / (n - 1)).astype(np.float32)
