"""Ranking metrics used by the behavioral suite (paper §4.4).

The port's copy of ``repro.metrics.ranking``: numpy on host arrays, the
same arithmetic line for line (the port imports nothing of ``repro``).

RBO  — Rank-Biased Overlap [Webber et al., TOIS 2010], extrapolated form.
ILS  — Intra-List Similarity: mean pairwise cosine among top-K results.
nDCG — standard graded formulation, log2 discount.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def rbo(list_a: Sequence[int], list_b: Sequence[int], p: float = 0.9) -> float:
    """Extrapolated RBO (eq. 32 of Webber et al.) for two finite rankings."""
    a, b = list(list_a), list(list_b)
    k = min(len(a), len(b))
    if k == 0:
        return 1.0
    seen_a, seen_b = set(), set()
    overlap = 0
    summand = 0.0
    x_k = 0
    for d in range(1, k + 1):
        ai, bi = a[d - 1], b[d - 1]
        if ai == bi:
            overlap += 1
        else:
            if ai in seen_b:
                overlap += 1
            if bi in seen_a:
                overlap += 1
        seen_a.add(ai)
        seen_b.add(bi)
        x_k = overlap
        summand += (overlap / d) * (p ** d)
    rbo_min = (1 - p) / p * summand
    # extrapolation term: assume agreement continues at depth-k rate
    return float(rbo_min + (x_k / k) * (p ** k))


def ils(embeds: np.ndarray) -> float:
    """Mean pairwise cosine among a result list's embeddings (K, d)."""
    e = np.asarray(embeds, np.float32)
    e = e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-9)
    sim = e @ e.T
    k = sim.shape[0]
    if k < 2:
        return 0.0
    off = sim[np.triu_indices(k, 1)]
    return float(off.mean())


def ndcg_at_k(ranked_ids: Sequence[int], qrels: Dict[int, int], k: int = 10) -> float:
    gains = [qrels.get(int(d), 0) for d in list(ranked_ids)[:k]]
    dcg = sum((2 ** g - 1) / np.log2(i + 2) for i, g in enumerate(gains))
    ideal = sorted(qrels.values(), reverse=True)[:k]
    idcg = sum((2 ** g - 1) / np.log2(i + 2) for i, g in enumerate(ideal))
    return float(dcg / idcg) if idcg > 0 else 0.0


def centroid_similarity(result_embeds: np.ndarray, seed_embeds: np.ndarray) -> float:
    """Mean cosine(result, centroid(seeds)) — the paper's centroid metric."""
    c = np.asarray(seed_embeds, np.float32).mean(axis=0)
    c = c / max(np.linalg.norm(c), 1e-9)
    e = np.asarray(result_embeds, np.float32)
    e = e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-9)
    return float((e @ c).mean())
