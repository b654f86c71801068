"""Synthetic recsys data (Criteo-like click logs, behavior sequences).

The port of ``repro.data.recsys``, a copy: numpy only, batch for batch
equal to the reference's from the same seeds."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

# MLPerf DLRM / Criteo 1TB per-table cardinalities (day-23 counts) —
# the published benchmark config [arXiv:1906.00091; MLPerf v0.7 rules].
CRITEO_1TB_VOCAB_SIZES: Tuple[int, ...] = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)


def dlrm_batch(
    batch: int, n_dense: int, vocab_sizes: Sequence[int], seed: int = 0
) -> Dict[str, np.ndarray]:
    rng = np.random.Generator(np.random.PCG64(seed))
    sparse = np.stack(
        [rng.integers(0, v, batch).astype(np.int32) for v in vocab_sizes], axis=1
    )
    # clicks correlate with a hidden linear signal so training can learn
    dense = rng.standard_normal((batch, n_dense)).astype(np.float32)
    p = 1 / (1 + np.exp(-(dense[:, :3].sum(1))))
    return {
        "dense": dense,
        "sparse": sparse,
        "labels": (rng.random(batch) < p).astype(np.float32),
    }


def bst_batch(batch: int, seq_len: int, vocab_items: int, n_other: int = 8,
              seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.Generator(np.random.PCG64(seed))
    hist = rng.integers(0, vocab_items, (batch, seq_len)).astype(np.int32)
    target = rng.integers(0, vocab_items, batch).astype(np.int32)
    other = rng.standard_normal((batch, n_other)).astype(np.float32)
    # click iff target shares a coarse "category" (id modulo) with history
    cat = target % 97
    match = (hist % 97 == cat[:, None]).any(axis=1)
    noise = rng.random(batch) < 0.1
    return {
        "hist": hist, "target": target, "other": other,
        "labels": (match ^ noise).astype(np.float32),
    }


def autoint_batch(batch: int, n_fields: int, vocab_per_field: int,
                  seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.Generator(np.random.PCG64(seed))
    sparse = rng.integers(0, vocab_per_field, (batch, n_fields)).astype(np.int32)
    p = 1 / (1 + np.exp(-((sparse[:, :2].sum(1) % 7) - 3.0)))
    return {"sparse": sparse, "labels": (rng.random(batch) < p).astype(np.float32)}


def twotower_batch(batch: int, vocab_user: int, vocab_item: int, hist_len: int,
                   seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.Generator(np.random.PCG64(seed))
    hist = rng.integers(0, vocab_item, (batch, hist_len)).astype(np.int32)
    # ragged bags: pad a random suffix with -1
    lens = rng.integers(1, hist_len + 1, batch)
    hist[np.arange(hist_len)[None, :] >= lens[:, None]] = -1
    pos = rng.integers(0, vocab_item, batch).astype(np.int32)
    # logQ correction: popularity-biased sampling probability (synthetic Zipf)
    q = 1.0 / (1.0 + (pos % 1000).astype(np.float64))
    return {
        "user_id": rng.integers(0, vocab_user, batch).astype(np.int32),
        "hist": hist,
        "pos_item": pos,
        "logq": np.log(q / q.sum()).astype(np.float32),
    }
