"""Public wrapper of the top-K kernel: ``jax.lax.top_k`` order on the card.

Same name and arguments as ``repro.kernels.topk.ops.topk`` minus the TPU
block sizes and interpret switch: a CPU tensor takes the plain version
(``ref.py``), a CUDA tensor runs ``csrc/topk.cu``'s tile passes.  Pass 1
sorts tiles of the score panel and keeps each tile's first k keys; every
later pass does the same over the survivors, until one tile remains and
writes values and indices.  ``launches`` counts every pass.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.topk import kernel
from repro_torch.kernels.topk.ref import topk_ref

MIN_TILE = 8192    # keys a tile sorts (64 KB of shared memory)
MAX_TILE = 16384   # 128 KB: the largest tile, so k <= MAX_TILE // 2
MAX_ROWS = 65535   # the grid's y extent


def _pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise top-k of a (B, N) score panel; (values desc, int32
    indices).  ``scores`` may be any strided float32 view."""
    if scores.ndim != 2:
        raise ValueError(f"topk: scores must be (B, N), got {tuple(scores.shape)}")
    if k < 0:
        raise ValueError(f"topk: k must be >= 0, got {k}")
    if scores.device.type == "cpu":
        return topk_ref(scores, k)
    if scores.device.type != "cuda":
        raise ValueError(f"topk: no kernel for device {scores.device}")
    if scores.dtype != torch.float32:
        raise ValueError(f"topk: scores must be float32, got {scores.dtype}")
    b, n = scores.shape
    if b > MAX_ROWS:
        raise ValueError(f"topk: at most {MAX_ROWS} rows, got {b}")
    tile = min(max(MIN_TILE, _pow2(4 * k)), MAX_TILE)
    if 2 * k > tile:
        raise ValueError(f"topk: k={k} above the kernel's {MAX_TILE // 2}")
    dev = scores.device
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0 or k == 0:
        return vals, idx
    keys = None
    length = max(n, k)
    while True:
        tiles = -(-length // tile)
        sort_n = _pow2(min(tile, length))
        if tiles == 1:
            kernel.launch_pass(scores, keys, length, tile, sort_n, k,
                               None, vals, idx)
            topk.launches += 1
            return vals, idx
        kept = torch.empty((b, tiles * k), dtype=torch.int64, device=dev)
        kernel.launch_pass(scores, keys, length, tile, sort_n, k, kept,
                           None, None)
        topk.launches += 1
        keys, length = kept, tiles * k


#: kernel launches (tile passes) since the last reset; the plain CPU path
#: never counts
topk.launches = 0
