"""Public wrapper of the top-K kernel: ``jax.lax.top_k`` order on the card.

Same name and arguments as ``repro.kernels.topk.ops.topk`` minus the TPU
block sizes and interpret switch: a CPU tensor takes the plain version
(``ref.py``), a CUDA tensor runs ``csrc/topk.cu``: a radix select of each
row's K-th key, a compaction of the K survivors in index order and one
sort of them, all enqueued by one call with no host synchronisation.  A
panel whose rows are not contiguous (a filter batch's masked panel is
column-major) is copied row-major by the first radix pass, into a buffer
allocated here.  ``launches`` counts every kernel launch (six a call).
A meta tensor
(``launch/dryrun.py``) gets its outputs' shapes, with nothing launched.
"""

from __future__ import annotations

import threading
from typing import Tuple

import torch

from repro_torch.kernels.topk import kernel
from repro_torch.kernels.topk.ref import topk_ref

MAX_K = 8192       # the sort keeps k 64-bit keys in shared memory (64 KB)
MAX_ROWS = 65535   # the grid's y extent
CHUNKS = (1024, 2048, 4096, 8192, 16384)  # columns a block takes
MIN_BLOCKS = 264   # two blocks an SM on the H100's 132
_count_lock = threading.Lock()


def _pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def chunking(rows: int, length: int) -> Tuple[int, int]:
    """(chunk, chunks): the largest chunk that still gives the grid
    ``MIN_BLOCKS`` blocks, so a single row spreads over the card."""
    chunk = CHUNKS[0]
    for c in CHUNKS:
        if rows * -(-length // c) >= MIN_BLOCKS:
            chunk = c
    return chunk, -(-length // chunk)


def topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise top-k of a (B, N) score panel; (values desc, int32
    indices).  ``scores`` may be any strided float32 view."""
    if scores.ndim != 2:
        raise ValueError(f"topk: scores must be (B, N), got {tuple(scores.shape)}")
    if k < 0:
        raise ValueError(f"topk: k must be >= 0, got {k}")
    if scores.device.type == "cpu":
        return topk_ref(scores, k)
    if scores.device.type not in ("cuda", "meta"):
        raise ValueError(f"topk: no kernel for device {scores.device}")
    if scores.dtype != torch.float32:
        raise ValueError(f"topk: scores must be float32, got {scores.dtype}")
    b, n = scores.shape
    if b > MAX_ROWS:
        raise ValueError(f"topk: at most {MAX_ROWS} rows, got {b}")
    if k > MAX_K:
        raise ValueError(f"topk: k={k} above the kernel's {MAX_K}")
    dev = scores.device
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0 or k == 0 or dev.type == "meta":  # meta: a dry run's shapes
        return vals, idx
    if n == 0:  # the kernel reads at least one column: all of them -inf
        scores = scores.new_full((b, k), float("-inf"))
    chunk, chunks = chunking(b, max(n, k))
    ws = torch.empty(-(-kernel.workspace_bytes(b, chunks, k) // 8),
                     dtype=torch.int64, device=dev)
    copy = (None if scores.stride(1) == 1 or n == 1
            else torch.empty((b, n), dtype=torch.float32, device=dev))
    kernel.launch(scores, k, chunk, chunks, _pow2(k), ws, copy, vals, idx)
    with _count_lock:  # shard workers launch from several threads
        topk.launches += kernel.LAUNCHES
    return vals, idx


#: kernel launches since the last reset; the plain CPU path never counts
topk.launches = 0
