"""ctypes binding of ``csrc/topk.cu`` (``flexvec_topk``)."""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

#: kernel launches one call enqueues: three radix-select passes (the
#: first also copies a panel whose rows are not contiguous row-major),
#: the tie count, the tie write and the sort
LAUNCHES = 6


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load()
    lib.flexvec_topk.argtypes = [_P, _L, _L, _I, _I, _I, _I, _I, _I, _P,
                                 _P, _P, _P, _P]
    lib.flexvec_topk.restype = _I
    lib.flexvec_topk_workspace.argtypes = [_I, _I, _I]
    lib.flexvec_topk_workspace.restype = _L
    return lib


@functools.lru_cache(maxsize=256)
def workspace_bytes(rows: int, chunks: int, k: int) -> int:
    """Bytes of scratch :func:`launch` needs (histograms, offsets,
    survivors)."""
    return int(_lib().flexvec_topk_workspace(rows, chunks, k))


def launch(scores: torch.Tensor, k: int, chunk: int, chunks: int,
           sort_n: int, workspace: torch.Tensor, copy: Optional[torch.Tensor],
           vals: torch.Tensor, idx: torch.Tensor) -> None:
    """Enqueue one top-k (all its launches) on the current stream (see the
    C entry point for the contract; ``copy``, when given, receives the
    panel row-major first).  Arguments are validated and sized by
    :func:`repro_torch.kernels.topk.ops.topk`."""
    rows, n = scores.shape
    with torch.cuda.device(scores.device):  # the launch's current device
        err = _lib().flexvec_topk(
            scores.data_ptr(), scores.stride(0), scores.stride(1), n, rows,
            k, chunk, chunks, sort_n, workspace.data_ptr(),
            None if copy is None else copy.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), _build.stream_ptr(scores.device))
    _build.check(err, "topk")
