"""ctypes binding of ``csrc/topk.cu`` (``flexvec_topk_pass``)."""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load().flexvec_topk_pass
    fn.argtypes = [_P, _L, _L, _I, _P, _L, _I, _I, _I, _I, _I, _P, _L,
                   _P, _P, _P]
    fn.restype = _I
    return fn


def launch_pass(scores: torch.Tensor, keys_in: Optional[torch.Tensor],
                length: int, tile: int, sort_n: int, k: int,
                keys_out: Optional[torch.Tensor],
                vals: Optional[torch.Tensor],
                idx: Optional[torch.Tensor]) -> None:
    """Enqueue one tile pass on the current stream (see the C entry point
    for the contract).  Arguments are validated and sized by
    :func:`repro_torch.kernels.topk.ops.topk`."""
    rows, n = scores.shape
    err = _fn()(scores.data_ptr(), scores.stride(0), scores.stride(1), n,
                None if keys_in is None else keys_in.data_ptr(),
                0 if keys_in is None else keys_in.stride(0),
                length, tile, sort_n, k, rows,
                None if keys_out is None else keys_out.data_ptr(),
                0 if keys_out is None else keys_out.stride(0),
                None if vals is None else vals.data_ptr(),
                None if idx is None else idx.data_ptr(),
                _build.stream_ptr(scores.device))
    _build.check(err, "topk")
