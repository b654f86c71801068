"""ctypes binding of ``csrc/pem_score.cu`` (``flexvec_pem_score``)."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load().flexvec_pem_score
    fn.argtypes = [_P, ctypes.c_int, _P, _P, _P, _P, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_longlong, _P]
    fn.restype = ctypes.c_int
    return fn


def launch(matrix: torch.Tensor, q_pre: torch.Tensor, q_sup: torch.Tensor,
           decay, out: torch.Tensor) -> None:
    """Enqueue one scoring launch on the current stream.  Arguments are
    validated by :func:`repro_torch.kernels.pem_score.ops.pem_score`."""
    n, d = matrix.shape
    err = _fn()(matrix.data_ptr(), int(matrix.dtype == torch.bfloat16),
                q_pre.data_ptr(), q_sup.data_ptr(),
                None if decay is None else decay.data_ptr(), out.data_ptr(),
                n, d, q_pre.shape[1], out.stride(0), out.stride(1),
                _build.stream_ptr(matrix.device))
    _build.check(err, "pem_score")
