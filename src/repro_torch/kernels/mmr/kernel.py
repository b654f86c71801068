"""ctypes binding of ``csrc/mmr.cu`` (``flexvec_mmr``)."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load().flexvec_mmr
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P]
    fn.restype = _I
    return fn


def launch(embeds: torch.Tensor, rel: torch.Tensor, lam: torch.Tensor,
           k: int, idx: torch.Tensor, val: torch.Tensor) -> None:
    """Enqueue one selection launch on the current stream.  Arguments are
    validated by :func:`repro_torch.kernels.mmr.ops.mmr_select`."""
    b, n, d = embeds.shape
    err = _fn()(embeds.data_ptr(), rel.data_ptr(), lam.data_ptr(), b, n, d,
                k, idx.data_ptr(), val.data_ptr(),
                _build.stream_ptr(embeds.device))
    _build.check(err, "mmr")
