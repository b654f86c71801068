"""ctypes binding of ``csrc/mmr.cu`` (``flexvec_mmr``, ``flexvec_mmr_shape``)."""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
NO_CLUSTER = -1  # flexvec_mmr's code when no cluster of its shape fits


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load()
    lib.flexvec_mmr.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P]
    lib.flexvec_mmr.restype = _I
    lib.flexvec_mmr_shape.argtypes = [_I, _I] + [ctypes.POINTER(_I)] * 4
    lib.flexvec_mmr_shape.restype = _I
    return lib


def shape(n: int, d: int) -> Dict[str, int]:
    """The launch's shape for an (n, d) pool on the current card: CTAs a
    cluster, pool rows a CTA holds in shared memory, dynamic shared memory
    a CTA, and ``cudaOccupancyMaxActiveClusters``."""
    out = [_I() for _ in range(4)]
    err = _lib().flexvec_mmr_shape(n, d, *[ctypes.byref(x) for x in out])
    _build.check(err, "mmr")
    keys = ("cluster", "rows_in_smem", "smem_bytes", "max_active_clusters")
    return {key: x.value for key, x in zip(keys, out)}


def launch(embeds: torch.Tensor, rel: torch.Tensor, lam: torch.Tensor,
           k: int, idx: torch.Tensor, val: torch.Tensor) -> None:
    """Enqueue one selection launch on the current stream.  Arguments are
    validated by :func:`repro_torch.kernels.mmr.ops.mmr_select`."""
    b, n, d = embeds.shape
    with torch.cuda.device(embeds.device):  # the launch's current device
        err = _lib().flexvec_mmr(embeds.data_ptr(), rel.data_ptr(),
                                 lam.data_ptr(), b, n, d, k, idx.data_ptr(),
                                 val.data_ptr(),
                                 _build.stream_ptr(embeds.device))
    if err == NO_CLUSTER:
        raise RuntimeError(f"mmr: cudaOccupancyMaxActiveClusters is 0 for a "
                           f"cluster over a ({n}, {d}) pool")
    _build.check(err, "mmr")
