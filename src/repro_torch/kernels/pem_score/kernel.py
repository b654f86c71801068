"""ctypes binding of ``csrc/pem_score.cu`` (``flexvec_pem_score``)."""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
#: the kernel keeps 64-row tiles of the full depth and the split query in
#: shared memory, so it takes embeddings up to this width (a two-tower
#: model's 256-wide item vectors)
MAX_D = 256


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load().flexvec_pem_score
    fn.argtypes = [_P, ctypes.c_int, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_longlong, _P]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch(matrix: torch.Tensor, q_pre: torch.Tensor, q_sup: torch.Tensor,
           decay, days_ago, half_lives, out: torch.Tensor) -> None:
    """Enqueue one scoring launch on the current stream.  Arguments are
    validated by :func:`repro_torch.kernels.pem_score.ops.pem_score`."""
    n, d = matrix.shape
    with torch.cuda.device(matrix.device):  # the launch's current device
        err = _fn()(matrix.data_ptr(), int(matrix.dtype == torch.bfloat16),
                    q_pre.data_ptr(), q_sup.data_ptr(), _ptr(decay),
                    _ptr(days_ago), _ptr(half_lives), out.data_ptr(),
                    n, d, q_pre.shape[1], out.stride(0), out.stride(1),
                    _build.stream_ptr(matrix.device))
    _build.check(err, "pem_score")


def plan(n: int, d: int, b: int, bf16: bool = False) -> Dict[str, int]:
    """The launch's shape for an (n, d) corpus and b plans: product width,
    query chunks, boxes a row, ring stages, whether the split query stays
    resident, grid, dynamic shared memory and row tiles.  Needs the built
    library (a machine with a card)."""
    fn = _build.load().flexvec_pem_score_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    info = (ctypes.c_longlong * 8)()
    _build.check(fn(n, d, b, int(bf16), info), "pem_score plan")
    keys = ("product_width", "chunks", "boxes", "stages", "resident_query",
            "grid", "smem_bytes", "tiles")
    return dict(zip(keys, (int(v) for v in info)))
