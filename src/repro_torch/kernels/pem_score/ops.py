"""Public wrapper of the fused PEM scoring kernel.

Same name and arguments as ``repro.kernels.pem_score.ops.pem_score`` minus
the TPU block sizes and interpret switch: a CPU tensor takes the plain
version (``ref.py``), a CUDA tensor launches ``csrc/pem_score.cu``.  The
kernel masks the ragged N and B edges itself, so nothing is padded.
``out=`` lets a caller receive the (N, B) scores in any strided view, such
as the transpose of a (B, N) panel the top-k kernel reads directly.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.pem_score import kernel
from repro_torch.kernels.pem_score.ref import pem_score_ref


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"pem_score: {msg}")


def pem_score(
    matrix: torch.Tensor,                  # (N, d) f32 or bf16
    q_pre: torch.Tensor,                   # (d, B) f32
    q_sup: torch.Tensor,                   # (d, B) f32
    decay: Optional[torch.Tensor] = None,  # (N,) f32 or None (ones)
    *,
    out: Optional[torch.Tensor] = None,    # (N, B) f32, any strides
) -> torch.Tensor:
    """Batched modulated scores (N, B)."""
    n, d = matrix.shape
    b = q_pre.shape[1]
    _require(q_pre.shape == (d, b) and q_sup.shape == (d, b),
             f"q_pre/q_sup must be ({d}, B), got {tuple(q_pre.shape)} and "
             f"{tuple(q_sup.shape)}")
    _require(decay is None or tuple(decay.shape) == (n,),
             f"decay must be ({n},)")
    _require(out is None or (tuple(out.shape) == (n, b)
                             and out.dtype == torch.float32),
             f"out must be a float32 ({n}, {b}) tensor")
    if matrix.device.type == "cpu":
        res = pem_score_ref(matrix, q_pre, q_sup,
                            torch.ones(n) if decay is None else decay)
        return res if out is None else out.copy_(res)
    _require(matrix.device.type == "cuda",
             f"no kernel for device {matrix.device}")
    tensors = [q_pre, q_sup] + ([] if decay is None else [decay])
    tensors += [] if out is None else [out]
    _require(all(t.device == matrix.device for t in tensors),
             "all tensors must be on the corpus's device")
    _require(matrix.dtype in (torch.float32, torch.bfloat16),
             f"corpus dtype {matrix.dtype} is neither float32 nor bfloat16")
    _require(all(t.dtype == torch.float32 for t in tensors),
             "queries, decay and out must be float32")
    _require(matrix.is_contiguous() and q_pre.is_contiguous()
             and q_sup.is_contiguous()
             and (decay is None or decay.is_contiguous()),
             "corpus, queries and decay must be contiguous")
    # the kernel reads the corpus four elements at a time
    _require(d % 4 == 0
             and matrix.data_ptr() % (4 * matrix.element_size()) == 0,
             f"the kernel needs d % 4 == 0 (d={d}) and an aligned corpus")
    if out is None:
        out = torch.empty((n, b), dtype=torch.float32, device=matrix.device)
    if n and b:
        kernel.launch(matrix, q_pre, q_sup, decay, out)
        pem_score.launches += 1
    return out


#: kernel launches since the last reset (the plain CPU path never counts)
pem_score.launches = 0

