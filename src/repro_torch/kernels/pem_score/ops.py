"""Public wrapper of the fused PEM scoring kernel.

Same name and arguments as ``repro.kernels.pem_score.ops.pem_score`` minus
the TPU block sizes and interpret switch: a CPU tensor takes the plain
version (``ref.py``), a CUDA tensor launches ``csrc/pem_score.cu`` once.
The kernel masks the ragged N, B and d edges itself, so nothing is padded.
``out=`` lets a caller receive the (N, B) scores in any strided view, such
as the transpose of a (B, N) panel the top-k kernel reads directly.  A
meta tensor (``launch/dryrun.py``) passes the same checks and gets its
output's shape, with nothing launched.

Keyword-only ``days_ago=`` (N,) with ``half_lives=`` (B,) replace
``decay``: each plan then gets its own factor 1 / (1 + days / half_life)
(+inf for a plan without decay), so a batch that mixes half-lives scores
in one launch.  ``timestamps=`` (N,) float64 unix seconds with ``now=``
and ``half_lives=`` is the same form with the ages formed by the kernel,
``max((now - ts) / 86400, 0)`` rounded to f32 as the host forms them: a
segment's timestamps stay on the card and no ages cross from the host.
The three forms are exclusive.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from repro_torch.kernels.pem_score import kernel
from repro_torch.kernels.pem_score.ref import (pem_score_days_ref,
                                               pem_score_ref,
                                               pem_score_stamps_ref)


_count_lock = threading.Lock()


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
    days_ago: Optional[torch.Tensor] = None,    # (N,) f32
    half_lives: Optional[torch.Tensor] = None,  # (B,) f32, +inf = no decay
    timestamps: Optional[torch.Tensor] = None,  # (N,) f64 unix seconds
    now: Optional[float] = None,                # unix seconds
) -> torch.Tensor:
    """Batched modulated scores (N, B)."""
    n, d = matrix.shape
    b = q_pre.shape[1]
    _require(q_pre.shape == (d, b) and q_sup.shape == (d, b),
             f"q_pre/q_sup must be ({d}, B), got {tuple(q_pre.shape)} and "
             f"{tuple(q_sup.shape)}")
    _require(decay is None or tuple(decay.shape) == (n,),
             f"decay must be ({n},)")
    _require((timestamps is None) == (now is None),
             "timestamps and now go together")
    ages = days_ago if timestamps is None else timestamps
    _require((ages is None) == (half_lives is None),
             "days_ago (or timestamps) and half_lives go together")
    _require(sum(t is not None for t in (decay, days_ago, timestamps)) <= 1,
             "decay, days_ago/half_lives and timestamps/now/half_lives are "
             "exclusive")
    _require(ages is None or (tuple(ages.shape) == (n,)
                              and tuple(half_lives.shape) == (b,)),
             f"days_ago or timestamps must be ({n},) and half_lives ({b},)")
    _require(timestamps is None or timestamps.dtype == torch.float64,
             "timestamps must be float64")
    _require(out is None or (tuple(out.shape) == (n, b)
                             and out.dtype == torch.float32),
             f"out must be a float32 ({n}, {b}) tensor")
    if matrix.device.type == "cpu":
        if timestamps is not None:
            res = pem_score_stamps_ref(matrix, q_pre, q_sup, timestamps, now,
                                       half_lives)
        elif days_ago is not None:
            res = pem_score_days_ref(matrix, q_pre, q_sup, days_ago,
                                     half_lives)
        else:
            res = pem_score_ref(matrix, q_pre, q_sup,
                                torch.ones(n) if decay is None else decay)
        return res if out is None else out.copy_(res)
    _require(matrix.device.type in ("cuda", "meta"),
             f"no kernel for device {matrix.device}")
    factors = [t for t in (decay, days_ago, half_lives) if t is not None]
    stamps = [] if timestamps is None else [timestamps]
    tensors = [q_pre, q_sup] + factors + ([] if out is None else [out])
    _require(all(t.device == matrix.device for t in tensors + stamps),
             "all tensors must be on the corpus's device")
    _require(matrix.dtype in (torch.float32, torch.bfloat16),
             f"corpus dtype {matrix.dtype} is neither float32 nor bfloat16")
    _require(all(t.dtype == torch.float32 for t in tensors),
             "queries, decay, days_ago, half_lives and out must be float32")
    _require(all(t.is_contiguous() for t in [matrix, q_pre, q_sup]
                 + factors + stamps),
             "corpus, queries, decay factors and timestamps must be "
             "contiguous")
    # TMA reads the corpus: 16-byte aligned base and row stride
    _require(0 < d <= kernel.MAX_D
             and (d * matrix.element_size()) % 16 == 0,
             f"the kernel needs d <= {kernel.MAX_D} with 16-byte rows "
             f"(d % 4 == 0 for float32, d % 8 == 0 for bfloat16; d={d})")
    if matrix.device.type == "meta":  # a dry run: the shape, no launch
        return out if out is not None else torch.empty(
            (n, b), dtype=torch.float32, device="meta")
    _require(all(t.data_ptr() % 16 == 0
                 for t in (matrix, decay, days_ago, timestamps)
                 if t is not None),
             "the corpus, decay, days_ago and timestamps must be 16-byte "
             "aligned (TMA reads them)")
    if out is None:
        out = torch.empty((n, b), dtype=torch.float32, device=matrix.device)
    if n and b:
        kernel.launch(matrix, q_pre, q_sup, decay, days_ago, timestamps, now,
                      half_lives, out)
        with _count_lock:  # shard workers launch from several threads
            pem_score.launches += 1
            pem_score.stamped_launches += timestamps is not None
    return out


#: kernel launches since the last reset (the plain CPU path never counts)
pem_score.launches = 0
#: of those, the launches that formed the rows' ages from timestamps
#: (``timestamps=``); reset with ``launches``
pem_score.stamped_launches = 0
