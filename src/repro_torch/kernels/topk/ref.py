"""Plain PyTorch version of the top-K kernel: ``jax.lax.top_k``'s order.

Values rank in IEEE total order, as XLA's top_k compares them (-0.0 below
+0.0), and a stable descending sort keeps equal values in index order, so
ties (-inf padding and masked rows included) go to the smallest index.
``torch.topk`` documents no tie order and is not used.
"""

from __future__ import annotations

from typing import Tuple

import torch


def topk_ref(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores (B, N) -> (values (B, k) desc, indices (B, k) int32).  A k
    above N reads the missing columns as -inf at indices N, N+1, ..., as
    the kernel path does."""
    b, n = scores.shape
    s = scores.to(torch.float32)
    if k > n:
        s = torch.cat([s, s.new_full((b, k - n), float("-inf"))], dim=1)
    bits = s.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)  # total-order key
    _, i = torch.sort(key, dim=1, descending=True, stable=True)
    i = i[:, :k]
    return torch.gather(s, 1, i), i.to(torch.int32)
