"""Public wrapper of the MMR selection kernel.

Same name and arguments as ``repro.kernels.mmr.ops.mmr_select`` minus the
interpret switch: a CPU tensor takes the plain version (``ref.py``), a
CUDA tensor launches ``csrc/mmr.cu``.  ``lam`` is a scalar or a (B,)
vector (the scalar broadcasts here), so one launch serves plans with
different lambdas.  Padding slots carry rel = NEG; the kernel takes any n,
so nothing is padded to the TPU's 128 multiples.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels.mmr import kernel
from repro_torch.kernels.mmr.ref import NEG, mmr_ref

__all__ = ["NEG", "mmr_select"]

MAX_POOL = 25000  # 9 bytes of shared memory a slot within 227 KB


def mmr_select(
    embeds: torch.Tensor,                   # (B, n, d) pool embeddings
    rel: torch.Tensor,                      # (B, n) relevance scores
    k: int,
    lam: Union[float, torch.Tensor] = 0.7,  # scalar or (B,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MMR-select k of n (selection order) -> (indices int32, mmr scores)."""
    b, n, d = embeds.shape
    if tuple(rel.shape) != (b, n):
        raise ValueError(f"mmr_select: rel must be ({b}, {n}), got "
                         f"{tuple(rel.shape)}")
    if not 0 <= k <= n:
        raise ValueError(f"mmr_select: need 0 <= k <= n, got k={k}, n={n}")
    lam_t = (lam.to(device=embeds.device, dtype=torch.float32)
             if isinstance(lam, torch.Tensor)
             else torch.full((b,), float(lam), device=embeds.device))
    if tuple(lam_t.shape) != (b,):
        raise ValueError(f"mmr_select: lam must be a scalar or ({b},)")
    if embeds.device.type == "cpu":
        return mmr_ref(embeds, rel, k, lam_t)
    if embeds.device.type != "cuda":
        raise ValueError(f"mmr_select: no kernel for device {embeds.device}")
    if rel.device != embeds.device:
        raise ValueError("mmr_select: rel must be on the embeddings' device")
    if embeds.dtype != torch.float32 or rel.dtype != torch.float32:
        raise ValueError("mmr_select: embeds and rel must be float32")
    if n > MAX_POOL:
        raise ValueError(f"mmr_select: pool {n} above the kernel's {MAX_POOL}")
    idx = torch.empty((b, k), dtype=torch.int32, device=embeds.device)
    val = torch.empty((b, k), dtype=torch.float32, device=embeds.device)
    if b == 0 or k == 0:
        return idx, val
    if d % 4:
        # the kernel reads rows as float4; zero columns change no dot
        embeds = F.pad(embeds, (0, 4 - d % 4))
    kernel.launch(embeds.contiguous(), rel.contiguous(),
                  lam_t.contiguous(), k, idx, val)
    mmr_select.launches += 1
    return idx, val


#: kernel launches since the last reset (the plain CPU path never counts)
mmr_select.launches = 0
