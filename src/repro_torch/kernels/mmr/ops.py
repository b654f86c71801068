"""Public wrapper of the MMR selection kernel.

Same name and arguments as ``repro.kernels.mmr.ops.mmr_select`` minus the
interpret switch: a CPU tensor takes the plain version (``ref.py``), a
CUDA tensor launches ``csrc/mmr.cu``: one cluster of C CTAs a query, one
CTA an SM, C chosen from (B, n, d) by ``kernel.plan`` so that the batch's
queries are resident at once (2 CTAs a query at B = 64, 16 at B = 1);
each CTA keeps its share of the pool's live rows in shared memory, and
in registers where that falls short (rows that do not fit are read from
global memory by the same kernel); a step is one exchange of candidates
by st.async.  Picks equal the plain version's (each dot one FMA chain in
column order, as cuBLAS's f32 gram rounds).  ``lam`` is a scalar or a
(B,) vector (the scalar broadcasts here), so one launch serves plans with
different lambdas.  Padding slots carry rel = NEG and are never loaded;
the kernel takes any n, so nothing is padded to the TPU's 128 multiples.
A meta tensor (``launch/dryrun.py``) gets its outputs' shapes, with
nothing launched.
"""

from __future__ import annotations

import threading
from typing import Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels.mmr import kernel
from repro_torch.kernels.mmr.ref import NEG, mmr_ref

__all__ = ["NEG", "mmr_select"]

MAX_POOL = 25000  # a CTA keeps 12 bytes of state for each of n / C slots
_count_lock = threading.Lock()


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
    if embeds.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"mmr_select: no kernel for device {embeds.device}")
    lam_t = (lam.to(device=embeds.device, dtype=torch.float32)
             if isinstance(lam, torch.Tensor)
             else torch.full((b,), float(lam), device=embeds.device))
    if tuple(lam_t.shape) != (b,):
        raise ValueError(f"mmr_select: lam must be a scalar or ({b},)")
    if embeds.device.type == "cpu":
        return mmr_ref(embeds, rel, k, lam_t)
    if rel.device != embeds.device:
        raise ValueError("mmr_select: rel must be on the embeddings' device")
    if embeds.dtype != torch.float32 or rel.dtype != torch.float32:
        raise ValueError("mmr_select: embeds and rel must be float32")
    if n > MAX_POOL:
        raise ValueError(f"mmr_select: pool {n} above the kernel's {MAX_POOL}")
    idx = torch.empty((b, k), dtype=torch.int32, device=embeds.device)
    val = torch.empty((b, k), dtype=torch.float32, device=embeds.device)
    if b == 0 or k == 0 or embeds.device.type == "meta":  # a dry run
        return idx, val
    if d % 4:
        # the kernel reads rows as float4; zero columns change no dot
        embeds = F.pad(embeds, (0, 4 - d % 4))
    kernel.launch(embeds.contiguous(), rel.contiguous(),
                  lam_t.contiguous(), k, idx, val)
    with _count_lock:  # shard workers launch from several threads
        mmr_select.launches += 1
    return idx, val


#: kernel launches since the last reset (the plain CPU path never counts)
mmr_select.launches = 0
