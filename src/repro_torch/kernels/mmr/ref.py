"""Plain PyTorch version of the MMR selection kernel (paper Table 1,
``diverse``).

    score_i = lam * rel_i - (1 - lam) * max_{j in selected} sim(i, j)

Greedy argmax over the unselected pool, first occurrence on ties; the
first pick is pure relevance (the empty selection's NEG sentinel counts
as zero penalty, as in ``mmr_select_np``).  Taken slots and padding (rel
at or below NEG/2) are pinned to NEG after the blend, so lam = 0 cannot
make padding finite.  ``lam`` is per row, (B,).
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG = -1e30


def mmr_ref(
    embeds: torch.Tensor,  # (B, n, d) L2-normalized pool embeddings
    rel: torch.Tensor,     # (B, n)    relevance (modulated scores)
    k: int,
    lam: torch.Tensor,     # (B,)      per-row lambda
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (indices (B, k) int32 in selection order, mmr scores (B, k))."""
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 similarities
    e = embeds.to(torch.float32)
    r = rel.to(torch.float32)
    b, n, _ = e.shape
    lam = lam.to(device=r.device, dtype=torch.float32)[:, None]
    rows = torch.arange(b, device=r.device)
    max_sim = torch.full((b, n), NEG, dtype=torch.float32, device=r.device)
    taken = torch.zeros((b, n), dtype=torch.bool, device=r.device)
    invalid = r <= NEG * 0.5
    idx = torch.zeros((b, k), dtype=torch.int32, device=r.device)
    val = torch.zeros((b, k), dtype=torch.float32, device=r.device)
    for i in range(k):
        penalty = torch.where(max_sim <= NEG * 0.5, 0.0, max_sim)
        mmr = lam * r - (1.0 - lam) * penalty
        mmr = torch.where(taken | invalid, NEG, mmr)
        v, j = mmr.max(dim=1)  # first maximal index on ties
        idx[:, i] = j.to(torch.int32)
        val[:, i] = v
        sim = torch.bmm(e, e[rows, j][:, :, None])[:, :, 0]
        max_sim = torch.maximum(max_sim, sim)
        taken[rows, j] = True
    return idx, val
