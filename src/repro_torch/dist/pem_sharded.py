"""Sharded PEM scoring + top-k: the two-stage distributed retrieval path.

The port of ``repro.dist.pem_sharded``.  Gathering the full (N, B) score
panel of a row-sharded corpus before selecting moves N·B scores across
the interconnect; this module's ``make_pem_topk`` has every shard score
its own corpus rows (the ``pem_score`` kernel), select a LOCAL top-k (the
``topk`` kernel), and send only the (shards · k, B) candidate union, which
one more ``topk`` merges — ``shards·k·B / (N·B)`` of the naive traffic.

A rank of a ``torch.distributed`` process group takes the place of a
mesh axis: one card is one rank, its block of rows is contiguous, and
``all_gather`` in rank order is the shard-major gather.  The merge itself
is one pure function, :func:`merge_shard_major`, over stacked per-shard
candidates, so an in-process caller (``ShardedBackend``, where the copy
to the lead device stands in for the collective) merges exactly as the
collective forms do.

Exactness: brute-force scoring is preserved (Bruch, *Foundations of
Vector Retrieval*: flat top-k is exact); the union of per-shard top-k
provably contains the global top-k, so the merge returns exactly the
unsharded result, tie order included.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.modulations import DEFAULT_DECAY_HALF_LIFE
from repro_torch.kernels.pem_score.ops import pem_score
from repro_torch.kernels.topk.ops import topk
from repro_torch.kernels.topk.ref import topk_ref

__all__ = [
    "pem_topk_reference",
    "merge_shard_major",
    "union_merge_topk",
    "union_merge_topk_payload",
    "make_pem_topk",
]


def pem_topk_reference(
    corpus: torch.Tensor,   # (N, d) row-major chunk embeddings
    days: torch.Tensor,     # (N,) age in days
    q_pre: torch.Tensor,    # (d, B) pre-decay direction panel
    q_sup: torch.Tensor,    # (d, B) suppress panel
    k: int,
    *,
    half_life: float = DEFAULT_DECAY_HALF_LIFE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unsharded oracle in plain PyTorch: full-panel fused scoring + global
    top-k (``jax.lax.top_k`` order: ties to the smallest row).

    Returns ``(indices, values)`` each (B, k), descending by score — the
    contract every sharded lowering must reproduce exactly.
    """
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products, as JAX's
    decay = 1.0 / (1.0 + days.to(torch.float32) / half_life)
    scores = decay[:, None] * (corpus @ q_pre) + corpus @ q_sup  # (N, B)
    v, i = topk_ref(scores.T, k)
    return i, v


def merge_shard_major(
    cand_v: torch.Tensor,                   # (S, B, k_local) values
    cand_i: torch.Tensor,                   # (S, B, k_local) GLOBAL rows
    k: int,
    cand_p: Optional[torch.Tensor] = None,  # (S, B, k_local, d) payload
):
    """One top-k over the union of S shards' local top-k candidates.

    The stack swaps to (B, S·k_local) in SHARD-MAJOR order before the
    selection.  Shards hold contiguous row blocks in rank order and each
    shard's list is sorted with ties to its smallest row, so position in
    the union is global row order among equal scores; the ``topk`` kernel
    breaks ties to the smallest position, which keeps the reference's
    smallest-global-row rule (``repro/dist/pem_sharded.py:55-58``).  A
    rank-major stack, or a concatenation along the candidate axis of
    per-query lists, would break it for ties that straddle a shard
    boundary.

    Indices (and the payload, when given) follow the same permutation.
    Returns ``(indices, values[, payload])``, each (B, min(k, S·k_local)).
    On a CUDA tensor the selection is the ``topk`` kernel; on the CPU its
    plain version.
    """
    s, b, kl = cand_v.shape
    union = s * kl
    v = cand_v.transpose(0, 1).reshape(b, union)
    i = cand_i.transpose(0, 1).reshape(b, union)
    vk, pos = topk(v, min(k, union))
    pos = pos.long()
    ik = torch.gather(i, 1, pos)
    if cand_p is None:
        return ik, vk
    d = cand_p.shape[-1]
    p = cand_p.transpose(0, 1).reshape(b, union, d)
    pk = torch.gather(p, 1, pos[..., None].expand(-1, -1, d))
    return ik, vk, pk


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    """(S, ...) stack of every rank's ``t``, in rank order."""
    import torch.distributed as dist

    parts = [torch.empty_like(t)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def union_merge_topk(
    v: torch.Tensor,    # (B, k_local) this rank's local top-k values
    gi: torch.Tensor,   # (B, k_local) matching GLOBAL row indices
    k: int,
    group=None,         # the process group the corpus rows shard over
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Collective union merge: ``all_gather`` every rank's local top-k in
    rank order (shard-major), then :func:`merge_shard_major`.  Every rank
    returns the same ``(indices, values)``, each (B, min(k, S·k_local)).
    Ranks must hold equal row counts (equal ``k_local``)."""
    return merge_shard_major(_gather(v, group), _gather(gi, group), k)


def union_merge_topk_payload(
    v: torch.Tensor,    # (B, k_local) local top-k values
    gi: torch.Tensor,   # (B, k_local) matching GLOBAL row indices
    pe: torch.Tensor,   # (B, k_local, d) matching row PAYLOAD (embeddings)
    k: int,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`union_merge_topk` carrying a per-candidate payload — the
    pool-row embeddings each rank gathered from its OWN rows, so a diverse
    (MMR) tail never reads the full row space: the collective moves
    ``S · k_local · (2 + d)`` elements, independent of N.  The payload
    rides the same permutation as the indices, so ``pk[b, j]`` is the row
    ``ik[b, j]``.  Returns ``(indices, values, payload)``."""
    return merge_shard_major(_gather(v, group), _gather(gi, group), k,
                             _gather(pe, group))


def make_pem_topk(k: int, *, half_life: float = DEFAULT_DECAY_HALF_LIFE,
                  group=None):
    """Build the row-sharded score -> local top-k -> merge function.

    The returned ``fn(corpus, days, q_pre, q_sup) -> (indices, values)``
    takes THIS rank's contiguous block of ``n_local`` rows (rank r holds
    global rows ``[r·n_local, (r+1)·n_local)``) and the replicated query
    panels.  It runs the ``pem_score`` kernel into a (B, n_local) panel,
    the ``topk`` kernel for ``min(k, n_local)``, offsets the indices to
    global rows and union-merges over ``group`` (None: the default group;
    no initialised group: one rank).  At world size 1 it returns the
    local result.  Every rank needs the same ``n_local`` (callers pad the
    row grid, as the reference requires N divisible by the shard count).
    """
    import torch.distributed as dist

    def sharded_topk(corpus, days, q_pre, q_sup):
        world = (dist.get_world_size(group) if dist.is_initialized() else 1)
        rank = dist.get_rank(group) if world > 1 else 0
        n_local = corpus.shape[0]
        b = q_pre.shape[1]
        panel = torch.empty((b, n_local), dtype=torch.float32,
                            device=corpus.device)
        pem_score(corpus, q_pre, q_sup, days_ago=days.to(torch.float32),
                  half_lives=torch.full((b,), float(half_life),
                                        device=corpus.device),
                  out=panel.T)
        v, i = topk(panel, min(k, n_local))           # (B, k_local)
        gi = i.long() + rank * n_local                # global row ids
        if world == 1:
            return gi, v
        return union_merge_topk(v, gi, k, group)

    return sharded_topk
