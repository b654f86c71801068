"""Plain PyTorch version of the fused PEM scoring kernel.

    scores[n, b] = f[n, b] * (M[n] . q_pre[:, b]) + (M[n] . q_sup[:, b])

``q_pre``/``q_sup`` are the two effective vectors every plan folds into
(``core.modulations.fold_plans``).  The factor ``f`` takes one of two
forms: :func:`pem_score_ref` takes one (N,) column shared by every plan
(the reciprocal temporal factor 1/(1 + days/half_life), or ones), and
:func:`pem_score_days_ref` computes each plan's own column from the rows'
ages and the plans' half-lives (+inf for a plan without decay gives
exactly 1); :func:`pem_score_stamps_ref` first forms those ages from the
rows' unix timestamps and ``now``.  Float32 accumulation whatever the
corpus dtype, like the kernel.
"""

from __future__ import annotations

import torch


def _products(matrix, q_pre, q_sup):
    # f64 products rounded once to f32: a BLAS f32 product sums a row in an
    # order that depends on how many rows share the call (its tile edges),
    # so two equal rows in blocks of different length could score apart by
    # a last bit and break a tie the wrong way; rounded from f64 they score
    # the same wherever they sit, within 1e-5 of any f32 summation order
    m = matrix.to(torch.float64)
    return ((m @ q_pre.to(torch.float64)).to(torch.float32),
            (m @ q_sup.to(torch.float64)).to(torch.float32))


def pem_score_ref(
    matrix: torch.Tensor,   # (N, d) corpus embeddings (f32 or bf16)
    q_pre: torch.Tensor,    # (d, B) pre-decay effective vectors
    q_sup: torch.Tensor,    # (d, B) post-decay (suppress) effective vectors
    decay: torch.Tensor,    # (N,)   temporal factor (ones if no decay)
) -> torch.Tensor:          # (N, B) float32 scores
    pre, sup = _products(matrix, q_pre, q_sup)
    return decay.to(torch.float32)[:, None] * pre + sup


def decay_factors(days_ago: torch.Tensor,
                  half_lives: torch.Tensor) -> torch.Tensor:
    """(N, B) factors 1 / (1 + days / half_life) in f32, each operation
    correctly rounded, as the reference computes one column in numpy."""
    days = days_ago.to(torch.float32)[:, None]
    return 1.0 / (1.0 + days / half_lives.to(torch.float32)[None, :])


def pem_score_days_ref(
    matrix: torch.Tensor,      # (N, d) corpus embeddings (f32 or bf16)
    q_pre: torch.Tensor,       # (d, B)
    q_sup: torch.Tensor,       # (d, B)
    days_ago: torch.Tensor,    # (N,) row ages in days
    half_lives: torch.Tensor,  # (B,) per-plan half-lives, +inf for none
) -> torch.Tensor:             # (N, B) float32 scores
    pre, sup = _products(matrix, q_pre, q_sup)
    return decay_factors(days_ago, half_lives) * pre + sup


def ages_from_stamps(timestamps: torch.Tensor, now: float) -> torch.Tensor:
    """(N,) f32 ages in days: ``max((now - ts) / 86400, 0)`` in f64, each
    operation correctly rounded, then rounded to f32 -- the host's
    ``CorpusSegment.days_ago`` bit for bit (a NaN timestamp gives NaN, as
    ``np.maximum`` keeps it)."""
    x = (float(now) - timestamps.to(torch.float64)) / 86400.0
    return torch.maximum(x, x.new_zeros(())).to(torch.float32)


def pem_score_stamps_ref(
    matrix: torch.Tensor,      # (N, d) corpus embeddings (f32 or bf16)
    q_pre: torch.Tensor,       # (d, B)
    q_sup: torch.Tensor,       # (d, B)
    timestamps: torch.Tensor,  # (N,) f64 unix seconds
    now: float,                # unix seconds
    half_lives: torch.Tensor,  # (B,) per-plan half-lives, +inf for none
) -> torch.Tensor:             # (N, B) float32 scores
    return pem_score_days_ref(matrix, q_pre, q_sup,
                              ages_from_stamps(timestamps, now), half_lives)
