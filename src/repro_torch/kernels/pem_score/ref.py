"""Plain PyTorch version of the fused PEM scoring kernel.

    scores[n, b] = decay[n] * (M[n] . q_pre[:, b]) + (M[n] . q_sup[:, b])

``q_pre``/``q_sup`` are the two effective vectors every plan folds into
(``core.modulations.fold_plans``); ``decay`` is the reciprocal temporal
factor 1/(1 + days/half_life), or ones.  Float32 accumulation whatever the
corpus dtype, like the kernel.
"""

from __future__ import annotations

import torch


def pem_score_ref(
    matrix: torch.Tensor,   # (N, d) corpus embeddings (f32 or bf16)
    q_pre: torch.Tensor,    # (d, B) pre-decay effective vectors
    q_sup: torch.Tensor,    # (d, B) post-decay (suppress) effective vectors
    decay: torch.Tensor,    # (N,)   temporal factor (ones if no decay)
) -> torch.Tensor:          # (N, B) float32 scores
    # full f32 products on the card: TF32 keeps ~3 digits and would miss
    # the 1e-5 tolerance this version is the yardstick for
    torch.backends.cuda.matmul.allow_tf32 = False
    m = matrix.to(torch.float32)
    pre = m @ q_pre.to(torch.float32)
    sup = m @ q_sup.to(torch.float32)
    return decay.to(torch.float32)[:, None] * pre + sup
