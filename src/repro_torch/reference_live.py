"""A plain reference of one composed query over a live store: the rows of
every segment, tombstoned rows held out, scored and selected as one
corpus.

It imports ``torch`` and ``numpy`` only, nothing of the port, and knows
nothing of segments: the segments' arrays (the dicts
:func:`repro_torch.core.segments.store_from_arrays` takes) are joined in
store order once, and every query is answered over the live rows of that
one corpus.  Holding the port's segmented pass to it is the claim that
segmentation does not change the answer.

- Scores, in float64: ``decay * (M q_pre) + M q_sup`` with
  ``decay = 1 / (1 + days / half_life)`` (1 without a half-life) and
  ``days = max(now - ts, 0) / 86400``, over the live rows only.
- Selection: the exact top ``min(k, live)`` rows by score, ties to the
  smallest global row (a row's offset in the joined arrays, tombstoned
  rows counted).  ``diverse`` first takes the top
  ``min(3 * max(k, pool), live)`` rows the same way, then greedy MMR
  picks ``k`` of them: at each step the first largest
  ``lam * rel - (1 - lam) * max_sim``, ``max_sim`` 0 before the first
  pick and otherwise the largest similarity to a pick so far.

Every product runs in float64 on the CPU, and TF32 is off for any
float32 product torch might be asked for beside it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

SECONDS_PER_DAY = 86400.0
OVERSAMPLE = 3


class LiveReference:
    """The live rows of a store's segments at a fixed ``now``."""

    def __init__(self, segments: Sequence[Dict[str, np.ndarray]],
                 now: float):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ids = np.concatenate([np.asarray(s["ids"], np.int64)
                              for s in segments])
        live = np.concatenate([np.asarray(s["live_mask"], bool)
                               for s in segments])
        ts = np.concatenate([np.asarray(s["timestamps"], np.float64)
                             for s in segments])
        rows = np.flatnonzero(live)
        matrix = np.concatenate([np.asarray(s["matrix"], np.float32)
                                 for s in segments])
        self.ids = ids
        self.rows = torch.from_numpy(rows)          # global rows, ascending
        self.matrix = torch.from_numpy(matrix[rows]).double()
        self.days = torch.from_numpy(
            np.maximum(float(now) - ts[rows], 0.0) / SECONDS_PER_DAY)

    @property
    def n_live(self) -> int:
        return int(self.rows.numel())

    def scores(self, q_pre, q_sup,
               half_life: Optional[float]) -> torch.Tensor:
        """(live,) float64 scores of the live rows."""
        pre = torch.as_tensor(np.asarray(q_pre, np.float64))
        sup = torch.as_tensor(np.asarray(q_sup, np.float64))
        out = self.matrix @ pre
        if half_life is not None:
            out = out / (1.0 + self.days / float(half_life))
        return out + self.matrix @ sup

    def top(self, scores: torch.Tensor, width: int) -> torch.Tensor:
        """Positions among the live rows of the ``width`` best scores, by
        descending score, ties to the smallest row (the live rows are in
        ascending global order, so a stable sort keeps that)."""
        order = torch.sort(-scores, stable=True).indices
        return order[:width]

    def mmr(self, pos: torch.Tensor, rel: torch.Tensor, k: int,
            lam: float) -> torch.Tensor:
        """Greedy MMR: ``k`` positions into ``pos`` in pick order."""
        emb = self.matrix[pos]
        max_sim = torch.zeros(pos.numel(), dtype=torch.float64)
        taken = torch.zeros(pos.numel(), dtype=torch.bool)
        picks = torch.empty(k, dtype=torch.int64)
        for step in range(k):
            val = lam * rel - (1.0 - lam) * max_sim
            val[taken] = -torch.inf
            j = int(torch.argmax(val))     # the first largest
            picks[step] = j
            taken[j] = True
            sim = emb @ emb[j]
            max_sim = sim if step == 0 else torch.maximum(max_sim, sim)
        return picks

    def search(self, q_pre, q_sup, half_life: Optional[float], *, k: int,
               pool: int, diverse: bool,
               lam: float = 0.7) -> Tuple[np.ndarray, np.ndarray]:
        """One query: (chunk ids, float64 scores) of its selection, in
        order."""
        s = self.scores(q_pre, q_sup, half_life)
        k = max(0, min(int(k), self.n_live))
        if diverse:
            width = min(OVERSAMPLE * max(k, int(pool)), self.n_live)
            pos = self.top(s, width)
            pos = pos[self.mmr(pos, s[pos], min(k, width), lam)]
        else:
            pos = self.top(s, k)
        return self.ids[self.rows[pos].numpy()], s[pos].numpy()
