"""The plain reference: a frozen NumPy copy of flexvec's composed-query
semantics, worked out from the corpus arrays and query strings that the
benchmark made.  It imports nothing of the program.

- Grammar: the tokens the traffic uses (``similar:``, ``suppress:``
  (repeatable), ``from:``/``to:``, ``decay:N``, ``pool:N``, ``diverse``),
  whitespace-delimited, a prefix opening a clause that bare words extend.
- Embedding: ``corpus.embed`` (the hash embedder), each direction then
  L2-normalised; the trajectory is ``embed(to) - embed(from)`` of the two
  normalised ends, not normalised again.
- Scores (the paper's Table 1, in its fixed order): ``s = M q``; with a
  trajectory ``s = 0.5 s + 0.5 M t``; ``s *= 1 / (1 + days / N)``;
  ``s -= 0.5 M x`` for each suppression.  ``days = max(now - ts, 0) /
  86400``.  Tombstoned rows take no part.
- Selection: exact top-k by score, ties to the smallest row; ``diverse``
  is MMR with lambda 0.7 over the top ``3 * max(k, pool)`` rows, each step
  taking the first largest ``0.7 rel - 0.3 max_sim`` (max_sim 0 before
  the first pick).

``precision="f64"`` computes every product in float64 (the reference).
``precision="tf32"`` rounds both operands of every product to TF32 (10
explicit mantissa bits, to nearest) and accumulates in float32: the
control, TF32 put in place of the float32 that the configuration states.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from harness import corpus as C

PREFIXES = ("similar", "suppress", "from", "to", "decay", "pool")
SUPPRESS_WEIGHT = 0.5
TRAJECTORY_BLEND = 0.5
MMR_LAMBDA = 0.7
OVERSAMPLE = 3
DEFAULT_POOL = 500
BLOCK = 1 << 17


@dataclasses.dataclass
class Query:
    similar: Optional[str] = None
    suppress: List[str] = dataclasses.field(default_factory=list)
    from_text: Optional[str] = None
    to_text: Optional[str] = None
    decay: Optional[float] = None
    diverse: bool = False
    pool: int = DEFAULT_POOL


def parse(tokens: str) -> Query:
    """The grammar's subset the traffic uses; anything else is refused."""
    q = Query()
    clause = None
    words: List[str] = []

    def close():
        if clause is None:
            return
        text = " ".join(words)
        if not text:
            raise ValueError(f"empty {clause}:")
        if clause == "similar":
            q.similar = text
        elif clause == "suppress":
            q.suppress.append(text)
        elif clause == "from":
            q.from_text = text
        elif clause == "to":
            q.to_text = text

    for raw in tokens.split():
        head, sep, rest = raw.partition(":")
        if sep and head in PREFIXES:
            close()
            clause, words = None, []
            if head == "decay":
                q.decay = float(rest)
            elif head == "pool":
                q.pool = int(rest)
            else:
                clause, words = head, [rest] if rest else []
        elif raw == "diverse":
            close()
            clause, words = None, []
            q.diverse = True
        elif clause is None:
            raise ValueError(f"token {raw!r} outside a clause")
        else:
            words.append(raw)
    close()
    if q.similar is None or (q.from_text is None) != (q.to_text is None):
        raise ValueError(f"unsupported query {tokens!r}")
    return q


def _unit(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def directions(q: Query, dim: int):
    """(q_pre, q_sup), each (dim,) float64: ``s = decay * M q_pre + M q_sup``
    is the fixed-order pipeline above, by linearity."""
    pre = _unit(C.embed(q.similar, dim))
    if q.from_text is not None:
        t = _unit(C.embed(q.to_text, dim)) - _unit(C.embed(q.from_text, dim))
        pre = (1.0 - TRAJECTORY_BLEND) * pre + TRAJECTORY_BLEND * t
    sup = np.zeros(dim)
    for text in q.suppress:
        sup -= SUPPRESS_WEIGHT * _unit(C.embed(text, dim))
    return pre, sup


def tf32(x: np.ndarray) -> np.ndarray:
    """float32 rounded to TF32's 10 explicit mantissa bits, to nearest."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    b = (b + np.uint32(0x0FFF) + ((b >> np.uint32(13)) & np.uint32(1))) \
        & np.uint32(0xFFFFE000)
    return b.view(np.float32)


def operand(x: np.ndarray, precision: str) -> np.ndarray:
    """An operand of a product at ``precision``."""
    if precision == "f64":
        return np.asarray(x, np.float64)
    if precision == "tf32":
        return tf32(np.asarray(x, np.float32))
    raise ValueError(f"precision {precision!r}")


class Reference:
    """Scores and selections over one corpus (``matrix`` (n, d) float32,
    ``timestamps`` (n,), ``live`` (n,) bool) at a fixed ``now``."""

    def __init__(self, matrix, timestamps, live, now: float,
                 precision: str = "f64"):
        self.matrix = matrix
        self.days = np.maximum(now - np.asarray(timestamps, np.float64),
                               0.0) / C.SECONDS_PER_DAY
        self.live = (np.ones(matrix.shape[0], bool) if live is None
                     else np.asarray(live, bool))
        self.precision = precision
        self.dim = matrix.shape[1]

    def _plans(self, queries: Sequence[Query]):
        pre, sup = zip(*(directions(q, self.dim) for q in queries))
        h = np.asarray([q.decay if q.decay is not None else np.inf
                        for q in queries])
        return np.stack(pre, 1), np.stack(sup, 1), h

    def _block_scores(self, rows: np.ndarray, pre, sup, h) -> np.ndarray:
        """(len(rows), B) scores of the given rows."""
        m = operand(self.matrix[rows], self.precision)
        p = operand(pre, self.precision)
        s = operand(sup, self.precision)
        days = self.days[rows][:, None]
        out = (m @ p) * (1.0 / (1.0 + days / h[None, :])) + m @ s
        return out.astype(np.float64)

    def scores_of(self, queries: Sequence[Query], rows_per_query) -> list:
        """Each query's scores of its own rows (any rows, dead ones too)."""
        pre, sup, h = self._plans(queries)
        return [self._block_scores(np.asarray(r, np.int64), pre[:, [j]],
                                   sup[:, [j]], h[[j]])[:, 0]
                for j, r in enumerate(rows_per_query)]

    def top(self, queries: Sequence[Query], width: int):
        """Each query's top ``width`` live rows: (rows (B, w), scores
        (B, w)), by descending score, ties to the smallest row."""
        pre, sup, h = self._plans(queries)
        n, b = self.matrix.shape[0], len(queries)
        best_r = np.empty((b, 0), np.int64)
        best_s = np.empty((b, 0))
        for a in range(0, n, BLOCK):
            rows = np.arange(a, min(n, a + BLOCK))
            rows = rows[self.live[rows]]
            s = self._block_scores(rows, pre, sup, h).T
            cand_r = np.concatenate([best_r, np.broadcast_to(rows, s.shape)], 1)
            cand_s = np.concatenate([best_s, s], 1)
            keep = min(width, cand_s.shape[1])
            part = np.argpartition(-cand_s, keep - 1, axis=1)[:, :keep] \
                if keep < cand_s.shape[1] else \
                np.broadcast_to(np.arange(cand_s.shape[1]), cand_s.shape)
            # a tie at the boundary keeps the smallest rows: re-take every
            # score equal to the cut, then sort by (score desc, row asc)
            cut = np.take_along_axis(cand_s, part, 1).min(1, keepdims=True)
            best_r, best_s = [], []
            for j in range(b):
                sel = np.flatnonzero(cand_s[j] >= cut[j])
                order = np.lexsort((cand_r[j, sel], -cand_s[j, sel]))[:keep]
                best_r.append(cand_r[j, sel[order]])
                best_s.append(cand_s[j, sel[order]])
            best_r, best_s = np.stack(best_r), np.stack(best_s)
        return best_r, best_s

    def rows(self, rows) -> np.ndarray:
        """The corpus rows ``rows`` as operands of a product."""
        return operand(self.matrix[rows], self.precision)

    @staticmethod
    def gram_row(emb: np.ndarray, e: np.ndarray) -> np.ndarray:
        """Similarities of operand rows ``emb`` (..., w, d) to ``e``
        (..., d)."""
        return np.matmul(emb, e[..., None])[..., 0].astype(np.float64)

    def mmr(self, pool_rows: np.ndarray, rel: np.ndarray, k: int,
            lam: float = MMR_LAMBDA) -> np.ndarray:
        """Greedy MMR over each query's pool, batched: (B, k) positions."""
        b, w = rel.shape
        emb = self.rows(pool_rows)
        max_sim = np.zeros((b, w))
        taken = np.zeros((b, w), bool)
        picks = np.empty((b, k), np.int64)
        ar = np.arange(b)
        for step in range(k):
            val = lam * rel - (1.0 - lam) * max_sim
            val[taken] = -np.inf
            j = np.argmax(val, axis=1)
            picks[:, step] = j
            taken[ar, j] = True
            sim = self.gram_row(emb, emb[ar, j])
            max_sim = sim if step == 0 else np.maximum(max_sim, sim)
        return picks

    def mmr_gap(self, pool_rows: np.ndarray, rel: np.ndarray,
                forced: np.ndarray, forced_rel: np.ndarray,
                lam: float = MMR_LAMBDA) -> float:
        """One query followed through the program's own picks ``forced``
        (rows, in pick order, with their reference relevance): the widest
        gap by which a pick's MMR value lies below the best value left in
        the pool at its step."""
        emb = self.rows(pool_rows)
        picks = self.rows(np.asarray(forced, np.int64))
        max_sim = np.zeros(pool_rows.size)
        taken = np.zeros(pool_rows.size, bool)
        where = {int(r): i for i, r in enumerate(pool_rows)}
        gap = 0.0
        for step, (r, fr) in enumerate(zip(forced, forced_rel)):
            f_sim = (float(self.gram_row(picks[:step], picks[step]).max())
                     if step else 0.0)
            val = lam * rel - (1.0 - lam) * max_sim
            val[taken] = -np.inf
            gap = max(gap, float(val.max()) - (lam * fr - (1.0 - lam) * f_sim))
            if int(r) in where:
                taken[where[int(r)]] = True
            else:  # a pick from outside the pool: how far below its edge
                gap = max(gap, float(rel.min()) - float(fr))
            sim = self.gram_row(emb, picks[step])
            max_sim = sim if step == 0 else np.maximum(max_sim, sim)
        return gap


def minmax(values: np.ndarray) -> np.ndarray:
    """Min-max to [0, 1]; all equal maps to ones."""
    lo, hi = values.min(), values.max()
    if hi == lo:
        return np.ones_like(values)
    return (values - lo) / (hi - lo)
