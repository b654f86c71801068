"""Programmatic Embedding Modulation (PEM) — the paper's core operator set.

Each modulation is a pure function over (embedding matrix ``M``, score array
``s``, query vector ``q``).  The formulas are paper Table 1, verbatim:

    suppress:X    s -= w * (M @ embed(X))                       (w = 0.5)
    decay:N       s *= 1 / (1 + days / N)
    centroid:ids  q = a*q + (1-a)*mean(E[ids]); q /= ||q||       (a = 0.5)
    from:A to:B   s  = 0.5*s + 0.5*(M @ (embed(B) - embed(A)))
    diverse       MMR: score = lam*rel - (1-lam)*max_sim         (lam = 0.7)

Modulations execute in a FIXED order regardless of token order (paper §3.3):

    centroid -> base similarity -> trajectory -> decay -> suppress -> diverse

The functions below are numpy: the paper-faithful host engine, and the oracle
the Hopper backend's kernels are held against.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

Array = Any  # np.ndarray

# Paper defaults (§4.4): suppress w=0.5, centroid alpha=0.5, trajectory blend
# 0.5/0.5, decay half-life 30 days, diverse lambda=0.7 with 3x oversample,
# candidate pool K=500.
DEFAULT_SUPPRESS_WEIGHT = 0.5
DEFAULT_CENTROID_ALPHA = 0.5
DEFAULT_TRAJECTORY_BLEND = 0.5
DEFAULT_DECAY_HALF_LIFE = 30.0
DEFAULT_MMR_LAMBDA = 0.7
DEFAULT_MMR_OVERSAMPLE = 3
DEFAULT_POOL = 500
DEFAULT_FUSE_WEIGHT = 0.5
DEFAULT_RRF_K = 60


def l2_normalize(v: Array, eps: float = 1e-12) -> Array:
    """L2-normalize along the last axis."""
    nrm = (v * v).sum(axis=-1, keepdims=True) ** 0.5
    return v / (nrm + eps)


# ---------------------------------------------------------------------------
# Specs — a declarative plan the grammar parser emits and every backend
# (numpy host engine, Hopper kernel backend) consumes.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SuppressSpec:
    """`suppress:X` — subtract directional similarity toward a concept."""

    direction: Array  # (d,) L2-normalized embed(X)
    weight: float = DEFAULT_SUPPRESS_WEIGHT


@dataclasses.dataclass(frozen=True)
class DecaySpec:
    """`decay:N` — reciprocal temporal decay with an N-day half-life."""

    half_life_days: float = DEFAULT_DECAY_HALF_LIFE


@dataclasses.dataclass(frozen=True)
class CentroidSpec:
    """`centroid:ids` — shift the query toward the mean of example embeds."""

    examples: Array  # (m, d) embeddings of the example chunks
    alpha: float = DEFAULT_CENTROID_ALPHA


@dataclasses.dataclass(frozen=True)
class TrajectorySpec:
    """`from:A to:B` — blend directional similarity along embed(B)-embed(A)."""

    direction: Array  # (d,) = embed(B) - embed(A), NOT renormalized (paper)
    blend: float = DEFAULT_TRAJECTORY_BLEND


@dataclasses.dataclass(frozen=True)
class DiverseSpec:
    """`diverse` — MMR iterative selection from an oversampled pool."""

    lam: float = DEFAULT_MMR_LAMBDA
    oversample: int = DEFAULT_MMR_OVERSAMPLE


@dataclasses.dataclass(frozen=True)
class FusionSpec:
    """`fuse:MODE[,param]` — how lexical (BM25) and vector scores combine.

    ``weighted``: final = weight * modulated + (1-weight) * minmax(bm25),
    fused ON DEVICE as an additive score bias (the weight folds into the
    query panel by linearity, the lexical part rides as ``score_bias``).
    ``rrf``: reciprocal-rank fusion 1/(k+rank) over the two ranked lists,
    finished on host after selection (rank fusion is not linear in scores).
    ``filter``: the lexical hit set becomes a HARD Phase-1 candidate set
    (sharp-keyword hybrid: only FTS hits are eligible, so the
    selectivity-aware ``PrefilterRouter`` crossover applies to the
    lexical leg); ranking within the hits is pure-vector at the default
    ``weight=1.0``, or weighted fusion when ``fuse:filter,W`` gives
    ``W < 1``.
    """

    mode: str = "weighted"  # "weighted" | "rrf" | "filter"
    weight: float = DEFAULT_FUSE_WEIGHT  # vector-side weight, weighted mode
    rrf_k: int = DEFAULT_RRF_K


@dataclasses.dataclass(frozen=True)
class LexicalHits:
    """Resolved `keyword:` clause: sparse BM25 hits, min-max normalized.

    ``ids`` are chunk ids in descending lexical relevance; ``scores`` are
    the matching normalized scores in [0, 1].  Resolved at plan-build time
    (like centroid ids) so the plan stays executable without a connection.
    """

    ids: np.ndarray     # (m,) int64
    scores: np.ndarray  # (m,) float32, min-max normalized, descending


@dataclasses.dataclass(frozen=True)
class ModulationPlan:
    """Everything Phase 2 needs, in executable form.

    ``query`` is the raw `similar:` embedding; centroid shifting happens at
    execution time so the plan remains a faithful record of the request.
    ``cluster``/``central`` are the §3.2 STRUCTURAL operators: they compute
    over the selected candidates and surface as extra temp-table columns.
    """

    query: Array  # (d,) L2-normalized
    centroid: Optional[CentroidSpec] = None
    trajectory: Optional[TrajectorySpec] = None
    decay: Optional[DecaySpec] = None
    suppress: Tuple[SuppressSpec, ...] = ()
    diverse: Optional[DiverseSpec] = None
    pool: int = DEFAULT_POOL
    cluster: Optional[int] = None   # cluster:K -> k-means label column
    central: bool = False           # central -> similarity-centrality column
    keyword: Optional[str] = None   # keyword:TEXT -> lexical leg of fusion
    fusion: Optional[FusionSpec] = None
    lexical: Optional[LexicalHits] = None  # resolved keyword: hits

    @property
    def n_directions(self) -> int:
        """Query-side directions the fused kernel must score (incl. base)."""
        return 1 + (1 if self.trajectory is not None else 0) + len(self.suppress)


def fusion_scale(plan: ModulationPlan) -> float:
    """Vector-side multiplier for weighted fusion (1.0 = no scaling).

    Folding the weight into the query panel keeps the fused pipeline a
    single GEMM: w*(decay*(M@q_pre) + M@q_sup) == decay*(M@(w*q_pre)) +
    M@(w*q_sup) by linearity.  RRF never scales (rank-based).
    """
    if plan.fusion is not None and plan.fusion.mode in ("weighted", "filter"):
        return float(plan.fusion.weight)
    return 1.0


def filter_candidate_ids(
    plan: "ModulationPlan",
    candidate_ids=None,
):
    """Phase-1 candidate set for a ``fuse:filter`` plan.

    Returns the lexical hit ids (intersected with an existing Phase-1
    candidate set when both filters apply — the SQL pre-filter stays
    hard under the lexical one), or ``candidate_ids`` unchanged for
    every other plan.  An empty intersection returns an empty array, not
    None: a filter that matched nothing must yield no results, not the
    full corpus.
    """
    f = plan.fusion
    if f is None or f.mode != "filter" or plan.lexical is None:
        return candidate_ids
    lex = np.asarray(plan.lexical.ids, np.int64)
    if candidate_ids is None:
        return lex
    cand = (candidate_ids if isinstance(candidate_ids, np.ndarray)
            else np.asarray(list(candidate_ids), dtype=np.int64))
    return lex[np.isin(lex, cand)]


def combine_lexical_pools(
    pools: Sequence[Tuple[np.ndarray, np.ndarray]],
    pool: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge per-``keyword:``-token FTS pools into one lexical hit list.

    Overlapping hits across tokens dedup by chunk id and their per-token
    min-max scores combine by CombSUM (the sum of normalized scores — a
    chunk matching several keyword clauses outranks one matching a
    single clause at the same strength), then the combined scores
    re-normalize to [0, 1] and the list sorts descending, ties broken by
    first-seen order (token order, then each pool's own rank) so the
    result is deterministic.  Truncates to ``pool`` entries.
    """
    scores: dict = {}
    order: dict = {}
    for ids, vals in pools:
        for i, v in zip(np.asarray(ids, np.int64),
                        np.asarray(vals, np.float32)):
            i = int(i)
            scores[i] = scores.get(i, 0.0) + float(v)
            if i not in order:
                order[i] = len(order)
    if not scores:
        return np.empty(0, np.int64), np.empty(0, np.float32)
    ranked = sorted(scores.items(), key=lambda kv: (-kv[1], order[kv[0]]))
    ranked = ranked[:max(0, int(pool))]
    ids = np.asarray([i for i, _ in ranked], np.int64)
    vals = minmax_normalize(np.asarray([v for _, v in ranked], np.float32))
    return ids, np.asarray(vals, np.float32)


def minmax_normalize(values: Array) -> Array:
    """Min-max normalize to [0, 1]; degenerate (max==min) maps to ones."""
    values = np.asarray(values)
    if values.shape[0] == 0:
        return values
    lo, hi = values.min(), values.max()
    if hi == lo:
        return np.ones_like(values)
    return (values - lo) / (hi - lo)


def rrf_fuse(
    vector_ids: Sequence[int],
    lexical_ids: Sequence[int],
    rrf_k: int = DEFAULT_RRF_K,
) -> List[Tuple[int, float]]:
    """Reciprocal-rank fusion over two ranked id lists.

    score(id) = sum over lists containing id of 1/(rrf_k + rank), rank
    1-based.  Ties break deterministically by first-seen order (vector
    list first, then lexical).
    """
    scores: dict = {}
    order: dict = {}
    for lst in (vector_ids, lexical_ids):
        for rank, i in enumerate(lst, start=1):
            i = int(i)
            scores[i] = scores.get(i, 0.0) + 1.0 / (rrf_k + rank)
            if i not in order:
                order[i] = len(order)
    return sorted(scores.items(), key=lambda kv: (-kv[1], order[kv[0]]))


# ---------------------------------------------------------------------------
# The five modulations, as pure functions (paper Table 1).
# ---------------------------------------------------------------------------


def apply_centroid(query: Array, spec: CentroidSpec) -> Array:
    """q = alpha*q + (1-alpha)*mean(E[ids]);  q /= ||q||   (query-side)."""
    center = spec.examples.mean(axis=0)
    q = spec.alpha * query + (1.0 - spec.alpha) * center
    return l2_normalize(q)


def base_similarity(matrix: Array, query: Array) -> Array:
    """Brute-force cosine scores for L2-normalized rows: one matvec."""
    return matrix @ query


def apply_trajectory(scores: Array, matrix: Array, spec: TrajectorySpec) -> Array:
    """scores = (1-b)*sim + b*(M @ (embed(B) - embed(A))), b = 0.5 default."""
    directional = matrix @ spec.direction
    return (1.0 - spec.blend) * scores + spec.blend * directional


def apply_decay(scores: Array, days_ago: Array, spec: DecaySpec) -> Array:
    """scores *= 1 / (1 + days/N). Not a filter: old-but-relevant survives."""
    return scores * (1.0 / (1.0 + days_ago / spec.half_life_days))


def apply_suppress(scores: Array, matrix: Array, spec: SuppressSpec) -> Array:
    """scores -= w * (M @ embed(X)). Multiple suppressions stack additively."""
    return scores - spec.weight * (matrix @ spec.direction)


def mmr_select_np(
    pool_embeds: np.ndarray,
    pool_scores: np.ndarray,
    k: int,
    lam: float = DEFAULT_MMR_LAMBDA,
) -> np.ndarray:
    """Maximal Marginal Relevance over a candidate pool (numpy host path).

    Iteratively picks argmax of  lam*rel - (1-lam)*max_sim(selected)  from the
    remaining pool.  O(k * n * d); the pool is small (paper: 3x oversample of
    K=500) so this is the paper's ``k x n pairwise`` cost.
    """
    n = pool_scores.shape[0]
    k = min(k, n)
    selected = np.empty(k, dtype=np.int64)
    max_sim = np.full(n, -np.inf)
    taken = np.zeros(n, dtype=bool)
    for i in range(k):
        mmr = lam * pool_scores - (1.0 - lam) * np.where(
            np.isneginf(max_sim), 0.0, max_sim
        )
        mmr = np.where(taken, -np.inf, mmr)
        j = int(np.argmax(mmr))
        selected[i] = j
        taken[j] = True
        sim_to_j = pool_embeds @ pool_embeds[j]
        max_sim = np.maximum(max_sim, sim_to_j)
    return selected


def modulate_scores(
    matrix: Array,
    days_ago: Optional[Array],
    plan: ModulationPlan,
) -> Array:
    """Run the score-side fixed-order pipeline (no selection).

    Order (paper §3.3): centroid (query shift) -> base similarity ->
    trajectory -> decay -> suppress.  `diverse` changes selection, not
    scoring, and is applied by the caller over the top-pool candidates.
    """
    q = plan.query
    if plan.centroid is not None:
        q = apply_centroid(q, plan.centroid)
    scores = base_similarity(matrix, q)
    if plan.trajectory is not None:
        scores = apply_trajectory(scores, matrix, plan.trajectory)
    if plan.decay is not None:
        if days_ago is None:
            raise ValueError("decay: modulation requires per-chunk timestamps")
        scores = apply_decay(scores, days_ago, plan.decay)
    for spec in plan.suppress:
        scores = apply_suppress(scores, matrix, spec)
    scale = fusion_scale(plan)
    if scale != 1.0:  # guarded: fuse:weighted,1.0 stays bit-identical
        scores = scores * scale
    return scores


def effective_query(plan: ModulationPlan) -> Array:
    """The query vector after centroid shift (what base similarity uses)."""
    q = plan.query
    if plan.centroid is not None:
        q = apply_centroid(q, plan.centroid)
    return q


def stacked_directions(plan: ModulationPlan) -> Tuple[Array, Array]:
    """Fuse all query-side directions into one (d, m) panel + (m,) weights.

    This is the beyond-paper TPU formulation: because trajectory and suppress
    are LINEAR in the scores, the whole pre-decay/post-decay pipeline is

        scores = (M @ Q_all) @ w        with decay folded multiplicatively.

    Column 0 is the (centroid-shifted) query; its weight absorbs the
    trajectory blend ((1-b) scaling of the base sim). Trajectory contributes
    column with weight b. Suppressions contribute columns with weight -w_i.

    NOTE decay ordering: the paper applies decay BEFORE suppress, i.e.
        s = decay(
              (1-b)*sim + b*traj
            ) - sum_i w_i * (M @ x_i)
    so the fused form is  decay * (M @ Q_pre) @ w_pre  +  (M @ Q_sup) @ w_sup.
    `stacked_directions` returns the PRE-decay panel columns first and the
    suppress columns after; the consumer splits at `1 + has_trajectory`.
    """
    q = effective_query(plan)
    cols = [q]
    weights = [1.0]
    if plan.trajectory is not None:
        weights[0] = 1.0 - plan.trajectory.blend
        cols.append(plan.trajectory.direction)
        weights.append(plan.trajectory.blend)
    for spec in plan.suppress:
        cols.append(spec.direction)
        weights.append(-spec.weight)
    panel = np.stack(cols, axis=1)  # (d, m)
    w = np.asarray(weights, dtype=panel.dtype)
    return panel, w


def fold_plan(plan: ModulationPlan) -> Tuple[np.ndarray, np.ndarray]:
    """Fold one plan's directions into (q_pre, q_sup), each (d,).

    Linearity (DESIGN.md §2.1): trajectory and suppress are linear in the
    score array, so
        q_pre = (1-blend)*q_centroid_shifted + blend*direction_traj
        q_sup = -sum_i w_i * x_i
    and  scores = decay * (M @ q_pre) + M @ q_sup  reproduces the fixed-order
    pipeline exactly.
    """
    q = np.asarray(effective_query(plan), dtype=np.float32)
    if plan.trajectory is not None:
        b = plan.trajectory.blend
        q_pre = (1.0 - b) * q + b * np.asarray(plan.trajectory.direction, np.float32)
    else:
        q_pre = q
    d = q.shape[-1]
    q_sup = np.zeros(d, dtype=np.float32)
    for spec in plan.suppress:
        q_sup -= spec.weight * np.asarray(spec.direction, np.float32)
    scale = fusion_scale(plan)
    if scale != 1.0:  # guarded: fuse:weighted,1.0 stays bit-identical
        q_pre = np.asarray(scale * q_pre, dtype=np.float32)
        q_sup = np.asarray(scale * q_sup, dtype=np.float32)
    return q_pre, q_sup


def fold_plans(plans: Sequence[ModulationPlan]) -> Tuple[np.ndarray, np.ndarray]:
    """Batch of plans -> (q_pre (d,B), q_sup (d,B)) panels."""
    pres, sups = zip(*(fold_plan(p) for p in plans))
    return np.stack(pres, axis=1), np.stack(sups, axis=1)


def fused_modulate_scores(
    matrix: Array,
    days_ago: Optional[Array],
    plan: ModulationPlan,
) -> Array:
    """Single-GEMM formulation of `modulate_scores` (algebraically equal).

    scores = decay * ((M @ Q_pre) @ w_pre) + (M @ Q_sup) @ w_sup
    """
    panel, w = stacked_directions(plan)
    n_pre = 1 + (1 if plan.trajectory is not None else 0)
    all_scores = matrix @ panel  # (N, m) — ONE pass over the corpus matrix
    pre = all_scores[:, :n_pre] @ w[:n_pre]
    if plan.decay is not None:
        if days_ago is None:
            raise ValueError("decay: modulation requires per-chunk timestamps")
        pre = apply_decay(pre, days_ago, plan.decay)
    if panel.shape[1] > n_pre:
        pre = pre + all_scores[:, n_pre:] @ w[n_pre:]
    scale = fusion_scale(plan)
    if scale != 1.0:  # guarded: fuse:weighted,1.0 stays bit-identical
        pre = pre * scale
    return pre
