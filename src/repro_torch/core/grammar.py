"""Token grammar (paper §3.4.2) — deterministic parser from token string to
:class:`~repro_torch.core.modulations.ModulationPlan`.

Grammar (whitespace-delimited; prefix tokens open a clause, bare words attach
to the open clause's text; bare keywords close it):

    similar:TEXT...      query text (multi-word until next token)
    suppress:TEXT...     suppression direction (repeatable, stacks additively)
    decay:N              N-day half-life (float)
    centroid:id1,id2     example chunk ids (comma separated)
    from:TEXT... to:TEXT trajectory endpoints
    diverse              MMR selection (bare keyword)
    pool:N               candidate pool size (default 500)
    cluster:K            STRUCTURAL (§3.2): k-means label column
    central              STRUCTURAL (§3.2): similarity-centrality column
    keyword:TEXT...      lexical (FTS5/BM25) leg of hybrid fusion
                         (repeatable; pools dedup + CombSUM-combine)
    fuse:weighted,W      hybrid: W*vector + (1-W)*minmax(bm25) (W in [0,1])
    fuse:rrf,K           hybrid: reciprocal-rank fusion with constant K
    fuse:filter[,W]      hybrid: FTS hits become a HARD Phase-1 candidate
                         set (router crossover applies to the lexical
                         leg); W defaults to 1.0 = pure-vector ranking

Tokens may appear in ANY order; execution order is fixed (modulations.py).
``keyword:`` without ``fuse:`` defaults to ``fuse:weighted,0.5``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import modulations as M

EmbedFn = Callable[[str], np.ndarray]
ResolveIdsFn = Callable[[Sequence[int]], np.ndarray]  # ids -> (m, d) embeds
# keyword text + pool width -> (ids desc-by-bm25, minmax scores in [0,1])
LexicalFn = Callable[[str, int], Tuple[np.ndarray, np.ndarray]]

_PREFIXES = ("similar:", "suppress:", "decay:", "centroid:", "from:", "to:",
             "pool:", "cluster:", "keyword:", "fuse:")
_KEYWORDS = ("diverse", "central")


class GrammarError(ValueError):
    """Raised on malformed token strings; surfaced to the agent via MCP."""


@dataclasses.dataclass
class ParsedTokens:
    """Intermediate, embedder-independent parse (pure text -> structure)."""

    similar: Optional[str] = None
    suppress: List[str] = dataclasses.field(default_factory=list)
    decay: Optional[float] = None
    centroid_ids: Optional[List[int]] = None
    from_text: Optional[str] = None
    to_text: Optional[str] = None
    diverse: bool = False
    pool: int = M.DEFAULT_POOL
    cluster: Optional[int] = None   # structural: k-means label column
    central: bool = False           # structural: centrality column
    keyword: Optional[str] = None   # lexical leg of hybrid fusion (joined)
    # one entry per keyword: clause — each token resolves its OWN FTS
    # pool and the pools combine (dedup + CombSUM) at plan build
    keywords: List[str] = dataclasses.field(default_factory=list)
    fuse_mode: Optional[str] = None  # "weighted" | "rrf" | "filter"
    fuse_weight: float = M.DEFAULT_FUSE_WEIGHT
    fuse_k: int = M.DEFAULT_RRF_K


def tokenize(token_string: str) -> ParsedTokens:
    """Parse the whitespace token grammar into :class:`ParsedTokens`."""
    parsed = ParsedTokens()
    # (kind, accumulated words) for the clause currently being extended.
    open_clause: Optional[Tuple[str, List[str]]] = None

    def close() -> None:
        nonlocal open_clause
        if open_clause is None:
            return
        kind, words = open_clause
        text = " ".join(words).strip()
        if not text:
            raise GrammarError(f"empty text for token '{kind}:'")
        if kind == "similar":
            parsed.similar = text
        elif kind == "suppress":
            parsed.suppress.append(text)
        elif kind == "from":
            parsed.from_text = text
        elif kind == "to":
            parsed.to_text = text
        elif kind == "keyword":
            # each keyword: clause keeps its own FTS query (pools dedup
            # and combine at plan build); `keyword` stays the joined
            # text for display/back-compat
            parsed.keywords.append(text)
            parsed.keyword = (
                f"{parsed.keyword} {text}" if parsed.keyword else text
            )
        open_clause = None

    for raw in token_string.split():
        matched_prefix = next((p for p in _PREFIXES if raw.startswith(p)), None)
        if matched_prefix is not None:
            close()
            kind = matched_prefix[:-1]
            rest = raw[len(matched_prefix):]
            if kind in ("similar", "suppress", "from", "to", "keyword"):
                open_clause = (kind, [rest] if rest else [])
            elif kind == "fuse":
                _parse_fuse(parsed, rest)
            elif kind == "decay":
                try:
                    parsed.decay = float(rest) if rest else M.DEFAULT_DECAY_HALF_LIFE
                except ValueError as e:
                    raise GrammarError(f"decay: expects a number, got {rest!r}") from e
                if parsed.decay <= 0:
                    raise GrammarError("decay: half-life must be positive")
            elif kind == "centroid":
                try:
                    parsed.centroid_ids = [int(x) for x in rest.split(",") if x]
                except ValueError as e:
                    raise GrammarError(
                        f"centroid: expects comma-separated ids, got {rest!r}"
                    ) from e
                if not parsed.centroid_ids:
                    raise GrammarError("centroid: needs at least one id")
            elif kind == "pool":
                try:
                    parsed.pool = int(rest)
                except ValueError as e:
                    raise GrammarError(f"pool: expects an integer, got {rest!r}") from e
                if parsed.pool <= 0:
                    raise GrammarError("pool: must be positive")
            elif kind == "cluster":
                try:
                    parsed.cluster = int(rest)
                except ValueError as e:
                    raise GrammarError(f"cluster: expects an integer, got {rest!r}") from e
                if parsed.cluster <= 0:
                    raise GrammarError("cluster: must be positive")
        elif raw in _KEYWORDS:
            close()
            if raw == "diverse":
                parsed.diverse = True
            elif raw == "central":
                parsed.central = True
        else:
            if open_clause is None:
                # Bare words before any prefix token belong to similar:
                # (agent convenience: 'vec_ops(\'auth tokens diverse\')').
                open_clause = ("similar", [raw])
            else:
                open_clause[1].append(raw)
    close()

    if (parsed.from_text is None) != (parsed.to_text is None):
        raise GrammarError("from:/to: must be used together")
    if parsed.fuse_mode is not None and parsed.keyword is None:
        raise GrammarError("fuse: requires a keyword: clause")
    if parsed.keyword is not None and parsed.fuse_mode is None:
        parsed.fuse_mode = "weighted"  # keyword: alone -> default fusion
    if parsed.fuse_mode == "rrf" and parsed.diverse:
        raise GrammarError(
            "diverse cannot combine with fuse:rrf (MMR needs fused scores "
            "before selection; use fuse:weighted instead)"
        )
    if (
        parsed.similar is None
        and parsed.from_text is None
        and parsed.centroid_ids is None
        and parsed.keyword is None
    ):
        raise GrammarError(
            "query needs at least one of similar:, from:/to:, centroid:, "
            "or keyword:"
        )
    return parsed


def _parse_fuse(parsed: ParsedTokens, rest: str) -> None:
    """Parse ``fuse:weighted[,W]`` / ``fuse:rrf[,K]`` / ``fuse:filter[,W]``
    into ``parsed``.  ``filter`` makes the lexical hit set a hard Phase-1
    candidate set; its default weight is 1.0 (pure-vector ranking within
    the hits) rather than the blended default."""
    parts = rest.split(",") if rest else [""]
    mode = parts[0]
    if mode not in ("weighted", "rrf", "filter"):
        raise GrammarError(
            f"fuse: expects 'weighted[,W]', 'rrf[,K]' or 'filter[,W]', "
            f"got {rest!r}"
        )
    parsed.fuse_mode = mode
    if mode == "filter":
        parsed.fuse_weight = 1.0
    if len(parts) > 2:
        raise GrammarError(f"fuse: too many parameters in {rest!r}")
    if len(parts) == 2:
        param = parts[1]
        if mode in ("weighted", "filter"):
            try:
                parsed.fuse_weight = float(param)
            except ValueError as e:
                raise GrammarError(
                    f"fuse:{mode} expects a number, got {param!r}"
                ) from e
            if not 0.0 <= parsed.fuse_weight <= 1.0:
                raise GrammarError(
                    f"fuse:{mode} weight must be in [0, 1], got "
                    f"{parsed.fuse_weight}"
                )
        else:
            try:
                parsed.fuse_k = int(param)
            except ValueError as e:
                raise GrammarError(
                    f"fuse:rrf expects an integer, got {param!r}"
                ) from e
            if parsed.fuse_k <= 0:
                raise GrammarError("fuse:rrf constant must be positive")


def build_plan(
    parsed: ParsedTokens,
    embed: EmbedFn,
    resolve_ids: Optional[ResolveIdsFn] = None,
    lexical_fn: Optional[LexicalFn] = None,
) -> M.ModulationPlan:
    """Bind a :class:`ParsedTokens` to an embedder -> executable plan.

    ``lexical_fn`` resolves a ``keyword:`` clause to BM25 hits at build
    time (symmetric with ``resolve_ids`` for ``centroid:``); it receives
    the parsed ``pool:`` width so the lexical stage is never silently
    truncated below the requested candidate pool.
    """
    d = None
    if parsed.similar is not None:
        query = M.l2_normalize(np.asarray(embed(parsed.similar), dtype=np.float32))
        d = query.shape[-1]
    else:
        # Pure-trajectory / pure-centroid query: zero base query vector.
        probe = embed(parsed.from_text or "")
        d = np.asarray(probe).shape[-1]
        query = np.zeros(d, dtype=np.float32)

    centroid = None
    if parsed.centroid_ids is not None:
        if resolve_ids is None:
            raise GrammarError("centroid: requires an id resolver")
        examples = np.asarray(resolve_ids(parsed.centroid_ids), dtype=np.float32)
        if examples.ndim != 2 or examples.shape[0] == 0:
            raise GrammarError("centroid: ids resolved to no embeddings")
        centroid = M.CentroidSpec(examples=examples)

    trajectory = None
    if parsed.from_text is not None:
        a = M.l2_normalize(np.asarray(embed(parsed.from_text), dtype=np.float32))
        b = M.l2_normalize(np.asarray(embed(parsed.to_text), dtype=np.float32))
        trajectory = M.TrajectorySpec(direction=b - a)

    suppress = tuple(
        M.SuppressSpec(
            direction=M.l2_normalize(np.asarray(embed(text), dtype=np.float32))
        )
        for text in parsed.suppress
    )

    decay = M.DecaySpec(half_life_days=parsed.decay) if parsed.decay is not None else None
    diverse = M.DiverseSpec() if parsed.diverse else None

    fusion = None
    lexical = None
    if parsed.keyword is not None:
        if lexical_fn is None:
            raise GrammarError(
                "keyword: requires a lexical (FTS) resolver — query through "
                "the materializer / RetrievalService, or pass lexical_fn"
            )
        fusion = M.FusionSpec(
            mode=parsed.fuse_mode or "weighted",
            weight=parsed.fuse_weight,
            rrf_k=parsed.fuse_k,
        )
        # one FTS pool per keyword: clause; multi-clause plans dedup
        # overlapping hits and CombSUM-combine instead of concatenating
        tokens = parsed.keywords or [parsed.keyword]
        if len(tokens) == 1:
            lex_ids, lex_scores = lexical_fn(tokens[0], parsed.pool)
        else:
            lex_ids, lex_scores = M.combine_lexical_pools(
                [lexical_fn(t, parsed.pool) for t in tokens], parsed.pool)
        lexical = M.LexicalHits(
            ids=np.asarray(lex_ids, dtype=np.int64),
            scores=np.asarray(lex_scores, dtype=np.float32),
        )

    return M.ModulationPlan(
        query=query,
        centroid=centroid,
        trajectory=trajectory,
        decay=decay,
        suppress=suppress,
        diverse=diverse,
        pool=parsed.pool,
        cluster=parsed.cluster,
        central=parsed.central,
        keyword=parsed.keyword,
        fusion=fusion,
        lexical=lexical,
    )


def parse(
    token_string: str,
    embed: EmbedFn,
    resolve_ids: Optional[ResolveIdsFn] = None,
    lexical_fn: Optional[LexicalFn] = None,
) -> M.ModulationPlan:
    """tokenize + build_plan in one call (the VectorCache entry point)."""
    return build_plan(tokenize(token_string), embed, resolve_ids, lexical_fn)
