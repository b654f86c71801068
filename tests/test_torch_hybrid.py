"""Hybrid lexical+vector retrieval (the fusion stage): the port against the
reference, on the CPU.

The reference's invariants (``tests/test_hybrid.py``), each held here as
equality between ``repro`` and ``repro_torch`` on the same seeded corpus,
the same stub BM25 hits and the same SQL, on every pair of backends that
``tests/torch_harness.py`` names:

1. ``fuse:weighted,1.0`` is bit-identical to the unfused ranking in the
   port (ids and float scores), and that ranking equals the reference's;
2. ``fuse:weighted,w``, ``fuse:rrf,K`` and ``fuse:filter[,w]`` rank the
   ids the reference ranks, scores within 1e-5;
3. ``keyword:``/``fuse:`` parse to the same fields, and the same malformed
   specs raise ``GrammarError`` in both;
4. the lexical resolver receives the plan's pool width;
5. ``keyword()``/``vec_ops()``/``HYBRID_SEARCH()``/``VECTOR_SEARCH()`` give
   the reference's rows, FTS5 special characters included;
6. the sync facade ranks the same with and without the batched engine.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_harness import (ENGINES, NOW, PACKAGES, R, T, corpus,  # noqa: E402
                           database, engine, same_ranking, same_rows,
                           store_from_splits)

SEGMENTATIONS = {"mono": [230], "two": [100, 130], "three": [80, 80, 70]}
TOMBSTONES = {"live": (), "tombs": (3, 104, 171)}
LEX_IDS = [7, 12, 55, 102, 168, 229, 3]  # 3 is tombstoned in some stores
LEX_SCORES = [1.0, 0.9, 0.7, 0.5, 0.3, 0.2, 0.1]
TOKENS = ("similar:how the retrieval system works decay:14 "
          "suppress:website landing page pool:40")


def _lexical(ids=LEX_IDS, scores=LEX_SCORES):
    """A lexical resolver returning fixed BM25-style hits (minmaxed)."""
    def fn(text, pool):
        return (np.asarray(ids[:pool], dtype=np.int64),
                np.asarray(scores[:pool], dtype=np.float32))
    return fn


def _vc(P, splits=(100, 130), deleted=(3, 104), lexical=None):
    mat, ts = corpus(seed=5)
    return P.V.VectorCache(store=store_from_splits(P, mat, ts, splits,
                                                   deleted),
                           embed_fn=P.Hash(32),
                           lexical_fn=lexical or _lexical())


@pytest.mark.parametrize("key", ENGINES)
@pytest.mark.parametrize("seg", SEGMENTATIONS)
@pytest.mark.parametrize("tombs", TOMBSTONES)
def test_weighted_one_is_the_unfused_ranking(key, seg, tombs):
    out = {}
    for P in PACKAGES:
        vc = _vc(P, SEGMENTATIONS[seg], TOMBSTONES[tombs])
        be = engine(P, key)
        out[P.name] = (vc.search(TOKENS, now=NOW, engine=be),
                       vc.search(TOKENS + " keyword:server fuse:weighted,1.0",
                                 now=NOW, engine=be))
    base, fused = out["repro_torch"]
    assert base == fused  # bit-identical: w = 1.0 multiplies nothing
    same_ranking(base, out["repro"][0])


def test_weighted_one_plan_contributes_no_bias():
    for P in PACKAGES:
        plan = P.G.parse(TOKENS + " keyword:x fuse:weighted,1.0",
                         P.Hash(32), lexical_fn=_lexical())
        assert plan.fusion is not None
        assert P.B.plan_fusion_bias(plan) is None
        store = _vc(P, [230], ()).store
        assert P.B.fusion_bias_arrays(store, store.segments, [plan]) is None


FUSIONS = ["weighted,0.6", "weighted,0.3", "weighted,0.0", "rrf,30",
           "rrf,60", "filter", "filter,0.5"]


@pytest.mark.parametrize("key", ENGINES)
@pytest.mark.parametrize("fuse", FUSIONS)
def test_fusion_matches_reference(key, fuse):
    """Weighted (a bias on the device panel), RRF (fused on the host after
    the pure-vector pass) and filter (the hit set as a Phase-1 filter)."""
    out = {}
    for P in PACKAGES:
        out[P.name] = _vc(P).search(TOKENS + f" keyword:server fuse:{fuse}",
                                    now=NOW, engine=engine(P, key))
    assert out["repro_torch"]
    assert 3 not in {i for i, _ in out["repro_torch"]}  # tombstone stays
    same_ranking(out["repro_torch"], out["repro"])


@pytest.mark.parametrize("key", ["fused", "hopper"])
def test_rrf_and_weighted_respect_a_candidate_filter(key):
    cands = list(range(0, 230, 2))
    for fuse in ("rrf", "weighted,0.5"):
        out = {}
        for P in PACKAGES:
            out[P.name] = _vc(P, [230], ()).search(
                TOKENS + f" keyword:server fuse:{fuse}", cands, now=NOW,
                engine=engine(P, key))
        assert out["repro_torch"]
        assert all(i % 2 == 0 for i, _ in out["repro_torch"])
        same_ranking(out["repro_torch"], out["repro"])


@pytest.mark.parametrize("key", ["fused", "hopper"])
def test_fuse_filter_on_no_hits_and_a_broad_hit_set(key):
    """No hits rank nothing; a broad hit set (52% of the rows) takes the
    masked arm of the router in both packages."""
    broad = _lexical(list(range(120)),
                     np.linspace(1.0, 0.1, 120).astype(np.float32))
    out = {}
    for P in PACKAGES:
        empty = _vc(P, [230], (), lexical=_lexical([], [])).search(
            "similar:x keyword:zzz fuse:filter", now=NOW,
            engine=engine(P, key))
        vc = _vc(P, [230], (), lexical=broad)
        vc.prefilter = P.B.PrefilterRouter()
        got = vc.search(TOKENS.replace("pool:40", "pool:200")
                        + " keyword:server fuse:filter", now=NOW,
                        engine=engine(P, key))
        out[P.name] = (empty, got, vc.prefilter.routed_masked,
                       vc.prefilter.routed_gather)
    assert out["repro_torch"][0] == out["repro"][0] == []
    same_ranking(out["repro_torch"][1], out["repro"][1])
    assert out["repro_torch"][2:] == out["repro"][2:] == (1, 0)


GRAMMAR = [
    "keyword:server lifecycle keyword:restart similar:x",
    "keyword:server",
    "keyword:x fuse:weighted,0.25",
    "keyword:x fuse:rrf,17",
    "similar:x keyword:y fuse:filter",
    "similar:x keyword:y fuse:filter,0.7",
    "similar:x keyword:alpha beta keyword:gamma fuse:rrf pool:40",
    "keyword:x fuse:weighted,1.5",
    "keyword:x fuse:weighted,nope",
    "keyword:x fuse:rrf,0",
    "keyword:x fuse:median",
    "keyword:x fuse:weighted,0.5,9",
    "similar:x fuse:weighted,0.5",
    "similar:x keyword:y fuse:rrf diverse",
    "similar:x keyword:y fuse:filter,1.5",
    "similar:x keyword:y fuse:filter,nope",
]


def _tokenized(P, text):
    try:
        p = P.G.tokenize(text)
    except P.G.GrammarError as e:
        return ("GrammarError", str(e))
    return tuple(getattr(p, f) for f in (
        "similar", "keyword", "keywords", "fuse_mode", "fuse_weight",
        "fuse_k", "pool"))


@pytest.mark.parametrize("text", GRAMMAR)
def test_keyword_and_fuse_grammar_match_reference(text):
    assert _tokenized(T, text) == _tokenized(R, text)


def test_keyword_without_a_resolver_raises_in_both():
    for P in PACKAGES:
        with pytest.raises(P.G.GrammarError):
            P.G.parse("similar:x keyword:y", P.Hash(32))


def test_keyword_anchor_and_pool_width_reach_the_resolver():
    out = {}
    for P in PACKAGES:
        seen = []

        def spy(text, pool):
            seen.append((text, pool))
            return np.asarray([1, 4], np.int64), np.asarray([1.0, 0.5],
                                                            np.float32)

        P.G.parse("similar:x keyword:server restart pool:700", P.Hash(32),
                  lexical_fn=spy)
        P.G.parse("similar:x keyword:alpha keyword:beta fuse:weighted,0.5 "
                  "pool:40", P.Hash(32), None, spy)
        plan = P.G.build_plan(P.G.tokenize("keyword:server"), P.Hash(32),
                              lexical_fn=spy)
        out[P.name] = (seen, plan.query.any(), list(plan.lexical.ids),
                       plan.lexical.scores.tolist())
    assert out["repro_torch"] == out["repro"]
    assert out["repro_torch"][0][0] == ("server restart", 700)


def test_multi_keyword_pools_combine_like_the_reference():
    pools = [(np.array([1, 2, 3]), np.array([1.0, 0.5, 0.25], np.float32)),
             (np.array([3, 4]), np.array([1.0, 0.5], np.float32))]
    for width in (10, 2):
        r_ids, r_scores = R.M.combine_lexical_pools(pools, width)
        t_ids, t_scores = T.M.combine_lexical_pools(pools, width)
        np.testing.assert_array_equal(t_ids, r_ids)
        np.testing.assert_array_equal(t_scores, r_scores)

    def lex(term, pool):
        if term == "server":
            return (np.asarray(LEX_IDS, np.int64),
                    np.asarray(LEX_SCORES, np.float32))
        return np.array([12, 77], np.int64), np.array([1.0, 0.8], np.float32)

    out = {}
    for P in PACKAGES:
        out[P.name] = _vc(P, [230], (), lexical=lex).search(
            TOKENS + " keyword:server keyword:restart fuse:weighted,0.4",
            now=NOW, engine=engine(P, "hopper"))
    same_ranking(out["repro_torch"], out["repro"])


def test_filter_candidate_ids_match_reference():
    for cands in (None, [12, 999, 7], [999], [1, 2, 3]):
        got = {}
        for P in PACKAGES:
            f = P.G.parse("similar:x keyword:k fuse:filter", P.Hash(32),
                          lexical_fn=_lexical())
            w = P.G.parse("similar:x keyword:k fuse:weighted,0.5",
                          P.Hash(32), lexical_fn=_lexical())
            got[P.name] = [None if o is None else list(o) for o in (
                P.M.filter_candidate_ids(f, cands),
                P.M.filter_candidate_ids(w, cands))]
        assert got["repro_torch"] == got["repro"]


# -- the SQL surface -----------------------------------------------------------

SQL = [
    "SELECT id, score, snippet FROM keyword('server') LIMIT 5",
    "SELECT id, score, snippet FROM vec_ops('similar:server') LIMIT 5",
    "SELECT id, score, snippet FROM HYBRID_SEARCH('server') LIMIT 5",
    "SELECT id, score, snippet FROM VECTOR_SEARCH('server') LIMIT 5",
    "SELECT id FROM HYBRID_SEARCH('server restart', 0.6) "
    "ORDER BY score DESC LIMIT 5",
    "SELECT id FROM hybrid_search('server restart', 0.6) "
    "ORDER BY score DESC LIMIT 5",
    "SELECT id, score FROM HYBRID_SEARCH('server restart', 0.5) "
    "ORDER BY score DESC LIMIT 10",
    "SELECT id, score FROM HYBRID_SEARCH('server restart', 0.7) "
    "ORDER BY score DESC LIMIT 10",
    "SELECT id FROM HYBRID_SEARCH('x', 1.5)",
    "SELECT id FROM HYBRID_SEARCH('x', 'not_a_number')",
    "SELECT id FROM HYBRID_SEARCH('server.lifecycle') LIMIT 5",
    "SELECT id, score FROM keyword('server-lifecycle \"restart\"') LIMIT 5",
    "SELECT id, score FROM HYBRID_SEARCH('auth (token)', 0.4) LIMIT 5",
    "SELECT id, score FROM vec_ops("
    "'similar:server lifecycle keyword:restart fuse:weighted,0.7 pool:30')"
    " ORDER BY score DESC",
    "SELECT id, score FROM vec_ops("
    "'similar:server lifecycle keyword:restart fuse:rrf,60 pool:30')"
    " ORDER BY score DESC",
    "SELECT v.id, v.score FROM vec_ops("
    "'similar:server lifecycle keyword:restart fuse:weighted,0.5',"
    "'SELECT id FROM chunks WHERE type = ''assistant''') v "
    "ORDER BY v.score DESC LIMIT 8",
]


@pytest.fixture(scope="module", params=["fused", "hopper"])
def services(request):
    out = {}
    for P in PACKAGES:
        conn, emb = database(P, 600, 30, 7, 64)
        out[P.name] = P.R.RetrievalService(
            conn, dim=64, embedder=emb, now=1_770_000_000.0,
            engine=engine(P, request.param))
    yield out
    for svc in out.values():
        svc.close()


@pytest.mark.parametrize("sql", SQL)
def test_sql_surface_matches_reference(services, sql):
    r, t = (services[n].flex_search(sql) for n in ("repro", "repro_torch"))
    assert t.ok == r.ok, (t.error, r.error)
    if not r.ok:
        assert type(t.error) is type(r.error)
        return
    assert t.columns == r.columns
    assert t.rows
    same_rows(t.rows, r.rows)


def test_fts_query_honours_its_limit_like_the_reference():
    out = {}
    for P in PACKAGES:
        conn, _ = database(P, 600, 30, 7, 64)
        out[P.name] = [P.MZ.fts_query(conn, "server", limit=n)
                       for n in (3, 50)]
    assert [len(x) for x in out["repro_torch"]] == [3, len(out["repro"][1])]
    for g, w in zip(out["repro_torch"], out["repro"]):
        same_rows(g, w)


@pytest.mark.parametrize("key", ["fused", "hopper", "torch"])
def test_sync_facade_ranks_the_same_with_and_without_the_engine(key):
    tokens = "similar:server lifecycle keyword:restart fuse:weighted,0.6"
    rrf = "similar:server keyword:restart fuse:rrf,30"
    out = {}
    for P in PACKAGES:
        conn, emb = database(P, 600, 30, 7, 64)
        svc = P.R.RetrievalService(conn, dim=64, embedder=emb,
                                   now=1_770_000_000.0, engine=engine(P, key))
        try:
            direct = svc.search(tokens, k=8)
            rrf_direct = svc.cache.search(rrf, now=svc.now,
                                          engine=svc.engine)[:8]
            svc.serving(max_batch=8)
            out[P.name] = (direct, svc.search(tokens, k=8, priority=1),
                           rrf_direct, svc.search(rrf, k=8))
        finally:
            svc.close()
    direct, batched, rrf_direct, rrf_batched = out["repro_torch"]
    assert len(direct) == 8
    same_ranking(batched, direct, tol=2e-5)
    assert [i for i, _ in rrf_batched] == [i for i, _ in rrf_direct]
    for g, w in zip(out["repro_torch"], out["repro"]):
        same_ranking(g, w)


def test_finalize_fusion_is_a_no_op_for_weighted():
    for P in PACKAGES:
        plan = P.G.parse("similar:x keyword:y fuse:weighted,0.5", P.Hash(32),
                         lexical_fn=_lexical())
        results = [(1, 0.5), (2, 0.25)]
        assert P.B.finalize_fusion(plan, results, 2) is results
