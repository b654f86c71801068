"""The port's Phase-2 serving slice against the reference package, end to end.

The reference ``RetrievalService(engine="jit-jax")`` and the port's
``RetrievalService`` on ``HopperBackend("cpu")`` (the kernels' plain
versions) serve the same seeded corpus, ``generate_corpus(2000, seed=0)``,
each built through its own package.  The corpus and the ``HashEmbedder``
vectors must be bit-identical; the paper's composed query through the SQL
endpoint and a mixed request set through the batched engine must rank the
same ids, scores within 1e-5 (f32 products summed in another order).
"""

import sqlite3

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.corpus import build_database as r_build  # noqa: E402
from repro.data.corpus import generate_corpus as r_generate  # noqa: E402
from repro.embed import HashEmbedder as RHash  # noqa: E402
from repro.serve.engine import BatchedRetrievalEngine as REngine  # noqa: E402
from repro.serve.retrieval import RetrievalService as RService  # noqa: E402
from repro_torch.core.backends import HopperBackend  # noqa: E402
from repro_torch.data.corpus import build_database as t_build  # noqa: E402
from repro_torch.data.corpus import generate_corpus as t_generate  # noqa: E402
from repro_torch.embed import HashEmbedder as THash  # noqa: E402
from repro_torch.serve.engine import BatchedRetrievalEngine as TEngine  # noqa: E402
from repro_torch.serve.retrieval import RetrievalService as TService  # noqa: E402

NOW = 1_770_000_000.0
N = 2000
TOKENS = ("similar:how the system works architecture "
          "suppress:website landing page design "
          "from:prototype sketch to:production deployment "
          "decay:30 diverse pool:500")
REQUESTS = [
    "similar:server lifecycle diverse decay:30",
    "similar:auth token suppress:website design",
    "similar:rendering pipeline from:sketch to:production",
    "similar:database migration decay:14 diverse pool:50",
    "similar:identity provenance",
    "similar:how the system works decay:30",
]


@pytest.fixture(scope="module")
def services():
    """Both services over the same corpus, each built by its own package."""
    r_chunks = r_generate(n_chunks=N, n_sessions=N // 50, seed=0, now=NOW)
    t_chunks = t_generate(n_chunks=N, n_sessions=N // 50, seed=0, now=NOW)
    r_conn = sqlite3.connect(":memory:", check_same_thread=False)
    t_conn = sqlite3.connect(":memory:", check_same_thread=False)
    r_mat = r_build(r_conn, r_chunks, RHash(128))
    t_mat = t_build(t_conn, t_chunks, THash(128))
    r_svc = RService(r_conn, dim=128, embedder=RHash(128), now=NOW,
                     engine="jit-jax")
    t_svc = TService(t_conn, dim=128, embedder=THash(128), now=NOW,
                     engine=HopperBackend("cpu"))
    yield {"r_chunks": r_chunks, "t_chunks": t_chunks, "r_mat": r_mat,
           "t_mat": t_mat, "r": r_svc, "t": t_svc}
    r_svc.close()
    t_svc.close()


def _same_ranking(got, want):
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               atol=1e-5)


def test_corpus_and_embedder_are_bit_identical(services):
    assert [c.row() for c in services["t_chunks"]] == \
        [c.row() for c in services["r_chunks"]]
    assert services["t_mat"].dtype == services["r_mat"].dtype
    np.testing.assert_array_equal(services["t_mat"], services["r_mat"])
    for text in ("how the system works", "", "auth token flow 42"):
        np.testing.assert_array_equal(THash(128)(text), RHash(128)(text))
        np.testing.assert_array_equal(THash(64)(text), RHash(64)(text))


@pytest.mark.parametrize("limit", [10, 500])
def test_composed_sql_query_matches(services, limit):
    sql = (f"SELECT v.id, v.score FROM vec_ops('{TOKENS}') v "
           f"ORDER BY v.score DESC LIMIT {limit}")
    got = services["t"].flex_search(sql)
    want = services["r"].flex_search(sql)
    assert got.ok and want.ok, (got.error, want.error)
    assert got.columns == want.columns
    _same_ranking(got.rows, want.rows)


def test_direct_search_matches(services):
    for tokens in REQUESTS + [TOKENS]:
        _same_ranking(services["t"].search(tokens, 20),
                      services["r"].search(tokens, 20))


def test_batched_engine_matches(services):
    """The batched engine folds the requests into shared device passes;
    rankings equal the reference engine's and the port's direct path."""
    t_eng = TEngine(services["t"].cache, max_batch=8, now=NOW,
                    engine=services["t"].engine)
    r_eng = REngine(services["r"].cache, max_batch=8, now=NOW,
                    engine=services["r"].engine)
    try:
        got = [t_eng.search(q, 10) for q in REQUESTS]
        want = [r_eng.search(q, 10) for q in REQUESTS]
    finally:
        t_eng.close()
        r_eng.close()
    for q, g, w in zip(REQUESTS, got, want):
        _same_ranking(g, w)
        _same_ranking(g, services["t"].search(q, 10))
    assert t_eng.stats()["batches_served"] >= 1
    assert services["t"].cache.fused.host_pool_transfers == 0


def test_sql_errors_come_back_explicit(services):
    res = services["t"].flex_search(
        "SELECT v.id FROM vec_ops('similar:x decay:zzz') v")
    assert not res.ok and "MaterializeError" in res.error


def test_shard_group_waits_for_its_slice(services):
    with pytest.raises(NotImplementedError, match="procgroup"):
        services["t"].shard_group(4)
