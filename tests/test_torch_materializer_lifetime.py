"""The port's SQL endpoint: how long a retrieval result table lives, and
what the statement reads in a pseudo-call's place, on the CPU.

1. ``Materializer.execute`` drops every result table its rewrite made,
   once the statement has returned or failed (a failing second
   pseudo-call and a failed read-only check included), so
   ``RetrievalService.stats()["sql"]`` reads ``temp_tables_dropped ==
   temp_tables`` and ``sqlite_temp_master`` holds no result table;
2. a ``vec_ops`` / ``HYBRID_SEARCH`` / ``VECTOR_SEARCH`` table holds only
   the search's own columns, and the statement joins ``snippet`` (a
   content prefix of ``_raw_chunks``) only where it reads it: the columns
   and rows, snippets included, are the reference's on the same store;
3. the benchmark's statement, which reads no snippet, plans no read of
   ``_raw_chunks``.
"""

import pytest

pytest.importorskip("torch")

from torch_harness import (PACKAGES, T, database, engine,  # noqa: E402
                           same_rows)

NOW = 1_770_000_000.0
# the shape of the benchmark's composed statement (perfbench's
# sql_composed traffic), at this corpus's pool
CELL = ("SELECT v.id, v.score FROM vec_ops('similar:server lifecycle "
        "suppress:landing page from:prototype to:deployment decay:{h} "
        "diverse pool:40') v LIMIT 10")


def _service(P, key="hopper"):
    conn, emb = database(P, 600, 30, 7, 64)
    return P.R.RetrievalService(conn, dim=64, embedder=emb, now=NOW,
                                engine=engine(P, key))


@pytest.fixture(scope="module")
def svc():
    s = _service(T)
    yield s
    s.close()


def _tables(conn):
    return [r[0] for r in conn.execute(
        "SELECT name FROM sqlite_temp_master WHERE type = 'table'")]


def _made_and_dropped(svc):
    sql = svc.stats()["sql"]
    return sql["temp_tables"], sql["temp_tables_dropped"]


def test_many_composed_statements_keep_no_table(svc):
    made0, dropped0 = _made_and_dropped(svc)
    for i in range(40):
        res = svc.flex_search(CELL.format(h=(7, 14, 30, 90)[i % 4]))
        assert res.ok, res.error
        ids = [r[0] for r in res.rows]
        assert len(ids) == 10 and ids == sorted(ids)
    made, dropped = _made_and_dropped(svc)
    assert made - made0 == 40
    assert dropped == made and dropped - dropped0 == 40
    assert _tables(svc.conn) == []


# (statement, result tables it makes before it fails, the error's type)
FAILING = [
    # fails in SQLite after its rewrite
    ("SELECT v.nope FROM vec_ops('similar:server') v", 1, "MaterializeError"),
    # fails in SQLite part-way through its rows
    ("SELECT v.id, abs(-9223372036854775807 - (v.id > {mid})) "
     "FROM vec_ops('similar:server pool:40') v", 1, "OperationalError"),
    # a two-vec_ops join whose statement fails after both tables exist
    ("SELECT a.nope FROM vec_ops('similar:alpha') a "
     "JOIN vec_ops('similar:beta') b ON a.id = b.id", 2, "MaterializeError"),
    # the second pseudo-call raises after the first made its table
    ("SELECT a.id FROM vec_ops('similar:alpha') a "
     "JOIN vec_ops('decay:zzz') b ON a.id = b.id", 1, "MaterializeError"),
    ("SELECT a.id FROM keyword('server') a "
     "JOIN VECTOR_SEARCH('') b ON a.id = b.id", 1, "MaterializeError"),
    # the read-only check refuses the rewritten statement
    ("DELETE FROM _raw_chunks WHERE id IN "
     "(SELECT id FROM vec_ops('similar:server'))", 1, "MaterializeError"),
]


@pytest.mark.parametrize("sql,n,error", FAILING)
def test_a_failed_statement_drops_what_its_rewrite_made(svc, sql, n, error):
    if "{mid}" in sql:
        ids = [r[0] for r in svc.flex_search(
            "SELECT v.id FROM vec_ops('similar:server pool:40') v").rows]
        sql = sql.format(mid=ids[len(ids) // 2])
    made0, dropped0 = _made_and_dropped(svc)
    res = svc.flex_search(sql)
    assert not res.ok and res.error.startswith(error + ":"), res.error
    made, dropped = _made_and_dropped(svc)
    assert (made - made0, dropped - dropped0) == (n, n)
    assert _tables(svc.conn) == []
    assert svc.conn.execute("SELECT count(*) FROM _raw_chunks").fetchone()[0]


# (statement, result tables it makes)
SERVED = [
    ("SELECT a.id FROM vec_ops('similar:alpha') a "
     "JOIN vec_ops('similar:beta') b ON a.id = b.id", 2),
    ("SELECT id, score, snippet FROM keyword('server') LIMIT 5", 1),
    ("SELECT * FROM HYBRID_SEARCH('server restart', 0.6)", 1),
    ("SELECT * FROM vec_ops('similar:server cluster:3 central pool:30')", 1),
    # a prefilter with no rows: the empty result table
    ("SELECT * FROM vec_ops('similar:server', "
     "'SELECT id FROM chunks WHERE type = ''nope''')", 1),
]


@pytest.mark.parametrize("sql,n", SERVED)
def test_a_served_statement_drops_its_tables(svc, sql, n):
    made0, dropped0 = _made_and_dropped(svc)
    res = svc.flex_search(sql)
    assert res.ok, res.error
    made, dropped = _made_and_dropped(svc)
    assert (made - made0, dropped - dropped0) == (n, n)
    assert _tables(svc.conn) == []


def test_a_bare_rewrite_leaves_its_table_to_the_caller(svc):
    mz = T.MZ.Materializer(svc.conn, svc.cache, now=NOW, engine=svc.engine)
    rewritten = mz.rewrite(CELL.format(h=30))
    (table,) = _tables(svc.conn)
    assert (mz.temp_tables, mz.temp_tables_dropped) == (1, 0)
    assert len(svc.conn.execute(rewritten).fetchall()) == 10
    svc.conn.execute(f"DROP TABLE {table}")


# -- the result contract against the reference --------------------------------

CONTRACT = [
    "SELECT v.id, v.score, v.snippet FROM vec_ops("
    "'similar:server lifecycle pool:30') v",
    "SELECT * FROM vec_ops('similar:server lifecycle decay:14 pool:30')",
    "SELECT * FROM vec_ops('similar:server cluster:3 central pool:30') v",
    "SELECT * FROM HYBRID_SEARCH('server restart', 0.6)",
    "SELECT v.id, v.score, v.snippet FROM HYBRID_SEARCH('server') v",
    "SELECT * FROM VECTOR_SEARCH('server restart')",
    "SELECT v.snippet, v.id FROM VECTOR_SEARCH('server') v "
    "WHERE v.snippet LIKE '%e%' ORDER BY v.score DESC LIMIT 7",
    "SELECT * FROM vec_ops('similar:server', "
    "'SELECT id FROM chunks WHERE type = ''nope''')",
    CELL.format(h=30),
]


@pytest.fixture(scope="module", params=["fused", "hopper"])
def pair(request):
    out = {P.name: _service(P, request.param) for P in PACKAGES}
    yield out
    for s in out.values():
        s.close()


@pytest.mark.parametrize("sql", CONTRACT)
def test_columns_and_rows_are_the_references(pair, sql):
    r, t = (pair[n].flex_search(sql) for n in ("repro", "repro_torch"))
    assert r.ok and t.ok, (r.error, t.error)
    assert t.columns == r.columns
    if "*" in sql:
        assert t.columns[:3] == ["id", "score", "snippet"]
    same_rows(t.rows, r.rows)


def test_a_snippet_is_the_content_prefix_of_its_row(svc):
    res = svc.flex_search(
        "SELECT v.id, v.snippet FROM vec_ops('similar:server pool:60') v")
    assert res.ok and len(res.rows) == 60
    for cid, snippet in res.rows:
        (content,) = svc.conn.execute(
            "SELECT content FROM _raw_chunks WHERE id = ?", (cid,)
        ).fetchone()
        assert snippet == content[:96]


def _plan(svc, sql):
    mz = T.MZ.Materializer(svc.conn, svc.cache, now=NOW, engine=svc.engine)
    rewritten = mz.rewrite(sql)
    try:
        return [r[-1] for r in svc.conn.execute(
            "EXPLAIN QUERY PLAN " + rewritten)]
    finally:
        for table in _tables(svc.conn):
            svc.conn.execute(f"DROP TABLE {table}")


def test_the_benchmark_statement_plans_no_read_of_the_content(svc):
    plan = _plan(svc, CELL.format(h=30))
    assert plan and not [d for d in plan if " c " in f"{d} "], plan
    # the same statement reading the snippet searches the content by id
    plan = _plan(svc, CELL.format(h=30).replace("v.score", "v.snippet"))
    assert any(d.startswith("SEARCH c ") for d in plan), plan
