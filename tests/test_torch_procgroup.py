"""The port's shard groups against the reference package's, on the CPU.

``repro_torch.dist.procgroup.ProcessGroup`` with ``"fused-numpy"``
workers runs the reference's numpy code path, so it must be
BIT-IDENTICAL to ``repro.dist.procgroup.ProcessGroup`` on the same rows —
ids and float scores, across the ``inline``, ``thread`` and ``process``
transports — under the contracts of ``tests/test_procgroup.py`` and
``tests/test_cohort.py``: cross-shard tie order, segmentations and
tombstones, candidate masks, ``fuse:rrf``, k truncation, replicas and
failover, and the cohort's one corpus stream.  Each package parses the
same token strings with its own, bit-identical ``HashEmbedder``.

Workers on ``HopperBackend("cpu")`` (the kernels' plain versions, spawned
for ``process``) rank exactly like the reference's on a corpus without
duplicate rows, scores within 1e-5; on the reference's own corpus, whose
texts repeat (identical rows), they equal the port's monolith exactly,
ties to the smallest row, where the reference's BLAS splits such ties by
a last-bit difference of its tail kernel.  The bf16 worker keeps the
reference's truncated ``pack_bf16`` codes bit for bit, and
``RetrievalService.shard_group`` routes, mirrors mutations and serves the
batched engine's fan-out.  (That a spawned worker imports neither JAX
nor the reference is pinned in tests/test_torch_isolation.py.)
"""

import concurrent.futures as cf
import dataclasses
import sqlite3
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import grammar as RG  # noqa: E402
from repro.core import modulations as RM  # noqa: E402
from repro.core.segments import pack_bf16 as r_pack_bf16  # noqa: E402
from repro.data.corpus import build_database as r_build  # noqa: E402
from repro.data.corpus import generate_corpus as r_generate  # noqa: E402
from repro.dist.procgroup import ProcessGroup as RGroup  # noqa: E402
from repro.embed import HashEmbedder as RHash  # noqa: E402
from repro.serve.retrieval import RetrievalService as RService  # noqa: E402
from repro_torch.core import grammar as TG  # noqa: E402
from repro_torch.core import modulations as TM  # noqa: E402
from repro_torch.core.backends import (HopperBackend,  # noqa: E402
                                       finalize_segment_candidates,
                                       score_select_segments)
from repro_torch.core.vectorcache import VectorCache as TCache  # noqa: E402
from repro_torch.data.corpus import build_database as t_build  # noqa: E402
from repro_torch.data.corpus import generate_corpus as t_generate  # noqa: E402
from repro_torch.dist.procgroup import ProcessGroup as TGroup  # noqa: E402
from repro_torch.dist.procgroup import ShardWorker  # noqa: E402
from repro_torch.embed import HashEmbedder as THash  # noqa: E402
from repro_torch.serve.retrieval import RetrievalService as TService  # noqa: E402

DIM = 64
NOW = 1_770_000_000.0
N = 480  # 3 shards x 160 rows, 160 % 4 == 0
TOL = 1e-5
TRANSPORTS = ["inline", "thread", "process"]


def _texts(n, offset=0):
    # i and i+407 share a text exactly -> identical rows -> exact score
    # ties in DIFFERENT shards (407 % 3 != 0)
    return [f"topic {(offset + i) % 37} filler {(offset + i) % 11}"
            for i in range(n)]


@pytest.fixture(scope="module")
def corpus():
    ids = np.arange(N, dtype=np.int64)
    matrix = THash(DIM).embed_batch(_texts(N))
    np.testing.assert_array_equal(matrix, RHash(DIM).embed_batch(_texts(N)))
    ts = np.linspace(NOW - 90 * 86400.0, NOW - 3600.0, N)
    return ids, matrix, ts


@pytest.fixture(scope="module")
def random_corpus():
    """Unit rows drawn at random: no two rows tie."""
    rng = np.random.default_rng(21)
    matrix = rng.standard_normal((N, DIM)).astype(np.float32)
    matrix /= np.linalg.norm(matrix, axis=1, keepdims=True)
    ts = NOW - rng.uniform(0, 90, N) * 86400.0
    return np.arange(N, dtype=np.int64), matrix, ts


def _lex(normalize):
    """Deterministic synthetic keyword resolver over ids 0..N-1."""
    def lex(term, limit):
        rng = np.random.default_rng(zlib.crc32(term.encode()))
        n = min(limit, 64)
        ids = rng.choice(N, size=n, replace=False).astype(np.int64)
        scores = np.sort(rng.random(n).astype(np.float32))[::-1]
        return ids, normalize(scores)
    return lex


R_LEX, T_LEX = _lex(RM.minmax_normalize), _lex(TM.minmax_normalize)


def _plans(tokens):
    """The same plan in both packages."""
    r = RG.parse(tokens, RHash(DIM), None, R_LEX)
    t = TG.parse(tokens, THash(DIM), None, T_LEX)
    return r, t


def _groups(corpus, **kw):
    ids, matrix, ts = corpus
    kw.setdefault("n_shards", 3)
    kw.setdefault("transport", "inline")
    engine = kw.pop("engine", "fused-numpy")
    t_kw = dict(kw, engine=engine)
    if engine == "hopper":
        t_kw["device"] = "cpu"
    return (RGroup.build(ids, matrix, ts, **kw),
            TGroup.build(ids, matrix, ts, **t_kw))


def _same_group_results(rg, tg, tokens, *args, **kw):
    r, t = _plans(tokens)
    want = rg.search_plan(r, *args, now=NOW, **kw)
    got = tg.search_plan(t, *args, now=NOW, **kw)
    assert got == want, f"mismatch for {tokens!r}"
    return got


TOKEN_SHAPES = [
    "similar:server lifecycle pool:60",
    "similar:session handling suppress:landing page pool:60",
    "similar:retry logic decay:21 pool:60",
    "similar:cache eviction suppress:website design decay:30 pool:64",
    "similar:error handling diverse pool:48",
    "similar:auth keyword:token fuse:weighted,0.6 pool:40",
    "similar:auth keyword:token fuse:rrf pool:40",
]


# -- numpy workers: bit-identical to the reference ---------------------------


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_group_matches_reference(corpus, transport):
    rg, tg = _groups(corpus, transport=transport)
    with rg, tg:
        for tokens in TOKEN_SHAPES:
            _same_group_results(rg, tg, tokens)
        # mutations cross every transport the same way
        assert rg.delete([0, 1, 2, 3, 407]) == tg.delete([0, 1, 2, 3, 407])
        _same_group_results(rg, tg, TOKEN_SHAPES[0])


@pytest.mark.parametrize("transport", ["inline", "thread"])
def test_group_segmentations_and_tombstones(corpus, transport):
    rg, tg = _groups(corpus, transport=transport)
    with rg, tg:
        for extra, off in ((96, 1000), (192, 2000)):
            eids = np.arange(off, off + extra, dtype=np.int64)
            emat = THash(DIM).embed_batch(_texts(extra, offset=off))
            ets = np.linspace(NOW - 40 * 86400.0, NOW - 7200.0, extra)
            rg.append(eids, emat, ets)
            tg.append(eids, emat, ets)
        dead = ([int(i) for i in range(0, 90, 5)]
                + [1000 + i for i in range(0, 40, 7)]
                + [2000 + i for i in range(0, 150, 11)])
        assert rg.delete(dead) == tg.delete(dead) == len(dead)
        assert tg.n_live == rg.n_live
        for tokens in TOKEN_SHAPES:
            _same_group_results(rg, tg, tokens)


def test_group_candidate_masks(corpus):
    rng = np.random.default_rng(7)
    rg, tg = _groups(corpus)
    with rg, tg:
        for frac in (0.5, 0.3):
            cand = [int(i) for i in rng.choice(N, size=int(N * frac),
                                               replace=False)]
            for tokens in TOKEN_SHAPES:
                _same_group_results(rg, tg, tokens, cand)
        assert _same_group_results(rg, tg, TOKEN_SHAPES[0], []) == []


@pytest.mark.parametrize("lam", [0.0, 0.3, 0.7, 1.0])
def test_group_diverse_lambda_sweep(corpus, lam):
    rg, tg = _groups(corpus)
    with rg, tg:
        r, t = _plans("similar:error handling diverse pool:48")
        r = dataclasses.replace(r, diverse=RM.DiverseSpec(lam=lam))
        t = dataclasses.replace(t, diverse=TM.DiverseSpec(lam=lam))
        assert tg.search_plan(t, now=NOW) == rg.search_plan(r, now=NOW)


def test_group_cross_shard_tie_order(corpus):
    rg, tg = _groups(corpus)
    with rg, tg:
        got = _same_group_results(rg, tg, f"similar:{_texts(1)[0]} pool:80")
        pos = {int(i): p for p, (i, _) in enumerate(got)}
        assert 0 in pos and 407 in pos and pos[0] < pos[407]


def test_group_fuse_filter_and_k_truncation(corpus):
    rg, tg = _groups(corpus)
    with rg, tg:
        for tokens in ("similar:auth keyword:token fuse:filter pool:40",
                       "similar:auth keyword:token fuse:filter,0.8 pool:40"):
            _same_group_results(rg, tg, tokens)
        full = _same_group_results(rg, tg, TOKEN_SHAPES[0])
        assert len(full) == 60
        assert _same_group_results(rg, tg, TOKEN_SHAPES[0], k=10) == full[:10]
        assert len(_same_group_results(rg, tg, TOKEN_SHAPES[0],
                                       k=10_000)) == N


@pytest.mark.parametrize("dtype", ["f32b", "bf16"])
@pytest.mark.parametrize("transport,n_shards",
                         [("inline", 1), ("inline", 3), ("thread", 3)])
def test_cohort_matches_reference_and_serial(corpus, dtype, transport,
                                             n_shards):
    shapes = TOKEN_SHAPES[:5]
    rg, tg = _groups(corpus, dtype=dtype, transport=transport,
                     n_shards=n_shards)
    with rg, tg:
        for q in (1, 4, 16):
            pairs = [_plans(shapes[i % len(shapes)]) for i in range(q)]
            r_plans = [p[0] for p in pairs]
            t_plans = [p[1] for p in pairs]
            cohort = tg.search_plan_batch(t_plans, [None] * q, now=NOW,
                                          ks=[20] * q)
            assert cohort == rg.search_plan_batch(
                r_plans, [None] * q, now=NOW, ks=[20] * q)
            assert cohort == [tg.search_plan(p, now=NOW, k=20)
                              for p in t_plans]


@pytest.mark.parametrize("engine", ["fused-numpy", "hopper"])
def test_cohort_streams_corpus_once(corpus, engine, monkeypatch):
    """Q = 16 plans: ONE corpus stream a shard (on the Hopper worker, one
    pem_score call a shard); 16 serial queries: 16."""
    from repro_torch.kernels.pem_score import ops

    calls = []
    real = ops.pem_score
    monkeypatch.setattr(ops, "pem_score",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, t_plans = zip(*[_plans(TOKEN_SHAPES[i % 5]) for i in range(16)])
    rg, tg = _groups(corpus, dtype="f32b", engine=engine)
    with rg, tg:
        tg.search_plan_batch(list(t_plans), [None] * 16, now=NOW,
                             ks=[10] * 16)
        rows = tg.stats()["shards"]
        assert [s["corpus_streams"] for s in rows] == [1, 1, 1]
        assert all(s["cohort_passes"] == 1 and s["cohort_plans"] == 16
                   for s in rows)
        assert len(calls) == (3 if engine == "hopper" else 0)
        for p in t_plans:
            tg.search_plan(p, now=NOW, k=10)
        assert [s["corpus_streams"] for s in tg.stats()["shards"]] == [17] * 3


def test_replicas_and_failover(corpus):
    """Replicas round-robin; a killed worker process fails over to its
    shard's survivor; an application error propagates and fails nothing
    over; a shard with no survivor raises."""
    ids, matrix, ts = corpus
    rg, tg = _groups(corpus, replicas=2, transport="process", n_shards=2)
    with rg, tg:
        want = _same_group_results(rg, tg, TOKEN_SHAPES[0])
        victim = tg._clients[0][0]
        victim._proc.kill()
        victim._proc.join(timeout=5.0)
        assert not victim._proc.is_alive()
        r, t = _plans(TOKEN_SHAPES[0])
        assert tg.search_plan(t, now=NOW) == want
        assert tg.search_plan(t, now=NOW) == want
        st = tg.stats()
        assert st["failovers"] >= 1 and st["dead_replicas"] == 1
        assert tg.delete([0, 1, 2, 3]) == rg.delete([0, 1, 2, 3]) == 4
        _same_group_results(rg, tg, TOKEN_SHAPES[0])
    with TGroup.build(ids[:64], matrix[:64], None, n_shards=2, replicas=2,
                      transport="process", engine="fused-numpy") as g:
        _, t = _plans("similar:x decay:14")  # decay without timestamps
        with pytest.raises(RuntimeError, match="decay"):
            g.search_plan(t, now=NOW)
        assert g.stats()["failovers"] == g.stats()["dead_replicas"] == 0
        victim = g._clients[1][0]
        victim._proc.kill()
        victim._proc.join(timeout=5.0)
        g._clients[1][1]._proc.kill()
        g._clients[1][1]._proc.join(timeout=5.0)
        _, t = _plans(TOKEN_SHAPES[0])
        with pytest.raises(RuntimeError, match="no surviving replicas"):
            g.search_plan(t, now=NOW)


def test_stats_ledger_and_row_skew(corpus):
    rg, tg = _groups(corpus)
    with rg, tg:
        _same_group_results(rg, tg, TOKEN_SHAPES[0])
        dead = [i for i, s in tg._shard_of.items() if s == 0][:100]
        rg.delete(dead)
        tg.delete(dead)
        want, got = rg.stats(), tg.stats()
        for key in ("n_shards", "replicas", "live", "rows", "searches",
                    "failovers", "dead_replicas", "row_skew",
                    "corpus_streams"):
            assert got[key] == want[key], key
        for g, w in zip(got["shards"], want["shards"]):
            for key in ("shard", "rows", "live", "matrix_bytes",
                        "codes_bytes", "scoring_bytes", "passes"):
                assert g[key] == w[key], key
            assert g["device"] == "host" and g["device_bytes"] == 0


# -- workers on the kernels' plain versions ------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "f32b", "bf16"])
@pytest.mark.parametrize("transport", TRANSPORTS)
def test_hopper_workers_rank_like_the_reference(random_corpus, dtype,
                                                transport):
    rg, tg = _groups(random_corpus, dtype=dtype, transport=transport,
                     engine="hopper")
    with rg, tg:
        for tokens in TOKEN_SHAPES:
            r, t = _plans(tokens)
            want = rg.search_plan(r, now=NOW)
            got = tg.search_plan(t, now=NOW)
            assert [i for i, _ in got] == [i for i, _ in want], tokens
            np.testing.assert_allclose([s for _, s in got],
                                       [s for _, s in want], atol=TOL)
        st = tg.stats()["shards"]
        assert all(s["device"] == "cpu" and s["device_bytes"] > 0
                   for s in st)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_hopper_workers_equal_the_port_monolith(corpus, n_shards):
    """Exact, on repeated rows too: the group's merge reproduces the
    monolithic pass over the same rows, diverse pools finished by the same
    host MMR oracle."""
    ids, matrix, ts = corpus
    _, tg = _groups(corpus, n_shards=n_shards, engine="hopper")
    vc = TCache(ids, matrix, ts, THash(DIM), lexical_fn=T_LEX)
    backend = HopperBackend("cpu")
    with tg:
        for tokens in TOKEN_SHAPES[:5]:
            _, plan = _plans(tokens)
            got = tg.search_plan(plan, now=NOW)
            segs = vc.store.segments
            sel = score_select_segments(backend, segs, [plan], [plan.pool],
                                        now=NOW, device_mmr=False)
            (want,) = finalize_segment_candidates(segs, [plan], [plan.pool],
                                                  sel)
            assert got == want, tokens


def test_bf16_worker_keeps_the_reference_codes(corpus):
    ids, matrix, ts = corpus
    w = ShardWorker(0, DIM, engine="hopper", device="cpu", dtype="bf16")
    w.append(ids, matrix, ts, normalized=True)
    w.delete([5, 6])
    _, plan = _plans("similar:server lifecycle decay:21")
    w.local_pass([plan], [10], NOW)
    codes, rows, _ = w._packed_view(w.store.segments)
    live = np.setdiff1d(ids, [5, 6])
    np.testing.assert_array_equal(codes, r_pack_bf16(matrix[live]))
    np.testing.assert_array_equal(rows, live)
    dev = w.backend._device_matrix(codes)
    assert dev.dtype == torch.bfloat16
    np.testing.assert_array_equal(dev.view(torch.int16).numpy()
                                  .view(np.uint16), codes)
    st = w.stats()
    assert st["codes_bytes"] == st["scoring_bytes"] == codes.nbytes
    assert st["device_bytes"] == codes.nbytes  # only the codes are resident


def test_hopper_group_defaults_to_the_card(corpus):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    ids, matrix, ts = corpus
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TGroup.build(ids, matrix, ts, n_shards=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardWorker(0, DIM)


# -- the service ---------------------------------------------------------------


@pytest.fixture()
def services():
    r_chunks = r_generate(n_chunks=N, n_sessions=24, seed=11)
    t_chunks = t_generate(n_chunks=N, n_sessions=24, seed=11)
    r_conn = sqlite3.connect(":memory:", check_same_thread=False)
    t_conn = sqlite3.connect(":memory:", check_same_thread=False)
    r_build(r_conn, r_chunks, RHash(DIM))
    t_build(t_conn, t_chunks, THash(DIM))
    r = RService(r_conn, dim=DIM, embedder=RHash(DIM), now=NOW)
    t = TService(t_conn, dim=DIM, embedder=THash(DIM), now=NOW,
                 engine=HopperBackend("cpu"))
    yield r, t
    r.close()
    t.close()


SVC_TOKENS = [
    "similar:server lifecycle pool:50",
    "similar:session handling suppress:landing page decay:30 pool:64",
    "similar:retry logic diverse pool:48",
    "similar:cache keyword:server fuse:rrf pool:40",
]


def _same_ids(got, want):
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               atol=TOL)


def test_service_shard_group_routes_and_mirrors(services):
    """The port's service on the CPU: shard workers where its engine runs
    (the plain versions), results equal to its own direct path and to the
    reference service's group; ingest and delete reach the group."""
    r_svc, t_svc = services
    direct = [t_svc.search(t, k=20) for t in SVC_TOKENS]
    g = t_svc.shard_group(n_shards=3, transport="inline")
    assert g is t_svc.shard_group()  # idempotent attach
    assert g.devices == ["cpu"] * 3
    r_svc.shard_group(n_shards=3, transport="inline")
    for t, want in zip(SVC_TOKENS, direct):
        got = t_svc.search(t, k=20)
        _same_ids(got, want)
        _same_ids(got, r_svc.search(t, k=20))
    rows = [(10_000 + i, f"s{i % 4}", "text",
             f"fresh server lifecycle note {i}", NOW - i * 3600.0,
             i, "proj", None, None, None) for i in range(48)]
    for svc in services:
        svc.ingest(rows)
        svc.delete(list(range(0, 96, 2)))
    assert g.n_live == t_svc.cache.store.n_live
    res = t_svc.search(SVC_TOKENS[0], k=20)
    _same_ids(res, r_svc.search(SVC_TOKENS[0], k=20))
    assert any(i >= 10_000 for i, _ in res)
    assert len(t_svc.stats()["shard_group"]["shards"]) == 3
    t_svc.close()
    assert t_svc._shard_group is None


def test_service_engine_fans_out_to_the_group(services):
    _, t_svc = services
    g = t_svc.shard_group(n_shards=3, transport="thread")
    direct = [t_svc.search(t, k=20) for t in SVC_TOKENS]
    eng = t_svc.serving(max_batch=8, max_wait_ms=4.0)
    assert eng.shard_group is g
    with cf.ThreadPoolExecutor(8) as ex:
        batched = list(ex.map(lambda t: t_svc.search(t, k=20),
                              SVC_TOKENS * 3))
    for got, want in zip(batched, direct * 3):
        assert [i for i, _ in got] == [i for i, _ in want]
    assert eng.batches_served < 12  # batching actually batched
    assert g.stats()["searches"] >= 1


@pytest.mark.parametrize("engine", ["fused-numpy", "hopper"])
def test_journaled_group_recovers_like_the_reference(corpus, tmp_path,
                                                     engine):
    """Every shard replica journals its own slice and the coordinator its
    routing: a checkpoint, more mutations, a close and an ``open`` give
    back the reference's rankings bit for bit with numpy workers, and a
    never-closed group's with Hopper workers."""
    ids, matrix, ts = corpus
    kw = dict(n_shards=3, replicas=2, fsync=False)
    t_kw = dict(kw, engine=engine,
                **({"device": "cpu"} if engine == "hopper" else {}))
    groups = [(RGroup, tmp_path / "ref", kw), (TGroup, tmp_path / "port",
                                               t_kw)]
    for cls, path, opts in groups:
        with cls(DIM, journal_dir=str(path), **opts) as g:
            g.append(ids[:240], matrix[:240], ts[:240])
            g.delete([3, 50, 51])
            g.checkpoint()
            g.append(ids[240:], matrix[240:], ts[240:])
            g.delete([300, 407])
    with RGroup.open(str(tmp_path / "ref"), DIM, **kw) as rg, \
            TGroup.open(str(tmp_path / "port"), DIM, **t_kw) as tg:
        assert tg.n_live == rg.n_live == N - 5
        assert tg.recovered_records == rg.recovered_records == 2
        for tokens in TOKEN_SHAPES[:5]:
            r, t = _plans(tokens)
            want = rg.search_plan(r, now=NOW)
            got = tg.search_plan(t, now=NOW)
            if engine == "fused-numpy":
                assert got == want, tokens
        if engine == "hopper":
            # the plain versions split repeated rows' ties by row, BLAS by
            # a last bit: hold recovery to a group that never closed
            with TGroup(DIM, **{k: v for k, v in t_kw.items()
                                if k != "fsync"}) as live:
                live.append(ids[:240], matrix[:240], ts[:240])
                live.delete([3, 50, 51])
                live.append(ids[240:], matrix[240:], ts[240:])
                live.delete([300, 407])
                for tokens in TOKEN_SHAPES[:5]:
                    _, t = _plans(tokens)
                    assert (tg.search_plan(t, now=NOW)
                            == live.search_plan(t, now=NOW)), tokens
