"""The async continuous-batching engine: the port against the reference, on
the CPU.

Each scenario runs in ``repro`` and ``repro_torch``; a gate backend
(``tests/torch_harness.py``) holds the scoring pass until the test lets it
go, so queue states are pinned exactly.  What each package observes must
be equal: ``asearch``, ``search_async`` and ``flex_search_async`` rank as
the direct path does (ids in order, scores within 1e-5, and as the
reference ranks); a full queue rejects; a lapsed deadline fails at
collect; priority orders the collect; ``close()`` fails the queued
requests fast; a held admission window folds arrivals into one cohort;
async dispatch on and off rank the same; a failing pass fails only its
batch; and rankings served while ingest and delete race the scheduler
stay bit-identical to the direct path and equal to the reference's on
the same mutation sequence.
"""

import asyncio
import concurrent.futures as cf
import sys
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_harness import (NOW, PACKAGES, R, T, database, engine,  # noqa: E402
                           gate_backend, make_cache, same_ranking, same_rows,
                           wait_for)

TOKENS = [f"similar:group {i % 7} tail decay:14" for i in range(20)]


@pytest.mark.parametrize("key", ["fused", "hopper", "torch"])
def test_asearch_matches_the_direct_path(key):
    out = {}
    for P in PACKAGES:
        cache, _ = make_cache(P, 300)
        eng = P.E.BatchedRetrievalEngine(cache, max_batch=16, now=NOW,
                                         engine=engine(P, key))
        try:
            async def main():
                return await asyncio.gather(*[eng.asearch(t, 5)
                                              for t in TOKENS])

            batched = asyncio.run(main())
            out[P.name] = (batched,
                           [cache.search(t, now=NOW,
                                         engine=engine(P, key))[:5]
                            for t in TOKENS], eng.batches_served)
        finally:
            eng.close()
    batched, direct, batches = out["repro_torch"]
    assert batches < len(TOKENS)
    for b, d, r in zip(batched, direct, out["repro"][0]):
        same_ranking(b, d)
        same_ranking(b, r)


@pytest.fixture(scope="module", params=["fused", "hopper"])
def services(request):
    out = {}
    for P in PACKAGES:
        conn, emb = database(P, 300, 20, 5, 64)
        out[P.name] = P.R.RetrievalService(
            conn, dim=64, embedder=emb, now=1_770_000_000.0,
            engine=engine(P, request.param))
    yield out
    for svc in out.values():
        svc.close()


FLEX = [
    "SELECT v.id, v.score FROM vec_ops('similar:server pool:5') v LIMIT 3",
    "SELECT v.id, v.score FROM vec_ops('similar:auth token decay:30 "
    "diverse pool:40') v LIMIT 8",
    "SELECT v.id, v.score FROM vec_ops('similar:server lifecycle "
    "keyword:restart fuse:weighted,0.5') v LIMIT 5",
    "SELECT id, score FROM HYBRID_SEARCH('server restart', 0.7) LIMIT 5",
]


def test_service_async_surface_matches_the_direct_path(services):
    """``flex_search_async`` (direct and through the engine),
    ``search_async``, ``ingest_async`` and ``delete_async`` in one loop;
    the port's flex calls all at once, the reference's one at a time."""
    out = {}
    for name, svc in services.items():
        row = (9001, "s1", "user", "fresh doc text", 1_769_000_000.0, 0,
               "proj", None, None, None)

        async def main():
            if name == "repro":  # its calls race on the connection at once
                flex = [await svc.flex_search_async(q) for q in FLEX]
            else:
                flex = await asyncio.gather(*[svc.flex_search_async(q)
                                              for q in FLEX])
            hits = await svc.search_async("similar:server lifecycle "
                                          "decay:30", 5)
            n_in = await svc.ingest_async([row])
            fresh = await svc.search_async("similar:fresh doc text", 3)
            n_out = await svc.delete_async([9001])
            return flex, hits, n_in, fresh, n_out

        flex, hits, n_in, fresh, n_out = asyncio.run(main())
        direct = [svc.flex_search(q) for q in FLEX]
        assert all(f.ok for f in flex), [f.error for f in flex]
        for f, d in zip(flex, direct):
            same_rows(f.rows, d.rows)
        serving = svc.stats()["serving"]
        out[name] = ([f.rows for f in flex], hits, n_in, fresh, n_out,
                     serving["queue_depth"], serving["requests_served"] >= 2)
    t, r = out["repro_torch"], out["repro"]
    for g, w in zip(t[0], r[0]):
        same_rows(g, w)
    same_ranking(t[1], r[1])
    assert 9001 in [i for i, _ in t[3]]
    same_ranking(t[3], r[3])
    assert t[2:3] + t[4:] == r[2:3] + r[4:] == (1, 1, 0, True)


def test_flex_search_async_many_at_once_from_one_loop():
    """64 ``flex_search_async`` calls at once from one asyncio loop through
    the engine rank as the direct path (the reference's one at a time)."""
    out = {}
    topics = ["server lifecycle", "identity provenance", "auth token",
              "rendering pipeline", "database migration"]
    queries = [f"SELECT v.id, v.score FROM vec_ops('similar:{topics[i % 5]}"
               f" decay:30{' diverse' if i % 3 == 0 else ''}') v LIMIT 10"
               for i in range(64)]
    for P in PACKAGES:
        conn, emb = database(P, 300, 20, 5, 64)
        svc = P.R.RetrievalService(conn, dim=64, embedder=emb,
                                   now=1_770_000_000.0,
                                   engine=engine(P, "hopper"))
        try:
            svc.serving(max_batch=32)

            async def main():
                if P is R:  # its calls race on the connection at once
                    return [await svc.flex_search_async(q) for q in queries]
                return await asyncio.gather(*[svc.flex_search_async(q)
                                              for q in queries])

            got = asyncio.run(main())
            assert all(g.ok for g in got), [g.error for g in got]
            direct = [svc.flex_search(q) for q in queries]
            for g, d in zip(got, direct):
                same_rows(g.rows, d.rows)
            out[P.name] = [g.rows for g in got]
        finally:
            svc.close()
    for g, w in zip(out["repro_torch"], out["repro"]):
        same_rows(g, w)


# -- admission, deadlines, priority, close ---------------------------------------


def _backpressure(P):
    cache, _ = make_cache(P)
    gate = gate_backend(P)
    eng = P.E.BatchedRetrievalEngine(cache, max_batch=1, engine=gate,
                                     max_queue=2)
    try:
        with cf.ThreadPoolExecutor(4) as ex:
            first = ex.submit(eng.search, "similar:group 1 tail", 5)
            assert gate.entered.wait(5.0)
            queued = [ex.submit(eng.search, f"similar:group {i} tail", 5)
                      for i in (2, 3)]
            assert wait_for(lambda: eng.queue_depth == 2)
            with pytest.raises(P.E.QueueFullError):
                eng.search("similar:group 4 tail", 5, timeout=5.0)
            gate.release.set()
            got = [first.result(10.0)] + [f.result(10.0) for f in queued]
        return got, eng.rejected, eng.stats()["rejected"], eng.queue_depth
    finally:
        gate.release.set()
        eng.close()


def _deadline(P):
    cache, _ = make_cache(P)
    gate = gate_backend(P)
    eng = P.E.BatchedRetrievalEngine(cache, max_batch=1, engine=gate)
    try:
        with cf.ThreadPoolExecutor(2) as ex:
            blocker = ex.submit(eng.search, "similar:group 1 tail", 5)
            assert gate.entered.wait(5.0)
            doomed = ex.submit(eng.search, "similar:group 2 tail", 5, 10.0,
                               deadline_ms=20.0)
            assert wait_for(lambda: eng.queue_depth == 1)
            time.sleep(0.1)  # the deadline lapses while queued
            gate.release.set()
            got = blocker.result(10.0)
            with pytest.raises(P.E.DeadlineExceededError):
                doomed.result(10.0)
        return got, eng.deadline_misses
    finally:
        gate.release.set()
        eng.close()


def _priority(P):
    cache, _ = make_cache(P)
    sem = threading.Semaphore(0)
    gate = gate_backend(P, semaphore=sem)
    eng = P.E.BatchedRetrievalEngine(cache, max_batch=1, engine=gate)
    order = []
    try:
        with cf.ThreadPoolExecutor(4) as ex:
            blocker = ex.submit(eng.search, "similar:group 1 tail", 5)
            assert gate.entered.wait(5.0)

            def tagged(tokens, tag, priority):
                eng.search(tokens, 5, priority=priority)
                order.append(tag)

            low = ex.submit(tagged, "similar:group 2 tail", "low", 0)
            assert wait_for(lambda: eng.queue_depth == 1)
            high = ex.submit(tagged, "similar:group 3 tail", "high", 5)
            assert wait_for(lambda: eng.queue_depth == 2)
            sem.release()
            blocker.result(10.0)
            sem.release()
            assert wait_for(lambda: len(order) == 1)
            sem.release()
            high.result(10.0)
            low.result(10.0)
        return order
    finally:
        for _ in range(3):
            sem.release()
        eng.close()


def _close_drains(P):
    cache, _ = make_cache(P)
    gate = gate_backend(P)
    eng = P.E.BatchedRetrievalEngine(cache, max_batch=1, engine=gate)
    with cf.ThreadPoolExecutor(4) as ex:
        in_flight = ex.submit(eng.search, "similar:group 1 tail", 5)
        assert gate.entered.wait(5.0)
        queued = [ex.submit(eng.search, f"similar:group {i} tail", 5)
                  for i in (2, 3)]
        assert wait_for(lambda: eng.queue_depth == 2)
        t0 = time.monotonic()
        closer = ex.submit(eng.close)
        time.sleep(0.05)
        gate.release.set()
        closer.result(10.0)
        got = in_flight.result(10.0)
        failed = []
        for f in queued:
            with pytest.raises(P.E.EngineClosedError):
                f.result(10.0)
            failed.append(True)
        fast = time.monotonic() - t0 < 10.0
    with pytest.raises(P.E.EngineClosedError):
        eng.search("similar:anything", 3)
    return got, failed, fast


def _held_window(P):
    cache, _ = make_cache(P)
    gate = gate_backend(P)
    eng = P.E.BatchedRetrievalEngine(cache, max_batch=4, engine=gate)
    try:
        assert eng.async_dispatch
        with cf.ThreadPoolExecutor(4) as ex:
            first = ex.submit(eng.search, "similar:group 1 tail", 5)
            assert gate.entered.wait(5.0)
            held = [ex.submit(eng.search, f"similar:group {i} tail", 5)
                    for i in (2, 3)]
            assert wait_for(lambda: eng.queue_depth == 2)
            assert wait_for(lambda: eng.overlapped_collects >= 1)
            gate.release.set()
            got = [first.result(10.0)] + [f.result(10.0) for f in held]
        return got, eng.overlapped_collects >= 1, eng.batches_served
    finally:
        gate.release.set()
        eng.close()


def _failure_per_batch(P):
    cache, _ = make_cache(P)
    base = P.B.get_backend(engine(P, "hopper"))

    class Flaky(type(base)):
        boom = True

        def score_select(self, *args, **kwargs):
            if Flaky.boom:
                Flaky.boom = False
                raise RuntimeError("injected device failure")
            return super().score_select(*args, **kwargs)

    flaky = Flaky.__new__(Flaky)
    flaky.__dict__.update(base.__dict__)
    eng = P.E.BatchedRetrievalEngine(cache, max_batch=4, engine=flaky)
    try:
        with pytest.raises(RuntimeError, match="injected"):
            eng.search("similar:group 1 tail", 5, timeout=10.0)
        return eng.search("similar:group 2 tail", 5, timeout=10.0)
    finally:
        eng.close()


def _same_observation(got, want):
    """Observations of two packages: rankings compared as rankings, the
    rest exactly."""
    if (isinstance(got, list) and got and isinstance(got[0], tuple)
            and len(got[0]) == 2 and not isinstance(got[0][0], str)):
        same_ranking(got, want)
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_observation(g, w)
    else:
        assert got == want


SCENARIOS = {"backpressure": _backpressure, "deadline": _deadline,
             "priority": _priority, "close-drains": _close_drains,
             "held-window": _held_window,
             "failure-per-batch": _failure_per_batch}
EXPECTED = {"backpressure": lambda o: o[1:] == (1, 1, 0),
            "deadline": lambda o: o[1] == 1,
            "priority": lambda o: o == ["high", "low"],
            "close-drains": lambda o: o[1:] == ([True, True], True),
            "held-window": lambda o: o[1:] == (True, 2),
            "failure-per-batch": lambda o: len(o) == 5}


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_engine_admission_and_shutdown_match_reference(scenario):
    r = SCENARIOS[scenario](R)
    t = SCENARIOS[scenario](T)
    assert EXPECTED[scenario](t), t
    _same_observation(t, r)


def test_latency_clock_is_monotonic_like_the_reference():
    for P in PACKAGES:
        req = P.E.Request(tokens="similar:x")
        assert abs(req.enqueued_at - time.monotonic()) < 60.0
        cache, _ = make_cache(P)
        eng = P.E.BatchedRetrievalEngine(cache, engine="fused-numpy")
        try:
            req2 = P.E.Request(tokens="similar:group 1 tail", k=3)
            eng._submit(req2)
            req2.future.result(10.0)
            assert 0.0 <= req2.latency_ms < 60_000.0
        finally:
            eng.close()


@pytest.mark.parametrize("key", ["fused", "hopper"])
def test_async_dispatch_on_and_off_rank_the_same(key):
    tokens = [f"similar:group {i % 7} tail decay:14" for i in range(16)]
    out = {}
    for P in PACKAGES:
        cache, _ = make_cache(P, 300)
        res = {}
        for mode in (True, False):
            eng = P.E.BatchedRetrievalEngine(cache, max_batch=8, now=NOW,
                                             engine=engine(P, key),
                                             async_dispatch=mode)
            try:
                with cf.ThreadPoolExecutor(8) as ex:
                    res[mode] = list(ex.map(lambda t: eng.search(t, 5),
                                            tokens))
            finally:
                eng.close()
        direct = [cache.search(t, now=NOW, engine=engine(P, key))[:5]
                  for t in tokens]
        for a, b, d in zip(res[True], res[False], direct):
            assert [i for i, _ in a] == [i for i, _ in b] == \
                [i for i, _ in d]
        out[P.name] = res[True]
    for g, w in zip(out["repro_torch"], out["repro"]):
        same_ranking(g, w)


def test_window_stats_report_like_the_reference():
    out = {}
    for P in PACKAGES:
        cache, _ = make_cache(P)
        eng = P.E.BatchedRetrievalEngine(cache, max_batch=64,
                                         max_wait_ms=2.0,
                                         engine="fused-numpy")
        fixed = P.E.BatchedRetrievalEngine(cache, max_wait_ms=3.0,
                                           engine="fused-numpy",
                                           adaptive_window=False)
        try:
            with cf.ThreadPoolExecutor(8) as ex:
                futs = [ex.submit(eng.search, f"similar:group {i % 7} tail",
                                  3) for i in range(24)]
                assert all(len(f.result(10.0)) == 3 for f in futs)
            st, fst = eng.stats(), fixed.stats()
            assert 0.05 <= st["window_ms"] <= 8.0
            assert len(fixed.search("similar:group 1 tail", 5)) == 5
            out[P.name] = (sorted(st), st["adaptive_window"],
                           fst["adaptive_window"], fst["window_ms"],
                           fixed.windows_extended)
        finally:
            eng.close()
            fixed.close()
    assert out["repro_torch"] == out["repro"]
    assert out["repro_torch"][1:] == (True, False, 3.0, 0)


def test_pipeline_overlaps_the_tail_with_the_next_pass(monkeypatch):
    """Both stages stubbed to sleep: the pipelined engine overlaps batches
    (and the sync core never does) in both packages."""
    out = {}
    for P in PACKAGES:
        orig = P.E.finalize_segment_candidates

        def slow_tail(*args, _orig=orig, **kwargs):
            time.sleep(0.03)
            return _orig(*args, **kwargs)

        monkeypatch.setattr(P.E, "finalize_segment_candidates", slow_tail)
        seen = []
        for pipeline in (False, True):
            cache, _ = make_cache(P, 50)
            eng = P.E.BatchedRetrievalEngine(
                cache, max_batch=1, max_wait_ms=0.5, pipeline=pipeline,
                engine=gate_backend(P, released=True, delay_s=0.03))
            try:
                with cf.ThreadPoolExecutor(8) as ex:
                    futs = [ex.submit(eng.search,
                                      f"similar:group {i % 7} tail", 3)
                            for i in range(8)]
                    assert all(len(f.result(30.0)) == 3 for f in futs)
                seen.append(eng.overlapped_batches > 0)
            finally:
                eng.close()
        monkeypatch.setattr(P.E, "finalize_segment_candidates", orig)
        out[P.name] = seen
    assert out["repro_torch"] == out["repro"] == [False, True]


# -- mutations racing the scheduler -------------------------------------------


def _racing(P, key):
    """Four searchers race five bursts of ingest and delete; after each
    burst the batched rankings must equal the direct path on the same
    store.  Returns the post-burst rankings."""
    cache, _ = make_cache(P, 250)
    eng = P.E.BatchedRetrievalEngine(
        cache, max_batch=8, now=NOW, engine=engine(P, key),
        compaction=P.S.CompactionPolicy(min_live_fraction=0.6,
                                        max_segments=5))
    tokens = [f"similar:group {i} tail decay:14" for i in range(7)]
    tokens.append("similar:group 2 tail diverse decay:14")
    errors, seen = [], []
    stop = threading.Event()

    def searcher(seed):
        i = seed
        while not stop.is_set():
            try:
                assert eng.search(tokens[i % len(tokens)], 5)
            except Exception as e:  # pragma: no cover - failure path
                errors.append(e)
                return
            i += 1

    threads = [threading.Thread(target=searcher, args=(i,))
               for i in range(4)]
    try:
        for t in threads:
            t.start()
        rng = np.random.default_rng(7)
        next_id = 50_000
        for burst in range(5):
            ids = np.arange(next_id, next_id + 30)
            next_id += 30
            eng.ingest(ids, rng.standard_normal((30, 32)).astype(np.float32),
                       np.linspace(0, 80 * 86400, 30))
            eng.delete(rng.choice(ids, size=10, replace=False).tolist())
            time.sleep(0.01)
            for t_q in tokens:
                batched = eng.search(t_q, 5)
                direct = cache.search(t_q, now=NOW,
                                      engine=engine(P, key))[:5]
                assert [i for i, _ in batched] == [i for i, _ in direct], \
                    (burst, t_q)
                np.testing.assert_allclose([v for _, v in batched],
                                           [v for _, v in direct],
                                           rtol=1e-5)
                seen.append(batched)
    finally:
        stop.set()
        for t in threads:
            t.join(10.0)
        eng.close()
    assert not errors, errors
    return seen, cache.store.n_live


@pytest.mark.parametrize("key", ["fused", "hopper"])
def test_concurrent_mutations_stay_bit_identical(key):
    r, r_live = _racing(R, key)
    t, t_live = _racing(T, key)
    assert t_live == r_live == 250 + 5 * 20
    for g, w in zip(t, r):
        same_ranking(g, w)


def test_idle_compaction_never_lands_inside_a_scoring_pass(monkeypatch):
    out = {}
    for P in PACKAGES:
        cache, _ = make_cache(P, 300)
        windows = {"score": [], "fold": []}
        orig_sss = P.E.score_select_segments
        orig_fold = P.S.SegmentedCorpusStore._fold

        def recording_sss(*args, _f=orig_sss, _w=windows, **kwargs):
            t0 = time.monotonic()
            res = _f(*args, **kwargs)
            _w["score"].append((t0, time.monotonic()))
            return res

        def recording_fold(self, victims, _f=orig_fold, _w=windows):
            t0 = time.monotonic()
            res = _f(self, victims)
            if res:
                _w["fold"].append((t0, time.monotonic()))
            return res

        monkeypatch.setattr(P.E, "score_select_segments", recording_sss)
        monkeypatch.setattr(P.S.SegmentedCorpusStore, "_fold",
                            recording_fold)
        eng = P.E.BatchedRetrievalEngine(
            cache, max_batch=8, now=NOW, engine=engine(P, "hopper"),
            compaction=P.S.CompactionPolicy(min_live_fraction=0.9,
                                            max_segments=4))
        stop = threading.Event()

        def searcher(seed):
            i = seed
            while not stop.is_set():
                eng.search(f"similar:group {i % 7} tail decay:14", 5)
                i += 1

        threads = [threading.Thread(target=searcher, args=(i,))
                   for i in range(3)]
        try:
            for t in threads:
                t.start()
            rng = np.random.default_rng(1)
            for cycle in range(8):
                ids = np.arange(10_000 + 12 * cycle, 10_012 + 12 * cycle)
                eng.ingest(ids, rng.standard_normal((12, 32)).astype(
                    np.float32), np.full(12, NOW - 1000.0))
                eng.delete(ids[:8].tolist())
                time.sleep(0.02)
            stop.set()
            for t in threads:
                t.join(10.0)
            assert wait_for(lambda: eng.compactions_run >= 1, timeout=10.0)
        finally:
            stop.set()
            eng.close()
        monkeypatch.setattr(P.E, "score_select_segments", orig_sss)
        monkeypatch.setattr(P.S.SegmentedCorpusStore, "_fold", orig_fold)
        assert windows["fold"]
        for fs, fe in windows["fold"]:
            for ss, se in windows["score"]:
                assert fe <= ss or se <= fs
        out[P.name] = (cache.store.n_live, cache.store.compactions >= 1,
                       cache.search("similar:group 3 tail decay:14",
                                    now=NOW, engine="fused-numpy")[:5])
    assert out["repro_torch"][:2] == out["repro"][:2] == (300 + 8 * 4, True)
    same_ranking(out["repro_torch"][2], out["repro"][2])


MIXED_SQL = FLEX + [
    "SELECT id, score FROM keyword('server restart') LIMIT 5",
    "SELECT v.id, v.score FROM vec_ops('similar:server lifecycle',"
    "'SELECT id FROM chunks WHERE type = ''assistant''') v LIMIT 5",
]


@pytest.mark.parametrize("serving", [False, True], ids=["direct", "engine"])
def test_concurrent_flex_search_async_calls_share_one_connection(serving):
    """Many ``flex_search_async`` calls at once run ``flex_search`` on
    worker threads over the service's one SQLite connection: every call
    succeeds and returns the rows the reference returns one at a time.
    (The reference's service lets two threads interleave statements on
    the connection, and a call then fails now and then; the port holds a
    lock around each use of it.)"""
    calls = MIXED_SQL * 8
    out = {}
    for P in PACKAGES:
        conn, emb = database(P, 300, 20, 5, 64)
        svc = P.R.RetrievalService(conn, dim=64, embedder=emb,
                                   now=1_770_000_000.0,
                                   engine=engine(P, "fused"))
        try:
            if P is R:  # the reference, one call at a time
                out[P.name] = [svc.flex_search(q).rows for q in MIXED_SQL]
                continue
            if serving:
                svc.serving()
            for _ in range(3):
                async def main():
                    return await asyncio.gather(*[svc.flex_search_async(q)
                                                  for q in calls])

                got = asyncio.run(main())
                assert all(g.ok for g in got), [g.error for g in got
                                                 if not g.ok]
                out.setdefault(P.name, []).append([g.rows for g in got])
        finally:
            svc.close()
    for rows in out["repro_torch"]:
        for i, got in enumerate(rows):
            same_rows(got, out["repro"][i % len(MIXED_SQL)])


def test_inserts_and_searches_race_on_one_connection():
    """INSERTs, deletes and searches from several threads over one
    service: no call fails, and the store, SQLite and FTS agree."""
    conn, emb = database(T, 300, 20, 5, 64)
    svc = T.R.RetrievalService(conn, dim=64, embedder=emb,
                               now=1_770_000_000.0, engine="fused-numpy")
    svc.serving()
    insert = ("INSERT INTO chunks (id, session_id, type, content, "
              "created_at) VALUES ({cid}, 's1', 'assistant', "
              "'racing row {cid}', 1769000000.0)")
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # threads trade places as often as they can
    try:
        with cf.ThreadPoolExecutor(24) as ex:
            futs = [ex.submit(svc.flex_search, insert.format(cid=5000 + i))
                    for i in range(40)]
            futs += [ex.submit(svc.flex_search, q) for q in MIXED_SQL * 6]
            futs += [ex.submit(svc.ingest, [(6000 + i, "s2", "user",
                                             f"direct row {i}", 1.7e9, 0,
                                             "p", None, None, None)])
                     for i in range(10)]
            results = [f.result(30.0) for f in futs]
        assert all(r.ok for r in results[:40 + len(MIXED_SQL) * 6]), \
            [r.error for r in results if hasattr(r, "ok") and not r.ok]
        assert wait_for(lambda: svc.stats()["ingest"]["embedded"] == 40)
        n_sql = conn.execute("SELECT COUNT(*) FROM _raw_chunks").fetchone()[0]
        n_fts = conn.execute("SELECT COUNT(*) FROM chunks_fts").fetchone()[0]
        assert n_sql == n_fts == svc.cache.store.n_live == 350
        assert svc.delete(list(range(5000, 5040))) == 40
        assert svc.cache.store.n_live == 310
    finally:
        sys.setswitchinterval(switch)
        svc.close()


def test_device_cache_stats_read_while_passes_upload():
    """``stats()`` reads the device cache while the engine's passes insert
    into it and evict from it: the reader never sees the cache change
    under it."""
    backend = T.B.HopperBackend("cpu")
    mats = [np.full((4, 8), i, np.float32) for i in range(200)]
    errors = []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            try:
                backend.device_cache_stats()
            except RuntimeError as e:  # a lost race surfaces here
                errors.append(e)
                return

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    thread = threading.Thread(target=reader)
    try:
        thread.start()
        for _ in range(50):
            for m in mats:
                backend._device_matrix(m)
    finally:
        stop.set()
        thread.join(10.0)
        sys.setswitchinterval(switch)
    assert not thread.is_alive()
    assert not errors, errors
    st = backend.device_cache_stats()
    assert st["entries"] == 32 and st["bytes"] == 32 * mats[0].nbytes
