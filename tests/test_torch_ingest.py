"""Delta ingest, the write-ahead journal and the background vectorizer: the
port against the reference, on the CPU.

Each scenario runs in ``repro`` and ``repro_torch`` on the same seeded
rows and texts, and what it observes must be equal: rankings (ids in
order, scores within 1e-5) after every append, delete and engine batch;
the rejection of duplicate ids before anything is written; for every
crash point a ``FaultPlan`` can name, the recovered store's ids, matrix
bits, tombstones and segment layout (each package also reads the
journal the other wrote); the torn tail and O(delta) replay; the
vectorizer's retry schedule on a fake clock, its dead letters,
back-pressure, discards and crash recovery; and the service's queued
``INSERT INTO chunks``, ``close()`` flush and priority shedding.
"""

import concurrent.futures as cf
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_harness import (NOW, PACKAGES, R, T, database, engine,  # noqa: E402
                           gate_backend, make_cache, same_ranking, same_rows,
                           same_stores, wait_for)

DIM = 32
INSERT = ("INSERT INTO chunks (id, session_id, type, content, created_at) "
          "VALUES ({cid}, 'sess-d', 'assistant', '{text}', 1769000000.0)")


def _rows(n, start=0):
    rng = np.random.default_rng(1_000 + 7 * start + n)
    return (np.arange(start, start + n, dtype=np.int64),
            rng.standard_normal((n, DIM)).astype(np.float32),
            np.linspace(0.0, 86400.0 * n, n))


# -- delta ingest through the service and the engine ---------------------------


@pytest.mark.parametrize("key", ["fused", "hopper", "torch"])
def test_engine_ingest_and_delete_between_batches(key):
    """Rows appended and deleted through the engine between its batches
    rank as in the reference, before, during and after."""
    out = {}
    for P in PACKAGES:
        emb = P.Hash(64)
        texts = [f"item group {i % 5} tail {i}" for i in range(120)]
        vc = P.V.VectorCache(np.arange(120), emb.embed_batch(texts),
                             np.linspace(0, 89 * 86400, 120), emb)
        eng = P.E.BatchedRetrievalEngine(vc, max_batch=4, now=NOW,
                                         engine=engine(P, key))
        try:
            seen = [eng.search("similar:group 1 tail", 5)]
            eng.ingest(np.arange(500, 508), emb.embed_batch(
                [f"brand new doc about group 1 tail {i}" for i in range(8)]),
                np.full(8, NOW))
            seen.append(eng.search("similar:brand new doc group 1 tail", 8))
            eng.delete(np.arange(500, 504))
            seen.append(eng.search("similar:brand new doc group 1 tail", 8))
            seen.append(eng.search("similar:group 1 tail diverse", 5))
            seen.append(vc.search("similar:group 1 tail", now=NOW,
                                  engine="fused-numpy")[:5])
            out[P.name] = (seen, vc.store.n_segments, vc.store.n_live)
        finally:
            eng.close()
    t_seen = out["repro_torch"][0]
    assert any(i >= 500 for i, _ in t_seen[1])
    assert not {500, 501, 502, 503} & {i for i, _ in t_seen[2]}
    assert [i for i, _ in t_seen[0]] == [i for i, _ in t_seen[4]]
    for g, w in zip(t_seen, out["repro"][0]):
        same_ranking(g, w)
    assert out["repro_torch"][1:] == out["repro"][1:]


def test_materializer_insert_and_delete_like_the_reference():
    """INSERT/DELETE against the chunks view keep SQLite, FTS and the
    cache's segments in step, and other writes stay refused."""
    out = {}
    for P in PACKAGES:
        conn, emb = database(P, 200, 10, 9, 64)
        ids, matrix, ts = P.SQL.load_embedding_matrix(conn, 64)
        cache = P.V.VectorCache(ids, matrix, ts, emb)
        mz = P.MZ.Materializer(conn, cache, now=1_770_000_000.0,
                               engine=engine(P, "hopper"))
        new_id = int(ids.max()) + 1
        seen = [mz.execute(
            "INSERT INTO chunks (id, session_id, type, content, created_at) "
            f"VALUES ({new_id}, 'sess-new', 'assistant', "
            "'zanzibar exotic retrieval topic', 1769000000.0)"),
            (cache.store.n_live, cache.store.n_segments)]
        for sql in ("SELECT v.id, v.score FROM vec_ops('similar:zanzibar "
                    "exotic retrieval topic') v ORDER BY v.score DESC "
                    "LIMIT 3",
                    "SELECT k.id FROM keyword('zanzibar') k",
                    f"DELETE FROM chunks WHERE id = {new_id}",
                    "SELECT v.id FROM vec_ops('similar:zanzibar exotic "
                    "retrieval topic') v LIMIT 3",
                    "SELECT k.id FROM keyword('zanzibar') k"):
            seen.append(mz.execute(sql))
        seen.append(cache.store.n_live)
        for bad in ("DELETE FROM _raw_chunks",
                    "UPDATE _raw_chunks SET content='x'"):
            with pytest.raises(P.MZ.MaterializeError):
                mz.execute(bad)
        out[P.name] = seen
    t, r = out["repro_torch"], out["repro"]
    assert t[0] == (["id"], [(int(t[0][1][0][0]),)])
    assert t[2][1][0][0] == t[0][1][0][0]
    for g, w in zip(t, r):
        if isinstance(g, tuple) and len(g) == 2 and isinstance(g[1], list):
            assert g[0] == w[0]
            same_rows(g[1], w[1])
        else:
            assert g == w


def test_failed_insert_rolls_back_like_the_reference():
    out = {}
    for P in PACKAGES:
        conn, emb = database(P, 50, 4, 21, 64)
        ids, matrix, ts = P.SQL.load_embedding_matrix(conn, 64)
        cache = P.V.VectorCache(ids, matrix, ts, embed_fn=None)
        mz = P.MZ.Materializer(conn, cache)
        errors = []
        for embed_fn, cid in ((None, 7777), (emb, int(ids[0]))):
            cache.embed_fn = embed_fn
            with pytest.raises(P.MZ.MaterializeError) as e:
                mz.execute("INSERT INTO chunks (id, session_id, type, "
                           "content, created_at) VALUES "
                           f"({cid}, 's', 'assistant', 'orphan row', 1.0)")
            errors.append(str(e.value))
            assert not conn.in_transaction
        conn.commit()
        out[P.name] = (errors, conn.execute(
            "SELECT COUNT(*) FROM _raw_chunks WHERE id=7777").fetchone(),
            cache.store.n_segments)
    assert out["repro_torch"] == out["repro"]
    assert out["repro_torch"][1:] == ((0,), 1)


def test_service_rejects_duplicate_ids_before_writing():
    out = {}
    for P in PACKAGES:
        conn, emb = database(P, 50, 4, 25, 64)
        svc = P.R.RetrievalService(conn, dim=64, embedder=emb,
                                   engine=engine(P, "fused"))
        live_id = int(svc.cache.ids[0])
        before = conn.execute("SELECT content FROM _raw_chunks WHERE id=?",
                              (live_id,)).fetchone()
        with pytest.raises(ValueError, match="already live") as e:
            svc.ingest([(live_id, "s", "assistant", "replacement", 2.0,
                         0, None, None, None, None),
                        (live_id + 10_000, "s", "assistant", "fresh", 2.0,
                         0, None, None, None, None)])
        out[P.name] = (str(e.value), before == conn.execute(
            "SELECT content FROM _raw_chunks WHERE id=?",
            (live_id,)).fetchone(), svc.cache.store.n_segments,
            svc.cache.store.n_live)
        svc.close()
    assert out["repro_torch"] == out["repro"]
    assert out["repro_torch"][1:3] == (True, 1)


@pytest.mark.parametrize("key", ["fused", "hopper", "torch"])
def test_service_ingest_delete_and_stats_like_the_reference(key):
    out = {}
    for P in PACKAGES:
        conn, emb = database(P, 150, 8, 13, 64)
        svc = P.R.RetrievalService(conn, dim=64, embedder=emb,
                                   now=1_770_000_000.0, engine=engine(P, key))
        q = ("SELECT v.id, v.score FROM vec_ops('similar:quetzal plumage "
             "iridescent') v ORDER BY v.score DESC LIMIT 3")
        seen = [svc.ingest([(10_000, "sess-x", "assistant",
                             "quetzal plumage iridescent", 1_769_000_000.0,
                             0, "proj", None, None, None)]),
                svc.flex_search(q).rows]
        st = svc.stats()
        seen += [st["store"]["segments"], st["queries"],
                 st["device_cache"]["uploads"] >= 1 if key != "fused"
                 else None,
                 svc.delete([10_000]), svc.flex_search(q).rows,
                 svc.stats()["store"]["tombstoned"]]
        for sql in (INSERT.format(cid=10_001, text="axolotl regeneration"),
                    "DELETE FROM chunks WHERE id = 10001"):
            res = svc.flex_search(sql)
            seen.append((res.ok, res.rows))
        out[P.name] = seen
        svc.close()
    t, r = out["repro_torch"], out["repro"]
    assert t[1][0][0] == 10_000 and 10_000 not in [x[0] for x in t[6]]
    for g, w in zip(t, r):
        if isinstance(g, list):
            same_rows(g, w)
        else:
            assert g == w


# -- the journal ---------------------------------------------------------------


def _script(store):
    ids, mat, ts = _rows(40)
    store.append(ids, mat, ts)
    store.delete([1, 5, 9])
    store.append(*_rows(10, start=100))
    store.delete(list(range(0, 40, 2)))
    store.compact(min_live_fraction=1.0)


def test_journaled_reopen_matches_reference_and_never_crashed(tmp_path):
    """Both packages journal the same script; each reopens its own journal
    and the other's to the never-crashed state, with the same record
    count, and the two journals hold the same bytes."""
    stores = {}
    for P in PACKAGES:
        oracle = P.S.SegmentedCorpusStore(DIM)
        _script(oracle)
        store = P.S.SegmentedCorpusStore.open(tmp_path / P.name, dim=DIM)
        _script(store)
        store.journal.close()
        stores[P.name] = oracle
    assert ((tmp_path / "repro" / "journal.wal").read_bytes()
            == (tmp_path / "repro_torch" / "journal.wal").read_bytes())
    for P in PACKAGES:
        for src in ("repro", "repro_torch"):
            got = P.S.SegmentedCorpusStore.open(tmp_path / src, dim=DIM)
            same_stores(got, stores[P.name])
            same_stores(got, stores["repro"])
            assert got.recovered_records == 5
            got.journal.close()


CRASH_POINTS = ["append:post-journal", "delete:post-journal",
                "compact:post-journal", "snapshot:pre-rename",
                "snapshot:post-rename"]


def _crash_run(P, path, crash_at):
    """Drive the script until ``crash_at`` fires; return the recovered
    store, the store after one more append and a second recovery, and
    the fired points."""
    plan = P.J.FaultPlan(crash_at=crash_at)
    store = P.S.SegmentedCorpusStore.open(path, dim=DIM, fault_plan=plan)
    with pytest.raises(P.J.InjectedCrash):
        store.append(*_rows(30))
        if crash_at.startswith("snapshot:"):
            store.checkpoint()
        store.delete([2, 4])
        store.append(*_rows(8, start=50))
        store.delete(list(range(0, 30, 2)))
        store.compact(min_live_fraction=1.0)
        raise AssertionError(f"fault plan never fired: {crash_at}")
    recovered = P.S.SegmentedCorpusStore.open(path, dim=DIM)
    layout = [(s.seg_id, s.ids.tolist(), s.tombstones.tolist())
              for s in recovered.segments]
    recovered.append(*_rows(5, start=200))
    recovered.journal.close()
    again = P.S.SegmentedCorpusStore.open(path, dim=DIM)
    again.journal.close()
    return recovered, again, layout, list(plan.fired)


@pytest.mark.parametrize("crash_at", CRASH_POINTS)
def test_crash_at_every_point_recovers_like_the_reference(tmp_path,
                                                          crash_at):
    r = _crash_run(R, tmp_path / "r", crash_at)
    t = _crash_run(T, tmp_path / "t", crash_at)
    assert t[3] == r[3] and crash_at in t[3]
    assert t[2] == r[2]
    same_stores(t[0], r[0])
    same_stores(t[1], r[1])
    same_stores(t[1], t[0])
    # each package recovers the other's crashed journal the same way
    for P, path in ((T, tmp_path / "r"), (R, tmp_path / "t")):
        got = P.S.SegmentedCorpusStore.open(path, dim=DIM)
        same_stores(got, t[1])
        got.journal.close()


def _torn_tail(P, path):
    plan = P.J.FaultPlan()
    store = P.S.SegmentedCorpusStore.open(path, dim=DIM, fault_plan=plan)
    store.append(*_rows(20))
    plan.crash_at = "journal:torn-tail"
    with pytest.raises(P.J.InjectedCrash):
        store.append(*_rows(6, start=50))
    recovered = P.S.SegmentedCorpusStore.open(path, dim=DIM)
    dropped = recovered.journal.torn_tail_dropped
    first = [s.ids.tolist() for s in recovered.segments]
    recovered.append(*_rows(6, start=50))
    recovered.journal.close()
    again = P.S.SegmentedCorpusStore.open(path, dim=DIM)
    again.journal.close()
    return dropped, first, again


def test_torn_tail_tolerated_like_the_reference(tmp_path):
    r = _torn_tail(R, tmp_path / "r")
    t = _torn_tail(T, tmp_path / "t")
    assert t[:2] == r[:2] == (1, [list(range(20))])
    same_stores(t[2], r[2])


def _o_delta(P, path):
    store = P.S.SegmentedCorpusStore.open(path, dim=DIM)
    for i in range(25):
        store.append(*_rows(4, start=i * 10))
    store.checkpoint()
    store.append(*_rows(3, start=900))
    store.delete([900])
    stats = store.stats()
    store.journal.close()
    recovered = P.S.SegmentedCorpusStore.open(path, dim=DIM)
    seen = [recovered.recovered_records, recovered.n_live,
            {k: stats[k] for k in ("journal_bytes", "checkpoints")}]
    recovered.checkpoint()
    seen.append(recovered.stats()["journal_bytes"])
    recovered.journal.close()
    writer = P.S.SegmentedCorpusStore.open(path, dim=DIM)
    seen.append(writer.recovered_records)
    ids, mat, ts = _rows(2, start=950)
    writer.append(ids, mat, ts)
    writer.delete([int(ids[0])])
    writer.journal.close()
    last = P.S.SegmentedCorpusStore.open(path, dim=DIM)
    seen += [last.recovered_records, last.n_live]
    last.journal.close()
    return seen, last


def test_recovery_is_o_delta_like_the_reference(tmp_path):
    """After a checkpoint recovery replays only the later records, and the
    sequence resumes past the snapshot on a reopened writer."""
    r, r_store = _o_delta(R, tmp_path / "r")
    t, t_store = _o_delta(T, tmp_path / "t")
    assert t == r
    assert t[0] == 2 and t[1] == 102 and t[3] == 0 and t[4] == 0
    assert t[5] == 2 and t[6] == 103
    same_stores(t_store, r_store)
    assert os.path.exists(tmp_path / "t" / "snapshot.bin")


# -- the vectorizer on a fake clock --------------------------------------------


class _Failing:
    """Raises ``fail_times`` times, then embeds through ``P``'s hash."""

    def __init__(self, P, fail_times=10**9):
        self.fail_times, self.calls, self._emb = fail_times, 0, P.Hash(DIM)

    def __call__(self, text):
        self.calls += 1
        if self.calls <= self.fail_times:
            raise RuntimeError("embedder down")
        return self._emb(text)


def _worker(P, embed, **kw):
    sunk = []
    kw.setdefault("jitter", 0.0)
    kw.setdefault("base_backoff_s", 1.0)
    kw.setdefault("max_backoff_s", 8.0)
    return P.VZ.VectorizerWorker(
        P.VZ.IngestQueue(64), embed,
        lambda ids, vecs, ts: sunk.append((list(ids), vecs, list(ts))),
        **kw), sunk


def _backoff(P):
    worker, _ = _worker(P, _Failing(P), max_attempts=10)
    jittered, _ = _worker(P, _Failing(P), jitter=0.25, seed=3)
    return ([worker.backoff_s(n) for n in range(1, 8)],
            [jittered.backoff_s(n) for n in (1, 2, 3) for _ in range(10)])


def _retry_schedule(P):
    embed = _Failing(P, fail_times=2)
    worker, sunk = _worker(P, embed, max_attempts=5)
    worker.enqueue([(1, "alpha text", 10.0)])
    seen = []
    for now in (0.0, 0.5, 0.99, 1.0, 2.99, 3.0):
        seen.append((now, worker.has_due(now=now), worker.drain_once(now=now),
                     embed.calls, dict(worker.stats())))
    return seen, [(ids, vecs.tobytes(), ts) for ids, vecs, ts in sunk]


def _dead_letters(P):
    worker, sunk = _worker(P, _Failing(P), max_attempts=3)
    worker.enqueue([(7, "poison row", None), (8, "poison too", None)])
    seen = []
    for now in (0.0, 100.0, 200.0, 300.0):
        seen.append((worker.drain_once(now=now), dict(worker.stats())))
    flusher, _ = _worker(P, _Failing(P), max_attempts=4)
    flusher.enqueue([(i, f"text {i}", None) for i in range(5)])
    return (seen, sunk, sorted((d["chunk_id"], d["attempts"])
                               for d in worker.dead_letters),
            flusher.flush(), dict(flusher.stats()))


def _queue(P):
    q = P.VZ.IngestQueue(maxsize=3)
    q.put([(1, "a", None), (2, "b", None)])
    with pytest.raises(P.VZ.IngestQueueFullError):
        q.put([(3, "c", None), (4, "d", None)])
    seen = [len(q), q.rejected]
    q.put([(3, "c", None)])
    seen.append(len(q))
    worker, sunk = _worker(P, _Failing(P, fail_times=0))
    worker.enqueue([(1, "a", None), (2, "b", None)])
    seen.append(worker.queue.discard([1]))
    worker.flush()
    return seen, [(ids, vecs.tobytes()) for ids, vecs, _ in sunk]


@pytest.mark.parametrize("scenario", [_backoff, _retry_schedule,
                                      _dead_letters, _queue],
                         ids=["backoff", "retry-schedule", "dead-letters",
                              "queue"])
def test_vectorizer_on_a_fake_clock_matches_reference(scenario):
    assert scenario(T) == scenario(R)


def _pending_recovery(P, path):
    store = P.S.SegmentedCorpusStore.open(path / "a", dim=DIM)
    emb = P.Hash(DIM)

    def sink(target):
        return lambda ids, vecs, ts: target.append(
            ids, vecs, [t or 0.0 for t in ts])

    worker = P.VZ.VectorizerWorker(P.VZ.IngestQueue(64), emb, sink(store),
                                   journal=store.journal)
    worker.enqueue([(1, "first pending", 5.0), (2, "second pending", 6.0)])
    worker.drain_once()
    worker.enqueue([(3, "never embedded", 7.0)])
    recovered = P.S.SegmentedCorpusStore.open(path / "a", dim=DIM)
    seen = [sorted(i for i, _, _ in recovered.recovered_pending),
            recovered.n_live]
    worker2 = P.VZ.VectorizerWorker(P.VZ.IngestQueue(64), emb,
                                    sink(recovered),
                                    journal=recovered.journal)
    worker2.adopt(recovered.recovered_pending,
                  recovered.recovered_dead_letters)
    worker2.flush()
    seen.append(recovered.n_live)

    plan = P.J.FaultPlan(crash_at="vectorizer:post-embed")
    crashing = P.S.SegmentedCorpusStore.open(path / "b", dim=DIM,
                                             fault_plan=plan)
    worker3 = P.VZ.VectorizerWorker(P.VZ.IngestQueue(64), emb,
                                    sink(crashing), journal=crashing.journal,
                                    fault_plan=plan)
    worker3.enqueue([(11, "doomed batch", None)])
    with pytest.raises(P.J.InjectedCrash):
        worker3.drain_once()
    back = P.S.SegmentedCorpusStore.open(path / "b", dim=DIM)
    seen += [[i for i, _, _ in back.recovered_pending], back.n_live]

    dead = P.S.SegmentedCorpusStore.open(path / "c", dim=DIM)
    worker4 = P.VZ.VectorizerWorker(
        P.VZ.IngestQueue(64), _Failing(P), lambda *a: None, max_attempts=2,
        journal=dead.journal, base_backoff_s=0.0, jitter=0.0)
    worker4.enqueue([(5, "poison", None)])
    worker4.flush()
    reopened = P.S.SegmentedCorpusStore.open(path / "c", dim=DIM)
    seen += [[d["chunk_id"] for d in reopened.recovered_dead_letters],
             reopened.recovered_pending]
    reopened.checkpoint(dead_letters=reopened.recovered_dead_letters)
    reopened.journal.close()
    again = P.S.SegmentedCorpusStore.open(path / "c", dim=DIM)
    seen += [[d["chunk_id"] for d in again.recovered_dead_letters],
             again.recovered_records]
    again.journal.close()
    return seen, recovered


def test_pending_rows_and_dead_letters_survive_a_crash(tmp_path):
    r, r_store = _pending_recovery(R, tmp_path / "r")
    t, t_store = _pending_recovery(T, tmp_path / "t")
    assert t == r
    assert t == [[3], 2, 3, [11], 0, [5], [], [5], 0]
    same_stores(t_store, r_store)


# -- the service: queued INSERT, close() flush, crash adoption ------------------


def _service(P, path, **kwargs):
    conn, emb = database(P, 80, 6, 11, DIM)
    return P.R.RetrievalService(conn, dim=DIM, embedder=emb,
                                store_path=path, engine=engine(P, "hopper"),
                                **kwargs), conn


@pytest.mark.parametrize("fault", ["none", "retry", "dead-letter"])
def test_insert_drains_in_idle_gaps_like_the_reference(tmp_path, fault):
    """A queued INSERT returns on enqueue; the scheduler's idle gaps embed
    it (after two failed attempts with ``retry``; never, with
    ``dead-letter``, whose letter then survives the close)."""
    plans = {"none": None, "retry": 2, "dead-letter": 10**6}
    out = {}
    for P in PACKAGES:
        kw = ({} if plans[fault] is None
              else {"fault_plan": P.J.FaultPlan(embed_failures=plans[fault])})
        svc, _ = _service(P, tmp_path / P.name, **kw)
        try:
            svc.serving(max_wait_ms=1.0, ingest_max_attempts=2 + (
                fault == "retry"), ingest_base_backoff_s=0.001)
            res = svc.flex_search(INSERT.format(
                cid=9001, text="quixotic durability payload"))
            assert res.ok, res.error
            queued = svc.stats()["ingest"]["queued"]
            key = "dead_letter" if fault == "dead-letter" else "embedded"
            assert wait_for(lambda: svc.stats()["ingest"][key] == 1)
            st = svc.stats()["ingest"]
            hits = svc.search("similar:quixotic durability payload", k=3)
            out[P.name] = (queued, st["embedded"], st["retries"],
                           st["dead_letter"], 9001 in svc.cache.store, hits)
        finally:
            svc.close()
        if fault == "dead-letter":
            store = P.S.SegmentedCorpusStore.open(tmp_path / P.name, dim=DIM)
            out[P.name] += ([d["chunk_id"]
                             for d in store.recovered_dead_letters],)
            store.journal.close()
    t, r = out["repro_torch"], out["repro"]
    assert t[:5] == r[:5]
    assert t[0] == 1 and t[4] == (fault != "dead-letter")
    assert t[2] == {"none": 0, "retry": 2, "dead-letter": 1}[fault]
    same_ranking(t[5], r[5])
    if fault != "dead-letter":
        assert t[5][0][0] == 9001
    else:
        assert t[6] == r[6] == [9001]


def test_close_flushes_pending_ingest_like_the_reference(tmp_path):
    out = {}
    for P in PACKAGES:
        svc, conn = _service(P, tmp_path / P.name)
        svc.serving(max_wait_ms=2000.0)  # no idle gap fires
        assert svc.flex_search(INSERT.format(cid=9002,
                                             text="flush me on close")).ok
        svc.close()
        svc2 = P.R.RetrievalService(conn, dim=DIM, embedder=P.Hash(DIM),
                                    store_path=tmp_path / P.name,
                                    engine=engine(P, "hopper"))
        try:
            out[P.name] = (9002 in svc2.cache.store,
                           svc2.cache.store.recovered_records,
                           svc2.search("similar:flush me on close", k=3))
        finally:
            svc2.close()
    assert out["repro_torch"][:2] == out["repro"][:2] == (True, 0)
    same_ranking(out["repro_torch"][2], out["repro"][2])


def test_crashed_service_recovers_pending_through_adoption(tmp_path):
    out = {}
    for P in PACKAGES:
        svc, conn = _service(P, tmp_path / P.name)
        svc.serving(max_wait_ms=2000.0)
        assert svc.flex_search(INSERT.format(cid=9003,
                                             text="survives the crash")).ok
        pending = 9003 in svc.cache.store
        # a killed process: no close-path flush, no checkpoint
        eng, svc._serving = svc._serving, None
        eng.vectorizer = None
        eng.close()
        svc.cache.store.journal.close()
        svc2 = P.R.RetrievalService(conn, dim=DIM, embedder=P.Hash(DIM),
                                    store_path=tmp_path / P.name,
                                    engine=engine(P, "hopper"))
        try:
            svc2.serving(max_wait_ms=1.0)
            assert wait_for(lambda: 9003 in svc2.cache.store)
            out[P.name] = (pending,
                           svc2.search("similar:survives the crash", k=3))
        finally:
            svc2.close()
    assert out["repro_torch"][0] is out["repro"][0] is False
    assert out["repro_torch"][1][0][0] == 9003
    same_ranking(out["repro_torch"][1], out["repro"][1])


def test_explicit_embedding_ingest_stays_synchronous(tmp_path):
    out = {}
    for P in PACKAGES:
        svc, _ = _service(P, tmp_path / P.name)
        try:
            svc.serving(max_wait_ms=2000.0)
            n0 = svc.cache.store.n_live
            svc.ingest([(9100, "sess-d", "assistant", "inline row", 1.0,
                         0, None, None, None, None)])
            out[P.name] = (svc.cache.store.n_live - n0,
                           svc.stats()["ingest"]["queued"])
        finally:
            svc.close()
    assert out["repro_torch"] == out["repro"] == (1, 0)


# -- priority shedding at admission --------------------------------------------


def _shedding(P, newcomer_priority):
    cache, _ = make_cache(P)
    gate = gate_backend(P)
    eng = P.E.BatchedRetrievalEngine(cache, max_batch=1, engine=gate,
                                     max_queue=2)
    outcome = {}
    try:
        with cf.ThreadPoolExecutor(4) as ex:
            blocker = ex.submit(eng.search, "similar:group 1 tail", 5)
            assert gate.entered.wait(5.0)
            waiting = {p: ex.submit(eng.search, f"similar:group {g} tail", 5,
                                    priority=p)
                       for g, p in ((2, 0), (3, 3))}
            assert wait_for(lambda: eng.queue_depth == 2)
            if newcomer_priority > 0:
                waiting[newcomer_priority] = ex.submit(
                    eng.search, "similar:group 4 tail", 5,
                    priority=newcomer_priority)
                wait_for(lambda: eng.shed_low_priority == 1, timeout=5.0)
            else:
                with pytest.raises(P.E.QueueFullError):
                    eng.search("similar:group 4 tail", 5, priority=-1)
            gate.release.set()
            outcome["blocker"] = len(blocker.result(10.0))
            for p, f in sorted(waiting.items()):
                try:
                    outcome[p] = len(f.result(10.0))
                except P.E.QueueFullError:
                    outcome[p] = "shed"
        st = eng.stats()
        return outcome, st["shed_low_priority"], st["rejected"], \
            eng.queue_depth
    finally:
        gate.release.set()
        eng.close()


@pytest.mark.parametrize("newcomer", [5, 0], ids=["sheds-lowest",
                                                  "newcomer-lowest"])
def test_full_queue_sheds_by_priority_like_the_reference(newcomer):
    r, t = _shedding(R, newcomer), _shedding(T, newcomer)
    assert t == r
    if newcomer:
        assert t == ({"blocker": 5, 0: "shed", 3: 5, 5: 5}, 1, 0, 0)
    else:
        assert t == ({"blocker": 5, 0: 5, 3: 5}, 0, 1, 0)
