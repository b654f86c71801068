"""The span recorder on the port's flex_search path (``repro_torch.spans``)
and the benchmark's six span metrics, on the CPU.

The service is the benchmark's own: ``perfbench``'s corpus_240k
configuration cut to its tiny corpus, loaded through the harness, driven
with its sql_composed traffic.  Spans record only under a torch profiler;
each test records into a fresh ``Recorder``, so nothing leaks into the
process's own.
"""

import sys
import threading
import time
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "perfbench") not in sys.path:
    sys.path.insert(0, str(ROOT / "perfbench"))

import run as bench_run  # noqa: E402
from harness import spec, traffic  # noqa: E402

from repro_torch import spans  # noqa: E402

TINY = {"chunks": 3000, "sessions": 60}   # perfbench's tiny corpus
SEED = 2**31 + 29
CELL = "corpus_240k.sql_composed"
# the children of one composed query's root, each under its parent
PARENT = {"parse": "flex_search", "device_pass": "flex_search",
          "device_wait": "device_pass", "host_tail": "flex_search",
          "sql.temp_table": "flex_search", "sql.statement": "flex_search"}
METRICS = {
    "sql_ms_per_query.direct": ("sql.temp_table", "sql.snippet",
                                "sql.statement", "sql.prefilter"),
    "parse_ms_per_query.direct": ("parse",),
    "dispatch_ms_per_query.direct": ("device_pass",),
    "device_wait_ms_per_query.direct": ("device_wait",),
    "tail_ms_per_query.direct": ("host_tail",),
    "unspanned_ms_per_query.direct": ("flex_search",),
}


def _profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture
def recorder(monkeypatch):
    rec = spans.Recorder()
    monkeypatch.setattr(spans, "RECORDER", rec)
    return rec


@pytest.fixture(scope="module")
def built():
    bench = spec.load(ROOT)
    b = bench_run.build(ROOT, bench, "corpus_240k", SEED, "cpu", TINY)
    mix = spec.traffic(ROOT, "sql_composed")
    b.stream = traffic.QueryStream(mix, SEED)
    yield b
    b.system.release()


def _by_request(snap):
    out = {}
    for s in snap.spans:
        out.setdefault(s.request, []).append(s)
    return out


def test_nothing_recorded_with_the_profiler_off(recorder):
    """A run of the cell without a profiler records nothing, and its rows
    are the reference's."""
    bench = spec.load(ROOT)
    out = bench_run.run_cell(ROOT, bench, spec.cell(bench, CELL), SEED, 0.4,
                             False, "cpu", 0.0, sizes=TINY)
    assert out["correct"], out["checks"]
    assert not spans.profiling()
    assert recorder.snapshot() == spans.Snapshot((), 0)


def test_each_request_is_one_root_with_its_children_nested(built, recorder):
    svc, stream = built.system.svc, built.stream
    queries = [stream.request(i) for i in range(4)]
    plain = [svc.flex_search(q).rows for q in queries]
    brackets = []
    with _profile():
        assert spans.profiling()
        traced = []
        for q in queries:
            t0 = time.perf_counter_ns()
            traced.append(svc.flex_search(q).rows)
            brackets.append((t0, time.perf_counter_ns()))
    assert traced == plain
    snap = recorder.snapshot()
    assert snap.dropped == 0
    requests = _by_request(snap)
    assert len(requests) == len(queries)
    for (t0, t1), (rid, group) in zip(brackets, sorted(requests.items())):
        by_id = {s.id: s for s in group}
        (root,) = [s for s in group if s.parent < 0]
        assert (root.name, root.id) == ("flex_search", rid)
        assert t0 <= root.start_ns <= root.end_ns <= t1
        assert {s.name for s in group} == {"flex_search", *PARENT}
        assert sum(s.name == "device_wait" for s in group) == 1
        for s in group:
            if s is root:
                continue
            parent = by_id[s.parent]
            assert parent.name == PARENT[s.name]
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        for parent in group:
            kids = sorted((s for s in group if s.parent == parent.id),
                          key=lambda s: s.start_ns)
            for a, b in zip(kids, kids[1:]):
                assert a.end_ns <= b.start_ns


def test_latency_is_taken_on_the_monotonic_clock(built, recorder):
    q = built.stream.request(0)
    t0 = time.perf_counter()
    res = built.system.svc.flex_search(q)
    wall = (time.perf_counter() - t0) * 1e3
    assert res.ok and 0.0 < res.latency_ms <= wall


def test_sql_temp_tables_counts_every_result_table(built, recorder):
    """Every retrieval pseudo-call that gets as far as its result makes
    one table, and its statement drops it: none is kept."""
    svc = built.system.svc
    before = svc.stats()["sql"]
    for i in range(3):
        assert svc.flex_search(built.stream.request(i)).ok
    assert not svc.flex_search("SELECT v.id FROM vec_ops('decay:zzz') v").ok
    two = ("SELECT a.id FROM vec_ops('similar:alpha') a "
           "JOIN vec_ops('similar:beta') b ON a.id = b.id")
    assert svc.flex_search(two).ok
    after = svc.stats()["sql"]
    kept = svc.conn.execute(
        "SELECT count(*) FROM sqlite_temp_master WHERE type = 'table'"
    ).fetchone()[0]
    assert after["temp_tables"] - before["temp_tables"] == 5
    assert (after["temp_tables_dropped"] - before["temp_tables_dropped"]
            == 5)
    assert after["temp_tables_dropped"] == after["temp_tables"]
    assert kept == 0


def test_a_new_profiler_session_starts_a_fresh_recording(built,
                                                         monkeypatch):
    """A recording keeps its cap and counts the rest as dropped; the next
    session, after a request served with the profiler off, starts
    afresh."""
    rec = spans.Recorder()
    monkeypatch.setattr(spans, "RECORDER", rec)
    monkeypatch.setattr(spans, "CAP", 12)
    svc, stream = built.system.svc, built.stream
    with _profile():
        svc.flex_search(stream.request(0))
        svc.flex_search(stream.request(1))
    first = rec.snapshot()
    per_request = 1 + len(PARENT)            # device_wait once
    assert len(first.spans) == 12
    assert first.dropped == 2 * per_request - 12
    svc.flex_search(stream.request(2))
    assert rec.snapshot() == first
    with _profile():
        svc.flex_search(stream.request(3))
    second = rec.snapshot()
    assert second.dropped == 0 and len(second.spans) == per_request
    assert min(s.id for s in second.spans) > max(s.id for s in first.spans)


def test_cache_search_is_a_root_only_outside_a_span(built, recorder):
    cache, backend = built.system.cache, built.system.backend
    tokens = built.stream.tokens(0)
    with _profile():
        cache.search(tokens, now=built.system.now, engine=backend)
        with spans.root("outer"):
            cache.search(tokens, now=built.system.now, engine=backend)
    requests = _by_request(recorder.snapshot())
    assert len(requests) == 2
    first, outer = (sorted(g, key=lambda s: s.id)
                    for _, g in sorted(requests.items()))
    assert [s.name for s in first if s.parent < 0] == ["search"]
    assert {s.name for s in first} == {"search", "parse", "device_pass",
                                       "device_wait", "host_tail"}
    assert [s.name for s in outer if s.parent < 0] == ["outer"]
    assert "search" not in {s.name for s in outer}


def test_threads_keep_their_requests_apart(built, recorder):
    """Four threads search the cache at once: each request's spans carry
    its own root's id and nest on their own thread."""
    cache, backend = built.system.cache, built.system.backend
    tokens = [built.stream.tokens(i) for i in range(4)]
    errors = []

    def client(t):
        try:
            for _ in range(3):
                cache.search(t, now=built.system.now, engine=backend)
        except Exception as e:  # surfaced below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _profile():
            threads = [threading.Thread(target=client, args=(t,))
                       for t in tokens]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(th.is_alive() for th in threads)
    requests = _by_request(recorder.snapshot())
    assert len(requests) == 12
    for rid, group in requests.items():
        by_id = {s.id: s for s in group}
        assert [s.id for s in group if s.parent < 0] == [rid]
        for s in group:
            if s.parent >= 0:
                p = by_id[s.parent]
                assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def _metric(name):
    return spec.metric_module(ROOT, name)


def test_span_metrics_read_nothing_where_nothing_was_recorded(recorder):
    ctx = types.SimpleNamespace(trace=None, completed=10, delta={},
                                shapes={})
    for name in METRICS:
        assert _metric(name).read(ctx) is None


def _span(name, request, id_, parent, a_ms, b_ms):
    return spans.Span(name, request, id_, parent, int(a_ms * 1e6),
                      int(b_ms * 1e6))


def test_span_metrics_from_a_hand_built_recording(monkeypatch):
    recording = spans.Snapshot((
        _span("parse", 0, 1, 0, 0.1, 0.6),
        _span("device_wait", 0, 3, 2, 3.0, 3.5),
        _span("device_pass", 0, 2, 0, 1.0, 4.0),
        _span("host_tail", 0, 4, 0, 4.0, 4.2),
        _span("sql.temp_table", 0, 5, 0, 5.0, 6.0),
        _span("sql.snippet", 0, 6, 0, 6.0, 8.0),
        _span("sql.statement", 0, 7, 0, 8.0, 8.5),
        _span("flex_search", 0, 0, -1, 0.0, 10.0),
        _span("sql.prefilter", 10, 11, 10, 20.0, 21.0),
        _span("parse", 10, 12, 10, 21.0, 21.5),
        _span("device_pass", 10, 13, 10, 22.0, 23.0),
        _span("device_wait", 10, 14, 13, 22.5, 22.9),
        _span("host_tail", 10, 15, 10, 23.0, 23.4),
        _span("sql.statement", 10, 16, 10, 24.0, 24.2),
        _span("flex_search", 10, 10, -1, 20.0, 26.0),
        # a request whose root was dropped counts nowhere
        _span("sql.snippet", 30, 31, 30, 40.0, 45.0),
    ), 1)
    monkeypatch.setattr(spans, "snapshot", lambda: recording)
    want = {"sql_ms_per_query.direct": (1.0 + 2.0 + 0.5 + 1.0 + 0.2) / 2,
            "parse_ms_per_query.direct": (0.5 + 0.5) / 2,
            "dispatch_ms_per_query.direct": (2.5 + 0.6) / 2,
            "device_wait_ms_per_query.direct": (0.5 + 0.4) / 2,
            "tail_ms_per_query.direct": (0.2 + 0.4) / 2,
            "unspanned_ms_per_query.direct": (2.8 + 2.9) / 2}
    got = {name: _metric(name).read(None) for name in METRICS}
    assert got == pytest.approx(want, abs=1e-9)
    assert sum(got.values()) == pytest.approx((10.0 + 6.0) / 2, abs=1e-9)


def test_span_metrics_are_in_the_manifest():
    bench = spec.load(ROOT)
    entries = {m["name"]: m for m in bench["per_layer"]}
    # the live store's cell reads device_wait too (its segments' copies)
    cells = {"device_wait_ms_per_query.direct":
             [CELL, "live_240k.composed_diverse"]}
    for name, names in METRICS.items():
        m = entries[name]
        assert (m["unit"], m["better"], m["source"], m["moves"],
                m["workloads"]) == ("ms", "lower", "program_span",
                                    "query_p50_ms", cells.get(name, [CELL]))
        assert _metric(name).SPANS == names
