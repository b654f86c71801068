"""The yardstick on the CPU: the generator against the port's, the
reference against the port's plain path, the control and a broken timed
path against the limits, and the counts behind the rooflines."""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import control
import run as bench_run
from harness import check, roofline, spec, trace, window
from harness import corpus as C
from harness import reference as R

ROOT = bench_run.ROOT
TINY = {"chunks": 3000, "sessions": 60}
SEED = 2**31 + 17
WINDOW_REQUESTS = 8   # the timed window of a run judged broken


@pytest.fixture(scope="module")
def bench():
    """The manifest, with corpus_1m entered as a later cell would enter
    it: its files are proven on the chip, its cell is not in
    BENCHMARK.json (PERF.md, Open questions)."""
    b = spec.load(ROOT)
    b["configs"].append({"name": "corpus_1m",
                         "file": "perfbench/configs/corpus_1m.json"})
    return b


def test_generator_shares_match_the_port():
    from repro_torch.data.corpus import CHUNK_TYPES, generate_corpus

    n, sessions = 20_000, 400
    port = generate_corpus(n, n_sessions=sessions, seed=3)
    ours = C.generate(n, sessions, 180.0, 3, 1_770_000_000.0, 128)
    clusters = [c for c, _ in C.CLUSTERS]
    want = np.bincount([clusters.index(c.cluster) for c in port], minlength=3)
    got = np.bincount(C.TOPIC_CLUSTER[ours.topic], minlength=3)
    np.testing.assert_allclose(got / n, want / n, atol=0.015)
    want = np.bincount([CHUNK_TYPES.index(c.type) for c in port], minlength=4)
    np.testing.assert_allclose(np.bincount(ours.ctype, minlength=4) / n,
                               want / n, atol=0.015)
    per_port = np.unique([c.session_id for c in port], return_counts=True)[1]
    assert sorted(np.bincount(ours.session)) == sorted(per_port)
    words = [len(c.content.split()) // (4 if c.type == "assistant" else 1)
             for c in port]
    assert abs(np.mean(words) - np.mean((ours.words >= 0).sum(1))) < 0.3


def test_embedder_and_rows_match_the_port():
    from repro_torch.embed import HashEmbedder

    port = HashEmbedder(128)
    corpus = C.generate(500, 10, 180.0, 9, 1_770_000_000.0, 128)
    texts = C.texts(corpus)
    for i in range(0, 500, 25):
        np.testing.assert_array_equal(C.embed(texts[i], 128), port(texts[i]))
        np.testing.assert_allclose(corpus.matrix[i], port(texts[i]),
                                   atol=1e-6)


@pytest.mark.parametrize("config,mix", [
    ("corpus_240k", "sql_composed"), ("corpus_1m", "composed_diverse")])
def test_program_passes_and_control_fails(bench, config, mix):
    """At a small size the reference ranks as the port's plain CPU path
    does, and the TF32 control fails the limit of every mix."""
    for line in control.readings(ROOT, bench, config, [mix], [SEED], 0.5,
                                 "cpu", sizes=TINY):
        mix = spec.traffic(ROOT, line["traffic"])
        limits = mix["check"]["limits"]
        prog, ctrl = line["program"], line["control"]
        assert all(prog[k] == 0 for k in ("failed", "dead_rows", "bad_rows"))
        assert all(prog[k] <= limits[k] / 10 for k in limits), line
        assert any(ctrl[k] > limits[k] for k in limits), line


def _break_topk(monkeypatch):
    """An answer altered where it is produced: each row's best candidate
    from top-k replaced by its last."""
    from repro_torch.kernels.topk import ops

    real = ops.topk

    def broken(scores, k):
        v, i = real(scores, k)
        i = i.clone()
        i[:, 0] = i[:, -1]
        return v, i

    broken.launches = real.launches
    monkeypatch.setattr(ops, "topk", broken)


@pytest.mark.parametrize("config,mix", [
    ("corpus_240k", "sql_composed"), ("corpus_1m", "composed_diverse")])
def test_a_run_judges_a_broken_path_incorrect(bench, config, mix,
                                              monkeypatch):
    """The timed window holds its first ``WINDOW_REQUESTS`` requests
    whatever the CPU's speed: on a busy one a 0.4 s window held one, which
    the broken path need not alter."""
    run = window.run

    def counted_window(call, request, clients, seconds, limit=None):
        if limit is None:
            seconds, limit = float("inf"), WINDOW_REQUESTS
        return run(call, request, clients, seconds, limit=limit)

    monkeypatch.setattr(window, "run", counted_window)
    w = {"name": f"{config}.{mix}", "config": config, "traffic": mix,
         "chips": 1}
    sound = bench_run.run_cell(ROOT, bench, w, SEED, 0.4, False, "cpu", 0.0,
                               sizes=TINY)
    assert sound["correct"], sound["checks"]
    _break_topk(monkeypatch)
    broken = bench_run.run_cell(ROOT, bench, w, SEED, 0.4, False, "cpu", 0.0,
                                sizes=TINY)
    assert not broken["correct"], broken["checks"]


def test_reference_ties_go_to_the_smallest_row():
    m = np.tile(np.eye(1, 8, 0, dtype=np.float32), (6, 1))
    ref = R.Reference(m, np.zeros(6), None, 0.0)
    rows, scores = ref.top([R.parse("similar:system")], 3)
    assert rows[0].tolist() == [0, 1, 2]


def test_roofline_counts_reproduce_the_known_bounds():
    k1 = roofline.pem_score_work(240_000, 128, 32)
    assert round(roofline.bound_s(k1) * 1e3, 4) == 0.0461
    assert k1.nbytes / roofline.HBM_BYTES_S > k1.flops / 495e12
    k3 = roofline.mmr_work(1, 1500, 500, 128)
    assert round(roofline.bound_s(k3) * 1e3, 4) == 0.0029
    assert k3.flops / 67e12 > k3.nbytes / roofline.HBM_BYTES_S


def test_trace_summary_unions_device_time():
    events = [("void at::cuda::(anonymous namespace)::spin_kernel(long)", 0, 50),
              ("void (anonymous namespace)::mmr_kernel<true>(float*)", 100, 200),
              ("pem_score_kernel", 250, 100),
              ("Memcpy HtoD (Pageable -> Device)", 900, 200),
              ("spin_kernel", 1050, 40)]
    s = trace.summarize(events, [(10.0, 10.0005)], 10.0)
    assert s["window_s"] == pytest.approx(1e-3)          # 50 to 1050
    assert s["busy_s"] == pytest.approx(400e-6)          # 100-350, 900-1050
    assert trace.device_seconds(s, ["mmr_kernel"]) == pytest.approx(200e-6)
    assert s["breakdown"]["idle_gaps"] == [
        ["client, between requests", pytest.approx(550e-6)],
        ["host path, 1 request(s) in flight", pytest.approx(50e-6)]]


def test_trace_window_survives_a_dropped_marker():
    """Markers at each end, one of the first group missing: the window is
    still the longest gap between two markers."""
    events = [("spin_kernel", 0, 50), ("spin_kernel", 60, 50),
              ("pem_score_kernel", 200, 100),
              ("spin_kernel", 1000, 40), ("spin_kernel", 1050, 40),
              ("spin_kernel", 1100, 40)]
    s = trace.summarize(events, [], 10.0)
    assert s["window_s"] == pytest.approx(890e-6)        # 110 to 1000
    assert s["busy_s"] == pytest.approx(100e-6)
    trace.verify(s, 890e-6, {"pem_score": 1})
    assert s["launches"] == {"pem_score_kernel": 1}


def _traced_window(lose):
    """A traced window of a second, ten requests on the trace's clock (us),
    each a K1 and a K3 launch, three markers at each end; the host's
    seconds between the marker groups; the launch counters' change.
    ``lose`` takes away what a trace that lost records would lack."""
    start = [(trace.MARKER, t, 50) for t in (0, 70, 140)]
    end = [(trace.MARKER, t, 50) for t in (1_000_000, 1_000_070, 1_000_140)]
    work = [e for q in range(10) for e in (
        ("pem_score_kernel", 1_000 + 90_000 * q, 60),
        ("mmr_kernel", 1_100 + 90_000 * q, 900))]
    host_s = (1_000_000 - 190) * 1e-6
    if lose == "start":
        start = []
    elif lose == "end":
        end = []
    elif lose == "mmr":
        work.pop()
    elif lose == "clock":
        host_s += 2 * trace.WINDOW_TOLERANCE_S
    return start + work + end, host_s, {"pem_score": 10, "mmr": 10,
                                        "topk": 60}


@pytest.mark.parametrize("lose,check", [
    ("", None), ("start", "window"), ("end", "window"), ("mmr", "launches"),
    ("clock", "window")])
def test_an_incomplete_trace_gives_no_reading(lose, check):
    """A trace that lost a marker group, or a counted kernel's launch, or
    whose window disagrees with the host's clock, raises naming the check
    that missed; the whole trace passes both."""
    events, host_s, launches = _traced_window(lose)
    s = trace.summarize(events, [], 10.0)
    with (pytest.raises(trace.IncompleteTrace, match=check) if check
          else contextlib.nullcontext()):
        readings = trace.verify(s, host_s, launches)
    if not check:
        assert readings["mmr_kernel"] == {"events": 10, "mmr": 10}
        assert s["busy_s"] == pytest.approx(9_600e-6)


class _HostClockTracer(trace.Tracer):
    """The Tracer with the host's clock for the card's: markers at its
    marks, a K1 and a K3 launch at each request's start; ``lose`` "end"
    takes the end group away."""

    lose = ""

    def __init__(self):
        self.marks = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _mark(self):
        before = time.perf_counter()
        self.marks.append((before, before + 3 * 70e-6))

    def read(self, records=(), launches=None):
        self._starts = [r.start for r in records]
        return super().read(records, launches)

    def events(self):
        groups = [[(trace.MARKER, b * 1e6 + 70 * i, 50) for i in range(3)]
                  for b, _ in self.marks]
        work = [(name, t * 1e6 + 1, 20) for t in self._starts
                for name in ("pem_score_kernel", "mmr_kernel")]
        if self.lose == "end":
            groups[1] = []
        return groups[0] + work + groups[1]


@pytest.mark.parametrize("lose,check", [("end", "window"),
                                        ("mmr", "launches")])
def test_a_run_on_an_incomplete_trace_exits_nonzero(bench, monkeypatch,
                                                    capsys, lose, check):
    """run.py, driven through a whole traced run of the tiny cell on the
    CPU, exits non-zero with the missed check named and prints no result
    where the trace lost its end group or one of K3's launches.  K3's
    counter then reads one launch more than the trace holds, so the trace
    still names K3 however few requests the window held (on a busy CPU one:
    losing its only record would leave K3 unnamed, and so unchecked)."""
    import torch

    from harness.system import System

    calls = []
    entry = System.entry

    def counted_entry(self, mix):
        call = entry(self, mix)

        def counted(q):
            calls.append(q)
            return call(q)
        return counted

    reads = []

    def counters(self):
        # read before the window and after it; "mmr": one more after
        reads.append(len(calls))
        extra = int(lose == "mmr" and len(reads) > 1)
        return {"pem_score": len(calls), "topk": 6 * len(calls),
                "mmr": len(calls) + extra}

    monkeypatch.setattr(System, "entry", counted_entry)
    monkeypatch.setattr(System, "counters", counters)
    monkeypatch.setattr(_HostClockTracer, "lose", lose)
    monkeypatch.setattr(trace, "Tracer", _HostClockTracer)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    run_cell = bench_run.run_cell
    monkeypatch.setattr(bench_run, "run_cell", lambda *a: run_cell(
        *a[:6], "cpu", a[7], sizes=TINY))
    rc = bench_run.main(["--workload", "corpus_240k.sql_composed", "--seed",
                         str(SEED), "--seconds", "0.4", "--trace", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert f"the trace is incomplete, no reading taken: {check}" in out.err


def test_metrics_read_nothing_where_nothing_ran(bench):
    import types

    empty = types.SimpleNamespace(
        trace={"busy_s": 0.0, "window_s": 1.0, "seconds": {}}, completed=10,
        delta={"pem_score": 0, "topk": 0, "mmr": 0}, shapes={
            "d": 128, "mmr": None})
    for m in bench["per_layer"]:
        assert spec.metric_module(ROOT, m["name"]).read(empty) is None


def test_run_needs_a_card():
    """Without a CUDA card a run exits with an error and prints nothing."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
         "corpus_240k.sql_composed", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_a_run_loads_no_jax():
    """A run's process, the CPU's tiny cell here, holds no module of JAX
    or of the JAX package once its window has closed."""
    code = (
        "import sys; sys.path.insert(0, %r); import run as r; "
        "from harness import spec; b = spec.load(r.ROOT); "
        "c = spec.cell(b, 'corpus_240k.sql_composed'); "
        "out = r.run_cell(r.ROOT, b, c, 7, 0.2, False, 'cpu', 0.0, "
        "sizes=%r); print(r.forbidden_modules(), out['correct'])"
        % (str(ROOT / "perfbench"), TINY))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-2] == "[] True"


def test_traffic_streams_repeat_by_seed(bench):
    from harness.traffic import QueryStream

    mix = spec.traffic(ROOT, "sql_composed")
    a, b = QueryStream(mix, 2**33 + 1), QueryStream(mix, 2**33 + 1)
    assert [a.request(i) for i in range(20)] == [b.request(i)
                                                for i in range(20)]
    assert check.SQL_RE.match(a.request(0))
    assert json.dumps(mix)
