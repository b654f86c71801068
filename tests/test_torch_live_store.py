"""The live store on the CPU: the port's segmented pass against the plain
reference ``repro_torch.reference_live``, the spans of its general branch
and the benchmark metrics that read them, and the segment layout the
port's write path leaves at the benchmark's ``live_240k``.

The store is cut in the proportions of ``perfbench/configs/live_240k.json``
(a base of 90% and 7 deltas) from seeded unit rows; ``HopperBackend("cpu")``
runs the kernels' plain versions.
"""

import sys
import types
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "perfbench") not in sys.path:
    sys.path.insert(0, str(ROOT / "perfbench"))

import run as bench_run  # noqa: E402
from harness import corpus as C  # noqa: E402
from harness import spec  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.core import grammar  # noqa: E402
from repro_torch.core import modulations as M  # noqa: E402
from repro_torch.core.backends import HopperBackend  # noqa: E402
from repro_torch.core.segments import (CompactionPolicy,  # noqa: E402
                                       SegmentedCorpusStore,
                                       store_from_arrays)
from repro_torch.core.vectorcache import VectorCache  # noqa: E402
from repro_torch.embed import HashEmbedder  # noqa: E402
from repro_torch.reference_live import LiveReference  # noqa: E402

CELL = "live_240k.composed_diverse"
N, DIM, NOW = 3000, 128, 1_770_000_000.0
# The port's plain K1 takes its products in float64 and rounds each score
# once to float32 (half an ulp of a score below 2 is 1.2e-7), and its ages
# are float32; MMR's relevance is those scores.  1e-5 is the float32
# tolerance the kernels' suites hold scores to: a hundred times that
# rounding, while TF32 products (10 mantissa bits) miss by ~1e-3.
TOL = 1e-5
QUERIES = [
    "similar:{s} suppress:cache eviction from:parser to:kernel {m}",
    "similar:{s} suppress:website landing page {m}",
    "similar:{s} from:draft to:release {m}",
]
SIMILAR = ["segment merge tombstone", "flash attention kernel",
           "sql endpoint result table"]
SPAN_NAMES = ("segment_pass", "segment_merge", "segment_mmr")
METRICS = {
    "segment_passes_per_query.segmented": "segment_pass",
    "segment_pass_ms_per_query.segmented": "segment_pass",
    "segment_merge_ms_per_query.segmented": "segment_merge",
    "segment_mmr_ms_per_query.segmented": "segment_mmr",
}


def _config():
    return spec.config(ROOT, spec.load(ROOT), "live_240k")


def _arrays(layout, seed=34):
    """Per-segment dicts, as ``store_from_arrays`` takes them: seeded unit
    rows cut at ``layout``'s shares, tombstoned at its share."""
    cuts, dead = layout
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((N, DIM)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    ts = NOW - rng.uniform(0.0, 180 * 86400.0, N)
    live = rng.random(N) >= dead
    return [{"ids": np.arange(a, b, dtype=np.int64) + 10_000,
             "matrix": m[a:b], "timestamps": ts[a:b], "live_mask": live[a:b]}
            for a, b in C.segment_bounds(N, cuts)]


LAYOUTS = {
    "live_240k": lambda: (_config()["segments"], _config()["tombstoned"]),
    "8_segments_all_live": lambda: (_config()["segments"], 0.0),
    "1_segment_tombstoned": lambda: ([1.0], _config()["tombstoned"]),
}


def _tokens(i, decay, diverse):
    mods = " ".join(filter(None, [f"decay:{(7, 14, 30, 90)[i]}" if decay
                                  else "", "diverse pool:500" if diverse
                                  else "pool:500"]))
    return QUERIES[i % len(QUERIES)].format(s=SIMILAR[i % len(SIMILAR)],
                                            m=mods)


def _reference_rows(ref, tokens, embed):
    plan = grammar.parse(tokens, embed)
    q_pre, q_sup = M.fold_plans([plan])
    ids, scores = ref.search(
        q_pre[:, 0], q_sup[:, 0],
        plan.decay.half_life_days if plan.decay is not None else None,
        k=plan.pool, pool=plan.pool, diverse=plan.diverse is not None,
        lam=plan.diverse.lam if plan.diverse is not None else 0.7)
    return list(zip(ids.tolist(), scores.tolist()))


def _assert_same_ranking(got, want, tol=TOL):
    """The same ids in the same order, but for two neighbours trading
    places where the port's float32 MMR blends (or its float32 scores)
    turn a near tie the other way; every score within ``tol``."""
    gi, wi = [i for i, _ in got], [i for i, _ in want]
    assert len(gi) == len(wi)
    score = dict(want)
    assert max(abs(float(v) - score[i]) for i, v in got) <= tol
    p = 0
    while p < len(gi):
        if gi[p] != wi[p]:
            assert gi[p:p + 2] == wi[p:p + 2][::-1], (p, gi[p:p + 3],
                                                      wi[p:p + 3])
            p += 1
        p += 1


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("decay", [True, False], ids=["decay", "no_decay"])
@pytest.mark.parametrize("diverse", [True, False],
                         ids=["diverse", "plain"])
def test_segmented_search_matches_the_plain_reference(layout, decay,
                                                      diverse):
    arrays = _arrays(LAYOUTS[layout]())
    embed = HashEmbedder(DIM)
    cache = VectorCache(embed_fn=embed, store=store_from_arrays(arrays))
    ref = LiveReference(arrays, NOW)
    backend = HopperBackend("cpu")
    dead = {int(i) for a in arrays for i in a["ids"][~a["live_mask"]]}
    assert bool(dead) == (LAYOUTS[layout]()[1] > 0)
    for i in range(3):
        tokens = _tokens(i, decay, diverse)
        got = cache.search(tokens, now=NOW, engine=backend)
        want = _reference_rows(ref, tokens, embed)
        assert len(got) == 500
        assert not dead & {i for i, _ in got}
        _assert_same_ranking(got, want)


def test_ties_go_to_the_smallest_row_across_segments():
    """Every delta row a copy of a base row, with its timestamp: the copies
    score bit-equal, and the merged selection puts the base's row (the
    smaller global row) first, as the reference does, with no swap."""
    arrays = _arrays(LAYOUTS["live_240k"]())
    base = arrays[0]
    at = 0
    for seg in arrays[1:]:
        n = seg["ids"].size
        seg["matrix"] = base["matrix"][at:at + n].copy()
        seg["timestamps"] = base["timestamps"][at:at + n].copy()
        at += n
    embed = HashEmbedder(DIM)
    cache = VectorCache(embed_fn=embed, store=store_from_arrays(arrays))
    ref = LiveReference(arrays, NOW)
    for i in range(3):
        tokens = _tokens(i, True, False)
        got = cache.search(tokens, now=NOW, engine=HopperBackend("cpu"))
        want = _reference_rows(ref, tokens, embed)
        scores = [v for _, v in got]
        assert len(set(scores)) < len(scores)      # ties were selected
        assert [i for i, _ in got] == [i for i, _ in want]
        _assert_same_ranking(got, want)


def test_the_reference_knows_nothing_of_segments():
    """One corpus cut into 8 segments or left whole: the same answer."""
    cuts, dead = LAYOUTS["live_240k"]()
    whole = _arrays(([1.0], dead))
    cut = _arrays((cuts, dead))
    embed = HashEmbedder(DIM)
    tokens = _tokens(0, True, True)
    assert (_reference_rows(LiveReference(whole, NOW), tokens, embed)
            == _reference_rows(LiveReference(cut, NOW), tokens, embed))


def _profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture
def recorder(monkeypatch):
    rec = spans.Recorder()
    monkeypatch.setattr(spans, "RECORDER", rec)
    return rec


@pytest.mark.parametrize("layout,passes", [
    ("live_240k", 8), ("1_segment_tombstoned", 1), ("whole", 0)])
def test_the_general_branch_opens_its_spans(recorder, layout, passes):
    """A request on the general branch opens one ``segment_pass`` a
    segment (its ages, mask rows and K1 enqueue, no copy back), one
    ``segment_merge`` (the mask and the one K2) and one ``segment_mmr``
    around the pool's gather, K3 and the request's one copy back; one
    live segment takes the fast path, opens none of them and copies back
    once too."""
    cut = ([1.0], 0.0) if layout == "whole" else LAYOUTS[layout]()
    cache = VectorCache(embed_fn=HashEmbedder(DIM),
                        store=store_from_arrays(_arrays(cut)))
    backend = HopperBackend("cpu")
    with _profile():
        for i in range(2):
            cache.search(_tokens(i, True, True), now=NOW, engine=backend)
    snap = recorder.snapshot()
    assert snap.dropped == 0
    assert spans.count_per_request(snap, ["segment_pass"]) == passes
    general = 1 if passes else 0
    for name in ("segment_merge", "segment_mmr"):
        assert spans.count_per_request(snap, [name]) == general
    by_id = {s.id: s for s in snap.spans}
    waits = Counter(by_id[s.parent].name for s in snap.spans
                    if s.name == "device_wait")
    if passes:
        assert waits == {"segment_mmr": 2}   # one copy back a request
    else:
        assert waits == {"device_pass": 2}   # one copy back a request
    for s in snap.spans:
        if s.name in SPAN_NAMES:
            assert by_id[s.parent].name == "device_pass"
    assert spans.count_per_request(snap, ["search"]) == 1


def test_count_per_request():
    def sp(name, request, id_, parent):
        return spans.Span(name, request, id_, parent, 0, 1)

    assert spans.count_per_request(spans.Snapshot((), 0), ["x"]) is None
    snap = spans.Snapshot((
        sp("x", 0, 1, 0), sp("x", 0, 2, 0), sp("y", 0, 3, 0),
        sp("search", 0, 0, -1),
        sp("x", 4, 5, 4), sp("search", 4, 4, -1),
        sp("x", 9, 10, 9),        # its root was dropped: counts nowhere
    ), 1)
    assert spans.count_per_request(snap, ["x"]) == 1.5
    assert spans.count_per_request(snap, ["x", "y"]) == 2.0
    assert spans.count_per_request(snap, ["z"]) == 0.0


def _span(name, request, id_, parent, a_ms, b_ms):
    return spans.Span(name, request, id_, parent, int(a_ms * 1e6),
                      int(b_ms * 1e6))


def _recording(dropped=0):
    return spans.Snapshot((
        _span("device_wait", 0, 2, 1, 1.5, 1.7),
        _span("segment_pass", 0, 1, 9, 1.0, 2.0),
        _span("device_wait", 0, 4, 3, 2.5, 2.6),
        _span("segment_pass", 0, 3, 9, 2.0, 3.0),
        _span("segment_merge", 0, 5, 9, 3.0, 3.25),
        _span("device_wait", 0, 7, 6, 4.0, 4.5),
        _span("segment_mmr", 0, 6, 9, 3.25, 4.75),
        _span("device_pass", 0, 9, 0, 0.5, 5.0),
        _span("search", 0, 0, -1, 0.0, 6.0),
        _span("segment_pass", 10, 11, 19, 10.0, 10.5),
        _span("segment_merge", 10, 12, 19, 10.5, 10.75),
        _span("segment_mmr", 10, 13, 19, 10.75, 11.25),
        _span("device_pass", 10, 19, 10, 9.0, 12.0),
        _span("search", 10, 10, -1, 8.0, 13.0),
    ), dropped)


def test_segment_metrics_from_a_hand_built_recording(monkeypatch):
    monkeypatch.setattr(spans, "snapshot", lambda: _recording())
    want = {"segment_passes_per_query.segmented": (2 + 1) / 2,
            "segment_pass_ms_per_query.segmented":
                (0.8 + 0.9 + 0.5) / 2,
            "segment_merge_ms_per_query.segmented": (0.25 + 0.25) / 2,
            "segment_mmr_ms_per_query.segmented": (1.0 + 0.5) / 2}
    got = {name: spec.metric_module(ROOT, name).read(None)
           for name in METRICS}
    assert got == pytest.approx(want, abs=1e-9)


@pytest.mark.parametrize("why", ["dropped", "none_recorded", "nothing"])
def test_segment_metrics_read_nothing(monkeypatch, why):
    """Nothing where the recording dropped spans, where the program opens
    none of these (the fast path, or a program without them), or where
    nothing was recorded."""
    snap = {"dropped": _recording(dropped=1),
            "none_recorded": spans.Snapshot(
                tuple(s for s in _recording().spans
                      if s.name not in SPAN_NAMES), 0),
            "nothing": spans.Snapshot((), 0)}[why]
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    for name in METRICS:
        assert spec.metric_module(ROOT, name).read(None) is None


def test_segment_metrics_are_in_the_manifest():
    bench = spec.load(ROOT)
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name, span in METRICS.items():
        m = entries[name]
        assert (m["source"], m["moves"], m["workloads"]) == (
            "program_span", "query_p50_ms", [CELL])
        assert spec.metric_module(ROOT, name).SPANS == (span,)
    assert entries["segment_passes_per_query.segmented"]["unit"] == "passes"
    for name in ("device_idle.direct", "device_ms_per_query.direct",
                 "launches_per_query.direct",
                 "device_wait_ms_per_query.direct", "mmr_roofline.direct"):
        assert CELL in entries[name]["workloads"]


def test_the_write_path_leaves_the_configured_layout():
    """24,000 rows appended in the vectorizer's 64-row batches to a
    216,000-row base, the compaction policy applied after each: the
    segment sizes of ``live_240k``."""
    config = _config()
    n, dim = int(config["chunks"]), 2
    base = 216_000
    row = np.full((1, dim), 1.0 / np.sqrt(dim), np.float32)
    store = SegmentedCorpusStore(dim)
    store.append(np.arange(base), np.repeat(row, base, 0),
                 np.zeros(base), normalized=True)
    policy = CompactionPolicy()
    for a in range(base, n, 64):
        store.append(np.arange(a, a + 64), np.repeat(row, 64, 0),
                     np.zeros(64), normalized=True)
        store.maybe_compact(policy)
    got = Counter(s.n_rows for s in store.segments)
    want = Counter(b - a for a, b in C.segment_bounds(n, config["segments"]))
    assert got == want
    assert len(store.segments) == policy.max_segments
    assert want == {216_000: 1, 3_456: 4, 3_392: 3}
    assert int(round(n * config["tombstoned"])) == 2_400


def test_the_cell_runs_at_a_tiny_size():
    """The new cell through the harness on the CPU, its corpus cut to
    3,000 rows: every answer correct, no tombstoned row returned."""
    bench = spec.load(ROOT)
    out = bench_run.run_cell(ROOT, bench, spec.cell(bench, CELL), 2**31 + 34,
                             0.5, False, "cpu", 0.0,
                             sizes={"chunks": N, "sessions": 60})
    assert out["correct"], out["checks"]
    assert out["checks"]["dead_rows"]["value"] == 0
    assert set(out["metrics"]) == {"query_p50_ms", "setup_s"}


def test_the_cells_traced_metrics_on_a_program_without_spans(monkeypatch):
    """The parent's program records no segment span: each new metric then
    reads nothing and raises nothing."""
    monkeypatch.delattr(spans, "count_per_request")
    monkeypatch.setattr(spans, "snapshot", lambda: spans.Snapshot(
        tuple(s for s in _recording().spans if s.name not in SPAN_NAMES),
        0))
    ctx = types.SimpleNamespace(trace=None, completed=2, delta={},
                                shapes={})
    for name in METRICS:
        assert spec.metric_module(ROOT, name).read(ctx) is None
