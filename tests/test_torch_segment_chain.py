"""The general branch of ``score_select_segments`` as one device chain
(``HopperBackend.score_select_chain``) against the pass a segment it
replaces, on the CPU: ids equal and scores bit-equal.

``HopperBackend("cpu")`` runs the chain through the kernels' plain
versions; ``LoopHopper``, a subclass that opts out of the chain, runs the
same kernels once a segment and merges on the host.  The stores are cut
as ``tests/test_torch_live_store.py`` cuts them (the benchmark's
``live_240k`` proportions, all live, one tombstoned segment), plus one
whose segment sizes are not multiples of 4; plans are single requests and
cohorts mixing half-lives and lambdas, with decay and without, diverse
and plain, under 1-D candidate masks, (n, B) candidate panels, a segment
the mask skips, and score bias.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "perfbench") not in sys.path:
    sys.path.insert(0, str(ROOT / "perfbench"))

from harness import corpus as C  # noqa: E402
from harness import spec  # noqa: E402

from repro_torch.core import backends as B  # noqa: E402
from repro_torch.core import grammar  # noqa: E402
from repro_torch.core import modulations as M  # noqa: E402
from repro_torch.core.segments import (gather_ids,  # noqa: E402
                                       segment_offsets, store_from_arrays)
from repro_torch.embed import HashEmbedder  # noqa: E402

N, DIM, NOW = 3000, 128, 1_770_000_000.0


class LoopHopper(B.HopperBackend):
    """The same kernels, one ``score_select`` a segment and the host's
    union merge: the loop the chain must equal."""

    segment_chain = False


def _live_240k():
    config = spec.config(ROOT, spec.load(ROOT), "live_240k")
    return config["segments"], config["tombstoned"]


LAYOUTS = {
    "live_240k": lambda: C.segment_bounds(N, _live_240k()[0]),
    "8_segments_all_live": lambda: C.segment_bounds(N, _live_240k()[0]),
    "1_segment_tombstoned": lambda: [(0, N)],
    # no segment a multiple of 4 rows: every slice of ages is padded
    "ragged": lambda: list(zip(RAGGED[:-1], RAGGED[1:])),
}
RAGGED = [0, 1001, 1334, 1591, 1790, 1941, 2002, 2005, N]
DEAD = {"live_240k": None, "8_segments_all_live": 0.0,
        "1_segment_tombstoned": None, "ragged": 0.03}


def _store(layout, seed=35, dead=None):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((N, DIM)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    ts = NOW - rng.uniform(0.0, 180 * 86400.0, N)
    if dead is None:
        dead = DEAD[layout]
    live = rng.random(N) >= (_live_240k()[1] if dead is None else dead)
    return store_from_arrays([
        {"ids": np.arange(a, b, dtype=np.int64) + 10_000, "matrix": m[a:b],
         "timestamps": ts[a:b], "live_mask": live[a:b]}
        for a, b in LAYOUTS[layout]()])


TOKENS = [
    "similar:segment merge tombstone suppress:cache eviction "
    "from:parser to:kernel",
    "similar:flash attention kernel suppress:website landing page",
    "similar:sql endpoint result table from:draft to:release",
    "similar:device cache upload",
]
HALF_LIVES = (7, 14, 30, 90)
LAMS = (0.7, 0.3, 0.0, 0.9)


def _plans(batch, decay, diverse):
    """``batch`` plans; a cohort mixes half-lives (and a plan without
    decay) and lambdas."""
    embed = HashEmbedder(DIM)
    out = []
    for j in range(batch):
        mods = []
        if decay and not (batch > 1 and j == batch - 1):
            mods.append(f"decay:{HALF_LIVES[j % 4]}")
        if diverse:
            mods.append("diverse")
        plan = grammar.parse(" ".join([TOKENS[j % 4]] + mods), embed)
        if plan.diverse is not None:
            plan = dataclasses.replace(
                plan, diverse=M.DiverseSpec(lam=LAMS[j % 4]))
        out.append(plan)
    return out


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _assert_bit_equal(got, want):
    assert len(got) == len(want)
    for (gi, gv), (wi, wv) in zip(got, want):
        assert gi.dtype == wi.dtype == np.int64
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(_bits(gv), _bits(wv))


def _both(store, plans, ks, **kw):
    counters = {}
    out = {}
    for name, backend in (("chain", B.HopperBackend("cpu")),
                          ("loop", LoopHopper("cpu"))):
        counters[name] = B.FusedCounters()
        out[name] = B.score_select_segments(
            backend, store.segments, plans, ks, now=NOW,
            counters=counters[name], **kw)
    assert (counters["chain"].segment_chains,
            counters["chain"].segment_loops) == (1, 0)
    assert (counters["loop"].segment_chains,
            counters["loop"].segment_loops) == (0, 1)
    assert counters["chain"].device_mmr == counters["loop"].device_mmr
    _assert_bit_equal(out["chain"], out["loop"])
    return out["chain"]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("decay", [True, False], ids=["decay", "no_decay"])
@pytest.mark.parametrize("diverse", [True, False], ids=["diverse", "plain"])
@pytest.mark.parametrize("batch", [1, 4])
def test_chain_equals_the_loop(layout, decay, diverse, batch):
    store = _store(layout)
    plans = _plans(batch, decay, diverse)
    ks = [50, 20, 7, 33][:batch]
    got = _both(store, plans, ks)
    dead = {int(i) for s in store.segments for i in s.ids[s.tombstones]}
    for (rows, _), k in zip(got, ks):
        assert rows.size == k
        assert not dead & set(gather_ids(store.segments, rows).tolist())


@pytest.mark.parametrize("device_mmr", [None, False])
def test_chain_equals_the_loop_with_the_host_pool(device_mmr):
    """``device_mmr=False`` (the shard workers' contract): diverse plans
    come back as their oversample pools, from the chain as from the
    loop."""
    store = _store("live_240k")
    plans = _plans(4, True, True)
    plans[1] = dataclasses.replace(plans[1], diverse=None)
    got = _both(store, plans, [50, 20, 7, 33], device_mmr=device_mmr)
    pool = B.selection_width(plans[0], 50, N)
    assert got[0][0].size == (50 if device_mmr is None else pool)


def _masks(store, kind, batch, rng):
    """Per-segment candidate masks: (n,) or (n, B); the third segment is
    skipped (None), the fourth holds every row."""
    out = []
    for s, seg in enumerate(store.segments):
        shape = (seg.n_rows,) if kind == "1d" else (seg.n_rows, batch)
        if s == 2:
            out.append(None)
        elif s == 3:
            out.append(np.ones(shape, bool))
        else:
            out.append(rng.random(shape) < 0.4)
    return out


def _bias(store, kind, batch, rng):
    """Per-segment additive bias: sparse, (n,) or (n, B), None on the
    second segment (no lexical hit there)."""
    if kind is None:
        return None
    out = []
    for s, seg in enumerate(store.segments):
        if s == 1:
            out.append(None)
            continue
        shape = (seg.n_rows,) if kind == "1d" else (seg.n_rows, batch)
        b = np.zeros(shape, np.float32)
        hit = rng.random(shape) < 0.1
        b[hit] = rng.uniform(0.0, 0.5, int(hit.sum())).astype(np.float32)
        out.append(b)
    return out


@pytest.mark.parametrize("layout", ["live_240k", "ragged"])
@pytest.mark.parametrize("mask_kind", [None, "1d", "panel"])
@pytest.mark.parametrize("bias_kind", [None, "1d", "panel"])
@pytest.mark.parametrize("diverse", [True, False], ids=["diverse", "plain"])
def test_chain_equals_the_loop_masked_and_biased(layout, mask_kind,
                                                 bias_kind, diverse):
    store = _store(layout)
    rng = np.random.default_rng(7)
    batch = 4
    plans = _plans(batch, True, diverse)
    masks = (None if mask_kind is None
             else _masks(store, mask_kind, batch, rng))
    bias = _bias(store, bias_kind, batch, rng)
    got = _both(store, plans, [50, 20, 7, 33], candidate_masks=masks,
                score_bias=bias)
    if masks is not None:
        off = segment_offsets(store.segments)
        for rows, _ in got:   # the skipped segment gave no row
            assert not ((rows >= off[2]) & (rows < off[3])).any()


def test_ties_go_to_the_smallest_row_in_the_chain():
    """Every delta row a copy of a base row, with its timestamp: copies
    score bit-equal across segments, and the chain's one K2 puts the
    base's row (the smaller global row) first, as the loop's merge
    does."""
    store = _store("live_240k")
    base = store.segments[0]
    at = 0
    for seg in store.segments[1:]:
        n = seg.n_rows
        seg.matrix[...] = base.matrix[at:at + n]
        seg.timestamps[...] = base.timestamps[at:at + n]
        at += n
    for diverse in (False, True):
        got = _both(store, _plans(4, True, diverse), [50, 20, 7, 33])
        if not diverse:
            vals = np.concatenate([v for _, v in got])
            assert len(set(vals.tolist())) < vals.size   # ties selected


@pytest.mark.parametrize("layout,dead,k1", [
    ("live_240k", None, 8), ("1_segment_tombstoned", 0.0, 1)],
    ids=["8_segments", "1_segment_all_live"])
def test_chain_takes_the_panel_in_one_pass_of_each_kernel(monkeypatch, layout,
                                                          dead, k1):
    """Eight segments: one K1 call a segment, one K2 call and one K3 call
    for the cohort, and no merged pool through the host.  One segment
    with every row live takes the fast path (``score_select``): one call
    of each kernel, the pool's rows gathered from the resident matrix on
    the device, and the one copy back is the final candidates'."""
    from repro_torch.kernels.mmr import ops as mmr_ops
    from repro_torch.kernels.pem_score import ops as pem_ops
    from repro_torch.kernels.topk import ops as topk_ops

    calls = {"pem_score": 0, "topk": 0, "mmr": 0}

    def count(mod, name, key):
        real = getattr(mod, name)

        def wrapped(*a, **kw):
            calls[key] += 1
            return real(*a, **kw)

        monkeypatch.setattr(mod, name, wrapped)

    count(pem_ops, "pem_score", "pem_score")
    count(topk_ops, "topk", "topk")
    count(mmr_ops, "mmr_select", "mmr")
    copies = []
    real_to_host = B._to_host
    monkeypatch.setattr(B, "_to_host",
                        lambda *t: copies.append(len(t)) or real_to_host(*t))
    store = _store(layout, dead=dead)
    assert len(store.segments) == k1
    backend = B.HopperBackend("cpu")
    backend.mmr_pool_segments_batch = None   # the loop's; must not run
    backend._gather_pool_device = None       # a gather by host indices
    out = B.score_select_segments(backend, store.segments,
                                  _plans(4, True, True), [50, 20, 7, 33],
                                  now=NOW)
    assert calls == {"pem_score": k1, "topk": 1, "mmr": 1}
    assert copies == [1]                     # one packed copy back
    assert [rows.size for rows, _ in out] == [50, 20, 7, 33]


def test_score_select_stages_its_inputs_and_copies_back_once(monkeypatch):
    """``HopperBackend.score_select`` on a warm matrix lays every input
    out in one ``_Staging`` buffer, uploads no array of its own, and
    copies a diverse cohort's answer back in one blocking copy, under a
    mask and a bias; its answer is the one it gave before the spies."""
    store = _store("1_segment_tombstoned")
    seg = store.segments[0]
    plans = _plans(4, True, True)
    plans[1] = dataclasses.replace(plans[1], diverse=None)
    bias = np.random.default_rng(3).uniform(0.0, 0.1, N).astype(np.float32)
    backend = B.HopperBackend("cpu")

    def select():
        return backend.score_select(seg.matrix, seg.days_ago(NOW), plans,
                                    [50, 20, 7, 33], mask=seg.live_mask,
                                    score_bias=bias)

    want = select()                          # uploads the matrix
    seen = []

    def spy(name, real):
        def wrapped(*a, **kw):
            seen.append(name)
            return real(*a, **kw)
        monkeypatch.setattr(B, name, wrapped)

    for name in ("_Staging", "_to_device", "_to_host"):
        spy(name, getattr(B, name))
    got = select()
    assert sorted(seen) == ["_Staging", "_to_host"]
    _assert_bit_equal(got, want)
    assert [rows.size for rows, _ in got] == [50, 20, 7, 33]


def test_other_backends_keep_the_loop():
    assert B.HopperBackend.segment_chain
    for cls in (B.ShardedBackend, B.TorchBackend, B.FusedNumpyBackend,
                B.ReferenceNumpyBackend):
        assert not cls.segment_chain


@pytest.mark.parametrize("sizes", [[3, 5, 7], [4, 1, 2, 9]])
def test_ages_start_aligned_whatever_the_segment_sizes(sizes, monkeypatch):
    """Each segment's resident timestamps reach K1 at a 16-byte-aligned
    address, as its TMA reads them, however many rows the segments
    before it hold (the segments' arrays are views of one array, at
    offsets of 8 bytes a row); the chain stages no ages of its own."""
    from repro_torch.kernels.pem_score import ops as pem_ops

    seen = []
    real = pem_ops.pem_score

    def spy(*a, days_ago=None, timestamps=None, **kw):
        assert days_ago is None
        seen.append(timestamps)
        return real(*a, timestamps=timestamps, **kw)

    staged = []
    real_staging = B._Staging

    class Spying(real_staging):
        def __init__(self, layout, *a, **kw):
            staged.extend(layout)
            super().__init__(layout, *a, **kw)

    monkeypatch.setattr(B, "_Staging", Spying)
    monkeypatch.setattr(pem_ops, "pem_score", spy)
    rng = np.random.default_rng(4)
    n = sum(sizes)
    m = rng.standard_normal((n, DIM)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    ts = NOW - rng.uniform(0.0, 30 * 86400.0, n)
    cuts = np.cumsum([0] + sizes)
    store = store_from_arrays([
        {"ids": np.arange(a, b), "matrix": m[a:b], "timestamps": ts[a:b],
         "live_mask": np.ones(b - a, bool)}
        for a, b in zip(cuts[:-1], cuts[1:])])
    B.score_select_segments(B.HopperBackend("cpu"), store.segments,
                            _plans(2, True, False), [4, 3], now=NOW)
    assert len(seen) == len(sizes)
    for t, seg in zip(seen, store.segments):
        assert t.dtype == torch.float64 and t.data_ptr() % 16 == 0
        np.testing.assert_array_equal(t.numpy(), seg.timestamps)
    assert "days" not in staged


class HostAges(LoopHopper):
    """The same kernels fed the host's ages: one ``score_select`` a
    segment, each taking its :class:`Stamps` as f32 ages made on the host
    (as the loop backends take them), the form K1 read before it formed
    the ages itself."""

    def score_select(self, matrix, days_ago, *a, **kw):
        return super().score_select(matrix, B._host_days(days_ago), *a,
                                    **kw)


def _segments_call(backend, store, kind, now=NOW, masked_fast=False):
    """One ``score_select_segments`` call of ``kind`` (plain, diverse,
    masked: 1-D candidate masks, biased: (n,) bias); ``masked_fast``
    gives the one segment's mask to ``score_select`` itself."""
    rng = np.random.default_rng(12)
    plans = _plans(4, True, kind == "diverse")
    ks = [50, 20, 7, 33]
    if masked_fast:
        seg = store.segments[0]
        return backend.score_select(
            seg.matrix, B.Stamps(seg.timestamps, now), plans, ks,
            mask=rng.random(seg.n_rows) < 0.4)
    kw = {}
    if kind == "masked":
        kw["candidate_masks"] = _masks(store, "1d", 4, rng)
    if kind == "biased":
        kw["score_bias"] = _bias(store, "1d", 4, rng)
    return B.score_select_segments(backend, store.segments, plans, ks,
                                   now=now, **kw)


PATHS = {"fast": ("1_segment_tombstoned", 0.0),
         "general": ("live_240k", None)}


def _path_store(path):
    layout, dead = PATHS[path]
    return _store(layout, dead=dead)


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("kind", ["plain", "diverse", "masked", "biased"])
def test_stamped_ages_equal_the_hosts(path, kind):
    """``HopperBackend`` whose K1 forms the ages from the segments'
    timestamps gives the candidates, bit for bit, that the same kernels
    give fed the host's ages: on the fast path (one segment, all live;
    its mask given to ``score_select``) and the general branch (eight
    segments, tombstones), plain, diverse, masked and biased."""
    store = _path_store(path)
    fast_masked = path == "fast" and kind == "masked"
    if path == "fast" and not fast_masked:
        assert len(store.segments) == 1 and not store.segments[0].n_dead
    got = _segments_call(B.HopperBackend("cpu"), store, kind,
                         masked_fast=fast_masked)
    want = _segments_call(HostAges("cpu"), store, kind,
                          masked_fast=fast_masked)
    _assert_bit_equal(got, want)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_stamped_chain_matches_the_reference(path):
    """The chain with K1's ages against ``repro``'s
    ``score_select_segments`` on the same arrays and token strings:
    rows equal, scores within 1e-5."""
    from repro.core import backends as RB
    from repro.core import grammar as r_grammar
    from repro.core import modulations as RM
    from repro.core.segments import SegmentedCorpusStore
    from repro.embed import HashEmbedder as RHash

    store = _path_store(path)
    ref = SegmentedCorpusStore(dim=DIM)
    for seg in store.segments:
        ref.append(seg.ids, seg.matrix, seg.timestamps, normalized=True)
    ref.delete([int(i) for s in store.segments for i in s.ids[s.tombstones]])
    plans = _plans(4, True, True)
    r_plans = []
    for j, p in enumerate(plans):
        mods = [f"decay:{HALF_LIVES[j % 4]}"] if p.decay is not None else []
        rp = r_grammar.parse(" ".join([TOKENS[j % 4]] + mods + ["diverse"]),
                             RHash(DIM))
        r_plans.append(dataclasses.replace(
            rp, diverse=RM.DiverseSpec(lam=LAMS[j % 4])))
    ks = [50, 20, 7, 33]
    got = B.score_select_segments(B.HopperBackend("cpu"), store.segments,
                                  plans, ks, now=NOW)
    want = RB.score_select_segments("jit-jax", ref.segments, r_plans, ks,
                                    now=NOW)
    for (gi, gv), (wi, wv) in zip(got, want):
        np.testing.assert_array_equal(gi, np.asarray(wi))
        np.testing.assert_allclose(gv, np.asarray(wv, np.float32),
                                   atol=1e-5)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_chain_paths_make_no_host_ages(path, monkeypatch):
    """Neither chain path makes the rows' ages on the host, from a
    segment or from its :class:`Stamps`."""
    from repro_torch.core import segments as S

    def refuse(*a):
        raise AssertionError("host ages made on a chain path")

    store = _path_store(path)
    monkeypatch.setattr(S.CorpusSegment, "days_ago", refuse)
    monkeypatch.setattr(B.Stamps, "host_ages", refuse)
    for kind in ("plain", "diverse", "biased"):
        got = _segments_call(B.HopperBackend("cpu"), store, kind)
        assert [rows.size for rows, _ in got] == [50, 20, 7, 33]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_each_now_gives_its_own_ages(path):
    """Two calls on one warm backend at two ``now``s give the two answers
    the host's ages give: nothing is kept from one ``now`` to the next."""
    store = _path_store(path)
    backend = B.HopperBackend("cpu")
    later = NOW + 45 * 86400.0
    got = [_segments_call(backend, store, "plain", now=t)
           for t in (NOW, later, NOW)]
    for t, g in zip((NOW, later, NOW), got):
        _assert_bit_equal(g, _segments_call(HostAges("cpu"), store, "plain",
                                            now=t))
    assert any(not np.array_equal(_bits(a[1]), _bits(b[1]))
               for a, b in zip(got[0], got[1]))


def test_timestamps_upload_once_a_segment():
    """A warm store uploads no timestamps: each segment's go up once, and
    a segment that compaction makes uploads its own once more."""
    store = _store("live_240k")
    backend = B.HopperBackend("cpu")
    for _ in range(3):
        _segments_call(backend, store, "plain")
        assert backend.stamp_uploads == len(store.segments) == 8
    assert backend.uploads == 8
    store.delete([int(store.segments[k].ids[0]) for k in (3, 5)])
    folded = store.compact()          # the tombstoned ones, into one
    assert folded >= 3 and len(store.segments) == 8 - folded + 1
    _segments_call(backend, store, "plain")
    _segments_call(backend, store, "plain")
    assert backend.stamp_uploads == 9 and backend.uploads == 9


@pytest.mark.parametrize("path,decay,k1", [
    ("fast", True, 1), ("general", True, 8), ("fast", False, 0),
    ("general", False, 0)])
def test_stamped_launches_count_the_ages_formed(path, decay, k1,
                                               monkeypatch):
    """K1 forms the ages once a fast-path call and once a decaying
    segment of the chain (what ``pem_score.stamped_launches`` counts on a
    card); a cohort without decay forms none.  The plain path launches
    nothing, so it leaves the counter, like ``launches``, as it was."""
    from repro_torch.kernels.pem_score import ops as pem_ops

    formed = []
    real = pem_ops.pem_score

    def spy(*a, **kw):
        formed.append(kw.get("timestamps") is not None)
        return real(*a, **kw)

    monkeypatch.setattr(pem_ops, "pem_score", spy)
    store = _path_store(path)
    before = (real.launches, real.stamped_launches)
    got = B.score_select_segments(B.HopperBackend("cpu"), store.segments,
                                  _plans(4, decay, True), [50, 20, 7, 33],
                                  now=NOW)
    assert sum(formed) == k1
    assert (real.launches, real.stamped_launches) == before
    assert [rows.size for rows, _ in got] == [50, 20, 7, 33]


@pytest.mark.parametrize("name", ["fused-numpy", "reference-numpy", "torch",
                                  "sharded"])
def test_loop_backends_take_stamps_as_host_ages(name):
    """A backend without the chain takes a segment's :class:`Stamps` at
    its ``score_select`` entry as the host's ages: the same candidates,
    bit for bit, as given ``CorpusSegment.days_ago``, plain and diverse,
    under a mask."""
    backend = {"fused-numpy": B.FusedNumpyBackend,
               "reference-numpy": B.ReferenceNumpyBackend,
               "torch": lambda: B.TorchBackend("cpu"),
               "sharded": lambda: B.ShardedBackend(["cpu"] * 3)}[name]()
    seg = _store("live_240k").segments[0]
    mask = np.random.default_rng(3).random(seg.n_rows) < 0.5
    for diverse in (False, True):
        plans = _plans(4, True, diverse)
        got, want = (backend.score_select(seg.matrix, days, plans,
                                          [50, 20, 7, 33], mask=mask,
                                          fused_mmr=False)
                     for days in (B.Stamps(seg.timestamps, NOW),
                                  seg.days_ago(NOW)))
        _assert_bit_equal(got, want)


def test_a_chain_of_parts_takes_no_host_ages():
    """Host ages come with a one-part chain alone: several parts given
    arrays are refused, not staged."""
    store = _store("live_240k")
    parts = [(int(o), seg.matrix, seg.days_ago(NOW), None, None)
             for o, seg in zip(segment_offsets(store.segments),
                               store.segments)]
    with pytest.raises(ValueError, match="Stamps"):
        B.HopperBackend("cpu").score_select_chain(
            parts, _plans(2, True, False), [4, 3], [4, 3], False)


def test_a_panel_wider_than_k2_takes_the_loop():
    """A selection width past K2's ``MAX_K`` (a plain k of 9,000 over
    10,000 rows) is served by the pass a segment, with the same answer
    the loop gives."""
    from repro_torch.kernels.topk.ops import MAX_K

    n = 10_000
    rng = np.random.default_rng(9)
    m = rng.standard_normal((n, DIM)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    store = store_from_arrays([
        {"ids": np.arange(a, b), "matrix": m[a:b],
         "timestamps": np.full(b - a, NOW), "live_mask": np.ones(b - a, bool)}
        for a, b in C.segment_bounds(n, _live_240k()[0])])
    plans = _plans(1, False, False)
    assert B.selection_width(plans[0], 9_000, n) > MAX_K
    counters = B.FusedCounters()
    got = B.score_select_segments(B.HopperBackend("cpu"), store.segments,
                                  plans, [9_000], now=NOW, counters=counters)
    assert (counters.segment_chains, counters.segment_loops) == (0, 1)
    want = B.score_select_segments(LoopHopper("cpu"), store.segments, plans,
                                   [9_000], now=NOW)
    _assert_bit_equal(got, want)
