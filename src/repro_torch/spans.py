"""Host spans on the ``flex_search`` path, kept off the device and out of
the profile.

A span is a name, its request's id, its parent's id, and a start and an
end on ``time.perf_counter_ns()``: the monotonic clock on which a client
times its requests, so spans map onto a device trace as requests do.
Every span of one request carries the id of its root span.

    with spans.root("flex_search"):      # opens a request
        with spans.span("parse"):        # nests under the span open here
            ...

Spans record only while a torch profiler records: each root reads
torch's own flag, ``torch.autograd.profiler._is_profiler_enabled``, and
children follow their root.  With the profiler off a site returns a
shared no-op context and records nothing.  A span calls nothing of torch
(no profiler range, no NVTX, no CUDA event, no synchronise), so the
device's timeline is the same with spans on or off.

A root opens only where no span is open on its thread, and a child only
where one is.  A root that finds the profiler on after a root found it
off starts a fresh recording; :func:`snapshot` returns the current one.
A recording keeps at most ``CAP`` spans and counts the rest as
``dropped``.  :func:`self_ms_per_request` reduces a snapshot to the
milliseconds a request spends in named spans, less their children, and
:func:`count_per_request` to how many named spans a request opens.
"""

from __future__ import annotations

import itertools
import sys
import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

# spans a recording keeps: ~50,000 composed queries through flex_search
# (about 10 spans each), ~34,000 through VectorCache.search on a store of
# 8 segments (about 15 each: a segment_pass a segment, one device_wait)
CAP = 1 << 19


class Span(NamedTuple):
    name: str
    request: int    # the id of the request's root span
    id: int
    parent: int     # -1 for a root
    start_ns: int   # time.perf_counter_ns()
    end_ns: int


class Snapshot(NamedTuple):
    spans: Tuple[Span, ...]   # in the order they closed
    dropped: int


def profiling() -> bool:
    """torch's flag that a profiler records; False while torch is not
    loaded, since then none can."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Recording:
    __slots__ = ("spans", "dropped", "lock")

    def __init__(self):
        self.spans: List[tuple] = []   # Span's fields
        self.dropped = 0
        self.lock = threading.Lock()

    def add(self, span: tuple) -> None:
        if len(self.spans) < CAP:
            self.spans.append(span)
        else:
            with self.lock:
                self.dropped += 1


class _Thread(threading.local):
    top = None   # the innermost open span on this thread


_THREAD = _Thread()


class _Open:
    """An open span; it records itself when it closes."""

    __slots__ = ("recording", "name", "request", "id", "parent", "outer",
                 "start")

    def __init__(self, recording, name, request, id_, outer):
        self.recording, self.name = recording, name
        self.request, self.id, self.outer = request, id_, outer
        self.parent = -1 if outer is None else outer.id

    def __enter__(self):
        _THREAD.top = self
        self.start = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _THREAD.top = self.outer
        self.recording.add((self.name, self.request, self.id, self.parent,
                            self.start, end))
        return False


class Recorder:
    """Spans of the requests this process serves while a profiler
    records.  One instance, :data:`RECORDER`, serves the program."""

    def __init__(self):
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._recording = _Recording()
        self._stale = True   # the next root found on starts a recording

    def root(self, name: str):
        if not profiling():
            self._stale = True
            return _NULL
        if _THREAD.top is not None:
            return _NULL
        if self._stale:
            with self._lock:
                if self._stale:
                    self._recording, self._stale = _Recording(), False
        i = next(self._ids)
        return _Open(self._recording, name, i, i, None)

    def span(self, name: str, top: _Open):
        return _Open(top.recording, name, top.request, next(self._ids), top)

    def snapshot(self) -> Snapshot:
        rec = self._recording
        return Snapshot(tuple(Span._make(s) for s in rec.spans),
                        rec.dropped)


RECORDER = Recorder()


def root(name: str):
    """A request's root span, where a profiler records and no span is
    open on this thread; else a no-op context."""
    return RECORDER.root(name)


def span(name: str):
    """A child of the span open on this thread; a no-op context where
    none is."""
    top = _THREAD.top
    if top is None:
        return _NULL
    return RECORDER.span(name, top)


def snapshot() -> Snapshot:
    """The current recording's spans and its count of dropped ones."""
    return RECORDER.snapshot()


def self_ms_per_request(snap: Snapshot,
                        names: Iterable[str]) -> Optional[float]:
    """Milliseconds a request spends in the spans named ``names``, less
    what their child spans cover, over the requests whose root span was
    recorded; None where none was."""
    roots = {s.id for s in snap.spans if s.parent < 0}
    if not roots:
        return None
    names = set(names)
    covered: Dict[int, int] = {}
    for s in snap.spans:
        if s.parent >= 0:
            covered[s.parent] = (covered.get(s.parent, 0)
                                 + s.end_ns - s.start_ns)
    total = sum(s.end_ns - s.start_ns - covered.get(s.id, 0)
                for s in snap.spans
                if s.name in names and s.request in roots)
    return total / len(roots) * 1e-6


def count_per_request(snap: Snapshot, names: Iterable[str]) -> Optional[float]:
    """How many spans named ``names`` a request opens, over the requests
    whose root span was recorded; None where none was."""
    roots = {s.id for s in snap.spans if s.parent < 0}
    if not roots:
        return None
    names = set(names)
    return sum(1 for s in snap.spans
               if s.name in names and s.request in roots) / len(roots)
