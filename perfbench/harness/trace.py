"""The traced run: ``torch.profiler`` over the window, read back from its
results in memory.

On the card it records the device's activity alone (kernels, copies,
memsets): the host's own ops would multiply the trace's size and its
reading time.  Marker kernels (``torch.cuda._sleep``), each launched on
an idle card and waited for, bound the window on the trace's clock and
tie it to the host's: a few at each end, since a trace now and then
lacks one, and the window is the longest gap between two of them.  What
it yields: the device's busy seconds (the union of every device interval
inside the window), each device op's seconds in the window and records
in the trace by name, and the longest idle gaps, each named by what the clients were doing then
(inside a request: the program's host path; or between requests).

Kineto keeps only the device records whose time, on its conversion of
the device's clock to the host's, falls between the session's start and
stop on the host's clock.  That conversion strays now and then (on an
H100 a marker read up to 14 ms after the host saw it end), so a record
at the very edge of the session is dropped: without room, a session lost
its first markers in 4 tries of 230.  So the session holds ``EDGE_S`` of
the host's time before the first marker and after the last.  No reading
is taken from a trace that lost records all the same: ``verify`` holds
the window the trace reads to the host's clock between the markers, and
each kernel that the program counts launch by launch to its counter, and
raises ``IncompleteTrace`` where either misses.
"""

from __future__ import annotations

import contextlib
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MARKER = "spin_kernel"
MARKER_CYCLES = 100_000
MARKS = 3   # marker kernels at each end of the window
EDGE_S = 0.25   # host seconds inside the session before and after the markers
#: how far the trace's window may differ from the host's between the
#: markers: over the cell's 45-200 s windows the two read 0.06-1.91 ms
#: apart, over short sessions of tiny launches up to 5 ms (NVIDIA H100
#: 80GB HBM3, 700 W); a trace that lost a marker group reads the window's
#: whole length off
WINDOW_TOLERANCE_S = 0.1
#: kernels the program counts one launch at a time, and their counters
COUNTED = (("pem_score_kernel", "pem_score"), ("mmr_kernel", "mmr"))
TOP = 10


def kernel_name(name: str) -> str:
    """A kernel's function name, without its return type, namespace,
    template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void\s+", "", name.split("(")[0])
    return name.split("<")[0].split("::")[-1].strip()


class IncompleteTrace(RuntimeError):
    """The trace lost records of its window: no reading is taken from it."""


class Tracer:
    """``with Tracer() as t: with t.window(): ...``; then
    ``t.read(records, launches)``.  The card's only."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        # the host's clock before and after each marker group
        self.marks: List[Tuple[float, float]] = []
        self._prof = profile(activities=[ProfilerActivity.CUDA])

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self._prof.__exit__(*exc)

    def _mark(self) -> None:
        import torch

        torch.cuda.synchronize()
        before = time.perf_counter()
        for _ in range(MARKS):
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
        self.marks.append((before, time.perf_counter()))

    @contextlib.contextmanager
    def window(self):
        time.sleep(EDGE_S)
        self._mark()
        yield
        self._mark()
        time.sleep(EDGE_S)

    def events(self) -> List[Tuple[str, float, float]]:
        """(name, start us, duration us) of each device record."""
        from torch.autograd import DeviceType

        return [(e.name(), e.start_ns() * 1e-3, e.duration_ns() * 1e-3)
                for e in self._prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA]

    def read(self, records=(), launches=None) -> Dict:
        """The summary of the window's device events, once ``verify`` has
        found the trace whole; ``launches`` is the change in the program's
        launch counters over the session."""
        summary = summarize(self.events(),
                            [(r.start, r.end) for r in records],
                            self.marks[0][1])
        summary["verified"] = verify(
            summary, self.marks[1][0] - self.marks[0][1], launches or {})
        return summary


def summarize(events: Sequence[Tuple[str, float, float]], host: List[tuple],
              host_start: float) -> Dict:
    """busy_s, window_s, ``seconds`` of each device op by name inside the
    window, ``launches`` (records of each op in the whole trace, markers
    aside), and the ``breakdown``, from device ``events`` (name, start us,
    duration us).  ``host`` lists the requests' (start, end) on the host's
    clock, on which the window began at ``host_start``."""
    names: Dict[str, str] = {}
    for raw, _, _ in events:
        if raw not in names:
            names[raw] = kernel_name(raw)
    op = np.asarray([names[raw] for raw, _, _ in events], dtype=object)
    a = np.asarray([e[1] for e in events], dtype=np.float64)
    b = a + np.asarray([e[2] for e in events], dtype=np.float64)
    kept, count = np.unique(op[op != MARKER], return_counts=True)
    launches = {str(k): int(c) for k, c in zip(kept, count)}
    marks = np.flatnonzero(op == MARKER)
    if marks.size < 2:
        raise IncompleteTrace(f"window: the trace holds {marks.size} "
                              "marker(s), no window")
    marks = marks[np.argsort(a[marks], kind="stable")]
    gap = int(np.argmax(a[marks[1:]] - b[marks[:-1]]))
    w0, w1 = b[marks[gap]], a[marks[gap + 1]]
    keep = (op != MARKER) & (b > w0) & (a < w1)
    op, a, b = op[keep], np.maximum(a[keep], w0), np.minimum(b[keep], w1)
    seconds: Dict[str, float] = {}
    for name, dur in zip(op, b - a):
        seconds[name] = seconds.get(name, 0.0) + dur * 1e-6
    # the union of the intervals: sorted by start, a new block wherever a
    # start passes every end before it
    order = np.argsort(a, kind="stable")
    a, b = a[order], b[order]
    reach = np.maximum.accumulate(b) if b.size else b
    new = np.ones(a.size, bool)
    new[1:] = a[1:] > reach[:-1]
    starts = a[new]
    ends = reach[np.r_[np.flatnonzero(new)[1:] - 1, a.size - 1]] if a.size \
        else reach
    edges_a = np.r_[w0, ends]
    edges_b = np.r_[starts, w1]
    gap = edges_b - edges_a
    top = np.argsort(-gap, kind="stable")[:TOP]

    def doing(t):
        h = host_start + (t - w0) * 1e-6
        inside = sum(1 for s, e in host if s <= h <= e)
        return (f"host path, {inside} request(s) in flight" if inside
                else "client, between requests")

    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": float((ends - starts).sum()) * 1e-6,
        "seconds": seconds,
        "launches": launches,
        "breakdown": {
            "device_ops": [[n, s] for n, s in sorted(
                seconds.items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": [[doing((edges_a[i] + edges_b[i]) / 2),
                           float(gap[i]) * 1e-6]
                          for i in top if gap[i] > 0],
        },
    }


def verify(summary: Dict, host_s: float, launches: Dict[str, int]) -> Dict:
    """Hold a summary's window to ``host_s``, the host's seconds between the
    marker groups, and each ``COUNTED`` kernel's records in the session to
    its counter's change over it in ``launches`` (a kernel the trace does
    not name at all goes unchecked: the program may have renamed it).
    Returns each reading; raises ``IncompleteTrace`` naming each check
    that missed and by how much."""
    off = float(summary["window_s"]) - host_s
    readings = {"window": {"trace_s": float(summary["window_s"]),
                           "host_s": host_s, "off_s": off,
                           "tolerance_s": WINDOW_TOLERANCE_S}}
    faults = []
    if not abs(off) <= WINDOW_TOLERANCE_S:
        faults.append(f"window: the trace reads {float(summary['window_s'])!r}"
                      f" s between the markers, the host {host_s!r} s, off by"
                      f" {off!r} s against a tolerance of "
                      f"{WINDOW_TOLERANCE_S!r} s")
    for kernel, counter in COUNTED:
        got = summary["launches"].get(kernel, 0)
        want = launches.get(counter, 0)
        if not got and want:
            continue
        readings[kernel] = {"events": got, counter: want}
        if got != want:
            faults.append(f"launches: {got} {kernel} record(s) in the trace "
                          f"against {want} counted by {counter}, off by "
                          f"{got - want:+d}")
    if faults:
        raise IncompleteTrace("; ".join(faults))
    return readings


def device_seconds(trace: Optional[Dict], names) -> float:
    """Seconds the kernels named ``names`` ran inside the window."""
    if not trace:
        return 0.0
    return sum(trace["seconds"].get(n, 0.0) for n in names)
