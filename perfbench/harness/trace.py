"""The traced run: ``torch.profiler`` over the window, read back from its
results in memory.

On the card it records the device's activity alone (kernels, copies,
memsets): the host's own ops would multiply the trace's size and its
reading time.  Marker kernels (``torch.cuda._sleep``), each launched on
an idle card and waited for, bound the window on the trace's clock and
tie it to the host's: a few at each end, since a trace now and then
lacks one, and the window is the longest gap between two of them.  What it yields: the device's busy seconds
(the union of every device interval inside the window), each device
op's seconds by name, and the longest idle gaps, each named by what the
clients were doing then (inside a request: the program's host path; or
between requests).
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
TOP = 10


def kernel_name(name: str) -> str:
    """A kernel's function name, without its return type, namespace,
    template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void\s+", "", name.split("(")[0])
    return name.split("<")[0].split("::")[-1].strip()


class Tracer:
    """``with Tracer() as t: with t.window(): ...``; then
    ``t.read(records)``.  The card's only."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.marks: List[float] = []
        self._prof = profile(activities=[ProfilerActivity.CUDA])

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self._prof.__exit__(*exc)

    def _mark(self) -> None:
        import torch

        torch.cuda.synchronize()
        for _ in range(MARKS):
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
        self.marks.append(time.perf_counter())

    @contextlib.contextmanager
    def window(self):
        self._mark()
        yield
        self._mark()

    def read(self, records=()) -> Dict:
        """The summary of the device events of the profile's results."""
        from torch.autograd import DeviceType

        events = [(e.name(), e.start_ns() * 1e-3, e.duration_ns() * 1e-3)
                  for e in self._prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA]
        return summarize(events, [(r.start, r.end) for r in records],
                         self.marks[0])


def summarize(events: Sequence[Tuple[str, float, float]], host: List[tuple],
              host_start: float) -> Dict:
    """busy_s, window_s, ``seconds`` of each device op by name inside the
    window, and the ``breakdown``, from device ``events`` (name, start us,
    duration us).  ``host`` lists the requests' (start, end) on the host's
    clock, on which the window began at ``host_start``."""
    names: Dict[str, str] = {}
    for raw, _, _ in events:
        if raw not in names:
            names[raw] = kernel_name(raw)
    op = np.asarray([names[raw] for raw, _, _ in events], dtype=object)
    a = np.asarray([e[1] for e in events], dtype=np.float64)
    b = a + np.asarray([e[2] for e in events], dtype=np.float64)
    marks = np.flatnonzero(op == MARKER)
    if marks.size < 2:
        raise RuntimeError("the trace holds no window's markers")
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
        "breakdown": {
            "device_ops": [[n, s] for n, s in sorted(
                seconds.items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": [[doing((edges_a[i] + edges_b[i]) / 2),
                           float(gap[i]) * 1e-6]
                          for i in top if gap[i] > 0],
        },
    }


def device_seconds(trace: Optional[Dict], names) -> float:
    """Seconds the kernels named ``names`` ran inside the window."""
    if not trace:
        return 0.0
    return sum(trace["seconds"].get(n, 0.0) for n in names)
