"""Closed-loop clients: each sends its next request only once its last has
come back, with no think time, as an agent waiting on a reply does.

Requests are timed from the client's side on the monotonic clock.  A
client starts no request after the window's end; the requests in flight
then are waited for, and count in the latencies but not in the rate.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class Record:
    index: int          # the query's index in the stream
    start: float        # perf_counter seconds
    end: float
    rows: Optional[list]
    error: Optional[str] = None


def run(call: Callable[[str], list], request: Callable[[int], str],
        clients: int, seconds: float, limit: Optional[int] = None):
    """Drive ``clients`` closed-loop clients for ``seconds``, or until
    ``limit`` requests have started; returns (records in start order,
    window start, window end)."""
    counter = itertools.count()
    lock = threading.Lock()
    records: List[Record] = []
    start = time.perf_counter()
    end = start + seconds

    def client():
        mine = []
        while True:
            with lock:
                i = next(counter)
            if limit is not None and i >= limit:
                break
            q = request(i)
            t0 = time.perf_counter()
            if t0 >= end:
                break
            try:
                rows, err = call(q), None
            except Exception as e:  # a failed request is counted, not fatal
                rows, err = None, f"{type(e).__name__}: {e}"
            mine.append(Record(i, t0, time.perf_counter(), rows, err))
        with lock:
            records.extend(mine)

    if clients == 1:
        client()
    else:
        threads = [threading.Thread(target=client, name=f"client-{c}")
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    records.sort(key=lambda r: (r.start, r.index))
    return records, start, end

