"""Milliseconds a query on the segmented path spends in ``segment_mmr``:
the merged pool gathered from the resident segments and K3 over it, less
the wait for its picks; the spans' self time, over the requests the
traced window recorded.  Nothing where the program records no such span,
or where the recording dropped any."""

LAYER = ("segmented device pass: score_select_segments general branch "
         "(core/backends.py)")
MOVES = "query_p50_ms"
SOURCE = "program_span"

SPANS = ("segment_mmr",)


def read(ctx):
    try:
        from repro_torch import spans
    except ImportError:   # a program without the span recorder
        return None
    snap = spans.snapshot()
    if snap.dropped or not any(s.name in SPANS for s in snap.spans):
        return None
    return spans.self_ms_per_request(snap, SPANS)
