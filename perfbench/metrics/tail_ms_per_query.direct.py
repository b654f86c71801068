"""Milliseconds a query on the direct path spends in the host tail: the
``host_tail`` spans (row ids resolved, fusion finished), over the
requests the traced window recorded."""

LAYER = "host tail (core/backends.py finalize_*)"
MOVES = "query_p50_ms"
SOURCE = "program_span"

SPANS = ("host_tail",)


def read(ctx):
    try:
        from repro_torch import spans
    except ImportError:   # a program without the span recorder
        return None
    return spans.self_ms_per_request(spans.snapshot(), SPANS)
