"""Milliseconds a query on the direct path blocks on the card: the
``device_wait`` spans (the copies of the selected candidates back to the
host), over the requests the traced window recorded."""

LAYER = "host blocked on the card (core/backends.py)"
MOVES = "query_p50_ms"
SOURCE = "program_span"

SPANS = ("device_wait",)


def read(ctx):
    try:
        from repro_torch import spans
    except ImportError:   # a program without the span recorder
        return None
    return spans.self_ms_per_request(spans.snapshot(), SPANS)
