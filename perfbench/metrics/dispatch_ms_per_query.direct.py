"""Milliseconds a query on the direct path spends on the host side of the
device pass: the ``device_pass`` spans' self time (ages, plan folding,
uploads and the kernels' enqueues, less the waits for the card), over
the requests the traced window recorded."""

LAYER = "HopperBackend host side (core/backends.py)"
MOVES = "query_p50_ms"
SOURCE = "program_span"

SPANS = ("device_pass",)


def read(ctx):
    try:
        from repro_torch import spans
    except ImportError:   # a program without the span recorder
        return None
    return spans.self_ms_per_request(spans.snapshot(), SPANS)
