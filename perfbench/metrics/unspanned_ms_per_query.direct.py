"""Milliseconds of a query on the direct path that no child span covers:
the ``flex_search`` root spans' self time (the service's and the
materializer's glue, the scores' normalisation), over the requests the
traced window recorded.  With the other five span metrics it adds up to
the root span's mean."""

LAYER = "serve/retrieval.py glue no child span covers"
MOVES = "query_p50_ms"
SOURCE = "program_span"

SPANS = ("flex_search",)


def read(ctx):
    try:
        from repro_torch import spans
    except ImportError:   # a program without the span recorder
        return None
    return spans.self_ms_per_request(spans.snapshot(), SPANS)
