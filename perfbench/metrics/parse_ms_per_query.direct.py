"""Milliseconds a query on the direct path spends parsing its tokens into
a plan, the hash embedder's calls included: the ``parse`` spans' self
time, over the requests the traced window recorded."""

LAYER = "grammar and embedding (core/grammar.py, embed/hashing.py)"
MOVES = "query_p50_ms"
SOURCE = "program_span"

SPANS = ("parse",)


def read(ctx):
    try:
        from repro_torch import spans
    except ImportError:   # a program without the span recorder
        return None
    return spans.self_ms_per_request(spans.snapshot(), SPANS)
