"""SQL milliseconds a query on the direct path: the self time of the
materializer's SQLite spans (the pool written to its temp table, the
snippet join, the rewritten statement, a Phase-1 prefilter), over the
requests the traced window recorded."""

LAYER = "SQL endpoint: core/materializer.py and SQLite"
MOVES = "query_p50_ms"
SOURCE = "program_span"

SPANS = ("sql.temp_table", "sql.snippet", "sql.statement", "sql.prefilter")


def read(ctx):
    try:
        from repro_torch import spans
    except ImportError:   # a program without the span recorder
        return None
    return spans.self_ms_per_request(spans.snapshot(), SPANS)
