"""Host milliseconds a query on the direct path: the traced window less
the device's busy time, over the queries answered in it.  What the SQL
endpoint and Phase 2 cost on the host, until the program's
own spans split it."""

LAYER = ("host path: SQL endpoint and Phase 2 on the host (serve/retrieval.py, "
         "core/materializer.py, core/grammar.py, core/vectorcache.py)")
MOVES = "query_p50_ms"
SOURCE = "device_trace"


def read(ctx):
    t = ctx.trace
    if not t or not t["busy_s"] or not ctx.completed:
        return None
    return (t["window_s"] - t["busy_s"]) / ctx.completed * 1e3
