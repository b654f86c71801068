"""Device milliseconds a query on the direct path: the device's busy time
over the traced window (the union of every kernel, copy and memset
interval), over the queries answered in it.  The host's speed, which
moves the latencies from run to run, does not enter it."""

LAYER = "device"
MOVES = "query_p50_ms"
SOURCE = "device_trace"


def read(ctx):
    t = ctx.trace
    if not t or not t["busy_s"] or not ctx.completed:
        return None
    return t["busy_s"] / ctx.completed * 1e3
