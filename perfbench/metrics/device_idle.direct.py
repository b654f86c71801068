"""The device's idle share on the direct path: 1 less the union of every
kernel, copy and memset interval over the traced window."""

LAYER = "device"
MOVES = "query_p50_ms"
SOURCE = "device_trace"


def read(ctx):
    t = ctx.trace
    if not t or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
