"""K3 ``mmr`` on the direct path: the sum of its launches' bounds over its
device time.  Each launch selects ``k`` of one query's ``live`` pool
rows (``shapes["mmr"]``)."""

from harness import roofline
from harness.trace import device_seconds

LAYER = "kernel kernels/mmr (csrc/mmr.cu)"
MOVES = "query_p50_ms"
SOURCE = "device_trace"

KERNELS = ("mmr_kernel",)


def read(ctx):
    t = device_seconds(ctx.trace, KERNELS)
    launches = ctx.delta.get("mmr", 0)
    shape = ctx.shapes.get("mmr")
    if not t or not launches or not shape:
        return None
    work = roofline.mmr_work(1, shape["live"], shape["k"], ctx.shapes["d"],
                             shape["bucket"]).scaled(launches)
    return 100.0 * roofline.bound_s(work) / t
