"""Kernel launches a query on the direct path: the change in the three
kernels' ``launches`` counters over the window, over the queries
answered in it."""

LAYER = "HopperBackend (core/backends.py)"
MOVES = "query_p50_ms"
SOURCE = "program_counter"

OPS = ("pem_score", "topk", "mmr")


def read(ctx):
    launches = sum(ctx.delta.get(op, 0) for op in OPS)
    if not launches or not ctx.completed:
        return None
    return launches / ctx.completed
