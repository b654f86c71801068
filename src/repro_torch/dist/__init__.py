"""Distributed retrieval: sharded PEM top-k and cross-process shard groups.

``pem_sharded`` is the two-stage (local top-k + union merge) distributed
retrieval path over a ``torch.distributed`` process group: each rank
scores its own contiguous block of corpus rows with the Hopper kernels,
selects a LOCAL top-k, and only the candidate union crosses the
interconnect.  ``procgroup`` is the cross-PROCESS axis — per-shard
segmented stores behind a shard-replica router, each shard scoring on
its own card, merged with the same exact-union contract (the
million-chunk serving topology).
"""
