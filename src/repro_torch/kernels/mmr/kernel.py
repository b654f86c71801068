"""ctypes binding of ``csrc/mmr.cu`` and the launch's shape.

:func:`plan` chooses the shape from (B, n, d) and the card's figures, in
one place, so the CPU tests can hold it to the H100's: each query a
cluster of C CTAs, one CTA an SM, C the widest power of two up to
``MAX_CLUSTER`` whose clusters the card keeps resident B at once (one
wave), and no narrower than the per-slot state needs; each CTA keeps its
share of the live rows on chip (one a thread in registers for d <= 128,
then in the shared memory that its state and buffers leave) and reads any
beyond from global memory.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
NO_CLUSTER = -1  # flexvec_mmr's code when no cluster of its shape fits

THREADS = 384       # a CTA with register rows: 12 warps, a row a thread
MAX_CLUSTER = 16    # the widest cluster plan() picks (non-portable)
STATE_BYTES = 12    # a slot's state: rel, max_sim, slot
CLUSTERS = (1, 2, 4, 8, 16)
#: the H100 SXM's figures (227 KB a CTA may opt into, the kernels'
#: static shared memory, and the clusters of each size the card keeps
#: resident at one CTA an SM, cudaOccupancyMaxActiveClusters on its 132
#: SMs), for the CPU tests
H100 = dict(smem_optin=232_448, static_smem=6_208,
            resident={1: 132, 2: 66, 4: 30, 8: 15, 16: 7})


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load()
    lib.flexvec_mmr.argtypes = [_P, _P, _P] + [_I] * 7 + [_P, _P, _P]
    lib.flexvec_mmr.restype = _I
    lib.flexvec_mmr_limits.argtypes = [ctypes.POINTER(_I)] * 2
    lib.flexvec_mmr_limits.restype = _I
    lib.flexvec_mmr_occupancy.argtypes = [_I] * 5 + [ctypes.POINTER(_I)]
    lib.flexvec_mmr_occupancy.restype = _I
    lib.flexvec_cluster_sync_probe.argtypes = [_I] * 5 + [_P, _P]
    lib.flexvec_cluster_sync_probe.restype = _I
    return lib


def plan(b: int, n: int, d: int, *, smem_optin: int, static_smem: int,
         resident: Dict[int, int],
         live: Optional[int] = None,
         cluster: Optional[int] = None) -> Dict[str, int]:
    """The launch's shape for b queries over an (n, d) pool (d % 4 == 0)
    on a card with ``smem_optin`` bytes of shared memory a CTA and
    ``resident[C]`` clusters of C CTAs resident at once:
    ``cluster`` (given, or chosen), rows a CTA keeps in registers (one a
    thread, only where its share of the slots does not fit in shared
    memory) and in shared memory, the shared memory a CTA takes, the
    waves, and, for ``live`` live slots a query (default n, dealt evenly),
    the rows a CTA reads from global memory each step."""
    d4 = -(-d // 4)
    row = 16 * (d4 + 1)
    avail = smem_optin - static_smem - 2 * d4 * 16  # less E[j], twice
    c_min = 1  # the per-slot state takes at most half the shared memory
    while STATE_BYTES * -(-n // c_min) > avail // 2:
        c_min *= 2
    if c_min > CLUSTERS[-1]:
        raise ValueError(f"mmr: a pool of {n} slots needs a cluster of "
                         f"{c_min} CTAs, above {CLUSTERS[-1]}")
    if cluster is None:
        cluster = MAX_CLUSTER
        while cluster > c_min and b > resident[cluster]:
            cluster //= 2
    lmax = -(-n // cluster)
    reg = THREADS if d <= 128 and lmax * row > avail - STATE_BYTES * lmax else 0
    smem_rows = max(0, min(lmax - reg, (avail - STATE_BYTES * lmax) // row))
    share = -(-(n if live is None else live) // cluster)
    return {"cluster": cluster, "reg_rows": reg, "smem_rows": smem_rows,
            "smem_bytes": smem_optin - static_smem - avail + row * smem_rows
            + STATE_BYTES * lmax,
            "waves": -(-b // resident[cluster]),
            "global_rows": max(0, share - reg - smem_rows)}


@functools.lru_cache(maxsize=None)
def limits() -> Dict[str, object]:
    """The current card's figures :func:`plan` takes (clusters resident
    at once at the kernel's one CTA an SM)."""
    out = [_I() for _ in range(2)]
    _build.check(_lib().flexvec_mmr_limits(*[ctypes.byref(x) for x in out]),
                 "mmr")
    lim = dict(zip(("smem_optin", "static_smem"), (x.value for x in out)))
    lim["resident"] = {c: _occupancy(128, 128, c, THREADS, 0)
                       for c in CLUSTERS}
    return lim


def _occupancy(n: int, d: int, cluster: int, reg: int,
               smem_rows: int) -> int:
    out = _I()
    _build.check(_lib().flexvec_mmr_occupancy(n, d, cluster, int(reg > 0),
                                              smem_rows, ctypes.byref(out)),
                 "mmr")
    return out.value


def shape(b: int, n: int, d: int, live: Optional[int] = None,
          cluster: Optional[int] = None) -> Dict[str, int]:
    """:func:`plan` on the current card, with
    ``cudaOccupancyMaxActiveClusters`` for its launch."""
    p = plan(b, n, d, live=live, cluster=cluster, **limits())
    p["max_active_clusters"] = _occupancy(n, d, p["cluster"], p["reg_rows"],
                                          p["smem_rows"])
    return p


def launch(embeds: torch.Tensor, rel: torch.Tensor, lam: torch.Tensor,
           k: int, idx: torch.Tensor, val: torch.Tensor,
           cluster: Optional[int] = None) -> None:
    """Enqueue one selection launch on the current stream at
    :func:`plan`'s shape (``cluster`` overrides its width).  Arguments are
    validated by :func:`repro_torch.kernels.mmr.ops.mmr_select`."""
    b, n, d = embeds.shape
    with torch.cuda.device(embeds.device):  # the launch's current device
        p = plan(b, n, d, cluster=cluster, **limits())
        err = _lib().flexvec_mmr(embeds.data_ptr(), rel.data_ptr(),
                                 lam.data_ptr(), b, n, d, k, p["cluster"],
                                 int(p["reg_rows"] > 0), p["smem_rows"],
                                 idx.data_ptr(), val.data_ptr(),
                                 _build.stream_ptr(embeds.device))
    if err == NO_CLUSTER:
        raise RuntimeError(f"mmr: cudaOccupancyMaxActiveClusters is 0 for "
                           f"{p['cluster']}-CTA clusters over a ({n}, {d}) "
                           f"pool")
    _build.check(err, "mmr")


#: the probe's exchanges: a cluster barrier; one and a read of the next
#: CTA's shared memory; mbarriers (every warp stores into and arrives on
#: every CTA's barrier with release semantics, then waits on its own);
#: the same words by st.async, completing bytes on the receiver's barrier
PROBE_MODES = ("cluster barrier", "cluster barrier + remote read",
               "mbarrier exchange", "st.async exchange")


def cluster_sync_probe(cluster: int, clusters: int, threads: int,
                       iters: int, mode: int, out: torch.Tensor) -> None:
    """Enqueue ``iters`` exchanges (``PROBE_MODES[mode]``) in each of
    ``clusters`` clusters of ``cluster`` CTAs of ``threads`` threads, one
    CTA an SM.  ``out``: ``cluster * clusters`` int32 on the card."""
    with torch.cuda.device(out.device):
        err = _lib().flexvec_cluster_sync_probe(
            cluster, clusters, threads, iters, mode, out.data_ptr(),
            _build.stream_ptr(out.device))
    _build.check(err, "cluster_sync_probe")
