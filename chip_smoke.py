#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one card.

    python3 chip_smoke.py [--seed S]

Needs one NVIDIA card (sm_90a, an H100) and the CUDA toolkit; exits non-zero
with no result line anywhere else.  Imports nothing of JAX or of the
reference package.  Prints one JSON object per line, in order:

1. the device, then nvidia-smi's name and power limit on a line of its own;
2. the kernel build: seconds, each kernel's registers, shared memory and
   spills, the MMR launch's cluster shape with
   cudaOccupancyMaxActiveClusters, and pem_score's launch shape;
3. each kernel against its plain PyTorch version on the card at the main
   path's shapes (max error or exact index equality, the kernel's time,
   the plain version's, one library call's where one computes the same
   function, and the bound from the shapes); pem_score at 240k and
   1,000,448 rows, f32 and bf16, B = 1 and 32 (its bound both by bytes
   and by split-TF32 operations, one call's per-launch profile), and a
   batch over five half-lives in one launch timed beside the grouped
   chain of five; top-k also on adversarial
   rows at full size (masked, 100 live, constant, 64 levels, signed zeros
   at the boundary), MMR also on a pool larger than a cluster's shared
   memory, each MMR row with its time per step and cluster size;
4. the main path at the paper's production size: 240k chunks through
   SQLite into ``RetrievalService`` on ``HopperBackend("cuda")``, the
   composed query through ``flex_search``, then 64 requests from 32
   threads through ``BatchedRetrievalEngine`` and 8 over mixed
   half-lives (one pem_score launch a batch); every ranking held against
   the ``fused-numpy`` oracle on the same store;
   then the same service with ``shard_group(4)`` (thread workers on the
   card): the composed query through ``flex_search`` and the 64 requests,
   both fanned out to the group by the attached engine;
5. the 1M phase: 1,000,448 seeded chunks in four segments with tombstones
   through ``store_from_arrays``, two composed queries against the oracle;
6. ``sharded_1m``: the same store through ``ShardedBackend`` (four shards
   on one card, or one a card where there are four): ids equal to the
   monolithic ``HopperBackend``'s, rankings to the oracle's, no diverse
   pool on the host;
7. ``pem_sharded``: ``make_pem_topk`` in a one-rank NCCL group at
   1,000,448 x 128, B = 32, k = 500 against ``pem_topk_reference``, and
   four in-process shards of the same rows merged shard-major, bit-equal
   to the one rank;
8. ``shard_group_1m``: ``ProcessGroup`` over the same rows, four shards:
   spawned workers in f32, then thread workers in f32, f32b and bf16
   (f32 against the oracle, f32b and bf16 by their top-100 overlap);
9. ``flexvec_arch``: the flexvec architecture entry
   (``configs.get_arch("flexvec")``, built on ``make_local_mesh()``) at
   its corpus_240k and corpus_1m cells, B = 64, MMR 500 of 1500, f32 and
   bf16, one-stage and two-stage (a one-rank NCCL group): each kernel
   against its plain version on the step's inputs, the step against the
   plain step, two-stage bit-equal to one-stage; step and kernel times,
   bounds from the shared count, launches, K3's waves, peak memory;
10. ``torch_engine`` (run before the 1M store is dropped, so it comes
    after ``shard_group_1m``): ``TorchBackend``, the same chain as plain
    PyTorch library calls, over the main path's 240k corpus (a service on
    its SQLite connection) and the 1M store: the composed query through
    ``flex_search`` cold and warm, the 64 engine requests, the two 1M
    queries, each time beside HopperBackend's, rankings against the
    oracle, its ``plan_cache`` stats, and no kernel launched;
11. ``behavioral``: the paper's §4.4 suite (Tables 5-6) on the four
    BEIR-like datasets at their published sizes (3,633-57,638 rows), 180
    searches each on ``HopperBackend`` against fused-numpy: ids, scores,
    the figures at their printed precision, K3 on every diverse search,
    ms per search, each dataset's generator seed; then each kernel alone
    on a search's inputs at fiqa-like's 57,638 x 128 (K1 at B = 1, K2 at
    K = 512 and 2,048, K3 500 of 1,500) beside its plain version, its
    library call and its bound;
12. ``lm``: the LM family at internlm2-1.8b's and granite-moe-1b-a400m's
    published widths, seeded weights (no kernel of the port's runs
    here): ``LMDecodeEngine`` serving 8 requests (64-512 prompt tokens,
    32 new) through 4 slots, max_ctx 2048, in f32 with TF32 off, each
    request's tokens equal to the sequential ``prefill_step`` +
    ``decode_step`` but for printed near-ties, then in bf16 (prefill
    logits' largest error against f32, top-1 agreement); prefill ms,
    decode tokens/s, one decode step's host and device ms and launches,
    peak memory.  Then the launcher's ``Trainer``: internlm2-1.8b in
    bf16, remat full, 4 x 1024, 6 AdamW steps, a checkpoint at step 3
    and a second trainer resumed from it ending bit-equal to the
    uninterrupted run under ``torch.use_deterministic_algorithms``, the
    loss falling; step ms, mfu (model flops over step time x 989
    TFLOP/s), the step split into gradients and AdamW; granite-moe 3
    steps with a finite loss;
13. ``recsys_gnn``: the GNN and recsys families at their published
    widths, weights and data seeded from ``--seed``.  two-tower-retrieval
    (12.9 GB of f32 tables): ``retrieval_cand`` through the arch's spec
    (the user tower, K1 over the item tower's 1,000,000 x 256 vectors with
    decay:30, K2 for 1,500, the pool's rows, K3 for 500), one K1, six K2
    and one K3 launch, held against ``pem_serve_step_plain`` (ids equal but
    for adjacent near-tie swaps, counted and printed; scores within 1e-5),
    then each kernel alone on its inputs beside its plain version, library
    call and bound; ``serve_p99`` (the user tower at 512 within 1e-4 of
    f64); 3 AdamW steps at batch 16,384 (train_batch's 65,536 cut: the
    in-batch logits grow as B^2) on the full tables.  bst and autoint:
    serve_p99 and serve_bulk forwards within 1e-4 of f64, 3 steps at
    65,536.  PNA: minibatch_lg (Reddit-scale source graph and its CSR on
    the host, 3 steps each on a fresh 1,024-seed subgraph at fanout
    15-10), full_graph_sm and molecule, 5 steps each, forwards against
    f64; then ogb_products (2,449,408 x 61,859,328 padded, built on the
    host from ``--seed``) through the edge-chunked path: on a 4M-edge
    subgraph the chunked path against the whole-edge path (loss, logits,
    every gradient), the whole graph's forward against f64 (its device
    time by kernel), 3 steps, with the chunk count, graph seconds and the
    card's name and power limit.  Every loss finite and falling; step ms and peak GB;
14. the ``kernels`` line (launch counts from the main path's run, and
    each path's own run beside them);
15. ``{"ok": true, "device": {...}}``, the last line.

Any failure raises.  Rankings must equal the oracle's id for id, scores
agree to 1e-5; a candidate pool must equal the oracle's as a set except
for members within 1e-5 of the boundary score, which are printed.
"""

from __future__ import annotations

import concurrent.futures as cf
import gc
import json
import os
import re
import sqlite3
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# cuBLAS is deterministic only with a fixed workspace; the lm phase's
# resumed training run must end bit-equal to the uninterrupted one
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

NOW = 1_770_000_000.0
TOL = 1e-5
TOKENS = (
    "similar:how the system works architecture "
    "suppress:website landing page design "
    "from:prototype sketch to:production deployment "
    "decay:30 diverse pool:500"
)
SCALE1M_TOKENS = (
    "similar:how the system works architecture "
    "suppress:website landing page design "
    "decay:30 pool:500"
)
SCALE1M_DIVERSE_TOKENS = SCALE1M_TOKENS + " diverse"
SCALE1M_N = 1_000_448
MAIN_N = 240_000         # the paper's production corpus
MAIN_SESSIONS = 4_800    # as launch/serve.py sizes it: chunks // 50
DEVICE = "cuda"          # the phases' device ("cpu" rehearses them on the
#                          kernels' plain versions, at a small MAIN_N)
TOPICS = ["server lifecycle", "identity provenance", "rendering pipeline",
          "auth token", "database migration"]
# engine requests over mixed half-lives (and none), after the 64 decay:30
MIXED_REQUESTS = [f"similar:{TOPICS[i % len(TOPICS)]} {mod}".strip()
                  for i, mod in enumerate(
                      ("decay:7", "decay:14", "decay:30", "decay:90", "",
                       "decay:7 diverse", "decay:30 diverse", "diverse"))]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(work):
    """A kernel's least time on the card: its bytes over the HBM rate or
    its operations over their peak, whichever is larger, and which one it
    is.  ``work`` comes from the one count of each kernel's work
    (``repro_torch/configs/flexvec.py``) and the H100's published figures
    (``repro_torch/roofline/analysis.py``), which the dry run reads too."""
    from repro_torch.roofline.analysis import HW

    return HW.bound_s(work) * 1e3, HW.bound_by(work)


def time_ms(torch, fn, iters: int) -> float:
    """Mean device time of one call: CUDA events around ``iters`` calls,
    after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def traced_us(torch, fn, reps: int):
    """``fn()`` ``reps`` times under torch.profiler's CUDA trace: the last
    call's result and the device microseconds a call spends in each
    kernel (and memset)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            res = fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_time_total > 0:
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0]  # kernels that share it add up
            out[name] = out.get(name, 0.0) + ev.device_time_total / reps
    return res, out


def launch_breakdown(torch, fn, reps: int = 10) -> dict:
    """Device microseconds a warm call of ``fn`` spends in each kernel
    (and memset), traced over ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    return traced_us(torch, fn, reps)[1]


def check_ranking(name, got, want, tol=TOL) -> list:
    """Final ranked (id, score) lists: ids equal, scores within tol.

    One exception: two neighbours may trade places.  The card sums in f32
    in another order than the numpy oracle (f64 MMR blend), so where two
    candidates tie or nearly tie, either order is the greedy answer (the
    oracle itself meets exact ties on this data).  Such swaps are returned
    so the caller prints them; anything else fails."""
    gi = [int(i) for i, _ in got]
    wi = [int(i) for i, _ in want]
    if len(gi) != len(wi):
        raise AssertionError(f"{name}: {len(gi)} results, oracle {len(wi)}")
    swaps, p = [], 0
    while p < len(gi):
        if gi[p] == wi[p]:
            p += 1
            continue
        if (p + 1 < len(gi) and gi[p] == wi[p + 1]
                and gi[p + 1] == wi[p]):
            swaps.append({"position": p, "ids": [wi[p], wi[p + 1]],
                          "scores": [float(want[p][1]),
                                     float(want[p + 1][1])]})
            p += 2
            continue
        raise AssertionError(
            f"{name}: ranking differs from the oracle at position {p} "
            f"(got {gi[p:p + 5]}, oracle {wi[p:p + 5]})")
    score = {i: float(v) for i, v in want}
    err = max((abs(float(v) - score[int(i)]) for i, v in got), default=0.0)
    if err > tol:
        raise AssertionError(f"{name}: scores differ by {err} > {tol}")
    return swaps


def check_pool(name, got, want, tol=TOL) -> dict:
    """A candidate pool (rows, scores) against the oracle's: equal as a set
    except members within tol of the boundary score."""
    (gi, gv), (wi, wv) = got, want
    if gi.shape != wi.shape:
        raise AssertionError(f"{name}: pool sizes {gi.shape} vs {wi.shape}")
    err = float(np.max(np.abs(gv - wv))) if gv.size else 0.0
    boundary = float(wv[-1]) if wv.size else 0.0
    extra = sorted(set(gi.tolist()) - set(wi.tolist()))
    missing = sorted(set(wi.tolist()) - set(gi.tolist()))
    g_score = dict(zip(gi.tolist(), gv.tolist()))
    w_score = dict(zip(wi.tolist(), wv.tolist()))
    near = ([(r, g_score[r]) for r in extra]
            + [(r, w_score[r]) for r in missing])
    far = [(r, s) for r, s in near if abs(s - boundary) > tol]
    if err > tol or far:
        raise AssertionError(f"{name}: pool differs (max score error {err}, "
                             f"members off the boundary {far[:5]})")
    return {"pool": int(gi.size), "max_abs_err": err,
            "boundary_near_ties": near}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def _smi() -> str:
    """nvidia-smi's name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def phase_device(torch) -> str:
    name = torch.cuda.get_device_name(0)
    smi = _smi()
    emit({"phase": "device", "name": name,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    print(smi, flush=True)
    return name


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load()
    kernels = {}
    for src, text in _build.build_info["ptxas"].items():
        for fn, body in re.findall(
                r"Compiling entry function '(\S+)'.*?\n(.*?Used[^\n]*)",
                text, flags=re.S):
            regs = re.search(r"Used (\d+) registers", body)
            smem = re.search(r"(\d+) bytes smem", body)
            spill = re.search(r"(\d+) bytes spill stores", body)
            kernels[fn] = {"source": src,
                           "registers": int(regs.group(1)) if regs else None,
                           "static_smem": int(smem.group(1)) if smem else 0,
                           "spill_stores": int(spill.group(1)) if spill else 0}
    from repro_torch.kernels.mmr import kernel as mmr_kernel

    # the MMR launch's cluster shape at the main path's pool and at a pool
    # larger than a cluster's shared memory holds
    mmr_shapes = {f"n={n},d=128": mmr_kernel.shape(n, 128)
                  for n in (2048, 8192)}
    from repro_torch.kernels.pem_score import kernel as pem_kernel

    # K1's launch (product width, query chunks, ring stages, resident or
    # restaged query, grid, shared memory) at the main path's widths
    pem_shapes = {f"n={MAIN_N},b={b},{dt}": pem_kernel.plan(
        MAIN_N, 128, b, dt == "bf16")
        for b, dt in ((1, "f32"), (32, "f32"), (32, "bf16"), (130, "f32"))}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_info["seconds"],
          "library": _build.build_info["path"], "kernels": kernels,
          "mmr_cluster": mmr_shapes, "pem_score_launch": pem_shapes})


def pem_bound(n: int, d: int, b: int, esize: int) -> dict:
    """K1's least time (``pem_score_work``): the bytes (corpus, queries,
    the (N,) decay or ages, the (N, B) panel) over the HBM rate, against
    the split-TF32 products (three for an f32 corpus, two for bf16:
    2 * N * d * 2B operations each) over the TF32 peak; beside it, the
    4 * N * d * B f32 operations on the CUDA cores that the kernel no
    longer runs."""
    from repro_torch.configs.flexvec import pem_score_work
    from repro_torch.roofline.analysis import HW

    work = pem_score_work(n, d, b, esize)
    t, by = bound_ms(work)
    return {"bound_ms": t, "bound_by": by,
            "bound_bytes_ms": HW.bytes_s(work) * 1e3,
            "bound_tf32_ms": HW.ops_s(work) * 1e3,
            "f32_cuda_core_ms": work.flops / HW.f32_flops * 1e3}


def phase_pem_score(torch) -> dict:
    from repro_torch.kernels.pem_score import kernel as pem_kernel
    from repro_torch.kernels.pem_score.ops import pem_score
    from repro_torch.kernels.pem_score.ref import pem_score_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    d = 128
    rows = {}
    for n in (MAIN_N, SCALE1M_N):
        base = torch.randn(n, d, generator=gen, device=dev)
        base /= base.norm(dim=1, keepdim=True)
        decay = 1.0 / (1.0 + torch.rand(n, generator=gen, device=dev) * 10)
        for dtype, tol in ((torch.float32, TOL), (torch.bfloat16, 2e-2)):
            m = base.to(dtype)
            for b in (1, 32):
                qp = torch.randn(d, b, generator=gen, device=dev) / d ** 0.5
                qs = torch.randn(d, b, generator=gen, device=dev) * 0.1
                panel = torch.empty((b, n), device=dev)
                got = pem_score(m, qp, qs, decay, out=panel.T)
                want = pem_score_ref(m, qp, qs, decay)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if not err <= tol:
                    raise AssertionError(
                        f"pem_score n={n} b={b} {dtype}: max error {err}")
                iters = 20 if n > 500_000 else 50
                ms = time_ms(torch, lambda: pem_score(m, qp, qs, decay,
                                                      out=panel.T), iters)
                plain = time_ms(torch, lambda: pem_score_ref(m, qp, qs, decay),
                                iters)
                qcat = torch.cat([qp, qs], dim=1)

                def library():
                    # one f32 product (a bf16 corpus widened first: the
                    # library has no bf16 x f32 product) and its epilogue
                    both = torch.matmul(m if m.dtype == torch.float32
                                        else m.float(), qcat)
                    return decay[:, None] * both[:, :b] + both[:, b:]

                lib = time_ms(torch, library, iters)
                row = {"phase": "kernel", "name": "pem_score", "n": n, "d": d,
                       "b": b, "dtype": str(dtype).split(".")[-1],
                       "max_abs_err": err, "tol": tol, "ms": ms,
                       "plain_ms": plain, "library_ms": lib,
                       **pem_bound(n, d, b, m.element_size()),
                       "launch": pem_kernel.plan(n, d, b,
                                                 dtype == torch.bfloat16)}
                if n == MAIN_N and b == 32 and dtype == torch.float32:
                    row["per_launch_us"] = launch_breakdown(
                        torch, lambda: pem_score(m, qp, qs, decay,
                                                 out=panel.T))
                emit(row)
                rows[(n, b, row["dtype"])] = row
        del base, m
    rows["mixed"] = pem_mixed_half_lives(torch, gen)
    return rows


def pem_mixed_half_lives(torch, gen) -> dict:
    """An engine batch's scoring: 240k x 128 f32, 32 plans over the
    half-lives 7, 14, 30, 90 and none, in one launch (per-plan factors
    from the rows' ages) against the plain version, timed beside the
    grouped chain that scored such a batch before (one launch per
    half-life into the panel's rows, then a gather back to plan order;
    its decay columns precomputed on the card, so the chain is timed
    without the host work it also did)."""
    from repro_torch.kernels.pem_score.ops import pem_score
    from repro_torch.kernels.pem_score.ref import (decay_factors,
                                                   pem_score_days_ref)

    dev = torch.device("cuda")
    n, d, b = MAIN_N, 128, 32
    m = torch.randn(n, d, generator=gen, device=dev)
    m /= m.norm(dim=1, keepdim=True)
    qp = torch.randn(d, b, generator=gen, device=dev) / d ** 0.5
    qs = torch.randn(d, b, generator=gen, device=dev) * 0.1
    days = torch.rand(n, generator=gen, device=dev) * 180
    levels = [7.0, 14.0, 30.0, 90.0, float("inf")]
    hl = torch.tensor([levels[j % 5] for j in range(b)], device=dev)
    panel = torch.empty((b, n), device=dev)
    before = pem_score.launches
    got = pem_score(m, qp, qs, days_ago=days, half_lives=hl, out=panel.T)
    launches = pem_score.launches - before
    want = pem_score_days_ref(m, qp, qs, days, hl)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err <= TOL or launches != 1:
        raise AssertionError(f"pem_score mixed half-lives: max error {err}, "
                             f"{launches} launches")
    groups = [[j for j in range(b) if j % 5 == i] for i in range(5)]
    order = [j for cols in groups for j in cols]
    perm = torch.argsort(torch.tensor(order, device=dev))
    parts = [(qp[:, cols].contiguous(), qs[:, cols].contiguous(),
              None if levels[i] == float("inf")
              else decay_factors(days, hl[cols[:1]])[:, 0].contiguous())
             for i, cols in enumerate(groups)]

    def grouped():
        out = torch.empty((b, n), device=dev)
        r = 0
        for (p, s, dec), cols in zip(parts, groups):
            pem_score(m, p, s, dec, out=out[r:r + len(cols)].T)
            r += len(cols)
        return out[perm]

    chain = grouped()
    torch.cuda.synchronize()
    chain_err = float((chain.T - want).abs().max())
    if not chain_err <= TOL:
        raise AssertionError(f"grouped chain: max error {chain_err}")
    qcat = torch.cat([qp, qs], dim=1)

    def library():
        both = torch.matmul(m, qcat)
        return decay_factors(days, hl) * both[:, :b] + both[:, b:]

    ms = time_ms(torch, lambda: pem_score(m, qp, qs, days_ago=days,
                                          half_lives=hl, out=panel.T), 50)
    row = {"phase": "kernel", "name": "pem_score", "case": "mixed half-lives",
           "n": n, "d": d, "b": b, "half_lives": levels, "dtype": "float32",
           "launches": launches, "max_abs_err": err, "tol": TOL, "ms": ms,
           "grouped_chain_ms": time_ms(torch, grouped, 50),
           "grouped_chain_launches": len(groups),
           "plain_ms": time_ms(torch, lambda: pem_score_days_ref(
               m, qp, qs, days, hl), 50),
           "library_ms": time_ms(torch, library, 50),
           **pem_bound(n, d, b, 4)}
    emit(row)
    return row


ADVERSARIAL = ("masked", "100 live", "constant", "64 levels", "signed zeros",
               "random")


def adversarial_panel(torch, gen, b, n, k):
    """(b, n) rows cycling through ``ADVERSARIAL``: a fully masked row; 100
    live entries, the rest -inf; a constant row; values on 64 levels, so
    thousands of ties straddle the k-th key; k/2 positives, then +0.0 and
    -0.0 so that the k-th key is the 7th -0.0 (shuffled); and a random row
    with a tombstone every 50 columns."""
    dev = torch.device("cuda")
    s = torch.empty((b, n), device=dev)
    half = min(k // 2, n // 4)
    plus = max(k - half - 7, 0)
    for r in range(b):
        kind = ADVERSARIAL[r % len(ADVERSARIAL)]
        row = s[r]
        if kind == "masked":
            row.fill_(float("-inf"))
        elif kind == "100 live":
            row.fill_(float("-inf"))
            row[torch.randperm(n, generator=gen, device=dev)[:100]] = \
                torch.randn(100, generator=gen, device=dev)
        elif kind == "constant":
            row.fill_(0.5)
        elif kind == "64 levels":
            row.copy_(torch.floor(torch.rand(n, generator=gen, device=dev)
                                  * 64) / 64)
        elif kind == "signed zeros":
            row.fill_(-1.0)
            row[:half] = torch.rand(half, generator=gen, device=dev) + 0.1
            row[half:half + plus] = 0.0
            row[half + plus:3 * half] = -0.0
            row.copy_(row[torch.randperm(n, generator=gen, device=dev)])
        else:
            row.copy_(torch.randn(n, generator=gen, device=dev))
            row[::50] = float("-inf")
    return s


def phase_topk(torch) -> dict:
    from repro_torch.configs.flexvec import topk_work
    from repro_torch.kernels.topk.ops import topk
    from repro_torch.kernels.topk.ref import topk_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = {}
    for b, n, k in ((32, 240_000, 2048), (1, 240_000, 2048),
                    (1, SCALE1M_N, 2048)):
        s = torch.randn(b, n, generator=gen, device=dev)
        s[:, ::50] = float("-inf")  # tombstoned rows ride along as -inf
        v, i = topk(s, k)
        vr, ir = topk_ref(s, k)
        torch.cuda.synchronize()
        exact = bool(torch.equal(i, ir) and torch.equal(v, vr))
        if not exact:
            raise AssertionError(f"topk b={b} n={n} k={k}: differs from "
                                 f"the plain version")
        ms = time_ms(torch, lambda: topk(s, k), 50)
        plain = time_ms(torch, lambda: topk_ref(s, k), 10)
        lib = time_ms(torch, lambda: torch.topk(s, k, dim=1), 50)
        t, by = bound_ms(topk_work(b, n, k))
        row = {"phase": "kernel", "name": "topk", "b": b, "n": n, "k": k,
               "exact": exact, "max_abs_err": 0.0, "ms": ms,
               "plain_ms": plain, "library_ms": lib, "bound_ms": t,
               "bound_by": by,
               # one read of the panel by a library reduction, for scale
               "panel_sum_ms": time_ms(torch, lambda: s.sum(dim=1), 50),
               "per_launch_us": launch_breakdown(torch, lambda: topk(s, k))}
        emit(row)
        rows[(b, n, k)] = row
    # adversarial rows at the main path's full size, each held exactly
    b, n, k = 32, 240_000, 2048
    adv = adversarial_panel(torch, gen, b, n, k)
    v, i = topk(adv, k)
    vr, ir = topk_ref(adv, k)
    torch.cuda.synchronize()
    bad = [ADVERSARIAL[r % len(ADVERSARIAL)] for r in range(b)
           if not (torch.equal(i[r], ir[r]) and torch.equal(v[r], vr[r]))]
    if bad:
        raise AssertionError(f"topk adversarial rows differ: {sorted(set(bad))}")
    emit({"phase": "kernel", "name": "topk", "case": "adversarial", "b": b,
          "n": n, "k": k, "rows": list(ADVERSARIAL), "exact": True,
          "ms": time_ms(torch, lambda: topk(adv, k), 50),
          "library_ms": time_ms(torch, lambda: torch.topk(adv, k, dim=1),
                                50)})
    # ties, -inf padding, masked rows and signed zeros
    tie = torch.tensor([-1.0, 3.0, 3.0, -5.0, 0.0, -0.0, float("-inf")],
                       device=dev).repeat(8, 5000)
    tie[1] = float("-inf")
    tie[2, 100:] = float("-inf")
    for k in (10, 2048):
        v, i = topk(tie, k)
        vr, ir = topk_ref(tie, k)
        torch.cuda.synchronize()
        if not (torch.equal(i, ir) and torch.equal(v, vr)):
            raise AssertionError(f"topk ties k={k}: differs from plain")
        if any(len(set(r.tolist())) != k for r in i.cpu()):
            raise AssertionError(f"topk ties k={k}: an index twice")
    emit({"phase": "kernel", "name": "topk", "case": "ties/-inf/-0.0",
          "exact": True})
    return rows


def phase_mmr(torch) -> dict:
    from repro_torch.configs.flexvec import mmr_work
    from repro_torch.kernels.mmr import kernel as mmr_kernel
    from repro_torch.kernels.mmr.ops import NEG, mmr_select
    from repro_torch.kernels.mmr.ref import mmr_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    d = 128
    rows = {}
    # (b, k, bucket, live, lambdas): the direct path, the batched path, the
    # three lambdas, and a pool larger than a cluster's shared memory holds
    # (its rows past that are read from global memory)
    cases = ((1, 500, 2048, 1500, (0.7,)), (32, 10, 2048, 1500, (0.7,)),
             (4, 500, 2048, 1500, (0.7, 0.0, 1.0)),
             (2, 100, 8192, 6000, (0.7, 0.0, 1.0)))
    for b, k, bucket, pool, lams in cases:
        shape = mmr_kernel.shape(bucket, d)
        e = torch.randn(b, bucket, d, generator=gen, device=dev)
        e /= e.norm(dim=-1, keepdim=True)
        rel = torch.randn(b, bucket, generator=gen, device=dev) * 0.1
        rel[:, pool:] = NEG
        for lam in lams:
            lam_t = torch.full((b,), lam, device=dev)
            idx, val = mmr_select(e, rel, k, lam_t)
            ir, vr = mmr_ref(e, rel, k, lam_t)
            torch.cuda.synchronize()
            exact = bool(torch.equal(idx, ir))
            err = float((val - vr).abs().max())
            if not exact or err > TOL or int(idx.max()) >= pool:
                raise AssertionError(f"mmr b={b} n={bucket} k={k} lam={lam}: "
                                     f"indices equal {exact}, value error "
                                     f"{err}")
            ms = time_ms(torch, lambda: mmr_select(e, rel, k, lam_t), 10)
            row = {"phase": "kernel", "name": "mmr", "b": b, "n": bucket,
                   "live": pool, "d": d, "k": k, "lam": lam, "exact": exact,
                   "max_abs_err": err, "ms": ms, "ms_per_step": ms / k,
                   "cluster": shape["cluster"],
                   "rows_in_smem_per_cta": shape["rows_in_smem"],
                   "global_rows": max(0, pool - shape["cluster"]
                                      * shape["rows_in_smem"])}
            if lam == 0.7 and bucket == 2048 and b != 4:
                row["plain_ms"] = time_ms(
                    torch, lambda: mmr_ref(e, rel, k, lam_t), 2)
                row["library_ms"] = None
                # the k dependent steps bound it in practice; the formula's
                # floor is the live pool and rel read once, the picks
                # written, or the k * live * d similarity products
                t, by = bound_ms(mmr_work(b, pool, k, d, bucket))
                row.update(bound_ms=t, bound_by=by)
                rows[(b, k)] = row
            emit(row)
    return rows


def _counts():
    from repro_torch.kernels.mmr.ops import mmr_select
    from repro_torch.kernels.pem_score.ops import pem_score
    from repro_torch.kernels.topk.ops import topk

    return {"pem_score": pem_score.launches, "topk": topk.launches,
            "mmr": mmr_select.launches}


def _reset_counts() -> None:
    from repro_torch.kernels.mmr.ops import mmr_select
    from repro_torch.kernels.pem_score.ops import pem_score
    from repro_torch.kernels.topk.ops import topk

    pem_score.launches = topk.launches = mmr_select.launches = 0


def phase_main_path(torch) -> dict:
    from repro_torch.core.backends import (FusedNumpyBackend, HopperBackend,
                                           selection_width)
    from repro_torch.core.grammar import parse
    from repro_torch.core.materializer import Materializer
    from repro_torch.data.corpus import build_database, generate_corpus
    from repro_torch.embed import HashEmbedder
    from repro_torch.serve.engine import BatchedRetrievalEngine
    from repro_torch.serve.retrieval import RetrievalService

    t0 = time.perf_counter()
    emb = HashEmbedder(128)
    chunks = generate_corpus(n_chunks=MAIN_N, n_sessions=MAIN_SESSIONS,
                             seed=0, now=NOW)
    conn = sqlite3.connect(":memory:", check_same_thread=False)
    build_database(conn, chunks, emb)
    backend = HopperBackend(DEVICE)
    svc = RetrievalService(conn, dim=128, embedder=emb, now=NOW,
                           engine=backend)
    build_s = time.perf_counter() - t0
    del chunks

    sql = f"SELECT v.id, v.score FROM vec_ops('{TOKENS}') v LIMIT 10"
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    res = svc.flex_search(sql)
    sql_ms = (time.perf_counter() - t0) * 1e3
    if not res.ok:
        raise RuntimeError(f"flex_search failed: {res.error}")
    t0 = time.perf_counter()
    res = svc.flex_search(sql)  # warm: the corpus is resident now
    sql_warm_ms = (time.perf_counter() - t0) * 1e3

    engine = BatchedRetrievalEngine(svc.cache, max_batch=32, now=NOW,
                                    engine=backend)
    reqs = [f"similar:{TOPICS[i % len(TOPICS)]} diverse decay:30"
            for i in range(64)]
    lat = []

    def one(q):
        t = time.perf_counter()
        out = engine.search(q, 10)
        lat.append((time.perf_counter() - t) * 1e3)
        return out

    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(max_workers=32) as ex:
        served = list(ex.map(one, reqs))
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    stats = engine.stats()
    # a batch over mixed half-lives (and none): still one K1 launch a batch
    k1_before = _counts()["pem_score"]
    with cf.ThreadPoolExecutor(max_workers=len(MIXED_REQUESTS)) as ex:
        mixed_served = list(ex.map(lambda q: engine.search(q, 10),
                                   MIXED_REQUESTS))
    torch.cuda.synchronize()
    mixed = {"requests": len(MIXED_REQUESTS),
             "batches": engine.stats()["batches_served"]
             - stats["batches_served"],
             "pem_score_launches": _counts()["pem_score"] - k1_before}
    counts = _counts()
    engine.close()
    fused_stats = svc.cache.fused.stats()
    peak = torch.cuda.max_memory_allocated()

    # the oracle: the same store through fused-numpy
    oracle = Materializer(conn, svc.cache, now=NOW, engine="fused")
    cols, want_rows = oracle.execute(sql)
    if res.columns != cols:
        raise AssertionError(f"columns {res.columns} vs {cols}")
    near_ties = check_ranking("flex_search", res.rows, want_rows)
    want_served = [svc.cache.search(q, now=NOW, engine="fused")[:10]
                   for q in reqs]
    for q, got, want in zip(reqs, served, want_served):
        near_ties += check_ranking(f"engine {q!r}", got, want)
    mixed["ranking_near_ties"] = []
    for q, got in zip(MIXED_REQUESTS, mixed_served):
        want = svc.cache.search(q, now=NOW, engine="fused")[:10]
        mixed["ranking_near_ties"] += check_ranking(f"engine {q!r}", got,
                                                    want)
    mixed["oracle_match"] = True
    # the composed query's 2048-wide pool (diverse plans select 1500 rows
    # in a 2048 bucket) against the oracle's, before MMR
    plan = parse(TOKENS, emb)
    seg = svc.cache.store.segments[0]
    k = min(plan.pool, seg.n_rows)
    pools = [b.score_select(seg.matrix, seg.days_ago(NOW), [plan], [k],
                            fused_mmr=False)[0]
             for b in (backend, FusedNumpyBackend())]
    pool = check_pool("composed query pool", *pools)
    if pool["pool"] != selection_width(plan, k, seg.n_rows):
        raise AssertionError(f"pool width {pool['pool']}")
    lat.sort()
    out = {"phase": "main_path_240k", "chunks": MAIN_N,
           "corpus_build_s": build_s, "sql_first_ms": sql_ms,
           "sql_warm_ms": sql_warm_ms, "sql_rows": len(res.rows),
           "requests": len(reqs), "engine_wall_ms": wall * 1e3,
           "qps": len(reqs) / wall, "latency_p50_ms": lat[len(lat) // 2],
           "latency_p99_ms": lat[int(len(lat) * 0.99)],
           "batches_served": stats["batches_served"],
           "device_mmr": fused_stats["device_mmr"],
           "host_pool_transfers": fused_stats["host_pool_transfers"],
           "uploads": backend.uploads, "max_memory_allocated": peak,
           "launches": counts, "mixed_half_lives": mixed,
           "oracle_match": True,
           "ranking_near_ties": near_ties, "pool_check": pool}
    emit(out)
    if any(v == 0 for v in counts.values()):
        raise AssertionError(f"a kernel never ran on the main path: {counts}")
    if fused_stats["host_pool_transfers"]:
        raise AssertionError("diverse pools crossed to the host")
    if mixed["pem_score_launches"] != mixed["batches"]:
        raise AssertionError(f"mixed half-lives: {mixed['batches']} batches "
                             f"but {mixed['pem_score_launches']} K1 launches")
    try:
        out["service_shard_group"] = service_shard_group(torch, svc, conn,
                                                         sql, reqs)
        emit({"phase": "service_shard_group_240k", "chunks": MAIN_N,
              **out["service_shard_group"]})
    finally:
        svc.close()
    # what torch_engine reuses: the corpus's connection (not built again),
    # the calls and the oracle's rankings of them
    out["reuse"] = {"conn": conn, "embedder": emb, "sql": sql,
                    "columns": cols, "oracle_sql": want_rows,
                    "requests": reqs, "oracle_requests": want_served}
    return out


def phase_1m(torch) -> dict:
    from repro_torch.core.backends import HopperBackend
    from repro_torch.core.segments import store_from_arrays
    from repro_torch.core.vectorcache import VectorCache
    from repro_torch.embed import HashEmbedder

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    mat = rng.standard_normal((SCALE1M_N, 128), dtype=np.float32)
    mat /= np.linalg.norm(mat, axis=1, keepdims=True)
    ts = NOW - rng.uniform(0.0, 180.0, SCALE1M_N) * 86400.0
    live = rng.random(SCALE1M_N) >= 0.01       # 1% tombstoned
    cuts = [0, SCALE1M_N * 2 // 5, SCALE1M_N * 7 // 10, SCALE1M_N * 19 // 20,
            SCALE1M_N]
    store = store_from_arrays([
        {"ids": np.arange(a, b, dtype=np.int64), "matrix": mat[a:b],
         "timestamps": ts[a:b], "live_mask": live[a:b]}
        for a, b in zip(cuts, cuts[1:])])
    cache = VectorCache(embed_fn=HashEmbedder(128), store=store)
    build_s = time.perf_counter() - t0
    backend = HopperBackend(DEVICE)
    out = {"phase": "scale_1m", "chunks": SCALE1M_N,
           "segments": store.n_segments, "live": store.n_live,
           "store_build_s": build_s}
    before = _counts()
    queries = (("composed", SCALE1M_TOKENS),
               ("composed_diverse", SCALE1M_DIVERSE_TOKENS))
    served = {}
    for name, tokens in queries:
        cache.search(tokens, now=NOW, engine=backend)  # uploads, builds
        t0 = time.perf_counter()
        served[name] = cache.search(tokens, now=NOW, engine=backend)
        out[name] = {"results": len(served[name]),
                     "warm_ms": (time.perf_counter() - t0) * 1e3}
    after = _counts()
    out["launches"] = {k: after[k] - before[k] for k in after}
    out["device_mmr"] = cache.fused.device_mmr
    out["host_pool_transfers"] = cache.fused.host_pool_transfers
    oracle = {}
    for name, tokens in queries:  # the oracle, on the same store
        t0 = time.perf_counter()
        want = oracle[name] = cache.search(tokens, now=NOW, engine="fused")
        out[name]["oracle_ms"] = (time.perf_counter() - t0) * 1e3
        out[name]["ranking_near_ties"] = check_ranking(
            f"1M {name}", served[name], want)
        out[name]["oracle_match"] = True
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    emit(out)
    if not out["launches"]["mmr"] or out["host_pool_transfers"]:
        raise AssertionError("the merged-pool MMR path did not run on the "
                             "card")
    # the 1M store, its rows and the rankings the next phases are held to
    return {"cache": cache, "ids": np.arange(SCALE1M_N, dtype=np.int64),
            "matrix": mat, "timestamps": ts, "dead": np.flatnonzero(~live),
            "queries": queries, "served": served, "oracle": oracle,
            "warm_ms": {name: out[name]["warm_ms"] for name, _ in queries}}


def _check_launched(path: str, counts: dict, kernels) -> None:
    """Fail unless every kernel of ``path`` launched in its run."""
    idle = [k for k in kernels if not counts.get(k)]
    if idle:
        raise AssertionError(f"{path}: {idle} never launched: {counts}")


def _shard_devices(torch) -> list:
    """Four shards: one a card where there are four, else four on one."""
    if DEVICE == "cuda" and torch.cuda.device_count() >= 4:
        return [f"cuda:{s}" for s in range(4)]
    return [DEVICE if DEVICE == "cpu" else "cuda:0"] * 4


def phase_sharded_1m(torch, one_m) -> dict:
    """The 1M store through ``ShardedBackend``: four contiguous row blocks
    per segment, the Hopper chain on every shard, the shard-major merge,
    and the merged-pool MMR on the lead device."""
    from repro_torch.core.backends import ShardedBackend

    cache = one_m["cache"]
    devices = _shard_devices(torch)
    backend = ShardedBackend(devices)
    torch.cuda.reset_peak_memory_stats()
    before = cache.fused.stats()
    out = {"phase": "sharded_1m", "chunks": SCALE1M_N,
           "segments": cache.store.n_segments, "devices": devices}
    for name, tokens in one_m["queries"]:
        cache.search(tokens, now=NOW, engine=backend)  # uploads
        _reset_counts()
        t0 = time.perf_counter()
        got = cache.search(tokens, now=NOW, engine=backend)
        torch.cuda.synchronize()
        warm = (time.perf_counter() - t0) * 1e3
        counts = _counts()
        _check_launched(f"sharded_1m {name}", counts,
                        ("pem_score", "topk") + (("mmr",) if "diverse"
                                                 in tokens else ()))
        mono = one_m["served"][name]
        if [i for i, _ in got] != [i for i, _ in mono]:
            raise AssertionError(f"sharded_1m {name}: ids differ from the "
                                 f"monolithic HopperBackend's")
        out[name] = {
            "warm_ms": warm, "launches_per_query": counts,
            "max_abs_diff_vs_monolith": max(
                abs(float(a[1]) - float(b[1])) for a, b in zip(got, mono)),
            "ranking_near_ties": check_ranking(f"sharded_1m {name}", got,
                                               one_m["oracle"][name]),
            "oracle_match": True}
    after = cache.fused.stats()
    out["device_mmr"] = after["device_mmr"] - before["device_mmr"]
    out["host_pool_transfers"] = (after["host_pool_transfers"]
                                  - before["host_pool_transfers"])
    out["device_cache"] = backend.device_cache_stats()
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["launches"] = {k: sum(out[name]["launches_per_query"][k]
                              for name, _ in one_m["queries"])
                       for k in _counts()}
    emit(out)
    if out["host_pool_transfers"] or not out["device_mmr"]:
        raise AssertionError("sharded_1m: a diverse pool crossed to the host")
    del backend
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_pem_sharded(torch) -> dict:
    """``make_pem_topk`` in a world-1 NCCL group at 1,000,448 x 128, B = 32,
    k = 500, against ``pem_topk_reference``; the same rows split over four
    in-process shards and merged shard-major must give its indices bit for
    bit, and the collective merge of the one rank must be the identity."""
    import torch.distributed as dist

    from repro_torch.dist.pem_sharded import (make_pem_topk,
                                              merge_shard_major,
                                              pem_topk_reference,
                                              union_merge_topk)
    from repro_torch.kernels.pem_score.ops import pem_score
    from repro_torch.kernels.topk.ops import topk

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(3)
    n, d, b, k, hl = SCALE1M_N, 128, 32, 500, 30.0
    corpus = torch.randn(n, d, generator=gen, device=dev)
    corpus /= corpus.norm(dim=1, keepdim=True)
    days = torch.rand(n, generator=gen, device=dev) * 180
    qp = torch.randn(d, b, generator=gen, device=dev) / d ** 0.5
    qs = torch.randn(d, b, generator=gen, device=dev) * 0.1
    dist.init_process_group("nccl" if DEVICE == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        fn = make_pem_topk(k, half_life=hl)
        _reset_counts()
        idx, val = fn(corpus, days, qp, qs)
        merged_i, merged_v = union_merge_topk(val, idx, k)
        torch.cuda.synchronize()
        counts = _counts()
        if not (torch.equal(merged_i, idx) and torch.equal(merged_v, val)):
            raise AssertionError("pem_sharded: the one-rank merge is not "
                                 "the identity")
        ms = time_ms(torch, lambda: fn(corpus, days, qp, qs), 20)
    finally:
        dist.destroy_process_group()
    _check_launched("pem_sharded", counts, ("pem_score", "topk"))
    ri, rv = pem_topk_reference(corpus, days, qp, qs, k, half_life=hl)
    err = float((val - rv).abs().max())
    # K1's split-TF32 products are f32-accurate, not the plain f32
    # product's bits: where the picks differ, the kernel's pick must score
    # (by the reference's arithmetic) within the tolerance of the
    # reference's pick at that rank
    rows, pos = torch.nonzero(idx != ri, as_tuple=True)
    picked = idx[rows, pos]
    m = corpus[picked]
    their = (1.0 / (1.0 + days[picked] / hl)) * (m * qp.T[rows]).sum(1) \
        + (m * qs.T[rows]).sum(1)
    near = float((their - rv[rows, pos]).abs().max()) if rows.numel() else 0.0
    unique = all(len(set(r.tolist())) == k for r in idx.cpu())
    if err > TOL or near > TOL or not unique:
        raise AssertionError(f"pem_sharded: differs from the reference "
                             f"(max error {err}, picks off by {near})")
    # four in-process shards of the same rows, merged shard-major
    n_local = n // 4
    cand_v, cand_i = [], []
    for s in range(4):
        blk = slice(s * n_local, (s + 1) * n_local)
        panel = torch.empty((b, n_local), device=dev)
        pem_score(corpus[blk], qp, qs, days_ago=days[blk],
                  half_lives=torch.full((b,), hl, device=dev), out=panel.T)
        v, i = topk(panel, k)
        cand_v.append(v)
        cand_i.append(i.long() + s * n_local)
    si, sv = merge_shard_major(torch.stack(cand_v), torch.stack(cand_i), k)
    torch.cuda.synchronize()
    if not (torch.equal(si, idx) and torch.equal(sv, val)):
        raise AssertionError("pem_sharded: four shards differ from one "
                             "rank's bits")
    out = {"phase": "pem_sharded", "n": n, "d": d, "b": b, "k": k,
           "world_size": 1, "backend": "nccl" if DEVICE == "cuda" else "gloo",
           "launches": counts, "max_abs_err": err,
           "positions_in_near_ties": int(rows.numel()),
           "near_tie_max_gap": near,
           "four_shards_bit_equal": True, "ms": ms,
           "plain_ms": time_ms(torch, lambda: pem_topk_reference(
               corpus, days, qp, qs, k, half_life=hl), 5)}
    emit(out)
    return out


def _group_launches(g, reset=False) -> dict:
    """Kernel launches of a shard group's workers: one count for the
    coordinator's process (inline and thread workers share it), the sum
    of the workers' own processes for the process transport."""
    if g.transport != "process":
        counts = _counts()
        if reset:
            _reset_counts()
        return counts
    total: dict = {}
    for row in g._clients:
        for client in row:
            for key, n in client.call("kernel_launches", reset).items():
                total[key] = total.get(key, 0) + n
    return total


def _overlap(a, b, k=100) -> int:
    return len({int(i) for i, _ in a[:k]} & {int(i) for i, _ in b[:k]})


def phase_shard_group_1m(torch, one_m) -> dict:
    """``ProcessGroup`` over the same 1,000,448 rows, four shards: spawned
    GPU workers (``process``) in f32, then ``thread`` workers in f32, f32b
    and bf16; f32 held to the fused-numpy oracle, f32b and bf16 by their
    top-100 overlap with f32 (the bounds of the reference's tests: 90 and
    75 of 100)."""
    from repro_torch.core.grammar import parse
    from repro_torch.dist.procgroup import ProcessGroup

    emb = one_m["cache"].embed_fn
    plans = {name: parse(tokens, emb) for name, tokens in one_m["queries"]}
    out = {"phase": "shard_group_1m", "chunks": SCALE1M_N, "n_shards": 4}
    f32_rank = {}
    for transport, dtype in (("process", "f32"), ("thread", "f32"),
                             ("thread", "f32b"), ("thread", "bf16")):
        t0 = time.perf_counter()
        g = ProcessGroup.build(
            one_m["ids"], one_m["matrix"], one_m["timestamps"],
            normalized=True, n_shards=4, transport=transport, dtype=dtype,
            engine="hopper", device=DEVICE)
        try:
            g.delete(one_m["dead"])
            row = {"build_s": time.perf_counter() - t0}
            for name, plan in plans.items():
                g.search_plan(plan, now=NOW)  # uploads
                _group_launches(g, reset=True)
                t0 = time.perf_counter()
                got = g.search_plan(plan, now=NOW)
                warm = (time.perf_counter() - t0) * 1e3
                counts = _group_launches(g)
                _check_launched(f"shard_group_1m {transport} {dtype}",
                                counts, ("pem_score", "topk"))
                res = {"warm_ms": warm, "launches_per_query": counts}
                if dtype == "f32":
                    res["ranking_near_ties"] = check_ranking(
                        f"shard_group {transport} {name}", got,
                        one_m["oracle"][name])
                    res["oracle_match"] = True
                    f32_rank[name] = got
                else:
                    res["top100_overlap_with_f32"] = _overlap(
                        got, f32_rank[name])
                    need = 90 if dtype == "f32b" else 75
                    if res["top100_overlap_with_f32"] < need:
                        raise AssertionError(
                            f"shard_group {dtype} {name}: top-100 overlap "
                            f"{res['top100_overlap_with_f32']} < {need}")
                row[name] = res
            # both queries in one batch: one pem_score launch a shard
            _group_launches(g, reset=True)
            g.search_plan_batch(list(plans.values()), now=NOW)
            row["pem_score_launches_per_batch"] = _group_launches(
                g)["pem_score"]
            if row["pem_score_launches_per_batch"] != 4:
                raise AssertionError(
                    f"shard_group {transport} {dtype}: "
                    f"{row['pem_score_launches_per_batch']} pem_score "
                    "launches for one batch over four shards")
            st = g.stats()
            row["shards"] = [{k: s[k] for k in (
                "shard", "device", "rows", "live", "device_bytes",
                "scoring_bytes", "last_pass_ms", "corpus_streams")}
                for s in st["shards"]]
            row["last_fanout_ms"] = st["last_fanout_ms"]
            row["last_merge_ms"] = st["last_merge_ms"]
        finally:
            g.close()
        out[f"{transport}_{dtype}"] = row
    out["launches"] = {k: sum(out[key][name]["launches_per_query"][k]
                              for key in out if key.startswith(("process",
                                                                "thread"))
                              for name in plans)
                       for k in _counts()}
    emit(out)
    return out


def service_shard_group(torch, svc, conn, sql, reqs) -> dict:
    """The 240k service with ``shard_group(4)`` on the card: the composed
    query through ``flex_search`` and the engine requests, both fanned
    out to the group by the attached engine, every ranking held to the
    fused-numpy oracle."""
    from repro_torch.core.materializer import Materializer

    _reset_counts()
    t0 = time.perf_counter()
    g = svc.shard_group(4)
    attach_s = time.perf_counter() - t0
    eng = svc.serving(max_batch=32)
    if eng.shard_group is not g:
        raise AssertionError("the engine does not fan out to the group")
    res = svc.flex_search(sql)
    if not res.ok:
        raise RuntimeError(f"flex_search through the group: {res.error}")
    t0 = time.perf_counter()
    res = svc.flex_search(sql)
    sql_warm_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(max_workers=32) as ex:
        served = list(ex.map(lambda q: svc.search(q, 10), reqs))
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = _counts()
    stats = eng.stats()
    _check_launched("service shard_group", counts, ("pem_score", "topk"))
    cols, want_rows = Materializer(conn, svc.cache, now=NOW,
                                   engine="fused").execute(sql)
    if res.columns != cols:
        raise AssertionError(f"columns {res.columns} vs {cols}")
    near = check_ranking("flex_search via shard_group", res.rows, want_rows)
    for q, got in zip(reqs, served):
        want = svc.cache.search(q, now=NOW, engine="fused")[:10]
        near += check_ranking(f"shard_group engine {q!r}", got, want)
    st = g.stats()
    return {"n_shards": st["n_shards"], "transport": st["transport"],
            "dtype": st["dtype"], "attach_s": attach_s,
            "sql_warm_ms": sql_warm_ms, "requests": len(reqs),
            "engine_wall_ms": wall * 1e3, "qps": len(reqs) / wall,
            "batches_served": stats["batches_served"],
            "launches": counts, "oracle_match": True,
            "ranking_near_ties": near,
            "shards": [{k: s[k] for k in ("shard", "device", "live",
                                          "device_bytes", "last_pass_ms")}
                       for s in st["shards"]]}


FLEXVEC_CELLS = ("corpus_240k", "corpus_1m")  # corpus_67m: dry run only


def _flexvec_kernels(torch, corpus, days, q, qs, over, pool, tol) -> dict:
    """Each kernel of the step on the step's own inputs, held against its
    plain version: K1 within ``tol``, K2's ids and values exact on K1's
    panel, K3 on the gathered pool equal but for adjacent swaps of near
    ties; their times beside the shared count's bounds, the plain
    versions' and one library call's where one computes the same thing.
    The step's pool (K2 on K1's panel) must hold the plain pool's members
    but for near ties at its boundary score."""
    from repro_torch.configs.flexvec import (HALF_LIFE, LAMBDA, _rows,
                                             step_work)
    from repro_torch.kernels.mmr.ops import mmr_select
    from repro_torch.kernels.mmr.ref import mmr_ref
    from repro_torch.kernels.pem_score.ops import pem_score
    from repro_torch.kernels.pem_score.ref import (decay_factors,
                                                   pem_score_days_ref)
    from repro_torch.kernels.topk.ops import topk
    from repro_torch.kernels.topk.ref import topk_ref

    n, d = corpus.shape
    b = q.shape[1]
    dev = corpus.device
    hl = torch.full((b,), HALF_LIFE, device=dev)
    lam = torch.full((b,), LAMBDA, device=dev)
    panel = torch.empty((b, n), device=dev)

    def k1():
        return pem_score(corpus, q, qs, days_ago=days, half_lives=hl,
                         out=panel.T)

    k1()
    want = pem_score_days_ref(corpus, q, qs, days, hl)
    k1_err = float((panel.T - want).abs().max())
    v, i = topk(panel, over)
    vr, ir = topk_ref(panel, over)
    emb = _rows(corpus, i)
    sel, mv = mmr_select(emb, v, pool, LAMBDA)
    sr, mvr = mmr_ref(emb, v, pool, lam)
    torch.cuda.synchronize()
    if not k1_err <= tol:
        raise AssertionError(f"flexvec pem_score: max error {k1_err} > {tol}")
    if not (torch.equal(i, ir) and torch.equal(v, vr)):
        raise AssertionError("flexvec topk: differs from the plain version "
                             "on the same panel")
    swaps = []
    for r in range(b):
        swaps += check_ranking(
            f"flexvec mmr row {r}",
            list(zip(sel[r].tolist(), v[r][sel[r].long()].tolist())),
            list(zip(sr[r].tolist(), v[r][sr[r].long()].tolist())))
    same = sel == sr
    k3_err = float((mv[same] - mvr[same]).abs().max())
    if k3_err > TOL:
        raise AssertionError(f"flexvec mmr: values differ by {k3_err}")
    wv, wi = topk_ref(want.T, over)  # the plain step's pool
    boundary = 0
    for r in range(b):
        boundary += len(check_pool(
            f"flexvec pool row {r}", (i[r].cpu().numpy(), v[r].cpu().numpy()),
            (wi[r].cpu().numpy(), wv[r].cpu().numpy()),
            tol)["boundary_near_ties"])
    del want, wv, wi
    qcat = torch.cat([q, qs], dim=1)
    cost = step_work(n, b, over, pool, d=d, esize=corpus.element_size())

    def k1_library():
        both = torch.matmul(corpus if corpus.dtype == torch.float32
                            else corpus.float(), qcat)
        return decay_factors(days, hl) * both[:, :b] + both[:, b:]

    times = {
        "pem_score": (time_ms(torch, k1, 20),
                      time_ms(torch, lambda: pem_score_days_ref(
                          corpus, q, qs, days, hl), 5),
                      time_ms(torch, k1_library, 5)),
        "topk": (time_ms(torch, lambda: topk(panel, over), 20),
                 time_ms(torch, lambda: topk_ref(panel, over), 5),
                 time_ms(torch, lambda: torch.topk(panel, over, dim=1), 20)),
        "gather": (time_ms(torch, lambda: _rows(corpus, i), 20), None, None),
        "mmr": (time_ms(torch, lambda: mmr_select(emb, v, pool, LAMBDA), 10),
                time_ms(torch, lambda: mmr_ref(emb, v, pool, lam), 1), None),
    }
    kernels = {}
    for name, (ms, plain, lib) in times.items():
        t, by = bound_ms(cost[name])
        kernels[name] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                         "bound_ms": t, "bound_by": by}
    kernels["pem_score"]["max_abs_err"] = k1_err
    kernels["topk"]["max_abs_err"] = 0.0
    kernels["mmr"].update(max_abs_err=k3_err, adjacent_swaps=swaps,
                          ms_per_step=kernels["mmr"]["ms"] / pool)
    return {"kernels": kernels,
            "step_bound_ms": sum(k["bound_ms"] for k in kernels.values()),
            "pool_boundary_near_ties": boundary}


def phase_flexvec_arch(torch, seed: int) -> dict:
    """The flexvec architecture entry (``configs.get_arch("flexvec")``) at
    the paper's batched cells, 64 queries, each an MMR pool of 500 picked
    from 1500, on 240,000 and 1,000,000 rows: built by
    ``build(shape, make_local_mesh(), get_rules("default", ...))`` and
    run on inputs made on the card from ``seed`` (a unit-normal corpus,
    ages uniform on 0-90 days, q normal, q_sup = -0.5 q), in f32 and bf16,
    one-stage and two-stage in a one-rank NCCL group.  One-stage runs are
    held to the plain step (each kernel to its plain version, the pool's
    members to the plain pool's, the picks equal but for adjacent swaps of
    near ties); two-stage runs must equal them bit for bit."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.configs.flexvec import (DIM, SHAPES, FlexvecArch,
                                             pem_serve_step_plain)
    from repro_torch.dist.tuned import get_rules
    from repro_torch.kernels.mmr import kernel as mmr_kernel
    from repro_torch.launch.mesh import make_local_mesh

    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    # a step: one K1 launch, one top-k call (6 launches), one K3 launch
    # (the plain versions of a CPU rehearsal count none)
    expect = {"pem_score": 1, "topk": 6, "mmr": 1}
    if DEVICE == "cpu":
        expect = dict.fromkeys(expect, 0)
    out = {"phase": "flexvec_arch", "seed": seed, "runs": []}
    total = dict.fromkeys(expect, 0)
    dist.init_process_group("nccl" if DEVICE == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_local_mesh(DEVICE)
        rules = get_rules("default", mesh)
        for shape in FLEXVEC_CELLS:
            s = SHAPES[shape]
            n, b, over, pool = s["n"], s["batch"], s["over"], s["pool"]
            occupancy = mmr_kernel.shape(over, DIM)
            base = torch.randn(n, DIM, generator=gen, device=dev)
            base /= base.norm(dim=1, keepdim=True)
            days = torch.rand(n, generator=gen, device=dev) * 90.0
            q = torch.randn(DIM, b, generator=gen, device=dev)
            qs = -0.5 * q
            for dtype, tol in ((torch.float32, TOL), (torch.bfloat16, 2e-2)):
                corpus = base.to(dtype)
                args = (corpus, days, q, qs)
                one = None
                for two_stage in (False, True):
                    arch = (get_arch("flexvec")
                            if dtype == torch.float32 and not two_stage
                            else FlexvecArch(dtype=dtype, two_stage=two_stage))
                    spec = arch.build(shape, mesh, rules)
                    for a, t in zip(spec.call_args(rules), args):
                        if tuple(a.shape) != tuple(t.shape) or a.dtype != t.dtype:
                            raise AssertionError(f"{shape}: the spec takes "
                                                 f"{a.shape} {a.dtype}")
                    torch.cuda.synchronize()
                    resident = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    _reset_counts()
                    idx, val = spec.fn(*args)
                    torch.cuda.synchronize()
                    counts = _counts()
                    peak = torch.cuda.max_memory_allocated()
                    name = (f"{shape} {str(dtype).split('.')[-1]} "
                            f"{'two-stage' if two_stage else 'one-stage'}")
                    if counts != expect:
                        raise AssertionError(f"flexvec {name}: launches "
                                             f"{counts}, expected {expect}")
                    if tuple(idx.shape) != (b, pool) or not bool(
                            torch.isfinite(val).all()):
                        raise AssertionError(f"flexvec {name}: picks "
                                             f"{tuple(idx.shape)} or values "
                                             f"not finite")
                    for k in total:
                        total[k] += counts[k]
                    row = {"cell": shape, "n": n, "b": b, "over": over,
                           "pool": pool, "dtype": str(dtype).split(".")[-1],
                           "two_stage": two_stage, "launches": counts,
                           "step_ms": time_ms(torch, lambda: spec.fn(*args),
                                              10),
                           "k3_max_active_clusters":
                               occupancy["max_active_clusters"],
                           "k3_waves": -(-b // occupancy[
                               "max_active_clusters"]),
                           "resident_bytes_before": resident,
                           "max_memory_allocated": peak}
                    if two_stage:
                        if not (torch.equal(idx.long(), one[0].long())
                                and torch.equal(val, one[1])):
                            raise AssertionError(f"flexvec {name}: not "
                                                 f"bit-equal to one-stage")
                        row["bit_equal_to_one_stage"] = True
                    else:
                        one = (idx, val)
                        row.update(_flexvec_kernels(
                            torch, corpus, days, q, qs, over, pool, tol))
                        wi, wv = pem_serve_step_plain(*args, pool=pool,
                                                      over=over)
                        swaps = []
                        for r in range(b):
                            swaps += check_ranking(
                                f"flexvec {name} row {r}",
                                list(zip(idx[r].tolist(), val[r].tolist())),
                                list(zip(wi[r].tolist(), wv[r].tolist())),
                                tol)
                        row.update(
                            plain_step_ms=time_ms(
                                torch, lambda: pem_serve_step_plain(
                                    *args, pool=pool, over=over), 1),
                            ranking_near_ties=swaps, plain_match=True)
                    emit({"phase": "flexvec_arch", **row})
                    out["runs"].append(row)
                del corpus, args
            del base, days, q, qs
    finally:
        dist.destroy_process_group()
    out["launches"] = total
    emit({"phase": "flexvec_arch", "runs": len(out["runs"]),
          "launches": total, "seconds": time.perf_counter() - t0})
    return out


def phase_torch_engine(torch, main_path, one_m) -> dict:
    """``TorchBackend``, the main path as plain PyTorch library calls (one
    function per plan structure, no kernel), over the main path's 240k
    corpus (a service on its SQLite connection: the corpus is not built
    again) and the 1M store: the composed query through ``flex_search``
    cold and warm, the 64 engine requests from 32 threads, and the 1M
    store's two composed queries.  Every ranking is held to the
    fused-numpy oracle's, each time stands beside HopperBackend's for the
    same call in this run, a repeated structure builds nothing, and no
    kernel launches."""
    from repro_torch.core.backends import TorchBackend
    from repro_torch.serve.engine import BatchedRetrievalEngine
    from repro_torch.serve.retrieval import RetrievalService

    t_phase = time.perf_counter()
    reuse = main_path["reuse"]
    backend = TorchBackend(DEVICE)
    t0 = time.perf_counter()
    svc = RetrievalService(reuse["conn"], dim=128, embedder=reuse["embedder"],
                           now=NOW, engine=backend)
    out = {"phase": "torch_engine", "chunks": MAIN_N,
           "service_load_s": time.perf_counter() - t0}
    sql, reqs = reuse["sql"], reuse["requests"]
    _reset_counts()
    lat = []
    try:
        t0 = time.perf_counter()
        res = svc.flex_search(sql)
        cold_ms = (time.perf_counter() - t0) * 1e3
        if not res.ok:
            raise RuntimeError(f"flex_search on TorchBackend: {res.error}")
        builds = backend.plan_cache.builds
        t0 = time.perf_counter()
        res = svc.flex_search(sql)
        warm_ms = (time.perf_counter() - t0) * 1e3
        rebuilt = backend.plan_cache.builds - builds
        # where a warm query's time goes: device time by kernel (one more
        # call, traced), against its host-clock time above
        sql_profile = launch_breakdown(torch, lambda: svc.flex_search(sql),
                                       reps=1)
        engine = BatchedRetrievalEngine(svc.cache, max_batch=32, now=NOW,
                                        engine=backend)

        def one(q):
            t = time.perf_counter()
            got = engine.search(q, 10)
            lat.append((time.perf_counter() - t) * 1e3)
            return got

        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(max_workers=32) as ex:
            served = list(ex.map(one, reqs))
        wall = time.perf_counter() - t0
        batches = engine.stats()["batches_served"]
        engine.close()
        plan_cache = svc.stats()["plan_cache"]
    finally:
        svc.close()
    scale = {}
    for name, tokens in one_m["queries"]:
        t0 = time.perf_counter()
        one_m["cache"].search(tokens, now=NOW, engine=backend)  # uploads
        cold = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        got = one_m["cache"].search(tokens, now=NOW, engine=backend)
        scale[name] = {"cold_ms": cold,
                       "warm_ms": (time.perf_counter() - t0) * 1e3,
                       "hopper_warm_ms": one_m["warm_ms"][name],
                       "device_ms": sum(launch_breakdown(
                           torch, lambda: one_m["cache"].search(
                               tokens, now=NOW, engine=backend),
                           reps=1).values()) / 1e3,
                       "ranking_near_ties": check_ranking(
                           f"torch_engine 1M {name}", got,
                           one_m["oracle"][name])}
    counts = _counts()
    if res.columns != reuse["columns"]:
        raise AssertionError(f"columns {res.columns} vs {reuse['columns']}")
    near = check_ranking("torch_engine flex_search", res.rows,
                         reuse["oracle_sql"])
    for q, got, want in zip(reqs, served, reuse["oracle_requests"]):
        near += check_ranking(f"torch_engine engine {q!r}", got, want)
    lat.sort()
    out.update({
        "flex_search_cold_ms": cold_ms, "flex_search_warm_ms": warm_ms,
        "flex_search_device_ms": sum(sql_profile.values()) / 1e3,
        "flex_search_device_us_by_kernel": dict(sorted(
            sql_profile.items(), key=lambda kv: -kv[1])[:6]),
        "hopper_flex_search_cold_ms": main_path["sql_first_ms"],
        "hopper_flex_search_warm_ms": main_path["sql_warm_ms"],
        "engine": {"requests": len(reqs), "wall_ms": wall * 1e3,
                   "qps": len(reqs) / wall,
                   "latency_p50_ms": lat[len(lat) // 2],
                   "latency_p99_ms": lat[int(len(lat) * 0.99)],
                   "batches_served": batches},
        "hopper_engine": {k: main_path[k] for k in (
            "engine_wall_ms", "qps", "latency_p50_ms", "latency_p99_ms",
            "batches_served")},
        "scale_1m": scale, "plan_cache": plan_cache,
        "plan_cache_after_1m": backend.plan_cache.stats(),
        "builds_on_repeat": rebuilt, "launches": counts,
        "oracle_match": True, "ranking_near_ties": near,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "seconds": time.perf_counter() - t_phase})
    emit(out)
    if any(counts.values()):
        raise AssertionError(f"TorchBackend launched a kernel: {counts}")
    if rebuilt:
        raise AssertionError(f"a repeated structure built {rebuilt} "
                             f"functions again")
    return out


def phase_behavioral(torch) -> dict:
    """The paper's §4.4 behavioural suite (Tables 5-6,
    ``repro_torch.bench.behavioral``) at the four datasets' published
    document counts, 128 f32 dimensions: 30 queries x 6 plans each
    through ``VectorCache`` on ``HopperBackend`` and on fused-numpy over
    the same cache.  Ids must equal the oracle's but for adjacent swaps
    whose two scores lie within 1e-5 of each other, each printed; scores
    agree to 1e-5; the Table 5/6 figures are equal at the
    precision the reference prints; and every diverse search launches
    the mmr kernel."""
    from repro_torch.bench import behavioral as BH
    from repro_torch.core import modulations as M
    from repro_torch.core.backends import HopperBackend
    from repro_torch.data.beir import DATASET_SPECS

    t_phase = time.perf_counter()
    backend = HopperBackend(DEVICE)
    out = {"phase": "behavioral", "datasets": []}
    total = dict.fromkeys(_counts(), 0)
    for name, spec in DATASET_SPECS.items():
        t0 = time.perf_counter()
        suite = BH.setup(name)
        setup_s = time.perf_counter() - t0
        n = len(suite.ds.doc_texts)
        if n != spec[0] or suite.cache.matrix.shape != (n, BH.DIM):
            raise AssertionError(f"behavioral {name}: {n} rows")
        # the corpus's upload, outside the counted and timed searches
        suite.cache.search_plan(M.ModulationPlan(
            query=M.l2_normalize(suite.emb(suite.ds.queries[0]))),
            now=suite.ds.now, engine=backend)
        torch.cuda.synchronize()
        _reset_counts()
        got = BH.run_dataset(name, backend, suite=suite)
        counts = _counts()
        want = BH.run_dataset(name, "fused-numpy", suite=suite)
        swaps = []
        for plan in BH.PLANS:
            for qi, (g, w) in enumerate(zip(got["rankings"][plan],
                                            want["rankings"][plan])):
                for sw in check_ranking(f"behavioral {name} {plan} q{qi}",
                                        g, w):
                    gap = abs(sw["scores"][0] - sw["scores"][1])
                    if gap > TOL:
                        raise AssertionError(
                            f"behavioral {name} {plan} q{qi}: swapped "
                            f"scores {sw['scores']} differ by {gap}")
                    swaps.append({"plan": plan, "query": qi, **sw})
        figures = BH.table5_rows(got) + [BH.table6_row(got)]
        if figures != BH.table5_rows(want) + [BH.table6_row(want)]:
            raise AssertionError(f"behavioral {name}: figures {figures} "
                                 f"differ from the oracle's")
        diverse = len(got["rankings"]["diverse"])
        if DEVICE == "cuda":  # a CPU rehearsal's plain versions count none
            _check_launched(f"behavioral {name}", counts,
                            ("pem_score", "topk", "mmr"))
            if counts["mmr"] < diverse:
                raise AssertionError(
                    f"behavioral {name}: {counts['mmr']} mmr launches for "
                    f"{diverse} diverse searches")
        for k in total:
            total[k] += counts[k]
        row = {"phase": "behavioral", "dataset": name, "rows": n,
               "effective_seed": got["effective_seed"],
               "searches": got["searches"], "setup_s": setup_s,
               "figures": dict(figures), "launches": counts,
               "ms_per_search": got["search_s"] / got["searches"] * 1e3,
               "oracle_ms_per_search":
                   want["search_s"] / want["searches"] * 1e3,
               "oracle_match": True, "adjacent_swaps": swaps}
        emit(row)
        out["datasets"].append(row)
        if name == "fiqa-like":
            out["kernels"] = behavioral_kernels(torch, suite.cache.matrix)
        del suite
    out["launches"] = total
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "behavioral", "datasets": len(out["datasets"]),
          "launches": total, "seconds": out["seconds"]})
    return out


def behavioral_kernels(torch, matrix) -> dict:
    """Each kernel alone on a behavioural search's inputs at one dataset's
    size (fiqa-like, 57,638 x 128 f32): K1 at B = 1, K2 at K = 512 and
    2,048 over its scores, K3 picking 500 of the top 1,500 rows (bucket
    2,048); each against its plain version, its library call, and its
    bound from the shared count (``configs/flexvec.py``)."""
    from repro_torch.configs.flexvec import (mmr_work, pem_score_work,
                                             topk_work)
    from repro_torch.kernels.mmr.ops import NEG, mmr_select
    from repro_torch.kernels.mmr.ref import mmr_ref
    from repro_torch.kernels.pem_score.ops import pem_score
    from repro_torch.kernels.pem_score.ref import pem_score_ref
    from repro_torch.kernels.topk.ops import topk
    from repro_torch.kernels.topk.ref import topk_ref

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(3)
    m = torch.as_tensor(matrix, device=dev)
    n, d = m.shape
    qp = m[:1].T.contiguous()                        # a document as the query
    qs = torch.randn(d, 1, generator=gen, device=dev) * 0.05
    decay = 1.0 / (1.0 + torch.rand(n, generator=gen, device=dev) * 3)
    rows = {}

    def row(name, got_err, ms, plain, lib, work, **extra):
        t, by = bound_ms(work)
        r = {"phase": "behavioral", "kernel": name, "n": n, "d": d,
             "max_abs_err": got_err, "ms": ms, "plain_ms": plain,
             "library_ms": lib, "bound_ms": t, "bound_by": by, **extra}
        emit(r)
        rows[name if "k" not in extra else f"{name} k={extra['k']}"] = r

    panel = torch.empty((1, n), device=dev)
    got = pem_score(m, qp, qs, decay, out=panel.T)
    want = pem_score_ref(m, qp, qs, decay)
    err = float((got - want).abs().max())
    if not err <= TOL:
        raise AssertionError(f"behavioral pem_score: max error {err}")
    qcat = torch.cat([qp, qs], dim=1)

    def library(both):   # one f32 product and the epilogue
        return decay[:, None] * both[:, :1] + both[:, 1:]

    row("pem_score", err,
        time_ms(torch, lambda: pem_score(m, qp, qs, decay, out=panel.T), 50),
        time_ms(torch, lambda: pem_score_ref(m, qp, qs, decay), 50),
        time_ms(torch, lambda: library(m @ qcat), 50),
        pem_score_work(n, d, 1, 4), b=1)
    scores = panel
    for k in (512, 2048):
        v, i = topk(scores, k)
        vr, ir = topk_ref(scores, k)
        if not (torch.equal(i, ir) and torch.equal(v, vr)):
            raise AssertionError(f"behavioral topk k={k}: differs from plain")
        row("topk", 0.0, time_ms(torch, lambda: topk(scores, k), 50),
            time_ms(torch, lambda: topk_ref(scores, k), 20),
            time_ms(torch, lambda: torch.topk(scores, k, dim=1), 50),
            topk_work(1, n, k), k=k)
    live, bucket, k = 1500, 2048, 500
    _, top = topk_ref(scores, bucket)
    e = m.index_select(0, top[0].long())[None].contiguous()
    rel = scores[0, top[0].long()][None].contiguous()
    rel[:, live:] = NEG
    lam = torch.full((1,), 0.7, device=dev)
    idx, val = mmr_select(e, rel, k, lam)
    ir, vr = mmr_ref(e, rel, k, lam)
    err = float((val - vr).abs().max())
    if not (torch.equal(idx, ir) and err <= TOL):
        raise AssertionError(f"behavioral mmr: picks differ (value error "
                             f"{err})")
    row("mmr", err, time_ms(torch, lambda: mmr_select(e, rel, k, lam), 10),
        time_ms(torch, lambda: mmr_ref(e, rel, k, lam), 2), None,
        mmr_work(1, live, k, d, bucket), live=live, bucket=bucket)
    return rows


# -- the LM family --------------------------------------------------------------

LM_MODELS = ("internlm2-1.8b", "granite-moe-1b-a400m")
LM_SERVE = dict(slots=4, max_ctx=2048, requests=8, prompt=(64, 512), new=32)
LM_TRAIN = dict(batch=4, seq=1024, steps=6, ckpt_at=3, moe_steps=3)
LM_SMOKE = False   # True: the archs' smoke configs (a CPU rehearsal)
NEAR_TIE = 1e-4    # a top-2 logit gap below this share of the top logit
PEAK_BF16 = 989e12  # the H100's dense bf16 rate (the mfu's denominator)


def _lm_cfg(arch, **changes):
    import dataclasses

    return dataclasses.replace(arch.smoke_cfg if LM_SMOKE else arch.cfg,
                               **changes)


def _lm_rules():
    from repro_torch.dist.sharding import default_rules
    from repro_torch.launch.mesh import make_local_mesh

    return default_rules(make_local_mesh(DEVICE))


def _sync(torch):
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _step_profile(torch, fn, reps: int = 3) -> dict:
    """One call of ``fn``: its host ms (ending in a synchronize), and on the
    card the device ms its kernels take and its kernel launches, from
    torch.profiler's CUDA trace: the share the card idles is 1 - device /
    host."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync(torch)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(torch)
    out = {"host_ms": (time.perf_counter() - t0) / reps * 1e3}
    if DEVICE != "cuda":
        return out
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_time_total > 0]
    out["device_ms"] = sum(e.device_time_total for e in evs) / reps / 1e3
    out["launches"] = sum(e.count for e in evs) / reps
    return out


def _sequential(torch, T, params, cfg, rules, prompt, n_new, max_ctx):
    """One request alone: ``prefill_step``, then ``decode_step`` at B = 1;
    its tokens and, at each, the top-2 logit gap over the top logit."""
    dev = params["embed"].device
    S = len(prompt)
    logits, cache = T.prefill_step(
        params, torch.as_tensor(prompt[None], device=dev), cfg, rules)
    big = T.make_cache(cfg, 1, max_ctx, device=dev)
    for b, c in zip(big, cache):
        b[:, :, :S] = c
    toks, gaps, lg = [], [], logits[0]
    for step in range(n_new + 1):
        top2 = torch.topk(lg.float(), 2).values
        gaps.append(float((top2[0] - top2[1]) / top2[0].abs()))
        toks.append(int(torch.argmax(lg)))
        if step == n_new:
            return toks, gaps
        lg, big = T.decode_step(params, torch.tensor([[toks[-1]]], device=dev),
                                big, S + step, cfg, rules)
        lg = lg[0]


def _serve(torch, T, cfg, params, rules, prompts):
    """The engine over the requests: their tokens and the engine's figures."""
    from repro_torch.serve.lm_engine import DecodeRequest, LMDecodeEngine

    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    eng = LMDecodeEngine(cfg, params, rules, n_slots=LM_SERVE["slots"],
                         max_ctx=LM_SERVE["max_ctx"])
    reqs = [DecodeRequest(prompt=p, max_new_tokens=LM_SERVE["new"])
            for p in prompts]
    stats = eng.run(list(reqs))
    if not all(r.done and len(r.tokens) == LM_SERVE["new"] + 1 for r in reqs):
        raise AssertionError(f"lm serve {cfg.name}: a request did not finish")
    # one decode step of the full slot pool, as the engine runs it
    dev = params["embed"].device
    token = torch.zeros((LM_SERVE["slots"], 1), dtype=torch.int64, device=dev)
    lens = torch.as_tensor([len(p) for p in prompts[:LM_SERVE["slots"]]],
                           device=dev)
    step = _step_profile(torch, lambda: T.decode_step(
        params, token, eng.cache, lens, cfg, rules))
    return [r.tokens for r in reqs], {
        "requests": stats["requests"], "decode_steps": stats["decode_steps"],
        "mean_occupancy": stats["mean_occupancy"],
        "prefill_ms": stats["prefill_s"] / stats["requests"] * 1e3,
        "decode_tokens_per_s": stats["decode_tokens"] / stats["decode_s"],
        "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                    if DEVICE == "cuda" else None),
        "decode_step": step}


def lm_serve(torch, arch_id, seed) -> dict:
    """(a) One model served in f32 (TF32 off) and in bf16: 8 requests of
    64-512 prompt tokens and 32 new tokens through ``LMDecodeEngine``, 4
    slots, max_ctx 2048, seeded weights at the published widths.  The f32
    tokens must equal the sequential prefill + decode's, request for
    request; a request may diverge only where the sequential run's top-2
    logit gap lies below ``NEAR_TIE`` of its top logit, and is printed and
    compared no further.  bf16 prints its prefill logits' largest error
    against f32 and the top-1 agreement over every prompt position."""
    import torch.utils._pytree as pytree

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T

    arch = get_arch(arch_id)
    cfg = _lm_cfg(arch, dtype=torch.float32)
    rules = _lm_rules()
    params = T.init_params(cfg, seed, device=DEVICE)
    n_params = sum(p.numel() for p in pytree.tree_leaves(params))
    if n_params != cfg.n_params:
        raise AssertionError(f"lm {arch_id}: {n_params} params, config "
                             f"{cfg.n_params}")
    rng = np.random.default_rng(seed)
    lo, hi = LM_SERVE["prompt"]
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(lo, hi + 1, LM_SERVE["requests"])]
    out = {"phase": "lm", "part": "serve", "arch": arch_id,
           "n_params": n_params, "prompt_tokens": [len(p) for p in prompts]}
    t0 = time.perf_counter()

    toks32, out["f32"] = _serve(torch, T, cfg, params, rules, prompts)
    near_ties = []
    for r, (p, got) in enumerate(zip(prompts, toks32)):
        want, gaps = _sequential(torch, T, params, cfg, rules, p,
                                 LM_SERVE["new"], LM_SERVE["max_ctx"])
        diff = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                    None)
        if diff is None:
            continue
        if gaps[diff] >= NEAR_TIE:
            raise AssertionError(
                f"lm {arch_id} f32: request {r} differs from the sequential "
                f"decode at token {diff} (gap {gaps[diff]:.3g} of the top "
                f"logit; engine {got[diff:diff + 4]}, sequential "
                f"{want[diff:diff + 4]})")
        near_ties.append({"request": r, "token": diff,
                          "gap_over_top": gaps[diff]})
    out["f32"]["sequential_match"] = True
    out["f32"]["near_ties"] = near_ties

    cfg16 = _lm_cfg(arch, dtype=torch.bfloat16)
    params16 = pytree.tree_map(lambda t: t.to(torch.bfloat16), params)
    toks16, out["bf16"] = _serve(torch, T, cfg16, params16, rules, prompts)
    err, agree, total = 0.0, 0, 0
    with torch.no_grad():
        for p in prompts:
            tok = torch.as_tensor(p[None], device=params["embed"].device)
            l32 = T.forward(params, tok, cfg, rules)[0]
            l16 = T.forward(params16, tok, cfg16, rules)[0].float()
            err = max(err, float((l16 - l32).abs().max()))
            agree += int((l16.argmax(-1) == l32.argmax(-1)).sum())
            total += len(p)
    out["bf16"].update(
        prefill_logits_max_abs_err=err, top1_agreement=agree / total,
        tokens_equal_f32=sum(a == b for a, b in zip(toks16, toks32)))
    if not np.isfinite(err):
        raise AssertionError(f"lm {arch_id} bf16: logits not finite")
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


def _trainer(arch, rules, *, steps, ckpt_dir=None, ckpt_every=None):
    """The launcher's trainer (``launch/train.py --full``) at LM_TRAIN's
    batch and sequence length, seeded."""
    from repro_torch.launch.train import build_parser, lm_trainer

    argv = ["--arch", arch.arch_id, "--steps", str(steps),
            "--batch", str(LM_TRAIN["batch"]), "--seq", str(LM_TRAIN["seq"]),
            "--device", DEVICE]
    if not LM_SMOKE:
        argv.append("--full")
    if ckpt_dir is not None:
        argv += ["--ckpt-dir", str(ckpt_dir), "--ckpt-every", str(ckpt_every)]
    return lm_trainer(arch, build_parser().parse_args(argv), rules)


def _train_figures(torch, arch, trainer_out, cfg) -> dict:
    hist = trainer_out["history"]
    losses = [h["loss"] for h in hist]
    if not (np.isfinite(losses).all() and len(losses) >= 2):
        raise AssertionError(f"lm train {arch.arch_id}: losses {losses}")
    # the first step builds; the rest are the steady state
    step_s = float(np.median([h["sec_per_step"] for h in hist[1:]]))
    flops = 6.0 * cfg.n_active_params * LM_TRAIN["batch"] * LM_TRAIN["seq"]
    return {"losses": losses, "step_ms": step_s * 1e3,
            "first_step_ms": hist[0]["sec_per_step"] * 1e3,
            "model_flops": flops, "mfu": flops / (step_s * PEAK_BF16)}


def _train_split(torch, trainer, cfg, rules) -> dict:
    """One more step of ``trainer`` timed in its two parts: the loss and
    its gradients (forward, remat, backward), then the AdamW update."""
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                             loss_and_grads)

    batch = trainer.to_batch(trainer.stream.next_batch())
    grads = {}

    def fwd_bwd():
        grads["g"] = loss_and_grads(
            lambda p, b: T.lm_loss(p, b, cfg, rules), trainer.params,
            batch)[1]

    out = {"loss_and_grads": _step_profile(torch, fwd_bwd, reps=1)}
    out["adamw"] = _step_profile(torch, lambda: adamw_update(
        AdamWConfig(), trainer.params, grads["g"], trainer.opt_state),
        reps=1)
    return out


def lm_train(torch, seed) -> dict:
    """(b) internlm2-1.8b at its published widths in bf16 (remat full),
    batch 4 x seq 1024, 6 AdamW steps through the launcher's Trainer: the
    loss finite and falling; a run stopped after step 3's checkpoint and a
    second trainer resumed from it must end with the uninterrupted run's
    params bit for bit, under ``torch.use_deterministic_algorithms``.
    granite-moe-1b-a400m then takes 3 steps with a finite loss."""
    import dataclasses
    import shutil
    import tempfile

    import torch.utils._pytree as pytree

    from repro_torch.configs import get_arch
    from repro_torch.train.checkpoint import latest_step

    rules = _lm_rules()
    arch = get_arch(LM_MODELS[0])
    cfg = _lm_cfg(arch)
    steps, at = LM_TRAIN["steps"], LM_TRAIN["ckpt_at"]
    out = {"phase": "lm", "part": "train", "arch": arch.arch_id,
           "dtype": str(cfg.dtype).split(".")[-1], "remat": cfg.remat,
           "remat_policy": cfg.remat_policy, "batch": LM_TRAIN["batch"],
           "seq": LM_TRAIN["seq"], "steps": steps}
    t_phase = time.perf_counter()
    ckpt = Path(tempfile.mkdtemp(prefix="lm_ckpt_"))
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        out["disk_free_gb"] = shutil.disk_usage(ckpt).free / 1e9
        first = _trainer(arch, rules, steps=steps, ckpt_dir=ckpt,
                         ckpt_every=at)
        t0 = time.perf_counter()
        head = first.run(at)                  # stops after step 3's save
        out["run_to_checkpoint_s"] = time.perf_counter() - t0
        if latest_step(ckpt) != at:
            raise AssertionError(f"lm train: latest checkpoint "
                                 f"{latest_step(ckpt)}, not {at}")
        out["checkpoint_gb"] = sum(f.stat().st_size
                                   for f in ckpt.glob("*.npz")) / 1e9
        del first
        gc.collect()
        resumed = _trainer(arch, rules, steps=steps, ckpt_dir=ckpt,
                           ckpt_every=at)
        t0 = time.perf_counter()
        if not resumed.try_resume() or resumed.step != at:
            raise AssertionError("lm train: no resume from step 3")
        out["restore_s"] = time.perf_counter() - t0
        # the resumed run writes no checkpoint of its own: a second 18.9 GB
        # save that nothing reads
        resumed.cfg = dataclasses.replace(resumed.cfg, ckpt_dir=None)
        tail = resumed.run()
        end = pytree.tree_leaves(resumed.params)
        del resumed
        gc.collect()
        whole = _trainer(arch, rules, steps=steps)
        full = whole.run()
        same = [torch.equal(a, b) for a, b in
                zip(pytree.tree_leaves(whole.params), end)]
        if not all(same):
            raise AssertionError(f"lm train: the resumed run differs from "
                                 f"the uninterrupted one in "
                                 f"{same.count(False)} of {len(same)} params")
        out["resume_bit_equal"] = True
        out["resumed_losses"] = [h["loss"] for h in head["history"]
                                 + tail["history"]]
        if out["resumed_losses"] != [h["loss"] for h in full["history"]]:
            raise AssertionError("lm train: resumed losses differ")
        out["step_split"] = _train_split(torch, whole, cfg, rules)
        del whole, end
    finally:
        torch.use_deterministic_algorithms(det)
        shutil.rmtree(ckpt, ignore_errors=True)
    out.update(_train_figures(torch, arch, full, cfg))
    if not out["losses"][-1] < out["losses"][0]:
        raise AssertionError(f"lm train: the loss did not fall "
                             f"{out['losses']}")
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    moe = get_arch(LM_MODELS[1])
    moe_run = _trainer(moe, rules, steps=LM_TRAIN["moe_steps"])
    out["moe"] = {"arch": moe.arch_id,
                  **_train_figures(torch, moe, moe_run.run(), _lm_cfg(moe)),
                  "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                              if DEVICE == "cuda" else None)}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


def phase_lm(torch, seed: int) -> dict:
    """The LM family on the card at two models' published widths: the
    decode engine for each (``lm_serve``), then the trainer
    (``lm_train``)."""
    t0 = time.perf_counter()
    out = {"serve": {}}
    _reset_counts()
    for arch_id in LM_MODELS:
        out["serve"][arch_id] = lm_serve(torch, arch_id, seed)
        gc.collect()
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    out["train"] = lm_train(torch, seed)
    # the LM path runs none of the port's kernels: its products are the
    # library's, as the reference's are plain jnp
    out["launches"] = _counts()
    if any(out["launches"].values()):
        raise AssertionError(f"lm: kernel launches {out['launches']}")
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "lm", "launches": out["launches"],
          "seconds": out["seconds"]})
    return out


# -- the GNN and recsys families ------------------------------------------------

RECSYS_SMOKE = False  # True: the archs' smoke configs and small graphs (a
#                       CPU rehearsal)
# pna_steps: full_graph_sm's and molecule's; minibatch_lg and ogb_products
# take `steps`, so that their host-built graphs and ogb_products' seconds-long
# step leave the phase as short as it can be
RECSYS_TRAIN = dict(two_tower_batch=16_384, steps=3, pna_steps=5, lr=1e-4)
# minibatch_lg's source graph: Reddit's nodes, edges, features and classes
PNA_SOURCE = dict(n=232_965, e=114_615_892, d_feat=602, n_classes=41)
# ogb_products' check of the edge-chunked path against the whole-edge path:
# the first 4,000,000 edges among the first 409,600 nodes (a whole-edge step
# peaks at about 50 GB there; over all 2.45M nodes its node side alone
# would keep 88 GB)
PNA_OGB_SUB = dict(nodes=409_600, edges=4_000_000)
F64_RTOL = 1e-4   # a forward against the same function in f64, relative


def _family_arch(arch_id):
    """The registered arch, or (RECSYS_SMOKE) a copy at its smoke config."""
    import copy

    from repro_torch.configs import get_arch

    arch = get_arch(arch_id)
    if RECSYS_SMOKE and hasattr(arch, "smoke_cfg"):
        arch = copy.copy(arch)
        arch.cfg = arch.smoke_cfg
    return arch


def _reset_peak(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak_gb(torch):
    return torch.cuda.max_memory_allocated() / 1e9 if DEVICE == "cuda" \
        else None


def _free(torch) -> None:
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()


def _rel_err(got, want) -> float:
    """max |got - want| over max |want|, ``want`` in f64."""
    return float((got.double() - want).abs().max()
                 / want.abs().max().clamp(min=1e-300))


def _check_f64(name, got, want, slack: float = 0.0) -> float:
    """``got``'s relative error from ``want`` (the same function in f64),
    which must be at most F64_RTOL + ``slack``."""
    err = _rel_err(got, want)
    if not err <= F64_RTOL + slack:
        raise AssertionError(f"{name}: {err} from f64, above {F64_RTOL} + "
                             f"{slack}")
    return err


def _spec_args(spec, rules, args, name) -> tuple:
    """``args`` checked against the shapes and dtypes the spec takes."""
    for a, t in zip(spec.call_args(rules), args):
        if tuple(a.shape) != tuple(t.shape) or a.dtype != t.dtype:
            raise AssertionError(f"{name}: the spec takes {tuple(a.shape)} "
                                 f"{a.dtype}, given {tuple(t.shape)} "
                                 f"{t.dtype}")
    return tuple(args)


def _train(torch, loss_fn, params, next_batch, steps) -> dict:
    """``steps`` AdamW steps (lr RECSYS_TRAIN["lr"], one warmup step) of
    the arch's train step, a batch from ``next_batch(i)`` each: the losses
    (finite and falling, last below first), each step's ms and its
    batch's, peak GB."""
    from repro_torch.configs.base import train_step_fn
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state

    step = train_step_fn(loss_fn, AdamWConfig(
        lr=RECSYS_TRAIN["lr"], warmup_steps=1, total_steps=steps))
    opt = init_opt_state(params)
    _sync(torch)
    _reset_peak(torch)
    out = {"losses": [], "step_ms": [], "batch_ms": []}
    for i in range(steps):
        t0 = time.perf_counter()
        batch = next_batch(i)
        _sync(torch)
        t1 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        out["losses"].append(float(metrics["loss"]))
        _sync(torch)
        out["step_ms"].append((time.perf_counter() - t1) * 1e3)
        out["batch_ms"].append((t1 - t0) * 1e3)
        del batch
    out["peak_gb"] = _peak_gb(torch)
    losses = out["losses"]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"losses {losses} not finite and falling")
    del opt, params
    return out


def _two_tower(torch, seed, mesh, rules) -> dict:
    """two-tower-retrieval at its published widths (seeded weights):
    retrieval_cand through K1 -> K2 -> K3, serve_p99, and training at
    batch RECSYS_TRAIN["two_tower_batch"]."""
    import dataclasses

    import torch.utils._pytree as pytree

    from repro_torch.configs.flexvec import pem_serve_step_plain
    from repro_torch.configs.recsys_archs import OVER, POOL, SHAPES
    from repro_torch.data import recsys as RD
    from repro_torch.models import recsys as R

    arch = _family_arch("two-tower-retrieval")
    cfg = arch.cfg
    dev = torch.device(DEVICE)
    out = {"arch": arch.arch_id}
    t0 = time.perf_counter()
    params = R.twotower_init(cfg, seed, device=DEVICE)
    leaves = pytree.tree_leaves(params)
    _sync(torch)
    out["param_gb"] = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    out["init_s"] = time.perf_counter() - t0

    # retrieval_cand: the candidates are the item tower over ids 0..n-1
    t0 = time.perf_counter()
    n = SHAPES["retrieval_cand"]["n_candidates"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        cand = R.item_tower(params, torch.arange(n, device=dev) % cfg.vocab_item,
                            cfg, rules)
    days = torch.rand(n, generator=gen, device=dev) * 90.0
    raw = RD.twotower_batch(1, cfg.vocab_user, cfg.vocab_item, cfg.hist_len,
                            seed)
    user = [torch.from_numpy(raw[k]).to(dev) for k in ("user_id", "hist")]
    spec = arch.build("retrieval_cand", mesh, rules)
    args = _spec_args(spec, rules, (*leaves, *user, cand, days),
                      "retrieval_cand")
    _sync(torch)
    _reset_peak(torch)
    _reset_counts()
    idx, val = spec.fn(*args)
    _sync(torch)
    counts = _counts()
    peak = _peak_gb(torch)
    expect = {"pem_score": 1, "topk": 6, "mmr": 1}
    if DEVICE == "cpu":  # the plain versions count nothing
        expect = dict.fromkeys(expect, 0)
    if counts != expect:
        raise AssertionError(f"two-tower retrieval_cand: launches {counts}, "
                             f"expected {expect}")
    if tuple(idx.shape) != (1, POOL) or not bool(torch.isfinite(val).all()):
        raise AssertionError("two-tower retrieval_cand: picks or values")
    with torch.no_grad():
        u = R.user_tower(params, dict(zip(("user_id", "hist"), user)), cfg,
                         rules).T.contiguous()
    zero = torch.zeros_like(u)
    wi, wv = pem_serve_step_plain(cand, days, u, zero, pool=POOL, over=OVER)
    swaps = check_ranking("two-tower retrieval_cand",
                          list(zip(idx[0].tolist(), val[0].tolist())),
                          list(zip(wi[0].tolist(), wv[0].tolist())))
    ret = {"n": n, "d": cand.shape[1], "launches": counts,
           "adjacent_swaps": swaps, "n_swaps": len(swaps),
           "peak_gb": peak}
    if DEVICE == "cuda":
        from repro_torch.kernels.mmr import kernel as mmr_kernel
        from repro_torch.kernels.pem_score import kernel as pem_kernel

        ret["k1_launch"] = pem_kernel.plan(n, cand.shape[1], 1)
        ret["k3_launch"] = mmr_kernel.shape(OVER, cand.shape[1])
    ret.update(_flexvec_kernels(torch, cand, days, u, zero, OVER, POOL, TOL))
    ret["step_ms"] = time_ms(torch, lambda: spec.fn(*args), 10)
    ret["plain_step_ms"] = time_ms(torch, lambda: pem_serve_step_plain(
        cand, days, u, zero, pool=POOL, over=OVER), 1)
    ret["seconds"] = time.perf_counter() - t0
    out["retrieval_cand"] = ret
    emit({"phase": "recsys_gnn", "part": "two-tower retrieval_cand",
          "param_gb": out["param_gb"], "init_s": out["init_s"], **ret})
    del cand, days, idx, val, wi, wv, args
    _free(torch)

    # serve_p99: the user tower at batch 512 against itself in f64 (the
    # rows it reads and the tower's weights widened)
    t0 = time.perf_counter()
    b = SHAPES["serve_p99"]["batch"]
    raw = RD.twotower_batch(b, cfg.vocab_user, cfg.vocab_item, cfg.hist_len,
                            seed + 1)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    spec = arch.build("serve_p99", mesh, rules)
    args = _spec_args(spec, rules, (*leaves, *batch.values()), "serve_p99")
    got = spec.fn(*args)
    uid, hist = batch["user_id"].long(), batch["hist"].long()
    p64 = {"user_table": params["user_table"].index_select(0, uid).double(),
           "item_table": params["item_table"].index_select(
               0, hist.clamp(min=0).reshape(-1)).double(),
           "user_w": [w.double() for w in params["user_w"]],
           "user_b": [w.double() for w in params["user_b"]]}
    b64 = {"user_id": torch.arange(b, device=dev),
           "hist": torch.where(hist >= 0, torch.arange(
               hist.numel(), device=dev).view(hist.shape), -1)}
    with torch.no_grad():
        want = R.user_tower(p64, b64, dataclasses.replace(
            cfg, dtype=torch.float64), rules)
    serve = {"batch": b, "f64_rel_err": _check_f64("two-tower serve_p99",
                                                   got, want),
             "ms": time_ms(torch, lambda: spec.fn(*args), 20),
             "seconds": time.perf_counter() - t0}
    out["serve_p99"] = serve
    emit({"phase": "recsys_gnn", "part": "two-tower serve_p99", **serve})
    del got, want, p64, args

    # training at its full tables (the batch cut: the in-batch logits are
    # B x B)
    t0 = time.perf_counter()
    b = RECSYS_TRAIN["two_tower_batch"]
    raw = RD.twotower_batch(b, cfg.vocab_user, cfg.vocab_item, cfg.hist_len,
                            seed + 2)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    del leaves
    train = _train(torch, lambda p, bb: R.twotower_loss(p, bb, cfg, rules),
                   params, lambda i: batch, RECSYS_TRAIN["steps"])
    train.update(batch=b, seconds=time.perf_counter() - t0)
    out["train"] = train
    emit({"phase": "recsys_gnn", "part": "two-tower train", **train})
    del params, batch
    _free(torch)
    return out


def _ctr(torch, arch_id, seed, mesh, rules) -> dict:
    """A pointwise CTR arch (bst, autoint) at its published widths: the
    serve_p99 and serve_bulk forwards through the cell's spec, each
    against the same function in f64, then training at train_batch."""
    import dataclasses

    import torch.utils._pytree as pytree

    from repro_torch.configs.recsys_archs import SHAPES, smoke_data

    arch = _family_arch(arch_id)
    cfg = arch.cfg
    out = {"arch": arch_id}
    t0 = time.perf_counter()
    params = arch._init(cfg, seed, device=DEVICE)
    leaves = pytree.tree_leaves(params)
    p64 = pytree.tree_map(lambda t: t.double(), params)
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
    for k, shape in enumerate(("serve_p99", "serve_bulk")):
        b = SHAPES[shape]["batch"] if not RECSYS_SMOKE else 64 * (k + 1)
        batch = smoke_data(arch_id, cfg, b, DEVICE, seed=seed + k)
        spec = arch.build(shape, mesh, rules)
        args = (*leaves, *batch.values())
        if not RECSYS_SMOKE:
            _spec_args(spec, rules, args, f"{arch_id} {shape}")
        _reset_peak(torch)
        got = spec.fn(*args)
        with torch.no_grad():
            want = arch._fwd(p64, batch, cfg64, rules)
        out[shape] = {"batch": b,
                      "f64_rel_err": _check_f64(f"{arch_id} {shape}", got,
                                                want),
                      "ms": time_ms(torch, lambda: spec.fn(*args), 5),
                      "peak_gb": _peak_gb(torch)}
        del got, want, batch, args
    del p64
    _free(torch)
    b = SHAPES["train_batch"]["batch"] if not RECSYS_SMOKE else 256
    batch = smoke_data(arch_id, cfg, b, DEVICE, seed=seed + 2)
    del leaves
    out["train"] = _train(torch, lambda p, bb: arch._loss(p, bb, cfg, rules),
                          params, lambda i: batch, RECSYS_TRAIN["steps"])
    out["train"]["batch"] = b
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "recsys_gnn", "part": arch_id, **out})
    del params, batch
    _free(torch)
    return out


def _pna(torch, seed, rules) -> dict:
    """PNA at its published widths: minibatch_lg (the Reddit-scale source
    graph on the host, its CSR, then RECSYS_TRAIN["steps"] steps each
    on a fresh 1,024-seed subgraph at fanout 15-10), full_graph_sm and
    molecule; each part's first batch's forward against f64."""
    import dataclasses

    import torch.utils._pytree as pytree

    from repro_torch.configs.gnn import GNN_SHAPES, graph_batch
    from repro_torch.data.graph import (CSRGraph, make_graph,
                                        make_molecule_batch, sample_subgraph)
    from repro_torch.models import pna

    arch = _family_arch("pna")
    out = {}
    for shape in ("minibatch_lg", "full_graph_sm", "molecule"):
        s = GNN_SHAPES[shape]
        cfg = arch._cfg(s)
        t0 = time.perf_counter()
        part = {"shape": shape}
        if shape == "minibatch_lg":
            src = PNA_SOURCE if not RECSYS_SMOKE else dict(
                n=5_000, e=50_000, d_feat=s["d_feat"], n_classes=41)
            g = make_graph(src["n"], src["e"], src["d_feat"],
                           n_classes=src["n_classes"], seed=seed)
            part["graph_s"] = time.perf_counter() - t0
            t1 = time.perf_counter()
            csr = CSRGraph(src["n"], g.edge_src, g.edge_dst)
            part["csr_s"] = time.perf_counter() - t1
            part["source"] = {"nodes": src["n"], "edges": src["e"]}
            seeds = s["seeds"] if not RECSYS_SMOKE else 64

            def next_batch(i, g=g, csr=csr, n=src["n"], seeds=seeds):
                rng = np.random.default_rng(seed + i)
                sub = sample_subgraph(g, csr, rng.choice(n, seeds,
                                                         replace=False),
                                      s["fanouts"], rng)
                return graph_batch(sub, DEVICE)
        else:
            if shape == "full_graph_sm":
                g = make_graph(s["n"], s["e"], s["d_feat"],
                               n_classes=s["n_classes"], seed=seed)
            else:
                g = make_molecule_batch(s["batch"], s["nodes"], s["edges"],
                                        s["d_feat"], n_classes=s["n_classes"],
                                        seed=seed)
            fixed = graph_batch(g, DEVICE)

            def next_batch(i, fixed=fixed):
                return fixed
        params = pna.init_params(cfg, seed, device=DEVICE)
        first = next_batch(0)
        part["nodes"], part["edges"] = (int(first["feats"].shape[0]),
                                        int(first["edge_src"].shape[0]))
        # PNA's std aggregator, sqrt(relu(E[m^2] - E[m]^2) + 1e-5), cancels
        # in f32 where a node's messages (nearly) agree, and the scalers
        # carry it on (2.5 / 1e-5 for a node without in-edges): the card's
        # f32 forward is held to f64 within F64_RTOL plus twice the CPU's
        # f32 error on the same inputs
        p64 = pytree.tree_map(lambda t: t.double(), params)
        with torch.no_grad():
            got = pna.forward(params, first, cfg, rules)
            want = pna.forward(p64, first, dataclasses.replace(
                cfg, dtype=torch.float64), rules)
            cpu = pna.forward(pytree.tree_map(lambda t: t.cpu(), params),
                              {k: v.cpu() for k, v in first.items()}, cfg,
                              rules)
        part["cpu_f32_rel_err"] = _rel_err(cpu, want.cpu())
        part["f64_rel_err"] = _check_f64(f"pna {shape}", got, want,
                                         2.0 * part["cpu_f32_rel_err"])
        del got, want, cpu, p64, first
        part["train"] = _train(torch,
                               lambda p, b, cfg=cfg: pna.loss_fn(p, b, cfg,
                                                                 rules),
                               params, next_batch, RECSYS_TRAIN[
                                   "steps" if shape == "minibatch_lg"
                                   else "pna_steps"])
        part["seconds"] = time.perf_counter() - t0
        emit({"phase": "recsys_gnn", "part": f"pna {shape}", **part})
        out[shape] = part
        del g, params, next_batch
        _free(torch)
    out["ogb_products"] = _pna_ogb(torch, seed, rules)
    return out


def _pad_graph(g, n: int, e: int):
    """``g`` padded to ``n`` nodes and ``e`` edges as the reference's cells
    pad (``configs/gnn.py`` ``_round512``): the padded nodes are masked and
    the padded edges, masked too, point at the sink, node ``n - 1``."""
    from repro_torch.data.graph import GraphBatch

    n0, e0 = g.feats.shape[0], g.edge_src.shape[0]
    if not (n0 < n and e0 <= e):
        raise ValueError(f"{n0} nodes / {e0} edges leave no sink in {n} / {e}")

    def pad(a, size, fill):
        out = np.full((size,) + a.shape[1:], fill, a.dtype)
        out[:len(a)] = a
        return out

    return GraphBatch(
        feats=pad(g.feats, n, 0.0), edge_src=pad(g.edge_src, e, n - 1),
        edge_dst=pad(g.edge_dst, e, n - 1), labels=pad(g.labels, n, 0),
        node_mask=pad(g.node_mask, n, False),
        edge_mask=pad(g.edge_mask, e, False))


def _pna_ogb(torch, seed, rules) -> dict:
    """PNA's ogb_products cell on one card: the reference's seeded graph
    at OGB ogbn-products' published size, padded to 512 multiples
    (2,449,408 nodes, 61,859,328 edges), through the edge-chunked path.
    First a subgraph (``PNA_OGB_SUB``): its forward on the CPU in f32
    against the card's f64 (the CPU's own f32 error; the whole graph takes
    minutes there), then the chunked path against the whole-edge path,
    the loss, logits and every gradient, each within F64_RTOL plus twice
    that error.  Then the whole graph: the forward against f64 on the card
    within the same (its device time by kernel traced), and
    RECSYS_TRAIN["steps"] AdamW steps."""
    import dataclasses

    import torch.utils._pytree as pytree

    from repro_torch.configs.base import named_leaves
    from repro_torch.configs.gnn import GNN_SHAPES, _round512, graph_batch
    from repro_torch.data.graph import GraphBatch, make_graph
    from repro_torch.models import pna
    from repro_torch.train.optimizer import loss_and_grads

    s = GNN_SHAPES["ogb_products"]
    cfg = _family_arch("pna")._cfg(s)
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
    budget = pna.EDGE_BUDGET
    if RECSYS_SMOKE:   # small graphs, and a budget that still chunks them
        src_n, src_e, sub_n, sub_e = 5_000, 120_000, 1_024, 8_000
        budget = 4 << 20
    else:
        src_n, src_e = s["n"], s["e"]
        sub_n, sub_e = PNA_OGB_SUB["nodes"], PNA_OGB_SUB["edges"]
    t0 = time.perf_counter()
    part = {"shape": "ogb_products",
            "card": _smi() if DEVICE == "cuda" else DEVICE}
    g = make_graph(src_n, src_e, s["d_feat"], n_classes=s["n_classes"],
                   seed=seed)
    g = _pad_graph(g, _round512(src_n), _round512(src_e))
    part["graph_s"] = time.perf_counter() - t0
    n, e = g.feats.shape[0], g.edge_src.shape[0]
    chunk = pna.edge_chunk(e, cfg.d_hidden, cfg.dtype, budget)
    if chunk is None:
        raise AssertionError(f"ogb_products: {e} edges on the whole-edge "
                             "path")
    part.update(nodes=n, edges=e, d_feat=s["d_feat"],
                layers=cfg.n_layers, d_hidden=cfg.d_hidden, chunk=chunk,
                chunks=-(-e // chunk))
    params = pna.init_params(cfg, seed, device=DEVICE)
    p64 = pytree.tree_map(lambda t: t.double(), params)

    # the subgraph: the first sub_e edges among the first sub_n nodes
    keep = np.flatnonzero((g.edge_src < sub_n) & (g.edge_dst < sub_n))
    if len(keep) < sub_e:
        raise AssertionError(f"ogb_products: {len(keep)} edges among the "
                             f"first {sub_n} nodes, fewer than {sub_e}")
    keep = keep[:sub_e]
    sub = _pad_graph(GraphBatch(
        feats=g.feats[:sub_n], edge_src=g.edge_src[keep],
        edge_dst=g.edge_dst[keep], labels=g.labels[:sub_n],
        node_mask=g.node_mask[:sub_n], edge_mask=g.edge_mask[keep]),
        _round512(sub_n + 1), _round512(sub_e))
    del keep
    sb = graph_batch(sub, DEVICE)
    sp = {"nodes": sub.feats.shape[0], "edges": sub.edge_src.shape[0],
          "chunk": pna.edge_chunk(sub.edge_src.shape[0], cfg.d_hidden,
                                  cfg.dtype, budget)}
    t1 = time.perf_counter()
    with torch.no_grad():
        want = pna.forward(p64, sb, cfg64, rules, budget).cpu()
        # the same function on the CPU's faster whole-edge path
        cpu = pna.forward(pytree.tree_map(lambda t: t.cpu(), params),
                          {k: v.cpu() for k, v in sb.items()}, cfg, rules,
                          float("inf"))
    sp["cpu_f32_rel_err"] = _rel_err(cpu, want)
    sp["cpu_s"] = time.perf_counter() - t1
    slack = 2.0 * sp["cpu_f32_rel_err"]
    del want, cpu
    runs = {}
    for path, b_path in (("chunked", budget), ("whole_edge", float("inf"))):
        _sync(torch)
        _reset_peak(torch)
        t1 = time.perf_counter()
        loss, grads = loss_and_grads(
            lambda p, b, bp=b_path: pna.loss_fn(p, b, cfg, rules, bp),
            params, sb)
        _sync(torch)
        sp[f"{path}_ms"] = (time.perf_counter() - t1) * 1e3
        sp[f"{path}_peak_gb"] = _peak_gb(torch)
        with torch.no_grad():
            logits = pna.forward(params, sb, cfg, rules, b_path)
        runs[path] = [loss, logits] + pytree.tree_leaves(grads)
        del loss, grads, logits
        _free(torch)
    names = ["loss", "logits"] + [k for k, _ in named_leaves(params)]
    sp["rel_err"] = {}
    for name, a, b in zip(names, runs["chunked"], runs["whole_edge"]):
        err = _rel_err(a, b.double())
        if not err <= F64_RTOL + slack:
            raise AssertionError(f"pna ogb_products subgraph: {name}: "
                                 f"chunked {err} from the whole-edge path, "
                                 f"above {F64_RTOL} + {slack}")
        sp["rel_err"][name] = err
    part["subgraph"] = sp
    del runs, sb, sub
    _free(torch)

    # the whole graph
    fb = graph_batch(g, DEVICE)
    del g
    def fwd():
        return pna.forward(params, fb, cfg, rules, budget)

    _sync(torch)
    _reset_peak(torch)
    t1 = time.perf_counter()
    with torch.no_grad():
        if DEVICE == "cuda":   # traced: the device ms of its top kernels
            got, us = traced_us(torch, fwd, 1)
            ms = {}
            for k, v in us.items():     # names cut short, their times added
                ms[k[:80]] = ms.get(k[:80], 0.0) + v / 1e3
            part["forward_device_ms"] = {"all": sum(ms.values()), **dict(
                sorted(ms.items(), key=lambda kv: -kv[1])[:8])}
        else:
            got = fwd()
        part["forward_ms"] = (time.perf_counter() - t1) * 1e3
        want = pna.forward(p64, fb, cfg64, rules, budget)
    part["forward_peak_gb"] = _peak_gb(torch)
    part["f64_rel_err"] = _check_f64("pna ogb_products", got, want, slack)
    part["f64_slack"] = slack
    del got, want, p64
    _free(torch)
    part["train"] = _train(torch,
                           lambda p, b: pna.loss_fn(p, b, cfg, rules, budget),
                           params, lambda i: fb, RECSYS_TRAIN["steps"])
    part["seconds"] = time.perf_counter() - t0
    emit({"phase": "recsys_gnn", "part": "pna ogb_products", **part})
    del params, fb
    _free(torch)
    return part


def phase_recsys_gnn(torch, seed: int) -> dict:
    """The GNN and recsys families on the card at their published widths,
    seeded from ``seed``: two-tower-retrieval (retrieval_cand through
    K1 -> K2 -> K3 against the plain step, serve_p99, training), bst and
    autoint (serve forwards, training), PNA (minibatch_lg through the
    neighbour sampler, full_graph_sm, molecule on the whole-edge path,
    ogb_products on the edge-chunked one).  dlrm-mlperf (96.1 GB of
    tables) runs only as a dry-run cell.  The phase's launches are those
    of the retrieval_cand step's one run."""
    from repro_torch.dist.sharding import default_rules
    from repro_torch.launch.mesh import make_local_mesh

    t0 = time.perf_counter()
    mesh = make_local_mesh(DEVICE)
    rules = default_rules(mesh)
    out = {"two_tower": _two_tower(torch, seed, mesh, rules)}
    out["launches"] = out["two_tower"]["retrieval_cand"]["launches"]
    for arch_id in ("bst", "autoint"):
        out[arch_id] = _ctr(torch, arch_id, seed, mesh, rules)
    out["pna"] = _pna(torch, seed, rules)
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "recsys_gnn", "launches": out["launches"],
          "seconds": out["seconds"],
          "part_seconds": {
              "two_tower": sum(out["two_tower"][k]["seconds"]
                               for k in ("retrieval_cand", "serve_p99",
                                         "train")),
              "bst": out["bst"]["seconds"],
              "autoint": out["autoint"]["seconds"],
              "pna": sum(p["seconds"] for p in out["pna"].values())}})
    return out


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the flexvec_arch phase's inputs, of the "
                         "lm phase's weights and requests, and of the "
                         "recsys_gnn phase's weights and data")
    cli = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs the "
                         "port on an NVIDIA card")
    import repro_torch  # noqa: F401  (fails here, before any output, alone)

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32
    name = phase_device(torch)
    phase_build()
    k1 = phase_pem_score(torch)
    k2 = phase_topk(torch)
    k3 = phase_mmr(torch)
    main_path = phase_main_path(torch)
    one_m = phase_1m(torch)
    paths = {"main_path_240k": main_path["launches"],
             "sharded_1m": phase_sharded_1m(torch, one_m)["launches"],
             "pem_sharded": phase_pem_sharded(torch)["launches"],
             "shard_group_1m": phase_shard_group_1m(torch, one_m)["launches"],
             "service_shard_group_240k":
                 main_path["service_shard_group"]["launches"]}
    paths["torch_engine"] = phase_torch_engine(torch, main_path,
                                               one_m)["launches"]
    main_path.pop("reuse")["conn"].close()
    del one_m  # the 1M store's device copies: the next phase's memory
    gc.collect()
    torch.cuda.empty_cache()
    paths["flexvec_arch"] = phase_flexvec_arch(torch, cli.seed)["launches"]
    behavioral = phase_behavioral(torch)
    paths["behavioral"] = behavioral["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    paths["lm"] = phase_lm(torch, cli.seed)["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    paths["recsys_gnn"] = phase_recsys_gnn(torch, cli.seed)["launches"]

    counts = main_path["launches"]
    picks = [
        ("pem_score", "src/repro_torch/csrc/pem_score.cu",
         "src/repro/kernels/pem_score/kernel.py:47",
         k1[(240_000, 32, "float32")], counts["pem_score"]),
        ("topk", "src/repro_torch/csrc/topk.cu",
         "src/repro/kernels/topk/kernel.py:55",
         k2[(32, 240_000, 2048)], counts["topk"]),
        ("mmr", "src/repro_torch/csrc/mmr.cu",
         "src/repro/kernels/mmr/kernel.py:63",
         k3[(1, 500)], counts["mmr"]),
    ]
    emit({"kernels": [
        {"name": kname, "route": "cuda", "source": src, "replaces": rep,
         "launches": n, "max_abs_err": row["max_abs_err"], "ms": row["ms"],
         "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": row["bound_by"], "library_ms": row["library_ms"],
         "shape": {k: row[k] for k in ("b", "n", "d", "k") if k in row},
         # each path's own run, counts zeroed just before it
         "launches_by_path": {path: c.get(kname, 0)
                              for path, c in paths.items()}}
        for kname, src, rep, row, n in picks]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
