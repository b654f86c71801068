#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one card.

    python3 chip_smoke.py

Needs one NVIDIA card (sm_90a, an H100) and the CUDA toolkit; exits non-zero
with no result line anywhere else.  Imports nothing of JAX or of the
reference package.  Prints one JSON object per line, in order:

1. the device, then nvidia-smi's name and power limit on a line of its own;
2. the kernel build: seconds and each kernel's registers and shared memory;
3. each kernel against its plain PyTorch version on the card at the main
   path's shapes (max error or exact index equality, the kernel's time,
   the plain version's, one library call's where one computes the same
   function, and the bound from the shapes);
4. the main path at the paper's production size: 240k chunks through
   SQLite into ``RetrievalService`` on ``HopperBackend("cuda")``, the
   composed query through ``flex_search``, then 64 requests from 32
   threads through ``BatchedRetrievalEngine``; every ranking held against
   the ``fused-numpy`` oracle on the same store;
5. the 1M phase: 1,000,448 seeded chunks in four segments with tombstones
   through ``store_from_arrays``, two composed queries against the oracle;
6. the ``kernels`` line (launch counts from the main path's run);
7. ``{"ok": true, "device": {...}}``, the last line.

Any failure raises.  Rankings must equal the oracle's id for id, scores
agree to 1e-5; a candidate pool must equal the oracle's as a set except
for members within 1e-5 of the boundary score, which are printed.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import re
import sqlite3
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

NOW = 1_770_000_000.0
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12      # f32 outside the tensor cores, same source
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float):
    """Least time for the work: bytes over HBM rate vs f32 operations over
    the f32 peak, whichever is larger, and which one it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def phase_device(torch) -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
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
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_info["seconds"],
          "library": _build.build_info["path"], "kernels": kernels})


def phase_pem_score(torch) -> dict:
    from repro_torch.kernels.pem_score.ops import pem_score
    from repro_torch.kernels.pem_score.ref import pem_score_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    d = 128
    rows = {}
    for n in (240_000, SCALE1M_N):
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
                    both = torch.matmul(m, qcat)
                    return decay[:, None] * both[:, :b] + both[:, b:]

                lib = (time_ms(torch, library, iters)
                       if dtype == torch.float32 else None)
                esize = m.element_size()
                t, by = bound_ms(n * d * esize + 2 * d * b * 4 + n * 4
                                 + n * b * 4, 4.0 * n * d * b)
                row = {"phase": "kernel", "name": "pem_score", "n": n, "d": d,
                       "b": b, "dtype": str(dtype).split(".")[-1],
                       "max_abs_err": err, "tol": tol, "ms": ms,
                       "plain_ms": plain, "library_ms": lib, "bound_ms": t,
                       "bound_by": by}
                emit(row)
                rows[(n, b, row["dtype"])] = row
        del base, m
    return rows


def phase_topk(torch) -> dict:
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
        t, by = bound_ms(b * n * 4 + b * k * 8, float(b * n))
        row = {"phase": "kernel", "name": "topk", "b": b, "n": n, "k": k,
               "exact": exact, "max_abs_err": 0.0, "ms": ms,
               "plain_ms": plain, "library_ms": lib, "bound_ms": t,
               "bound_by": by}
        emit(row)
        rows[(b, n, k)] = row
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
    from repro_torch.kernels.mmr.ops import NEG, mmr_select
    from repro_torch.kernels.mmr.ref import mmr_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    d, bucket, pool = 128, 2048, 1500
    rows = {}
    for b, k in ((1, 500), (32, 10), (4, 500)):
        e = torch.randn(b, bucket, d, generator=gen, device=dev)
        e /= e.norm(dim=-1, keepdim=True)
        rel = torch.randn(b, bucket, generator=gen, device=dev) * 0.1
        rel[:, pool:] = NEG
        for lam in ((0.7,) if b != 4 else (0.7, 0.0, 1.0)):
            lam_t = torch.full((b,), lam, device=dev)
            idx, val = mmr_select(e, rel, k, lam_t)
            ir, vr = mmr_ref(e, rel, k, lam_t)
            torch.cuda.synchronize()
            exact = bool(torch.equal(idx, ir))
            err = float((val - vr).abs().max())
            if not exact or err > TOL or int(idx.max()) >= pool:
                raise AssertionError(f"mmr b={b} k={k} lam={lam}: indices "
                                     f"equal {exact}, value error {err}")
            row = {"phase": "kernel", "name": "mmr", "b": b, "n": bucket,
                   "live": pool, "d": d, "k": k, "lam": lam, "exact": exact,
                   "max_abs_err": err}
            if lam == 0.7 and b != 4:
                row["ms"] = time_ms(torch, lambda: mmr_select(e, rel, k, lam_t),
                                    10)
                row["plain_ms"] = time_ms(
                    torch, lambda: mmr_ref(e, rel, k, lam_t), 2)
                row["library_ms"] = None
                # the k dependent steps bound it in practice; the formula's
                # floor is the k * n * d similarity products
                t, by = bound_ms(b * bucket * (d + 1) * 4 + b * k * 8,
                                 2.0 * b * k * pool * d)
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
    counts = _counts()
    stats = engine.stats()
    engine.close()
    fused_stats = svc.cache.fused.stats()
    peak = torch.cuda.max_memory_allocated()

    # the oracle: the same store through fused-numpy
    oracle = Materializer(conn, svc.cache, now=NOW, engine="fused")
    cols, want_rows = oracle.execute(sql)
    if res.columns != cols:
        raise AssertionError(f"columns {res.columns} vs {cols}")
    near_ties = check_ranking("flex_search", res.rows, want_rows)
    for q, got in zip(reqs, served):
        want = svc.cache.search(q, now=NOW, engine="fused")[:10]
        near_ties += check_ranking(f"engine {q!r}", got, want)
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
           "launches": counts, "oracle_match": True,
           "ranking_near_ties": near_ties, "pool_check": pool}
    emit(out)
    svc.close()
    if any(v == 0 for v in counts.values()):
        raise AssertionError(f"a kernel never ran on the main path: {counts}")
    if fused_stats["host_pool_transfers"]:
        raise AssertionError("diverse pools crossed to the host")
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
    for name, tokens in queries:  # the oracle, on the same store
        t0 = time.perf_counter()
        want = cache.search(tokens, now=NOW, engine="fused")
        out[name]["oracle_ms"] = (time.perf_counter() - t0) * 1e3
        out[name]["ranking_near_ties"] = check_ranking(
            f"1M {name}", served[name], want)
        out[name]["oracle_match"] = True
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    emit(out)
    if not out["launches"]["mmr"] or out["host_pool_transfers"]:
        raise AssertionError("the merged-pool MMR path did not run on the "
                             "card")
    return out


def main() -> None:
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
    phase_1m(torch)

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
         "shape": {k: row[k] for k in ("b", "n", "d", "k") if k in row}}
        for kname, src, rep, row, n in picks]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
