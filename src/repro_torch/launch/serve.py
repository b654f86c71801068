"""Serving launcher: FLEXVEC retrieval service on the Hopper kernels.

    PYTHONPATH=src python -m repro_torch.launch.serve --chunks 50000 \
        --queries 64 [--sql "SELECT ..."] [--device cpu]

Builds a production-like corpus, starts the micro-batching engine + the
agent-facing SQL endpoint, serves a concurrent workload, prints latency
stats.  Both the SQL endpoint and the batched engine score through one
:class:`HopperBackend`: the pem_score -> topk -> mmr kernels on the card
(``--device cuda``, the default), or their plain versions on the CPU
(``--device cpu``).
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import sqlite3
import time

from repro_torch.core.backends import HopperBackend
from repro_torch.data.corpus import build_database, generate_corpus
from repro_torch.embed import HashEmbedder
from repro_torch.serve.engine import BatchedRetrievalEngine
from repro_torch.serve.retrieval import RetrievalService

NOW = 1_770_000_000.0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=50_000)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run the kernels on the card, or their plain "
                         "versions on the CPU")
    ap.add_argument("--sql", default=None,
                    help="run one SQL statement through flex_search and exit")
    ap.add_argument("--sync-core", action="store_true",
                    help="serialize the host tail behind the device pass "
                         "(the pre-async engine behavior, for comparison)")
    args = ap.parse_args()

    backend = HopperBackend(args.device)
    emb = HashEmbedder(128)
    chunks = generate_corpus(n_chunks=args.chunks,
                             n_sessions=max(20, args.chunks // 50),
                             seed=0, now=NOW)
    conn = sqlite3.connect(":memory:", check_same_thread=False)
    build_database(conn, chunks, emb)
    svc = RetrievalService(conn, dim=128, embedder=emb, now=NOW,
                           engine=backend)

    if args.sql:
        res = svc.flex_search(args.sql)
        if not res.ok:
            raise SystemExit(f"error: {res.error}")
        print(",".join(res.columns))
        for r in res.rows[:50]:
            print(r)
        print(f"-- {len(res.rows)} rows in {res.latency_ms:.1f} ms")
        return

    engine = BatchedRetrievalEngine(svc.cache, max_batch=32, now=NOW,
                                    engine=backend,
                                    pipeline=not args.sync_core)
    topics = ["server lifecycle", "identity provenance", "rendering pipeline",
              "auth token", "database migration"]
    reqs = [f"similar:{topics[i % len(topics)]} diverse decay:30"
            for i in range(args.queries)]
    t0 = time.time()
    with cf.ThreadPoolExecutor(max_workers=32) as ex:
        for out in ex.map(lambda q: engine.search(q, args.k), reqs):
            if len(out) != args.k:
                raise SystemExit(f"error: {len(out)} results, wanted {args.k}")
    wall = time.time() - t0
    stats = engine.stats()
    core = "sync-core" if args.sync_core else "pipelined"
    print(f"served {args.queries} queries in {wall*1e3:.0f} ms "
          f"({args.queries/wall:.0f} q/s) on {backend.device} across "
          f"{stats['batches_served']} fused batches [{core}; "
          f"{stats['overlapped_batches']} overlapped]")
    engine.close()


if __name__ == "__main__":
    main()
