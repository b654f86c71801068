"""The system under test: the port ``repro_torch``, loaded with the
benchmark's corpus through its own loading API, and the entries the
traffic mixes drive.

A configuration's ``store`` says how the rows go in: ``sqlite`` loads them
into an in-memory SQLite (``sqlio.schema.build_schema``,
``insert_sources``, ``insert_chunks``, ``register_presets``) that
``RetrievalService`` then serves; ``arrays`` builds the segmented store
from the arrays (``core.segments.store_from_arrays``) and serves it
through ``VectorCache``.  Each entry returns a request's rows as
``[(id, score), ...]`` and raises on a failed request: ``flex_search``
(one SQL statement through ``RetrievalService.flex_search``) or
``cache_search`` (tokens through ``VectorCache.search``, the direct path
that ``RetrievalService.search`` takes).
"""

from __future__ import annotations

import sqlite3
from typing import Callable, Dict, List

import numpy as np

from harness import corpus as C

ENTRIES = ("flex_search", "cache_search")
INSERT_BATCH = 20_000


class System:
    def __init__(self, config: Dict, corpus: C.Corpus, live: np.ndarray,
                 device: str):
        from repro_torch.core.backends import HopperBackend

        self.config = config
        self.now = float(config["now"])
        self.backend = HopperBackend(device)
        self.svc = None
        dim = int(config["dim"])
        if config["store"] == "sqlite":
            if not live.all() or len(config["segments"]) != 1:
                raise ValueError("a sqlite store is one segment, all live")
            from repro_torch.serve.retrieval import RetrievalService
            from repro_torch.sqlio.presets import register_presets
            from repro_torch.sqlio.schema import (build_schema, insert_chunks,
                                                  insert_sources)

            rows = C.sql_rows(corpus)
            self.conn = sqlite3.connect(":memory:", check_same_thread=False)
            build_schema(self.conn, config.get("description", ""))
            register_presets(self.conn)
            insert_sources(self.conn, rows["sources"])
            for a in range(0, corpus.n, INSERT_BATCH):
                insert_chunks(self.conn, rows["chunks"][a:a + INSERT_BATCH],
                              corpus.matrix[a:a + INSERT_BATCH])
            del rows
            self.svc = RetrievalService(self.conn, dim=dim, now=self.now,
                                        engine=self.backend)
            self.cache = self.svc.cache
        elif config["store"] == "arrays":
            from repro_torch.core.segments import store_from_arrays
            from repro_torch.core.vectorcache import VectorCache
            from repro_torch.embed import HashEmbedder

            store = store_from_arrays([
                {"ids": corpus.ids[a:b], "matrix": corpus.matrix[a:b],
                 "timestamps": corpus.timestamps[a:b],
                 "live_mask": live[a:b]}
                for a, b in C.segment_bounds(corpus.n, config["segments"])])
            self.cache = VectorCache(embed_fn=HashEmbedder(dim), store=store)
        else:
            raise ValueError(f"store {config['store']!r}")

    def entry(self, mix: Dict) -> Callable[[str], List[tuple]]:
        """The callable one request goes through."""
        kind = mix["entry"]
        k = int(mix["k"])
        if kind == "flex_search":
            if self.svc is None:
                raise ValueError("entry flex_search needs a sqlite store")
            svc = self.svc

            def call(sql):
                res = svc.flex_search(sql)
                if not res.ok:
                    raise RuntimeError(res.error)
                return [tuple(r) for r in res.rows]
        elif kind == "cache_search":
            cache, now, backend = self.cache, self.now, self.backend

            def call(tokens):
                return cache.search(tokens, now=now, engine=backend)[:k]
        else:
            raise ValueError(f"entry {kind!r}: one of {ENTRIES}")
        return call

    def counters(self) -> Dict[str, int]:
        """The three kernels' launch counters."""
        from repro_torch.kernels.mmr.ops import mmr_select
        from repro_torch.kernels.pem_score.ops import pem_score
        from repro_torch.kernels.topk.ops import topk

        return {"pem_score": pem_score.launches, "topk": topk.launches,
                "mmr": mmr_select.launches}

    def release(self) -> None:
        """Drop the program's state, so the reference runs after it."""
        if self.svc is not None:
            self.svc.close()
        self.svc = self.cache = self.backend = self.conn = None
