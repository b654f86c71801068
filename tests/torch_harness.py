"""Both packages side by side, for the port's parity suites of flexvec's
filter, hybrid, write and async paths (``tests/test_torch_{prefilter,
hybrid,ingest,serve_async}.py``).

``R`` and ``T`` hold the same modules of ``repro`` and ``repro_torch``
under the same names, so one scenario function runs in either package and
its observations are compared.  ``engine(P, key)`` gives the backend of
each package that the suites pair: the reference's ``PallasBackend``
(interpret mode) with the port's ``HopperBackend("cpu")`` (the kernels'
plain versions), ``JitJaxBackend`` with ``TorchBackend("cpu")``, the
reference's ``ShardedBackend`` (one host device) with the port's over
three CPU shards, and fused-numpy in both.  ``gate_backend`` blocks a
package's scoring pass until the test releases it, so queue states are
pinned exactly.
"""

import importlib
import threading
import time
import types

import numpy as np

TOL = 1e-5
NOW = 90 * 86400.0


def _package(root):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    return types.SimpleNamespace(
        name=root, B=mod("core.backends"), G=mod("core.grammar"),
        J=mod("core.journal"), MZ=mod("core.materializer"),
        M=mod("core.modulations"), S=mod("core.segments"),
        V=mod("core.vectorcache"), C=mod("data.corpus"),
        Hash=mod("embed").HashEmbedder, E=mod("serve.engine"),
        R=mod("serve.retrieval"), VZ=mod("serve.vectorizer"),
        SQL=mod("sqlio.schema"))


R = _package("repro")
T = _package("repro_torch")
PACKAGES = (R, T)

# each key: the reference's backend, and a factory of the port's
_ENGINES = {
    "hopper": (lambda: R.B.PallasBackend(), lambda: T.B.HopperBackend("cpu")),
    "torch": (lambda: R.B.JitJaxBackend(), lambda: T.B.TorchBackend("cpu")),
    "sharded": (lambda: "sharded", lambda: T.B.ShardedBackend(["cpu"] * 3)),
    "fused": (lambda: "fused-numpy", lambda: "fused-numpy"),
}
ENGINES = list(_ENGINES)


def engine(P, key):
    """A fresh backend of package ``P`` for ``key`` (a name for the
    registered numpy and sharded engines)."""
    ref, port = _ENGINES[key]
    return ref() if P is R else port()


def same_ranking(got, want, tol=TOL):
    """(id, score) lists: ids equal in order, scores within ``tol``."""
    assert [int(i) for i, _ in got] == [int(i) for i, _ in want]
    np.testing.assert_allclose([float(s) for _, s in got],
                               [float(s) for _, s in want], atol=tol)


def same_rows(got, want, tol=TOL):
    """SQL result rows: every column equal, floats within ``tol``."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                assert abs(float(a) - float(b)) <= tol, (g, w)
            else:
                assert a == b, (g, w)


def same_stores(a, b):
    """Two stores (of either package) in the same scoring state: segments,
    row order, matrix bits, tombstones and timestamps."""
    assert a.n_segments == b.n_segments
    assert a.n_live == b.n_live
    for sa, sb in zip(a.segments, b.segments):
        assert sa.seg_id == sb.seg_id
        np.testing.assert_array_equal(sa.ids, sb.ids)
        np.testing.assert_array_equal(sa.tombstones, sb.tombstones)
        assert np.asarray(sa.matrix).tobytes() == \
            np.asarray(sb.matrix).tobytes()
        if sa.timestamps is None:
            assert sb.timestamps is None
        else:
            np.testing.assert_array_equal(sa.timestamps, sb.timestamps)


def wait_for(predicate, timeout=10.0, interval=0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def corpus(n=230, d=32, seed=3):
    """Unit rows and timestamps up to 60 days before ``NOW``."""
    rng = np.random.default_rng(seed)
    mat = rng.standard_normal((n, d)).astype(np.float32)
    mat /= np.linalg.norm(mat, axis=1, keepdims=True)
    days = rng.uniform(0.0, 60.0, n).astype(np.float32)
    return mat, NOW - days.astype(np.float64) * 86400.0


def store_from_splits(P, mat, ts, splits, deleted=()):
    store = P.S.SegmentedCorpusStore(dim=mat.shape[1])
    start = 0
    for size in splits:
        store.append(np.arange(start, start + size), mat[start:start + size],
                     ts[start:start + size], normalized=True)
        start += size
    assert start == mat.shape[0]
    if len(deleted):
        store.delete(deleted)
    return store


def make_cache(P, n=200, dim=32):
    emb = P.Hash(dim)
    texts = [f"item group {i % 7} tail {i}" for i in range(n)]
    return P.V.VectorCache(np.arange(n), emb.embed_batch(texts),
                           np.linspace(0, 89 * 86400, n), emb), emb


def database(P, n_chunks, n_sessions, seed, dim):
    """A seeded corpus built through ``P``'s own SQLite schema; returns
    (connection, embedder)."""
    import sqlite3

    emb = P.Hash(dim)
    conn = sqlite3.connect(":memory:", check_same_thread=False)
    P.C.build_database(conn, P.C.generate_corpus(
        n_chunks=n_chunks, n_sessions=n_sessions, seed=seed), emb)
    return conn, emb


def gate_backend(P, key="fused", *, released=False, delay_s=0.0,
                 semaphore=None):
    """``engine(P, key)`` with a scoring pass that blocks until
    ``release`` is set (or, with ``semaphore``, takes one permit a pass)
    and optionally sleeps first."""
    base = P.B.get_backend(engine(P, key))

    class Gate(type(base)):
        name = "gate"

        def score_select(self, *args, **kwargs):
            self._wait()
            return super().score_select(*args, **kwargs)

        def score_select_chain(self, *args, **kwargs):
            # a segmented store's general branch scores here, not through
            # score_select, on a backend that runs it as one chain
            self._wait()
            return super().score_select_chain(*args, **kwargs)

        def _wait(self):
            self.calls += 1
            self.entered.set()
            if delay_s:
                time.sleep(delay_s)
            if semaphore is not None:
                ok = semaphore.acquire(timeout=15.0)
            else:
                ok = self.release.wait(timeout=15.0)
            if not ok:
                raise RuntimeError("gate never released (test bug)")

    gate = Gate.__new__(Gate)
    gate.__dict__.update(base.__dict__)
    gate.release = threading.Event()
    if released:
        gate.release.set()
    gate.entered = threading.Event()
    gate.calls = 0
    return gate
