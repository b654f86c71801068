"""Tables 5 & 6 — behavioral validation on four BEIR-like corpora (§4.4).

The port of ``benchmarks/behavioral.py``: the same datasets, plans and
metrics through the port's ``VectorCache`` on any engine, by default
:class:`~repro_torch.core.backends.HopperBackend` on the card.  Per
modulation, the paper's diagnostic metric:

    diverse      ILS reduction (10-40% band) + nDCG@10 retention (Table 6)
    suppress:X   RBO vs baseline well below 1 (band 0.19-0.41)
    decay:7      mean result age shift (tens of days on 90-day spread)
    centroid:ids centroid similarity gain (+0.05..+0.12)
    from:/to:    RBO vs baseline (band 0.08-0.25)

Synthetic stand-ins preserve structure: direction/band is the validation
target, not the paper's exact decimals.  30 queries per dataset, by
insertion order (paper Appendix A).  Each dataset is generated from
``seed ^ hash(name)`` (``repro_torch.data.beir``), so two processes
build different datasets unless ``PYTHONHASHSEED`` is set.

    python -m repro_torch.bench.behavioral [--device cuda|cpu]
                                           [--datasets NAME ...]

prints the reference's CSV rows (``name,us_per_call,derived``).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import modulations as M
from repro_torch.core.vectorcache import VectorCache
from repro_torch.data.beir import (DATASET_SPECS, BeirLikeDataset,
                                   effective_seed, make_dataset)
from repro_torch.embed import HashEmbedder
from repro_torch.metrics import centroid_similarity, ils, ndcg_at_k, rbo

DIM = 128  # benchmarks/common.py's embedding width
N_QUERIES = 30
K = 10
PLANS = ("baseline", "diverse", "suppress", "decay7", "centroid",
         "trajectory")


def emit(name: str, seconds: float, derived: str = "") -> None:
    """CSV row: name,us_per_call,derived (benchmarks/common.py's)."""
    print(f"{name},{seconds*1e6:.1f},{derived}", flush=True)


@dataclasses.dataclass
class Suite:
    """One dataset with its embedder and the cache that serves it."""

    emb: HashEmbedder
    ds: BeirLikeDataset
    cache: VectorCache


def setup(name: str) -> Suite:
    emb = HashEmbedder(DIM)
    ds = make_dataset(name)
    matrix = emb.embed_batch(ds.doc_texts)
    cache = VectorCache(np.arange(len(ds.doc_texts)), matrix, ds.timestamps,
                        emb)
    return Suite(emb, ds, cache)


def run_dataset(name: str, engine, n_queries: int = N_QUERIES, k: int = K,
                *, suite: Optional[Suite] = None) -> Dict:
    """The suite on one dataset through ``engine`` (a backend name or
    instance).  Returns the Table 5 figures (``table5``), the Table 6 row
    (``table6``), each query's ranked ``(id, score)`` list for each of
    :data:`PLANS` (``rankings``), the searches made and the seconds they
    took.  ``suite`` reuses a dataset already built by :func:`setup`."""
    suite = suite or setup(name)
    emb, ds, cache = suite.emb, suite.ds, suite.cache
    rankings: Dict[str, List[List[Tuple[int, float]]]] = {p: [] for p in PLANS}
    clock = [0.0]

    def rank(kind: str, plan: M.ModulationPlan) -> List[int]:
        t0 = time.perf_counter()
        got = cache.search_plan(plan, now=ds.now, engine=engine)[:k]
        clock[0] += time.perf_counter() - t0
        rankings[kind].append([(int(i), float(s)) for i, s in got])
        return [i for i, _ in got]

    def age(rows) -> float:
        return float(np.mean((ds.now - ds.timestamps[rows]) / 86400.0))

    base_ndcg, div_ndcg = [], []
    base_ils, div_ils = [], []
    rbo_sup, rbo_traj = [], []
    age_shift, cent_gain = [], []
    for qi in range(min(n_queries, len(ds.queries))):
        q = np.asarray(M.l2_normalize(emb(ds.queries[qi])))
        qrels = ds.qrels[qi]
        base = rank("baseline", M.ModulationPlan(query=q))
        base_ndcg.append(ndcg_at_k(base, qrels, k))
        base_ils.append(ils(cache.matrix[base]))

        div = rank("diverse", M.ModulationPlan(query=q,
                                               diverse=M.DiverseSpec()))
        div_ndcg.append(ndcg_at_k(div, qrels, k))
        div_ils.append(ils(cache.matrix[div]))

        # suppress: the dominant-cluster direction = centroid of the
        # baseline top-3 (the paper's 'named concept' use case)
        sup_dir = M.l2_normalize(cache.matrix[base[:3]].mean(axis=0))
        sup = rank("suppress", M.ModulationPlan(
            query=q, suppress=(M.SuppressSpec(direction=np.asarray(sup_dir)),)))
        rbo_sup.append(rbo(base, sup))

        dec = rank("decay7", M.ModulationPlan(query=q, decay=M.DecaySpec(7.0)))
        age_shift.append(age(base) - age(dec))

        # centroid from relevant seeds the words did NOT surface (the
        # paper's use case: anchor to a facet the text query missed)
        deep = [r for r in qrels if r not in base][:5]
        seeds = deep or base[:3]
        cent = rank("centroid", M.ModulationPlan(
            query=q, centroid=M.CentroidSpec(examples=cache.matrix[seeds])))
        cent_gain.append(
            centroid_similarity(cache.matrix[cent], cache.matrix[seeds])
            - centroid_similarity(cache.matrix[base], cache.matrix[seeds]))

        # trajectory between two fixed docs' directions
        n_docs = len(ds.doc_texts)
        a = cache.matrix[(qi * 7) % n_docs]
        b = cache.matrix[(qi * 13 + 5) % n_docs]
        traj = rank("trajectory", M.ModulationPlan(
            query=q, trajectory=M.TrajectorySpec(direction=b - a)))
        rbo_traj.append(rbo(base, traj))

    b_ndcg = float(np.mean(base_ndcg))
    d_ndcg = float(np.mean(div_ndcg))
    ils_red = 1.0 - float(np.mean(div_ils)) / max(float(np.mean(base_ils)),
                                                  1e-9)
    return {
        "name": name,
        "effective_seed": effective_seed(name),
        "table5": {"diverse_ils_reduction": ils_red,
                   "suppress_rbo": float(np.mean(rbo_sup)),
                   "decay7_age_shift_days": float(np.mean(age_shift)),
                   "centroid_sim_gain": float(np.mean(cent_gain)),
                   "trajectory_rbo": float(np.mean(rbo_traj))},
        "table6": {"baseline_ndcg": b_ndcg, "diverse_ndcg": d_ndcg,
                   "retention": d_ndcg / max(b_ndcg, 1e-9),
                   "ils_reduction": ils_red},
        "rankings": rankings,
        "searches": sum(len(r) for r in rankings.values()),
        "search_s": clock[0],
    }


def table5_rows(result: Dict) -> List[Tuple[str, str]]:
    """(row name, derived text) of the Table 5 rows, at the reference's
    printed precision."""
    name, t5 = result["name"], result["table5"]
    return [
        (f"table5/{name}/diverse_ils_reduction",
         f"{t5['diverse_ils_reduction']:.3f}"),
        (f"table5/{name}/suppress_rbo", f"{t5['suppress_rbo']:.3f}"),
        (f"table5/{name}/decay7_age_shift_days",
         f"{t5['decay7_age_shift_days']:.1f}"),
        (f"table5/{name}/centroid_sim_gain",
         f"{t5['centroid_sim_gain']:+.3f}"),
        (f"table5/{name}/trajectory_rbo", f"{t5['trajectory_rbo']:.3f}"),
    ]


def table6_row(result: Dict) -> Tuple[str, str]:
    t6 = result["table6"]
    return (f"table6/{result['name']}",
            f"baseline_ndcg={t6['baseline_ndcg']:.3f} "
            f"diverse_ndcg={t6['diverse_ndcg']:.3f} "
            f"retention={t6['retention']:.2f} "
            f"ils_reduction={t6['ils_reduction']:.2f}")


def run(engine=None, datasets: Optional[Sequence[str]] = None) -> None:
    """Print the reference's CSV rows: each dataset's Table 5 rows as it
    finishes, then every Table 6 row.  ``engine=None`` is
    ``HopperBackend("cuda")``."""
    if engine is None:
        from repro_torch.core.backends import HopperBackend

        engine = HopperBackend("cuda")
    results = []
    for name in (DATASET_SPECS if datasets is None else datasets):
        result = run_dataset(name, engine)
        for row, derived in table5_rows(result):
            emit(row, 0.0, derived)
        results.append(result)
    for result in results:
        row, derived = table6_row(result)
        emit(row, 0.0, derived)


def main() -> None:
    from repro_torch.core.backends import HopperBackend

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where HopperBackend runs (cpu: the kernels' "
                         "plain versions)")
    ap.add_argument("--datasets", nargs="+", choices=sorted(DATASET_SPECS),
                    help="default: all four")
    args = ap.parse_args()
    run(HopperBackend(args.device), args.datasets)


if __name__ == "__main__":
    main()
