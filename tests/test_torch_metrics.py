"""The port's ranking metrics and BEIR-like datasets against the reference.

``repro_torch.metrics`` must return what ``repro.metrics`` returns on the
same seeded inputs (both are numpy: equality, not a tolerance), edge
cases included: an empty list, fewer than two results, no relevant
document.  ``repro_torch.data.beir.make_dataset`` must build the
reference's dataset for each of the four names.  The generator's seed
holds ``hash(name)``, which Python randomises per process, so both
packages' datasets are built here, in one process.
"""

import numpy as np
import pytest

from repro.data import beir as RBeir
from repro.metrics import ranking as RR
from repro_torch.data import beir as TBeir
from repro_torch.metrics import ranking as TR


def _lists(rng, n_lists=12, universe=40):
    out = []
    for _ in range(n_lists):
        ka, kb = rng.integers(1, 15, 2)
        out.append((rng.choice(universe, ka, replace=False).tolist(),
                    rng.choice(universe, kb, replace=False).tolist()))
    return out


@pytest.mark.parametrize("p", [0.5, 0.9, 0.98])
def test_rbo_matches_reference(p):
    rng = np.random.default_rng(1)
    cases = _lists(rng) + [([], [1, 2]), ([], []), ([3], [3]),
                           ([1, 2, 3], [3, 2, 1]), ([1, 2], [3, 4])]
    for a, b in cases:
        assert TR.rbo(a, b, p) == RR.rbo(a, b, p)


def test_ils_matches_reference():
    rng = np.random.default_rng(2)
    for k in (0, 1, 2, 5, 10):
        e = rng.standard_normal((k, 16)).astype(np.float32)
        assert TR.ils(e) == RR.ils(e)
    assert TR.ils(np.zeros((1, 8), np.float32)) == 0.0  # k < 2


def test_ndcg_matches_reference():
    rng = np.random.default_rng(3)
    for k in (1, 5, 10):
        for _ in range(10):
            ranked = rng.choice(50, 12, replace=False).tolist()
            qrels = {int(r): int(g) for r, g in zip(
                rng.choice(50, 8, replace=False), rng.integers(1, 3, 8))}
            assert TR.ndcg_at_k(ranked, qrels, k) == \
                RR.ndcg_at_k(ranked, qrels, k)
    # no relevant document, and an empty ranking
    assert TR.ndcg_at_k([1, 2, 3], {}, 10) == RR.ndcg_at_k([1, 2, 3], {},
                                                          10) == 0.0
    assert TR.ndcg_at_k([], {4: 2}, 10) == RR.ndcg_at_k([], {4: 2}, 10)


def test_centroid_similarity_matches_reference():
    rng = np.random.default_rng(4)
    for k, s in ((10, 3), (1, 1), (5, 5)):
        res = rng.standard_normal((k, 32)).astype(np.float32)
        seeds = rng.standard_normal((s, 32)).astype(np.float32)
        assert TR.centroid_similarity(res, seeds) == \
            RR.centroid_similarity(res, seeds)


@pytest.mark.parametrize("name", sorted(RBeir.DATASET_SPECS))
def test_make_dataset_matches_reference(name):
    assert TBeir.DATASET_SPECS == RBeir.DATASET_SPECS
    got, want = TBeir.make_dataset(name), RBeir.make_dataset(name)
    assert got.name == want.name and got.now == want.now
    assert got.doc_texts == want.doc_texts
    np.testing.assert_array_equal(got.doc_topics, want.doc_topics)
    np.testing.assert_array_equal(got.timestamps, want.timestamps)
    assert got.queries == want.queries
    np.testing.assert_array_equal(got.query_topics, want.query_topics)
    assert got.qrels == want.qrels
    assert len(got.doc_texts) == TBeir.DATASET_SPECS[name][0]
    assert TBeir.effective_seed(name) == 0 ^ hash(name) & 0x7FFF
