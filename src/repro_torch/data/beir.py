"""Synthetic BEIR-like labeled corpora for behavioral validation (paper §4.4).

Real BEIR downloads are unavailable offline; these generators preserve the
properties the paper's behavioral suite measures:

* topical corpora with graded query relevance (nDCG@10 computable),
* controllable cluster tightness (near-duplicate rate) — the knob behind
  the paper's SciFact(broad, 93% diverse retention) vs NFCorpus(tight, 59%)
  spread,
* synthetic 90-day-uniform timestamps (the paper's own caveat for decay),
* document counts matching the four BEIR datasets.

The port's copy of ``repro.data.beir``, numpy only.  The generator's seed
is ``seed ^ hash(name) & 0x7FFF`` as there; Python randomises ``hash`` of
a ``str`` per process (unless ``PYTHONHASHSEED`` is set), so the two
packages build the same dataset only inside one process, and two
processes build different ones.  :func:`effective_seed` says which seed
a process uses.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

_WORDPOOL_SIZE = 4000


@dataclasses.dataclass
class BeirLikeDataset:
    name: str
    doc_texts: List[str]
    doc_topics: np.ndarray          # (N,)
    timestamps: np.ndarray          # (N,) unix seconds, 90-day uniform
    queries: List[str]              # >= 30
    query_topics: np.ndarray
    qrels: List[Dict[int, int]]     # per query: {doc_row: relevance}
    now: float


# (n_docs, n_topics, dup_rate, noise_words, topic_words) — dup_rate high =>
# tight clusters (NFCorpus-like); more noise + fewer topic words => harder
# baseline (paper baseline nDCG@10 band: 0.13 NFCorpus .. 0.60 SciFact).
DATASET_SPECS = {
    "scifact-like": (5_183, 120, 0.20, 10, 6),
    "nfcorpus-like": (3_633, 30, 0.70, 22, 4),
    "scidocs-like": (25_657, 150, 0.45, 18, 5),
    "fiqa-like": (57_638, 100, 0.40, 16, 5),
}


def _word(i: int) -> str:
    return f"w{i:05d}"


def effective_seed(name: str, seed: int = 0) -> int:
    """The generator's seed for ``name`` in this process."""
    return seed ^ hash(name) & 0x7FFF


def make_dataset(name: str, seed: int = 0) -> BeirLikeDataset:
    n_docs, n_topics, dup_rate, n_noise, n_topic_words = DATASET_SPECS[name]
    rng = np.random.Generator(np.random.PCG64(effective_seed(name, seed)))
    # topic vocabularies: 12 words each, drawn from a shared pool (overlap
    # between topics => realistic non-zero off-topic similarity)
    topic_vocab = rng.integers(0, _WORDPOOL_SIZE, size=(n_topics, 12))
    # per-topic "template" docs that near-duplicates perturb
    templates = [
        [_word(w) for w in rng.choice(topic_vocab[t], n_topic_words)]
        for t in range(n_topics)
    ]

    doc_texts: List[str] = []
    doc_topics = rng.integers(0, n_topics, n_docs)
    is_template_dup = np.zeros(n_docs, bool)
    for i in range(n_docs):
        t = doc_topics[i]
        if rng.random() < dup_rate:
            words = list(templates[t])
            # small perturbation
            words[int(rng.integers(len(words)))] = _word(int(rng.choice(topic_vocab[t])))
            is_template_dup[i] = True
        else:
            words = [_word(int(w)) for w in rng.choice(topic_vocab[t], n_topic_words)]
        words += [_word(int(w)) for w in rng.integers(0, _WORDPOOL_SIZE, n_noise)]
        doc_texts.append(" ".join(words))

    now = 1_770_000_000.0
    timestamps = now - rng.uniform(0, 90 * 86400.0, n_docs)  # 90-day spread

    n_queries = 40
    queries: List[str] = []
    query_topics = rng.integers(0, n_topics, n_queries)
    qrels: List[Dict[int, int]] = []
    topic_rows: Dict[int, np.ndarray] = {
        t: np.where(doc_topics == t)[0] for t in range(n_topics)
    }
    for qi in range(n_queries):
        t = int(query_topics[qi])
        rows = topic_rows[t]
        # Queries are written ABOUT specific (judged) documents, as in real
        # BEIR: pick an anchor doc, sample query words from its text.
        anchor = int(rows[int(rng.integers(len(rows)))])
        anchor_words = doc_texts[anchor].split()
        qwords = [anchor_words[int(rng.integers(len(anchor_words)))]
                  for _ in range(3)]
        queries.append(" ".join(qwords))
        # SPARSE graded qrels (real BEIR judges a handful per query): anchor
        # + template-duplicates of the topic (rel 2) + a judged sample
        # (rel 1). Unjudged same-topic docs still rank high and drag nDCG
        # down — producing the paper's 0.13-0.60 baseline band.
        dups = [int(r) for r in rows if is_template_dup[r]][:8]
        n_judged = min(10, len(rows))
        judged = rng.choice(rows, n_judged, replace=False)
        rel: Dict[int, int] = {int(r): 1 for r in judged}
        for r in dups:
            rel[r] = 2
        rel[anchor] = 2
        qrels.append(rel)

    return BeirLikeDataset(
        name=name, doc_texts=doc_texts, doc_topics=doc_topics,
        timestamps=timestamps, queries=queries, query_topics=query_topics,
        qrels=qrels, now=now,
    )
