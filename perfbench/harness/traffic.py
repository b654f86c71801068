"""One generator for every traffic mix: a mix is a data file that names
the entry it drives, its closed-loop clients, ``k``, a token template and
how each of the template's slots is drawn.

A phrase slot (``{"cluster": null | "descriptive" | ..., "words": [lo,
hi]}``) takes one topic of the cluster (any cluster for null) and ``lo``
to ``hi`` distinct words of that topic's vocabulary and the query-overlap
words; a choice slot (``{"choice": [...]}``) takes one of its values.
Query ``i`` of a run is drawn from ``(seed, stream, i)`` alone, so every
run of a seed sends the same queries in the same order, whichever client
takes which.
"""

from __future__ import annotations

import string
from typing import Dict

import numpy as np

from harness import corpus as C

WINDOW, WARMUP = 1, 4   # the streams: the window's queries, the warm-up's


def _fields(template: str):
    return [f for _, f, _, _ in string.Formatter().parse(template) if f]


class QueryStream:
    def __init__(self, mix: Dict, seed: int, stream: int = WINDOW):
        self.mix = mix
        self.seed = int(seed)
        self.stream = stream
        self.slots = mix["slots"]
        missing = set(_fields(mix["tokens"])) - set(self.slots)
        if missing:
            raise ValueError(f"traffic slots {sorted(missing)} not drawn")

    def _phrase(self, rng, slot: Dict) -> str:
        topics = C.topic_words(slot.get("cluster"))
        words = topics[int(rng.integers(len(topics)))] + C.OVERLAP
        lo, hi = slot["words"]
        n = int(rng.integers(lo, hi + 1))
        return " ".join(words[i] for i in rng.choice(len(words), n,
                                                     replace=False))

    def tokens(self, i: int) -> str:
        rng = np.random.default_rng([self.seed, self.stream, int(i)])
        values = {}
        for name in sorted(self.slots):
            slot = self.slots[name]
            values[name] = (slot["choice"][int(rng.integers(len(slot["choice"])))]
                            if "choice" in slot else self._phrase(rng, slot))
        return self.mix["tokens"].format(**values)

    def request(self, i: int) -> str:
        """What the entry is sent: the statement around the tokens, or the
        tokens themselves."""
        tokens = self.tokens(i)
        statement = self.mix.get("statement")
        return tokens if statement is None else statement.format(tokens=tokens)
