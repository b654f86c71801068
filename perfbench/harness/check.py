"""How ``correct`` is decided: the rows the timed path returned, held to
the plain reference (``reference.py``, float64) on a sample of the
window's requests drawn from the seed, and three exact counts over every
request of the window.

Exact, limit 0: ``failed`` (requests that raised or came back as an
error), ``dead_rows`` (returned rows tombstoned or not in the corpus),
``bad_rows`` (requests with another count of rows than the query asks
for, a row twice, or, through SQL, rows out of the id order that the
statement's temp table gives).

Compared with the reference, against the limit its traffic file sets:
``row_err``, the widest gap of any row of the sample, in the units of
the scores the path returns.

- ``ranked`` (a search's first k rows with their relevance): for each
  row the larger of the gap between its score and the reference's score
  of that row, and the gap by which the row lies below the best the
  reference has at its rank.  For a plain search that is the
  reference's i-th score less the i-th row's; for ``diverse`` the
  reference follows the program's own picks and takes, at each step, the
  best MMR value left in its pool less the pick's.
- ``sql_rows`` (``SELECT v.id, v.score FROM vec_ops(...) v LIMIT n``: the
  n smallest ids of the selection, scores min-max normalised over all of
  it): row by row against the reference's rows, the gap between the
  scores, and 1 (the scores' whole range) where the ids differ.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

import numpy as np

from harness import reference as R

SQL_RE = re.compile(r"^SELECT v\.id, v\.score FROM vec_ops\('(?P<tokens>[^']*)'\)"
                    r" v LIMIT (?P<limit>\d+)$")


def plan_k(q: R.Query, n_live: int) -> int:
    """How many rows the program selects for ``q``: its pool."""
    return min(q.pool, n_live)


def pool_width(q: R.Query, k: int, n_live: int) -> int:
    return min(R.OVERSAMPLE * max(k, q.pool), n_live) if q.diverse else k


def tokens_of(mix: Dict, request: str) -> str:
    if mix.get("statement") is None:
        return request
    m = SQL_RE.match(request)
    if m is None:
        raise ValueError(f"statement {request!r} is not the checked shape")
    return m.group("tokens")


def produce(ref: R.Reference, mix: Dict, requests: Sequence[str]) -> List[list]:
    """Each request's rows as the reference (at its precision) returns
    them: the control's answers when the precision is TF32."""
    kind = mix["check"]["kind"]
    queries = [R.parse(tokens_of(mix, r)) for r in requests]
    n_live = int(ref.live.sum())
    out: List[list] = [None] * len(queries)
    groups: Dict[tuple, List[int]] = {}
    for j, q in enumerate(queries):
        k = plan_k(q, n_live)
        groups.setdefault((q.diverse, k, pool_width(q, k, n_live)), []).append(j)
    for (diverse, k, width), idx in groups.items():
        rows, scores = ref.top([queries[j] for j in idx], width)
        if diverse:
            picks = ref.mmr(rows, scores, k)
            rows = np.take_along_axis(rows, picks, 1)
            scores = np.take_along_axis(scores, picks, 1)
        for row, j in enumerate(idx):
            r, s = rows[row, :k], scores[row, :k]
            if kind == "sql_rows":
                limit = int(SQL_RE.match(requests[j]).group("limit"))
                s = R.minmax(s)
                order = np.argsort(r, kind="stable")[:limit]
                r, s = r[order], s[order]
            else:
                r, s = r[:int(mix["k"])], s[:int(mix["k"])]
            out[j] = list(zip(r.tolist(), s.tolist()))
    return out


def expected_count(mix: Dict, request: str, n_live: int) -> int:
    q = R.parse(tokens_of(mix, request))
    k = plan_k(q, n_live)
    if mix["check"]["kind"] == "sql_rows":
        return min(int(SQL_RE.match(request).group("limit")), k)
    return min(int(mix["k"]), k)


def exact_counts(mix: Dict, records, requests: Sequence[str], live) -> Dict:
    """failed, dead_rows and bad_rows over every request of the window."""
    n = live.size
    n_live = int(live.sum())
    failed = dead = bad = 0
    for rec, req in zip(records, requests):
        if rec.error is not None:
            failed += 1
            continue
        ids = np.asarray([r[0] for r in rec.rows], np.int64)
        ok = (ids >= 0) & (ids < n)
        dead += int((~ok).sum() + (~live[ids[ok]]).sum())
        if (ids.size != expected_count(mix, req, n_live)
                or np.unique(ids).size != ids.size
                or (mix["check"]["kind"] == "sql_rows"
                    and np.any(np.diff(ids) <= 0))):
            bad += 1
    return {"failed": failed, "dead_rows": dead, "bad_rows": bad}


def sample(records, seed: int, size: int) -> List[int]:
    """Positions of the sampled answered requests, drawn from the seed,
    the window's first and last answer among them."""
    ok = [i for i, r in enumerate(records) if r.error is None]
    if len(ok) <= size:
        return ok
    rng = np.random.default_rng([int(seed), 2])
    inner = rng.choice(np.arange(1, len(ok) - 1), size - 2, replace=False)
    return [ok[0]] + [ok[i] for i in sorted(inner)] + [ok[-1]]


def compare(ref: R.Reference, mix: Dict, requests: Sequence[str],
            answers: Sequence[list]) -> Dict[str, float]:
    """The compared numbers of ``answers`` (the program's, or the
    control's) to the ``requests`` against the float64 reference."""
    kind = mix["check"]["kind"]
    if not requests:
        return {}
    if kind == "sql_rows":
        err = 0.0
        for got, exp in zip(answers, produce(ref, mix, requests)):
            if [r[0] for r in got] != [r[0] for r in exp]:
                err = max(err, 1.0)
            err = max([err] + [abs(float(g[1]) - float(e[1]))
                               for g, e in zip(got, exp)])
        return {"row_err": err}
    if kind != "ranked":
        raise ValueError(f"check kind {kind!r}")
    queries = [R.parse(tokens_of(mix, r)) for r in requests]
    n_live = int(ref.live.sum())
    ids = [np.asarray([r[0] for r in a], np.int64) for a in answers]
    if any(np.any((i < 0) | (i >= ref.live.size)) for i in ids):
        return {"row_err": np.inf}
    rel = ref.scores_of(queries, ids)
    err = max(float(np.max(np.abs(np.asarray([r[1] for r in a]) - s)))
              if a else 0.0 for a, s in zip(answers, rel))
    groups: Dict[int, List[int]] = {}
    for j, q in enumerate(queries):
        groups.setdefault(pool_width(q, plan_k(q, n_live), n_live),
                          []).append(j)
    for width, idx in groups.items():
        rows, scores = ref.top([queries[j] for j in idx], width)
        for row, j in enumerate(idx):
            if queries[j].diverse:
                err = max(err, ref.mmr_gap(rows[row], scores[row], ids[j],
                                           rel[j]))
            elif ids[j].size:
                top = scores[row, :ids[j].size]
                err = max(err, float(np.max(top - rel[j])))
    return {"row_err": err}
