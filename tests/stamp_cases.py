"""Planted row timestamps for the tests of the ``pem_score`` kernel's
timestamps form (numpy only: the card's machine imports it too).

:func:`planted_stamps` gives unix timestamps whose ages in days land next
to the f32 rounding ties and boundaries, rows newer than ``now`` and at
it, ages of decades, a NaN, and ordinary ages; :func:`host_ages` is the
host's ``CorpusSegment.days_ago`` over them, the f32 ages the kernel's
form must reproduce bit for bit.
"""

import numpy as np

from repro_torch.core.segments import CorpusSegment

NOW = 1_770_000_000.0


def _around(x: np.ndarray) -> np.ndarray:
    """``x`` and its f64 neighbours one step down and up."""
    return np.concatenate([x, np.nextafter(x, -np.inf),
                           np.nextafter(x, np.inf)])


def planted_stamps(n: int, seed: int, now: float = NOW) -> np.ndarray:
    """(n,) float64 timestamps, shuffled; ``n`` >= 7,000."""
    rng = np.random.default_rng(seed)
    # ages half way between two neighbouring f32 (the cast's ties), and
    # powers of two with their f32 neighbours (the cast's boundaries)
    lo = rng.uniform(0.0, 400.0, 1500).astype(np.float32)
    hi = np.nextafter(lo, np.float32(np.inf))
    ties = (lo.astype(np.float64) + hi.astype(np.float64)) / 2
    p2 = np.float32(2.0) ** np.arange(-20, 14, dtype=np.float32)
    bounds = np.concatenate([p2, np.nextafter(p2, np.float32(0)),
                             np.nextafter(p2, np.float32(np.inf))])
    planted = _around(now - np.concatenate(
        [ties, bounds.astype(np.float64)]) * 86400.0)
    newer = np.concatenate([now + rng.uniform(0.0, 1e6, 200),
                            [now, np.nextafter(now, np.inf),
                             np.nextafter(now, -np.inf), now - 1e-6]])
    decades = np.concatenate(
        [now - rng.uniform(10.0, 60.0, 200) * 365.25 * 86400.0, [0.0]])
    fixed = np.concatenate([planted, newer, decades, [np.nan]])
    assert n >= fixed.size + 1000, n
    rest = now - rng.uniform(0.0, 180.0, n - fixed.size) * 86400.0
    return rng.permutation(np.concatenate([fixed, rest]))


def host_ages(timestamps: np.ndarray, now: float = NOW) -> np.ndarray:
    """The host's f32 ages, as a sealed segment makes them."""
    n = timestamps.shape[0]
    seg = CorpusSegment(seg_id=0, ids=np.arange(n),
                        matrix=np.zeros((n, 1), np.float32),
                        timestamps=timestamps,
                        tombstones=np.zeros(n, bool))
    return seg.days_ago(now)


def same_bits_or_nan(got: np.ndarray, want: np.ndarray) -> None:
    """Equal bit for bit, except that a NaN need only meet a NaN (its
    payload is the producer's)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32))
