"""Bounded log-bucket latency histograms (the per-edge sketch behind p99).

Scaler's folds keep count/total/min/max — enough for means, blind to
tails.  This module defines the fixed bucket layout that turns a folded
edge into a latency *distribution* at a bounded cost: HDR-style
linear-within-octave buckets, ``HIST_SUB`` sub-buckets per power of two
over octaves ``0..HIST_MAX_EXP-1`` (1 ns up to ~18 minutes), giving a
constant ``HIST_BUCKETS`` uint64 counters per edge (~1.25 KiB) and a
relative resolution of ``1/HIST_SUB`` within every octave.  That is the
lightweight-monitoring bargain (ScALPEL): no raw samples, no dynamic
allocation, and merge is an exact element-wise add — associative,
commutative, and loss-free, so shard merges and ring differencing keep
working on distributions exactly as they do on counters.

Bucket ``b`` covers ``[bucket_lo(b), bucket_hi(b))`` in integer
nanoseconds; durations are clamped into ``[1, 2**HIST_MAX_EXP - 1]``
before bucketing, so every recorded event lands in exactly one bucket
and ``hist.sum() == number of recorded events``.

Percentile read-out interpolates linearly inside the crossed bucket
(midpoint error is bounded by half the bucket width, i.e. ~12.5%
relative for HIST_SUB=4).  Jitter follows CORTEX's percentile-delta
convention: ``jitter = p99 - p50``.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np

#: linear sub-buckets per power-of-two octave (resolution = 1/HIST_SUB)
HIST_SUB = 4
#: number of octaves covered; max representable duration is 2**HIST_MAX_EXP-1
HIST_MAX_EXP = 40
#: total bucket count — the fixed width of every per-edge histogram row
HIST_BUCKETS = HIST_SUB * HIST_MAX_EXP

_MAX_NS = (1 << HIST_MAX_EXP) - 1


def bucket_index(dur_ns: int) -> int:
    """Bucket for an integer duration; pure integer math, no floats.

    ``e = bit_length - 1`` is the octave; the sub-bucket is the top two
    fractional bits of the mantissa, so the formula is
    ``HIST_SUB*e + (HIST_SUB*d >> e) - HIST_SUB``.
    """
    d = int(dur_ns)
    if d < 1:
        d = 1
    elif d > _MAX_NS:
        d = _MAX_NS
    e = d.bit_length() - 1
    return HIST_SUB * e + ((HIST_SUB * d) >> e) - HIST_SUB


def _edges() -> np.ndarray:
    """Lower edge of every bucket plus the final upper bound,
    shape [HIST_BUCKETS + 1], float64 ns."""
    out = np.empty(HIST_BUCKETS + 1, dtype=np.float64)
    for e in range(HIST_MAX_EXP):
        base = float(1 << e)
        for s in range(HIST_SUB):
            out[HIST_SUB * e + s] = base * (1.0 + s / HIST_SUB)
    out[HIST_BUCKETS] = float(1 << HIST_MAX_EXP)
    return out

#: bucket boundaries in ns: bucket b covers [BUCKET_EDGES[b], BUCKET_EDGES[b+1])
BUCKET_EDGES = _edges()
BUCKET_EDGES.setflags(write=False)


def new_hist(n: int = 1) -> np.ndarray:
    """Zeroed histogram block: shape [n, HIST_BUCKETS], uint64."""
    return np.zeros((n, HIST_BUCKETS), dtype=np.uint64)


def hist_of(durations_ns: Iterable[int]) -> np.ndarray:
    """Histogram of a duration sample, shape [HIST_BUCKETS] uint64.
    Convenience for tests/benchmarks — the hot path buckets inline."""
    h = np.zeros(HIST_BUCKETS, dtype=np.uint64)
    for d in durations_ns:
        h[bucket_index(d)] += 1
    return h


def percentile_ns(hist: Optional[np.ndarray], q: float) -> float:
    """q-th quantile (q in [0, 1]) of a single histogram row, in ns.

    Returns 0.0 for a missing or empty histogram.  Finds the bucket where
    the cumulative count crosses ``q * total`` and interpolates linearly
    within it, so p50 of a single-bucket histogram lands mid-bucket
    rather than on an edge.
    """
    if hist is None:
        return 0.0
    h = np.asarray(hist, dtype=np.float64).ravel()
    total = float(h.sum())
    if total <= 0.0:
        return 0.0
    rank = q * total
    cum = np.cumsum(h)
    b = int(np.searchsorted(cum, rank, side="left"))
    if b >= HIST_BUCKETS:
        b = HIST_BUCKETS - 1
    # skip leading empty buckets searchsorted may land on when rank == 0
    while h[b] == 0.0 and b < HIST_BUCKETS - 1:
        b += 1
    prev = cum[b] - h[b]
    frac = (rank - prev) / h[b] if h[b] > 0.0 else 0.0
    frac = min(max(frac, 0.0), 1.0)
    lo, hi = BUCKET_EDGES[b], BUCKET_EDGES[b + 1]
    return float(lo + frac * (hi - lo))


def percentiles_ns(hist: Optional[np.ndarray],
                   qs: Sequence[float] = (0.50, 0.95, 0.99)) -> tuple:
    """Vector of quantiles for one histogram row (0.0s when empty)."""
    return tuple(percentile_ns(hist, q) for q in qs)


def jitter_ns(hist: Optional[np.ndarray]) -> float:
    """Tail jitter as a percentile delta: p99 - p50 (CORTEX convention)."""
    p50, _, p99 = percentiles_ns(hist)
    return p99 - p50
