"""The arithmetic of the metrics: a tail over all calls, the union of
device intervals, idle shares, and the peaks of the card."""

from __future__ import annotations

import statistics

# NVIDIA H100 SXM data sheet, dense, at a 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def percentile(values, q: int) -> float:
    """The `q`-th percentile of all `values` (linear between order
    statistics, `statistics.quantiles(..., method="inclusive")`)."""
    values = list(values)
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def merged(intervals):
    """Sorted, overlapping `(start, end)` intervals merged."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def clipped(intervals, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def union_length(intervals, lo: float, hi: float) -> float:
    """The length of `[lo, hi]` that at least one interval covers."""
    return sum(e - s for s, e in merged(clipped(intervals, lo, hi)))


def gaps(intervals, lo: float, hi: float):
    """The parts of `[lo, hi]` that no interval covers, as `(start, end)`."""
    out, t = [], lo
    for s, e in merged(clipped(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


def idle_pct(intervals, lo: float, hi: float) -> float:
    """The share of `[lo, hi]`, in %, in which no interval is active."""
    return 100.0 * (1.0 - union_length(intervals, lo, hi) / (hi - lo))


def roofline_pct(nbytes: float, flop: float, seconds: float) -> float:
    """The least time the card allows for `nbytes` and `flop` (bf16), over
    the `seconds` measured, in %."""
    return 100.0 * max(nbytes / HBM_BYTES_PER_S, flop / BF16_FLOP_PER_S) / seconds
