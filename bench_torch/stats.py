"""Order statistics the metrics share."""

from __future__ import annotations


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) by linear interpolation between order
    statistics, numpy's default; the value itself for a single sample."""
    values = sorted(values)
    if len(values) == 1:
        return float(values[0])
    pos = (len(values) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(values) - 1)
    return float(values[lo] + (values[hi] - values[lo]) * (pos - lo))

