"""Latency histogram of the serving planes' load clients.

Ported from the JAX package's ops/loadgen.py, whose open-loop load
generator (Poisson arrivals, zipfian keys, brownouts) is not ported:
only `LogHistogram`, the log-bucketed latency histogram whose relative
error is bounded by the bucket growth factor at every percentile, p999
included. The replica read fan-out (client/read_fanout.py) takes its
hedge threshold from one.
"""

from __future__ import annotations

import math


class LogHistogram:
    """Log-bucketed latency histogram: bucket i covers
    [base * growth**i, base * growth**(i+1)).

    With the defaults (growth=1.25, 96 buckets from 1µs) every
    percentile — p50 through p999 — is reported with <= 25% relative
    error over a 1µs..~2000s span, so recording is one log + one
    increment and the tail is as trustworthy as the median (a
    linear-bucket table either truncates the tail or loses the head)."""

    __slots__ = ("base", "growth", "_log_g", "counts", "count", "total", "max")

    def __init__(self, base: float = 1e-6, growth: float = 1.25, n_buckets: int = 96):
        self.base = base
        self.growth = growth
        self._log_g = math.log(growth)
        self.counts = [0] * n_buckets
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def record(self, seconds: float) -> None:
        if seconds < self.base:
            i = 0
        else:
            i = min(
                int(math.log(seconds / self.base) / self._log_g),
                len(self.counts) - 1,
            )
        self.counts[i] += 1
        self.count += 1
        self.total += seconds
        if seconds > self.max:
            self.max = seconds

    def percentile(self, p: float) -> float:
        """Latency (seconds) at percentile p in [0, 100]: geometrically
        interpolated WITHIN the covering bucket by rank fraction
        (upper-bounded by the observed max, so a lone outlier reports
        itself, not its bucket ceiling). Raw bucket midpoints quantized
        p99 RATIOS to 1.25x steps — two runs one bucket apart read as a
        1.25-1.56x "regression" that never happened (the same fix the
        tenant gate's latency_percentile got in PR 12); interpolation
        keeps the error within the bucket while making ratios of two
        histograms continuous."""
        if self.count == 0:
            return 0.0
        target = self.count * p / 100.0
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target and c:
                if i == len(self.counts) - 1:
                    # overflow bucket: its midpoint means nothing — the
                    # observed max is the only honest answer there
                    return self.max
                frac = (target - (cum - c)) / c  # rank position in bucket
                val = self.base * self.growth ** (i + frac)
                return min(val, self.max) if self.max else val
        return self.max

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def merge(self, other: "LogHistogram") -> None:
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        self.max = max(self.max, other.max)

    def summary_ms(self) -> dict:
        """The publishable block: p50/p99/p999 (+ mean/max) in ms."""
        return {
            "p50_ms": round(self.percentile(50) * 1e3, 3),
            "p99_ms": round(self.percentile(99) * 1e3, 3),
            "p999_ms": round(self.percentile(99.9) * 1e3, 3),
            "mean_ms": round(self.mean * 1e3, 3),
            "max_ms": round(self.max * 1e3, 3),
            "count": self.count,
        }
