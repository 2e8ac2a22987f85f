"""Latency percentiles for the replay report: the HDR-style histogram and
``percentiles_ms`` of ``protocol_tpu/obs/metrics.py`` (``LatencyHistogram``,
``:150 percentiles_ms``), copied. The per-session registry, the SLO engine
and the ``/metrics`` endpoint of that module are not ported yet (ROADMAP
queue A, M6).
"""

from __future__ import annotations

import math

_SUB = 16  # linear sub-buckets per power of two


class LatencyHistogram:
    """HDR-style histogram over nanoseconds.

    Bucket index = (exponent, linear sub-bucket of the mantissa): values
    are scaled by ``lowest_ns`` (everything below lands in bucket 0), then
    ``frexp`` splits off the power of two and the mantissa's top bits pick
    one of 16 linear sub-buckets, so the relative error is at most 1/16 at
    every magnitude. Quantiles come back as the sub-bucket midpoint,
    capped at the recorded maximum."""

    __slots__ = ("lowest_ns", "_counts", "count", "sum_ns", "max_ns")

    def __init__(self, lowest_ns: float = 1000.0, decades: int = 9):
        self.lowest_ns = float(lowest_ns)
        n_buckets = int(decades * math.log2(10)) * _SUB + _SUB
        self._counts = [0] * n_buckets
        self.count = 0
        self.sum_ns = 0.0
        self.max_ns = 0.0

    def _index(self, ns: float) -> int:
        v = ns / self.lowest_ns
        if v < 1.0:
            return 0
        m, e = math.frexp(v)  # v = m * 2**e, 0.5 <= m < 1
        idx = (e - 1) * _SUB + int((m - 0.5) * 2 * _SUB)
        return min(idx, len(self._counts) - 1)

    def _value(self, idx: int) -> float:
        e, sub = divmod(idx, _SUB)
        return self.lowest_ns * (2.0 ** e) * (1.0 + (sub + 0.5) / _SUB)

    def observe_ns(self, ns: float) -> None:
        ns = float(ns)
        self._counts[self._index(ns)] += 1
        self.count += 1
        self.sum_ns += ns
        if ns > self.max_ns:
            self.max_ns = ns

    def observe_ms(self, ms: float) -> None:
        self.observe_ns(ms * 1e6)

    def quantile_ns(self, q: float) -> float:
        """Value at quantile ``q`` (0..1); 0.0 on an empty histogram."""
        if self.count == 0:
            return 0.0
        rank = max(1, min(self.count, math.ceil(q * self.count)))
        seen = 0
        for idx, c in enumerate(self._counts):
            seen += c
            if seen >= rank:
                return min(self._value(idx), self.max_ns)
        return self.max_ns  # pragma: no cover - unreachable

    def snapshot_ms(self) -> dict:
        """{count, mean, p50, p90, p99, p999, max} in milliseconds."""
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "mean_ms": round(self.sum_ns / self.count / 1e6, 3),
            "p50_ms": round(self.quantile_ns(0.50) / 1e6, 3),
            "p90_ms": round(self.quantile_ns(0.90) / 1e6, 3),
            "p99_ms": round(self.quantile_ns(0.99) / 1e6, 3),
            "p999_ms": round(self.quantile_ns(0.999) / 1e6, 3),
            "max_ms": round(self.max_ns / 1e6, 3),
        }


def percentiles_ms(walls_ms) -> dict:
    """A list of wall-clock ms through a histogram: its snapshot (p50, p99,
    ... keys)."""
    h = LatencyHistogram()
    for w in walls_ms:
        h.observe_ms(float(w))
    return h.snapshot_ms()
