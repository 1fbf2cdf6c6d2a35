"""Power-of-two-bucket latency histogram.

Port of `openr_tpu.obs.histogram`.  `record_us` is O(1), one
`bit_length` and one bucket increment; a percentile walks at most
`N_BUCKETS` counts.  Bucket `i` holds values whose `int.bit_length()`
is `i`, the half-open range [2^(i-1), 2^i) microseconds (bucket 0 holds
exact zeros), and a percentile reports its bucket's inclusive upper
bound 2^i - 1: at most a 2x overestimate, monotone and cheap.

`export_histogram` writes `<family>.p50_us`, `.p99_us`, `.p999_us`,
`<family>.hist_us.count` and each non-empty `<family>.hist_us.b<i>`
into a counters dict, the reference's keys.
"""

from __future__ import annotations

import threading

# 2^39 us is about 6.4 days: anything slower is a fault, not a latency
N_BUCKETS = 40

_PCTLS = ((50, "p50_us"), (99, "p99_us"), (99.9, "p999_us"))


class Histogram:
    """Thread-safe log2-bucketed microsecond histogram."""

    __slots__ = ("counts", "n", "_lock")

    def __init__(self) -> None:
        self.counts = [0] * N_BUCKETS
        self.n = 0
        self._lock = threading.Lock()

    def record_us(self, us: int) -> None:
        i = min(int(us).bit_length(), N_BUCKETS - 1) if us > 0 else 0
        with self._lock:
            self.counts[i] += 1
            self.n += 1

    def snapshot(self) -> tuple[list[int], int]:
        with self._lock:
            return list(self.counts), self.n

    def percentile_us(self, p: float) -> int:
        counts, n = self.snapshot()
        return _pctl_from_counts(counts, n, p)


def _pctl_from_counts(counts: list[int], n: int, p: float) -> int:
    if n <= 0:
        return 0
    rank = max(1, int(n * p / 100.0 + 0.999999))
    seen = 0
    for i, c in enumerate(counts):
        seen += c
        if seen >= rank:
            return (1 << i) - 1 if i else 0
    return (1 << (N_BUCKETS - 1)) - 1


def export_histogram(counters: dict, family: str, hist: Histogram) -> None:
    """One histogram family into a counters dict: the three percentile
    gauges, the total count and the non-empty buckets."""
    counts, n = hist.snapshot()
    for p, suffix in _PCTLS:
        counters[f"{family}.{suffix}"] = _pctl_from_counts(counts, n, p)
    counters[f"{family}.hist_us.count"] = n
    for i, c in enumerate(counts):
        if c:
            counters[f"{family}.hist_us.b{i}"] = c
