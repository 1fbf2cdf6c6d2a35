"""Observability: end-to-end span tracing and the shared latency
histogram.

Every seam imports `obs.trace` as a module and reads `trace.TRACE`
late-bound (its arming discipline).  Neither module imports torch.
"""

from .histogram import Histogram, export_histogram
from .trace import OBS_COUNTER_KEYS, ObsStats, Span, Tracer

__all__ = [
    "Histogram",
    "export_histogram",
    "OBS_COUNTER_KEYS",
    "ObsStats",
    "Span",
    "Tracer",
]
