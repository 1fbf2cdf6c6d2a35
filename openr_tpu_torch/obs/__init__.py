"""Observability: the shared latency histogram."""

from .histogram import Histogram, export_histogram

__all__ = ["Histogram", "export_histogram"]
