"""Monitor and Watchdog: observability and liveness (port of
`openr_tpu.monitor`)."""

from .monitor import LogSample, Monitor, SystemMetrics
from .watchdog import Watchdog

__all__ = ["LogSample", "Monitor", "SystemMetrics", "Watchdog"]
