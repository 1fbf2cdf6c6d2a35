"""Module runtime: event bases, inter-module queues, debounce."""

from .async_util import AsyncDebounce, AsyncThrottle
from .eventbase import OpenrEventBase
from .queue import QueueClosedError, ReplicateQueue, RQueue, RWQueue

__all__ = [
    "QueueClosedError",
    "RWQueue",
    "RQueue",
    "ReplicateQueue",
    "OpenrEventBase",
    "AsyncDebounce",
    "AsyncThrottle",
]
