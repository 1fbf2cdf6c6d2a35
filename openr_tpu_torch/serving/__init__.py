"""Query-serving layer: bounded admission, batch coalescing and
double-buffered dispatch in front of the device-residency engine.

Port of `openr_tpu.serving` less its replica router: concurrent clients
submit path, what-if, KSP and metric-optimization queries into a
bounded admission queue, a coalescer groups compatible queries (same
topology epoch, same op) into one backend call, and a double-buffered
dispatch loop stages batch i+1 while batch i runs.
"""

from .backend import DecisionBatchBackend, EngineBatchBackend
from .scheduler import (
    SERVING_COUNTER_KEYS,
    Query,
    QueryResult,
    QueryScheduler,
    QueryShedError,
)

__all__ = [
    "DecisionBatchBackend",
    "EngineBatchBackend",
    "Query",
    "QueryResult",
    "QueryScheduler",
    "QueryShedError",
    "SERVING_COUNTER_KEYS",
]
