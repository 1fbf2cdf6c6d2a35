"""Query-serving layer: bounded admission, batch coalescing and
double-buffered dispatch in front of the device-residency engine.

Port of `openr_tpu.serving`: concurrent clients submit path, what-if,
KSP and metric-optimization queries into a bounded admission queue, a
coalescer groups compatible queries (same topology epoch, same op) into
one backend call, and a double-buffered dispatch loop stages batch i+1
while batch i runs.  `ReplicaRouter` spreads queries over K such
schedulers with epoch pinning, failover, hedging and loud sheds.
"""

from .backend import DecisionBatchBackend, EngineBatchBackend
from .router import (
    ROUTER_COUNTER_KEYS,
    ReplicaRouter,
    ReplicaUnavailableError,
    SchedulerReplica,
    dispatch_ledger_closes,
)
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
    "ReplicaRouter",
    "ReplicaUnavailableError",
    "dispatch_ledger_closes",
    "ROUTER_COUNTER_KEYS",
    "SchedulerReplica",
    "SERVING_COUNTER_KEYS",
]
