"""Seeded, deterministic fault injection for multi-node tests.

Port of `openr_tpu.chaos` over the port's engine, KvStore transport,
Fib agent, serving layer and daemon; the same seed gives the same
schedules and event logs as the reference's.  Its entry points compute
on the CUDA card unless the caller passes `device="cpu"`.

One seed drives every fault decision (packet drop/duplicate/reorder/
delay, transport partitions, Fib agent crashes, KvStore sync failures),
so any chaos run replays bit-for-bit from its seed — the DeltaPath-style
churn-correctness proof machinery for this repo (see PAPERS.md).
"""

from .chaos import (
    ChaosEventLog,
    ChaosIoProvider,
    ChaosSpfBackend,
    FibChaosPlan,
    KvChaosInjector,
    LinkFaultProfile,
    wait_timeout_scale,
)
from .flapstorm import FlapStormResult, FlapStormScenario

# NOTE: the fuzz *loop* stays addressed as openr_tpu_torch.chaos.fuzz.fuzz —
# re-exporting the function here would shadow the submodule attribute
from .fuzz import (
    FUZZ_COUNTER_KEYS,
    FUZZ_COUNTERS,
    FuzzEvent,
    FuzzSessionResult,
    FuzzTimeline,
    run_timeline,
    seed_timeline,
    shrink,
)
from .ocs import OcsController, OcsRewireResult
from .overload import LoadReport, OpenLoopLoadGen
from .replicafleet import (
    ChaosReplicaHandle,
    ReplicaFleetController,
    ReplicaFleetResult,
)
from .scenario import (
    ChaosScenario,
    fib_unicast_routes,
    hold_converged,
    oracle_route_dbs,
)

__all__ = [
    "ChaosEventLog",
    "ChaosIoProvider",
    "ChaosReplicaHandle",
    "ChaosScenario",
    "ChaosSpfBackend",
    "FibChaosPlan",
    "FlapStormResult",
    "FlapStormScenario",
    "FUZZ_COUNTER_KEYS",
    "FUZZ_COUNTERS",
    "FuzzEvent",
    "FuzzSessionResult",
    "FuzzTimeline",
    "KvChaosInjector",
    "LinkFaultProfile",
    "LoadReport",
    "OcsController",
    "OcsRewireResult",
    "OpenLoopLoadGen",
    "ReplicaFleetController",
    "ReplicaFleetResult",
    "fib_unicast_routes",
    "hold_converged",
    "oracle_route_dbs",
    "run_timeline",
    "seed_timeline",
    "shrink",
    "wait_timeout_scale",
]
