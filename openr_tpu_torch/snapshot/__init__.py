"""Engine snapshots: replica warm-start, delta-replay restore, and the
elastic-fleet autoscaling policy (see snapshot.py's module docstring for
the restore-rung contract).  Port of `openr_tpu.snapshot`."""

from .autoscale import AutoscaleDecision, AutoscalePolicy
from .snapshot import (
    SNAPSHOT_COUNTER_KEYS,
    SNAPSHOT_COUNTERS,
    SNAPSHOT_VERSION,
    EngineSnapshot,
    SnapshotCounters,
    SnapshotFormatError,
)

__all__ = [
    "AutoscaleDecision",
    "AutoscalePolicy",
    "EngineSnapshot",
    "SnapshotCounters",
    "SnapshotFormatError",
    "SNAPSHOT_COUNTER_KEYS",
    "SNAPSHOT_COUNTERS",
    "SNAPSHOT_VERSION",
]
