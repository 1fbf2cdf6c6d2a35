"""Replicated CRDT key-value store (the distributed state backbone).

Port of `openr_tpu.kvstore` (reference: openr/kvstore/): per-area
eventually-consistent replicated store with (version, originatorId, value,
ttlVersion) conflict resolution, TTL eviction, 3-way full sync, incremental
flooding, and a peer FSM (IDLE -> SYNCING -> INITIALIZED).
"""

from .kvstore import (
    InProcessTransport,
    KvStore,
    KvStoreFilters,
    compare_values,
    generate_hash,
    merge_key_values,
)
from .client import KvStoreClientInternal

__all__ = [
    "InProcessTransport",
    "KvStore",
    "KvStoreClientInternal",
    "KvStoreFilters",
    "compare_values",
    "generate_hash",
    "merge_key_values",
]
