"""KvStore: replicated CRDT store with flooding and full-sync.

Port of `openr_tpu.kvstore.kvstore`.  Semantics are byte-exact with the
reference where convergence depends on it:

- `merge_key_values` reproduces KvStore::mergeKeyValues
  (openr/kvstore/KvStore.cpp:263-418): version > originatorId > value bytes
  > ttlVersion tie-break chain.
- `compare_values` reproduces KvStore::compareValues (KvStore.cpp:426-458)
  including the -2 "unknown" result when a value is missing.
- 3-way full sync: initiator sends its hash dump; responder returns full
  values where it is better plus `tobe_updated_keys` where the initiator is
  better; initiator merges and sends the finalize set back
  (requestThriftPeerSync/processThriftSuccess/finalizeFullSync,
  KvStore.cpp:1380-1640; dumpDifference KvStore.cpp).
- Peer FSM: IDLE -PEER_ADD-> SYNCING -SYNC_RESP_RCVD-> INITIALIZED, any
  error -> IDLE with exponential backoff (getNextState, KvStore.cpp:1001).
- Flooding: merged deltas flood to INITIALIZED peers except the sender;
  loop prevention via the nodeIds trail; token-bucket rate limiting with
  publication buffering (floodPublication/bufferPublication,
  KvStore.cpp:1700+).
- TTL: countdown queue evicts keys whose originator stopped refreshing;
  expired keys are published locally only (cleanupTtlCountdownQueue).

The transport is pluggable: `InProcessTransport` wires N stores in one
process for clusterless multi-node tests (the KvStoreWrapper pattern,
openr/kvstore/KvStoreWrapper.h:31); the TCP transport lives in `ctrl`.
With tracing armed (`obs.trace`), a publication that enters the store
roots a `kvstore.publication` trace (`merge_publication`, or the flood
chokepoint for a locally originated one) with a `kvstore.merge` stage,
and the trace rides the updates queue into Decision.  The transport's
fault seam (`InProcessTransport.set_chaos`) takes a
`chaos.KvChaosInjector`, whose seeded schedule fails `full_dump` and
`key_set` calls with `TransportError`, as the reference's does.  One
difference: a peer whose DUAL traffic arrived before the peering counts
as speaking DUAL (`KvStorePeer.dual_seen`), where the reference floods
it outside the SPT for good.
"""

from __future__ import annotations

import asyncio
import enum
import hashlib
import heapq
import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Iterable, Optional, Protocol

from ..obs import trace as _trace
from ..runtime.eventbase import OpenrEventBase
from ..runtime.queue import QueueClosedError, ReplicateQueue, RQueue
from ..types import (
    FloodTopoSetParams,
    KvStorePeerState,
    KvStoreSyncEvent,
    PeerEvent,
    PeerSpec,
    Publication,
    SptInfo,
    SptInfos,
    TTL_INFINITY,
    Value,
)
from ..utils.backoff import ExponentialBackoff
from .dual import DualNode, DualState

log = logging.getLogger(__name__)

# reference: Constants.h
INITIAL_BACKOFF_S = 0.064
MAX_BACKOFF_S = 8.0
PARALLEL_SYNC_LIMIT_INITIAL = 2
PARALLEL_SYNC_LIMIT_MAX = 32
TTL_THRESHOLD_S = 0.5  # Constants::kTtlThreshold (about-to-expire filter)
FLOOD_PENDING_PUBLICATION_S = 0.1  # Constants::kFloodPendingPublication
# DUAL over an unreliable per-request transport (the reference's ZMQ peer
# channel was reliable+ordered; ours is not, so we serialize per-peer and
# retry until delivery or peer removal, and reconcile with periodic
# re-assertion + anti-entropy syncs)
DUAL_SEND_RETRY_INITIAL_S = 0.25
DUAL_SEND_MAX_BACKOFF_S = 8.0
SPT_REASSERT_INTERVAL_S = 15.0
SPT_ANTI_ENTROPY_SYNC_S = 60.0
# bound on queued-but-unsent DUAL messages per peer: an unreachable peer
# must not accumulate tasks/messages without limit; oldest are dropped
# (peer_down/peer_up reconciles DUAL state on reconnect anyway)
DUAL_SEND_BACKLOG_MAX = 64


def generate_hash(version: int, originator_id: str, value: Optional[bytes]) -> int:
    """Deterministic 63-bit hash of (version, originatorId, value)
    (reference: generateHash, openr/common/Util.cpp).

    Single-shot construction (identical byte layout to the incremental
    form: version NUL originator NUL value): per-hash Python call count
    was ~70% of merge_key_values' cost at 10k-key publications."""
    data = b"%d\x00%s\x00" % (version, originator_id.encode())
    if value is not None:
        data += value
    return (
        int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "big")
        >> 1
    )


def compare_values(v1: Value, v2: Value) -> int:
    """1 if v1 better, -1 if v2 better, 0 same, -2 unknown
    (reference: KvStore::compareValues, KvStore.cpp:426-458)."""
    if v1.version != v2.version:
        return 1 if v1.version > v2.version else -1
    if v1.originator_id != v2.originator_id:
        return 1 if v1.originator_id > v2.originator_id else -1
    if v1.hash is not None and v2.hash is not None and v1.hash == v2.hash:
        if v1.ttl_version != v2.ttl_version:
            return 1 if v1.ttl_version > v2.ttl_version else -1
        return 0
    if v1.value is not None and v2.value is not None:
        if v1.value == v2.value:
            # same logical value: retain higher ttlVersion (the reference
            # reaches this via matching hashes; values compare equal here)
            if v1.ttl_version != v2.ttl_version:
                return 1 if v1.ttl_version > v2.ttl_version else -1
            return 0
        return 1 if v1.value > v2.value else -1
    return -2


class KvStoreFilters:
    """Key-prefix + originator filter (reference: KvStoreFilters,
    openr/kvstore/KvStore.h:71)."""

    def __init__(
        self,
        key_prefixes: Iterable[str] = (),
        originator_ids: Iterable[str] = (),
    ) -> None:
        self.key_prefixes = list(key_prefixes)
        self.originator_ids = set(originator_ids)

    def key_match(self, key: str, value: Value) -> bool:
        """OR semantics: match either list; empty filter matches all."""
        if not self.key_prefixes and not self.originator_ids:
            return True
        if self.key_prefixes and any(key.startswith(p) for p in self.key_prefixes):
            return True
        return bool(self.originator_ids) and value.originator_id in self.originator_ids

    def key_match_all(self, key: str, value: Value) -> bool:
        """AND semantics."""
        if self.key_prefixes and not any(
            key.startswith(p) for p in self.key_prefixes
        ):
            return False
        if self.originator_ids and value.originator_id not in self.originator_ids:
            return False
        return True


def merge_key_values(
    kv_store: dict[str, Value],
    key_vals: dict[str, Value],
    filters: Optional[KvStoreFilters] = None,
) -> dict[str, Value]:
    """Exact CRDT merge (reference: KvStore::mergeKeyValues,
    KvStore.cpp:263-418).  Mutates kv_store; returns the accepted delta."""
    kv_updates: dict[str, Value] = {}
    for key, value in key_vals.items():
        if filters is not None and not filters.key_match(key, value):
            continue
        if value.ttl_ms != TTL_INFINITY and value.ttl_ms <= 0:
            continue

        existing = kv_store.get(key)
        my_version = existing.version if existing is not None else 0
        new_version = value.version
        if new_version < my_version:
            continue

        update_all = False
        update_ttl = False
        if value.value is not None:
            if new_version > my_version:
                update_all = True
            elif value.originator_id > existing.originator_id:
                update_all = True
            elif value.originator_id == existing.originator_id:
                # deterministic winner when same (version, originator):
                # higher value bytes; equal value retains higher ttlVersion
                if existing.value is None or value.value > existing.value:
                    update_all = True
                elif value.value == existing.value:
                    if value.ttl_version > existing.ttl_version:
                        update_ttl = True
        if (
            value.value is None
            and existing is not None
            and value.version == existing.version
            and value.originator_id == existing.originator_id
            and value.ttl_version > existing.ttl_version
        ):
            update_ttl = True

        if not update_all and not update_ttl:
            continue

        if update_all:
            new_value = Value(
                version=value.version,
                originator_id=value.originator_id,
                value=value.value,
                ttl_ms=value.ttl_ms,
                ttl_version=value.ttl_version,
                hash=value.hash
                if value.hash is not None
                else generate_hash(value.version, value.originator_id, value.value),
            )
            kv_store[key] = new_value
        else:  # update_ttl
            existing.ttl_ms = value.ttl_ms
            existing.ttl_version = value.ttl_version

        kv_updates[key] = value
    return kv_updates


# ---------------------------------------------------------------------------
# Transport seam
# ---------------------------------------------------------------------------


@dataclass(slots=True)
class KeyDumpParams:
    """Reference: thrift::KeyDumpParams (openr/if/Types.thrift)."""

    keys: list[str] = field(default_factory=list)  # key prefixes
    originator_ids: list[str] = field(default_factory=list)
    key_val_hashes: Optional[dict[str, Value]] = None  # 3-way sync digest


@dataclass(slots=True)
class KeySetParams:
    """Reference: thrift::KeySetParams."""

    key_vals: dict[str, Value] = field(default_factory=dict)
    node_ids: Optional[list[str]] = None
    flood_root_id: Optional[str] = None
    timestamp_ms: int = 0


class KvStoreTransport(Protocol):
    """How one store's area DB talks to a peer store (thrift in the
    reference)."""

    async def full_dump(
        self, peer: PeerSpec, area: str, params: KeyDumpParams
    ) -> Publication: ...

    async def key_set(
        self, peer: PeerSpec, area: str, params: KeySetParams
    ) -> None: ...

    async def dual_messages(self, peer: PeerSpec, area: str, msgs) -> None: ...

    async def flood_topo_set(
        self, peer: PeerSpec, area: str, params
    ) -> None: ...


class TransportError(RuntimeError):
    pass


class InProcessTransport:
    """N stores in one process; addressing by PeerSpec.peer_addr.

    Supports fault injection (partitions) for tests — the MockIoProvider
    pattern (openr/tests/mocks/MockIoProvider.h:41)."""

    def __init__(self) -> None:
        self._stores: dict[str, "KvStore"] = {}
        self._partitioned: set[frozenset[str]] = set()
        # seeded per-edge failure injector (chaos.KvChaosInjector duck
        # type: check(op, src, dst) raises TransportError on schedule)
        self._chaos = None

    def register(self, addr: str, store: "KvStore") -> None:
        self._stores[addr] = store

    def set_chaos(self, injector) -> None:
        self._chaos = injector

    def _chaos_check(self, op: str, src: str, dst: str) -> None:
        if self._chaos is not None:
            self._chaos.check(op, src, dst)

    def set_partitioned(self, a: str, b: str, partitioned: bool) -> None:
        key = frozenset((a, b))
        if partitioned:
            self._partitioned.add(key)
        else:
            self._partitioned.discard(key)

    def _target(self, caller_addr: str, peer: PeerSpec) -> "KvStore":
        store = self._stores.get(peer.peer_addr)
        if store is None or not store.is_running:
            raise TransportError(f"peer {peer.peer_addr} unreachable")
        if frozenset((caller_addr, peer.peer_addr)) in self._partitioned:
            raise TransportError(
                f"partition between {caller_addr} and {peer.peer_addr}"
            )
        return store

    def bind(self, addr: str) -> "_BoundInProcessTransport":
        return _BoundInProcessTransport(self, addr)


class _BoundInProcessTransport:
    def __init__(self, fabric: InProcessTransport, addr: str) -> None:
        self._fabric = fabric
        self.addr = addr

    async def full_dump(
        self, peer: PeerSpec, area: str, params: KeyDumpParams
    ) -> Publication:
        self._fabric._chaos_check("full_dump", self.addr, peer.peer_addr)
        store = self._fabric._target(self.addr, peer)
        return await asyncio.wrap_future(
            store.run_in_event_base_thread(
                lambda: store._db(area).process_full_dump_request(params)
            )
        )

    async def key_set(
        self, peer: PeerSpec, area: str, params: KeySetParams
    ) -> None:
        self._fabric._chaos_check("key_set", self.addr, peer.peer_addr)
        store = self._fabric._target(self.addr, peer)
        await asyncio.wrap_future(
            store.run_in_event_base_thread(
                lambda: store._db(area).process_key_set_request(params)
            )
        )

    async def dual_messages(self, peer: PeerSpec, area: str, msgs) -> None:
        store = self._fabric._target(self.addr, peer)
        await asyncio.wrap_future(
            store.run_in_event_base_thread(
                lambda: store._db(area).process_dual_messages(msgs)
            )
        )

    async def flood_topo_set(self, peer: PeerSpec, area: str, params) -> None:
        store = self._fabric._target(self.addr, peer)
        await asyncio.wrap_future(
            store.run_in_event_base_thread(
                lambda: store._db(area).process_flood_topo_set(params)
            )
        )


# ---------------------------------------------------------------------------
# TTL countdown
# ---------------------------------------------------------------------------


@dataclass(slots=True, order=True)
class TtlCountdownEntry:
    """Reference: TtlCountdownQueueEntry (KvStore.h:52-69)."""

    expiry_time: float
    key: str = field(compare=False)
    version: int = field(compare=False)
    ttl_version: int = field(compare=False)
    originator_id: str = field(compare=False)


class _TokenBucket:
    """Reference: folly::BasicTokenBucket used for flood rate limiting
    (KvStore.h:497, floodRate config)."""

    def __init__(self, rate: float, burst: float) -> None:
        self._rate = rate
        self._burst = burst
        self._tokens = burst
        self._last = time.monotonic()

    def consume(self, n: float = 1.0) -> bool:
        now = time.monotonic()
        self._tokens = min(self._burst, self._tokens + (now - self._last) * self._rate)
        self._last = now
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False


# ---------------------------------------------------------------------------
# Per-area DB
# ---------------------------------------------------------------------------


class KvStorePeerEvent(enum.IntEnum):
    PEER_ADD = 0
    SYNC_RESP_RCVD = 2
    THRIFT_API_ERROR = 3


_NEXT_STATE = {
    (KvStorePeerState.IDLE, KvStorePeerEvent.PEER_ADD): KvStorePeerState.SYNCING,
    (KvStorePeerState.IDLE, KvStorePeerEvent.THRIFT_API_ERROR): KvStorePeerState.IDLE,
    (
        KvStorePeerState.SYNCING,
        KvStorePeerEvent.SYNC_RESP_RCVD,
    ): KvStorePeerState.INITIALIZED,
    (KvStorePeerState.SYNCING, KvStorePeerEvent.THRIFT_API_ERROR): KvStorePeerState.IDLE,
    (
        KvStorePeerState.INITIALIZED,
        KvStorePeerEvent.SYNC_RESP_RCVD,
    ): KvStorePeerState.INITIALIZED,
    (
        KvStorePeerState.INITIALIZED,
        KvStorePeerEvent.THRIFT_API_ERROR,
    ): KvStorePeerState.IDLE,
}


def get_next_state(
    curr: KvStorePeerState, event: KvStorePeerEvent
) -> KvStorePeerState:
    """Reference: KvStoreDb::getNextState (KvStore.cpp:1001-1047)."""
    nxt = _NEXT_STATE.get((curr, event))
    assert nxt is not None, f"invalid transition {curr} x {event}"
    return nxt


@dataclass
class KvStorePeer:
    """Reference: KvStoreDb::KvStorePeer (KvStore.h:429-453)."""

    name: str
    spec: PeerSpec
    backoff: ExponentialBackoff
    in_flight: bool = False
    # keys flooded while this peer was not yet INITIALIZED; flushed on sync
    # completion.  The reference silently drops these (floodPublication skips
    # non-initialized peers and the full-sync digest was snapshotted at
    # request time), leaving a loss window that its deployments paper over
    # with KvStoreClientInternal persist-key refresh; we close it instead.
    pending_flood_keys: set[str] = field(default_factory=set)
    # FIFO lock held by the single outbox drainer so retries cannot
    # reorder an older message after a newer one
    send_lock: asyncio.Lock = field(default_factory=asyncio.Lock)
    # DUAL message backlog (bounded at DUAL_SEND_BACKLOG_MAX):
    # (send_once, failure_counter) entries drained in order
    outbox: deque = field(default_factory=deque)
    # topo-set coalescing: (root_id, all_roots) -> latest params.  A
    # retried older set for a root is superseded by the newest one
    # (idempotent child add/remove — final state is what matters), so an
    # unreachable peer holds at most one pending set per root.
    pending_topo_set: dict = field(default_factory=dict)
    # set while an anti-entropy reconciliation sync is in flight, so its
    # completion does not re-fire initialization signaling (see
    # anti_entropy_sync / process_sync_success)
    anti_entropy_pending: bool = False
    # set when the DUAL outbox overflowed while this peer stayed up: a
    # dropped message means our DUAL exchange with it is no longer
    # complete, so once the backlog drains the drainer bounces DUAL state
    # for this peer (reconnect-time reconciliation alone never fires for
    # a slow-but-alive peer)
    dual_reconcile_needed: bool = False
    # whether this peer has ever spoken DUAL to us.  A flood-opt-disabled
    # peer never does, and must keep receiving full-mesh floods even once
    # our SPT is valid — otherwise a mixed-config mesh silently starves it.
    # (The reference assumes a uniform knob; its getFloodPeers comment
    # mentions "peers-who-does-not-support-dual" but no flag exists.)
    dual_seen: bool = False


class KvStoreDb:
    """One area's store (reference: KvStoreDb, KvStore.h:191).

    All methods run on the owning KvStore's event-base thread."""

    def __init__(self, store: "KvStore", area: str) -> None:
        self.store = store
        self.area = area
        self.kv: dict[str, Value] = {}
        self.peers: dict[str, KvStorePeer] = {}
        self._ttl_heap: list[TtlCountdownEntry] = []
        self._ttl_timer = None
        self._sync_timer = None
        self._parallel_sync_limit = PARALLEL_SYNC_LIMIT_INITIAL
        self._flood_limiter = (
            _TokenBucket(store.flood_rate[0], store.flood_rate[1])
            if store.flood_rate
            else None
        )
        # (flood_root_id, learned-from sender) -> buffered key names
        self._publication_buffer: dict[
            tuple[Optional[str], Optional[str]], set[str]
        ] = {}
        self._pending_flood_timer = None
        self._spt_reassert_timer = None
        self._anti_entropy_timer = None
        self.counters: dict[str, int] = {}
        # DUAL flood-topology (reference: KvStoreDb extends DualNode,
        # KvStore.h:191; hooks at :309 sendDualMessages and :337
        # processNexthopChange).  Composed rather than inherited.
        self.dual = DualNode(
            store.node_id,
            is_root=store.enable_flood_optimization and store.is_flood_root,
            send_dual_messages=self._send_dual_messages,
            process_nexthop_change=self._process_nexthop_change,
        )

    def _bump(self, counter: str, n: int = 1) -> None:
        self.counters[counter] = self.counters.get(counter, 0) + n

    # -- DUAL flood-topology --------------------------------------------------

    def _send_dual_messages(self, neighbor: str, msgs) -> bool:
        """DualNode I/O hook (reference: KvStoreDb::sendDualMessages,
        KvStore.cpp:3117)."""
        peer = self.peers.get(neighbor)
        if peer is None:
            log.warning("dual: no peer %s to send messages to", neighbor)
            return False
        self._bump("kvstore.dual.num_pkt_sent")
        self._dual_to_peer(peer, msgs)
        return True

    async def _drain_peer_outbox(self, peer: KvStorePeer) -> None:
        """Reliable+ordered delivery of the peer's queued DUAL traffic over
        the per-request transport: one drainer per peer (FIFO send_lock)
        prevents a retried older message landing after a newer one; retries
        continue (capped backoff) until delivery or until the peer
        registration is replaced/removed — at which point peer_down/peer_up
        reconciles DUAL state anyway.  Restores the delivery semantics the
        reference got from its ordered ZMQ peer channel, with a bounded
        backlog: new work enqueued while draining is picked up by the
        running drainer, so an unreachable peer holds at most
        DUAL_SEND_BACKLOG_MAX messages + one pending topo-set per root.

        INTENTIONAL reorder vs the reference's single FIFO channel:
        pending topo-sets are serviced ahead of queued DUAL messages.
        Topo-sets are idempotent FINAL-STATE registrations (child
        add/remove — processFloodTopoSet is state-independent in the
        reference too), so delivering one ahead of an older DUAL message
        cannot corrupt the exchange, and servicing them first keeps the
        SPT attach latency independent of DUAL backlog depth.  Starvation
        is bounded: topo-sets coalesce by (root, all_roots) key, so the
        map holds at most one entry per root and only sustained nexthop
        flapping could re-fill it — at which point attaching to the
        latest parent IS the priority."""
        if peer.send_lock.locked():
            return  # a drainer is running; it will see the new work
        async with peer.send_lock:
            delay = DUAL_SEND_RETRY_INITIAL_S
            failures = 0
            while self.peers.get(peer.name) is peer:
                if peer.pending_topo_set:
                    # oldest-first across roots (dict preserves insertion
                    # order, so an all-roots clear precedes later sets)
                    topo_key = next(iter(peer.pending_topo_set))
                    params = peer.pending_topo_set[topo_key]

                    async def send_once(params=params):
                        await self.store.transport.flood_topo_set(
                            peer.spec, self.area, params
                        )

                    def done(topo_key=topo_key, params=params):
                        # only clear if not superseded while in flight
                        if peer.pending_topo_set.get(topo_key) is params:
                            del peer.pending_topo_set[topo_key]

                    failure_counter = "kvstore.dual.num_topo_set_failure"
                elif peer.outbox:
                    entry = peer.outbox[0]
                    send_once, failure_counter = entry

                    def done(entry=entry):
                        # the in-flight head may have been dropped by a
                        # backlog overflow while we awaited the send: only
                        # pop if it is still the head, else the overflow
                        # already accounted for it and the new head must
                        # not be silently discarded
                        if peer.outbox and peer.outbox[0] is entry:
                            peer.outbox.popleft()

                elif peer.dual_reconcile_needed:
                    # backlog drained after an overflow drop: bounce DUAL
                    # state with this (live) peer so whatever the dropped
                    # message carried is regenerated from a clean slate.
                    # peer_down/peer_up enqueue fresh messages into this
                    # same outbox; the loop delivers them next.
                    peer.dual_reconcile_needed = False
                    self._bump("kvstore.dual.num_overflow_reconcile")
                    self.dual.peer_down(peer.name)
                    self.dual.peer_up(peer.name, 1)
                    continue
                else:
                    return
                try:
                    await send_once()
                    done()
                    delay = DUAL_SEND_RETRY_INITIAL_S
                    failures = 0
                except Exception as exc:
                    self._bump(failure_counter)
                    failures += 1
                    if failures % 8 == 1:
                        log.warning(
                            "dual: send to %s failing (attempt %d): %r",
                            peer.name,
                            failures,
                            exc,
                        )
                    await asyncio.sleep(delay)
                    delay = min(delay * 2, DUAL_SEND_MAX_BACKOFF_S)

    def _dual_to_peer(self, peer: KvStorePeer, msgs) -> None:
        if len(peer.outbox) >= DUAL_SEND_BACKLOG_MAX:
            # drop oldest; a live peer is reconciled by the drainer once
            # the backlog clears (dual_reconcile_needed), a dead one by
            # the reconnect-time peer_down/peer_up
            peer.outbox.popleft()
            peer.dual_reconcile_needed = True
            self._bump("kvstore.dual.num_pkt_backlog_dropped")

        async def send_once():
            await self.store.transport.dual_messages(
                peer.spec, self.area, msgs
            )

        peer.outbox.append((send_once, "kvstore.dual.num_pkt_send_failure"))
        self.store._spawn(self._drain_peer_outbox(peer))

    def _process_nexthop_change(
        self, root_id: str, old_nh: Optional[str], new_nh: Optional[str]
    ) -> None:
        """SPT parent changed: (un)register as child remotely + full-sync
        with the new parent (reference: KvStoreDb::processNexthopChange,
        KvStore.cpp:2310-2363)."""
        log.info(
            "dual nexthop change: root-id (%s) %s -> %s",
            root_id,
            old_nh or "none",
            new_nh or "none",
        )
        if new_nh is not None:
            peer = self.peers.get(new_nh)
            if peer is not None:
                self._send_topo_set(
                    peer, FloodTopoSetParams(
                        root_id=root_id,
                        src_id=self.store.node_id,
                        set_child=True,
                    )
                )
                # full-sync with the new parent so the SPT edge is never a
                # disconnected state (reference enqueues peersToSyncWith_)
                if peer.spec.state != KvStorePeerState.IDLE:
                    peer.spec.state = KvStorePeerState.IDLE
                self._schedule_sync(0.0)
        if old_nh is not None:
            peer = self.peers.get(old_nh)
            if peer is not None:
                self._send_topo_set(
                    peer, FloodTopoSetParams(
                        root_id=root_id,
                        src_id=self.store.node_id,
                        set_child=False,
                    )
                )

    def _send_topo_set(self, peer: KvStorePeer, params) -> None:
        # coalesce by (root, all_roots): latest set wins — child add/remove
        # is idempotent, so only the final state needs delivering.
        # all_roots is normalized (it defaults to None) so the
        # already-pending guard in reassert_spt_children matches.
        key = (params.root_id, bool(params.all_roots))
        peer.pending_topo_set[key] = params
        self.store._spawn(self._drain_peer_outbox(peer))

    def reassert_spt_children(self) -> None:
        """Re-register as a child with every current SPT parent.

        Belt-and-braces on top of _send_reliably: if our parent restarted or
        otherwise lost its child table, re-assertion (idempotent set insert)
        re-attaches us.  No reference equivalent — its ZMQ channel was
        reliable and peers restarting re-ran the whole peer FSM."""
        if self._spt_reassert_timer is not None:
            self._spt_reassert_timer.cancel()
            self._spt_reassert_timer = None
        if not self.peers:
            return  # re-armed by the next add_peers
        for root_id, dual in self.dual.duals.items():
            nexthop = dual.info.nexthop
            if nexthop is None or nexthop == self.store.node_id:
                continue
            peer = self.peers.get(nexthop)
            if peer is None:
                continue
            if (root_id, False) in peer.pending_topo_set:
                continue  # a set for this root is already pending/retrying
            self._send_topo_set(
                peer,
                FloodTopoSetParams(
                    root_id=root_id,
                    src_id=self.store.node_id,
                    set_child=True,
                ),
            )
        self._spt_reassert_timer = self.store.schedule_timeout(
            SPT_REASSERT_INTERVAL_S, self.reassert_spt_children
        )

    def anti_entropy_sync(self) -> None:
        """Periodic digest full-sync with the SPT parent.

        Publications flooded by the parent while it (transiently) did not
        know us as a child are skipped silently — we are INITIALIZED, so
        they are not even captured in pending_flood_keys.  A low-frequency
        3-way sync (hashes only when already consistent) closes that
        residual loss window."""
        if self._anti_entropy_timer is not None:
            self._anti_entropy_timer.cancel()
            self._anti_entropy_timer = None
        if not self.peers:
            return  # re-armed by the next add_peers
        root_id = self.dual.get_spt_root_id()
        parent = (
            self.dual.get_dual(root_id).info.nexthop
            if root_id is not None
            else None
        )
        if parent is not None and parent != self.store.node_id:
            peer = self.peers.get(parent)
            if peer is not None and peer.spec.state == KvStorePeerState.INITIALIZED:
                # steady-state reconciliation, not an initial sync: flag it
                # so completion neither re-fires KvStoreSyncEvent (which
                # gates downstream initialization) nor inflates the
                # full-sync counters
                peer.anti_entropy_pending = True
                peer.spec.state = KvStorePeerState.IDLE
                self._bump("kvstore.num_anti_entropy_sync")
                self._schedule_sync(0.0)
        self._anti_entropy_timer = self.store.schedule_timeout(
            SPT_ANTI_ENTROPY_SYNC_S, self.anti_entropy_sync
        )

    def process_dual_messages(self, msgs) -> None:
        """Peer-facing entry (reference: KvStore.cpp:906-923 — which drops
        DUAL traffic when the optimization is off, as must we: a disabled
        node has an empty neighbor view and would wedge enabled queriers
        waiting on replies that never come)."""
        if not self.store.enable_flood_optimization:
            self._bump("kvstore.dual.num_pkt_dropped")
            return
        self._bump("kvstore.dual.num_pkt_recv")
        peer = self.peers.get(msgs.src_id)
        if peer is not None:
            peer.dual_seen = True
        self.dual.process_dual_messages(msgs)

    def process_flood_topo_set(self, params) -> None:
        """FLOOD_TOPO_SET (reference: KvStoreDb::processFloodTopoSet,
        KvStore.cpp:2231-2263)."""
        if not self.store.enable_flood_optimization:
            return
        peer = self.peers.get(params.src_id)
        if peer is not None:
            peer.dual_seen = True
        if params.all_roots and not params.set_child:
            for dual in self.dual.duals.values():
                dual.remove_child(params.src_id)
            return
        if not self.dual.has_dual(params.root_id):
            log.error("processFloodTopoSet unknown root-id %s", params.root_id)
            return
        dual = self.dual.get_dual(params.root_id)
        if params.set_child:
            dual.add_child(params.src_id)
        else:
            dual.remove_child(params.src_id)

    def process_flood_topo_get(self):
        """FLOOD_TOPO_GET (reference: KvStoreDb::processFloodTopoGet,
        KvStore.cpp:2195-2228)."""
        infos = SptInfos()
        for root_id, dual in self.dual.duals.items():
            info = dual.info
            infos.infos[root_id] = SptInfo(
                passive=info.sm.state == DualState.PASSIVE,
                cost=info.distance,
                parent=info.nexthop,
                children=sorted(dual.children()),
            )
        root_id = self.dual.get_spt_root_id()
        infos.flood_root_id = root_id
        infos.flood_peers = sorted(self._flood_peers(root_id))
        return infos

    # -- reads ---------------------------------------------------------------

    def get_key_vals(self, keys: Iterable[str]) -> Publication:
        pub = Publication(area=self.area)
        for key in keys:
            val = self.kv.get(key)
            if val is not None:
                pub.key_vals[key] = _copy_value(val)
        self.update_publication_ttl(pub)
        return pub

    def dump_all_with_filters(
        self,
        filters: KvStoreFilters,
        match_all: bool = False,
        do_not_publish_value: bool = False,
    ) -> Publication:
        """Reference: dumpAllWithFilters."""
        pub = Publication(area=self.area)
        match = filters.key_match_all if match_all else filters.key_match
        for key, val in self.kv.items():
            if not match(key, val):
                continue
            out = _copy_value(val)
            if do_not_publish_value:
                out.value = None
            pub.key_vals[key] = out
        return pub

    def dump_hash_with_filters(self, filters: KvStoreFilters) -> Publication:
        """Reference: dumpHashWithFilters — version/originator/hash/ttl only."""
        pub = Publication(area=self.area)
        for key, val in self.kv.items():
            if not filters.key_match(key, val):
                continue
            pub.key_vals[key] = Value(
                version=val.version,
                originator_id=val.originator_id,
                value=None,
                ttl_ms=val.ttl_ms,
                ttl_version=val.ttl_version,
                hash=val.hash,
            )
        return pub

    def dump_difference(
        self, my_key_vals: dict[str, Value], req_key_vals: dict[str, Value]
    ) -> Publication:
        """Reference: dumpDifference — keyVals I know better, plus
        tobe_updated_keys the requester knows better."""
        pub = Publication(area=self.area, tobe_updated_keys=[])
        for key in set(my_key_vals) | set(req_key_vals):
            mine = my_key_vals.get(key)
            theirs = req_key_vals.get(key)
            if mine is None:
                pub.tobe_updated_keys.append(key)
                continue
            if theirs is None:
                pub.key_vals[key] = mine
                continue
            rc = compare_values(mine, theirs)
            if rc in (1, -2):
                pub.key_vals[key] = mine
            if rc in (-1, -2):
                pub.tobe_updated_keys.append(key)
        return pub

    # -- transport-facing request handlers ------------------------------------

    def process_full_dump_request(self, params: KeyDumpParams) -> Publication:
        """Server side of full sync (reference: OpenrCtrlHandler
        semifuture_getKvStoreKeyValsFilteredArea -> KvStoreDb)."""
        filters = KvStoreFilters(params.keys, params.originator_ids)
        pub = self.dump_all_with_filters(filters)
        if params.key_val_hashes is not None:
            pub = self.dump_difference(pub.key_vals, params.key_val_hashes)
        self._bump("kvstore.cmd_key_dump")
        self.update_publication_ttl(pub)
        return pub

    def process_key_set_request(self, params: KeySetParams) -> None:
        """Server side of KEY_SET / flooding (reference:
        semifuture_setKvStoreKeyVals -> mergePublication)."""
        self._bump("kvstore.cmd_key_set")
        pub = Publication(
            key_vals=params.key_vals,
            node_ids=params.node_ids,
            flood_root_id=params.flood_root_id,
            area=self.area,
        )
        self.merge_publication(pub)

    # -- merge + flood --------------------------------------------------------

    def merge_publication(
        self, pub: Publication, sender_id: Optional[str] = None
    ) -> int:
        """Reference: mergePublication (KvStore.cpp)."""
        tr = _trace.TRACE
        if tr is not None:
            # a publication entering this node roots a trace; it rides the
            # updates queue into Decision and Fib's terminal finishes it
            root = tr.root("kvstore.publication", area=self.area)
            if root is not None:
                with tr.activate((root,)):
                    return self._merge_publication_impl(pub, sender_id)
        return self._merge_publication_impl(pub, sender_id)

    def _merge_publication_impl(
        self, pub: Publication, sender_id: Optional[str]
    ) -> int:
        self._bump("kvstore.received_publications")
        self._bump("kvstore.received_key_vals", len(pub.key_vals))

        need_finalize = (
            sender_id is not None
            and pub.tobe_updated_keys is not None
            and len(pub.tobe_updated_keys) > 0
        )
        if not pub.key_vals and not need_finalize:
            return 0
        # loop prevention
        if pub.node_ids is not None and self.store.node_id in pub.node_ids:
            self._bump("kvstore.looped_publications")
            return 0

        with _trace.maybe_child("kvstore.merge"):
            delta = Publication(
                key_vals=merge_key_values(self.kv, pub.key_vals, self.store.filters),
                flood_root_id=pub.flood_root_id,
                area=self.area,
                node_ids=list(pub.node_ids) if pub.node_ids is not None else None,
            )
        kv_update_cnt = len(delta.key_vals)
        self._bump("kvstore.updated_key_vals", kv_update_cnt)
        self.update_ttl_countdown_queue(delta)
        if delta.key_vals:
            # sender_id matters when the publication has no node_ids trail
            # (full-sync responses): without it the delta would be captured
            # in the sender's pending_flood_keys and echoed straight back
            self.flood_publication(delta, sender_id=sender_id)
        if need_finalize:
            self.finalize_full_sync(pub.tobe_updated_keys, sender_id)
        return kv_update_cnt

    def set_key_vals(self, params: KeySetParams) -> None:
        """Local API origination (reference: setKvStoreKeyVals)."""
        for val in params.key_vals.values():
            if val.hash is None:
                val.hash = generate_hash(val.version, val.originator_id, val.value)
        self.process_key_set_request(params)

    def flood_publication(
        self,
        pub: Publication,
        rate_limit: bool = True,
        set_flood_root: bool = True,
        sender_id: Optional[str] = None,
    ) -> None:
        """Reference: floodPublication (KvStore.cpp).

        `sender_id` identifies the peer the publication was learned from
        when there is no node_ids trail (full-sync responses)."""
        # Locally-originated updates ride the SPT rooted at the current
        # flood root (reference: floodPublication stamps floodRootId when
        # the optimization is on, KvStore.cpp:2841-2864).  Stamped before
        # the rate-limit buffer so buffered publications keep their SPT
        # routing instead of falling back to full mesh on flush.
        if (
            set_flood_root
            and pub.flood_root_id is None
            and self.store.enable_flood_optimization
        ):
            pub.flood_root_id = self.dual.get_spt_root_id()

        if self._flood_limiter and rate_limit and not self._flood_limiter.consume(1):
            self._buffer_publication(pub, sender_id)
            if self._pending_flood_timer is None:
                self._pending_flood_timer = self.store.schedule_timeout(
                    FLOOD_PENDING_PUBLICATION_S, self._flood_buffered
                )
            return
        if self._publication_buffer:
            self._buffer_publication(pub, sender_id)
            self._flood_buffered_now()
            return

        self.update_publication_ttl(pub, remove_about_to_expire=True)
        if not pub.key_vals and not pub.expired_keys:
            return

        if pub.node_ids:
            sender_id = pub.node_ids[-1]
        if pub.node_ids is None:
            pub.node_ids = []
        pub.node_ids.append(self.store.node_id)

        # internal subscribers
        tr = _trace.TRACE
        root = None
        if tr is not None and not tr.scope():
            # a locally originated publication (API origination, TTL
            # expiry) roots its trace here instead of in merge_publication
            root = tr.root("kvstore.publication", area=self.area)
        if root is not None:
            with tr.activate((root,)):
                self.store.kvstore_updates_queue.push(pub)
        else:
            self.store.kvstore_updates_queue.push(pub)
        self._bump("kvstore.num_updates")

        if not pub.key_vals:
            return  # expired-keys-only publications stay local

        params = KeySetParams(
            key_vals=dict(pub.key_vals),
            node_ids=list(pub.node_ids),
            flood_root_id=pub.flood_root_id,
            timestamp_ms=int(time.time() * 1000),
        )
        for peer_name in self._flood_peers(pub.flood_root_id):
            peer = self.peers.get(peer_name)
            if peer is None or peer_name == sender_id:
                continue
            if peer.spec.state != KvStorePeerState.INITIALIZED:
                peer.pending_flood_keys.update(pub.key_vals)
                continue
            self._bump("kvstore.thrift.num_flood_pub")
            self.store._spawn(self._flood_to_peer(peer, params))

    async def _flood_to_peer(self, peer: KvStorePeer, params: KeySetParams) -> None:
        try:
            await self.store.transport.key_set(peer.spec, self.area, params)
        except Exception:
            self.process_sync_failure(peer.name)
            self._bump("kvstore.thrift.num_flood_pub_failure")

    def _flood_peers(self, flood_root_id: Optional[str]) -> list[str]:
        """SPT-constrained flood peers, falling back to full mesh when the
        optimization is off or no valid SPT exists (reference:
        KvStoreDb::getFloodPeers, KvStore.cpp:2813-2834)."""
        spt_peers = self.dual.get_spt_peers(flood_root_id)
        flood_to_all = (
            not self.store.enable_flood_optimization or not spt_peers
        )
        # peers that have never spoken DUAL (flood-opt-disabled nodes in a
        # mixed-config mesh) always get the full flood
        return [
            name
            for name, peer in self.peers.items()
            if flood_to_all or name in spt_peers or not peer.dual_seen
        ]

    def _buffer_publication(
        self, pub: Publication, sender_id: Optional[str] = None
    ) -> None:
        self._bump("kvstore.rate_limit_suppress")
        # keyed by (flood-root, learned-from) so the flush preserves both the
        # SPT routing and the sender-echo exclusion (the node_ids trail also
        # ends with the sender when present)
        if pub.node_ids:
            sender_id = pub.node_ids[-1]
        buf = self._publication_buffer.setdefault(
            (pub.flood_root_id, sender_id), set()
        )
        buf.update(pub.key_vals)
        buf.update(pub.expired_keys)

    def _flood_buffered(self) -> None:
        self._pending_flood_timer = None
        self._flood_buffered_now()

    def _flood_buffered_now(self) -> None:
        """Reference: floodBufferedUpdates."""
        if not self._publication_buffer:
            return
        buffers, self._publication_buffer = self._publication_buffer, {}
        for (flood_root_id, sender_id), keys in buffers.items():
            pub = Publication(area=self.area, flood_root_id=flood_root_id)
            for key in keys:
                val = self.kv.get(key)
                if val is not None:
                    pub.key_vals[key] = _copy_value(val)
                else:
                    pub.expired_keys.append(key)
            self.flood_publication(
                pub,
                rate_limit=False,
                set_flood_root=False,
                sender_id=sender_id,
            )

    # -- full sync ------------------------------------------------------------

    def add_peers(self, peers: dict[str, PeerSpec]) -> None:
        """Reference: addThriftPeers (KvStore.cpp:1660+)."""
        new_names: list[str] = []
        for name, new_spec in peers.items():
            spec = PeerSpec(
                peer_addr=new_spec.peer_addr,
                ctrl_port=new_spec.ctrl_port,
                state=KvStorePeerState.IDLE,
            )
            existing = self.peers.get(name)
            if existing is not None:
                existing.spec = spec
                # a re-added peer's next sync is a genuine initial sync
                existing.anti_entropy_pending = False
            else:
                self.peers[name] = KvStorePeer(
                    name=name,
                    spec=spec,
                    backoff=ExponentialBackoff(INITIAL_BACKOFF_S, MAX_BACKOFF_S),
                    # DUAL messages that arrived before this peering count:
                    # a converged neighbor may never send another, and an
                    # unseen peer is flooded outside the SPT forever (the
                    # reference drops that evidence)
                    dual_seen=self.dual.pkt_counters.get(name, {}).get("pkt_recv", 0) > 0,
                )
                new_names.append(name)
        # DUAL: every KvStore peering link has unit cost (reference:
        # KvStore.cpp addPeers -> DualNode::peerUp(peerName, 1)).  A new
        # peer may have stale child registrations for us from a
        # non-graceful restart: clear them all first (reference:
        # unsetChildAll, KvStore.cpp:1796-1800).
        if self.store.enable_flood_optimization:
            for name in new_names:
                peer = self.peers[name]
                self._send_topo_set(
                    peer,
                    FloodTopoSetParams(
                        root_id="",
                        src_id=self.store.node_id,
                        set_child=False,
                        all_roots=True,
                    ),
                )
                self.dual.peer_up(name, 1)
            if self._spt_reassert_timer is None:
                self._spt_reassert_timer = self.store.schedule_timeout(
                    SPT_REASSERT_INTERVAL_S, self.reassert_spt_children
                )
            if self._anti_entropy_timer is None:
                self._anti_entropy_timer = self.store.schedule_timeout(
                    SPT_ANTI_ENTROPY_SYNC_S, self.anti_entropy_sync
                )
        self._schedule_sync(0.0)

    def del_peers(self, peers: Iterable[str]) -> None:
        for name in peers:
            existed = self.peers.pop(name, None)
            if existed is not None and self.store.enable_flood_optimization:
                self.dual.peer_down(name)

    def dump_peers(self) -> dict[str, PeerSpec]:
        return {name: peer.spec for name, peer in self.peers.items()}

    def get_peer_state(self, peer_name: str) -> Optional[KvStorePeerState]:
        peer = self.peers.get(peer_name)
        return peer.spec.state if peer else None

    def get_peers_by_state(self, state: KvStorePeerState) -> list[str]:
        return [n for n, p in self.peers.items() if p.spec.state == state]

    def _schedule_sync(self, delay_s: float) -> None:
        if self._sync_timer is not None:
            self._sync_timer.cancel()
        self._sync_timer = self.store.schedule_timeout(
            delay_s, self.request_peer_sync
        )

    def request_peer_sync(self) -> None:
        """Promote IDLE peers to SYNCING and fire full-dump requests
        (reference: requestThriftPeerSync, KvStore.cpp:1380)."""
        self._sync_timer = None
        timeout = MAX_BACKOFF_S
        num_syncing = len(self.get_peers_by_state(KvStorePeerState.SYNCING))
        for name, peer in self.peers.items():
            if peer.spec.state != KvStorePeerState.IDLE:
                continue
            if not peer.backoff.can_try_now():
                timeout = min(timeout, peer.backoff.get_time_remaining_until_retry())
                continue
            peer.spec.state = get_next_state(
                peer.spec.state, KvStorePeerEvent.PEER_ADD
            )
            num_syncing += 1
            params = KeyDumpParams()
            if self.store.filters is not None:
                params.keys = list(self.store.filters.key_prefixes)
                params.originator_ids = list(self.store.filters.originator_ids)
            params.key_val_hashes = self.dump_hash_with_filters(
                KvStoreFilters()
            ).key_vals
            self._bump("kvstore.thrift.num_full_sync")
            self.store._spawn(self._full_sync_with_peer(peer, params))
            if num_syncing > self._parallel_sync_limit:
                timeout = MAX_BACKOFF_S
                break
        if (
            self.get_peers_by_state(KvStorePeerState.IDLE)
            or num_syncing > self._parallel_sync_limit
        ):
            self._schedule_sync(timeout)

    async def _full_sync_with_peer(
        self, peer: KvStorePeer, params: KeyDumpParams
    ) -> None:
        try:
            pub = await self.store.transport.full_dump(
                peer.spec, self.area, params
            )
        except Exception:
            self._bump("kvstore.thrift.num_full_sync_failure")
            self.process_sync_failure(peer.name)
            return
        self.process_sync_success(peer.name, pub)

    def process_sync_success(self, peer_name: str, pub: Publication) -> None:
        """Reference: processThriftSuccess (KvStore.cpp:1530-1610)."""
        peer = self.peers.get(peer_name)
        if peer is None:
            return
        if peer.spec.state == KvStorePeerState.IDLE:
            return  # stale response; a new sync round will supersede it
        self.merge_publication(pub, sender_id=peer_name)
        peer.spec.state = get_next_state(
            peer.spec.state, KvStorePeerEvent.SYNC_RESP_RCVD
        )
        peer.backoff.report_success()
        if peer.anti_entropy_pending:
            # periodic reconciliation: don't re-fire initialization
            # signaling or the initial-sync counters in steady state
            peer.anti_entropy_pending = False
            self._bump("kvstore.num_anti_entropy_sync_success")
        else:
            self._bump("kvstore.thrift.num_full_sync_success")
            self.store.kvstore_sync_events_queue.push(
                KvStoreSyncEvent(peer_name, self.area)
            )
        self._parallel_sync_limit = min(
            2 * self._parallel_sync_limit, PARALLEL_SYNC_LIMIT_MAX
        )
        # deliver keys flooded while the peer was syncing (see
        # KvStorePeer.pending_flood_keys)
        if peer.pending_flood_keys:
            pending, peer.pending_flood_keys = peer.pending_flood_keys, set()
            self._flood_keys_to_peer(
                peer, pending, counter="kvstore.thrift.num_flood_pub"
            )
        if self.get_peers_by_state(KvStorePeerState.IDLE):
            self._schedule_sync(0.0)

    def _flood_keys_to_peer(
        self, peer: KvStorePeer, keys: Iterable[str], counter: str
    ) -> None:
        """Send the current values of `keys` directly to one peer (used by
        finalize_full_sync and the pending-flood flush)."""
        updates = Publication(area=self.area)
        for key in keys:
            val = self.kv.get(key)
            if val is not None:
                updates.key_vals[key] = _copy_value(val)
        self.update_publication_ttl(updates)
        if not updates.key_vals:
            return
        self._bump(counter)
        self.store._spawn(
            self._flood_to_peer(
                peer,
                KeySetParams(
                    key_vals=updates.key_vals,
                    node_ids=[self.store.node_id],
                    timestamp_ms=int(time.time() * 1000),
                ),
            )
        )

    def process_sync_failure(self, peer_name: str) -> None:
        """Reference: processThriftFailure (KvStore.cpp:1612-1650)."""
        peer = self.peers.get(peer_name)
        if peer is None:
            return
        self._bump("kvstore.full_sync_retries")
        peer.backoff.report_error()
        peer.spec.state = get_next_state(
            peer.spec.state, KvStorePeerEvent.THRIFT_API_ERROR
        )
        if self._sync_timer is None:
            self._schedule_sync(0.0)

    def finalize_full_sync(self, keys: list[str], sender_id: str) -> None:
        """Reference: finalizeFullSync — send back values the peer needs."""
        peer = self.peers.get(sender_id)
        if peer is None or peer.spec.state == KvStorePeerState.IDLE:
            return
        self._flood_keys_to_peer(
            peer, keys, counter="kvstore.thrift.num_finalized_sync"
        )

    # -- TTL ------------------------------------------------------------------

    def update_ttl_countdown_queue(self, pub: Publication) -> None:
        """Reference: updateTtlCountdownQueue."""
        now = time.monotonic()
        for key, value in pub.key_vals.items():
            if value.ttl_ms == TTL_INFINITY:
                continue
            entry = TtlCountdownEntry(
                expiry_time=now + value.ttl_ms / 1000.0,
                key=key,
                version=value.version,
                ttl_version=value.ttl_version,
                originator_id=value.originator_id,
            )
            if not self._ttl_heap or entry.expiry_time <= self._ttl_heap[0].expiry_time:
                self._schedule_ttl_cleanup(value.ttl_ms / 1000.0)
            heapq.heappush(self._ttl_heap, entry)

    def _schedule_ttl_cleanup(self, delay_s: float) -> None:
        if self._ttl_timer is not None:
            self._ttl_timer.cancel()
        tr = _trace.TRACE
        if tr is not None and tr.scope():
            # the countdown is the store's, not the publication's that
            # re-armed it: an expiry roots its own trace at the flood
            # chokepoint (F7: the reference's timer carries the arming
            # publication's scope into the expiry)
            with tr.activate(()):
                self._ttl_timer = self.store.schedule_timeout(
                    max(0.0, delay_s), self.cleanup_ttl_countdown_queue
                )
            return
        self._ttl_timer = self.store.schedule_timeout(
            max(0.0, delay_s), self.cleanup_ttl_countdown_queue
        )

    def cleanup_ttl_countdown_queue(self) -> None:
        """Reference: cleanupTtlCountdownQueue."""
        self._ttl_timer = None
        expired: list[str] = []
        now = time.monotonic()
        while self._ttl_heap and self._ttl_heap[0].expiry_time <= now:
            top = heapq.heappop(self._ttl_heap)
            val = self.kv.get(top.key)
            if (
                val is not None
                and val.version == top.version
                and val.originator_id == top.originator_id
                and val.ttl_version == top.ttl_version
            ):
                expired.append(top.key)
                del self.kv[top.key]
        if self._ttl_heap:
            self._schedule_ttl_cleanup(self._ttl_heap[0].expiry_time - now)
        if not expired:
            return
        self._bump("kvstore.expired_key_vals", len(expired))
        # expired keys are published to local subscribers only
        self.flood_publication(
            Publication(expired_keys=expired, area=self.area)
        )

    def update_publication_ttl(
        self, pub: Publication, remove_about_to_expire: bool = False
    ) -> None:
        """Set remaining TTL minus the decrement on outgoing values
        (reference: updatePublicationTtl)."""
        now = time.monotonic()
        by_key: dict[tuple, TtlCountdownEntry] = {}
        for entry in self._ttl_heap:
            by_key[
                (entry.key, entry.version, entry.originator_id, entry.ttl_version)
            ] = entry
        for key in list(pub.key_vals):
            val = pub.key_vals[key]
            entry = by_key.get((key, val.version, val.originator_id, val.ttl_version))
            if entry is None:
                continue
            time_left_ms = (entry.expiry_time - now) * 1000.0
            if time_left_ms <= self.store.ttl_decr_ms:
                del pub.key_vals[key]
                continue
            if remove_about_to_expire and time_left_ms < TTL_THRESHOLD_S * 1000.0:
                del pub.key_vals[key]
                continue
            val.ttl_ms = int(time_left_ms - self.store.ttl_decr_ms)


def _copy_value(val: Value) -> Value:
    return Value(
        version=val.version,
        originator_id=val.originator_id,
        value=val.value,
        ttl_ms=val.ttl_ms,
        ttl_version=val.ttl_version,
        hash=val.hash,
    )


# ---------------------------------------------------------------------------
# KvStore event base
# ---------------------------------------------------------------------------


class KvStore(OpenrEventBase):
    """Multi-area KvStore module (reference: KvStore, KvStore.h:541)."""

    def __init__(
        self,
        node_id: str,
        kvstore_updates_queue: ReplicateQueue[Publication],
        kvstore_sync_events_queue: ReplicateQueue[KvStoreSyncEvent],
        peer_updates_queue: Optional[RQueue[PeerEvent]] = None,
        *,
        transport: Optional[Any] = None,
        areas: Iterable[str] = ("0",),
        filters: Optional[KvStoreFilters] = None,
        flood_rate: Optional[tuple[float, float]] = None,  # (msgs/s, burst)
        ttl_decr_ms: int = 1,
        enable_flood_optimization: bool = False,
        is_flood_root: bool = True,
    ) -> None:
        super().__init__(name=f"kvstore-{node_id}")
        self.node_id = node_id
        self.kvstore_updates_queue = kvstore_updates_queue
        self.kvstore_sync_events_queue = kvstore_sync_events_queue
        self._peer_updates_queue = peer_updates_queue
        self.transport = transport
        self.filters = filters
        self.flood_rate = flood_rate
        self.ttl_decr_ms = ttl_decr_ms
        # DUAL flood-topology knobs (reference: enable_flood_optimization /
        # is_flood_root in KvStoreConfig, OpenrConfig.thrift:25)
        self.enable_flood_optimization = enable_flood_optimization
        self.is_flood_root = is_flood_root
        self._dbs: dict[str, KvStoreDb] = {
            area: KvStoreDb(self, area) for area in areas
        }

    def _db(self, area: str) -> KvStoreDb:
        db = self._dbs.get(area)
        if db is None:
            raise KeyError(f"unknown area {area!r}")
        return db

    @property
    def areas(self) -> list[str]:
        return list(self._dbs)

    def _spawn(self, coro) -> None:
        """Launch a transport coroutine from evb-thread context."""
        self._track(self._loop.create_task(coro))

    def run(self) -> None:
        super().run()
        self.wait_until_running()
        if self._peer_updates_queue is not None:
            self.run_in_event_base_thread(
                lambda: self.add_fiber_task(
                    self._peer_updates_fiber(), name="peerUpdates"
                )
            ).result()

    async def _peer_updates_fiber(self) -> None:
        while True:
            try:
                event = await self._peer_updates_queue.aget()
            except QueueClosedError:
                return
            db = self._dbs.get(event.area)
            if db is None:
                continue
            if event.peers_to_add:
                db.add_peers(event.peers_to_add)
            if event.peers_to_del:
                db.del_peers(event.peers_to_del)

    # -- thread-safe public API (reference: KvStore.h:541-683) ---------------

    def _call(self, fn):
        return self.run_in_event_base_thread(fn).result()

    def get_key_vals(self, area: str, keys: Iterable[str]) -> Publication:
        return self._call(lambda: self._db(area).get_key_vals(keys))

    def set_key_vals(
        self,
        area: str,
        key_vals: dict[str, Value],
        node_ids: Optional[list[str]] = None,
        flood_root_id: Optional[str] = None,
    ) -> None:
        params = KeySetParams(
            key_vals=key_vals, node_ids=node_ids, flood_root_id=flood_root_id
        )
        self._call(lambda: self._db(area).set_key_vals(params))

    def dump_all(
        self,
        area: str,
        key_prefixes: Iterable[str] = (),
        originator_ids: Iterable[str] = (),
        match_all: bool = False,
        do_not_publish_value: bool = False,
    ) -> Publication:
        filters = KvStoreFilters(key_prefixes, originator_ids)
        return self._call(
            lambda: self._db(area).dump_all_with_filters(
                filters, match_all, do_not_publish_value
            )
        )

    def dump_hashes(
        self,
        area: str,
        key_prefixes: Iterable[str] = (),
        originator_ids: Iterable[str] = (),
    ) -> Publication:
        filters = KvStoreFilters(key_prefixes, originator_ids)
        return self._call(lambda: self._db(area).dump_hash_with_filters(filters))

    def process_full_dump(self, area: str, params: KeyDumpParams) -> Publication:
        """Serve a peer/ctrl full-dump request (incl. 3-way diff + TTL
        adjustment) — the same path the in-process transport uses."""
        return self._call(
            lambda: self._db(area).process_full_dump_request(params)
        )

    def add_peers(self, area: str, peers: dict[str, PeerSpec]) -> None:
        self._call(lambda: self._db(area).add_peers(peers))

    def del_peers(self, area: str, peers: list[str]) -> None:
        self._call(lambda: self._db(area).del_peers(peers))

    def dump_peers(self, area: str) -> dict[str, PeerSpec]:
        return self._call(lambda: self._db(area).dump_peers())

    def get_peer_state(
        self, area: str, peer_name: str
    ) -> Optional[KvStorePeerState]:
        return self._call(lambda: self._db(area).get_peer_state(peer_name))

    # -- DUAL flood-topology API (reference: KvStore.h:268-272) --------------

    def process_dual_messages(self, area: str, msgs) -> None:
        self._call(lambda: self._db(area).process_dual_messages(msgs))

    def process_flood_topo_set(self, area: str, params) -> None:
        self._call(lambda: self._db(area).process_flood_topo_set(params))

    def get_flood_topo(self, area: str):
        return self._call(lambda: self._db(area).process_flood_topo_get())

    def get_counters(self) -> dict[str, int]:
        def _sum() -> dict[str, int]:
            out: dict[str, int] = {}
            for db in self._dbs.values():
                for k, v in db.counters.items():
                    out[k] = out.get(k, 0) + v
                out[f"kvstore.num_keys.{db.area}"] = len(db.kv)
            return out

        return self._call(_sum)
