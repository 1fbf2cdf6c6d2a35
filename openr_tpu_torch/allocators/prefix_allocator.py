"""PrefixAllocator: distributed unique-subprefix election.

Port of `openr_tpu.allocators.prefix_allocator` (reference:
PrefixAllocator, openr/allocators/PrefixAllocator.h:35; doc
openr/docs/Protocol_Guide/PrefixAllocator.md): given a seed prefix P/N and
an allocation length M, elect a unique index i in [0, 2^(M-N)) via
RangeAllocator, map it to the i-th M-length subprefix of P, advertise it
through PrefixManager (PREFIX_ALLOCATOR type), and persist the allocated
index in the config store so restarts re-propose the same value.

With `assign_to_interface`, the elected prefix's first host address is
programmed onto that interface through the port's rtnetlink socket
(`nl.NetlinkProtocolSocket.add_addr`, CAP_NET_ADMIN), and every other
address of the interface inside the seed prefix is removed.  As in the
reference, a failed sync is logged and the allocation stands; the next
allocation change reconciles again.
"""

from __future__ import annotations

import ipaddress
import logging
from typing import Optional

from ..config_store import PersistentStore
from ..kvstore import KvStoreClientInternal
from ..runtime.eventbase import OpenrEventBase
from ..types import PrefixEntry, PrefixType, PrefixUpdateRequest
from ..runtime.queue import ReplicateQueue
from .range_allocator import RangeAllocator

log = logging.getLogger(__name__)

ALLOC_PREFIX_MARKER = "allocprefix:"  # reference: Constants::kPrefixAllocMarker
CONFIG_KEY = "prefix-allocator-config"  # persisted index


class PrefixAllocator:
    def __init__(
        self,
        evb: OpenrEventBase,
        node_name: str,
        client: KvStoreClientInternal,
        seed_prefix: str,
        alloc_prefix_len: int,
        *,
        area: str = "0",
        prefix_updates_queue: Optional[ReplicateQueue[PrefixUpdateRequest]] = None,
        config_store: Optional[PersistentStore] = None,
        assign_to_interface: str = "",
    ) -> None:
        self.evb = evb
        self.node_name = node_name
        self.client = client
        self.seed = ipaddress.ip_network(seed_prefix)
        self.alloc_len = alloc_prefix_len
        assert alloc_prefix_len > self.seed.prefixlen, "alloc len must be longer"
        n_prefixes = 1 << (alloc_prefix_len - self.seed.prefixlen)
        self._prefix_updates_queue = prefix_updates_queue
        self.config_store = config_store
        self.assign_to_interface = assign_to_interface
        self._nl = None  # cached NetlinkProtocolSocket (lazy)
        import threading

        self._addr_sync_lock = threading.Lock()
        # latest-wins mailbox for the single sync worker (see
        # _sync_iface_addr); a 1-tuple so pending None is distinguishable
        self._addr_pending: Optional[tuple] = None
        self._addr_worker_busy = False
        self._addr_stopped = False
        self.my_prefix: Optional[str] = None
        self.range_allocator = RangeAllocator(
            evb,
            client,
            area,
            ALLOC_PREFIX_MARKER,
            node_name,
            self._on_allocated,
            (0, n_prefixes - 1),
        )

    def start(self) -> None:
        init = None
        if self.config_store is not None:
            raw = self.config_store.load(CONFIG_KEY)
            if raw is not None:
                try:
                    init = int(raw.decode())
                except ValueError:
                    init = None
        self.range_allocator.start_allocation(init)

    def _index_to_prefix(self, index: int) -> str:
        # i-th subprefix computed arithmetically (2^k subnets never
        # materialized)
        shift = self.seed.network_address.max_prefixlen - self.alloc_len
        base = int(self.seed.network_address) + (index << shift)
        return str(ipaddress.ip_network((base, self.alloc_len)))

    def _sync_iface_addr(self, prefix: Optional[str]) -> None:
        """Program the elected prefix's first host address onto the
        configured interface, removing every OTHER address within the
        seed prefix (reference: PrefixAllocator syncIfaceAddrs — assigns
        the allocation to the loopback and reconciles stale addresses a
        previous process instance may have left behind).  Runs the
        blocking netlink I/O on a worker thread: the allocator's
        callbacks fire on the LinkMonitor event base, which must not
        stall on kernel round-trips.  Best-effort: needs CAP_NET_ADMIN;
        failures are logged, the allocation itself is unaffected."""
        if not self.assign_to_interface:
            return
        new_addr = None
        if prefix is not None:
            net = ipaddress.ip_network(prefix)
            # first host address — except at maximum length, where +1
            # would land in the NEXT node's allocation (reference adds
            # +1 only below full length)
            host = (
                net.network_address
                if net.prefixlen == net.network_address.max_prefixlen
                else net.network_address + 1
            )
            new_addr = f"{host}/{net.prefixlen}"
        import threading

        with self._addr_sync_lock:
            if self._addr_stopped:
                return
            # latest wins: a superseded request must never be applied
            # AFTER its successor (thread-per-call could reorder)
            self._addr_pending = (new_addr,)
            if self._addr_worker_busy:
                return  # the running worker drains the mailbox
            self._addr_worker_busy = True
        threading.Thread(
            target=self._addr_sync_worker,
            name="prefix-alloc-addr-sync",
            daemon=True,
        ).start()

    def _addr_sync_worker(self) -> None:
        """Single drainer: applies the LATEST pending address; the
        netlink socket is touched only here and released on exit when
        stop() raced us."""
        while True:
            with self._addr_sync_lock:
                if self._addr_pending is None or self._addr_stopped:
                    self._addr_worker_busy = False
                    if self._addr_stopped and self._nl is not None:
                        self._nl.close_request_socket()
                        self._nl = None
                    return
                (new_addr,) = self._addr_pending
                self._addr_pending = None
            try:
                self._apply_iface_addr(new_addr)
            except Exception:
                # the worker must survive ANY failure: dying here would
                # strand _addr_worker_busy=True and wedge every future
                # sync (and stop() would never reclaim the socket)
                log.exception("prefix-allocator: address sync failed")

    def _apply_iface_addr(self, new_addr: Optional[str]) -> None:
        # no same-value short-circuit: every sync reconciles against the
        # KERNEL's actual state, so a flapped interface (link down/up
        # flushes addresses) or operator deletion self-heals on the next
        # allocator callback
        try:
            if self._nl is None:
                from ..nl.netlink import NetlinkProtocolSocket

                # one cached socket: per-sync construction would leak
                # the persistent request fd to GC under churn.  Bare write
                # is single-drainer-confined: _apply_iface_addr runs only
                # on the one live worker (the _addr_worker_busy handshake
                # under _addr_sync_lock serializes successive workers, and
                # stop()'s locked reclaim at the loop head sees the update
                # through that same lock).
                self._nl = NetlinkProtocolSocket()  # openr: disable=guarded-by
            nl = self._nl
            if_index = {
                l.if_name: l.if_index for l in nl.get_all_links()
            }.get(self.assign_to_interface)
            if if_index is None:
                log.warning(
                    "prefix-allocator: interface %s not found; "
                    "skipping address assignment",
                    self.assign_to_interface,
                )
                return
            # reconcile: every address on the interface inside the SEED
            # prefix that is not the current allocation goes — incl.
            # leftovers from a previous process instance
            for addr in nl.get_all_addresses():
                if addr.if_index != if_index:
                    continue
                try:
                    ip = ipaddress.ip_interface(addr.prefix).ip
                except ValueError:
                    continue
                if ip in self.seed and addr.prefix != new_addr:
                    try:
                        nl.del_addr(if_index, addr.prefix)
                    except OSError:
                        pass  # already gone
            if new_addr is not None:
                nl.add_addr(if_index, new_addr)
        except OSError as exc:
            log.warning(
                "prefix-allocator: address sync on %s failed: %s",
                self.assign_to_interface,
                exc,
            )

    def _on_allocated(self, index: Optional[int]) -> None:
        if index is None:
            # lost allocation: withdraw
            if self.my_prefix is not None and self._prefix_updates_queue is not None:
                self._prefix_updates_queue.push(
                    PrefixUpdateRequest(
                        prefixes_to_del=[self.my_prefix],
                        type=PrefixType.PREFIX_ALLOCATOR,
                    )
                )
            self.my_prefix = None
            self._sync_iface_addr(None)
            return
        self.my_prefix = self._index_to_prefix(index)
        log.info(
            "prefix-allocator %s: allocated index %d -> %s",
            self.node_name,
            index,
            self.my_prefix,
        )
        if self.config_store is not None:
            self.config_store.store(CONFIG_KEY, str(index).encode())
        self._sync_iface_addr(self.my_prefix)
        if self._prefix_updates_queue is not None:
            self._prefix_updates_queue.push(
                PrefixUpdateRequest(
                    prefixes_to_add=[
                        PrefixEntry(
                            prefix=self.my_prefix,
                            type=PrefixType.PREFIX_ALLOCATOR,
                        )
                    ],
                    type=PrefixType.PREFIX_ALLOCATOR,
                )
            )

    def get_my_prefix(self) -> Optional[str]:
        return self.my_prefix

    def stop(self) -> None:
        self.range_allocator.stop()
        with self._addr_sync_lock:
            self._addr_stopped = True
            self._addr_pending = None
            # a busy worker owns the socket and closes it on exit; only
            # reclaim it here when no worker is running
            if not self._addr_worker_busy and self._nl is not None:
                self._nl.close_request_socket()
                self._nl = None
