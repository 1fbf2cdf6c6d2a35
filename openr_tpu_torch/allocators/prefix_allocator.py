"""PrefixAllocator: distributed unique-subprefix election.

Port of `openr_tpu.allocators.prefix_allocator` (reference:
PrefixAllocator, openr/allocators/PrefixAllocator.h:35; doc
openr/docs/Protocol_Guide/PrefixAllocator.md): given a seed prefix P/N and
an allocation length M, elect a unique index i in [0, 2^(M-N)) via
RangeAllocator, map it to the i-th M-length subprefix of P, advertise it
through PrefixManager (PREFIX_ALLOCATOR type), and persist the allocated
index in the config store so restarts re-propose the same value.

Assigning the elected prefix to an interface (`assign_to_interface`)
needs the rtnetlink socket, which the port does not have yet (ROADMAP
queue 1 item 3): the allocator refuses it at construction.
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
        if assign_to_interface:
            raise ValueError(
                "prefix allocation assign_to_interface needs the rtnetlink "
                "socket, which the port does not have yet (ROADMAP queue 1 "
                "item 3)"
            )
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
