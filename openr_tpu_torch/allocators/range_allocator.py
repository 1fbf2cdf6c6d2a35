"""RangeAllocator: distributed unique-integer election via KvStore.

Port of `openr_tpu.allocators.range_allocator` (reference: RangeAllocator
openr/allocators/RangeAllocator.h:28; doc
openr/docs/Protocol_Guide/RangeAllocator.md): each node proposes a value
in [start, end] by writing the key `<keyPrefix><value>` with its own node
name as the value; the KvStore CRDT merge resolves collisions
deterministically (higher version, then originator, then value bytes).  A
node that loses its claim picks another value and retries.  Convergence:
eventually every node owns a distinct value.
"""

from __future__ import annotations

import hashlib
import logging
from typing import Callable, Optional

from ..kvstore import KvStoreClientInternal
from ..runtime.eventbase import OpenrEventBase

log = logging.getLogger(__name__)

# settle time before declaring victory (reference: kRangeAllocTtl backoff)
SETTLE_TIME_S = 0.2


class RangeAllocator:
    """Runs on the caller's event base (like the reference, which runs on
    the owning module's evb)."""

    def __init__(
        self,
        evb: OpenrEventBase,
        client: KvStoreClientInternal,
        area: str,
        key_prefix: str,
        node_name: str,
        callback: Callable[[Optional[int]], None],
        allocate_range: tuple[int, int],
        *,
        override_owner: bool = True,
        settle_time_s: float = SETTLE_TIME_S,
    ) -> None:
        self.evb = evb
        self.client = client
        self.area = area
        self.key_prefix = key_prefix
        self.node_name = node_name
        self.callback = callback
        self.start, self.end = allocate_range
        assert self.start <= self.end
        self.override_owner = override_owner
        self._settle_time_s = settle_time_s
        self.my_value: Optional[int] = None
        self._proposed: Optional[int] = None
        self._settle_timer = None
        self._stopped = False
        client.subscribe_key_filter(
            f"^{key_prefix}", self._on_key_update
        )

    def _key(self, value: int) -> str:
        return f"{self.key_prefix}{value}"

    # -- allocation ----------------------------------------------------------

    def start_allocation(self, init_value: Optional[int] = None) -> None:
        self.evb.run_in_event_base_thread(
            lambda: self._propose(init_value)
        ).result()

    def _initial_value(self) -> int:
        span = self.end - self.start + 1
        digest = int.from_bytes(
            hashlib.blake2b(self.node_name.encode(), digest_size=8).digest(),
            "big",
        )
        return self.start + digest % span

    def _propose(self, init_value: Optional[int] = None) -> None:
        if self._stopped:
            return
        value = init_value if init_value is not None else self._initial_value()
        value = max(self.start, min(self.end, value))
        # skip values already owned by a live competitor
        span = self.end - self.start + 1
        for _ in range(span):
            existing = self.client.get_key(self.area, self._key(value))
            if existing is None or existing.value in (
                None,
                self.node_name.encode(),
            ):
                break
            if self.override_owner and self.node_name.encode() > existing.value:
                break  # we'd win the CRDT tie-break; claim it
            value = self.start + (value - self.start + 1) % span
        self._proposed = value
        self.my_value = None
        log.debug("range-alloc %s: proposing %d", self.node_name, value)
        self.client.persist_key(
            self.area, self._key(value), self.node_name.encode()
        )
        self._arm_settle_timer()

    def _arm_settle_timer(self) -> None:
        if self._settle_timer is not None:
            self._settle_timer.cancel()
        self._settle_timer = self.evb.schedule_timeout(
            self._settle_time_s, self._check_victory
        )

    def _check_victory(self) -> None:
        self._settle_timer = None
        if self._stopped or self._proposed is None:
            return
        existing = self.client.get_key(self.area, self._key(self._proposed))
        if existing is not None and existing.value == self.node_name.encode():
            if self.my_value != self._proposed:
                self.my_value = self._proposed
                self.callback(self.my_value)
        else:
            self._lost(self._proposed)

    def _on_key_update(self, key: str, value) -> None:
        """Conflict detection: somebody else claimed our key."""
        if self._stopped or self._proposed is None:
            return
        if key != self._key(self._proposed):
            return
        if value is None or value.value is None:
            return
        if value.value != self.node_name.encode():
            # persist_key auto-reasserts ownership (version bump); but if
            # we do NOT override, concede and move on
            if not self.override_owner or value.value > self.node_name.encode():
                self._lost(self._proposed, concede=True)
            else:
                self._arm_settle_timer()

    def _lost(self, value: int, concede: bool = False) -> None:
        log.debug(
            "range-alloc %s: lost %d%s",
            self.node_name,
            value,
            " (conceding)" if concede else "",
        )
        self.client.unset_key(self.area, self._key(value))
        had_value = self.my_value is not None
        self.my_value = None
        if had_value:
            self.callback(None)
        span = self.end - self.start + 1
        next_value = self.start + (value - self.start + 1) % span
        self._propose(next_value)

    def stop(self) -> None:
        self._stopped = True
        if self._settle_timer is not None:
            self._settle_timer.cancel()
            self._settle_timer = None
