"""KvStoreClientInternal: in-process client with key persistence.

Port of `openr_tpu.kvstore.client` (reference: KvStoreClientInternal,
openr/kvstore/KvStoreClientInternal.h:75-220):

- `persist_key`: advertise a key and keep re-advertising it — if another
  originator overwrites it (or the value differs), re-advertise with a
  bumped version so this node stays the owner;
- TTL refresh: for finite-TTL persisted keys, periodically bump ttlVersion
  so the key never expires while we own it;
- `check_persisted_keys`: periodic scan verifying persisted keys are still
  in the store (re-advertise if lost — e.g. store restarted);
- key subscriptions with exact-key and regex filters.

Runs on a caller-provided OpenrEventBase (the owning module's thread), and
watches the KvStore publications queue for overwrites.
"""

from __future__ import annotations

import re
from typing import Callable, Optional

from ..runtime.eventbase import OpenrEventBase
from ..runtime.queue import QueueClosedError, RQueue
from ..types import Publication, TTL_INFINITY, Value
from .kvstore import KvStore

# reference: Constants::kPersistKeyTimer
CHECK_PERSIST_INTERVAL_S = 60.0

KeyCallback = Callable[[str, Optional[Value]], None]


class KvStoreClientInternal:
    def __init__(
        self,
        evb: OpenrEventBase,
        node_id: str,
        kvstore: KvStore,
        kvstore_updates: Optional[RQueue[Publication]] = None,
        check_persist_interval_s: float = CHECK_PERSIST_INTERVAL_S,
    ) -> None:
        self.evb = evb
        self.node_id = node_id
        self.kvstore = kvstore
        # area -> key -> value we insist on
        self._persisted: dict[str, dict[str, Value]] = {}
        # (area, key) -> callback
        self._key_callbacks: dict[tuple[str, str], KeyCallback] = {}
        self._filter_callbacks: list[tuple[re.Pattern, KeyCallback]] = []
        self._ttl_timers: dict[tuple[str, str], object] = {}
        self._check_interval = check_persist_interval_s
        self._check_timer = None
        if kvstore_updates is not None:
            evb.run_in_event_base_thread(
                lambda: evb.add_fiber_task(
                    self._updates_fiber(kvstore_updates), name="kvClientUpdates"
                )
            ).result()
        self._schedule_check()

    def stop(self) -> None:
        for timer in self._ttl_timers.values():
            timer.cancel()
        self._ttl_timers.clear()
        if self._check_timer is not None:
            self._check_timer.cancel()
            self._check_timer = None

    # -- write API ------------------------------------------------------------

    def persist_key(
        self, area: str, key: str, value: bytes, ttl_ms: int = TTL_INFINITY
    ) -> None:
        """Reference: persistKey (KvStoreClientInternal.h:75)."""
        existing = self.kvstore.get_key_vals(area, [key]).key_vals.get(key)
        version = 1
        if existing is not None:
            if existing.originator_id == self.node_id and existing.value == value:
                version = existing.version  # already ours and identical
            else:
                version = existing.version + 1
        val = Value(
            version=version,
            originator_id=self.node_id,
            value=value,
            ttl_ms=ttl_ms,
            ttl_version=0,
        )
        self._persisted.setdefault(area, {})[key] = val
        self.kvstore.set_key_vals(area, {key: _fresh(val)})
        self._schedule_ttl_refresh(area, key)

    def set_key(
        self,
        area: str,
        key: str,
        value: bytes,
        version: Optional[int] = None,
        ttl_ms: int = TTL_INFINITY,
    ) -> Value:
        """One-shot advertise (reference: setKey,
        KvStoreClientInternal.h:90)."""
        if version is None:
            existing = self.kvstore.get_key_vals(area, [key]).key_vals.get(key)
            version = (existing.version + 1) if existing is not None else 1
        val = Value(
            version=version,
            originator_id=self.node_id,
            value=value,
            ttl_ms=ttl_ms,
        )
        self.kvstore.set_key_vals(area, {key: _fresh(val)})
        return val

    def unset_key(self, area: str, key: str) -> None:
        """Stop persisting; the key stays in the store until TTL expiry
        (reference: unsetKey, KvStoreClientInternal.h:103)."""
        self._persisted.get(area, {}).pop(key, None)
        timer = self._ttl_timers.pop((area, key), None)
        if timer is not None:
            timer.cancel()

    def clear_key(
        self, area: str, key: str, new_value: bytes, ttl_ms: int
    ) -> None:
        """Overwrite with a short-TTL tombstone value (reference: clearKey)."""
        self.unset_key(area, key)
        existing = self.kvstore.get_key_vals(area, [key]).key_vals.get(key)
        if existing is None:
            return
        self.kvstore.set_key_vals(
            area,
            {
                key: Value(
                    version=existing.version + 1,
                    originator_id=self.node_id,
                    value=new_value,
                    ttl_ms=ttl_ms,
                )
            },
        )

    # -- read / subscribe API --------------------------------------------------

    def get_key(self, area: str, key: str) -> Optional[Value]:
        return self.kvstore.get_key_vals(area, [key]).key_vals.get(key)

    def dump_all_with_prefix(self, area: str, prefix: str = "") -> dict[str, Value]:
        return self.kvstore.dump_all(area, key_prefixes=[prefix] if prefix else []).key_vals

    def subscribe_key(
        self, area: str, key: str, callback: KeyCallback
    ) -> Optional[Value]:
        """Reference: subscribeKey (KvStoreClientInternal.h:134).  Returns
        current value if any."""
        self._key_callbacks[(area, key)] = callback
        return self.get_key(area, key)

    def unsubscribe_key(self, area: str, key: str) -> None:
        self._key_callbacks.pop((area, key), None)

    def subscribe_key_filter(self, regex: str, callback: KeyCallback) -> None:
        self._filter_callbacks.append((re.compile(regex), callback))

    def unsubscribe_key_filter(self) -> None:
        self._filter_callbacks.clear()

    # -- internals -------------------------------------------------------------

    async def _updates_fiber(self, reader: RQueue[Publication]) -> None:
        while True:
            try:
                pub = await reader.aget()
            except QueueClosedError:
                return
            self._process_publication(pub)

    def _process_publication(self, pub: Publication) -> None:
        persisted = self._persisted.get(pub.area, {})
        for key, value in pub.key_vals.items():
            # subscriptions
            cb = self._key_callbacks.get((pub.area, key))
            if cb is not None:
                cb(key, value)
            for pattern, fcb in self._filter_callbacks:
                if pattern.search(key):
                    fcb(key, value)
            # ownership enforcement (reference: processPublicationForKey)
            mine = persisted.get(key)
            if mine is None or value.value is None:
                continue
            if value.originator_id != self.node_id or value.value != mine.value:
                mine.version = value.version + 1
                mine.ttl_version = 0
                self.kvstore.set_key_vals(pub.area, {key: _fresh(mine)})
        for key in pub.expired_keys:
            cb = self._key_callbacks.get((pub.area, key))
            if cb is not None:
                cb(key, None)
            mine = persisted.get(key)
            if mine is not None:
                # our key expired (e.g. store restarted): re-advertise
                self.kvstore.set_key_vals(pub.area, {key: _fresh(mine)})

    def _schedule_ttl_refresh(self, area: str, key: str) -> None:
        """Bump ttlVersion at ttl/4 cadence (reference: ttl refresh in
        advertisePendingKeys / scheduleTtlUpdates)."""
        val = self._persisted.get(area, {}).get(key)
        if val is None or val.ttl_ms == TTL_INFINITY:
            return
        existing = self._ttl_timers.pop((area, key), None)
        if existing is not None:
            existing.cancel()

        def _refresh() -> None:
            mine = self._persisted.get(area, {}).get(key)
            if mine is None:
                return
            mine.ttl_version += 1
            # TTL-refresh advertisement: version-only (value=None)
            self.kvstore.set_key_vals(
                area,
                {
                    key: Value(
                        version=mine.version,
                        originator_id=self.node_id,
                        value=None,
                        ttl_ms=mine.ttl_ms,
                        ttl_version=mine.ttl_version,
                    )
                },
            )
            self._schedule_ttl_refresh(area, key)

        self._ttl_timers[(area, key)] = self.evb.schedule_timeout(
            val.ttl_ms / 4000.0, _refresh
        )

    def _schedule_check(self) -> None:
        self._check_timer = self.evb.schedule_timeout(
            self._check_interval, self._check_persisted_keys
        )

    def _check_persisted_keys(self) -> None:
        """Reference: checkPersistKeyInStore (KvStoreClientInternal.h:220)."""
        for area, keys in self._persisted.items():
            missing = {
                key: _fresh(val)
                for key, val in keys.items()
                if self.kvstore.get_key_vals(area, [key]).key_vals.get(key) is None
            }
            if missing:
                self.kvstore.set_key_vals(area, missing)
        self._schedule_check()


def _fresh(val: Value) -> Value:
    return Value(
        version=val.version,
        originator_id=val.originator_id,
        value=val.value,
        ttl_ms=val.ttl_ms,
        ttl_version=val.ttl_version,
    )
