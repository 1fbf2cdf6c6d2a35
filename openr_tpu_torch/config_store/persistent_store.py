"""PersistentStore: disk-backed KV (TLV append log + periodic full rewrite).

Port of `openr_tpu.config_store.persistent_store` (reference:
PersistentStore, openr/config-store/PersistentStore.{h,cpp}), byte for
byte the same file format, so either package reads a store that the
other wrote: a TLV file starting with
'TlvFormatMarker', holding encoded PersistentObjects (ADD key/data, DEL
key).  Mutations append to the log; a debounced/backed-off timer rewrites
the full database periodically to bound file growth.  Used by LinkMonitor
(drain state) and PrefixAllocator (allocated prefix index).

File format (little-endian):
    b"TlvFormatMarker"
    repeated records: [type u8][key_len u32][key][has_data u8][data_len u32][data]
"""

from __future__ import annotations

import enum
import logging
import os
import struct
import threading
from dataclasses import dataclass
from typing import Optional

log = logging.getLogger(__name__)

TLV_MARKER = b"TlvFormatMarker"
# reference: Constants::kPersistentStoreInitialBackoff / kMaxBackoff
SAVE_INITIAL_BACKOFF_S = 0.1
SAVE_MAX_BACKOFF_S = 10.0


class ActionType(enum.IntEnum):
    ADD = 1
    DEL = 2


@dataclass(slots=True)
class PersistentObject:
    type: ActionType
    key: str
    data: Optional[bytes] = None


def encode_persistent_object(obj: PersistentObject) -> bytes:
    key = obj.key.encode()
    out = struct.pack("<BI", int(obj.type), len(key)) + key
    if obj.data is not None:
        out += struct.pack("<BI", 1, len(obj.data)) + obj.data
    else:
        out += struct.pack("<BI", 0, 0)
    return out


def decode_persistent_objects(
    buf: bytes, tolerate_truncation: bool = False
) -> list[PersistentObject]:
    """Decode records; with tolerate_truncation a torn final append yields
    the clean prefix instead of raising."""
    objs: list[PersistentObject] = []
    off = 0
    n = len(buf)
    while off < n:
        try:
            if off + 5 > n:
                raise ValueError("truncated record header")
            typ, key_len = struct.unpack_from("<BI", buf, off)
            noff = off + 5
            if noff + key_len + 5 > n:
                raise ValueError("truncated key")
            key = buf[noff : noff + key_len].decode()
            noff += key_len
            has_data, data_len = struct.unpack_from("<BI", buf, noff)
            noff += 5
            data = None
            if has_data:
                if noff + data_len > n:
                    raise ValueError("truncated data")
                data = buf[noff : noff + data_len]
                noff += data_len
            objs.append(PersistentObject(ActionType(typ), key, data))
            off = noff
        except ValueError:
            if tolerate_truncation:
                return objs
            raise
    return objs


class PersistentStore:
    """Thread-safe; no event loop needed (callers are module threads, I/O
    is tiny and synchronous — the reference's async API exists because of
    folly, not semantics)."""

    def __init__(
        self,
        storage_file_path: str,
        dryrun: bool = False,
        periodic_save_s: Optional[float] = None,
    ) -> None:
        self.path = storage_file_path
        self.dryrun = dryrun
        self._lock = threading.RLock()
        self._db: dict[str, bytes] = {}
        self.num_writes_to_disk = 0
        self._load_from_disk()
        self._periodic_save_s = periodic_save_s
        self._timer: Optional[threading.Timer] = None
        if periodic_save_s:
            self._schedule_periodic_save()

    # -- public API (reference: store/load/erase) ----------------------------

    def store(self, key: str, value: bytes) -> None:
        with self._lock:
            self._db[key] = bytes(value)
            self._append(PersistentObject(ActionType.ADD, key, bytes(value)))

    def load(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._db.get(key)

    def erase(self, key: str) -> bool:
        with self._lock:
            existed = self._db.pop(key, None) is not None
            if existed:
                self._append(PersistentObject(ActionType.DEL, key))
            return existed

    def keys(self) -> list[str]:
        with self._lock:
            return sorted(self._db)

    def close(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        self.save_database_to_disk()

    # -- disk I/O ------------------------------------------------------------

    def _append(self, obj: PersistentObject) -> None:
        if self.dryrun:
            return
        try:
            with open(self.path, "ab") as f:
                if f.tell() == 0:
                    f.write(TLV_MARKER)
                f.write(encode_persistent_object(obj))
            # guarded by the caller: set()/erase() enter _append inside
            # `with self._lock` (RLock), so this increment never runs bare
            self.num_writes_to_disk += 1  # openr: disable=guarded-by
        except OSError:
            # _db already holds the mutation; the next full rewrite
            # reconciles the file
            log.exception("config-store: append failed")

    def save_database_to_disk(self) -> bool:
        """Full rewrite (reference: saveDatabaseToDisk)."""
        if self.dryrun:
            return True
        with self._lock:
            blob = TLV_MARKER + b"".join(
                encode_persistent_object(
                    PersistentObject(ActionType.ADD, key, data)
                )
                for key, data in sorted(self._db.items())
            )
            try:
                tmp = f"{self.path}.tmp.{os.getpid()}"
                with open(tmp, "wb") as f:
                    f.write(blob)
                os.replace(tmp, self.path)
                self.num_writes_to_disk += 1
                return True
            except OSError:
                log.exception("config-store: full rewrite failed")
                return False

    def _load_from_disk(self) -> None:
        try:
            with open(self.path, "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            return
        except OSError:
            log.exception("config-store: read failed")
            return
        if not blob.startswith(TLV_MARKER):
            log.error("config-store: bad marker in %s; ignoring file", self.path)
            return
        objs = decode_persistent_objects(
            blob[len(TLV_MARKER) :], tolerate_truncation=True
        )
        for obj in objs:
            if obj.type == ActionType.ADD:
                self._db[obj.key] = obj.data or b""
            else:
                self._db.pop(obj.key, None)

    def _schedule_periodic_save(self) -> None:
        def _tick() -> None:
            self.save_database_to_disk()
            with self._lock:
                if self._timer is not None:
                    self._schedule_periodic_save()

        self._timer = threading.Timer(self._periodic_save_s, _tick)
        self._timer.daemon = True
        self._timer.start()
