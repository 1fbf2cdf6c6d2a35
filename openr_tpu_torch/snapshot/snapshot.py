"""Engine snapshots: checkpoint a residency engine, warm-start another.

Port of `openr_tpu.snapshot.snapshot`.  A new replica pays the full cold
path (CSR build, device upload, the first forward runs) before it
answers a query.  `EngineSnapshot` moves that cost off the serving
path: it checkpoints a `DeviceResidencyEngine`'s resident graph arrays
(a host image, in a versioned serial format with an integrity digest),
the rewire-log position, the LinkState epoch, and a *manifest* of the
ladder keys the engine has run (`engine.cached_program_keys()`), which
`engine.prewarm` runs once each, discarded, on the restored resident.

The serial format is the reference's byte for byte: equal engine state
gives equal bytes, and each package reads the other's artifacts.

Restore rungs (`EngineSnapshot.restore`, in preference order):

- **replay**: the target is the donor mirror itself (same CsrTopology
  object, same ELL identity; a rebuild replaces the ELL object, so the
  identity pin cannot survive one).  The resident is installed at the
  snapshot's (epoch, rewire_seq) position and `engine.sync()` replays
  the rewire and attribute changes since through the engine's own
  rungs.  A rewire-log gap demotes inside sync(), counted as
  `device.engine.rewire_fallbacks` and `snapshot.replay_fallbacks`.
- **install**: a foreign mirror (a fresh replica) whose content equals
  the checkpoint: installed directly at the target's (version,
  rewire_seq).  Nothing to replay; equal by construction.
- **cold**: anything else (a stale snapshot against a drifted mirror, a
  structural mismatch): an accounted demotion (`snapshot.replay_fallbacks`)
  to the engine's ordinary restage on the device.

Every restore leaves `csr` resident and answering as a cold build of the
same LinkState would; a demotion trades only the warm-start saving.
A damaged artifact is an error (`SnapshotFormatError`), not a demotion.

The `snapshot.*` family is pre-seeded: the `SNAPSHOT_COUNTERS` singleton
is the ctrl handler's `snapshot` module, so a daemon answers the whole
family on getCounters before any snapshot is taken.  With tracing armed
(`obs.trace`), `take` and `restore` run under an `engine.snapshot` stage
(`op` = take / restore) of the active scope, the restore tagged with its
`snapshot.rung` and its prewarm under `engine.snapshot.prewarm`.
"""

from __future__ import annotations

import hashlib
import json
import struct
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..device.engine import RESIDENT_ARRAYS, ell_leaves
from ..obs import trace as _trace

# serialized-format version: any layout change bumps it; `from_bytes`
# refuses a mismatched artifact (SnapshotFormatError), it never guesses
SNAPSHOT_VERSION = 1
_MAGIC = b"OTPUSNAP"

SNAPSHOT_COUNTER_KEYS = (
    "snapshot.taken",
    "snapshot.take_us",
    "snapshot.bytes",
    "snapshot.restores",
    "snapshot.restore_us",
    "snapshot.replayed_events",
    "snapshot.replay_fallbacks",
    "snapshot.digest_failures",
    "snapshot.manifest_programs",
    "snapshot.prewarmed_programs",
    "snapshot.scaleouts",
    "snapshot.scaleins",
)


class SnapshotCounters:
    """Pre-seeded ``snapshot.*`` registry."""

    def __init__(self) -> None:
        self.counters: dict[str, int] = {k: 0 for k in SNAPSHOT_COUNTER_KEYS}

    def get_counters(self) -> dict[str, int]:
        return dict(self.counters)

    def _bump(self, name: str, delta: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + delta


SNAPSHOT_COUNTERS = SnapshotCounters()


class SnapshotFormatError(RuntimeError):
    """Corrupt or incompatible serialized snapshot (bad magic, format
    version skew, integrity-digest mismatch).  Not a restore demotion:
    a damaged artifact is an error, a stale but intact snapshot demotes
    to a cold build."""


@dataclass
class EngineSnapshot:
    """One residency checkpoint: host arrays, position and manifest.

    Built by `take` (live engine) or `from_bytes` (serialized artifact).
    The two lineage pins below are same-process facts and never
    serialized: a deserialized snapshot restores only through the
    content-equality or cold rungs."""

    epoch: int  # csr.version the checkpoint was taken at
    rewire_seq: int  # rewire-log position at the checkpoint
    topo_key: tuple  # (node_capacity, edge_capacity)
    node_names: tuple
    sweep_hint: int
    arrays: dict  # name -> host np.ndarray, RESIDENT_ARRAYS
    ell_leaves: list  # host np.ndarray leaves of the donor's ELL
    manifest: tuple  # ladder keys the engine ran for topo_key
    donor_csr_id: Optional[int] = None
    donor_ell_ref: object = None

    # -- checkpoint ---------------------------------------------------------

    @classmethod
    def take(cls, engine, csr) -> "EngineSnapshot":
        """Checkpoint `csr`'s residency on `engine` (synced first, so the
        snapshot is at the mirror's current version)."""
        t0 = time.perf_counter()
        tr = _trace.TRACE
        with _trace.maybe_child("engine.snapshot", op="take"):
            state = engine.export_resident(csr)
            topo_key = tuple(state["topo_key"])
            manifest = tuple(
                k for k in engine.cached_program_keys() if k[0] == topo_key
            )
            snap = cls(
                epoch=int(state["version"]),
                rewire_seq=int(state["rewire_seq"]),
                topo_key=topo_key,
                node_names=tuple(csr.node_names),
                sweep_hint=int(state["sweep_hint"]),
                arrays=state["arrays"],
                ell_leaves=state["ell_leaves"],
                manifest=manifest,
                donor_csr_id=id(csr),
                donor_ell_ref=csr.ell,
            )
            nbytes = snap.nbytes()
            SNAPSHOT_COUNTERS._bump("snapshot.taken")
            SNAPSHOT_COUNTERS._bump("snapshot.bytes", nbytes)
            SNAPSHOT_COUNTERS._bump("snapshot.manifest_programs", len(manifest))
            if tr is not None:
                tr.note("snapshot.bytes", nbytes)
                tr.note("snapshot.epoch", snap.epoch)
        SNAPSHOT_COUNTERS._bump(
            "snapshot.take_us", int((time.perf_counter() - t0) * 1e6)
        )
        return snap

    def nbytes(self) -> int:
        return sum(a.nbytes for a in self.arrays.values()) + sum(
            a.nbytes for a in self.ell_leaves
        )

    # -- serial format ------------------------------------------------------

    @staticmethod
    def _key_json(k: tuple) -> list:
        topo, s_bucket, n_words, n_sweeps, small, use_link_metric = k
        return [
            [int(x) for x in topo],
            int(s_bucket),
            int(n_words),
            int(n_sweeps),
            bool(small),
            bool(use_link_metric),
        ]

    @staticmethod
    def _key_from_json(k: list) -> tuple:
        return (
            tuple(int(x) for x in k[0]),
            int(k[1]),
            int(k[2]),
            int(k[3]),
            bool(k[4]),
            bool(k[5]),
        )

    def _tensor_list(self) -> tuple:
        """(metadata list, concatenated payload) in serial order."""
        metas: list = []
        chunks: list = []
        for name in RESIDENT_ARRAYS:
            a = np.ascontiguousarray(self.arrays[name])
            metas.append({"name": name, "dtype": str(a.dtype), "shape": list(a.shape)})
            chunks.append(a.tobytes())
        for a in self.ell_leaves:
            a = np.ascontiguousarray(np.asarray(a))
            metas.append({"name": "ell", "dtype": str(a.dtype), "shape": list(a.shape)})
            chunks.append(a.tobytes())
        return metas, b"".join(chunks)

    def to_bytes(self) -> bytes:
        """MAGIC + u32 header length + JSON header + raw array payload.
        The sha256 digest covers the digest-less header and the payload,
        so damage anywhere in the artifact is caught at load."""
        metas, payload = self._tensor_list()
        header = {
            "format": SNAPSHOT_VERSION,
            "epoch": int(self.epoch),
            "rewire_seq": int(self.rewire_seq),
            "topo_key": [int(x) for x in self.topo_key],
            "node_names": list(self.node_names),
            "sweep_hint": int(self.sweep_hint),
            "manifest": [self._key_json(k) for k in self.manifest],
            "tensors": metas,
        }
        digest = hashlib.sha256(
            json.dumps(header, sort_keys=True).encode() + payload
        ).hexdigest()
        header["digest"] = digest
        hdr = json.dumps(header, sort_keys=True).encode()
        return _MAGIC + struct.pack("<I", len(hdr)) + hdr + payload

    @classmethod
    def from_bytes(cls, blob: bytes) -> "EngineSnapshot":
        if blob[: len(_MAGIC)] != _MAGIC:
            raise SnapshotFormatError("bad snapshot magic")
        off = len(_MAGIC)
        if len(blob) < off + 4:
            raise SnapshotFormatError("truncated snapshot header")
        (hlen,) = struct.unpack_from("<I", blob, off)
        off += 4
        try:
            header = json.loads(blob[off: off + hlen].decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise SnapshotFormatError(f"unreadable snapshot header: {e}")
        off += hlen
        fmt = int(header.get("format", -1))
        if fmt != SNAPSHOT_VERSION:
            raise SnapshotFormatError(
                f"snapshot format {fmt} != {SNAPSHOT_VERSION}; "
                "retake the snapshot with the current writer"
            )
        payload = blob[off:]
        digest = header.pop("digest", "")
        expect = hashlib.sha256(
            json.dumps(header, sort_keys=True).encode() + payload
        ).hexdigest()
        if digest != expect:
            SNAPSHOT_COUNTERS._bump("snapshot.digest_failures")
            raise SnapshotFormatError("snapshot integrity digest mismatch")
        arrays: dict = {}
        leaves: list = []
        pos = 0
        for meta in header["tensors"]:
            dtype = np.dtype(meta["dtype"])
            count = int(np.prod(meta["shape"], dtype=np.int64))
            a = (
                np.frombuffer(payload, dtype=dtype, count=count, offset=pos)
                .reshape(meta["shape"])
                .copy()
            )
            pos += a.nbytes
            if meta["name"] == "ell":
                leaves.append(a)
            else:
                arrays[meta["name"]] = a
        return cls(
            epoch=int(header["epoch"]),
            rewire_seq=int(header["rewire_seq"]),
            topo_key=tuple(int(x) for x in header["topo_key"]),
            node_names=tuple(header["node_names"]),
            sweep_hint=int(header["sweep_hint"]),
            arrays=arrays,
            ell_leaves=leaves,
            manifest=tuple(cls._key_from_json(k) for k in header["manifest"]),
        )

    # -- restore ------------------------------------------------------------

    def _structure_matches(self, csr) -> bool:
        """Shapes line up: capacities and the ELL's leaf layout."""
        if tuple(self.topo_key) != (csr.node_capacity, csr.edge_capacity):
            return False
        target = ell_leaves(csr.ell)
        if len(target) != len(self.ell_leaves):
            return False
        for mine, theirs in zip(self.ell_leaves, target):
            t = np.asarray(theirs)
            if mine.shape != t.shape or mine.dtype != t.dtype:
                return False
        return True

    def _content_matches(self, csr) -> bool:
        """Content equality against a foreign mirror: same node order,
        same edge-slot encoding and attributes, same ELL structure.  The
        ELL's `w` / `ok` / `transit_ok` planes are derived (every relax
        recomputes them from edge_metric / edge_up / node_overloaded,
        compared here) and go stale on the donor across in-place
        attribute refreshes, so only `nbr` / `edge_id` and the relabeling
        maps are compared.  Holds whenever the target was built from the
        LinkState the donor last rebuilt at (the fleet scale-out case);
        any real drift demotes to cold instead."""
        if tuple(self.node_names) != tuple(csr.node_names):
            return False
        for name in RESIDENT_ARRAYS:
            if not np.array_equal(self.arrays[name], getattr(csr, name)):
                return False
        theirs = csr.ell
        for b, bt in enumerate(theirs.buckets):
            nbr, _w, edge_id, _ok, _tok = self.ell_leaves[5 * b: 5 * b + 5]
            if not np.array_equal(nbr, np.asarray(bt.nbr)):
                return False
            if not np.array_equal(edge_id, np.asarray(bt.edge_id)):
                return False
        return np.array_equal(
            self.ell_leaves[-2], np.asarray(theirs.new_of_old)
        ) and np.array_equal(self.ell_leaves[-1], np.asarray(theirs.old_of_new))

    def _state(self) -> dict:
        return {
            "topo_key": self.topo_key,
            "version": self.epoch,
            "rewire_seq": self.rewire_seq,
            "sweep_hint": self.sweep_hint,
            "arrays": self.arrays,
            "ell_leaves": self.ell_leaves,
        }

    def restore(self, engine, csr, *, prewarm: bool = True) -> str:
        """Restore this checkpoint as `csr`'s residency on `engine` and
        (optionally) run the manifest's keys once each (`engine.prewarm`).
        Returns the rung taken: "replay" / "install" / "cold" (module
        docstring).  Staleness demotes, counted; it never raises."""
        t0 = time.perf_counter()
        tr = _trace.TRACE
        SNAPSHOT_COUNTERS._bump("snapshot.restores")
        with _trace.maybe_child("engine.snapshot", op="restore"):
            mode = self._restore_residency(engine, csr)
            if tr is not None:
                tr.annotate("snapshot.rung", mode)
                tr.note("snapshot.epoch", self.epoch)
            if prewarm and self.manifest:
                with _trace.maybe_child("engine.snapshot.prewarm"):
                    warmed = engine.prewarm(csr, self.manifest)
                SNAPSHOT_COUNTERS._bump("snapshot.prewarmed_programs", warmed)
        SNAPSHOT_COUNTERS._bump(
            "snapshot.restore_us", int((time.perf_counter() - t0) * 1e6)
        )
        return mode

    def _restore_residency(self, engine, csr) -> str:
        if self._structure_matches(csr):
            if (
                self.donor_csr_id == id(csr)
                and self.donor_ell_ref is csr.ell
                and int(csr.rewire_seq) >= self.rewire_seq
                and int(csr.version) >= self.epoch
            ):
                # donor mirror: install at the snapshot position, then the
                # engine's own rungs replay the rewire tail and any
                # attribute drift since the checkpoint.  A chain gap (log
                # eviction past REWIRE_LOG_DEPTH) demotes inside sync(),
                # visible here as a full_restages increment.
                engine.install_resident(csr, self._state())
                c0 = engine.get_counters()
                engine.sync(csr)
                c1 = engine.get_counters()
                if c1["device.engine.full_restages"] > c0["device.engine.full_restages"]:
                    SNAPSHOT_COUNTERS._bump("snapshot.replay_fallbacks")
                    return "cold"
                replayed = (
                    c1["device.engine.rewires"]
                    - c0["device.engine.rewires"]
                    + c1["device.engine.incremental_updates"]
                    - c0["device.engine.incremental_updates"]
                )
                SNAPSHOT_COUNTERS._bump("snapshot.replayed_events", replayed)
                return "replay"
            if self._content_matches(csr):
                # content-equal foreign mirror: adopt its lineage, so the
                # next sync() finds a current resident
                engine.install_resident(
                    csr,
                    self._state(),
                    version=int(csr.version),
                    rewire_seq=int(csr.rewire_seq),
                )
                return "install"
        # stale or structurally foreign: an accounted demotion to the
        # engine's ordinary restage
        SNAPSHOT_COUNTERS._bump("snapshot.replay_fallbacks")
        engine.drop(csr)
        engine.sync(csr)
        return "cold"
