"""The port's engine snapshots (`openr_tpu_torch.snapshot`, the engine's
snapshot seams) against `openr_tpu.snapshot`, on the CPU.

Oracle: tests/test_snapshot.py.  Both packages' engines hold mirrors of
LinkStates built from the same databases (tests/torch_parity.py), the
reference's own `grid_topology` and seeded WANs.  Everything compared is
integer state or bytes, so there is no tolerance:

- the serial format is the reference's byte for byte (equal state gives
  equal bytes), and artifacts cross between the packages both ways;
- each restore rung (replay, install, cold, and the rewire-log gap that
  demotes a replay) is taken as the reference takes it, with the same
  `snapshot.*` deltas and answers equal to the host Dijkstra's;
- damaged artifacts raise `SnapshotFormatError` as the reference's do;
- `prewarm`, the port's counterpart of the reference's program
  compiles, runs each manifest key once on an installed resident;
- a resident installed on a mirror that is later retired goes with it;
- `AutoscalePolicy` decides as the reference's on seeded counter walks.

`SNAPSHOT_COUNTERS` is process-wide in each package, so every test
asserts deltas.
"""

from __future__ import annotations

import gc
import json
import struct

import numpy as np
import pytest

from openr_tpu.decision.csr import CsrTopology as JCsr
from openr_tpu.device import DeviceResidencyEngine as JEngine
from openr_tpu.snapshot import SNAPSHOT_COUNTER_KEYS as J_SNAPSHOT_COUNTER_KEYS
from openr_tpu.snapshot import SNAPSHOT_COUNTERS as J_COUNTERS
from openr_tpu.snapshot import AutoscalePolicy as JAutoscalePolicy
from openr_tpu.snapshot import EngineSnapshot as JSnapshot
from openr_tpu.snapshot import SnapshotFormatError as JSnapshotFormatError
from openr_tpu_torch.decision.csr import CsrTopology
from openr_tpu_torch.device.engine import DeviceResidencyEngine
from openr_tpu_torch.snapshot import (
    SNAPSHOT_COUNTER_KEYS,
    SNAPSHOT_COUNTERS,
    AutoscalePolicy,
    EngineSnapshot,
    SnapshotFormatError,
)
from openr_tpu_torch.utils import topo
from torch_parity import link_states, overload, to_jax_dbs

PORT, REF = "port", "reference"

TOPOLOGIES = {
    "grid4": lambda: topo.grid_topology(4),
    "grid5_drained": lambda: overload(topo.grid_topology(5), 7),
    "wan96": lambda: topo.wan_topology(96, chords=2, seed=3),
}


class Side:
    """One package's LinkState, mirror, engine and snapshot API over the
    databases `dbs` (kept, so a test can change one and republish)."""

    def __init__(self, which: str, dbs) -> None:
        self.which = which
        self.dbs = dbs if which == PORT else to_jax_dbs(dbs)
        ls, jls = link_states(dbs)
        self.ls = ls if which == PORT else jls
        if which == PORT:
            self.csr = CsrTopology.from_link_state(self.ls)
            self.engine = DeviceResidencyEngine("cpu")
            self.snap, self.counters, self.error = (
                EngineSnapshot, SNAPSHOT_COUNTERS, SnapshotFormatError,
            )
        else:
            self.csr = JCsr.from_link_state(self.ls)
            self.engine = JEngine()
            self.snap, self.counters, self.error = (
                JSnapshot, J_COUNTERS, JSnapshotFormatError,
            )

    def fresh_engine(self):
        return DeviceResidencyEngine("cpu") if self.which == PORT else JEngine()

    def mirror(self, dbs):
        """A foreign mirror: a new LinkState and CSR over `dbs`."""
        ls, jls = link_states(dbs)
        if self.which == PORT:
            return ls, CsrTopology.from_link_state(ls)
        return jls, JCsr.from_link_state(jls)

    def republish(self, index: int) -> None:
        """Push self.dbs[index] again (after a test changed it)."""
        self.ls.update_adjacency_database(self.dbs[index])


def pair(dbs_fn):
    return Side(PORT, dbs_fn()), Side(REF, dbs_fn())


def answers(engine, csr, sources) -> dict:
    return {
        src: {
            dest: (int(entry.metric), frozenset(entry.next_hops))
            for dest, entry in res.items()
        }
        for src, res in engine.spf_results(csr, list(sources)).items()
    }


def oracle(ls, sources) -> dict:
    return {
        src: {
            dest: (int(entry.metric), frozenset(entry.next_hops))
            for dest, entry in ls.run_spf(src).items()
        }
        for src in sources
    }


def deltas(counters, before) -> dict:
    now = counters.get_counters()
    return {k: now[k] - before[k] for k in SNAPSHOT_COUNTER_KEYS if not k.endswith("_us")}


# -- the serial format ---------------------------------------------------------


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_bytes_equal_the_references(name):
    port, ref = pair(TOPOLOGIES[name])
    blob = EngineSnapshot.take(port.engine, port.csr).to_bytes()
    jblob = JSnapshot.take(ref.engine, ref.csr).to_bytes()
    assert blob == jblob
    back = EngineSnapshot.from_bytes(blob)
    assert back.to_bytes() == blob
    assert back.donor_csr_id is None and back.donor_ell_ref is None


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_fields_of_a_taken_snapshot_equal_the_references(name):
    port, ref = pair(TOPOLOGIES[name])
    snap = EngineSnapshot.take(port.engine, port.csr)
    jsnap = JSnapshot.take(ref.engine, ref.csr)
    for field in ("epoch", "rewire_seq", "topo_key", "node_names", "sweep_hint", "manifest"):
        assert getattr(snap, field) == getattr(jsnap, field), field
    assert snap.nbytes() == jsnap.nbytes()
    assert len(snap.ell_leaves) == len(jsnap.ell_leaves)
    for mine, theirs in zip(snap.ell_leaves, jsnap.ell_leaves):
        assert mine.dtype == theirs.dtype and np.array_equal(mine, theirs)
    for key, a in snap.arrays.items():
        assert a.dtype == jsnap.arrays[key].dtype and np.array_equal(a, jsnap.arrays[key])


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_artifacts_cross_between_the_packages(direction):
    """A snapshot serialized by one package restores in the other on the
    install rung, with no restage, answering as the donor did."""
    port, ref = pair(TOPOLOGIES["grid4"])
    donor, joiner = (ref, port) if direction == "reference_to_port" else (port, ref)
    sources = donor.ls.node_names[:3]
    want = answers(donor.engine, donor.csr, sources)
    blob = donor.snap.take(donor.engine, donor.csr).to_bytes()
    ls, csr = joiner.mirror(topo.grid_topology(4))
    engine = joiner.fresh_engine()
    snap = joiner.snap.from_bytes(blob)
    if direction == "port_to_reference":
        # the reference reads the port's manifest keys; its own program
        # shape for this size is the packed one
        assert all(k[4] is False for k in snap.manifest)
    assert snap.restore(engine, csr) == "install"
    assert engine.get_counters()["device.engine.full_restages"] == 0
    assert answers(engine, csr, sources) == want == oracle(ls, sources)


@pytest.mark.parametrize("which", [PORT, REF])
def test_a_flipped_payload_byte_fails_the_digest(which):
    side = Side(which, TOPOLOGIES["grid4"]())
    blob = bytearray(side.snap.take(side.engine, side.csr).to_bytes())
    before = side.counters.get_counters()
    blob[-3] ^= 0xFF
    with pytest.raises(side.error, match="digest"):
        side.snap.from_bytes(bytes(blob))
    assert deltas(side.counters, before)["snapshot.digest_failures"] == 1


@pytest.mark.parametrize("which", [PORT, REF])
def test_bad_magic_and_format_skew_refuse(which):
    side = Side(which, TOPOLOGIES["grid4"]())
    blob = side.snap.take(side.engine, side.csr).to_bytes()
    with pytest.raises(side.error, match="magic"):
        side.snap.from_bytes(b"NOTASNAP" + blob[8:])
    with pytest.raises(side.error, match="truncated"):
        side.snap.from_bytes(blob[:10])
    (hlen,) = struct.unpack_from("<I", blob, 8)
    header = json.loads(blob[12: 12 + hlen].decode())
    header["format"] = 99
    hdr = json.dumps(header, sort_keys=True).encode()
    skew = blob[:8] + struct.pack("<I", len(hdr)) + hdr + blob[12 + hlen:]
    with pytest.raises(side.error, match="format"):
        side.snap.from_bytes(skew)
    # the port's error is the port's own class, not the reference's
    assert (side.error is SnapshotFormatError) == (which == PORT)


def test_counter_family_is_the_references():
    assert SNAPSHOT_COUNTER_KEYS == J_SNAPSHOT_COUNTER_KEYS
    c = SNAPSHOT_COUNTERS.get_counters()
    assert set(SNAPSHOT_COUNTER_KEYS) <= set(c)
    assert all(k.startswith("snapshot.") for k in c)


# -- the restore rungs ---------------------------------------------------------


def _replay_after_drift(side):
    sources = side.ls.node_names[:3]
    answers(side.engine, side.csr, sources)
    snap = side.snap.take(side.engine, side.csr)
    side.dbs[0].adjacencies[0].metric = 41
    side.republish(0)
    assert side.csr.refresh(side.ls) is True
    before = side.counters.get_counters()
    mode = snap.restore(side.engine, side.csr, prewarm=False)
    return mode, deltas(side.counters, before), answers(side.engine, side.csr, sources), sources


def _install_fresh(side):
    sources = side.ls.node_names[:3]
    blob = side.snap.take(side.engine, side.csr).to_bytes()
    ls, csr = side.mirror(TOPOLOGIES["grid4"]())
    engine = side.fresh_engine()
    before = side.counters.get_counters()
    mode = side.snap.from_bytes(blob).restore(engine, csr, prewarm=False)
    assert engine.get_counters()["device.engine.full_restages"] == 0
    assert engine.has_residency(csr) and int(csr.version) == int(side.csr.version)
    return mode, deltas(side.counters, before), answers(engine, csr, sources), sources


def _stale_to_cold(side):
    snap = side.snap.take(side.engine, side.csr)
    dbs = TOPOLOGIES["grid4"]()
    dbs[0].adjacencies[0].metric = 57
    ls, csr = side.mirror(dbs)
    engine = side.fresh_engine()
    before = side.counters.get_counters()
    mode = snap.restore(engine, csr, prewarm=False)
    sources = ls.node_names[:2]
    side.ls = ls  # the oracle below reads the joiner's truth
    return mode, deltas(side.counters, before), answers(engine, csr, sources), sources


def _rewire_gap(side):
    side.engine.sync(side.csr)
    snap = side.snap.take(side.engine, side.csr)
    corner = side.dbs[0]
    depth = CsrTopology.REWIRE_LOG_DEPTH
    assert depth == JCsr.REWIRE_LOG_DEPTH
    for _ in range(depth // 2 + 2):
        gone = corner.adjacencies.pop(0)
        side.republish(0)
        side.csr.refresh(side.ls)
        corner.adjacencies.insert(0, gone)
        side.republish(0)
        side.csr.refresh(side.ls)
    before = side.counters.get_counters()
    mode = snap.restore(side.engine, side.csr, prewarm=False)
    sources = side.ls.node_names[:2]
    return mode, deltas(side.counters, before), answers(side.engine, side.csr, sources), sources


RUNGS = {
    "replay_after_drift": (_replay_after_drift, "replay"),
    "install_on_a_fresh_replica": (_install_fresh, "install"),
    "stale_snapshot_to_cold": (_stale_to_cold, "cold"),
    "rewire_chain_gap_to_cold": (_rewire_gap, "cold"),
}


@pytest.mark.parametrize("rung", sorted(RUNGS))
def test_restore_rungs_as_the_reference(rung):
    fn, want_mode = RUNGS[rung]
    port, ref = pair(TOPOLOGIES["grid4"])
    got = fn(port)
    jgot = fn(ref)
    assert got[0] == jgot[0] == want_mode
    assert got[1] == jgot[1]
    assert got[2] == jgot[2] == oracle(port.ls, got[3])
    if want_mode == "cold":
        assert got[1]["snapshot.replay_fallbacks"] == 1
    if want_mode == "replay":
        assert got[1]["snapshot.replayed_events"] >= 1


# -- prewarm: the port's counterpart of the reference's compiles ---------------


def test_prewarm_runs_each_manifest_key_once():
    port = Side(PORT, TOPOLOGIES["grid4"]())
    sources = port.ls.node_names[:3]
    port.engine.spf_results(port.csr, sources)
    port.engine.spf_results(port.csr, sources[:1])
    snap = EngineSnapshot.take(port.engine, port.csr)
    topo_key = (port.csr.node_capacity, port.csr.edge_capacity)
    assert snap.manifest == (
        (topo_key, 8, 1, 16, False, True),
        (topo_key, 1, 1, 16, False, True),
    )
    ls, csr = port.mirror(TOPOLOGIES["grid4"]())
    joiner = DeviceResidencyEngine("cpu")
    before = SNAPSHOT_COUNTERS.get_counters()
    assert snap.restore(joiner, csr) == "install"
    c = joiner.get_counters()
    assert c["device.engine.prewarm_runs"] == len(snap.manifest) == 2
    assert c["device.engine.queries"] == 0 and c["device.engine.full_restages"] == 0
    assert set(joiner.cached_program_keys()) == set(snap.manifest)
    assert deltas(SNAPSHOT_COUNTERS, before)["snapshot.prewarmed_programs"] == 2
    # run keys and keys of another topology are skipped
    other = (((64, 128),) + snap.manifest[0][1:],)
    assert joiner.prewarm(csr, snap.manifest + other) == 0
    # the first query runs a prewarmed key: no new key, answers equal
    assert answers(joiner, csr, sources) == oracle(ls, sources)
    assert set(joiner.cached_program_keys()) == set(snap.manifest)


def test_prewarm_needs_a_current_resident_and_reads_reference_keys():
    port, ref = pair(TOPOLOGIES["grid4"])
    sources = ref.ls.node_names[:3]
    ref.engine.spf_results(ref.csr, sources)
    jsnap = JSnapshot.take(ref.engine, ref.csr)
    # the reference's key names its packed program shape (small True)
    assert [k[4] for k in jsnap.manifest] == [True]
    snap = EngineSnapshot.from_bytes(jsnap.to_bytes())
    engine = DeviceResidencyEngine("cpu")
    assert engine.prewarm(port.csr, snap.manifest) == 0  # nothing resident
    assert snap.restore(engine, port.csr) == "install"
    assert engine.cached_program_keys() == [
        snap.manifest[0][:4] + (False,) + snap.manifest[0][5:]
    ]
    assert engine.get_counters()["device.engine.prewarm_runs"] == 1


def test_cached_program_keys_follow_the_sweep_ladder():
    """A non-converged attempt doubles the hint; both attempts' keys are
    recorded, as the reference compiles one program per attempt."""
    port, ref = pair(TOPOLOGIES["wan96"])
    for side in (port, ref):
        side.csr._sweep_hint = 1
    src = port.ls.node_names[:1]
    port.engine.spf_results(port.csr, src)
    ref.engine.spf_results(ref.csr, src)
    keys = [k[:4] + k[5:] for k in port.engine.cached_program_keys()]
    jkeys = [k[:4] + k[5:] for k in ref.engine.cached_program_keys()]
    assert keys == jkeys and len(keys) > 1


# -- residency bookkeeping ------------------------------------------------------


def test_install_on_a_retired_mirror_leaves_no_resident():
    port = Side(PORT, TOPOLOGIES["grid4"]())
    blob = EngineSnapshot.take(port.engine, port.csr).to_bytes()
    engine = DeviceResidencyEngine("cpu")
    ls, csr = port.mirror(TOPOLOGIES["grid4"]())
    assert EngineSnapshot.from_bytes(blob).restore(engine, csr) == "install"
    assert len(engine._residents) == 1
    del csr
    gc.collect()
    assert engine._residents == {}


def test_export_never_aliases_the_resident():
    port = Side(PORT, TOPOLOGIES["grid4"]())
    snap = EngineSnapshot.take(port.engine, port.csr)
    metric = snap.arrays["edge_metric"].copy()
    port.dbs[0].adjacencies[0].metric = 33
    port.republish(0)
    port.csr.refresh(port.ls)
    port.engine.sync(port.csr)
    assert np.array_equal(snap.arrays["edge_metric"], metric)


def test_install_refuses_an_image_of_another_ell_layout():
    port = Side(PORT, TOPOLOGIES["grid4"]())
    state = port.engine.export_resident(port.csr)
    state["ell_leaves"] = state["ell_leaves"][:-1]
    with pytest.raises(ValueError, match="ELL leaves"):
        DeviceResidencyEngine("cpu").install_resident(port.csr, state)


# -- autoscale -----------------------------------------------------------------


def _walk(seed: int, n: int = 200):
    rng = np.random.default_rng(seed)
    sheds = dispatches = 0
    for _ in range(n):
        sheds += int(rng.choice([0, 0, 0, 1, 3]))
        dispatches += int(rng.choice([0, 0, 5, 50]))
        counters = {"serving.router.sheds": sheds, "serving.router.dispatches": dispatches}
        if rng.random() < 0.1:
            counters = {}
        yield counters, int(rng.choice([0, 0, 10, 70]))


@pytest.mark.parametrize("seed", range(6))
def test_autoscale_decides_as_the_reference(seed):
    kwargs = dict(
        min_replicas=1 + seed % 2, max_replicas=3 + seed % 3, depth_high=64,
        idle_intervals=2 + seed % 2, cooldown=seed % 3,
    )
    p, jp = AutoscalePolicy(**kwargs), JAutoscalePolicy(**kwargs)
    k = jk = kwargs["min_replicas"]
    actions = set()
    for counters, depth in _walk(seed):
        d = p.observe(k, counters, admission_depth=depth)
        jd = jp.observe(jk, counters, admission_depth=depth)
        assert (d.action, d.target_k, d.reason) == (jd.action, jd.target_k, jd.reason)
        k, jk = d.target_k, jd.target_k
        actions.add(d.action)
    assert {"scale_out", "hold"} <= actions
