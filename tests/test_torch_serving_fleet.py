"""The port's serving fleet (`openr_tpu_torch.main.ServingFleet`,
`fleet_node_config`, the daemon's `snapshot` counter surface) against
`openr_tpu.main`, on the CPU.

Oracles: tests/test_replicafleet.py::TestServingFleetWiring and
tests/test_snapshot.py::TestFleetScaleUnderLoad.  `ServingFleet(2,
device="cpu")` brings up two full daemons peered over a KvStore full
mesh behind one ReplicaRouter; its front door answers queryPaths (with
a pinned session), queryKsp and queryWhatIf as the reference's fleet
does, survives a replica kill, and scales out (a snapshot warm start on
the install rung) and in under a load thread with the dispatch ledger
closing and no silent drop.  The deliberate difference: a warm start
that fails raises out of `scale()`, where the reference logs it and lets
the replica join cold.

No CPU burner: every wait polls converged state against a deadline, the
load thread is joined with a timeout, and every fleet is stopped in a
`finally`.
"""

from __future__ import annotations

import asyncio
import socket
import struct
import threading
import time

import pytest

from openr_tpu_torch.main import OpenrDaemon, ServingFleet, fleet_node_config
from openr_tpu_torch.serving import dispatch_ledger_closes
from openr_tpu_torch.snapshot import SNAPSHOT_COUNTER_KEYS, SNAPSHOT_COUNTERS, AutoscalePolicy

CONVERGE_S = 60.0


def call(fleet, method, **params):
    return asyncio.run(fleet.handler.async_methods[method](params))


def started(fleet):
    fleet.start()
    if not fleet.wait_converged(CONVERGE_S):
        fleet.stop()
        raise AssertionError("fleet never converged")
    return fleet


@pytest.fixture
def fleet2():
    fleet = started(ServingFleet(2, device="cpu"))
    try:
        yield fleet
    finally:
        fleet.stop()


def snapshot_deltas(before) -> dict:
    now = SNAPSHOT_COUNTERS.get_counters()
    return {k: now[k] - before[k] for k in SNAPSHOT_COUNTER_KEYS}


def test_fleet_node_config_is_the_references():
    from openr_tpu.main import fleet_node_config as j_fleet_node_config

    from openr_tpu_torch.serializer import to_wire
    from openr_tpu.serializer import to_wire as j_to_wire

    assert to_wire(fleet_node_config("fleet-3", 7)) == j_to_wire(
        j_fleet_node_config("fleet-3", 7)
    )


def test_front_door_answers_as_the_references_fleet():
    """queryPaths (pinned), queryKsp and queryWhatIf through each
    package's front door give equal replies."""
    from openr_tpu.main import ServingFleet as JServingFleet

    replies = {}
    for name, make in (
        ("port", lambda: ServingFleet(2, device="cpu")),
        ("reference", lambda: JServingFleet(2)),
    ):
        fleet = started(make())
        try:
            paths = call(fleet, "queryPaths", sources=["fleet-0"], session="cli")
            ksp = call(fleet, "queryKsp", sources=["fleet-0"], dests=["fleet-1"], k=1)
            what_if = call(
                fleet, "queryWhatIf", sources=["fleet-0"], scenarios=[[["fleet-0", "fleet-1"]]]
            )
            pin = fleet.router.session_pin("cli")
        finally:
            fleet.stop()
        assert pin == paths["epoch"]
        # a link's (n1, n2) is the order its two adjacencies arrived in,
        # which the fleet's flooding leaves to timing in both packages
        ksp = {
            dest: [[sorted(link) for link in path] for path in found]
            for dest, found in ksp["result"].items()
        }
        replies[name] = (paths["result"], ksp, what_if["result"])
    assert replies["port"] == replies["reference"]
    paths, ksp, what_if = replies["port"]
    assert paths["fleet-0"]["fleet-1"]["nextHops"] == ["fleet-1"]
    assert ksp["fleet-1"] == [[["fleet-0", "fleet-1"]]]
    assert what_if[0]["newly_unreachable_pairs"] == 1


def test_front_door_spreads_and_pins(fleet2):
    reply = None
    for _ in range(4):
        reply = call(fleet2, "queryPaths", sources=["fleet-0"], session="cli")
        assert reply["result"]["fleet-0"]["fleet-1"]["nextHops"] == ["fleet-1"]
    assert fleet2.router.session_pin("cli") == reply["epoch"]
    admitted = [d.serving.get_counters()["serving.admitted"] for d in fleet2.daemons]
    assert all(a >= 1 for a in admitted), admitted
    counters = fleet2.handler._all_counters()
    assert counters["serving.router.dispatches"] >= 4
    assert set(SNAPSHOT_COUNTER_KEYS) <= set(counters)
    assert counters["serving.router.replica_deaths"] == 0


def test_replica_kill_is_transparent_to_the_front_door(fleet2):
    assert call(fleet2, "queryPaths", sources=["fleet-0"])
    fleet2.daemons[1].serving.stop()
    for _ in range(3):
        reply = call(fleet2, "queryPaths", sources=["fleet-0"])
        assert reply["result"]["fleet-0"]["fleet-1"]["metric"] == 1
    c = fleet2.router.get_counters()
    assert c["serving.router.retries"] + c["serving.router.failovers"] >= 1


def taken_snapshots(monkeypatch) -> list:
    """Record every EngineSnapshot.take of the test."""
    from openr_tpu_torch.snapshot import EngineSnapshot

    taken: list = []
    take = EngineSnapshot.take.__func__

    def recording(cls, engine, csr):
        snap = take(cls, engine, csr)
        taken.append(snap)
        return snap

    monkeypatch.setattr(EngineSnapshot, "take", classmethod(recording))
    return taken


def expected_rung(snap) -> str:
    """The rung a converged joiner's fresh mirror takes: install when the
    donor's mirror has not rewired since it was (re)built, so its slot
    layout is a fresh build's; cold otherwise (the content check of the
    reference's restore, which this fleet's timing decides)."""
    return "install" if snap.rewire_seq == 0 else "cold"


def test_scale_out_and_in_under_load_closes_the_ledger(monkeypatch):
    taken = taken_snapshots(monkeypatch)
    fleet = started(ServingFleet(2, hedge_after_s=None, device="cpu"))
    stop = threading.Event()
    acct = {"submitted": 0, "resolved": 0}
    errors: list = []

    def load() -> None:
        while not stop.is_set():
            fut = fleet.router.submit("paths", sources=("fleet-0",))
            acct["submitted"] += 1
            try:
                fut.result(timeout=30)
            except Exception as exc:  # noqa: BLE001 — accounted
                errors.append(repr(exc))
            acct["resolved"] += 1
            time.sleep(0.002)

    thread = threading.Thread(target=load, name="fleet-load")
    c0 = SNAPSHOT_COUNTERS.get_counters()
    try:
        thread.start()
        time.sleep(0.2)
        modes = fleet.scale(3)
        assert len(taken) == 1 and modes == [expected_rung(taken[0])], modes
        assert len(fleet.daemons) == 3 and fleet.router.alive_replicas() == 3
        joiner = fleet.daemons[-1].decision.spf_solver.spf.engine
        restages = joiner.get_counters()["device.engine.full_restages"]
        time.sleep(0.2)
        fleet.scale(2)
        assert len(fleet.daemons) == 2
        time.sleep(0.2)
    finally:
        stop.set()
        thread.join(timeout=60)
        fleet.stop()
    assert not thread.is_alive(), "the load thread did not end"
    counters = fleet.router.get_counters()
    assert not errors, errors[:3]
    assert acct["resolved"] == acct["submitted"] > 0, "silent drops"
    assert dispatch_ledger_closes(counters, acct["submitted"]), counters
    d = snapshot_deltas(c0)
    assert (d["snapshot.scaleouts"], d["snapshot.scaleins"], d["snapshot.taken"]) == (1, 1, 1)
    assert d["snapshot.restores"] == 1
    assert d["snapshot.replay_fallbacks"] == (modes == ["cold"])
    # an install stages nothing beyond the joiner's own first build
    assert restages <= 1 or modes == ["cold"]


def test_autoscale_step_scales_in_and_out():
    fleet = started(ServingFleet(2, hedge_after_s=None, device="cpu"))
    try:
        c0 = SNAPSHOT_COUNTERS.get_counters()
        idle = AutoscalePolicy(min_replicas=1, idle_intervals=1, cooldown=0)
        decision = fleet.autoscale_step(idle)
        assert (decision.action, decision.target_k) == ("scale_in", 1)
        assert len(fleet.daemons) == 1
        pressed = AutoscalePolicy(max_replicas=2, depth_high=0, cooldown=0)
        decision = fleet.autoscale_step(pressed)
        assert (decision.action, decision.target_k) == ("scale_out", 2)
        assert len(fleet.daemons) == 2
        reply = call(fleet, "queryPaths", sources=["fleet-0"])
        assert reply["result"]["fleet-0"]["fleet-2"]["metric"] == 1
        d = snapshot_deltas(c0)
        assert (d["snapshot.scaleins"], d["snapshot.scaleouts"]) == (1, 1)
    finally:
        fleet.stop()


def _linger(pkg: str, fleet) -> None:
    """Leave the state a departed replica leaves: its adjacency database
    (an adjacency to fleet-0 that fleet-0 no longer lists) in every store,
    where it stays until its TTL, here none."""
    if pkg == "port":
        from openr_tpu_torch import types
        from openr_tpu_torch.serializer import dumps
    else:
        from openr_tpu import types
        from openr_tpu.serializer import dumps
    db = types.AdjacencyDatabase(
        this_node_name="fleet-9",
        adjacencies=[types.Adjacency(
            other_node_name="fleet-0", if_name="if-9-0", other_if_name="if-0-9",
            metric=1, next_hop_v6="fe80::fleet-0",
        )],
        area="0",
    )
    value = types.Value(version=1, originator_id="fleet-9", value=dumps(db))
    fleet.daemons[0].kvstore.set_key_vals("0", {types.adj_key("fleet-9"): value})
    deadline = time.monotonic() + CONVERGE_S
    while not all(
        "fleet-9" in d.decision.area_link_states["0"].node_names for d in fleet.daemons
    ):
        assert time.monotonic() < deadline, "the departed database never flooded"
        time.sleep(0.05)


def test_a_departed_replicas_database_does_not_block_convergence():
    """F6 (ROADMAP queue 3): the reference's `wait_converged` asks
    `len(ls.node_names) == k`, which a departed replica's adjacency
    database keeps false, so a scale-out after a scale-in waits out its
    whole timeout (30 s) and joins unconverged.  The port asks for the
    live replicas' full mesh, which the departed node (its links down)
    does not touch."""
    from openr_tpu.main import ServingFleet as JServingFleet

    converged = {}
    for pkg, make in (
        ("port", lambda: ServingFleet(2, hedge_after_s=None, device="cpu")),
        ("reference", lambda: JServingFleet(2, hedge_after_s=None)),
    ):
        fleet = started(make())
        try:
            _linger(pkg, fleet)
            converged[pkg] = fleet.wait_converged(2.0)
        finally:
            fleet.stop()
    assert converged == {"port": True, "reference": False}


def test_scale_out_after_a_scale_in(monkeypatch):
    fleet = started(ServingFleet(2, hedge_after_s=None, device="cpu"))
    try:
        fleet.scale(1)
        taken = taken_snapshots(monkeypatch)
        assert fleet.scale(2) == [expected_rung(taken[0])]
        assert fleet.wait_converged(CONVERGE_S)
        reply = call(fleet, "queryPaths", sources=["fleet-0"])
        assert reply["result"]["fleet-0"]["fleet-2"]["metric"] == 1
    finally:
        fleet.stop()


def test_a_failed_warm_start_raises_out_of_scale(monkeypatch):
    """The reference swallows a failed warm start (the replica joins
    cold, `scale` returns [None]); the port raises, and the replica never
    joins the router."""
    from openr_tpu_torch.snapshot import EngineSnapshot

    def broken(self, engine, csr, *, prewarm=True):
        raise RuntimeError("restore failed")

    monkeypatch.setattr(EngineSnapshot, "restore", broken)
    fleet = started(ServingFleet(2, hedge_after_s=None, device="cpu"))
    try:
        c0 = SNAPSHOT_COUNTERS.get_counters()
        with pytest.raises(RuntimeError, match="restore failed"):
            fleet.scale(3)
        assert len(fleet.router._replicas) == 2
        assert snapshot_deltas(c0)["snapshot.scaleouts"] == 0
    finally:
        fleet.stop()


def test_scale_refuses_below_one_and_before_start():
    fleet = ServingFleet(1, device="cpu")
    with pytest.raises(RuntimeError, match="started"):
        fleet.scale(2)
    with pytest.raises(ValueError):
        fleet.scale(0)
    with pytest.raises(ValueError):
        ServingFleet(0, device="cpu")
    for daemon in fleet.daemons:
        daemon.config_store.close()


def _thrift_counters(port: int) -> dict:
    from openr_tpu_torch.interop import thrift_binary as tb

    with socket.create_connection(("::1", port), timeout=30) as sock:
        sock.sendall(tb.frame(tb.encode_message("getCounters", tb.MSG_CALL, 1, b"\x00")))
        head = b""
        while len(head) < 4:
            head += sock.recv(4 - len(head))
        (length,) = struct.unpack("!i", head)
        data = b""
        while len(data) < length:
            data += sock.recv(length - len(data))
    _name, mtype, _seqid, body = tb.decode_message(data)
    assert mtype == tb.MSG_REPLY
    spec = tb.StructSpec("result", None, (tb.Field(
        0, "success", ("map", tb.T_STRING, tb.T_I64),
        dec=lambda m: {k.decode(): v for k, v in m.items()},
    ),))
    return tb.read_struct(body, spec)["success"]


def test_daemon_answers_the_snapshot_family_on_both_wires():
    from openr_tpu_torch.ctrl import CtrlClient
    from openr_tpu_torch.spark import MockIoProvider

    cfg = fleet_node_config("snap-0")
    cfg.thrift_shim_port = -1
    d = OpenrDaemon(cfg, io_provider=MockIoProvider().endpoint("snap-0"), device="cpu")
    d.start()
    try:
        with CtrlClient("::1", d.ctrl_port) as client:
            ctrl = client.call("getCounters")
        shim = _thrift_counters(d.thrift_shim.port)
    finally:
        d.stop()
    for counters in (ctrl, shim):
        assert set(SNAPSHOT_COUNTER_KEYS) <= set(counters)
