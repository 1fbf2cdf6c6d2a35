"""The port's Spark (`openr_tpu_torch.spark`) and StepDetector against
`openr_tpu`'s.

- `StepDetector` over seeded (numpy) RTT series with level shifts and
  jitter: the same verdict per sample, the same reported steps and the
  same baseline in both packages;
- `SparkPacket` bytes: a port Spark and a reference Spark on one
  `MockIoProvider` discover each other (each reads the other's hello,
  handshake and heartbeat bytes), and every packet the port sends is
  read by the reference's `loads` and written back to the same bytes;
- the scenarios of `tests/test_spark.py` run in each package over its
  own `MockIoProvider`, with the reference tests' fast timers: the
  neighbor events per node (type, neighbor, interface, area, address)
  are equal between the packages, and the FSM states the reference
  tests assert hold in the port;
- `UdpIoProvider` over a veth pair with kernel timestamps, as
  `tests/test_spark.py` runs it, skipped exactly when that test skips.

Threaded runs wait with deadline-bound polling and compare converged
state, never timings.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest

from torch_parity import to_ref

PACKAGES = ("port", "ref")


def pkg(name: str) -> SimpleNamespace:
    if name == "port":
        from openr_tpu_torch import serializer, spark, types
        from openr_tpu_torch.runtime.queue import ReplicateQueue
        from openr_tpu_torch.utils import step_detector
    else:
        from openr_tpu import serializer, spark, types
        from openr_tpu.runtime.queue import ReplicateQueue
        from openr_tpu.utils import step_detector
    return SimpleNamespace(
        name=name, T=types, ser=serializer, spark=spark,
        ReplicateQueue=ReplicateQueue, StepDetector=step_detector.StepDetector,
    )


P = {name: pkg(name) for name in PACKAGES}


def fast_cfg(p):
    """tests/test_spark.py's FAST_CFG."""
    return p.spark.SparkConfig(
        hello_time_s=0.2,
        fastinit_hello_time_s=0.02,
        keepalive_time_s=0.05,
        hold_time_s=0.3,
        graceful_restart_time_s=0.6,
        negotiate_hold_time_s=0.5,
    )


def wait_for(cond, timeout=10.0, interval=0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


# -- StepDetector ---------------------------------------------------------------


@pytest.mark.parametrize("seed", range(5))
def test_step_detector_equals_reference(seed):
    rng = np.random.default_rng(seed)
    levels = rng.integers(500, 20_000, size=6)
    series = np.concatenate(
        [lvl + rng.normal(0, lvl * 0.05, size=int(rng.integers(20, 90))) for lvl in levels]
    )
    kwargs = dict(
        fast_window_size=int(rng.integers(3, 12)),
        slow_window_size=int(rng.integers(30, 70)),
        lower_threshold_pct=0.4,
        upper_threshold_pct=0.6,
        abs_threshold=float(rng.integers(100, 800)),
    )
    runs = {}
    for name in PACKAGES:
        steps = []
        det = P[name].StepDetector(on_step=steps.append, **kwargs)
        verdicts = [det.add_value(float(x)) for x in series]
        runs[name] = (verdicts, steps, det.baseline)
    assert runs["port"] == runs["ref"]
    assert any(runs["port"][0])


def test_step_detector_rejects_bad_windows():
    for name in PACKAGES:
        with pytest.raises(ValueError):
            P[name].StepDetector(fast_window_size=10, slow_window_size=5)


# -- Spark harness ----------------------------------------------------------------


class Harness:
    """Spark nodes on one MockIoProvider (tests/test_spark.py's
    SparkHarness); `fabric_pkg` picks the fabric, each node its own
    package."""

    def __init__(self, fabric_pkg: str) -> None:
        self.fabric = P[fabric_pkg].spark.MockIoProvider()
        self.nodes, self.pkgs, self.if_queues, self.readers = {}, {}, {}, {}
        self.events: dict[str, list] = {}
        self.sent: dict[str, list] = {}

    def add_node(self, name, package, areas=None, domain="openr"):
        p = P[package]
        ifq, nbrq = p.ReplicateQueue(), p.ReplicateQueue()
        endpoint = self.fabric.endpoint(name)
        sent = self.sent.setdefault(name, [])
        real_send = endpoint.send

        def send(if_name, data):
            sent.append(data)
            real_send(if_name, data)

        endpoint.send = send
        spark = p.spark.Spark(
            name, ifq.get_reader(), nbrq, endpoint, config=fast_cfg(p),
            areas=areas, domain=domain,
        )
        spark.run()
        self.nodes[name], self.pkgs[name] = spark, p
        self.if_queues[name] = ifq
        self.readers[name] = nbrq.get_reader()
        self.events[name] = []
        return spark

    def bring_up(self, node, *ifs):
        T = self.pkgs[node].T
        self.if_queues[node].push(
            T.InterfaceDatabase(
                this_node_name=node,
                interfaces={
                    n: T.InterfaceInfo(if_name=n, is_up=True, if_index=i + 1)
                    for i, n in enumerate(ifs)
                },
            )
        )

    def drain(self, node) -> list:
        reader = self.readers[node]
        while reader.size():
            ev = reader.get(timeout=1)
            self.events[node].append(
                (ev.event_type.name, ev.node_name, ev.if_name, ev.area, ev.neighbor_addr_v6)
            )
        return self.events[node]

    def wait_event(self, node, type_name, count=1, timeout=10.0):
        assert wait_for(
            lambda: sum(e[0] == type_name for e in self.drain(node)) >= count, timeout
        ), (node, type_name, self.events[node])

    def state(self, node, if_name, nbr):
        st = self.nodes[node].get_neigh_state(if_name, nbr)
        return None if st is None else st.name

    def stop(self):
        for q in self.if_queues.values():
            q.close()
        for spark in self.nodes.values():
            spark.stop()
        for spark in self.nodes.values():
            spark.wait_until_stopped(5)


def in_both(scenario) -> dict:
    """`scenario(harness, package)` run once per package (nodes and
    fabric of that package); the records must be equal."""
    records = {}
    for name in PACKAGES:
        h = Harness(name)
        try:
            records[name] = scenario(h, name)
        finally:
            h.stop()
    assert records["port"] == records["ref"]
    return records["port"]


def two_nodes(h, package, latency_s=0.0):
    h.add_node("node1", package)
    h.add_node("node2", package)
    h.fabric.connect("node1", "if1", "node2", "if2", latency_s=latency_s)
    h.bring_up("node1", "if1")
    h.bring_up("node2", "if2")
    h.wait_event("node1", "NEIGHBOR_UP")
    h.wait_event("node2", "NEIGHBOR_UP")


def test_two_nodes_establish():
    def scenario(h, package):
        two_nodes(h, package)
        return {n: (h.drain(n)[:1], h.state(n, i, o)) for n, i, o in
                (("node1", "if1", "node2"), ("node2", "if2", "node1"))}

    rec = in_both(scenario)
    assert rec["node1"] == (
        [("NEIGHBOR_UP", "node2", "if1", "0", "fe80::node2")], "ESTABLISHED"
    )


def test_three_nodes_shared_segment():
    def scenario(h, package):
        for n in "abc":
            h.add_node(n, package)
        for x, y in (("a", "b"), ("a", "c"), ("b", "c")):
            h.fabric.connect(x, "if1", y, "if1")
        for n in "abc":
            h.bring_up(n, "if1")
        for n in "abc":
            h.wait_event(n, "NEIGHBOR_UP", count=2)
        return {n: sorted(e for e in h.drain(n) if e[0] == "NEIGHBOR_UP") for n in "abc"}

    rec = in_both(scenario)
    assert [e[1] for e in rec["a"]] == ["b", "c"]


def test_neighbor_down_on_hold_expiry_and_interface_down():
    """A disconnected link times out (heartbeat hold) to IDLE; an
    interface taken down sends NEIGHBOR_DOWN at once and the far side
    times out."""

    def scenario(h, package):
        two_nodes(h, package)
        h.fabric.disconnect("node1", "if1", "node2", "if2")
        h.wait_event("node1", "NEIGHBOR_DOWN")
        h.wait_event("node2", "NEIGHBOR_DOWN")
        hold = (h.state("node1", "if1", "node2"), h.state("node2", "if2", "node1"))
        h.fabric.connect("node1", "if1", "node2", "if2")
        h.wait_event("node1", "NEIGHBOR_UP", count=2)
        h.wait_event("node2", "NEIGHBOR_UP", count=2)
        h.if_queues["node1"].push(h.pkgs["node1"].T.InterfaceDatabase(this_node_name="node1"))
        h.wait_event("node1", "NEIGHBOR_DOWN", count=2)
        h.wait_event("node2", "NEIGHBOR_DOWN", count=2)
        return {"hold": hold, **{n: h.drain(n) for n in ("node1", "node2")}}

    rec = in_both(scenario)
    assert rec["hold"] == ("IDLE", "IDLE")
    assert [e[0] for e in rec["node1"]] == ["NEIGHBOR_UP", "NEIGHBOR_DOWN"] * 2


def test_graceful_restart_and_expiry():
    """node1 announces a restart: node2 goes RESTART and back to
    ESTABLISHED (NEIGHBOR_RESTARTED) once node1 stops announcing it;
    a second restart with the link cut expires to NEIGHBOR_DOWN."""

    def scenario(h, package):
        two_nodes(h, package)
        n1 = h.nodes["node1"]
        n1.flood_restarting_msg()
        h.wait_event("node2", "NEIGHBOR_RESTARTING")
        restarting = h.state("node2", "if2", "node1")
        n1.run_in_event_base_thread(lambda: setattr(n1, "_restarting", False)).result()
        h.wait_event("node2", "NEIGHBOR_RESTARTED")
        restarted = h.state("node2", "if2", "node1")
        n1.flood_restarting_msg()
        h.wait_event("node2", "NEIGHBOR_RESTARTING", count=2)
        h.fabric.disconnect("node1", "if1", "node2", "if2")
        h.wait_event("node2", "NEIGHBOR_DOWN")
        return {"states": (restarting, restarted), "node2": h.drain("node2")}

    rec = in_both(scenario)
    assert rec["states"] == ("RESTART", "ESTABLISHED")
    assert [e[0] for e in rec["node2"]] == [
        "NEIGHBOR_UP", "NEIGHBOR_RESTARTING", "NEIGHBOR_RESTARTED",
        "NEIGHBOR_RESTARTING", "NEIGHBOR_DOWN",
    ]


def test_area_negotiation():
    """Matching area configs establish in that area; mismatched ones stay
    WARM or NEGOTIATE with no event; a foreign domain is ignored."""

    def scenario(h, package):
        AreaConfig = P[package].spark.AreaConfig
        h.add_node("a1", package, areas=[AreaConfig("7", [".*"], ["b1"])])
        h.add_node("b1", package, areas=[AreaConfig("7", [".*"], ["a1"])])
        h.add_node("m1", package, areas=[AreaConfig("1", [".*"], ["m2"])])
        h.add_node("m2", package, areas=[AreaConfig("2", [".*"], ["m1"])])
        h.add_node("d1", package, domain="d1")
        h.add_node("d2", package, domain="d2")
        for x, y in (("a1", "b1"), ("m1", "m2"), ("d1", "d2")):
            h.fabric.connect(x, "if", y, "if")
            h.bring_up(x, "if")
            h.bring_up(y, "if")
        h.wait_event("a1", "NEIGHBOR_UP")
        assert wait_for(lambda: h.state("m1", "if", "m2") in ("WARM", "NEGOTIATE"))
        time.sleep(0.5)
        return {
            "a1": h.drain("a1"),
            "mismatch": (h.state("m1", "if", "m2") in ("WARM", "NEGOTIATE"), h.drain("m1")),
            "domain": (h.state("d1", "if", "d2"), h.drain("d1")),
        }

    rec = in_both(scenario)
    assert rec["a1"] == [("NEIGHBOR_UP", "b1", "if", "7", "fe80::b1")]
    assert rec["mismatch"] == (True, [])
    assert rec["domain"] == (None, [])


def test_rtt_measured_with_latency():
    """25 ms one way gives an RTT between 30 and 200 ms in each package
    (the reference test's bounds; the values themselves are timings)."""

    def scenario(h, package):
        two_nodes(h, package, latency_s=0.025)
        rtt = []
        assert wait_for(
            lambda: (nb := h.nodes["node1"].get_neighbors())
            and nb[0].rtt_latest_us > 0 and not rtt.append(nb[0].rtt_latest_us)
        )
        return 30_000 <= rtt[0] <= 200_000

    assert in_both(scenario) is True


@pytest.mark.parametrize("port_first", [True, False])
def test_port_and_reference_spark_interoperate(port_first):
    """A port Spark and a reference Spark on one fabric establish an
    adjacency both ways, so each reads the other's SparkPacket bytes;
    every packet the port sent is read by the reference's `loads` into
    the counterpart object and written back to the same bytes."""
    h = Harness("port" if port_first else "ref")
    try:
        h.add_node("p", "port")
        h.add_node("r", "ref")
        h.fabric.connect("p", "if1", "r", "if2")
        h.bring_up("p", "if1")
        h.bring_up("r", "if2")
        h.wait_event("p", "NEIGHBOR_UP")
        h.wait_event("r", "NEIGHBOR_UP")
        assert h.state("p", "if1", "r") == "ESTABLISHED"
        assert h.state("r", "if2", "p") == "ESTABLISHED"
        kinds = set()
        for data in list(h.sent["p"]):
            packet = P["port"].ser.loads(data)
            ref = P["ref"].ser.loads(data)
            assert ref == to_ref(packet)
            assert P["ref"].ser.dumps(ref) == data
            kinds |= {k for k in ("hello", "handshake", "heartbeat") if getattr(packet, k)}
        assert kinds == {"hello", "handshake", "heartbeat"}
    finally:
        h.stop()


def test_udp_io_provider_over_veth_with_kernel_timestamps():
    """tests/test_spark.py's real-UDP case on the port's Spark and
    UdpIoProvider: discovery over a veth pair through the IPv6 DAD
    window, and an RTT from kernel SO_TIMESTAMPNS stamps."""
    import subprocess
    import uuid

    from tests.test_netlink import NET_ADMIN

    if not NET_ADMIN:
        pytest.skip("needs NET_ADMIN (veth creation)")
    p = P["port"]
    name = f"tu{uuid.uuid4().hex[:8]}"
    peer = f"{name}p"
    subprocess.run(["ip", "link", "add", name, "type", "veth", "peer", "name", peer], check=True)
    sparks, queues, reader = [], [], None
    try:
        for dev in (name, peer):
            subprocess.run(["ip", "link", "set", dev, "up"], check=True)
        for node, ifn in (("udp-a", name), ("udp-b", peer)):
            ifq, nbrq = p.ReplicateQueue(), p.ReplicateQueue()
            if node == "udp-a":
                reader = nbrq.get_reader()
            s = p.spark.Spark(
                node, ifq.get_reader(), nbrq,
                io_provider=p.spark.UdpIoProvider(port=16662), config=fast_cfg(p),
            )
            s.run()
            ifq.push(p.T.InterfaceDatabase(node, {ifn: p.T.InterfaceInfo(ifn, True, 1)}))
            sparks.append(s)
            queues += [ifq, nbrq]
        up = False
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not up:
            try:
                up = reader.get(timeout=1).event_type == p.T.NeighborEventType.NEIGHBOR_UP
            except Exception:
                pass
        assert up, "discovery did not converge over real UDP"
        rtt = []
        assert wait_for(
            lambda: (nb := sparks[0].get_neighbors()) and nb[0].rtt_latest_us > 0
            and not rtt.append(nb[0].rtt_latest_us)
        )
        assert 0 < rtt[0] < 100_000
    finally:
        for q in queues:
            q.close()
        for s in sparks:
            s.stop()
        for s in sparks:
            s.wait_until_stopped(5)
        subprocess.run(["ip", "link", "del", name], capture_output=True)
