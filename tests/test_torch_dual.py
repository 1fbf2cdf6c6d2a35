"""The port's DUAL (`openr_tpu_torch.kvstore.dual`) against `openr_tpu`'s.

The scenarios of `tests/test_dual.py` (its graphs, costs, flaps and
random seeds) run through both packages' `DualNode`s over the same
queued message fabric.  After every event the fabric is pumped to
quiescence; each package's run records every delivered `DualMessages`
as `serializer.dumps` bytes, every nexthop change, and a snapshot of
every node per root (state, distance, report and feasible distance,
nexthop, children, SPT peers, per-neighbor counters) and its packet
counters.  The two records must be equal, and the port's SPTs must be
the shortest-path trees of the graph.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import random
from collections import deque

import numpy as np
import pytest

from openr_tpu import serializer as jser
from openr_tpu.kvstore import dual as jdual
from openr_tpu_torch import serializer as pser
from openr_tpu_torch.kvstore import dual as pdual

PACKAGES = {"port": (pdual, pser), "ref": (jdual, jser)}


class Fabric:
    """Queued delivery between one package's DualNodes, recording what
    went over the wire (the reference test's DualBaseFixture)."""

    def __init__(self, package: str) -> None:
        self.dual, self.ser = PACKAGES[package]
        self.nodes = {}
        self.queue: deque = deque()
        self.links: dict[frozenset, int] = {}
        self.trace: list = []

    def add_node(self, node_id: str, is_root: bool = False):
        def send(neighbor, msgs, me=node_id):
            self.queue.append((neighbor, msgs))
            self.trace.append(("msg", me, neighbor, self.ser.dumps(msgs)))
            return True

        def nexthop(root, old, new, me=node_id):
            self.trace.append(("nh", me, root, old, new))

        self.nodes[node_id] = self.dual.DualNode(
            node_id, is_root, send_dual_messages=send, process_nexthop_change=nexthop
        )

    def link_up(self, a, b, cost=1):
        self.links[frozenset((a, b))] = cost
        self.nodes[a].peer_up(b, cost)
        self.nodes[b].peer_up(a, cost)
        self.pump()

    def link_down(self, a, b):
        self.links.pop(frozenset((a, b)), None)
        self.nodes[a].peer_down(b)
        self.nodes[b].peer_down(a)
        self.pump()

    def cost_change(self, a, b, cost):
        self.links[frozenset((a, b))] = cost
        self.nodes[a].peer_cost_change(b, cost)
        self.nodes[b].peer_cost_change(a, cost)
        self.pump()

    def pump(self):
        n = 0
        while self.queue:
            dst, msgs = self.queue.popleft()
            self.nodes[dst].process_dual_messages(msgs)
            n += 1
            assert n < 100_000, "dual did not converge"
        self.trace.append(("snapshot", self.snapshot()))
        self.validate()

    def snapshot(self) -> dict:
        out = {}
        for name, node in sorted(self.nodes.items()):
            roots = {}
            for root, dual in sorted(node.duals.items()):
                info = dual.info
                roots[root] = (
                    info.sm.state.name,
                    info.distance,
                    info.report_distance,
                    info.feasible_distance,
                    info.nexthop,
                    sorted(dual.children()),
                    sorted(node.get_spt_peers(root)),
                    sorted(
                        (nbr, dataclasses.astuple(c))
                        for nbr, c in dual.counters.items()
                    ),
                    dual.status_string(),
                )
            out[name] = (
                node.get_spt_root_id(),
                roots,
                sorted((k, sorted(v.items())) for k, v in node.pkt_counters.items()),
            )
        return out

    def dijkstra(self, src):
        inf = self.dual.INFINITY64
        dist = {src: 0}
        heap = [(0, src)]
        while heap:
            d, u = heapq.heappop(heap)
            if d > dist.get(u, inf):
                continue
            for key, cost in self.links.items():
                if u in key:
                    (v,) = key - {u} or {u}
                    if d + cost < dist.get(v, inf):
                        dist[v] = d + cost
                        heapq.heappush(heap, (d + cost, v))
        return dist

    def validate(self):
        """Reference: DualBaseFixture::validate — per root, every node
        that knows the root passive at its shortest distance, parents along live links whose
        costs add up, and the parent edges a tree."""
        inf = self.dual.INFINITY64
        roots = {n.node_id for n in self.nodes.values() if n.is_root}
        if not roots:
            assert all(n.get_spt_root_id() is None for n in self.nodes.values())
            return
        for root in roots:
            expected = self.dijkstra(root)
            edges = set()
            for node in self.nodes.values():
                info = node.get_info(root)
                exp = expected.get(node.node_id, inf)
                if info is None:
                    # a node not yet linked to the root's component
                    assert exp == inf, (root, node.node_id)
                    continue
                assert info.sm.state.name == "PASSIVE", (root, node.node_id)
                assert info.distance == exp, (root, node.node_id)
                if node.node_id == root or exp == inf:
                    continue
                cost = self.links.get(frozenset((node.node_id, info.nexthop)))
                assert cost is not None and expected[info.nexthop] + cost == exp
                edges.add((node.node_id, info.nexthop))
            reachable = [n for n in self.nodes if expected.get(n, inf) < inf]
            assert len(edges) == len(reachable) - 1


def both(scenario) -> list:
    """Run `scenario(fabric)` in each package; the records must agree."""
    traces = {}
    for package in PACKAGES:
        fabric = Fabric(package)
        scenario(fabric)
        traces[package] = fabric.trace
    assert traces["port"] == traces["ref"]
    return traces["port"]


@pytest.mark.parametrize(
    "state,event,fc",
    list(itertools.product(range(5), range(4), (False, True))),
)
def test_state_machine_table(state, event, fc):
    """Reference: TEST(Dual, StateMachine), every (state, event, fc)."""
    results = []
    for mod in (pdual, jdual):
        sm = mod.DualStateMachine()
        sm.state = mod.DualState(state)
        sm.process_event(mod.DualEvent(event), fc)
        results.append(sm.state.value)
    assert results[0] == results[1]


def _two_nodes(f):
    f.add_node("n0", is_root=True)
    f.add_node("n1")
    f.link_up("n0", "n1")


def _no_root(f):
    f.add_node("n0")
    f.add_node("n1")
    f.link_up("n0", "n1")


def _ring(f, n=6):
    f.add_node("n0", is_root=True)
    for i in range(1, n):
        f.add_node(f"n{i}")
    for i in range(n):
        f.link_up(f"n{i}", f"n{(i + 1) % n}")
    for i in range(n):
        a, b = f"n{i}", f"n{(i + 1) % n}"
        f.link_down(a, b)
        f.link_up(a, b)


def _star(f):
    f.add_node("hub", is_root=True)
    for i in range(5):
        f.add_node(f"leaf{i}")
        f.link_up("hub", f"leaf{i}")
    f.link_down("hub", "leaf2")


def _multiple_roots(f):
    f.add_node("a", is_root=True)
    f.add_node("b", is_root=True)
    f.add_node("c")
    f.link_up("a", "b")
    f.link_up("b", "c")
    f.link_down("a", "b")


def _cost_changes(f):
    f.add_node("r", is_root=True)
    f.add_node("a")
    f.add_node("b")
    f.link_up("r", "a", cost=1)
    f.link_up("r", "b", cost=10)
    f.link_up("a", "b", cost=1)
    f.cost_change("a", "b", 20)
    f.cost_change("r", "b", 1)


def _spt_peers(f):
    f.add_node("r", is_root=True)
    f.add_node("a")
    f.add_node("b")
    f.link_up("r", "a")
    f.link_up("a", "b")
    for node_id in ("a", "b"):
        info = f.nodes[node_id].get_info("r")
        f.nodes[info.nexthop].get_dual("r").add_child(node_id)
    f.pump()


SCENARIOS = {
    "two_nodes": _two_nodes,
    "no_root": _no_root,
    "ring": _ring,
    "star": _star,
    "multiple_roots": _multiple_roots,
    "cost_changes": _cost_changes,
    "spt_peers": _spt_peers,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenarios_of_the_reference_tests(name):
    trace = both(SCENARIOS[name])
    assert trace and trace[-1][0] == "snapshot"


def test_reference_outcomes_hold_in_the_port():
    """The reference tests' own assertions, on the port's nodes."""
    f = Fabric("port")
    _multiple_roots(f)
    assert f.nodes["c"].get_spt_root_id() == "b"
    f = Fabric("port")
    _star(f)
    assert f.nodes["leaf2"].get_info("hub").distance == pdual.INFINITY64
    f = Fabric("port")
    _cost_changes(f)
    assert f.nodes["b"].get_info("r").distance == 1
    f = Fabric("port")
    _spt_peers(f)
    assert f.nodes["r"].get_dual("r").spt_peers() == {"a", "r"}
    assert f.nodes["a"].get_dual("r").spt_peers() == {"r", "b"}
    assert f.nodes["b"].get_dual("r").spt_peers() == {"a"}


def _random_graph(f, rng, n=8, extra=4, roots=("n0",)):
    """The reference's random graph: a random spanning tree plus extra
    edges, every edge then flapped down and up."""
    for i in range(n):
        f.add_node(f"n{i}", is_root=f"n{i}" in roots)
    edges = []
    for i in range(1, n):
        edges.append((f"n{i}", f"n{rng.randrange(i)}", rng.randint(1, 5)))
    for _ in range(extra):
        a, b = rng.sample(range(n), 2)
        if frozenset((f"n{a}", f"n{b}")) not in {frozenset((x, y)) for x, y, _ in edges}:
            edges.append((f"n{a}", f"n{b}", rng.randint(1, 5)))
    for a, b, c in edges:
        f.link_up(a, b, c)
    for a, b, c in edges:
        f.link_down(a, b)
        f.link_up(a, b, c)


def test_random_graphs_with_flaps_seed_of_the_reference():
    """tests/test_dual.py's three trials from random.Random(7), run as
    one stream in each package."""

    def scenario(f):
        rng = random.Random(7)
        for _ in range(3):
            sub = Fabric("port" if f.dual is pdual else "ref")
            _random_graph(sub, rng)
            f.trace.extend(sub.trace)

    trace = both(scenario)
    assert sum(1 for t in trace if t[0] == "msg") > 0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_graphs_several_roots(seed):
    """Seeded (numpy) graphs of 10 nodes with three flood roots: per root
    the same parents, distances and message counts in both packages."""
    picks = np.random.default_rng(seed).choice(10, size=3, replace=False)
    roots = tuple(f"n{i}" for i in sorted(picks))
    trace = both(
        lambda f: _random_graph(f, random.Random(seed), n=10, extra=6, roots=roots)
    )
    assert {spt_root for spt_root, _, _ in trace[-1][1].values()} == {roots[0]}
