"""The port's Decision module against `openr_tpu`'s, on the CPU.

Each scenario of tests/test_decision.py drives the same publication
bytes (serialized with the port's `dumps`, which gives the reference's
bytes) into the port's Decision on `device="cpu"` (its DeviceSpfBackend)
and into the reference's Decision (its host Dijkstra), and compares every
emitted DecisionRouteUpdate, normalized by `torch_parity`; routes are
integers, so there is no tolerance.  Also: static routes through the
static-routes queue, ordered-FIB holds driven by Decision's own timer,
the fleet dump of a banded fixture, and a rebuild exception that must
count and raise, never demote to the host backend.
"""

from __future__ import annotations

import dataclasses
import time

import pytest

from openr_tpu.decision.decision import Decision as JDecision
from openr_tpu.decision.rib_policy import PolicyError as JPolicyError
from openr_tpu.runtime.queue import ReplicateQueue as JReplicateQueue
from openr_tpu_torch import types as pt
from openr_tpu_torch.decision.decision import Decision
from openr_tpu_torch.decision.rib import (
    DecisionRouteUpdate,
    RibMplsEntry,
    RibUnicastEntry,
)
from openr_tpu_torch.decision.rib_policy import (
    PolicyError,
    RibPolicyConfig,
    RibPolicyStatementConfig,
    RibRouteActionWeight,
)
from openr_tpu_torch.decision.spf_solver import DeviceSpfBackend
from openr_tpu_torch.runtime.queue import ReplicateQueue
from openr_tpu_torch.serializer import dumps
from openr_tpu_torch.utils import topo
from torch_parity import normalized_routes, normalized_update, to_ref

PFX1 = "::1:0/112"
PFX2 = "::2:0/112"
DEBOUNCE = dict(debounce_min_s=0.005, debounce_max_s=0.02)


def adj(me: str, other: str, metric: int = 10) -> pt.Adjacency:
    return pt.Adjacency(
        other_node_name=other,
        if_name=f"{me}/{other}",
        other_if_name=f"{other}/{me}",
        metric=metric,
        next_hop_v6=f"fe80::{other}",
    )


def adj_val(node, adjs, version=1, label=0, **kw) -> pt.Value:
    db = pt.AdjacencyDatabase(
        this_node_name=node, adjacencies=adjs, node_label=label, **kw
    )
    return pt.Value(version=version, originator_id=node, value=dumps(db))


def prefix_val(node, prefix, version=1, entry=None, **kw):
    db = pt.PrefixDatabase(
        this_node_name=node, prefix_entries=[entry or pt.PrefixEntry(prefix)], **kw
    )
    return pt.prefix_key(node, prefix, "0"), pt.Value(
        version=version, originator_id=node, value=dumps(db)
    )


def square_publication() -> pt.Publication:
    kv = {
        pt.adj_key("1"): adj_val("1", [adj("1", "2"), adj("1", "3")], label=101),
        pt.adj_key("2"): adj_val("2", [adj("2", "1"), adj("2", "4")], label=102),
        pt.adj_key("3"): adj_val("3", [adj("3", "1"), adj("3", "4")], label=103),
        pt.adj_key("4"): adj_val("4", [adj("4", "2"), adj("4", "3")], label=104),
    }
    k, v = prefix_val("4", PFX1)
    kv[k] = v
    return pt.Publication(key_vals=kv, area="0")


class DecisionPair:
    """The port's Decision (device="cpu") and the reference's, each with
    its own queues; `push` hands both the same publication bytes."""

    def __init__(self, my_node: str = "1", with_static: bool = True, **kw) -> None:
        self.sides = {}
        for name, cls, queue, extra in (
            ("port", Decision, ReplicateQueue, {"device": "cpu"}),
            ("ref", JDecision, JReplicateQueue, {}),
        ):
            kvq, staticq, routeq = queue(), queue(), queue()
            reader = routeq.get_reader()
            decision = cls(
                my_node,
                kvq.get_reader(),
                staticq.get_reader() if with_static else None,
                routeq,
                **DEBOUNCE,
                **kw,
                **extra,
            )
            self.sides[name] = (kvq, staticq, routeq, reader, decision)

    @property
    def port(self) -> Decision:
        return self.sides["port"][4]

    @property
    def ref(self) -> JDecision:
        return self.sides["ref"][4]

    def run(self) -> "DecisionPair":
        for side in self.sides.values():
            side[4].run()
        return self

    def push(self, pub: pt.Publication) -> None:
        self.sides["port"][0].push(pub)
        self.sides["ref"][0].push(to_ref(pub))

    def push_static(self, update: DecisionRouteUpdate) -> None:
        self.sides["port"][1].push(update)
        self.sides["ref"][1].push(to_ref(update))

    def update(self, timeout: float = 5.0):
        """The next update of both, held equal; the port's is returned."""
        got = self.sides["port"][3].get(timeout=timeout)
        want = self.sides["ref"][3].get(timeout=timeout)
        assert normalized_update(got) == normalized_update(want)
        return got

    def call(self, fn):
        """`fn(decision)` on both, results held equal when not None."""
        got, want = fn(self.port), fn(self.ref)
        return got, want

    def close(self) -> None:
        for kvq, staticq, routeq, _reader, decision in self.sides.values():
            kvq.close()
            staticq.close()
            routeq.close()
            decision.stop()
            decision.wait_until_stopped(5)


@pytest.fixture
def pair():
    p = DecisionPair(enable_rib_policy=True).run()
    yield p
    p.close()


def nh_names(route) -> set:
    return {nh.neighbor_node_name for nh in route.nexthops}


def test_initial_convergence_and_incremental(pair):
    pair.push(square_publication())
    update = pair.update()
    assert nh_names(update.unicast_routes_to_update[PFX1]) == {"2", "3"}
    assert {e.label for e in update.mpls_routes_to_update} == {101, 102, 103, 104}
    names = [e.event_name for e in update.perf_events.events]
    assert "DECISION_RECEIVED" in names and "ROUTE_UPDATE" in names
    k, v = prefix_val("2", PFX2)
    pair.push(pt.Publication(key_vals={k: v}, area="0"))
    update = pair.update()
    assert set(update.unicast_routes_to_update) == {PFX2}
    assert not update.mpls_routes_to_update
    # the card backend served the build: one query
    assert pair.port.spf_solver.engine.get_counters()["device.engine.queries"] == 1


@pytest.mark.parametrize(
    "name, pub, check",
    [
        (
            "prefix_withdrawal_via_expired_key",
            pt.Publication(expired_keys=[pt.prefix_key("4", PFX1, "0")], area="0"),
            lambda u: u.unicast_routes_to_delete == [PFX1],
        ),
        (
            "adj_expiry_full_rebuild",
            pt.Publication(expired_keys=[pt.adj_key("2")], area="0"),
            lambda u: nh_names(u.unicast_routes_to_update[PFX1]) == {"3"}
            and 102 in u.mpls_routes_to_delete,
        ),
        (
            "metric_change_reroutes",
            pt.Publication(
                key_vals={
                    pt.adj_key("1"): adj_val(
                        "1", [adj("1", "2", metric=100), adj("1", "3")], 2, 101
                    )
                },
                area="0",
            ),
            lambda u: nh_names(u.unicast_routes_to_update[PFX1]) == {"3"},
        ),
        (
            "prefix_withdrawal_via_delete_flag",
            pt.Publication(
                key_vals=dict([prefix_val("4", PFX1, 2, delete_prefix=True)]),
                area="0",
            ),
            lambda u: u.unicast_routes_to_delete == [PFX1],
        ),
    ],
)
def test_change_after_convergence(pair, name, pub, check):
    pair.push(square_publication())
    pair.update()
    pair.push(pub)
    assert check(pair.update()), name


def test_rib_policy_reweights(pair):
    pair.push(square_publication())
    pair.update()
    cfg = RibPolicyConfig(
        statements=[
            RibPolicyStatementConfig(
                name="t",
                prefixes=[PFX1],
                set_weight=RibRouteActionWeight(
                    default_weight=1, neighbor_to_weight={"2": 7}
                ),
            )
        ],
        ttl_secs=60,
    )
    pair.port.set_rib_policy(cfg)
    pair.ref.set_rib_policy(to_ref(cfg))
    route = pair.update().unicast_routes_to_update[PFX1]
    assert {nh.neighbor_node_name: nh.weight for nh in route.nexthops} == {"2": 7, "3": 1}
    got, want = pair.call(lambda d: d.get_rib_policy())
    assert got.statements[0].prefixes == want.statements[0].prefixes == [PFX1]
    assert 0 < got.ttl_secs <= 60
    pair.port.clear_rib_policy()
    pair.ref.clear_rib_policy()
    route = pair.update().unicast_routes_to_update[PFX1]
    assert {nh.weight for nh in route.nexthops} == {0}
    for d, error in ((pair.port, PolicyError), (pair.ref, JPolicyError)):
        with pytest.raises(error, match="No RIB policy"):
            d.get_rib_policy()


def test_rib_policy_disabled_raises():
    p = DecisionPair(with_static=False).run()
    try:
        for d, error in ((p.port, PolicyError), (p.ref, JPolicyError)):
            with pytest.raises(error, match="not enabled"):
                d.get_rib_policy()
    finally:
        p.close()


def test_cold_start_holds_updates():
    p = DecisionPair(with_static=False, eor_time_s=0.2).run()
    try:
        t0 = time.monotonic()
        p.push(square_publication())
        update = p.update(timeout=5)
        assert time.monotonic() - t0 >= 0.15
        assert PFX1 in update.unicast_routes_to_update
        assert "COLD_START_UPDATE" in [e.event_name for e in update.perf_events.events]
    finally:
        p.close()


def test_get_route_db_source_parameterized(pair):
    pair.push(square_publication())
    pair.update()
    for node in ("1", "3", "nope"):
        got, want = pair.call(lambda d: d.get_route_db(node))
        assert normalized_routes(got) == normalized_routes(want), node
    got, want = pair.call(lambda d: d.get_adjacency_databases())
    assert sorted(db.this_node_name for db in got) == ["1", "2", "3", "4"]
    assert [to_ref(db) for db in got] == want
    got, want = pair.call(lambda d: d.get_received_routes(prefixes=[PFX1]))
    assert to_ref(got) == want


def test_self_redistribution_ignored(pair):
    pair.push(square_publication())
    pair.update()
    k, v = prefix_val(
        "1", PFX2, entry=pt.PrefixEntry(prefix=PFX2, area_stack=("0",))
    )
    pair.push(pt.Publication(key_vals={k: v}, area="0"))
    pfx3 = "::3:0/112"
    k3, v3 = prefix_val("2", pfx3)
    pair.push(pt.Publication(key_vals={k3: v3}, area="0"))
    assert pfx3 in pair.update().unicast_routes_to_update
    got, want = pair.call(
        lambda d: d.run_in_event_base_thread(
            lambda: set(d.prefix_state.prefixes)
        ).result()
    )
    assert got == want and PFX2 not in got


@pytest.mark.parametrize("kind", ["irrelevant", "duplicate"])
def test_no_rebuild_on_no_op_publication(pair, kind):
    """Ancestors: NoSpfOnIrrelevantPublication / NoSpfOnDuplicatePublication
    (DecisionTest.cpp:6179, :6212): the next update after the no-op
    publication is a later sentinel's alone."""
    pair.push(square_publication())
    pair.update()
    before = [d.counters.get("decision.adj_db_update", 0) for d in (pair.port, pair.ref)]
    if kind == "irrelevant":
        pair.push(
            pt.Publication(
                key_vals={
                    "adj2:1": adj_val("1", [adj("1", "2")]),
                    "adji2:2": adj_val("2", [adj("2", "1")]),
                },
                area="0",
            )
        )
    else:
        pair.push(square_publication())
    k, v = prefix_val("3", PFX2)
    pair.push(pt.Publication(key_vals={k: v}, area="0"))
    assert list(pair.update().unicast_routes_to_update) == [PFX2]
    after = [d.counters.get("decision.adj_db_update", 0) for d in (pair.port, pair.ref)]
    added = 0 if kind == "irrelevant" else 4
    assert after == [b + added for b in before]


def test_static_routes_queue(pair):
    pair.push(square_publication())
    pair.update()
    nh = pt.NextHop(address="fe80::9", if_name="static0")
    static = DecisionRouteUpdate()
    static.add_route_to_update(
        RibUnicastEntry(prefix="::9:0/112", nexthops=frozenset({nh}))
    )
    # a computed route wins over a static one for the same prefix
    static.add_route_to_update(
        RibUnicastEntry(prefix=PFX1, nexthops=frozenset({nh}))
    )
    static.mpls_routes_to_update.append(
        RibMplsEntry(label=60000, nexthops=frozenset({nh}))
    )
    pair.push_static(static)
    update = pair.update()
    assert "::9:0/112" in update.unicast_routes_to_update
    assert [e.label for e in update.mpls_routes_to_update] == [60000]
    delete = DecisionRouteUpdate(
        unicast_routes_to_delete=["::9:0/112"], mpls_routes_to_delete=[60000]
    )
    pair.push_static(delete)
    update = pair.update()
    assert update.unicast_routes_to_delete == ["::9:0/112"]
    assert update.mpls_routes_to_delete == [60000]
    # a withdrawn computed prefix falls back to its static route
    pair.push_static(static)
    pair.update()
    pair.push(pt.Publication(expired_keys=[pt.prefix_key("4", PFX1, "0")], area="0"))
    route = pair.update().unicast_routes_to_update[PFX1]
    assert route.nexthops == frozenset({nh})


def test_ordered_fib_holds_through_decision():
    """With ordered FIB, this router's own metric raise is held for its
    hold-down TTL (max hops to it, 2 on the square); Decision's timer,
    one FIB time (fibTime:1, 200 ms) per step, decrements the holds and
    rebuilds once they expire (reference: decrementOrderedFibHolds,
    Decision.cpp:1938-1955)."""
    p = DecisionPair(with_static=False, enable_ordered_fib=True).run()
    try:
        p.push(square_publication())
        p.update()
        t0 = time.monotonic()
        p.push(
            pt.Publication(
                key_vals={
                    "fibTime:1": pt.Value(1, "1", value=b"200"),
                    pt.adj_key("1"): adj_val(
                        "1", [adj("1", "2", metric=50), adj("1", "3")], 2, 101
                    ),
                },
                area="0",
            )
        )
        time.sleep(0.03)
        held, held_ref = p.call(lambda d: d.get_route_db())
        assert normalized_routes(held) == normalized_routes(held_ref)
        assert nh_names(held.unicast_routes[PFX1]) == {"2", "3"}
        update = p.update()
        assert time.monotonic() - t0 >= 0.35  # two decrements of 200 ms
        assert nh_names(update.unicast_routes_to_update[PFX1]) == {"3"}
        got, want = p.call(
            lambda d: d.run_in_event_base_thread(
                lambda: d.area_link_states["0"].has_holds()
            ).result()
        )
        assert got is want is False
    finally:
        p.close()


def test_fleet_dump_of_banded_fixture():
    """get_fleet_route_dbs on a 65-ring (banded at N >= 64): the port's
    fleet product against the reference's, for every node."""
    p = DecisionPair(with_static=False).run()
    try:
        dbs = topo.ring_topology(65)
        kv = {pt.adj_key(db.this_node_name): pt.Value(1, db.this_node_name, dumps(db)) for db in dbs}
        for i in range(0, 65, 8):
            k, v = prefix_val(f"r{i}", f"fc00:{i:x}::/64")
            kv[k] = v
        p.push(pt.Publication(key_vals=kv, area="0"))
        p.update()
        nodes = [f"r{i}" for i in range(0, 65, 4)]
        got, want = p.call(lambda d: d.get_fleet_route_dbs(nodes=nodes))
        assert sorted(got) == sorted(want) == sorted(nodes)
        for node in nodes:
            assert normalized_routes(got[node]) == normalized_routes(want[node]), node
        view = p.port.spf_solver.fleet._views[p.port.area_link_states["0"]]
        assert view._runner.bg is not None  # the banded path
        with pytest.raises(ValueError, match="exceeds"):
            p.port.get_fleet_route_dbs(nodes=["r0"] * (Decision.MAX_FLEET_DUMP_NODES + 1))
    finally:
        p.close()


def test_rebuild_exception_counts_and_raises_without_demotion(pair):
    """A failing route build is logged, counted as
    decision.route_rebuild_failures and raised; the solver keeps its
    device backend and the pending updates, so the next rebuild emits
    the routes."""
    pair.push(square_publication())
    pair.update()
    solver = pair.port.spf_solver
    backend = solver.spf
    real = solver.build_route_db
    calls = []

    def failing(*args, **kwargs):
        calls.append(1)
        raise RuntimeError("device lost")

    solver.build_route_db = failing
    pair.push(
        pt.Publication(
            key_vals={pt.adj_key("1"): adj_val("1", [adj("1", "2", 100), adj("1", "3")], 2, 101)},
            area="0",
        )
    )
    want = pair.sides["ref"][3].get(timeout=5)
    deadline = time.monotonic() + 5
    failures = pair.port.get_counters
    while (
        failures()["decision.route_rebuild_failures"] < 1
        and time.monotonic() < deadline
    ):
        time.sleep(0.01)
    assert calls == [1]
    assert failures()["decision.route_rebuild_failures"] == 1
    assert "decision.route_rebuild_fallbacks" not in pair.port.get_counters()
    assert solver.spf is backend and isinstance(backend, DeviceSpfBackend)
    assert pair.port.pending_updates.needs_full_rebuild
    # a rebuild called through the control API raises to its caller
    cfg = RibPolicyConfig(
        statements=[
            RibPolicyStatementConfig(
                name="t", prefixes=[PFX1], set_weight=RibRouteActionWeight(1)
            )
        ],
        ttl_secs=60,
    )
    pair.port._enable_rib_policy = True
    with pytest.raises(RuntimeError, match="device lost"):
        pair.port.set_rib_policy(cfg)
    assert pair.port.get_counters()["decision.route_rebuild_failures"] == 2
    pair.port.run_in_event_base_thread(lambda: setattr(pair.port, "rib_policy", None)).result()
    solver.build_route_db = real
    pair.port.run_in_event_base_thread(
        lambda: pair.port.rebuild_routes("RETRY")
    ).result()
    got = pair.sides["port"][3].get(timeout=5)
    assert normalized_update(got) == normalized_update(want)


def test_protection_queries_equal_reference(pair):
    """`what_if` and `get_ti_lfa` of the port's Decision equal the
    reference's on the converged square."""
    pair.push(square_publication())
    pair.update()
    scenarios = [[("1", "2")], [("1", "2"), ("1", "3")], [("1", "9")]]
    got, want = pair.call(lambda d: d.what_if(scenarios))
    assert got == want
    assert got[1]["newly_unreachable_pairs"] == 3
    got, want = pair.call(lambda d: d.get_ti_lfa())
    assert got == want and len(got["adjacencies"]) == 2


def test_pending_event_hint_across_a_publication():
    """Reference: Decision.pending_event_hint (decision.py:176-181): a
    publication that needs a route update raises the hint until the
    debounced rebuild folds it in, in both packages."""
    pair = DecisionPair(with_static=False)
    for side in pair.sides.values():
        # a debounce long enough to read the raised hint
        side[4]._debounce_bounds = (0.3, 0.5)
    pair.run()
    try:
        before = [d.pending_event_hint() for d in (pair.port, pair.ref)]
        pair.push(square_publication())
        seen = []
        for d in (pair.port, pair.ref):
            deadline = time.monotonic() + 5
            while d.pending_event_hint() == 0 and time.monotonic() < deadline:
                time.sleep(0.005)
            seen.append(d.pending_event_hint())
        pair.update()
        after = [d.pending_event_hint() for d in (pair.port, pair.ref)]
        assert (before, seen, after) == ([0, 0], [1, 1], [0, 0])
    finally:
        pair.close()
