"""The port's route deltas, static and adjacency-label routes, prepend
labels, ordered-FIB holds and RibPolicy against `openr_tpu`'s, on the
CPU.

The cases are those of tests/test_spf_solver.py (TestStaticRoutes,
TestRouteDelta, TestSrMpls::test_adjacency_label_routes) and of
tests/test_decision_golden.py (TestOrderedFibHolds less its KSP2 case,
TestPrependLabels, TestRibPolicyInteractions,
TestRibPolicyAreaInteractions).  The port's solver runs on its default
DeviceSpfBackend with `device="cpu"`; the reference's on its host
Dijkstra.  Route DBs and deltas are compared after `torch_parity`'s
normalization, with no tolerance.
"""

from __future__ import annotations

import copy
import dataclasses

import pytest

from openr_tpu.decision.link_state import LinkState as JLinkState
from openr_tpu.decision.prefix_state import PrefixState as JPrefixState
from openr_tpu.decision.rib_policy import PolicyError as JPolicyError
from openr_tpu.decision.rib_policy import RibPolicy as JRibPolicy
from openr_tpu.decision.spf_solver import SpfSolver as JSpfSolver
from openr_tpu_torch import types as pt
from openr_tpu_torch.decision.link_state import LinkState
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.decision.rib import DecisionRouteDb
from openr_tpu_torch.decision.rib_policy import (
    PolicyError,
    RibPolicy,
    RibPolicyConfig,
    RibPolicyStatementConfig,
    RibRouteActionWeight,
)
from openr_tpu_torch.decision.spf_solver import SpfSolver
from torch_parity import adj, normalized_routes, normalized_update, to_ref

PFX = "::1:0/112"
SQUARE = {
    "1": [("2", 10), ("3", 10)],
    "2": [("1", 10), ("4", 10)],
    "3": [("1", 10), ("4", 10)],
    "4": [("2", 10), ("3", 10)],
}
SQUARE_LABELS = {"1": 101, "2": 102, "3": 103, "4": 104}


def dbs_of(spec, labels=None, area="0", overloaded=()):
    return [
        pt.AdjacencyDatabase(
            this_node_name=node,
            adjacencies=[adj(node, other, metric) for other, metric in nbrs],
            is_overloaded=node in overloaded,
            node_label=(labels or {}).get(node, 0),
            area=area,
        )
        for node, nbrs in spec.items()
    ]


def square_dbs(**kw):
    return dbs_of(SQUARE, SQUARE_LABELS, **kw)


def two_area_dbs():
    """tests/test_decision_golden.py's two_areas: area 0 is 1 -- 2,
    area 1 is 1 -- 3."""
    return {
        "0": dbs_of({"1": [("2", 10)], "2": [("1", 10)]}, area="0"),
        "1": dbs_of({"1": [("3", 10)], "3": [("1", 10)]}, area="1"),
    }


class Pair:
    """Both packages' link states (one per area), prefix states and
    solvers over the same inputs.  The port's solvers persist per router,
    so their device mirror and engine follow every change in place."""

    def __init__(self, area_dbs, prefixes=()) -> None:
        self.ls = {a: LinkState(a) for a in area_dbs}
        self.jls = {a: JLinkState(a) for a in area_dbs}
        for dbs in area_dbs.values():
            for db in dbs:
                self.update(db)
        self.ps, self.jps = PrefixState(), JPrefixState()
        for node, area, entry in prefixes:
            self.ps.update_prefix(node, area, entry)
            self.jps.update_prefix(node, area, to_ref(entry))
        self._solvers = {}

    def update(self, db, hold_up_ttl=0, hold_down_ttl=0):
        change = self.ls[db.area].update_adjacency_database(
            copy.deepcopy(db), hold_up_ttl, hold_down_ttl
        )
        jchange = self.jls[db.area].update_adjacency_database(
            to_ref(db), hold_up_ttl, hold_down_ttl
        )
        assert dataclasses.astuple(change) == dataclasses.astuple(jchange)
        self.check_state(db.area)
        return change

    def delete(self, node, area="0"):
        change = self.ls[area].delete_adjacency_database(node)
        jchange = self.jls[area].delete_adjacency_database(node)
        assert dataclasses.astuple(change) == dataclasses.astuple(jchange)
        self.check_state(area)

    def decrement(self, area="0"):
        change = self.ls[area].decrement_holds()
        jchange = self.jls[area].decrement_holds()
        assert dataclasses.astuple(change) == dataclasses.astuple(jchange)
        self.check_state(area)
        return change

    def check_state(self, area) -> None:
        ls, jls = self.ls[area], self.jls[area]
        assert ls.version == jls.version
        assert ls.has_holds() == jls.has_holds()
        assert ls.num_links() == jls.num_links()
        for node in jls.node_names:
            assert ls.is_node_overloaded(node) == jls.is_node_overloaded(node)
            got = [
                (l.ordered_names, l.is_up(), l.metric_from_node(node), l.has_holds())
                for l in ls.ordered_links_from_node(node)
            ]
            want = [
                (l.ordered_names, l.is_up(), l.metric_from_node(node), l.has_holds())
                for l in jls.ordered_links_from_node(node)
            ]
            assert got == want, node
            for other in jls.node_names:
                assert ls.get_hops_from_a_to_b(node, other) == jls.get_hops_from_a_to_b(
                    node, other
                )
            assert ls.get_max_hops_to_node(node) == jls.get_max_hops_to_node(node)

    def solvers(self, me):
        if me not in self._solvers:
            self._solvers[me] = (SpfSolver(me, device="cpu"), JSpfSolver(me))
        return self._solvers[me]

    def routes(self, me="1"):
        """(port DB, reference DB) of `me`, held equal."""
        solver, jsolver = self.solvers(me)
        got = solver.build_route_db(self.ls, self.ps)
        want = jsolver.build_route_db(self.jls, self.jps)
        if want is None:
            assert got is None
            return None, None
        assert normalized_routes(got) == normalized_routes(want), me
        return got, want


def nh_names(route) -> set:
    return {nh.neighbor_node_name for nh in route.nexthops}


# -- static routes (test_spf_solver.py TestStaticRoutes) --------------------


def test_static_unicast_overlay():
    pair = Pair({"0": square_dbs()})
    solver, jsolver = pair.solvers("1")
    static = pt.UnicastRoute("::2:0/112", [pt.NextHop(address="fe80::9")])
    solver.update_static_unicast_routes([static], [])
    jsolver.update_static_unicast_routes([to_ref(static)], [])
    got, _ = pair.routes()
    assert "::2:0/112" in got.unicast_routes
    # a computed route wins over the static one for the same prefix
    over = pt.UnicastRoute(PFX, [pt.NextHop(address="fe80::9")])
    solver.update_static_unicast_routes([over], [])
    jsolver.update_static_unicast_routes([to_ref(over)], [])
    for ps, entry in ((pair.ps, pt.PrefixEntry(prefix=PFX)),):
        ps.update_prefix("4", "0", entry)
        pair.jps.update_prefix("4", "0", to_ref(entry))
    got, _ = pair.routes()
    assert nh_names(got.unicast_routes[PFX]) == {"2", "3"}
    for s in (solver, jsolver):
        route = s.create_route_for_prefix_or_get_static_route(
            pair.ls if s is solver else pair.jls,
            pair.ps if s is solver else pair.jps,
            PFX,
        )
        assert nh_names(route) == {"2", "3"}
    # withdrawn, the prefix falls back to its static route
    pair.ps.delete_prefix("4", "0", PFX)
    pair.jps.delete_prefix("4", "0", PFX)
    got = solver.create_route_for_prefix_or_get_static_route(pair.ls, pair.ps, PFX)
    want = jsolver.create_route_for_prefix_or_get_static_route(pair.jls, pair.jps, PFX)
    assert normalized_update(
        dataclasses.replace(_update(), unicast_routes_to_update={PFX: got})
    ) == normalized_update(
        dataclasses.replace(_update(), unicast_routes_to_update={PFX: want})
    )
    solver.update_static_unicast_routes([], ["::2:0/112"])
    jsolver.update_static_unicast_routes([], ["::2:0/112"])
    got, _ = pair.routes()
    assert "::2:0/112" not in got.unicast_routes
    assert solver.create_route_for_prefix_or_get_static_route(
        pair.ls, pair.ps, "::7:0/112"
    ) is None


def _update():
    from openr_tpu_torch.decision.rib import DecisionRouteUpdate

    return DecisionRouteUpdate()


@pytest.mark.parametrize("label", [60000, 104])
def test_static_mpls(label):
    """An unused label appears; a node label wins over a static one."""
    pair = Pair({"0": square_dbs()})
    solver, jsolver = pair.solvers("1")
    route = pt.MplsRoute(top_label=label, next_hops=[pt.NextHop(address="fe80::9")])
    solver.update_static_mpls_routes([route], [])
    jsolver.update_static_mpls_routes([to_ref(route)], [])
    got, _ = pair.routes()
    assert label in got.mpls_routes
    solver.update_static_mpls_routes([], [label])
    jsolver.update_static_mpls_routes([], [label])
    got, _ = pair.routes()
    assert (label in got.mpls_routes) == (label == 104)


# -- route deltas (test_spf_solver.py TestRouteDelta) -----------------------


def test_calculate_update():
    prefixes = [("4", "0", pt.PrefixEntry(prefix=PFX))]
    pair = Pair({"0": square_dbs()}, prefixes)
    db1, jdb1 = pair.routes()
    db2, jdb2 = pair.routes()
    assert db1.calculate_update(db2).empty() and jdb1.calculate_update(jdb2).empty()
    # withdrawn prefix: a delete
    empty = Pair({"0": square_dbs()})
    db3, jdb3 = empty.routes()
    delta, jdelta = db1.calculate_update(db3), jdb1.calculate_update(jdb3)
    assert normalized_update(delta) == normalized_update(jdelta)
    assert delta.unicast_routes_to_delete == [PFX]
    # metric change: an update, and applying it gives the new DB
    spec = dict(SQUARE, **{"1": [("2", 10), ("3", 50)], "3": [("1", 50), ("4", 10)]})
    changed = Pair({"0": dbs_of(spec, SQUARE_LABELS)}, prefixes)
    db4, jdb4 = changed.routes()
    delta, jdelta = db1.calculate_update(db4), jdb1.calculate_update(jdb4)
    assert normalized_update(delta) == normalized_update(jdelta)
    assert PFX in delta.unicast_routes_to_update
    applied = DecisionRouteDb(dict(db1.unicast_routes), dict(db1.mpls_routes))
    applied.update(delta)
    assert applied.unicast_routes == db4.unicast_routes
    assert applied.mpls_routes == db4.mpls_routes
    # node label and MPLS deletions ride the same delta
    gone = Pair({"0": dbs_of(SQUARE, dict(SQUARE_LABELS, **{"2": 0}))}, prefixes)
    db5, jdb5 = gone.routes()
    delta, jdelta = db1.calculate_update(db5), jdb1.calculate_update(jdb5)
    assert normalized_update(delta) == normalized_update(jdelta)
    assert delta.mpls_routes_to_delete == [102]


def test_build_route_db_unknown_node_and_source_parameterized():
    pair = Pair({"0": square_dbs()}, [("4", "0", pt.PrefixEntry(prefix=PFX))])
    assert pair.routes("nope") == (None, None)
    got, _ = pair.routes("2")
    assert nh_names(got.unicast_routes[PFX]) == {"4"}


# -- adjacency-label routes (test_spf_solver.py TestSrMpls) -----------------


@pytest.mark.parametrize("labels", [(50001,), (50001, 50002), (5, 50002), (1 << 20, 0)])
def test_adjacency_label_routes(labels):
    """Valid labels give PHP routes toward their neighbour; labels out of
    the MPLS range are skipped and counted."""
    spec = {"1": [("2", 10), ("3", 20)], "2": [("1", 10)], "3": [("1", 20)]}
    dbs = dbs_of(spec)
    for a, label in zip(dbs[0].adjacencies, labels):
        a.adj_label = label
    pair = Pair({"0": dbs})
    got, want = pair.routes("1")
    valid = [l for l in labels if 16 <= l < (1 << 20)]
    assert sorted(got.mpls_routes) == sorted(valid)
    for label in valid:
        (nh,) = got.mpls_routes[label].nexthops
        assert nh.mpls_action.action == pt.MplsActionCode.PHP
    solver, jsolver = pair.solvers("1")
    assert solver.counters.get("decision.skipped_mpls_route", 0) == jsolver.counters.get(
        "decision.skipped_mpls_route", 0
    )
    # the neighbours' route DBs carry no label of router 1's adjacencies
    got2, _ = pair.routes("2")
    assert not set(got2.mpls_routes) & set(valid)


# -- prepend labels (test_decision_golden.py TestPrependLabels) -------------

PREPEND = 60001


@pytest.mark.parametrize(
    "advertiser, prepend, expect",
    [
        ("4", PREPEND, (PREPEND, 104)),  # remote: [prepend, node label]
        ("2", PREPEND, (PREPEND,)),  # neighbour: the prepend alone
        ("4", (1 << 20) + 7, None),  # invalid prepend: no next hops
    ],
)
def test_prepend_labels(advertiser, prepend, expect):
    entry = pt.PrefixEntry(
        prefix=PFX,
        forwarding_type=pt.PrefixForwardingType.SR_MPLS,
        prepend_label=prepend,
    )
    pair = Pair({"0": square_dbs()}, [(advertiser, "0", entry)])
    got, _ = pair.routes("1")
    route = got.unicast_routes[PFX]
    if expect is None:
        assert route.nexthops == frozenset()
        return
    for nh in route.nexthops:
        assert nh.mpls_action == pt.MplsAction(pt.MplsActionCode.PUSH, push_labels=expect)


def test_self_prepend_label_with_static_nexthops():
    entry = pt.PrefixEntry(
        prefix=PFX,
        forwarding_type=pt.PrefixForwardingType.SR_MPLS,
        prepend_label=PREPEND,
    )
    pair = Pair({"0": square_dbs()}, [("1", "0", entry), ("4", "0", entry)])
    hops = [
        pt.NextHop(address="1.1.1.1", mpls_action=pt.MplsAction(pt.MplsActionCode.PHP)),
        pt.NextHop(address="2.2.2.2", mpls_action=pt.MplsAction(pt.MplsActionCode.PHP)),
    ]
    solver, jsolver = pair.solvers("1")
    route = pt.MplsRoute(top_label=PREPEND, next_hops=hops)
    solver.update_static_mpls_routes([route], [])
    jsolver.update_static_mpls_routes([to_ref(route)], [])
    got, _ = pair.routes("1")
    nhs = got.unicast_routes[PFX].nexthops
    assert {"1.1.1.1", "2.2.2.2"} <= {nh.address for nh in nhs}
    assert all(nh.mpls_action is None for nh in nhs if nh.address[0] in "12")


# -- ordered-FIB holds (test_decision_golden.py TestOrderedFibHolds) --------


def _held(pair, change_db, ttl, expect_held, expect_after):
    """Apply `change_db` with hold TTLs `ttl` and hold the port's device
    backend against the reference before and after every decrement."""
    got, _ = pair.routes("1")
    engine = pair.solvers("1")[0].spf.engine
    pair.update(change_db, *ttl)
    got, _ = pair.routes("1")
    assert nh_names(got.unicast_routes[PFX]) == expect_held
    assert pair.ls["0"].has_holds()
    steps = 0
    while pair.ls["0"].has_holds():
        before = engine.get_counters()
        change = pair.decrement()
        got, _ = pair.routes("1")
        after = engine.get_counters()
        # an expiry reaches the mirror as a version bump: one more query
        # on an in-place refresh (incremental sync), no restage
        if change.topology_changed:
            assert after["device.engine.queries"] == before["device.engine.queries"] + 1
            assert after["device.engine.full_restages"] == before["device.engine.full_restages"]
        steps += 1
    assert nh_names(got.unicast_routes[PFX]) == expect_after
    return steps


def test_metric_hold_defers_reroute_until_decrement():
    pair = Pair({"0": square_dbs()}, [("4", "0", pt.PrefixEntry(prefix=PFX))])
    db = dbs_of({"1": [("2", 50), ("3", 10)]}, SQUARE_LABELS)[0]
    assert _held(pair, db, (2, 2), {"2", "3"}, {"3"}) == 2


def test_metric_improvement_held_up():
    spec = dict(SQUARE, **{"1": [("2", 50), ("3", 10)]})
    pair = Pair({"0": dbs_of(spec, SQUARE_LABELS)}, [("4", "0", pt.PrefixEntry(prefix=PFX))])
    db = dbs_of({"1": [("2", 10), ("3", 10)]}, SQUARE_LABELS)[0]
    assert _held(pair, db, (3, 1), {"3"}, {"2", "3"}) == 3


def test_overload_hold_defers_drain():
    pair = Pair({"0": square_dbs()}, [("4", "0", pt.PrefixEntry(prefix=PFX))])
    db = dbs_of({"2": [("1", 10), ("4", 10)]}, SQUARE_LABELS, overloaded={"2"})[0]
    assert _held(pair, db, (1, 1), {"2", "3"}, {"3"}) == 1


def test_link_overload_hold_defers_down():
    pair = Pair({"0": square_dbs()}, [("4", "0", pt.PrefixEntry(prefix=PFX))])
    db = copy.deepcopy(square_dbs()[0])
    db.adjacencies[0].is_overloaded = True
    assert _held(pair, db, (2, 2), {"2", "3"}, {"3"}) == 2


def test_new_link_held_up():
    spec = dict(SQUARE, **{"1": [("3", 10)], "2": [("4", 10)]})
    pair = Pair({"0": dbs_of(spec, SQUARE_LABELS)}, [("4", "0", pt.PrefixEntry(prefix=PFX))])
    pair.update(dbs_of({"2": [("1", 10), ("4", 10)]}, SQUARE_LABELS)[0])
    db = square_dbs()[0]
    assert _held(pair, db, (2, 0), {"3"}, {"2", "3"}) == 2


def test_churn_during_hold_falls_back_to_fast_update():
    pair = Pair({"0": square_dbs()}, [("4", "0", pt.PrefixEntry(prefix=PFX))])
    pair.routes("1")
    pair.update(dbs_of({"1": [("2", 50), ("3", 10)]}, SQUARE_LABELS)[0], 3, 3)
    got, _ = pair.routes("1")
    assert nh_names(got.unicast_routes[PFX]) == {"2", "3"}
    # a second change while held cancels the hold: visible at once
    pair.update(dbs_of({"1": [("2", 60), ("3", 10)]}, SQUARE_LABELS)[0], 3, 3)
    got, _ = pair.routes("1")
    assert nh_names(got.unicast_routes[PFX]) == {"3"}
    assert not pair.ls["0"].has_holds()


def test_hold_then_node_delete_no_stale_routes():
    pair = Pair({"0": square_dbs()}, [("4", "0", pt.PrefixEntry(prefix=PFX))])
    pair.routes("1")
    pair.update(dbs_of({"2": [("1", 10), ("4", 10)]}, SQUARE_LABELS, overloaded={"2"})[0], 2, 2)
    pair.delete("2")
    got, _ = pair.routes("1")
    assert nh_names(got.unicast_routes[PFX]) == {"3"}
    assert 102 not in got.mpls_routes
    while pair.ls["0"].has_holds():
        pair.decrement()
        pair.routes("1")
    pair.delete("nope")


# -- RibPolicy (test_decision_golden.py TestRibPolicy*Interactions) ---------


def stmt(name, weight, prefixes=(PFX,), tags=None, **maps):
    return RibPolicyStatementConfig(
        name=name,
        prefixes=list(prefixes) if prefixes is not None else None,
        tags=tags,
        set_weight=RibRouteActionWeight(default_weight=weight, **maps),
    )


SQ = (lambda: {"0": square_dbs()}, [("4", "0", pt.PrefixEntry(prefix=PFX))], "1")
TWO = (two_area_dbs, [("2", "0", pt.PrefixEntry(prefix=PFX)), ("3", "1", pt.PrefixEntry(prefix=PFX))], "1")
POLICY_CASES = {
    "area_weight_applies_per_area": (TWO, [stmt("a", 1, area_to_weight={"0": 7, "1": 3})], 60),
    "neighbor_weight_overrides_area": (
        SQ, [stmt("n", 1, area_to_weight={"0": 5}, neighbor_to_weight={"2": 9})], 60),
    "zero_weight_drops_nexthop": (SQ, [stmt("d", 1, neighbor_to_weight={"2": 0})], 60),
    "all_zero_weights_retain_nexthops": (SQ, [stmt("b", 0)], 60),
    "tag_matcher_transforms_only_tagged": (
        (
            SQ[0],
            [
                ("4", "0", pt.PrefixEntry(prefix=PFX, tags=("edge",))),
                ("4", "0", pt.PrefixEntry(prefix="::2:0/112")),
            ],
            "1",
        ),
        [stmt("t", 4, prefixes=None, tags=["edge"])],
        60,
    ),
    "first_matching_statement_wins": (SQ, [stmt("f", 2), stmt("s", 8)], 60),
    "expired_policy_is_noop": (SQ, [stmt("e", 5)], 0),
    "area_weight_zero_drops_one_areas_arm": (
        TWO, [stmt("z", 1, area_to_weight={"0": 1, "1": 0})], 60),
    "all_areas_zeroed_retains_cross_area_ecmp": (
        TWO, [stmt("z", 1, area_to_weight={"0": 0, "1": 0})], 60),
    "neighbor_weight_overrides_area_weight_cross_area": (
        TWO, [stmt("n", 1, area_to_weight={"0": 5, "1": 2}, neighbor_to_weight={"3": 9})], 60),
    "unknown_area_falls_back_to_default_weight": (
        TWO, [stmt("u", 4, area_to_weight={"9": 1})], 60),
    "prefix_matcher_scopes_to_one_areas_prefix": (
        (
            two_area_dbs,
            [("2", "0", pt.PrefixEntry(prefix=PFX)), ("3", "1", pt.PrefixEntry(prefix="::2:0/112"))],
            "1",
        ),
        [stmt("p", 6)],
        60,
    ),
    "redistribution_consumer_sees_area_weight": (
        (
            two_area_dbs,
            [("3", "1", pt.PrefixEntry(prefix=PFX)), ("1", "0", pt.PrefixEntry(prefix=PFX))],
            "2",
        ),
        [stmt("c", 1, area_to_weight={"0": 8})],
        60,
    ),
}


@pytest.mark.parametrize("name", sorted(POLICY_CASES))
def test_rib_policy_equals_reference(name):
    (make_dbs, prefixes, me), statements, ttl = POLICY_CASES[name]
    pair = Pair(make_dbs(), prefixes)
    got, want = pair.routes(me)
    cfg = RibPolicyConfig(statements=statements, ttl_secs=ttl)
    policy, jpolicy = RibPolicy(cfg), JRibPolicy(to_ref(cfg))
    assert policy.is_active() == jpolicy.is_active() == (ttl > 0)
    change = policy.apply_policy(got.unicast_routes)
    jchange = jpolicy.apply_policy(want.unicast_routes)
    assert change.updated_routes == jchange.updated_routes
    assert change.deleted_routes == jchange.deleted_routes
    assert normalized_routes(got) == normalized_routes(want)
    assert to_ref(policy.to_config().statements) == jpolicy.to_config().statements
    for prefix, route in got.unicast_routes.items():
        assert policy.match(route) == jpolicy.match(want.unicast_routes[prefix])


@pytest.mark.parametrize(
    "cfg",
    [
        RibPolicyConfig(statements=[], ttl_secs=10),
        RibPolicyConfig(statements=[stmt("no-matcher", 1, prefixes=None)], ttl_secs=10),
        RibPolicyConfig(
            statements=[RibPolicyStatementConfig(name="no-action", prefixes=[PFX])],
            ttl_secs=10,
        ),
    ],
)
def test_policy_requires_statements_and_matcher(cfg):
    with pytest.raises(PolicyError) as got:
        RibPolicy(cfg)
    with pytest.raises(JPolicyError) as want:
        JRibPolicy(to_ref(cfg))
    assert str(got.value) == str(want.value)


# -- prefix state (reference: PrefixState.cpp) ------------------------------


def _prefix_states():
    entries = [
        ("1", "0", pt.PrefixEntry(prefix="fc00:1::/64")),
        ("2", "0", pt.PrefixEntry(prefix="fc00:1::/64")),
        ("2", "1", pt.PrefixEntry(prefix="fc00:2::/64", forwarding_type=pt.PrefixForwardingType.SR_MPLS)),
        ("3", "1", pt.PrefixEntry(prefix="fc00:2::/64")),
        ("3", "0", pt.PrefixEntry(prefix="10.0.0.0/24")),
    ]
    ps, jps = PrefixState(), JPrefixState()
    for node, area, entry in entries:
        assert ps.update_prefix(node, area, entry) == jps.update_prefix(
            node, area, to_ref(entry)
        )
    return ps, jps


@pytest.mark.parametrize(
    "filters",
    [
        {},
        {"prefixes": ["fc00:1:0::/64", "fd00::/64"]},
        {"node_name": "2"},
        {"area_name": "1"},
        {"node_name": "3", "area_name": "0"},
    ],
)
def test_received_routes_filtered_equal_reference(filters):
    ps, jps = _prefix_states()
    got = ps.get_received_routes_filtered(**filters)
    assert to_ref(got) == jps.get_received_routes_filtered(**filters)


def test_prefix_deletes_and_conflicts_equal_reference():
    ps, jps = _prefix_states()
    for prefix, entries in ps.prefixes.items():
        assert PrefixState.has_conflicting_forwarding_info(
            entries
        ) == JPrefixState.has_conflicting_forwarding_info(jps.prefixes[prefix])
    assert PrefixState.has_conflicting_forwarding_info(ps.prefixes["fc00:2::/64"])
    for args in (("2", "0", "fc00:1:0::/64"), ("2", "0", "fc00:1::/64"), ("9", "0", "10.0.0.0/24")):
        assert ps.delete_prefix(*args) == jps.delete_prefix(*args)
    assert ps.delete_all_from_node("3", "1") == jps.delete_all_from_node("3", "1")
    assert ps.delete_all_from_node("3", "0") == jps.delete_all_from_node("3", "0") == {"10.0.0.0/24"}
    assert to_ref(ps.prefixes) == jps.prefixes
