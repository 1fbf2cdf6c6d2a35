"""The port's BGP metric-vector selection and UCMP weights against
openr_tpu's.

`decision.metric_vector` on the cases of tests/test_metric_vector.py and
on seeded random vector pairs; BGP best-path selection, best-route
selection, UCMP weights and the BGP dry run through SpfSolver, each run
on the port's device backend (on the CPU), its host backend and the
reference's solver with equal route DBs (`SolverTrio`), on
the cases of test_spf_solver.py::TestBestRouteSelection and
test_decision_golden.py's TestBgpIgpMetricSequence,
TestBestRouteSelectionChain and TestUcmpWeightsPersistentPair; and a
dry-run Decision against the reference's.  Weights are integers:
tolerance 0.
"""

from __future__ import annotations

import numpy as np
import pytest

from openr_tpu.decision import metric_vector as jmv
from openr_tpu.decision.prefix_state import PrefixState as JPrefixState
from openr_tpu.decision.spf_solver import SpfSolver as JSpfSolver
from openr_tpu_torch import types as pt
from openr_tpu_torch.decision import metric_vector as mvu
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.decision.spf_solver import (
    HostSpfBackend,
    SpfSolver,
    select_best_node_area,
    select_best_prefix_metrics,
)

from torch_parity import (
    adj,
    adj_dbs,
    link_states,
    normalized_routes,
    square_dbs,
    to_jax_entry,
    to_ref,
)

PFX = "fc00:b::/64"
CT = pt.CompareType


class SolverTrio:
    """The port's SpfSolver on its device backend (device="cpu") and on
    its host backend, and the reference's SpfSolver, built once and fed
    the same prefix updates, so a sequence of steps runs on persistent
    solvers.  `build()` holds the three route DBs equal (normalized) and
    returns the port's device DB."""

    def __init__(self, me: str, dbs, **solver_kw) -> None:
        self.ls, self.jls = link_states(dbs)
        self.ps, self.jps = PrefixState(), JPrefixState()
        self.device = SpfSolver(me, device="cpu", **solver_kw)
        self.host = SpfSolver(
            me, spf_backend=HostSpfBackend(), device="cpu", **solver_kw
        )
        self.ref = JSpfSolver(me, **solver_kw)

    def advertise(self, node: str, entry, area: str = "0") -> None:
        self.ps.update_prefix(node, area, entry)
        jentry = to_jax_entry(entry)
        jentry.mv = to_ref(entry.mv)
        self.jps.update_prefix(node, area, jentry)

    def withdraw(self, node: str, prefix: str, area: str = "0") -> None:
        self.ps.delete_prefix(node, area, prefix)
        self.jps.delete_prefix(node, area, prefix)

    def build(self):
        dev = self.device.build_route_db({"0": self.ls}, self.ps)
        host = self.host.build_route_db({"0": self.ls}, self.ps)
        ref = self.ref.build_route_db({"0": self.jls}, self.jps)
        assert normalized_routes(dev) == normalized_routes(ref)
        assert normalized_routes(host) == normalized_routes(ref)
        return dev


def route_db_trio(me: str, dbs, entries, **solver_kw):
    """One SolverTrio build of `entries` ((node, PrefixEntry) pairs):
    (the port's device route DB, its solver)."""
    trio = SolverTrio(me, dbs, **solver_kw)
    for node, entry in entries:
        trio.advertise(node, entry)
    return trio.build(), trio.device


def ent(type_, priority, metric, op=CT.WIN_IF_PRESENT, tie_breaker=False):
    return pt.MetricEntity(
        type=type_, priority=priority, op=op,
        is_best_path_tie_breaker=tie_breaker, metric=list(metric),
    )


def five():
    """The UtilTest fixture: 5 entities, type == priority == i, metric [i]."""
    mk = lambda: pt.MetricVector(version=1, metrics=[ent(i, i, (i,)) for i in range(5)])
    return mk(), mk()


def both(l, r) -> str:
    """compare_metric_vectors of the port and of the reference (on the
    reference's types), which must agree; the result's name."""
    got = mvu.compare_metric_vectors(l, r)
    want = jmv.compare_metric_vectors(to_ref(l), to_ref(r))
    assert got.value == want.value
    return got.value


def _higher(l, r):
    r.metrics[3].metric = [r.metrics[3].metric[0] - 1]


def _tb_mismatch(l, r):
    _higher(l, r)
    r.metrics[3].is_best_path_tie_breaker = True


def _tb(l, r):
    _higher(l, r)
    r.metrics[3].is_best_path_tie_breaker = True
    l.metrics[3].is_best_path_tie_breaker = True


def _loner(l, r):
    _tb(l, r)
    r.metrics = r.metrics[1:]


def _type_clash(l, r):
    l.metrics[4].type = 99


def _loner_not_present(l, r):
    _loner(l, r)
    l.metrics[0].op = CT.WIN_IF_NOT_PRESENT


def _loner_ignore(l, r):
    _loner(l, r)
    l.metrics[0].op = CT.IGNORE_IF_NOT_PRESENT


@pytest.mark.parametrize(
    "edit, forward, backward",
    [
        (lambda l, r: None, "TIE", "TIE"),
        (_higher, "WINNER", "LOOSER"),
        (_tb_mismatch, "ERROR", "ERROR"),
        (_tb, "TIE_WINNER", "TIE_LOOSER"),
        (_loner, "WINNER", "LOOSER"),
        (_type_clash, "ERROR", "ERROR"),
        (_loner_not_present, "LOOSER", "WINNER"),
        (_loner_ignore, "TIE_WINNER", "TIE_LOOSER"),
    ],
    ids=["equal", "higher", "tb_mismatch", "tb", "loner", "type_clash",
         "loner_not_present", "loner_ignore"],
)
def test_compare_chain_equals_reference(edit, forward, backward):
    l, r = five()
    edit(l, r)
    assert both(l, r) == forward
    assert both(r, l) == backward


def test_empty_version_and_unsorted_vectors():
    assert both(pt.MetricVector(), pt.MetricVector()) == "TIE"
    assert both(pt.MetricVector(version=1), pt.MetricVector(version=2)) == "ERROR"
    l = pt.MetricVector(version=1, metrics=[ent(0, 100, (1,)), ent(1, 900, (7,))])
    r = pt.MetricVector(version=1, metrics=[ent(1, 900, (7,)), ent(0, 100, (0,))])
    assert both(l, r) == "WINNER"


def test_helpers_equal_reference():
    for res in mvu.CompareResult:
        jres = jmv.CompareResult(res.value)
        assert mvu.negate(res).value == jmv.negate(jres).value
        assert mvu.is_decisive(res) == jmv.is_decisive(jres)
    assert mvu.compare_metrics((1, 2), (1,), False).value == "ERROR"
    for op in CT:
        for tb in (False, True):
            e = ent(0, 0, (), op=op, tie_breaker=tb)
            assert mvu.result_for_loner(e).value == jmv.result_for_loner(to_ref(e)).value


def _random_vector(rng) -> pt.MetricVector:
    metrics = []
    for _ in range(int(rng.integers(0, 5))):
        metrics.append(
            ent(
                int(rng.integers(0, 4)),
                int(rng.integers(0, 4)),
                tuple(int(x) for x in rng.integers(0, 3, int(rng.integers(1, 3)))),
                op=CT(int(rng.integers(1, 4))),
                tie_breaker=bool(rng.integers(0, 2)),
            )
        )
    return pt.MetricVector(version=int(rng.integers(1, 3)) if rng.random() < 0.1 else 1,
                           metrics=metrics)


@pytest.mark.parametrize("seed", range(6))
def test_random_vector_pairs_equal_reference(seed):
    rng = np.random.default_rng(seed)
    seen = set()
    for _ in range(200):
        l, r = _random_vector(rng), _random_vector(rng)
        seen.add(both(l, r))
    assert len(seen) >= 4


# -- BGP selection in the solver -----------------------------------------------


def line3():
    return adj_dbs(
        {"1": [adj("1", "2")], "2": [adj("2", "1"), adj("2", "3")], "3": [adj("3", "2")]}
    )


def local_pref(pref: int, tie_break_ip: int = 0) -> pt.MetricVector:
    metrics = [ent(0, 9000, (pref,))]
    if tie_break_ip:
        metrics.append(ent(6, 3000, (tie_break_ip,), tie_breaker=True))
    return pt.MetricVector(version=1, metrics=metrics)


def bgp(mv, **kw) -> pt.PrefixEntry:
    return pt.PrefixEntry(prefix=PFX, type=pt.PrefixType.BGP, mv=mv, **kw)


def hops(route) -> set:
    return {nh.address for nh in route.nexthops}


def _worse_version():
    v = local_pref(100)
    v.version = 2
    return v


@pytest.mark.parametrize(
    "entries, want",
    [
        ({"1": bgp(local_pref(100))}, {"fe80::1"}),
        ({"1": bgp(local_pref(100)), "3": bgp(local_pref(200))}, {"fe80::3"}),
        ({"1": bgp(local_pref(100)), "3": bgp(local_pref(100))}, None),
        ({"1": bgp(local_pref(100, 1)), "3": bgp(local_pref(100, 3))},
         {"fe80::1", "fe80::3"}),
        ({"1": bgp(local_pref(100)), "3": bgp(_worse_version())}, None),
        ({"1": bgp(None), "3": bgp(None)}, {"fe80::1", "fe80::3"}),
        ({"1": bgp(local_pref(100)), "3": bgp(None)}, None),
    ],
    ids=["single", "better", "tie", "tie_breaker", "version", "no_vectors", "mixed"],
)
def test_solver_bgp_selection(entries, want):
    db, _ = route_db_trio("2", line3(), list(entries.items()))
    if want is None:
        assert PFX not in db.unicast_routes
    else:
        assert hops(db.unicast_routes[PFX]) == want


def test_winner_resets_prior_ties():
    dbs = adj_dbs(
        {
            "1": [adj("1", "4")], "2": [adj("2", "4")], "3": [adj("3", "4")],
            "4": [adj("4", "1"), adj("4", "2"), adj("4", "3")],
        }
    )
    db, solver = route_db_trio(
        "4", dbs,
        [("1", bgp(local_pref(100, 1))), ("2", bgp(local_pref(100, 2))),
         ("3", bgp(local_pref(200, 3)))],
    )
    assert hops(db.unicast_routes[PFX]) == {"fe80::3"}
    assert solver.best_routes_cache[PFX].best_node_area == ("3", "0")


@pytest.mark.parametrize("dry_run", [False, True])
def test_bgp_dry_run_marks_bgp_routes_only(dry_run):
    db, _ = route_db_trio(
        "2", line3(),
        [("1", bgp(local_pref(100))), ("3", pt.PrefixEntry(prefix="fc00:c::/64"))],
        bgp_dry_run=dry_run,
    )
    assert db.unicast_routes[PFX].do_not_install is dry_run
    assert db.unicast_routes["fc00:c::/64"].do_not_install is False


# -- best-route selection ------------------------------------------------------


def test_prefix_metrics_order_and_best_node_area():
    m = lambda pp=0, sp=0, d=0: pt.PrefixEntry(
        prefix=PFX,
        metrics=pt.PrefixMetrics(path_preference=pp, source_preference=sp, distance=d),
    )
    assert select_best_prefix_metrics(
        {("a", "0"): m(1000), ("b", "0"): m(2000), ("c", "0"): m(2000)}
    ) == {("b", "0"), ("c", "0")}
    assert select_best_prefix_metrics(
        {("a", "0"): m(0, 100, 5), ("b", "0"): m(0, 200, 9), ("c", "0"): m(0, 200, 2)}
    ) == {("c", "0")}
    nas = {("b", "0"), ("a", "0"), ("me", "1")}
    assert select_best_node_area(nas, "me") == ("me", "1")
    assert select_best_node_area(nas, "zz") == ("a", "0")


def _pp(pp, sp=0, **kw):
    return pt.PrefixEntry(
        prefix=PFX, metrics=pt.PrefixMetrics(path_preference=pp, source_preference=sp), **kw
    )


def _diamond_dbs(overloaded=frozenset()):
    return adj_dbs(
        {
            "1": [adj("1", "2"), adj("1", "3")],
            "2": [adj("2", "1"), adj("2", "4")],
            "3": [adj("3", "1"), adj("3", "4")],
            "4": [adj("4", "2"), adj("4", "3")],
        },
        overloaded=overloaded,
    )


@pytest.mark.parametrize(
    "dbs, entries, kw, want",
    [
        (square_dbs, [("2", _pp(2000)), ("3", _pp(1000))],
         {"enable_best_route_selection": True}, {"2"}),
        (lambda: _diamond_dbs({"2"}), [("2", pt.PrefixEntry(prefix=PFX)),
                                       ("4", pt.PrefixEntry(prefix=PFX))], {}, {"3"}),
        (square_dbs, [("4", pt.PrefixEntry(prefix=PFX, min_nexthop=3))], {}, None),
        (square_dbs, [("2", _pp(2000, 100)), ("3", _pp(1000, 900))],
         {"enable_best_route_selection": True}, {"2"}),
        (square_dbs, [("2", _pp(2000, 100)), ("3", _pp(2000, 900))],
         {"enable_best_route_selection": True}, {"3"}),
        (square_dbs, [("2", pt.PrefixEntry(prefix=PFX, type=pt.PrefixType.BGP,
                                           mv=local_pref(1))),
                      ("3", pt.PrefixEntry(prefix=PFX, type=pt.PrefixType.RIB))], {}, None),
        (square_dbs, [("2", pt.PrefixEntry(prefix=PFX, type=pt.PrefixType.BGP,
                                           mv=local_pref(1))),
                      ("3", pt.PrefixEntry(prefix=PFX, type=pt.PrefixType.RIB))],
         {"enable_best_route_selection": True}, "any"),
    ],
    ids=["limits_ecmp", "drained_filtered", "min_nexthop", "pp_wins", "sp_breaks",
         "mixed_rejected", "mixed_resolved"],
)
def test_best_route_selection(dbs, entries, kw, want):
    db, _ = route_db_trio("1", dbs(), entries, **kw)
    if want is None:
        assert PFX not in db.unicast_routes
    elif want != "any":
        assert {nh.neighbor_node_name for nh in db.unicast_routes[PFX].nexthops} == want
    else:
        assert PFX in db.unicast_routes


def test_duplicate_prefix_withdrawal_keeps_other_advertiser():
    trio = SolverTrio("1", square_dbs())
    trio.advertise("2", pt.PrefixEntry(prefix=PFX))
    trio.advertise("4", pt.PrefixEntry(prefix=PFX))
    assert "2" in {nh.neighbor_node_name for nh in trio.build().unicast_routes[PFX].nexthops}
    trio.withdraw("2", PFX)
    route = trio.build().unicast_routes[PFX]
    assert {nh.neighbor_node_name for nh in route.nexthops} == {"2", "3"}
    assert all(nh.metric == 20 for nh in route.nexthops)


# -- BGP over IGP metric changes (TestBgpIgpMetricSequence) --------------------


def _igp_entries():
    def entry(tb_value):
        return bgp(
            pt.MetricVector(
                metrics=[
                    pt.MetricEntity(type=1, priority=2, metric=[7]),
                    pt.MetricEntity(type=2, priority=1, is_best_path_tie_breaker=True,
                                    metric=[tb_value]),
                ]
            )
        )

    return [("2", entry(1)), ("3", entry(100))]


def _y(m12=10, m13=10, drain_12=False):
    a12, a21 = adj("1", "2", m12), adj("2", "1", m12)
    a12.is_overloaded = a21.is_overloaded = drain_12
    return adj_dbs(
        {"1": [a12, adj("1", "3", m13)], "2": [a21], "3": [adj("3", "1", m13)]},
        labels={"1": 101, "2": 102, "3": 103},
    )


@pytest.mark.parametrize(
    "dbs, want",
    [
        (lambda: _y(), {"2", "3"}),
        (lambda: _y(m13=20), {"2"}),
        (lambda: _y(m13=20, drain_12=True), {"3"}),
        (lambda: _y(m12=20, m13=20), {"2", "3"}),
    ],
    ids=["equal", "costlier_dropped", "drained_nearest", "undrain"],
)
def test_bgp_igp_metric_sequence(dbs, want):
    db, _ = route_db_trio("1", dbs(), _igp_entries())
    assert {nh.neighbor_node_name for nh in db.unicast_routes[PFX].nexthops} == want


# -- UCMP weights ---------------------------------------------------------------


def uentry(weight=None, algo=pt.PrefixForwardingAlgorithm.SP_UCMP_PREFIX_WEIGHT_PROPAGATION):
    return pt.PrefixEntry(prefix=PFX, forwarding_algorithm=algo, weight=weight)


def weights(route) -> dict:
    return {nh.neighbor_node_name: nh.weight for nh in route.nexthops}


def test_ecmp_next_hops_carry_no_weight():
    db, _ = route_db_trio("1", square_dbs(), [("4", pt.PrefixEntry(prefix=PFX, weight=300))])
    assert weights(db.unicast_routes[PFX]) == {"2": 0, "3": 0}


def test_prefix_weight_propagation_lifecycle():
    """Five steps on one persistent solver trio: weights follow the
    advertised prefix weights, normalized by their gcd."""
    trio = SolverTrio("1", square_dbs())
    trio.advertise("2", uentry(400))
    trio.advertise("3", uentry(100))
    assert weights(trio.build().unicast_routes[PFX]) == {"2": 4, "3": 1}
    trio.advertise("3", uentry(200))
    assert weights(trio.build().unicast_routes[PFX]) == {"2": 2, "3": 1}
    trio.withdraw("2", PFX)
    assert weights(trio.build().unicast_routes[PFX]) == {"3": 1}
    trio.advertise("2", uentry())
    trio.advertise("3", uentry())
    assert weights(trio.build().unicast_routes[PFX]) == {"2": 0, "3": 0}
    trio.advertise("2", uentry(algo=pt.PrefixForwardingAlgorithm.SP_ECMP))
    trio.advertise("3", uentry(500))
    assert weights(trio.build().unicast_routes[PFX]) == {"2": 0, "3": 0}


def test_weights_restricted_to_min_metric_advertisers():
    db, _ = route_db_trio("1", square_dbs(), [("2", uentry(100)), ("4", uentry(500))])
    assert weights(db.unicast_routes[PFX]) == {"2": 1}


def test_shared_first_hop_accumulates_advertiser_weights():
    dbs = adj_dbs(
        {
            "1": [adj("1", "2"), adj("1", "5", metric=20)],
            "2": [adj("2", "1"), adj("2", "3"), adj("2", "4")],
            "3": [adj("3", "2")],
            "4": [adj("4", "2")],
            "5": [adj("5", "1", metric=20)],
        }
    )
    db, _ = route_db_trio(
        "1", dbs, [("3", uentry(100)), ("4", uentry(300)), ("5", uentry(400))]
    )
    assert weights(db.unicast_routes[PFX]) == {"2": 1, "5": 1}


def test_adj_weight_propagation_uses_first_hop_weights():
    a12, a13 = adj("1", "2"), adj("1", "3")
    a12.weight, a13.weight = 6, 2
    dbs = adj_dbs(
        {
            "1": [a12, a13],
            "2": [adj("2", "1"), adj("2", "4")],
            "3": [adj("3", "1"), adj("3", "4")],
            "4": [adj("4", "2"), adj("4", "3")],
        }
    )
    db, _ = route_db_trio(
        "1", dbs,
        [("4", uentry(999, pt.PrefixForwardingAlgorithm.SP_UCMP_ADJ_WEIGHT_PROPAGATION))],
    )
    assert weights(db.unicast_routes[PFX]) == {"2": 3, "3": 1}


def test_drained_weighted_advertiser_degrades_to_ecmp():
    db, _ = route_db_trio(
        "1", _diamond_dbs({"2"}), [("2", uentry(700)), ("3", uentry())]
    )
    assert weights(db.unicast_routes[PFX]) == {"3": 0}


def test_ucmp_on_the_fleet_view_path():
    """Any-node route DBs from the fleet product (the port's device
    backend keeps a mirror, so its any-node query reads the fleet view)
    give the reference's UCMP weights."""
    from openr_tpu_torch.utils import topo

    trio = SolverTrio("r0", topo.ring_topology(65))
    for node, w in (("r10", 300), ("r55", 100), ("r32", 200)):
        trio.advertise(node, uentry(w))
    solver = SpfSolver("r0", device="cpu")
    jsolver = JSpfSolver("r0")
    for node in ("r0", "r20", "r40"):
        got = solver.any_node_route_db({"0": trio.ls}, trio.ps, node)
        want = jsolver.build_route_db({"0": trio.jls}, trio.jps, my_node_name=node)
        assert normalized_routes(got) == normalized_routes(want), node
        assert any(nh.weight for nh in got.unicast_routes[PFX].nexthops)
    assert solver.fleet._views  # the fleet view answered


def test_bgp_dry_run_through_decision():
    from test_torch_decision import DecisionPair, prefix_val, square_publication

    p = DecisionPair(with_static=False, bgp_dry_run=True).run()
    try:
        pub = square_publication()
        k, v = prefix_val("4", PFX, entry=bgp(local_pref(100)))
        pub.key_vals[k] = v
        p.push(pub)
        update = p.update()
        assert update.unicast_routes_to_update[PFX].do_not_install is True
    finally:
        p.close()
