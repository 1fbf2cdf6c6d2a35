"""The port's k edge-disjoint shortest paths against openr_tpu's.

Host k-paths (`LinkState.get_kth_paths`, `trace_one_path`,
`path_a_in_path_b`), the device backend's batched KSP2
(`DeviceSpfBackend.prefetch_kth_paths`: one masked run per source),
KSP2_ED_ECMP route selection with BGP metric vectors, and the fused
dual-plane KSP2 of `ops.ksp` on the bands, each fed the same seeded
inputs in both packages.  Path sets are compared order-free (ECMP tie
order may differ between the host heap and the device DAG, as in
tests/test_ksp2_device.py); distances, traces, verdicts and route DBs
must be equal.  A failing device prefetch raises and Decision counts
it.  Integer min-plus: tolerance 0.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmarks.synthetic import wan
from openr_tpu.ops.ksp import FusedKsp2Runner as JFusedKsp2Runner
from openr_tpu.ops.protection import build_reverse_edge_ids as j_reverse_ids
from openr_tpu.utils.topo import grid_topology, random_topology
from openr_tpu_torch import types as pt
from openr_tpu_torch.decision.csr import CsrTopology
from openr_tpu_torch.decision.link_state import path_a_in_path_b
from openr_tpu_torch.decision.spf_solver import DeviceSpfBackend
from openr_tpu_torch.ops.banded import SpfRunner, build_banded
from openr_tpu_torch.ops.ksp import FusedKsp2Runner, build_in_start
from openr_tpu_torch.ops.protection import build_reverse_edge_ids
from openr_tpu_torch.ops.sssp import INF32, build_ell

from test_torch_bgp_ucmp import route_db_trio
from torch_parity import adj, adj_dbs, link_states, square_dbs, to_port_dbs

PFX = "fc00:dead::/64"
CPU = torch.device("cpu")


def canon(paths):
    """Order-free form of a path set: node pairs of each path's links."""
    return sorted(tuple((link.n1, link.n2) for link in path) for path in paths)


def _diamond():
    """a-b-d and a-c-d at cost 2 (disjoint) plus a direct a-d at 5."""
    return adj_dbs(
        {
            "a": [adj("a", "b", 1), adj("a", "c", 1), adj("a", "d", 5)],
            "b": [adj("b", "a", 1), adj("b", "d", 1)],
            "c": [adj("c", "a", 1), adj("c", "d", 1)],
            "d": [adj("d", "b", 1), adj("d", "c", 1), adj("d", "a", 5)],
        }
    )


# -- host k-paths --------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 3])
def test_diamond_kth_paths_equal_reference(k):
    ls, jls = link_states(_diamond())
    assert canon(ls.get_kth_paths("a", "d", k)) == canon(jls.get_kth_paths("a", "d", k))
    assert ls.get_kth_paths("a", "a", k) == jls.get_kth_paths("a", "a", k) == []
    if k == 2:
        (path,) = ls.get_kth_paths("a", "d", 2)
        assert len(path) == 1 and path[0].metric_from_node("a") == 5


def test_path_a_in_path_b_and_cache_invalidation():
    ls, jls = link_states(_diamond())
    p1, p2 = ls.get_kth_paths("a", "d", 1)
    assert path_a_in_path_b(p1, p1) and not path_a_in_path_b(p1, p2)
    assert path_a_in_path_b([p1[0]], p1) and not path_a_in_path_b(p1, [p1[0]])
    # a version bump clears the memo: drop a - d
    dbs = _diamond()
    dbs[0].adjacencies = dbs[0].adjacencies[:2]
    ls.update_adjacency_database(dbs[0])
    assert ls.get_kth_paths("a", "d", 2) == []


def test_run_spf_links_to_ignore_equals_reference():
    ls, jls = link_states(to_port_dbs(random_topology(40, 60, seed=7)))
    src = sorted(ls.node_names)[0]
    ignore = sorted(ls.all_links)[::5]
    jignore = {l for l in jls.all_links if l.ordered_names in {x.ordered_names for x in ignore}}
    got = ls.run_spf(src, links_to_ignore=set(ignore))
    want = jls.run_spf(src, links_to_ignore=jignore)
    assert {n: r.metric for n, r in got.items()} == {n: r.metric for n, r in want.items()}
    assert {n: sorted(r.next_hops) for n, r in got.items()} == {
        n: sorted(r.next_hops) for n, r in want.items()
    }


# -- the device backend's batched KSP2 ----------------------------------------


def _kth_parity(jdbs, src, dests):
    ls, jls = link_states(to_port_dbs(jdbs))
    dev_ls, _ = link_states(to_port_dbs(jdbs))
    backend = DeviceSpfBackend("cpu")
    backend.prefetch_kth_paths(dev_ls, src, dests)
    for dest in dests:
        for k in (1, 2):
            want = canon(jls.get_kth_paths(src, dest, k))
            assert canon(ls.get_kth_paths(src, dest, k)) == want, (dest, k)
            assert canon(backend.get_kth_paths(dev_ls, src, dest, k)) == want, (dest, k)
    return backend


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_topologies_one_masked_batch(seed):
    jdbs = random_topology(n_nodes=80, n_extra_edges=120, seed=seed)
    nodes = sorted(db.this_node_name for db in jdbs)
    backend = _kth_parity(jdbs, nodes[0], nodes[1:25])
    c = backend.engine.get_counters()
    # every destination's k = 2 run is a row of ONE masked batch
    assert c["device.engine.masked_batches"] == 1
    assert c["device.engine.masked_rows"] == 24
    assert c["device.engine.masked_runs"] >= 1


def test_grid_single_destination_misses():
    jdbs = grid_topology(6)
    ls, jls = link_states(to_port_dbs(jdbs))
    backend = DeviceSpfBackend("cpu")
    for dest in ["node-5-5", "node-0-5", "node-3-2", "node-1-0"]:
        for k in (1, 2):
            assert canon(backend.get_kth_paths(ls, "node-0-0", dest, k)) == canon(
                jls.get_kth_paths("node-0-0", dest, k)
            )
    assert backend.get_kth_paths(ls, "node-0-0", "node-0-0", 1) == []
    assert backend.get_kth_paths(ls, "node-0-0", "node-0-0", 2) == []


def test_device_cache_invalidated_on_topology_change():
    dbs = to_port_dbs(grid_topology(4))
    ls, jls = link_states(dbs)
    backend = DeviceSpfBackend("cpu")
    before = backend.get_kth_paths(ls, "node-0-0", "node-3-3", 1)
    assert before
    link = before[0][0]
    db = next(d for d in dbs if d.this_node_name == link.n1)
    db.adjacencies = [a for a in db.adjacencies if a.other_node_name != link.n2]
    ls.update_adjacency_database(db)
    jdb = next(d for d in grid_topology(4) if d.this_node_name == link.n1)
    jdb.adjacencies = [a for a in jdb.adjacencies if a.other_node_name != link.n2]
    jls.update_adjacency_database(jdb)
    for k in (1, 2):
        assert canon(backend.get_kth_paths(ls, "node-0-0", "node-3-3", k)) == canon(
            jls.get_kth_paths("node-0-0", "node-3-3", k)
        )


def test_device_backend_refuses_k3():
    ls, _ = link_states(_diamond())
    with pytest.raises(ValueError, match="k = 1 and 2"):
        DeviceSpfBackend("cpu").get_kth_paths(ls, "a", "d", 3)


# -- KSP2_ED_ECMP routes --------------------------------------------------------


def _entry(**kw) -> pt.PrefixEntry:
    kw.setdefault("forwarding_type", pt.PrefixForwardingType.SR_MPLS)
    kw.setdefault("forwarding_algorithm", pt.PrefixForwardingAlgorithm.KSP2_ED_ECMP)
    return pt.PrefixEntry(prefix=PFX, **kw)


def nh_names(route) -> set:
    return {nh.neighbor_node_name for nh in route.nexthops}


def test_square_two_disjoint_paths_with_label_stacks():
    db, _ = route_db_trio("1", square_dbs(), [("4", _entry())])
    route = db.unicast_routes[PFX]
    assert nh_names(route) == {"2", "3"}
    for nh in route.nexthops:
        assert nh.metric == 20
        assert nh.mpls_action == pt.MplsAction(
            pt.MplsActionCode.PUSH, push_labels=(104,)
        )


def test_longer_second_path():
    dbs = adj_dbs(
        {
            "1": [adj("1", "2"), adj("1", "3")],
            "2": [adj("2", "1"), adj("2", "3")],
            "3": [adj("3", "1"), adj("3", "2")],
        },
        labels={"1": 101, "2": 102, "3": 103},
    )
    db, _ = route_db_trio("1", dbs, [("2", _entry())])
    by = {nh.neighbor_node_name: nh for nh in db.unicast_routes[PFX].nexthops}
    assert by["2"].metric == 10 and by["2"].mpls_action is None
    assert by["3"].metric == 20


def test_ksp2_requires_sr_mpls():
    db, solver = route_db_trio(
        "1", square_dbs(), [("4", _entry(forwarding_type=pt.PrefixForwardingType.IP))]
    )
    assert PFX not in db.unicast_routes
    assert solver.counters["decision.incompatible_forwarding_type"] == 1


def test_grid_rib_identical():
    route_db_trio(
        "node-0-0",
        to_port_dbs(grid_topology(5)),
        [("node-4-4", _entry()), ("node-2-3", _entry())],
    )


def _mv(value, priority=1, tie_breaker=False):
    return pt.MetricVector(
        metrics=[
            pt.MetricEntity(
                type=1, priority=priority,
                is_best_path_tie_breaker=tie_breaker, metric=[value],
            )
        ]
    )


def _bgp(value, tie_breaker=False, **kw):
    return _entry(type=pt.PrefixType.BGP, mv=_mv(value, tie_breaker=tie_breaker), **kw)


@pytest.mark.parametrize(
    "entries, check",
    [
        # the higher vector wins, KSP2 reaches it over 2 and 3
        ([("2", _bgp(100)), ("4", _bgp(200))],
         lambda r: r.best_prefix_entry.mv == _mv(200) and nh_names(r) == {"2", "3"}),
        # a plain TIE drops the route
        ([("2", _bgp(200)), ("3", _bgp(200))], None),
        # tie-breakers keep both advertisers
        ([("2", _bgp(2, True)), ("3", _bgp(1, True))],
         lambda r: r.best_prefix_entry.mv == _mv(2, tie_breaker=True)
         and nh_names(r) >= {"2", "3"}),
        # the winner flips to the neighbour
        ([("2", _bgp(300)), ("4", _bgp(200))],
         lambda r: "2" in nh_names(r) and r.best_prefix_entry.mv == _mv(300)),
        # min_nexthop above the path count withdraws
        ([("4", _bgp(200, min_nexthop=3))], None),
    ],
    ids=["winner", "plain_tie", "tie_breaker", "flip", "min_nexthop"],
)
def test_bgp_metric_vector_ksp2(entries, check):
    db, _ = route_db_trio("1", square_dbs(), entries)
    if check is None:
        assert PFX not in db.unicast_routes
    else:
        assert check(db.unicast_routes[PFX])


def test_failing_device_prefetch_raises_and_counts(monkeypatch):
    """A masked run that fails on the device is not answered by the host
    recursion: the solver raises, and Decision counts the failed rebuild
    and keeps its pending updates."""
    from test_torch_decision import DecisionPair, adj_val, prefix_val

    p = DecisionPair(with_static=False).run()
    try:
        solver = p.port.spf_solver

        def lost(*args, **kwargs):
            raise RuntimeError("masked run lost")

        monkeypatch.setattr(solver.spf.engine, "forward", lost)
        kv = {
            pt.adj_key(n): adj_val(n, [adj(n, o) for o in nb], label=100 + int(n))
            for n, nb in {"1": "23", "2": "14", "3": "14", "4": "23"}.items()
        }
        k, v = prefix_val("4", PFX, entry=_entry())
        kv[k] = v
        p.sides["port"][0].push(pt.Publication(key_vals=kv, area="0"))
        deadline = time.monotonic() + 10
        while (
            p.port.get_counters()["decision.route_rebuild_failures"] < 1
            and time.monotonic() < deadline
        ):
            time.sleep(0.01)
        assert p.port.get_counters()["decision.route_rebuild_failures"] >= 1
        assert "decision.device_fallbacks" not in solver.counters
        assert p.port.pending_updates.needs_full_rebuild
        with pytest.raises(RuntimeError, match="masked run lost"):
            solver.build_route_db(p.port.area_link_states, p.port.prefix_state)
    finally:
        p.close()


# -- fused dual-plane KSP2 (ops.ksp) -------------------------------------------


@pytest.fixture(scope="module")
def fused():
    topo = wan(768, seed=11)
    e = topo.n_edges
    rng = np.random.default_rng(17)
    te = topo.edge_metric.copy()
    te[:e] = rng.integers(1, 101, size=e).astype(np.int32)
    dests = rng.choice(np.arange(1, topo.n_nodes), size=8, replace=False).astype(np.int32)
    rev = build_reverse_edge_ids(topo.edge_src[:e], topo.edge_dst[:e])
    np.testing.assert_array_equal(rev, np.asarray(j_reverse_ids(topo.edge_src[:e], topo.edge_dst[:e])))
    runner = SpfRunner(
        build_ell(topo.edge_src, topo.edge_dst, topo.edge_metric, topo.edge_up,
                  topo.node_overloaded, e),
        build_banded(topo.edge_src, topo.edge_dst, e, topo.n_nodes),
        topo.edge_src, topo.edge_dst, topo.edge_metric, topo.edge_up,
        topo.node_overloaded, e,
    )
    runner.stage(CPU)
    planes = [topo.edge_metric, te]
    fk = FusedKsp2Runner(runner, topo.edge_dst, e, topo.n_nodes, rev, planes)
    jfk = JFusedKsp2Runner(topo.runner, topo.edge_dst, e, topo.n_nodes, rev, planes)
    return topo, fk, jfk, dests, fk.run(0, dests), jfk.run(0, dests)


FIELDS = ("k1", "k2", "excl", "ok_base", "ok_masked", "trace_ok")


def test_fused_results_equal_reference(fused):
    _topo, fk, jfk, _dests, res, jres = fused
    for r, jr in zip(res, jres):
        for f in FIELDS:
            np.testing.assert_array_equal(
                getattr(r, f).cpu().numpy(), np.asarray(getattr(jr, f)), err_msg=f
            )
        assert bool(r.ok_base) and bool(r.ok_masked) and bool(r.trace_ok)
    assert (fk.runner.hint, fk.runner.hint_masked) == (jfk.runner.hint, jfk.runner.hint_masked)
    assert fk.learned_max_hops == jfk.learned_max_hops


def test_fused_traces_are_shortest_and_k2_at_least_k1(fused):
    topo, fk, _jfk, _dests, res, _ = fused
    e = topo.n_edges
    for plane, r in zip(fk.planes_np, res):
        k1, k2, excl = (t.numpy() for t in (r.k1, r.k2, r.excl))
        for i in range(len(k1)):
            ee = excl[i][excl[i] < e]
            assert plane[ee].sum() == k1[i]
        finite = k2 < INF32
        assert np.all(k2[finite] >= k1[finite])


def test_fused_non_adaptive_reuses_hints(fused):
    _topo, fk, jfk, dests, _res, _ = fused
    h = (fk.runner.hint, fk.runner.hint_masked)
    res = fk.run(0, np.roll(dests, 1), adaptive=False)
    jres = jfk.run(0, np.roll(dests, 1), adaptive=False)
    assert (fk.runner.hint, fk.runner.hint_masked) == h
    for r, jr in zip(res, jres):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(r, f).numpy(), np.asarray(getattr(jr, f)))


def test_fused_needs_bands_and_a_padding_edge():
    dbs = adj_dbs({"1": [adj("1", "2")], "2": [adj("2", "1")]})
    csr = CsrTopology.from_link_state(link_states(dbs)[0])
    runner = SpfRunner(csr.ell, None, *(getattr(csr, f) for f in (
        "edge_src", "edge_dst", "edge_metric", "edge_up", "node_overloaded")), csr.n_edges)
    runner.stage(CPU)
    with pytest.raises(ValueError, match="banded"):
        FusedKsp2Runner(runner, csr.edge_dst, csr.n_edges, csr.n_nodes, [], [csr.edge_metric])


def test_in_start_contract():
    topo = wan(512, seed=2)
    e = topo.n_edges
    s = build_in_start(topo.edge_dst, e, topo.n_nodes)
    assert s[0] == 0 and s[-1] == e
    for v in (0, 17, 200, topo.n_nodes - 1):
        assert np.all(topo.edge_dst[np.arange(s[v], s[v + 1])] == v)
