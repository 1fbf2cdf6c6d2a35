"""The port's fleet product and route build against openr_tpu's.

`reduced_all_sources` (plain PyTorch on the CPU) against the reference's
`reduced_all_sources` with its Pallas epilogue pinned to interpret mode,
on the TestEpilogueParity families (tests/test_pallas.py): equal
(dist, bitmap, ok) and the same taught sweep hint.  Then the whole slice:
`SpfSolver.fleet_route_dbs(device="cpu")` against the reference solver's
host-oracle route build for every node, unicast and MPLS routes
compared in a normalized (prefix -> sorted next hops) form.  Integer
min-plus: tolerance 0.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from benchmarks import synthetic
from openr_tpu.decision.fleet import _reverse_runner as j_reverse_runner
from openr_tpu.decision.spf_solver import SpfSolver as JSpfSolver
from openr_tpu.ops import allsources as jasrc
from openr_tpu.ops import pallas_kernels as pk
from openr_tpu_torch.decision.csr import ARRAY_FIELDS, CsrTopology
from openr_tpu_torch.decision.fleet import FleetViewCache, _reverse_runner
from openr_tpu_torch.decision.spf_solver import SpfSolver
from openr_tpu_torch.ops import allsources as asrc
from openr_tpu_torch.ops.banded import _RelaxOps
from openr_tpu_torch.ops.sssp import u16_to_i32
from openr_tpu_torch.utils import topo

from torch_parity import (
    FAMILIES,
    link_states,
    mirrors,
    normalized_routes,
    overload,
    prefix_states,
)


def _wan96():
    ref = synthetic.wan(96, chords=2, seed=3)
    fields = {name: getattr(ref, name) for name in ARRAY_FIELDS}
    fields["n_edges"] = ref.n_edges
    names = topo.node_names(96, "w")
    return CsrTopology.from_arrays(fields, names), ref


PRODUCT_CASES = {
    # TestEpilogueParity (tests/test_pallas.py): odd-N ring, grid,
    # wan-shaped with chords, drained ring node, drained grid node
    "ring_odd_n": (lambda: mirrors(topo.ring_topology(65)), [0, 7, 31, 64]),
    "grid": (lambda: mirrors(topo.grid_topology(10)), list(range(0, 100, 9))),
    "wan_shaped_chords": (_wan96, [0, 5, 17, 48, 95]),
    # the drained cases keep their undrained twin's destination count,
    # so the reference's compiled programs are reused
    "ring_drained_node": (
        lambda: mirrors(overload(topo.ring_topology(65), 7)),
        [0, 7, 40, 64],
    ),
    "grid_drained_node": (
        lambda: mirrors(overload(topo.grid_topology(10), 37)),
        [0, 9, 18, 27, 37, 45, 54, 63, 72, 81, 99],
    ),
}


def _reference_product(jtopo, dest_ids):
    if hasattr(jtopo, "node_id"):
        runner = j_reverse_runner(jtopo)
        out_slot = jtopo.out_slot
    else:
        runner = synthetic.reversed_topology(jtopo).runner
        out_slot = None
    out = jasrc.build_out_ell(
        jtopo.edge_src,
        jtopo.edge_dst,
        int(jtopo.n_edges),
        int(jtopo.n_nodes),
        out_slot=out_slot,
    )
    counters: dict = {}
    dist, bitmap, ok = jasrc.reduced_all_sources(
        np.asarray(dest_ids, dtype=np.int32),
        runner,
        out,
        jtopo.edge_metric,
        jtopo.edge_up,
        jtopo.node_overloaded,
        maps=jasrc.build_epilogue_maps(runner.bg, out),
        pallas_run=lambda kind, pt, xt: pk.run_with_fallback(
            kind, pt, xt, counters=counters, mode="interpret"
        ),
    )
    assert counters == {"device.engine.pallas_products": 1}, counters
    n = int(jtopo.n_nodes)
    return (
        np.asarray(jax.device_get(dist))[:n],
        np.asarray(jax.device_get(bitmap))[:n],
        ok,
        runner.hint,
    )


@pytest.mark.parametrize("name", sorted(PRODUCT_CASES))
def test_reduced_all_sources_matches_reference(name):
    build, dests = PRODUCT_CASES[name]
    csr, jtopo = build()
    jdist, jbitmap, jok, jhint = _reference_product(jtopo, dests)

    runner = _reverse_runner(csr)
    runner.stage(torch.device("cpu"))
    out = asrc.build_out_ell(
        csr.edge_src, csr.edge_dst, csr.n_edges, csr.n_nodes, csr.out_slot
    )
    dist, bitmap, ok = asrc.reduced_all_sources(
        dests, runner, out, csr.edge_metric, csr.edge_up, csr.node_overloaded
    )
    assert ok is True and jok is True
    # the reference's dtype (uint16: every metric is below 5000) and raw
    # values, INF16 sentinels included
    assert dist.dtype == torch.uint16 and jdist.dtype == np.uint16
    assert bitmap.dtype == torch.int32
    np.testing.assert_array_equal(dist.numpy(), jdist)
    np.testing.assert_array_equal(bitmap.numpy().view(np.uint32), jbitmap)
    assert runner.hint == jhint
    # one exact relax pass in the 16-bit domain leaves the fixed point
    # unchanged
    ops = _RelaxOps(
        runner.bg,
        runner.call_arrays(),
        0 if runner.chord_mode else runner.depth,
        runner.resid_rounds,
        runner.chord_mode,
        small_dist=True,
    )
    d = u16_to_i32(dist)
    assert torch.equal(ops.verify(d), d)


ROUTE_CASES = {
    "ring65": lambda: topo.ring_topology(65),
    "ring65_drained": lambda: overload(topo.ring_topology(65), 7),
    "wan256": FAMILIES["wan256"],
}


@pytest.mark.parametrize("name", sorted(ROUTE_CASES))
def test_fleet_route_dbs_match_reference_every_node(name):
    dbs = ROUTE_CASES[name]()
    ls, jls = link_states(dbs)
    names = ls.node_names
    ps, jps = prefix_states(names)

    solver = SpfSolver(names[0], device="cpu")
    got = solver.fleet_route_dbs({"0": ls}, ps)
    counters = dict(solver.engine.counters)
    # the one dispatch is timed, as the reference's is
    assert counters.pop("device.engine.dispatch_us") >= 0
    assert counters == {
        "device.engine.dispatches": 1,
        # CPU tensors: plain versions, no kernel launched
        "device.engine.kernel_launches": 0,
        "device.engine.kernel_launches.fused_epilogue": 0,
        "device.engine.kernel_launches.blocked_outer": 0,
        "device.engine.kernel_launches.fused_epilogue.int32": 0,
        "device.engine.kernel_launches.fused_epilogue.uint16": 0,
        # banded and cold: no ELL sweep, no affected-set pass; small
        # metrics: the uint16 mode, which does not saturate
        "device.engine.ell_sweeps": 0,
        "device.engine.affected_passes": 0,
        "device.engine.small_dist_retries": 0,
    }
    jsolver = JSpfSolver(names[0])
    assert sorted(got) == names
    n_unicast = n_mpls = 0
    for node in names:
        want = jsolver.build_route_db({"0": jls}, jps, my_node_name=node)
        mine, theirs = normalized_routes(got[node]), normalized_routes(want)
        assert mine == theirs, node
        n_unicast += len(mine[0])
        n_mpls += len(mine[1])
    assert n_unicast > len(names) and n_mpls > len(names)


def _view_pair(name):
    from openr_tpu.decision.fleet import FleetViewCache as JFleetViewCache
    from openr_tpu.decision.fleet import fleet_destinations as j_dests

    from openr_tpu_torch.decision.fleet import fleet_destinations

    ls, jls = link_states(FAMILIES[name]())
    ps, jps = prefix_states(ls.node_names, every=9, anycast=False)
    dests = fleet_destinations(ls, ps)
    assert dests == j_dests(jls, jps)
    view = FleetViewCache().view(ls, dests, device="cpu")
    view.prefetch_rows(ls.node_names)
    assert view.converged
    return ls, jls, dests, view


def test_view_next_hops_match_reference_view():
    """The decoded bitmap of the port's view names the same ECMP
    neighbours as the reference's view, for every (router, dest)."""
    from openr_tpu.decision.fleet import FleetViewCache as JFleetViewCache

    ls, jls, dests, view = _view_pair("wan256")
    jview = JFleetViewCache(delta=False).view(jls, dests)
    for node in ls.node_names[::4]:
        for dest in dests:
            assert view.dist(node, dest) == jview.dist(node, dest)
            assert view.next_hop_neighbors(node, dest) == (
                jview.next_hop_neighbors(node, dest)
            ), (node, dest)


def test_two_word_bitmap_matches_host_dijkstra():
    """On the hub (33 neighbours, two bitmap words) the decoded next hops
    are the first hops of the host Dijkstra's shortest paths."""
    ls, _, dests, view = _view_pair("hub_w2")
    hub = ls.node_names[0]
    assert len(view.csr.slot_neighbors(hub)) == 33
    assert view._bitmap_dev.shape[2] == 2
    for node in ls.node_names:
        spf = ls.get_spf_result(node)
        for dest in dests:
            assert view.dist(node, dest) == spf[dest].metric
            assert view.next_hop_neighbors(node, dest) == (
                spf[dest].next_hops
            ), (node, dest)


def test_view_cache_reuses_and_recomputes():
    ls, _ = link_states(topo.ring_topology(65))
    cache = FleetViewCache()
    dests = ["r0", "r7"]
    view = cache.view(ls, dests, device="cpu")
    assert cache.view(ls, dests, device="cpu") is view
    assert cache.view(ls, ["r0"], device="cpu") is not view
    assert cache.view(ls, [], device="cpu") is None


def test_ring20_without_bands_matches_reference():
    """A ring below the band floor takes the ELL fallback and gives the
    reference's view: distances, decoded next hops and sweep hint."""
    from openr_tpu.decision.fleet import FleetViewCache as JFleetViewCache

    ls, jls = link_states(topo.ring_topology(20))  # below the band floor
    dests = ["r0", "r7"]
    view = FleetViewCache().view(ls, dests, device="cpu")
    jview = JFleetViewCache(delta=False).view(jls, dests)
    assert view._runner.bg is None and jview._runner.bg is None
    assert view.sweep_hint == jview.sweep_hint
    jdist = np.asarray(jview._dist_dev)
    assert view._dist_dev.dtype == torch.uint16 and jdist.dtype == np.uint16
    np.testing.assert_array_equal(view._dist_dev.numpy(), jdist)
    for node in ls.node_names:
        for dest in dests:
            assert view.dist(node, dest) == jview.dist(node, dest)
            assert view.next_hop_neighbors(node, dest) == (
                jview.next_hop_neighbors(node, dest)
            ), (node, dest)
