"""The port's ELL fallback against openr_tpu's, bit for bit.

Topologies without bands (small rings, the 4-node square, fat-trees,
disconnected graphs) take the bucketed-ELL relax in both packages: the
same relabelling and buckets (`build_ell`), the same fixed-sweep relax
and convergence verdicts (`batched_sssp_ell`, `spf_forward_ell_sweeps`),
the same adaptive sweep hint and fleet product (`reduced_all_sources`,
uint16 distances in both, compared raw), and the same route DBs.  Integer min-plus: tolerance 0.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.decision.fleet import _reverse_runner as j_reverse_runner
from openr_tpu.decision.spf_solver import SpfSolver as JSpfSolver
from openr_tpu.ops import allsources as jasrc
from openr_tpu.ops import sssp as jsssp
from openr_tpu_torch.decision.fleet import _reverse_runner
from openr_tpu_torch.decision.spf_solver import SpfSolver
from openr_tpu_torch.ops import allsources as asrc
from openr_tpu_torch.ops import sssp
from openr_tpu_torch.utils import topo

from torch_parity import (
    adj,
    adj_dbs,
    link_states,
    mirrors,
    normalized_routes,
    overload,
    prefix_states,
    square_dbs,
)

CPU = torch.device("cpu")


def _two_rings():
    """Two disconnected rings of 9 and 7 nodes."""
    dbs = topo.ring_topology(9)
    for db in topo.ring_topology(7):
        db.this_node_name = "s" + db.this_node_name
        db.node_label += 100
        for a in db.adjacencies:
            a.other_node_name = "s" + a.other_node_name
        dbs.append(db)
    return dbs


def _down_link_ring():
    """A 12-ring with metrics 1..12 whose r0 - r1 link is down (r0's
    adjacency is overloaded) and r5 drained."""
    n = 12
    names = [f"r{i:02d}" for i in range(n)]
    adj_map = {
        names[i]: [
            adj(names[i], names[(i + d) % n], metric=1 + (i * 7 + d) % 12,
                is_overloaded=(i, d) == (0, 1))
            for d in (1, -1)
        ]
        for i in range(n)
    }
    return adj_dbs(
        adj_map, labels={m: 200 + i for i, m in enumerate(names)},
        overloaded={names[5]},
    )


# name -> (port AdjacencyDatabases, destination ids); none is banded
CASES = {
    "ring20": (lambda: topo.ring_topology(20), [0, 3, 11, 19]),
    "square": (square_dbs, [0, 3]),
    "fat_tree2": (lambda: topo.fat_tree_topology(2), [0, 5, 9]),
    "fat_tree3": (lambda: topo.fat_tree_topology(3), [1, 4, 13, 17]),
    "fat_tree4_wide": (
        lambda: topo.fat_tree_topology(4, 2, 3, 5, 4), [0, 9, 20, 31]
    ),
    "fat_tree3_drained_fsw": (
        lambda: overload(topo.fat_tree_topology(3), 4), [1, 4, 13, 17]
    ),
    "down_link_and_drain": (_down_link_ring, [0, 1, 5, 8]),
    "two_components": (_two_rings, [0, 4, 10, 15]),
    # an anycast pair: two destinations of one prefix, far apart
    "anycast_pair": (lambda: topo.ring_topology(20), [2, 12]),
}


def _mirrors(name):
    build, dests = CASES[name]
    csr, jcsr = mirrors(build())
    return csr, jcsr, dests


def _runners(csr, jcsr):
    runner = _reverse_runner(csr)
    jrunner = j_reverse_runner(jcsr)
    assert runner.bg is None and jrunner.bg is None
    runner.stage(CPU)
    return runner, jrunner


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_ell_equals_reference(name):
    csr, jcsr, _ = _mirrors(name)
    runner, jrunner = _runners(csr, jcsr)
    ell, jell = runner.ell, jrunner.ell
    for attr in ("new_of_old", "old_of_new"):
        np.testing.assert_array_equal(
            getattr(ell, attr), np.asarray(getattr(jell, attr)), err_msg=attr
        )
    assert len(ell.buckets) == len(jell.buckets)
    for b, (bk, jbk) in enumerate(zip(ell.buckets, jell.buckets)):
        for field in bk._fields:
            np.testing.assert_array_equal(
                getattr(bk, field),
                np.asarray(getattr(jbk, field)),
                err_msg=f"bucket {b} {field}",
            )


def test_build_ell_buckets_of_the_fabric_shape():
    """BASELINE config #2's shape at 3 pods: spines (in-degree 3) and
    fabric switches (24 spines + 100 racks) in K 4 and K 128 buckets,
    racks and padding rows at the K = 4 floor."""
    csr, _ = mirrors(
        topo.fat_tree_topology(
            3, n_planes=4, n_fsw_per_pod=4, n_rsw_per_pod=100,
            n_ssw_per_plane=24,
        )
    )
    ell = _reverse_runner(csr).ell
    shapes = [tuple(bk.nbr.shape) for bk in ell.buckets]
    assert shapes == [(12, 128), (csr.node_capacity - 12, 4)]


def _jax_ell_inputs(jrunner, dests):
    _, _, met, up, ov = jrunner.arrays
    return jnp.asarray(np.asarray(dests, dtype=np.int32)), met, up, ov


@pytest.mark.parametrize("name", ["ring20", "down_link_and_drain"])
def test_fixed_sweep_relax_equals_reference(name):
    """Sweep counts too small to converge and past convergence: equal
    distances and equal verdicts."""
    csr, jcsr, dests = _mirrors(name)
    runner, jrunner = _runners(csr, jcsr)
    st = runner.call_arrays()
    jsrc, jmet, jup, jov = _jax_ell_inputs(jrunner, dests)
    src = torch.as_tensor(np.asarray(dests, dtype=np.int32))
    n_cap = csr.node_capacity
    verdicts = []
    for n_sweeps in (1, 3, 12):
        d0 = sssp.make_dist0_T(src, st.ell.new_of_old, n_cap)
        jd0 = jsssp.make_dist0_T(
            jsrc, jnp.asarray(jrunner.ell.new_of_old), n_cap
        )
        np.testing.assert_array_equal(d0.numpy(), np.asarray(jd0))
        d, ok = sssp.batched_sssp_ell(
            d0, st.ell, st.edge_up, st.node_overloaded, st.edge_metric,
            n_sweeps,
        )
        jd, jok = jsssp.batched_sssp_ell(
            jd0, jrunner.ell, edge_up=jup, node_overloaded=jov,
            edge_metric=jmet, n_sweeps=n_sweeps,
        )
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        assert ok == bool(jok), n_sweeps
        dist, _, ok = sssp.spf_forward_ell_sweeps(
            src, st.ell, st.edge_metric, st.edge_up, st.node_overloaded,
            n_sweeps,
        )
        jdist, _, jok = jsssp.spf_forward_ell_sweeps(
            jsrc, jrunner.ell, *jrunner.arrays, n_sweeps=n_sweeps,
            want_dag=False, transpose=False,
        )
        np.testing.assert_array_equal(dist.numpy(), np.asarray(jdist))
        assert ok == bool(jok), n_sweeps
        verdicts.append(ok)
    assert verdicts[0] is False and verdicts[-1] is True


def test_chunked_slots_equal_one_chunk(monkeypatch):
    """Gathering one slot per chunk gives the relax of one chunk per
    bucket: min over slots is exact in any grouping."""
    csr, jcsr, dests = _mirrors("fat_tree4_wide")
    runner, _ = _runners(csr, jcsr)
    src = torch.as_tensor(np.asarray(dests, dtype=np.int32))
    st = runner.call_arrays()
    args = (src, st.ell, st.edge_metric, st.edge_up, st.node_overloaded, 3)
    whole = sssp.spf_forward_ell_sweeps(*args)
    monkeypatch.setattr(sssp, "CHUNK_ELEMS", 1)
    single = sssp.spf_forward_ell_sweeps(*args)
    assert torch.equal(whole[0], single[0]) and whole[2] == single[2]


def _reference_product(jcsr, jrunner, dests):
    jout = jasrc.build_out_ell(
        jcsr.edge_src, jcsr.edge_dst, jcsr.n_edges, jcsr.n_nodes,
        out_slot=jcsr.out_slot,
    )
    dist, bitmap, ok = jasrc.reduced_all_sources(
        np.asarray(dests, dtype=np.int32), jrunner, jout,
        jcsr.edge_metric, jcsr.edge_up, jcsr.node_overloaded,
    )
    return np.asarray(dist), np.asarray(bitmap), ok


@pytest.mark.parametrize("name", sorted(CASES))
def test_reduced_all_sources_without_bands_equals_reference(name):
    csr, jcsr, dests = _mirrors(name)
    runner, jrunner = _runners(csr, jcsr)
    # learn the hint from 1 on the first cases, from the default on the rest
    if name in ("ring20", "fat_tree2", "two_components"):
        runner.hint = jrunner.hint = 1
    jdist, jbitmap, jok = _reference_product(jcsr, jrunner, dests)
    out = asrc.build_out_ell(
        csr.edge_src, csr.edge_dst, csr.n_edges, csr.n_nodes, csr.out_slot
    )
    dist, bitmap, ok = asrc.reduced_all_sources(
        dests, runner, out, csr.edge_metric, csr.edge_up, csr.node_overloaded
    )
    assert ok is True and jok is True
    assert tuple(dist.shape) == (csr.node_capacity, len(dests))
    # the reference's dtype (uint16: every metric is below 5000) and raw
    # values, INF16 sentinels included
    assert dist.dtype == torch.uint16 and jdist.dtype == np.uint16
    np.testing.assert_array_equal(dist.numpy(), jdist)
    np.testing.assert_array_equal(bitmap.numpy().view(np.uint32), jbitmap)
    assert runner.hint == jrunner.hint
    assert runner.sweeps > 0
    if name == "two_components":
        assert (dist.numpy()[: csr.n_nodes] == sssp.INF16).any()


def test_ell_path_refuses_a_warm_start():
    csr, jcsr, dests = _mirrors("ring20")
    runner, _ = _runners(csr, jcsr)
    out = asrc.build_out_ell(
        csr.edge_src, csr.edge_dst, csr.n_edges, csr.n_nodes, csr.out_slot
    )
    init = torch.zeros((csr.node_capacity, len(dests)), dtype=torch.int32)
    with pytest.raises(ValueError, match="warm"):
        asrc.reduced_all_sources(
            dests, runner, out, csr.edge_metric, csr.edge_up,
            csr.node_overloaded, init_dist=init,
        )


ROUTE_CASES = {
    "ring20": lambda: topo.ring_topology(20),
    "fat_tree3": lambda: topo.fat_tree_topology(3),
    "down_link_and_drain": _down_link_ring,
}


@pytest.mark.parametrize("name", sorted(ROUTE_CASES))
def test_route_dbs_through_ell_equal_reference_every_node(name):
    ls, jls = link_states(ROUTE_CASES[name]())
    names = ls.node_names
    ps, jps = prefix_states(names, every=3)
    solver = SpfSolver(names[0], device="cpu")
    got = solver.fleet_route_dbs({"0": ls}, ps)
    view = solver.fleet._views[ls]
    assert view._runner.bg is None and not view.node_sharded
    counters = solver.engine.counters
    assert counters["device.engine.ell_sweeps"] > 0
    assert counters["device.engine.kernel_launches"] == 0
    jsolver = JSpfSolver(names[0])
    for node in names:
        want = jsolver.build_route_db({"0": jls}, jps, my_node_name=node)
        assert normalized_routes(got[node]) == normalized_routes(want), node


@pytest.mark.cuda
def test_ell_product_on_card_equals_cpu():
    """The ELL product on the card equals the port's CPU product on the
    same inputs (runs with `-m cuda` on a machine with a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    csr, _, dests = _mirrors("fat_tree3_drained_fsw")
    out = asrc.build_out_ell(
        csr.edge_src, csr.edge_dst, csr.n_edges, csr.n_nodes, csr.out_slot
    )
    results = []
    for device in ("cpu", "cuda"):
        runner = _reverse_runner(csr)
        runner.hint = 1
        runner.stage(torch.device(device))
        dist, bitmap, ok = asrc.reduced_all_sources(
            dests, runner, out, csr.edge_metric, csr.edge_up,
            csr.node_overloaded,
        )
        assert ok and dist.device.type == device
        results.append((dist.cpu(), bitmap.cpu(), runner.hint, runner.sweeps))
    (d0, b0, h0, s0), (d1, b1, h1, s1) = results
    assert torch.equal(d0, d1) and torch.equal(b0, b1) and (h0, s0) == (h1, s1)
