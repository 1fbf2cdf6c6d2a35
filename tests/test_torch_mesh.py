"""The port's mesh-sharded SPF steps, sharded fleet product and mesh
prefetch against openr_tpu's, bit for bit.

Counterpart of tests/test_parallel_mesh.py: the reference runs on its 8
virtual CPU devices (`eight_cpu_devices`), the port on a CPU mesh of the
same shape (`make_mesh(["cpu"] * 8)`), plain versions throughout (K1
runs its plain version on CPU tensors).  `make_mesh`'s shapes and
errors; `spf_step_sharded` / `whatif_step_sharded` on batch-only and
2-D meshes against the reference's and the port's unsharded ELL
forwards; the layout's linear scaling, structurally (each shard's state
and the distance bytes moved between shards; the reference's XLA cost
analysis has no counterpart); `fleet_product_sharded` at the uint16 and
int32 widths, too few sweeps, saturation and the drain rule;
`prefetch_via_mesh`'s SpfResults and route databases; and the
`mesh.blocked.*` surface of the daemon and the fuzzer.  Integer
min-plus: tolerance 0.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from openr_tpu.decision import fleet as jfleet
from openr_tpu.decision.spf_solver import DeviceSpfBackend as JDeviceSpfBackend
from openr_tpu.decision.spf_solver import SpfSolver as JSpfSolver
from openr_tpu.ops import allsources as jasrc
from openr_tpu.ops import sssp as jsssp
from openr_tpu.parallel import mesh as jmesh_mod
from openr_tpu_torch.decision import fleet as pfleet
from openr_tpu_torch.decision.spf_solver import DeviceSpfBackend, SpfSolver
from openr_tpu_torch.ops import allsources as asrc
from openr_tpu_torch.ops import sssp
from openr_tpu_torch.parallel import mesh as pmesh
from openr_tpu_torch.utils import topo

from torch_parity import (
    link_states,
    mirrors,
    normalized_routes,
    overload,
    prefix_states,
    spf_key,
)

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def eight_cpu_devices():
    devices = jax.devices("cpu")
    if len(devices) < 8:
        pytest.skip("needs xla_force_host_platform_device_count=8")
    return devices[:8]


def _pad_sources(n: int, batch_axis: int) -> np.ndarray:
    sources = np.arange(n, dtype=np.int32)
    pad = (-n) % batch_axis
    return np.concatenate([sources, np.zeros(pad, dtype=np.int32)])


def _arrays(csr):
    return (csr.edge_src, csr.edge_dst, csr.edge_metric, csr.edge_up,
            csr.node_overloaded)


def _t(csr):
    """The port mirror's arrays as CPU tensors (the unsharded forwards)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in _arrays(csr))


def test_make_mesh_shapes_and_errors(eight_cpu_devices):
    """TestMeshValidation.test_make_mesh_indivisible_raises_valueerror on
    the port: the reference's shapes and messages."""
    for batch in (None, 4, 2, 1, 8):
        want = jmesh_mod.make_mesh(eight_cpu_devices, batch_axis=batch)
        got = pmesh.make_mesh(CPU8, batch_axis=batch)
        assert got.shape == dict(want.shape) and got.axis_names == ("batch", "node")
        assert got.devices.shape == want.devices.shape
    for batch in (3, 0, 16):
        with pytest.raises(ValueError) as want:
            jmesh_mod.make_mesh(eight_cpu_devices, batch_axis=batch)
        with pytest.raises(ValueError) as got:
            pmesh.make_mesh(CPU8, batch_axis=batch)
        assert str(got.value) == str(want.value)


# -- the SPF steps -------------------------------------------------------------


@pytest.mark.parametrize("batch_axis", [8, 4], ids=["batch_only", "4x2"])
def test_spf_step_matches_reference_and_unsharded(eight_cpu_devices, batch_axis):
    """TestMeshSpf on the port: distances and SP-DAG of a 4x4 grid over
    a batch-only and a 4x2 mesh equal the reference's sharded step and
    the port's unsharded `spf_forward_ell`."""
    csr, jcsr = mirrors(topo.grid_topology(4))
    sources = _pad_sources(csr.n_nodes, batch_axis)
    jm = jmesh_mod.make_mesh(eight_cpu_devices, batch_axis=batch_axis)
    jdist, jdag = jmesh_mod.sharded_spf_forward(jm, sources, jcsr.ell, *_arrays(jcsr))
    mesh = pmesh.make_mesh(CPU8, batch_axis=batch_axis)
    dist, dag = pmesh.sharded_spf_forward(mesh, sources, csr.ell, *_arrays(csr))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jdist))
    np.testing.assert_array_equal(dag.numpy(), np.asarray(jdag))
    udist, udag = sssp.spf_forward_ell(
        torch.from_numpy(sources), csr.ell.to("cpu"), *_t(csr)
    )
    assert torch.equal(dist, udist) and torch.equal(dag, udag)
    a, b = csr.node_id["node-0-0"], csr.node_id["node-3-3"]
    assert dist[a, b] == dist[b, a] == 6 and dist[a, a] == 0


def _failure_masks(csr, n_rows: int, seed: int, both_ways: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    fail = rng.integers(0, csr.n_edges, size=n_rows)
    mask = np.ones((n_rows, csr.edge_capacity), dtype=bool)
    links = csr.edges_of_links()
    for row, e in enumerate(fail):
        mask[row, e] = False
        if both_ways:
            for e2 in links[csr.edge_links[e][0]]:
                mask[row, e2] = False
    return mask


@pytest.mark.parametrize(
    "side,rows,batch_axis,both_ways",
    [(6, 16, 4, True), (8, 128, 8, False)],
    ids=["grid6_4x2", "grid8_128_batch_only"],
)
def test_whatif_step_matches_reference_and_masked(
    eight_cpu_devices, side, rows, batch_axis, both_ways
):
    """TestMeshWhatIf / test_whatif_fleet_1k_variants on the port: one
    failed link (or directed edge) per row, equal to the reference's
    sharded step and the port's unsharded `spf_forward_ell_masked`."""
    csr, jcsr = mirrors(topo.grid_topology(side))
    mask = _failure_masks(csr, rows, seed=side, both_ways=both_ways)
    rng = np.random.default_rng(7)
    sources = rng.integers(0, csr.n_nodes, size=rows).astype(np.int32)
    jm = jmesh_mod.make_mesh(eight_cpu_devices, batch_axis=batch_axis)
    jstep = jmesh_mod.whatif_step_sharded(jm)
    s_repl = NamedSharding(jm, P())
    jdist, jdag = jstep(
        jax.device_put(sources, NamedSharding(jm, P("batch"))),
        jax.device_put(jcsr.ell, s_repl),
        *(jax.device_put(np.asarray(a), s_repl) for a in _arrays(jcsr)),
        jax.device_put(mask.T.copy(), NamedSharding(jm, P(None, "batch"))),
    )
    step = pmesh.whatif_step_sharded(pmesh.make_mesh(CPU8, batch_axis=batch_axis))
    dist, dag = step(sources, csr.ell, *_arrays(csr), mask.T.copy())
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jdist))
    np.testing.assert_array_equal(dag.numpy(), np.asarray(jdag))
    udist, udag = sssp.spf_forward_ell_masked(
        torch.from_numpy(sources), csr.ell.to("cpu"), *_t(csr), torch.from_numpy(mask)
    )
    assert torch.equal(dist, udist) and torch.equal(dag, udag)
    with pytest.raises(ValueError, match="mask"):
        step(sources, csr.ell, *_arrays(csr))


def test_layout_scales_linearly_by_structure():
    """The scaling claim behind the layout (TestShardingLinearity, whose
    XLA cost analysis has no counterpart): on a batch-only mesh each
    shard relaxes [N_cap, S/b] and no distance moves between shards; on
    a 4x2 mesh each shard relaxes [N_cap/2, S/4] and the bytes moved are
    the modeled all-gathers, one of the whole [N_cap, S/4] state per
    sweep and batch shard."""
    csr, _ = mirrors(topo.grid_topology(8))
    n_cap, s = csr.node_capacity, 64
    sources = np.arange(s, dtype=np.int32)
    step = pmesh.spf_step_sharded(pmesh.make_mesh(CPU8))
    want = step(sources, csr.ell, *_arrays(csr))
    assert step.shard_shapes == [(n_cap, s // 8)] * 8
    assert step.bytes_moved == 0
    step2 = pmesh.spf_step_sharded(pmesh.make_mesh(CPU8, batch_axis=4))
    got = step2(sources, csr.ell, *_arrays(csr))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert step2.shard_shapes == [(n_cap // 2, s // 4)] * 8
    modeled = sum(sweeps * (2 - 1) * n_cap * (s // 4) * 4 for sweeps in step2.sweeps)
    assert step2.bytes_moved == modeled > 0
    assert step2.mesh.bytes_moved == modeled


# -- the sharded fleet product -------------------------------------------------


def _product_case(dbs, n_dests: int, seed: int, extra=()):
    csr, jcsr = mirrors(dbs)
    runner, jrunner = pfleet._reverse_runner(csr), jfleet._reverse_runner(jcsr)
    assert runner.bg is not None and jrunner.bg is not None  # banded path
    rng = np.random.default_rng(seed)
    pool = np.setdiff1d(np.arange(csr.n_nodes), extra)
    dests = np.sort(
        np.concatenate([rng.choice(pool, size=n_dests - len(extra), replace=False),
                        np.asarray(extra, dtype=np.int64)])
    ).astype(np.int32)
    out = asrc.build_out_ell(
        csr.edge_src, csr.edge_dst, csr.n_edges, csr.n_nodes, out_slot=csr.out_slot
    )
    jout = jasrc.build_out_ell(
        jcsr.edge_src, jcsr.edge_dst, int(jcsr.n_edges), int(jcsr.n_nodes),
        out_slot=jcsr.out_slot,
    )
    return csr, jcsr, runner, jrunner, dests, out, jout


def _sharded(csr, jcsr, runner, jrunner, dests, out, jout, devices, n_sweeps, small):
    jstep = jmesh_mod.fleet_product_sharded(
        jmesh_mod.make_mesh(devices), n_sweeps=n_sweeps, n_words=jout.n_words,
        depth=jrunner.depth, resid_rounds=jrunner.resid_rounds, small_dist=small,
        chord_mode=jrunner.chord_mode,
    )
    jd, jb, jok = jstep(
        dests, jrunner.bg, *(jnp.asarray(a) for a in jrunner.arrays), jout,
        jnp.asarray(jcsr.edge_metric), jnp.asarray(jcsr.edge_up),
    )
    step = pmesh.fleet_product_sharded(
        pmesh.make_mesh(CPU8), n_sweeps, out.n_words, depth=runner.depth,
        resid_rounds=runner.resid_rounds, small_dist=small,
        chord_mode=runner.chord_mode,
    )
    d, b, ok = step(dests, runner.bg, *runner.arrays, out, csr.edge_metric, csr.edge_up)
    if small:
        assert d.dtype == torch.uint16 and np.asarray(jd).dtype == np.uint16
        d = d.view(torch.int16).numpy().view(np.uint16)
    else:
        d = d.numpy()
    return (np.asarray(jd), np.asarray(jb), bool(jok)), (d, b.numpy().view(np.uint32), ok)


def _hint(jcsr, jrunner, dests, jout) -> int:
    """The reference's learned sweep count for this product (its
    single-device adaptive run)."""
    _, _, ok = jasrc.reduced_all_sources(
        dests, jrunner, jout, jcsr.edge_metric, jcsr.edge_up, jcsr.node_overloaded
    )
    assert bool(ok)
    return jrunner.hint


def _saturating_wan():
    dbs = topo.wan_topology(256, chords=2, seed=9)
    for db in dbs:
        for a in db.adjacencies:
            a.metric = 4000
    return dbs


@pytest.mark.parametrize(
    "case",
    ["uint16", "int32", "too_few_sweeps", "saturating_uint16"],
)
def test_fleet_product_sharded_matches_reference(eight_cpu_devices, case):
    """TestShardedFleetProduct on the port: wan(256, chords=2, seed=9)
    reversed, 32 destinations over a batch-only mesh of 8: dist, bitmap
    and `ok` equal to the reference's sharded product, at its learned
    sweep count, at one sweep (not converged: `ok` False) and at metric
    4000 in the uint16 mode (saturated: `ok` False)."""
    dbs = _saturating_wan() if case == "saturating_uint16" else topo.wan_topology(
        256, chords=2, seed=9
    )
    csr, jcsr, runner, jrunner, dests, out, jout = _product_case(dbs, 32, 3)
    small = case != "int32"
    if case == "saturating_uint16":
        n_sweeps = 64
    elif case == "too_few_sweeps":
        n_sweeps = 1
    else:
        n_sweeps = _hint(jcsr, jrunner, dests, jout)
    ref, port = _sharded(
        csr, jcsr, runner, jrunner, dests, out, jout, eight_cpu_devices, n_sweeps, small
    )
    np.testing.assert_array_equal(port[0], ref[0])
    np.testing.assert_array_equal(port[1], ref[1])
    assert port[2] is ref[2] is (case in ("uint16", "int32"))


def test_drain_semantics_survive_sharding(eight_cpu_devices):
    """TestShardedFleetProduct.test_drain_semantics_survive_sharding on
    the port: two drained nodes among 16 destinations of wan(128)."""
    dbs = overload(overload(topo.wan_topology(128, chords=2, seed=5), 7), 40)
    csr, jcsr, runner, jrunner, dests, out, jout = _product_case(dbs, 16, 4, (7, 40))
    assert csr.node_overloaded[[7, 40]].all()
    n_sweeps = _hint(jcsr, jrunner, dests, jout)
    ref, port = _sharded(
        csr, jcsr, runner, jrunner, dests, out, jout, eight_cpu_devices, n_sweeps,
        runner.small_dist,
    )
    np.testing.assert_array_equal(port[0], ref[0])
    np.testing.assert_array_equal(port[1], ref[1])
    assert port[2] is ref[2] is True
    # the port's single-device product of the same destinations
    runner.stage(torch.device("cpu"))
    d1, b1, ok1 = asrc.reduced_all_sources(
        dests, runner, out, csr.edge_metric, csr.edge_up, csr.node_overloaded
    )
    assert ok1
    np.testing.assert_array_equal(d1.view(torch.int16).numpy().view(np.uint16), port[0])
    np.testing.assert_array_equal(b1.numpy().view(np.uint32), port[1])


# -- the solver ----------------------------------------------------------------


def test_fabric_mesh_prefetch_route_equality(eight_cpu_devices):
    """test_fat_tree_mesh_prefetch_route_equality on the port: every
    node's SPF prefetched over an 8-shard batch mesh, each SpfResult
    equal to the reference's own mesh prefetch (its solver built with
    `min_device_nodes=1`), and the route databases built from the cache
    equal too, with no further engine query."""
    dbs = topo.fat_tree_topology(4, 2, 2, 16, 4)
    ls, jls = link_states(dbs)
    nodes = ls.node_names
    assert len(nodes) == 80
    ps, jps = prefix_states(nodes, every=4)
    jbackend = JDeviceSpfBackend(min_device_nodes=1, min_device_sources=1)
    jbackend.prefetch_via_mesh(jls, nodes, jmesh_mod.make_mesh(eight_cpu_devices))
    backend = DeviceSpfBackend("cpu")
    mesh = pmesh.make_mesh(CPU8)
    backend.prefetch_via_mesh(ls, nodes, mesh)
    assert backend._mesh_steps[mesh].bytes_moved == 0
    cache, jcache = backend._result_cache(ls), jbackend._result_cache(jls)
    assert sorted(cache) == sorted(jcache) == sorted(nodes)
    for node in nodes:
        assert spf_key(cache[node]) == spf_key(jcache[node]), node
    for me in (nodes[0], nodes[len(nodes) // 2], nodes[-1]):
        got = SpfSolver(me, spf_backend=backend).build_route_db({"0": ls}, ps)
        want = JSpfSolver(me, spf_backend=jbackend).build_route_db({"0": jls}, jps)
        assert normalized_routes(got) == normalized_routes(want), me
    assert backend.engine.get_counters()["device.engine.queries"] == 0
    # the solver's own front-end reaches the same cache
    solver = SpfSolver(nodes[0], device="cpu")
    solver.prefetch_via_mesh(ls, nodes[:8], mesh)
    assert sorted(solver.spf._result_cache(ls)) == sorted(nodes[:8])


# -- the daemon and the fuzzer -------------------------------------------------


def test_daemon_mesh_counter_family_equals_the_references():
    """The daemon's ctrl handler carries the engine's blocked rung as its
    `mesh` surface: its `mesh.*` keys equal the reference daemon's."""
    from openr_tpu.main import OpenrDaemon as JOpenrDaemon
    from openr_tpu.main import fleet_node_config as j_config
    from openr_tpu.spark import MockIoProvider as JMockIoProvider
    from openr_tpu_torch.main import OpenrDaemon, fleet_node_config
    from openr_tpu_torch.spark import MockIoProvider

    port = OpenrDaemon(
        fleet_node_config("mesh-0"), io_provider=MockIoProvider().endpoint("mesh-0"),
        device="cpu",
    )
    ref = JOpenrDaemon(
        j_config("mesh-1"), io_provider=JMockIoProvider().endpoint("mesh-1")
    )
    keys = []
    for d in (port, ref):
        d.start()
        try:
            keys.append(
                {k for k in d.ctrl_server.handler._all_counters() if k.startswith("mesh.")}
            )
        finally:
            d.stop()
    assert keys[0] == keys[1] == set(pmesh_blocked_keys())


def pmesh_blocked_keys():
    from openr_tpu_torch.parallel.blocked import BLOCKED_COUNTER_KEYS

    return BLOCKED_COUNTER_KEYS


def test_fuzz_fingerprint_carries_the_pipeline_fallbacks_key():
    from openr_tpu.chaos import fuzz as rfz
    from openr_tpu_torch.chaos import fuzz as fz

    assert fz._FP_BLOCKED_KEYS == rfz._FP_BLOCKED_KEYS
    assert "mesh.blocked.pipeline_fallbacks" in fz._FP_BLOCKED_KEYS
