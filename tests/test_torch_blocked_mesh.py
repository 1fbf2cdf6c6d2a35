"""The port's blocked APSP rung over a device mesh against openr_tpu's,
bit for bit.

Counterpart of the mesh parts of tests/test_blocked.py: the reference
runs on its 8 virtual CPU devices (`eight_cpu_devices`), the port on a
CPU mesh of the same shape (`make_blocked_mesh(["cpu"] * 8)`), plain
versions throughout (K2 runs its plain version on CPU tensors).  Mesh
validation, the three phases of one round on 2x2 and 2x4 meshes,
whole closures (random graphs, ring / grid / fat-tree / wan, the drain
rule, the 1x1x1 mesh, a batch axis of 2) with their `mesh.blocked.*`
counters, the pipelined loop against the bulk loop with its knobs and
its demotion, K2's plain version at shard extents, and the fleet view's
mesh-shape failure.  Integer min-plus: tolerance 0.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.ops import allsources as jasrc
from openr_tpu.parallel import blocked as blk
from openr_tpu_torch.decision.fleet import FleetViewCache
from openr_tpu_torch.device.engine import DeviceResidencyEngine
from openr_tpu_torch.ops import allsources as asrc
from openr_tpu_torch.ops import blocked_outer as bo
from openr_tpu_torch.parallel import blocked as pblk
from openr_tpu_torch.parallel.blocked import BlockedApspEngine, make_blocked_mesh
from openr_tpu_torch.utils import topo

from torch_parity import link_states, mirrors, overload

INF = 1 << 30
CPU8 = ["cpu"] * 8

# reference mesh kwargs -> the same shape on the port's CPU mesh
SHAPES = {
    "2x4": dict(),
    "2x2x2": dict(batch=2),
    "1x8": dict(rows=1, cols=8),
    "2x2": dict(rows=2, cols=2),
}


@pytest.fixture(scope="module")
def eight_cpu_devices():
    devices = jax.devices("cpu")
    if len(devices) < 8:
        pytest.skip("needs xla_force_host_platform_device_count=8")
    return devices[:8]


def _meshes(devices, shape: str):
    """(reference mesh, port mesh) of one shape; "2x2" takes 4 devices."""
    kw = SHAPES[shape]
    n = 4 if shape == "2x2" else 8
    return (
        blk.make_blocked_mesh(devices[:n], **kw),
        make_blocked_mesh(CPU8[:n], **kw),
    )


def _out(csr):
    return asrc.build_out_ell(
        csr.edge_src, csr.edge_dst, csr.n_edges, csr.n_nodes, out_slot=csr.out_slot
    )


def _jout(jcsr):
    return jasrc.build_out_ell(
        jcsr.edge_src, jcsr.edge_dst, int(jcsr.n_edges), int(jcsr.n_nodes),
        out_slot=jcsr.out_slot,
    )


def _products(dbs, dests, jmesh, mesh, tile, mode):
    """(reference engine, dist, bitmap), (port engine, dist, bitmap) of
    the fleet product of `dbs` on meshes of one shape, the pipeline
    pinned to `mode` in both."""
    csr, jcsr = mirrors(dbs)
    dests = np.asarray(dests, dtype=np.int32)
    jeng = blk.BlockedApspEngine(tile=tile, mesh=jmesh)
    jeng.pipeline_mode = mode
    jd, jb, _ = jeng.fleet_product(jcsr, dests, _jout(jcsr))
    eng = BlockedApspEngine(tile=tile, mesh=mesh)
    eng.pipeline_mode = mode
    d, b, ok = eng.fleet_product(csr, dests, _out(csr))
    assert ok is True
    return (jeng, np.asarray(jd), np.asarray(jb)), (eng, d.numpy(), b.numpy())


COUNTERS = (
    "mesh.blocked.products",
    "mesh.blocked.rounds",
    "mesh.blocked.tile_updates",
    "mesh.blocked.panel_broadcasts",
    "mesh.blocked.bytes_exchanged",
    "mesh.blocked.fallbacks",
    "mesh.blocked.pipeline_rounds_overlapped",
    "mesh.blocked.pipeline_prefetch_issues",
    "mesh.blocked.pipeline_fallbacks",
    "mesh.blocked.pipeline_overlap_frac_est",
)


def _assert_same(ref, port):
    (jeng, jd, jb), (eng, d, b) = ref, port
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(b.view(np.uint32), jb)
    for key in COUNTERS:
        assert eng.counters[key] == jeng.counters[key], key


# -- mesh validation -----------------------------------------------------------


def test_counter_keys_are_the_references():
    assert pblk.BLOCKED_COUNTER_KEYS == blk.BLOCKED_COUNTER_KEYS
    assert set(DeviceResidencyEngine("cpu").blocked.get_counters()) == set(
        blk.BLOCKED_COUNTER_KEYS
    )


def test_make_blocked_mesh_shapes_and_errors(eight_cpu_devices):
    """tests/test_blocked.py TestMeshValidation on the port: the same
    shapes and the same ValueErrors as the reference."""
    for kw in (dict(), dict(batch=2), dict(rows=1), dict(cols=8), dict(batch=4)):
        want = blk.make_blocked_mesh(eight_cpu_devices, **kw)
        got = make_blocked_mesh(CPU8, **kw)
        assert got.shape == dict(want.shape), kw
        assert got.axis_names == ("batch", "row", "col")
    for kw in (dict(rows=7, cols=3), dict(batch=3), dict(cols=5), dict(rows=3),
               dict(batch=0), dict(batch=2, rows=4, cols=2)):
        with pytest.raises(ValueError) as want:
            blk.make_blocked_mesh(eight_cpu_devices, **kw)
        with pytest.raises(ValueError) as got:
            make_blocked_mesh(CPU8, **kw)
        assert str(got.value) == str(want.value), kw


def test_tile_must_divide_by_mesh_lanes(eight_cpu_devices):
    jeng = blk.BlockedApspEngine(tile=6, mesh=blk.make_blocked_mesh(eight_cpu_devices))
    eng = BlockedApspEngine(tile=6, mesh=make_blocked_mesh(CPU8))
    with pytest.raises(ValueError) as want:
        jeng.tile_for(64, 2, 4)
    with pytest.raises(ValueError, match=r"lcm\(rows=2, cols=4\)") as got:
        eng.tile_for(64, 2, 4)
    assert str(got.value) == str(want.value)
    eng.tile = None
    for n, rows, cols in ((64, 2, 4), (5, 1, 8), (3, 1, 1), (100, 3, 2)):
        assert eng.tile_for(n, rows, cols) == blk.BlockedApspEngine().tile_for(
            n, rows, cols
        )


def test_mesh_default_is_the_engines_device_and_env_shape(monkeypatch):
    monkeypatch.delenv("OPENR_BLOCKED_MESH", raising=False)
    eng = DeviceResidencyEngine("cpu").blocked
    assert eng.mesh().shape == {"batch": 1, "row": 1, "col": 1}
    assert list(eng.mesh().devices.flat) == [torch.device("cpu")]
    for spec, shape in (("1x1", (1, 1, 1)), ("1x1x1", (1, 1, 1))):
        monkeypatch.setenv("OPENR_BLOCKED_MESH", spec)
        eng = DeviceResidencyEngine("cpu").blocked
        assert eng.mesh().devices.shape == shape
    for spec, match in (("2x2", r"rows=2 x cols=2 != 1"), ("ax2", "integers"),
                        ("1x1x1x1", "2 or 3")):
        monkeypatch.setenv("OPENR_BLOCKED_MESH", spec)
        with pytest.raises(ValueError, match=match):
            DeviceResidencyEngine("cpu").blocked.mesh()


# -- one round -----------------------------------------------------------------


def _round_input(t, b, seed):
    rng = np.random.default_rng(seed)
    n = t * b
    d = rng.integers(1, 60, size=(n, n)).astype(np.uint32)
    d[rng.random(d.shape) < 0.3] = np.uint32(INF)
    np.fill_diagonal(d, 0)
    return d.reshape(1, t, b, t, b), rng.random(n) < 0.2


@pytest.mark.parametrize("shape", ["2x2", "2x4"])
def test_three_phases_of_one_round_every_k(eight_cpu_devices, shape):
    """Phases 1-3 of a round over the shards, every k, against the
    reference's `blocked_diag` / `blocked_panels` / `blocked_outer` on a
    mesh of the same shape (B = 8 lanes over the mesh)."""
    t, b = 3, 8
    d, ov = _round_input(t, b, seed=5)
    jmesh, mesh = _meshes(eight_cpu_devices, shape)
    nr, nc = mesh.devices.shape[1:]
    br, bc = b // nr, b // nc
    eng = BlockedApspEngine(mesh=mesh)
    ovd = {torch.device("cpu"): torch.from_numpy(ov)}
    for k in range(t):
        kk = jnp.int32(k)
        closed = blk.blocked_diag(jnp.asarray(d), jnp.asarray(ov), kk, mesh=jmesh)
        row_p, col_p = blk.blocked_panels(
            jnp.asarray(d), closed, jnp.asarray(ov), kk, mesh=jmesh
        )
        want = np.asarray(
            blk.blocked_outer(
                jnp.asarray(d), row_p, col_p, jnp.asarray(ov), kk, mesh=jmesh
            )
        ).view(np.int32)
        row_p, col_p = np.asarray(row_p).view(np.int32), np.asarray(col_p).view(np.int32)
        tiles = pblk.TileShards(mesh, torch.from_numpy(d.view(np.int32).copy()))
        panels = eng._round_panels(tiles, ovd, k)
        got_row, got_col = panels[0]
        for r in range(nr):
            for c in range(nc):
                # shard (r, c) holds the row panel's columns of c (every
                # lane) and the column panel's rows of r (every lane)
                np.testing.assert_array_equal(
                    got_row[r, c].numpy(), row_p[..., c * bc : (c + 1) * bc]
                )
                np.testing.assert_array_equal(
                    got_col[r, c].numpy(), col_p[:, :, r * br : (r + 1) * br]
                )
        eng._outer_step(tiles, panels, ovd, k, bo.blocked_outer_reference)
        np.testing.assert_array_equal(tiles.full().numpy(), want, err_msg=f"k={k}")


# -- K2 at shard extents -------------------------------------------------------


@pytest.mark.parametrize(
    "s,t,b,nr,nc",
    [(1, 3, 16, 1, 8), (2, 4, 8, 2, 4), (1, 5, 12, 3, 2), (2, 3, 4, 1, 1)],
    ids=["bc2_odd_t", "s2_2x4", "br_ne_bc", "one_shard"],
)
def test_outer_reference_at_shard_extents(eight_cpu_devices, s, t, b, nr, nc):
    """K2's plain version on each shard's rectangle [S, T*B/R, T*B/C]
    (with mc = 2T at odd T: the scalar path's shape on the card) equals
    the reference's `blocked_outer` on the whole tensor, sliced."""
    rng = np.random.default_rng(s + t + b)
    dist = rng.integers(0, 1 << 20, size=(s, t, b, t, b)).astype(np.uint32)
    dist[rng.random(dist.shape) < 0.1] = np.uint32(INF)
    row_p = rng.integers(0, 1 << 20, size=(s, b, t, b)).astype(np.uint32)
    col_p = rng.integers(0, 1 << 20, size=(s, t, b, b)).astype(np.uint32)
    ov = rng.random(t * b) < 0.2
    mesh = blk.make_blocked_mesh(eight_cpu_devices[:1])
    br, bc = b // nr, b // nc
    for k in range(t):
        want = np.asarray(
            blk.blocked_outer(
                jnp.asarray(dist), jnp.asarray(row_p), jnp.asarray(col_p),
                jnp.asarray(ov), jnp.int32(k), mesh=mesh,
            )
        ).view(np.int32)
        for r in range(nr):
            for c in range(nc):
                rs, cs = slice(r * br, (r + 1) * br), slice(c * bc, (c + 1) * bc)
                shard = torch.from_numpy(dist[:, :, rs, :, cs].view(np.int32).copy())
                got = bo.blocked_outer(
                    shard,
                    torch.from_numpy(row_p[..., cs].view(np.int32).copy()),
                    torch.from_numpy(col_p[:, :, rs].view(np.int32).copy()),
                    torch.from_numpy(ov),
                    k,
                    (r * br, c * bc),
                )
                assert got is shard
                np.testing.assert_array_equal(
                    got.numpy(), want[:, :, rs, :, cs], err_msg=f"k={k} ({r}, {c})"
                )


# -- whole closures ------------------------------------------------------------


def test_seeded_random_graph_matches_scipy(eight_cpu_devices):
    """TestClosureParity.test_seeded_random_graph_matches_scipy on the
    port's 2x4 mesh, both loops (N = 23 pads to 24 at tile 4)."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg

    rng = np.random.default_rng(0)
    n, n_pad = 23, 24
    mask = rng.random((n, n)) < 0.25
    np.fill_diagonal(mask, False)
    src, dst = np.nonzero(mask)
    met = rng.integers(1, 50, size=len(src)).astype(np.int32)
    g = sp.csr_matrix((met.astype(np.float64), (src, dst)), shape=(n, n))
    ref = csg.shortest_path(g, method="D", directed=True)
    ref = np.where(np.isinf(ref), INF, ref).astype(np.int64)
    for mode in ("0", "1"):
        eng = BlockedApspEngine(tile=4, mesh=make_blocked_mesh(CPU8))
        eng.pipeline_mode = mode
        d0 = eng.dense_dist0(n, n_pad, src, dst, met, np.ones(len(src), bool), len(src))
        tiles, b = eng.run_apsp(d0[None], np.zeros(n_pad, bool))
        got = tiles.extract(np.arange(n), n).numpy().astype(np.int64)
        np.testing.assert_array_equal(got, ref)
        assert b == 4 and eng.counters["mesh.blocked.rounds"] == 6


CLOSURES = {
    "ring17": lambda: topo.ring_topology(17),
    "grid4x4": lambda: topo.grid_topology(4),
    "fattree": lambda: topo.fat_tree_topology(2),
    "grid-drained": lambda: overload(topo.grid_topology(4), 5),
}


@pytest.mark.parametrize("shape", ["2x4", "1x8"])
@pytest.mark.parametrize("name", sorted(CLOSURES))
def test_closure_and_counters_match_reference(eight_cpu_devices, name, shape):
    """The fleet product of each family on a mesh of the reference's
    shape, bulk and pipelined: dist, bitmap and every deterministic
    `mesh.blocked.*` counter equal to the reference's; pipelined equal
    to bulk."""
    dbs = CLOSURES[name]()
    n = len(dbs)
    dests = sorted({0, n // 3, n - 1})
    jmesh, mesh = _meshes(eight_cpu_devices, shape)
    bulk = _products(dbs, dests, jmesh, mesh, 8, "0")
    _assert_same(*bulk)
    pipe = _products(CLOSURES[name](), dests, jmesh, mesh, 8, "1")
    _assert_same(*pipe)
    np.testing.assert_array_equal(pipe[1][1], bulk[1][1])
    np.testing.assert_array_equal(pipe[1][2], bulk[1][2])
    eng, t = pipe[1][0], pipe[1][0].counters["mesh.blocked.rounds"]
    assert t >= 2
    assert eng.counters["mesh.blocked.pipeline_prefetch_issues"] == t - 1
    assert eng.counters["mesh.blocked.pipeline_rounds_overlapped"] == t - 1
    assert eng.counters["mesh.blocked.pipeline_overlap_frac_est"] == 100 * (t - 1) // t
    assert eng.counters["mesh.blocked.bytes_exchanged"] > 0
    for key in COUNTERS:
        if "pipeline" in key:
            assert bulk[1][0].counters[key] == 0, key


def test_wan_shaped_and_degenerate_meshes(eight_cpu_devices):
    """The wan-shaped family (benchmarks.synthetic.wan(96, chords=2,
    seed=3) as `topo.wan_topology`) on the 2x4, 1x8 and 1x1x1 meshes against the
    reference's, pipelined: the 1x1x1 mesh prefetches T - 1 rounds and
    overlaps none."""
    dbs = topo.wan_topology(96, chords=2, seed=3)
    n = len(dbs)
    dests = sorted(np.random.default_rng(4).choice(n, size=8, replace=False).tolist())
    results = []
    for shape in ("2x4", "1x8"):
        jmesh, mesh = _meshes(eight_cpu_devices, shape)
        ref, port = _products(dbs, dests, jmesh, mesh, 8, "1")
        _assert_same(ref, port)
        results.append(port)
    jone = blk.make_blocked_mesh(eight_cpu_devices[:1])
    ref, port = _products(dbs, dests, jone, make_blocked_mesh(["cpu"]), 8, "1")
    _assert_same(ref, port)
    eng = port[0]
    t = eng.counters["mesh.blocked.rounds"]
    assert eng.counters["mesh.blocked.pipeline_prefetch_issues"] == t - 1
    assert eng.counters["mesh.blocked.pipeline_rounds_overlapped"] == 0
    assert eng.counters["mesh.blocked.pipeline_overlap_frac_est"] == 0
    for other in results:
        np.testing.assert_array_equal(other[1], port[1])
        np.testing.assert_array_equal(other[2], port[2])


def test_batch_axis_composes(eight_cpu_devices):
    """TestFusedProductParity.test_batch_axis_composes on the port: S = 2
    identical variants over a 2x2x2 mesh, both slices equal to the
    reference's closure of the same mesh shape, both loops."""
    csr, jcsr = mirrors(topo.ring_topology(12))
    n = csr.n_nodes
    jeng = blk.BlockedApspEngine(
        tile=4, mesh=blk.make_blocked_mesh(eight_cpu_devices, batch=2)
    )
    jd0 = jeng.dense_dist0(
        n, n, jcsr.edge_src, jcsr.edge_dst, jcsr.edge_metric, jcsr.edge_up,
        int(jcsr.n_edges),
    )
    jdist, _ = jeng.run_apsp(np.stack([jd0, jd0]), np.zeros(n, bool))
    want = np.asarray(jdist).view(np.int32)
    for mode in ("0", "1"):
        eng = BlockedApspEngine(tile=4, mesh=make_blocked_mesh(CPU8, batch=2))
        eng.pipeline_mode = mode
        d0 = eng.dense_dist0(
            n, n, csr.edge_src, csr.edge_dst, csr.edge_metric, csr.edge_up,
            csr.n_edges,
        )
        tiles, _ = eng.run_apsp(torch.stack([d0, d0]), np.zeros(n, bool))
        np.testing.assert_array_equal(tiles.full().numpy(), want)
        for key in ("mesh.blocked.bytes_exchanged", "mesh.blocked.rounds"):
            assert eng.counters[key] == jeng.counters[key], key


# -- the pipeline's knobs and its demotion -------------------------------------


def test_env_knob_and_pinned_mode(monkeypatch):
    """OPENR_BLOCKED_PIPELINE=0 forces the bulk loop, the pinned
    `pipeline_mode` outranks the env, and one round has nothing to
    prefetch (the reference's precedence)."""
    eng = BlockedApspEngine(tile=4, mesh=make_blocked_mesh(CPU8))
    monkeypatch.delenv("OPENR_BLOCKED_PIPELINE", raising=False)
    assert eng.pipeline_enabled(2)
    assert not eng.pipeline_enabled(1)
    monkeypatch.setenv("OPENR_BLOCKED_PIPELINE", "0")
    assert not eng.pipeline_enabled(4)
    monkeypatch.setenv("OPENR_BLOCKED_PIPELINE", "1")
    assert eng.pipeline_enabled(4)
    eng.pipeline_mode = "0"
    assert not eng.pipeline_enabled(4)
    monkeypatch.setenv("OPENR_BLOCKED_PIPELINE", "0")
    eng.pipeline_mode = "1"
    assert eng.pipeline_enabled(4)
    # the env reaches a product: no pipeline counter moves
    eng.pipeline_mode = None
    csr, _ = mirrors(topo.grid_topology(4))
    eng.fleet_product(csr, np.asarray([0, 15], np.int32), _out(csr))
    assert eng.counters["mesh.blocked.pipeline_prefetch_issues"] == 0
    assert eng.counters["mesh.blocked.rounds"] == 4


def test_transient_fault_recovers_on_bulk_retry(eight_cpu_devices):
    """A `blocked_round` fault that fires once demotes the pipelined
    attempt; the bulk retry, from a restaged dist0, serves the product
    bit-equal to the reference's (counterpart of the reference test of
    this name)."""
    csr, jcsr = mirrors(topo.grid_topology(4))
    dests = np.asarray([0, csr.n_nodes - 1], dtype=np.int32)
    jeng = blk.BlockedApspEngine(tile=4, mesh=blk.make_blocked_mesh(eight_cpu_devices))
    jeng.pipeline_mode = "1"
    eng = BlockedApspEngine(tile=4, mesh=make_blocked_mesh(CPU8))
    eng.pipeline_mode = "1"
    for e in (jeng, eng):
        fired = []

        def hook(op, fired=fired):
            # the third round: the first two rounds already wrote dist0
            if op == "blocked_round":
                fired.append(op)
                if len(fired) == 3:
                    raise RuntimeError("injected: partition mid-pipeline")

        e.fault_hook = hook
    jd, jb, _ = jeng.fleet_product(jcsr, dests, _jout(jcsr))
    d, b, ok = eng.fleet_product(csr, dests, _out(csr))
    assert ok
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(b.numpy().view(np.uint32), np.asarray(jb))
    for key in COUNTERS:
        assert eng.counters[key] == jeng.counters[key], key
    assert eng.counters["mesh.blocked.pipeline_fallbacks"] == 1


def _view_engine(mesh_devices):
    engine = DeviceResidencyEngine("cpu")
    engine.blocked.node_shard_threshold = 0
    engine.blocked.tile = 4
    engine.blocked._mesh = make_blocked_mesh(mesh_devices)
    return engine


def test_armed_fault_raises_out_of_the_view(monkeypatch):
    """A `blocked_round` fault that stays armed: the pipelined loop
    demotes once, the bulk loop meets it again and it raises out of the
    view, counted once in each family (the reference serves the view by
    its fused product instead; the port never swaps the rung)."""
    monkeypatch.delenv("OPENR_NODE_SHARD", raising=False)
    ls, _ = link_states(topo.grid_topology(4))
    engine = _view_engine(CPU8)

    def hook(op):
        if op == "blocked_round":
            raise RuntimeError("injected: partition")

    engine.fault_hook = hook
    with pytest.raises(RuntimeError, match="injected: partition"):
        FleetViewCache().view(ls, ls.node_names[:2], engine=engine)
    assert engine.blocked.counters["mesh.blocked.pipeline_fallbacks"] == 1
    assert engine.blocked.counters["mesh.blocked.fallbacks"] == 1
    assert engine.blocked.counters["mesh.blocked.products"] == 0


def test_other_exceptions_in_the_pipeline_propagate(monkeypatch):
    """Only the hook's fault demotes: an error raised by a phase inside
    the pipelined loop leaves the view at once, no demotion counted."""
    monkeypatch.delenv("OPENR_NODE_SHARD", raising=False)
    ls, _ = link_states(topo.grid_topology(4))
    engine = _view_engine(CPU8)

    def broken(*args, **kwargs):
        raise RuntimeError("lookahead broke")

    monkeypatch.setattr(BlockedApspEngine, "blocked_lookahead", broken)
    with pytest.raises(RuntimeError, match="lookahead broke"):
        FleetViewCache().view(ls, ls.node_names[:2], engine=engine)
    assert engine.blocked.counters["mesh.blocked.pipeline_fallbacks"] == 0
    assert engine.blocked.counters["mesh.blocked.fallbacks"] == 1


def test_mesh_mismatch_raises_out_of_the_view(monkeypatch, eight_cpu_devices):
    """OPENR_BLOCKED_MESH of a shape the devices cannot hold: the
    reference's ValueError message, counted in `mesh.blocked.fallbacks`,
    and raised out of the view (the reference falls back to its fused
    product)."""
    monkeypatch.delenv("OPENR_NODE_SHARD", raising=False)
    monkeypatch.setenv("OPENR_BLOCKED_MESH", "7x3")
    with pytest.raises(ValueError) as want:
        blk.make_blocked_mesh(eight_cpu_devices[:1], rows=7, cols=3)
    ls, _ = link_states(topo.grid_topology(4))
    engine = DeviceResidencyEngine("cpu")
    engine.blocked.node_shard_threshold = 0
    with pytest.raises(ValueError) as got:
        FleetViewCache().view(ls, ls.node_names[:2], engine=engine)
    assert str(got.value) == str(want.value)
    assert engine.blocked.counters["mesh.blocked.fallbacks"] == 1
    assert engine.counters["device.engine.dispatches"] == 0


def test_engine_counts_every_shards_launch(monkeypatch):
    """On a 2x2 mesh the engine's front-end counts K2 once per shard per
    round, and the view equals the 1x1x1 view bit for bit."""
    monkeypatch.delenv("OPENR_NODE_SHARD", raising=False)

    def counting(*args):
        counting.launches += 1
        return bo.blocked_outer_reference(*args)

    counting.launches = 0
    monkeypatch.setattr(bo, "blocked_outer", counting)
    ls, _ = link_states(topo.fat_tree_topology(4))
    dests = ls.node_names[:3]
    engine = _view_engine(["cpu"] * 4)
    view = FleetViewCache().view(ls, dests, engine=engine)
    rounds = engine.blocked.counters["mesh.blocked.rounds"]
    assert counting.launches == 4 * rounds
    assert engine.counters["device.engine.kernel_launches.blocked_outer"] == 4 * rounds
    one = _view_engine(["cpu"])
    single = FleetViewCache().view(ls, dests, engine=one)
    assert torch.equal(view._dist_dev, single._dist_dev)
    assert torch.equal(view._bitmap_dev, single._bitmap_dev)
    assert counting.launches == 5 * rounds
