"""The port's blocked APSP rung against openr_tpu's, bit for bit.

Kernel K2's plain version `blocked_outer_reference` is held against the
reference's XLA phase 3 (`parallel.blocked.blocked_outer`) and its
Pallas kernel (`blocked_outer_pallas`, interpret mode) for every round
k; phases 1 and 2 against `blocked_diag` / `blocked_panels`; the rung's
`fleet_product` (distances and ECMP bitmap) against the reference's on a
one-device mesh; the blocked view against the port's own fused product,
the reference's view and the reference solver's route DBs.  Then the
dispatch policy: threshold, `OPENR_NODE_SHARD`, and a rung failure that
raises out of `view()` instead of falling back.  Integer min-plus:
tolerance 0.  The CUDA kernel runs only on the card (`-m cuda`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.decision.fleet import FleetViewCache as JFleetViewCache
from openr_tpu.decision.spf_solver import SpfSolver as JSpfSolver
from openr_tpu.device.engine import DeviceResidencyEngine as JEngine
from openr_tpu.ops import allsources as jasrc
from openr_tpu.ops import pallas_kernels as pk
from openr_tpu.parallel import blocked as blk
from openr_tpu_torch.decision.fleet import FleetViewCache
from openr_tpu_torch.decision.spf_solver import SpfSolver
from openr_tpu_torch.device.engine import DeviceResidencyEngine
from openr_tpu_torch.ops import allsources as asrc
from openr_tpu_torch.ops import blocked_outer as bo
from openr_tpu_torch.ops.sssp import u16_dist_to_i32
from openr_tpu_torch.parallel import blocked as pblk
from openr_tpu_torch.utils import topo

from torch_parity import link_states, mirrors, normalized_routes, overload
from torch_parity import prefix_states

INF = 1 << 30


def _one_device_mesh():
    return blk.make_blocked_mesh(jax.devices()[:1])


def _tile_inputs(s, t, b, seed):
    """The inputs of tests/test_pallas.py TestBlockedOuterKernel: values
    below 2^20, 10% INF entries in dist, 20% drained lanes."""
    rng = np.random.default_rng(seed)
    dist = rng.integers(0, 1 << 20, size=(s, t, b, t, b)).astype(np.uint32)
    dist[rng.random(dist.shape) < 0.1] = np.uint32(INF)
    row_p = rng.integers(0, 1 << 20, size=(s, b, t, b)).astype(np.uint32)
    col_p = rng.integers(0, 1 << 20, size=(s, t, b, b)).astype(np.uint32)
    ov = rng.random(t * b) < 0.2
    return dist, row_p, col_p, ov


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 values <= 2^30 as the port's int32 tensor (same bits)."""
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    return np.asarray(jax.device_get(x)).view(np.int32)


OUTER_CASES = {
    "drain_and_inf_s2_t3_b16": dict(s=2, t=3, b=16, seed=0, mask=True),
    "no_mask_s1_t4_b8": dict(s=1, t=4, b=8, seed=3, mask=False),
}


@pytest.mark.parametrize("name", sorted(OUTER_CASES))
def test_outer_reference_matches_xla_and_pallas_every_k(name):
    case = OUTER_CASES[name]
    dist, row_p, col_p, ov = _tile_inputs(
        case["s"], case["t"], case["b"], case["seed"]
    )
    if not case["mask"]:
        ov = np.zeros_like(ov)
    mesh = _one_device_mesh()
    for k in range(case["t"]):
        args = (jnp.asarray(row_p), jnp.asarray(col_p), jnp.asarray(ov), k)
        want_xla = _np(blk.blocked_outer(jnp.asarray(dist), *args, mesh=mesh))
        want_pallas = _np(
            pk.blocked_outer_pallas(jnp.asarray(dist), *args, interpret=True)
        )
        mine = _t(dist.copy())
        got = bo.blocked_outer_reference(
            mine, _t(row_p), _t(col_p), torch.from_numpy(ov), k
        )
        assert got is mine  # in place, as the reference donates dist
        np.testing.assert_array_equal(got.numpy(), want_xla, err_msg=f"k={k}")
        np.testing.assert_array_equal(got.numpy(), want_pallas, err_msg=f"k={k}")


def test_outer_wrapper_takes_the_plain_version_on_cpu():
    dist, row_p, col_p, ov = _tile_inputs(1, 4, 8, seed=9)
    before = bo.blocked_outer.launches
    args = (_t(row_p), _t(col_p), torch.from_numpy(ov), 2)
    got = bo.blocked_outer(_t(dist.copy()), *args)
    want = bo.blocked_outer_reference(_t(dist.copy()), *args)
    assert torch.equal(got, want)
    assert bo.blocked_outer.launches == before  # no kernel launched


def test_outer_wrapper_refuses_non_cuda_accelerator_tensors():
    d = torch.zeros((1, 2, 4, 2, 4), dtype=torch.int32, device="meta")
    r = torch.zeros((1, 4, 2, 4), dtype=torch.int32, device="meta")
    c = torch.zeros((1, 2, 4, 4), dtype=torch.int32, device="meta")
    ov = torch.zeros(8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        bo.blocked_outer(d, r, c, ov, 0)


@pytest.mark.parametrize("s,t,b", [(1, 3, 4), (2, 4, 8)])
def test_diag_and_panels_match_reference_every_k(s, t, b):
    """Phases 1 and 2 on a random matrix (zero diagonal, 30% INF, 20%
    drained lanes), every round k."""
    rng = np.random.default_rng(5 + s)
    n = t * b
    d = rng.integers(1, 60, size=(s, n, n)).astype(np.uint32)
    d[rng.random(d.shape) < 0.3] = np.uint32(INF)
    for i in range(s):
        np.fill_diagonal(d[i], 0)
    d = d.reshape(s, t, b, t, b)
    ov = rng.random(n) < 0.2
    mesh = _one_device_mesh()
    mine, ovt = _t(d), torch.from_numpy(ov)
    for k in range(t):
        kk = jnp.int32(k)
        closed = blk.blocked_diag(jnp.asarray(d), jnp.asarray(ov), kk, mesh=mesh)
        row_p, col_p = blk.blocked_panels(
            jnp.asarray(d), closed, jnp.asarray(ov), kk, mesh=mesh
        )
        got_closed = pblk.blocked_diag(mine, ovt, k)
        got_row, got_col = pblk.blocked_panels(mine, got_closed, ovt, k)
        np.testing.assert_array_equal(got_closed.numpy(), _np(closed))
        np.testing.assert_array_equal(got_row.numpy(), _np(row_p))
        np.testing.assert_array_equal(got_col.numpy(), _np(col_p))
    assert np.array_equal(mine.numpy(), d.view(np.int32))  # read only


def _wide_fat_tree():
    """40 pods on one plane of 2 spines: each spine has 40 unique
    out-neighbours, so its ECMP bitmap needs two words."""
    return topo.fat_tree_topology(
        40, n_planes=1, n_fsw_per_pod=1, n_rsw_per_pod=1, n_ssw_per_plane=2
    )


PRODUCT_CASES = {
    "fat_tree4": lambda: topo.fat_tree_topology(4),
    "grid5": lambda: topo.grid_topology(5),
    "wan256_drained": lambda: overload(
        topo.wan_topology(256, labeled=range(0, 256, 9)), 17
    ),
    "fat_tree_w2": _wide_fat_tree,
}


@pytest.mark.parametrize("name", sorted(PRODUCT_CASES))
def test_fleet_product_matches_reference(name):
    csr, jcsr = mirrors(PRODUCT_CASES[name]())
    n = csr.n_nodes
    dests = np.asarray(sorted({0, 3, n // 3, n // 2, n - 1}), dtype=np.int32)
    jout = jasrc.build_out_ell(
        jcsr.edge_src, jcsr.edge_dst, int(jcsr.n_edges), n,
        out_slot=jcsr.out_slot,
    )
    jdist, jbitmap, jok = blk.BlockedApspEngine(
        mesh=_one_device_mesh()
    ).fleet_product(jcsr, dests, jout)

    out = asrc.build_out_ell(
        csr.edge_src, csr.edge_dst, csr.n_edges, n, out_slot=csr.out_slot
    )
    eng = pblk.BlockedApspEngine(device="cpu")
    dist, bitmap, ok = eng.fleet_product(csr, dests, out)
    assert ok is True and jok is True
    assert dist.dtype == torch.int32 and bitmap.dtype == torch.int32
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jdist))
    np.testing.assert_array_equal(
        bitmap.numpy().view(np.uint32), np.asarray(jbitmap)
    )
    if name == "fat_tree_w2":
        assert out.n_words == 2
    if name == "wan256_drained":
        assert csr.node_overloaded[:n].sum() == 1
    b = eng.tile_for(n)
    t = -(-n // b)
    assert eng.counters["mesh.blocked.rounds"] == t
    assert eng.counters["mesh.blocked.products"] == 1


def test_bitmap_from_reference_distances_matches_reference():
    """`ecmp_bitmap_from_reverse_dist` alone, one and two words, on the
    reference's own distances."""
    for dbs in (topo.wan_topology(256), _wide_fat_tree()):
        csr, jcsr = mirrors(dbs)
        n = csr.n_nodes
        dests = np.arange(0, n, 7, dtype=np.int32)
        jout = jasrc.build_out_ell(
            jcsr.edge_src, jcsr.edge_dst, int(jcsr.n_edges), n,
            out_slot=jcsr.out_slot,
        )
        jdist, jbitmap, _ = blk.BlockedApspEngine(
            mesh=_one_device_mesh()
        ).fleet_product(jcsr, dests, jout)
        out = asrc.build_out_ell(
            csr.edge_src, csr.edge_dst, csr.n_edges, n, out_slot=csr.out_slot
        )
        got = asrc.ecmp_bitmap_from_reverse_dist(
            _t(np.asarray(jdist)),
            out,
            csr.edge_metric,
            csr.edge_up,
            csr.node_overloaded,
            out.n_words,
        )
        np.testing.assert_array_equal(
            got.numpy().view(np.uint32), np.asarray(jbitmap)
        )


def _blocked_engine(threshold: int = 0) -> DeviceResidencyEngine:
    engine = DeviceResidencyEngine("cpu")
    engine.blocked.node_shard_threshold = threshold
    return engine


def test_blocked_view_matches_fused_product(monkeypatch):
    """TestFusedProductParity (tests/test_blocked.py) on the port: the
    blocked view and the fused product's view agree bit for bit."""
    monkeypatch.delenv("OPENR_NODE_SHARD", raising=False)
    dbs = topo.wan_topology(256, labeled=range(0, 256, 9))
    ls, _ = link_states(dbs)
    names = ls.node_names
    dests = [names[i] for i in (0, 5, 17, 48, 95, 200, 255)]
    vb = FleetViewCache().view(ls, dests, engine=_blocked_engine())
    vf = FleetViewCache().view(ls, dests, device="cpu")
    assert vb.node_sharded and not vf.node_sharded
    # the blocked rung is int32, the fused view uint16 (small metrics);
    # distances agree after the int32 normalization, as in the reference
    assert vb._dist_dev.dtype == torch.int32
    assert vf._dist_dev.dtype == torch.uint16
    assert torch.equal(vb._dist_dev, u16_dist_to_i32(vf._dist_dev))
    assert torch.equal(vb._bitmap_dev, vf._bitmap_dev)


def test_view_rows_match_reference_view(monkeypatch):
    """tests/test_pallas.py TestEngineIntegration.test_blocked_rung_
    parity_on_fattree on the port: rows and decoded next hops of the
    port's blocked view against the reference's view, whose phase 3 runs
    the Pallas kernel in interpret mode on a one-device mesh."""
    monkeypatch.delenv("OPENR_NODE_SHARD", raising=False)
    ls, jls = link_states(topo.fat_tree_topology(4))
    nodes = sorted(ls.node_names)
    dests = [nodes[0], nodes[3], nodes[-1]]
    jengine = JEngine()
    jengine.pallas_mode = "interpret"
    jengine.blocked.node_shard_threshold = 0
    jengine.blocked._mesh = _one_device_mesh()
    jview = JFleetViewCache(delta=False).view(jls, dests, engine=jengine)
    assert jview.node_sharded
    assert jengine.get_counters()["device.engine.pallas_outer_updates"] > 0
    engine = _blocked_engine()
    view = FleetViewCache().view(ls, dests, engine=engine)
    assert view.converged and view.node_sharded
    for node in nodes:
        assert np.array_equal(view._row(node), jview._row(node)), node
        for dest in dests:
            assert view.next_hop_neighbors(node, dest) == (
                jview.next_hop_neighbors(node, dest)
            ), (node, dest)
    rounds = engine.blocked.counters["mesh.blocked.rounds"]
    assert rounds == -(-len(nodes) // 16)
    assert engine.counters["device.engine.kernel_launches"] == 0  # CPU


def test_fleet_route_dbs_through_the_rung_match_reference(monkeypatch):
    monkeypatch.delenv("OPENR_NODE_SHARD", raising=False)
    ls, jls = link_states(topo.fat_tree_topology(4))
    names = ls.node_names
    ps, jps = prefix_states(names, every=3)
    solver = SpfSolver(names[0], device="cpu")
    solver.engine.blocked.node_shard_threshold = 0
    got = solver.fleet_route_dbs({"0": ls}, ps)
    assert solver.engine.blocked.counters["mesh.blocked.products"] == 1
    jsolver = JSpfSolver(names[0])
    assert sorted(got) == names
    n_unicast = 0
    for node in names:
        want = jsolver.build_route_db({"0": jls}, jps, my_node_name=node)
        mine, theirs = normalized_routes(got[node]), normalized_routes(want)
        assert mine == theirs, node
        n_unicast += len(mine[0])
    assert n_unicast > len(names)


def test_should_engage_threshold_and_env(monkeypatch):
    """tests/test_blocked.py TestDispatchRung.test_threshold_and_env_
    engagement on the port."""
    monkeypatch.delenv("OPENR_NODE_SHARD", raising=False)
    engine = DeviceResidencyEngine("cpu")
    assert not engine.blocked.should_engage(64)  # default ceiling 2^15
    assert not engine.blocked.should_engage(1 << 15)
    assert engine.blocked.should_engage((1 << 15) + 1)
    engine.blocked.node_shard_threshold = 0
    assert engine.blocked.should_engage(64)
    monkeypatch.setenv("OPENR_NODE_SHARD", "0")
    assert not engine.blocked.should_engage(64)  # forced off
    monkeypatch.setenv("OPENR_NODE_SHARD", "1")
    engine.blocked.node_shard_threshold = 1 << 15
    assert engine.blocked.should_engage(64)  # forced on


def test_rung_is_checked_before_band_decomposition(monkeypatch):
    """A ring of 20 has no bands: below the threshold the view raises
    NotImplementedError (the ELL fallback is a later slice), while the
    forced rung serves it, equal to the host Dijkstra."""
    monkeypatch.setenv("OPENR_NODE_SHARD", "1")
    ls, _ = link_states(topo.ring_topology(20))
    view = FleetViewCache().view(ls, ["r0", "r7"], device="cpu")
    assert view.node_sharded
    for node in ls.node_names:
        spf = ls.get_spf_result(node)
        for dest in ("r0", "r7"):
            assert view.dist(node, dest) == spf[dest].metric
            assert view.next_hop_neighbors(node, dest) == spf[dest].next_hops


def test_rung_failure_raises_out_of_view(monkeypatch):
    """No fallback to the fused product: a tile the rung cannot use, or a
    failing phase 3, raises out of view(), counted in
    mesh.blocked.fallbacks."""
    monkeypatch.delenv("OPENR_NODE_SHARD", raising=False)
    ls, _ = link_states(topo.wan_topology(256))
    dests = ls.node_names[:3]
    engine = _blocked_engine()
    engine.blocked.tile = 0
    with pytest.raises(ValueError, match="tile"):
        FleetViewCache().view(ls, dests, engine=engine)
    assert engine.blocked.counters["mesh.blocked.fallbacks"] == 1
    assert engine.counters["device.engine.dispatches"] == 0  # no fused run

    def failing(*args):
        raise RuntimeError("blocked_outer kernel launch failed: injected")

    failing.launches = 0
    monkeypatch.setattr(bo, "blocked_outer", failing)
    engine.blocked.tile = None
    with pytest.raises(RuntimeError, match="injected"):
        FleetViewCache().view(ls, dests, engine=engine)
    assert engine.blocked.counters["mesh.blocked.fallbacks"] == 2
    assert engine.counters["device.engine.dispatches"] == 0


def test_engine_counts_every_phase3_launch(monkeypatch):
    """The engine's front-end counts the launches of the phase-3 wrapper,
    in all and per kernel: one per round of the closure."""
    monkeypatch.delenv("OPENR_NODE_SHARD", raising=False)

    def counting(*args):
        counting.launches += 1
        return bo.blocked_outer_reference(*args)

    counting.launches = 0
    monkeypatch.setattr(bo, "blocked_outer", counting)
    ls, _ = link_states(topo.fat_tree_topology(4))
    engine = _blocked_engine()
    FleetViewCache().view(ls, ls.node_names[:2], engine=engine)
    rounds = engine.blocked.counters["mesh.blocked.rounds"]
    assert rounds == 2 and counting.launches == rounds
    assert engine.counters["device.engine.kernel_launches"] == rounds
    assert engine.counters["device.engine.kernel_launches.blocked_outer"] == rounds
    assert engine.counters["device.engine.kernel_launches.fused_epilogue"] == 0


def test_fat_tree_topology_equals_reference():
    from openr_tpu.utils import topo as jtopo

    from torch_parity import to_jax_dbs

    for args in ((2,), (3, 4, 4, 5, 6)):
        mine = to_jax_dbs(topo.fat_tree_topology(*args))
        theirs = jtopo.fat_tree_topology(*args)
        assert mine == theirs


@pytest.mark.cuda
def test_kernel_matches_reference_on_card():
    """K2 against its plain version on the card, bit for bit, every k
    (runs with `-m cuda` on a machine with an sm_90 card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for s, t, b in ((1, 13, 8), (2, 9, 16), (2, 2, 128)):
        dist, row_p, col_p, ov = _tile_inputs(s, t, b, seed=s + t)
        args = (_t(row_p).cuda(), _t(col_p).cuda(), torch.from_numpy(ov).cuda())
        for k in range(t):
            got = bo.blocked_outer(_t(dist.copy()).cuda(), *args, k)
            want = bo.blocked_outer_reference(_t(dist.copy()).cuda(), *args, k)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (s, t, b, k)
