"""The port's uint16 distance mode against openr_tpu's, bit for bit.

The reference runs its fleet product in uint16 (INF16 = 40000, weights
clamped to WBIG16 = 20000) whenever every metric is below WBIG16 // 4
(ops/banded.py pick_small_dist), and latches the mode off and retries in
int32 when the saturation guard trips.  The port runs the same mode (int32
arithmetic over the 16-bit domain, narrowed to torch.uint16 at the fixed
point), so here:

- the banded product engages the mode at metrics 1..10 and not at 10 000
  (tests/test_banded.py test_uint16_mode_engages_and_matches,
  test_large_metrics_disable_uint16), raw products equal;
- the ELL relax in uint16 equals its int32 run and the reference's raw
  output (tests/test_sssp_ell.py test_uint16_mode_matches_int32);
- saturating chains, on the ELL path (the reference's 7-node chain) and
  on the banded path (a 65-ring at metric 4000), latch to int32 with the
  reference's `small_allowed`, hint and sweep sequence, and equal the
  host Dijkstra;
- warm views from a uint16 prior in both gate directions, into and out of
  the mode, equal the cold views and the reference's;
- K1's plain uint16 version equals the Pallas kernel in interpret mode on
  uint16 inputs, unconverged and saturated ones included.

Integer min-plus: tolerance 0.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import synthetic
from openr_tpu.decision import fleet as jfleet
from openr_tpu.decision.spf_solver import SpfSolver as JSpfSolver
from openr_tpu.ops import allsources as jasrc
from openr_tpu.ops import pallas_kernels as pk
from openr_tpu.ops import sssp as jsssp
from openr_tpu_torch.decision import fleet
from openr_tpu_torch.decision.csr import ARRAY_FIELDS, CsrTopology
from openr_tpu_torch.decision.spf_solver import SpfSolver
from openr_tpu_torch.device.engine import DeviceResidencyEngine
from openr_tpu_torch.ops import allsources as asrc
from openr_tpu_torch.ops import epilogue as ep
from openr_tpu_torch.ops import sssp
from openr_tpu_torch.ops.banded import pick_small_dist
from openr_tpu_torch.ops.sssp import INF16, INF32, WBIG, WBIG16
from openr_tpu_torch.utils import topo

from torch_parity import (
    LinkStatePair,
    adj,
    adj_dbs,
    link_states,
    mirrors,
    normalized_routes,
    prefix_states,
)


def _synthetic_csr(ref, stem: str) -> CsrTopology:
    fields = {name: getattr(ref, name) for name in ARRAY_FIELDS}
    fields["n_edges"] = ref.n_edges
    return CsrTopology.from_arrays(fields, topo.node_names(ref.n_nodes, stem))


def _record(runner, calls: list) -> None:
    """Log (sweeps, uint16 mode) of every fixed-sweep run of `runner`."""
    run_once = runner.run_once

    def logged(sources, n_sweeps, *args, **kwargs):
        calls.append((n_sweeps, runner.small_dist))
        return run_once(sources, n_sweeps, *args, **kwargs)

    runner.run_once = logged


def _port_product(csr, dests):
    runner = fleet._reverse_runner(csr)
    runner.stage(torch.device("cpu"))
    calls: list = []
    _record(runner, calls)
    out = asrc.build_out_ell(
        csr.edge_src, csr.edge_dst, csr.n_edges, csr.n_nodes, csr.out_slot
    )
    dist, bitmap, ok = asrc.reduced_all_sources(
        dests, runner, out, csr.edge_metric, csr.edge_up, csr.node_overloaded
    )
    return runner, calls, dist, bitmap, ok


def _reference_product(jtopo, dests):
    """The reference's fleet product with its lax epilogue (tests/
    test_pallas.py holds the Pallas kernel equal to it)."""
    if hasattr(jtopo, "node_id"):
        runner = jfleet._reverse_runner(jtopo)
        out_slot = jtopo.out_slot
    else:
        runner = synthetic.reversed_topology(jtopo).runner
        out_slot = None
    calls: list = []
    _record(runner, calls)
    out = jasrc.build_out_ell(
        jtopo.edge_src, jtopo.edge_dst, int(jtopo.n_edges), int(jtopo.n_nodes),
        out_slot=out_slot,
    )
    maps = jasrc.build_epilogue_maps(runner.bg, out) if runner.bg else None
    dist, bitmap, ok = jasrc.reduced_all_sources(
        np.asarray(dests, dtype=np.int32), runner, out,
        jtopo.edge_metric, jtopo.edge_up, jtopo.node_overloaded, maps=maps,
        pallas_run=lambda kind, pt, xt: pk.run_with_fallback(
            kind, pt, xt, counters={}, mode="off"
        ),
    )
    return (
        runner,
        calls,
        np.asarray(jax.device_get(dist)),
        np.asarray(jax.device_get(bitmap)),
        bool(ok),
    )


def _assert_products_equal(port, ref, n):
    runner, calls, dist, bitmap, ok = port
    jrunner, jcalls, jdist, jbitmap, jok = ref
    assert ok is True and jok is True
    assert dist.numpy().dtype == jdist.dtype
    np.testing.assert_array_equal(dist.numpy()[:n], jdist[:n])
    np.testing.assert_array_equal(bitmap.numpy().view(np.uint32), jbitmap)
    assert runner.small_allowed == jrunner.small_allowed
    assert runner.hint == jrunner.hint
    assert calls == jcalls
    if runner.bg is None:
        assert runner.sweeps == sum(max(s, 2) + 1 for s, _ in calls)


# -- the mode's gate (tests/test_banded.py) ---------------------------------


def test_uint16_mode_engages_at_small_metrics():
    ref = synthetic.wan(512, chords=2, seed=3)
    csr = _synthetic_csr(ref, "w")
    dests = np.arange(16)
    port = _port_product(csr, dests)
    assert port[0].small_dist and port[0].bg is not None
    assert port[2].dtype == torch.uint16
    _assert_products_equal(port, _reference_product(ref, dests), csr.n_nodes)


def test_large_metrics_disable_uint16():
    ref = synthetic.wan(256, chords=2, seed=1)
    ref.edge_metric[: ref.n_edges] = 10_000  # above the uint16 gate
    csr = _synthetic_csr(ref, "w")
    dests = np.arange(8)
    port = _port_product(csr, dests)
    assert not port[0].small_dist and port[0].small_allowed
    assert port[2].dtype == torch.int32
    _assert_products_equal(port, _reference_product(ref, dests), csr.n_nodes)


def test_pick_small_dist_gate_equals_reference():
    from openr_tpu.ops.banded import pick_small_dist as j_pick

    for top in (1, 4999, 5000, 10_000):
        m = np.array([3, top, 7, 1 << 20], dtype=np.int32)
        assert pick_small_dist(m, 2) == j_pick(m, 2)
    assert pick_small_dist(np.zeros(0, np.int32), 0) is True


# -- the ELL relax in uint16 (tests/test_sssp_ell.py) ------------------------


def test_ell_uint16_matches_int32_and_reference():
    csr, jcsr = mirrors(topo.fat_tree_topology(4))
    runner = fleet._reverse_runner(csr)
    runner.stage(torch.device("cpu"))
    jrunner = jfleet._reverse_runner(jcsr)
    assert runner.bg is None and runner.small_dist and jrunner.small_dist
    st = runner.call_arrays()
    src = torch.arange(csr.n_nodes, dtype=torch.int32)
    args = (src, st.ell, st.edge_metric, st.edge_up, st.node_overloaded, 16)
    d32, _, ok32 = sssp.spf_forward_ell_sweeps(*args)
    d16, _, ok16 = sssp.spf_forward_ell_sweeps(*args, small_dist=True)
    raw, _, okr = sssp.spf_forward_ell_sweeps(*args, small_dist=True, raw_u16=True)
    assert ok32 and ok16 and okr
    assert d16.dtype == torch.int32 and raw.dtype == torch.uint16
    assert torch.equal(d16, d32)
    assert torch.equal(sssp.u16_dist_to_i32(raw), d32)
    assert (raw.numpy()[csr.n_nodes :] == INF16).all()  # padding rows
    jraw, _, jok = jsssp.spf_forward_ell_sweeps(
        jnp.asarray(src.numpy()), jrunner.ell, *jrunner.arrays, n_sweeps=16,
        want_dag=False, small_dist=True, raw_u16=True, transpose=False,
    )
    assert bool(jok)
    np.testing.assert_array_equal(raw.numpy(), np.asarray(jraw))
    # the gate reads the runner's numpy metrics on every run
    runner.arrays[2][: runner.n_edges] = 10_000
    assert not runner.small_dist and runner.small_allowed


def _chain_dbs(n: int = 7, metric: int = 4000):
    """A chain c0 - c1 - ... at `metric`: every metric passes the gate,
    the far end (metric * (n - 1)) lies past WBIG16."""
    return adj_dbs(
        {
            f"c{i}": [
                adj(f"c{i}", f"c{j}", metric=metric)
                for j in (i - 1, i + 1)
                if 0 <= j < n
            ]
            for i in range(n)
        }
    )


def _ring_dbs(n: int = 65, metric: int = 4000):
    return adj_dbs(
        {
            f"r{i:03d}": [
                adj(f"r{i:03d}", f"r{j % n:03d}", metric=metric)
                for j in (i - 1, i + 1)
            ]
            for i in range(n)
        }
    )


def test_ell_chain_saturates_in_a_direct_run():
    csr, jcsr = mirrors(_chain_dbs())
    runner = fleet._reverse_runner(csr)
    runner.stage(torch.device("cpu"))
    st = runner.call_arrays()
    src = torch.tensor([csr.node_id["c0"]], dtype=torch.int32)
    raw, _, ok = sssp.spf_forward_ell_sweeps(
        src, st.ell, st.edge_metric, st.edge_up, st.node_overloaded, 16,
        small_dist=True, raw_u16=True,
    )
    jrunner = jfleet._reverse_runner(jcsr)
    jraw, _, jok = jsssp.spf_forward_ell_sweeps(
        jnp.asarray(src.numpy()), jrunner.ell, *jrunner.arrays, n_sweeps=16,
        want_dag=False, small_dist=True, raw_u16=True, transpose=False,
    )
    assert ok is False and not bool(jok)
    np.testing.assert_array_equal(raw.numpy(), np.asarray(jraw))
    assert ((raw.numpy() >= WBIG16) & (raw.numpy() < INF16)).any()


# -- saturation: latch to int32 and retry -----------------------------------

SATURATING = {
    # the reference's chain (< 64 nodes: no bands, the ELL path)
    "ell_chain": (_chain_dbs, ["c0", "c3", "c6"]),
    # a 65-ring (banded): every distance past 5 hops saturates
    "banded_ring": (_ring_dbs, ["r000", "r020", "r040"]),
}


@pytest.mark.parametrize("name", sorted(SATURATING))
def test_saturating_product_latches_and_retries(name):
    build, dest_names = SATURATING[name]
    csr, jcsr = mirrors(build())
    dests = [csr.node_id[d] for d in dest_names]
    port = _port_product(csr, dests)
    ref = _reference_product(jcsr, dests)
    assert (port[0].bg is None) == (name == "ell_chain")
    assert port[0].small_allowed is False and ref[0].small_allowed is False
    assert port[2].dtype == torch.int32
    _assert_products_equal(port, ref, csr.n_nodes)
    if name == "ell_chain":
        # uint16 attempts up to 32 sweeps, the latch, then int32
        assert port[1][:3] == [(8, True), (16, True), (32, True)]
        assert port[1][3] == (32, False)


@pytest.mark.parametrize("name", sorted(SATURATING))
def test_saturating_view_equals_dijkstra_and_reference(name):
    build, dest_names = SATURATING[name]
    ls, jls = link_states(build())
    engine = DeviceResidencyEngine("cpu")
    view = fleet.FleetViewCache().view(ls, dest_names, engine=engine)
    jview = jfleet.FleetViewCache(delta=False).view(jls, dest_names)
    assert engine.counters["device.engine.small_dist_retries"] == 1
    assert view._dist_dev.dtype == torch.int32
    assert np.asarray(jview._dist_dev).dtype == np.int32
    assert view.sweep_hint == jview.sweep_hint
    assert not view._runner.small_allowed and not jview._runner.small_allowed
    np.testing.assert_array_equal(
        view._dist_dev.numpy(), np.asarray(jview._dist_dev)
    )
    for node in ls.node_names:
        spf = ls.get_spf_result(node)
        for dest in dest_names:
            assert view.dist(node, dest) == spf[dest].metric
            assert view.next_hop_neighbors(node, dest) == spf[dest].next_hops


def test_saturating_route_dbs_equal_reference():
    ls, jls = link_states(_ring_dbs())
    names = ls.node_names
    ps, jps = prefix_states(names, every=13, anycast=False)
    solver = SpfSolver(names[0], device="cpu")
    got = solver.fleet_route_dbs({"0": ls}, ps)
    assert solver.engine.counters["device.engine.small_dist_retries"] == 1
    jsolver = JSpfSolver(names[0])
    for node in names[::8]:
        want = jsolver.build_route_db({"0": jls}, jps, my_node_name=node)
        assert normalized_routes(got[node]) == normalized_routes(want), node


def test_engine_counts_epilogue_variants(monkeypatch):
    """K1's launches per variant and the int32 retries, with a counting
    stand-in for the kernel (the CPU path launches nothing)."""

    def counted(d, *args, **kwargs):
        counted.launches += 1
        return ep.fused_epilogue_reference(d, *args)

    counted.launches = 0
    monkeypatch.setattr(ep, "fused_epilogue", counted)
    engine = DeviceResidencyEngine("cpu")
    ls, _ = link_states(topo.ring_topology(65))
    fleet.FleetViewCache().view(ls, ["r0", "r7"], engine=engine)
    ls, _ = link_states(_ring_dbs())
    fleet.FleetViewCache().view(ls, ["r000"], engine=engine)
    c = engine.counters
    assert c["device.engine.kernel_launches.fused_epilogue.uint16"] == 2
    assert c["device.engine.kernel_launches.fused_epilogue.int32"] == 1
    assert c["device.engine.kernel_launches.fused_epilogue"] == 3
    assert c["device.engine.small_dist_retries"] == 1


# -- warm views from a uint16 prior ------------------------------------------

N = 64


def _ring_chords(metric):
    """A 64-ring with chords of length 2 (banded after reversal) at
    metric(i, j) per directed adjacency."""
    name = lambda i: f"r{i % N:03d}"  # noqa: E731
    return adj_dbs(
        {
            name(i): [
                adj(name(i), name(i + d), metric=metric(i, (i + d) % N))
                for d in (1, -1, 2, -2)
            ]
            for i in range(N)
        }
    )


def _all_metrics(value):
    return lambda i, j: value


def _one_link(value, base=20):
    return lambda i, j: value if {i, j} == {5, 6} else base


# (first metrics, second metrics, the reference's warm mode, the first and
# the second product's dtype)
WARM_CASES = {
    "improve_uint16": (_one_link(90), _all_metrics(20), "improve", "uint16", "uint16"),
    "worsen_uint16": (_all_metrics(20), _one_link(90), "worsen", "uint16", "uint16"),
    # a uint16 seed into a saturating graph: the warm run latches and
    # retries in int32 from the seed
    "worsen_into_saturation": (
        _all_metrics(20), _all_metrics(4000), "worsen", "uint16", "int32"
    ),
    # an int32 seed (a metric at the gate) into the uint16 mode
    "improve_from_int32": (
        _one_link(5000), _all_metrics(20), "improve", "int32", "uint16"
    ),
}


@pytest.mark.parametrize("name", sorted(WARM_CASES))
def test_warm_view_from_prior_equals_cold_and_reference(name):
    first, second, mode, dtype1, dtype2 = WARM_CASES[name]
    pair = LinkStatePair(_ring_chords(first))
    dests = [f"r{i:03d}" for i in (0, 9, 31, 50)]
    cache, jcache = fleet.FleetViewCache(), jfleet.FleetViewCache(delta=False)
    prior = cache.view(pair.ls, dests, device="cpu")
    jcache.view(pair.jls, dests)
    assert str(prior._dist_dev.dtype) == f"torch.{dtype1}"
    pair.update(*(copy.deepcopy(db) for db in _ring_chords(second)))
    engine = DeviceResidencyEngine("cpu")
    warm = cache.view(pair.ls, dests, engine=engine)
    jwarm = jcache.view(pair.jls, dests)
    cold = fleet.FleetViewCache().view(pair.ls, dests, device="cpu")
    assert warm.warm_mode == jwarm.warm_mode == mode
    assert warm.warm and not warm.cold_fallback
    assert str(warm._dist_dev.dtype) == f"torch.{dtype2}"
    assert engine.counters["device.engine.small_dist_retries"] == (
        1 if dtype1 == "uint16" and dtype2 == "int32" else 0
    )
    assert torch.equal(warm._dist_dev, cold._dist_dev)
    assert torch.equal(warm._bitmap_dev, cold._bitmap_dev)
    jdist = np.asarray(jwarm._dist_dev)
    assert warm._dist_dev.numpy().dtype == jdist.dtype
    np.testing.assert_array_equal(warm._dist_dev.numpy(), jdist)
    np.testing.assert_array_equal(
        warm._bitmap_dev.numpy().view(np.uint32), np.asarray(jwarm._bitmap_dev)
    )
    assert warm.sweep_hint == jwarm.sweep_hint


# -- K1's plain uint16 version against the Pallas kernel ---------------------


def _random_tables16(n, p, n_words, n_resid, offsets, seed, saturated):
    """Random [G, N] group tables (weights up to 20, empty slots at
    WBIG16 or WBIG, overloaded rows, slot -1) and a random uint16 product
    on [0, INF16] with INF16 entries, zeros and INF16 columns; with
    `saturated` some finite entries lie in [WBIG16, INF16)."""
    rng = np.random.default_rng(seed)
    v = np.arange(n)
    rows = [(v - c) % n for c in offsets]
    rows += [rng.integers(0, n, n) for _ in range(n_resid)]
    g = len(rows)
    idx = np.asarray(rows).reshape(g, n)
    w = rng.integers(0, 20, (g, n))
    w[rng.random((g, n)) < 0.1] = WBIG16
    w[rng.random((g, n)) < 0.05] = WBIG
    ov = (rng.random((g, n)) < 0.15).astype(np.int64)
    slot = rng.integers(0, 32 * n_words, (g, n))
    slot[rng.random((g, n)) < 0.1] = -1
    d = rng.integers(0, 1 << 12, (n, p))
    d[rng.random((n, p)) < 0.1] = INF16
    d[rng.random((n, p)) < 0.05] = 0
    d[:, rng.choice(p, max(1, p // 10), replace=False)] = INF16
    if saturated:
        hot = rng.random((n, p)) < 0.05
        d[hot] = rng.integers(WBIG16, INF16, int(hot.sum()))
    tables = tuple(a.astype(np.int32) for a in (idx, w, ov, slot))
    return (d.astype(np.uint16),) + tables


def _relaxed16(d, idx, w, ov):
    """`d` relaxed to its fixed point under the uint16 candidate rule."""
    d = d.astype(np.int64)
    while True:
        vmin = d
        for g in range(idx.shape[0]):
            du = d[idx[g]]
            wg = w[g][:, None]
            allow = (wg < WBIG16) & ((ov[g] == 0)[:, None] | (du == 0)) & (du < INF16)
            vmin = np.minimum(vmin, np.where(allow, du + wg, INF16))
        if np.array_equal(vmin, d):
            return d.astype(np.uint16)
        d = vmin


def _pallas16(d, idx, w, ov, slot, n_words):
    """The reference Pallas kernel (interpret mode) on a uint16 product,
    padded as openr_tpu.ops.pallas_kernels.fused_epilogue pads it, with
    the caller's saturation verdict (ops/allsources.py :279-280)."""
    n, p = d.shape
    g = idx.shape[0]
    gp, np_pad, pp = -(-g // 8) * 8, -(-n // 128) * 128, -(-p // 128) * 128

    def pad(a, fill):
        return np.pad(a, ((0, gp - g), (0, np_pad - n)), constant_values=fill)

    dpad = np.pad(d, ((0, np_pad - n), (0, pp - p)), constant_values=INF16)
    bitmap, vmin = pk.fused_epilogue_pallas(
        jnp.asarray(dpad),
        jnp.asarray(pad(idx, 0)),
        jnp.asarray(pad(w, WBIG16)),
        jnp.asarray(pad(ov, 0)),
        jnp.asarray(pad(slot, -1)),
        n_groups=g,
        n_words=n_words,
        interpret=True,
    )
    converged = jnp.all(vmin == jnp.asarray(dpad))
    ok = jsssp.u16_saturation_verdict(jnp.asarray(d), converged)
    bitmap = np.asarray(bitmap)[:, :n, :p].transpose(1, 2, 0)
    return bitmap, bool(ok)


@pytest.mark.parametrize("n_words", [1, 3])
@pytest.mark.parametrize("state", ["converged", "random", "saturated"])
def test_k1_plain_uint16_matches_pallas_interpret(n_words, state):
    """Bands inside and outside the halo, both wraps, empty slots at
    either WBIG, weight 0, overloaded rows meeting d = 0, slot -1, INF16
    entries, a ragged P; unconverged and saturated products must fail
    the verdict exactly as the reference's does."""
    n, p = 150, 37
    d, idx, w, ov, slot = _random_tables16(
        n, p, n_words, 4, (1, 2, 8, 9, 75, n - 1, n - 9), n_words,
        saturated=state == "saturated",
    )
    if state != "random":
        d = _relaxed16(d, idx, w, ov)
    want_bitmap, want_ok = _pallas16(d, idx, w, ov, slot, n_words)
    td = torch.from_numpy(d)
    tables = tuple(torch.from_numpy(a) for a in (idx, w, ov, slot))
    bitmap, ok = ep.fused_epilogue_reference(td, *tables, n_words)
    assert bool(ok) == want_ok == (state == "converged")
    assert np.array_equal(bitmap.numpy().view(np.uint32), want_bitmap)
    assert want_bitmap.any()
    # the public wrapper runs the same plain version for CPU tensors
    bitmap2, ok2 = ep.fused_epilogue(td, *tables, n_words)
    assert torch.equal(bitmap, bitmap2) and bool(ok2) == bool(ok)


def test_k1_uint16_equals_int32_on_the_widened_product():
    """On a converged, unsaturated product whose empty slots carry WBIG
    (as the int32 binding writes them), the uint16 variant and the int32
    variant on `u16_dist_to_i32(d)` give one bitmap and one verdict."""
    n, p, n_words = 150, 40, 2
    d, idx, w, ov, slot = _random_tables16(
        n, p, n_words, 3, (1, 2, 75, n - 1), seed=5, saturated=False
    )
    w[w >= WBIG16] = WBIG
    d = _relaxed16(d, idx, w, ov)
    tables = tuple(torch.from_numpy(a) for a in (idx, w, ov, slot))
    b16, ok16 = ep.fused_epilogue_reference(torch.from_numpy(d), *tables, n_words)
    d32 = sssp.u16_dist_to_i32(torch.from_numpy(d))
    assert (d32.numpy() == INF32).any()
    b32, ok32 = ep.fused_epilogue_reference(d32, *tables, n_words)
    assert bool(ok16) and bool(ok32)
    assert torch.equal(b16, b32)


def test_u16_helpers_equal_reference():
    x = np.array([[0, 1, 19_999, 20_000, 39_999, 40_000]], dtype=np.uint16)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(
        sssp.u16_dist_to_i32(t).numpy(), np.asarray(jsssp.u16_dist_to_i32(jnp.asarray(x)))
    )
    assert torch.equal(sssp.to_u16(sssp.u16_to_i32(t)), t)
    for row in (x[:, :3], x[:, [0, 5]], x):
        got = sssp.u16_saturation_verdict(torch.from_numpy(np.ascontiguousarray(row)), True)
        want = jsssp.u16_saturation_verdict(jnp.asarray(row), jnp.bool_(True))
        assert got == bool(want)
    m = torch.tensor([1, 19_999, 20_000, 1 << 20], dtype=torch.int32)
    np.testing.assert_array_equal(
        sssp.clamp_metric_u16(m).numpy(),
        np.asarray(jsssp.clamp_metric_u16(jnp.asarray(m.numpy()))).astype(np.int32),
    )


def test_epilogue_plan_and_traffic_of_uint16():
    """A uint16 product: at wan100k's shape the slab that fills half a
    50 MiB L2 doubles to 128 columns (the packed kernel's wide path), a
    block takes 64 nodes, whose table entries fit its shared memory, and
    the far gathers move half the bytes."""
    mib = 1 << 20
    bands = (1, 2, 99_998, 99_999)
    p32 = ep.epilogue_plan(100_000, 1024, bands, 50 * mib, 8)
    p16 = ep.epilogue_plan(100_000, 1024, bands, 50 * mib, 8, elem_bytes=2)
    assert (p32.slab_cols, p32.node_tile) == (64, 64)
    assert (p16.path, p16.slab_cols, p16.node_tile) == ("wide", 128, 64)
    assert ep.u16_smem_bytes(p16.node_tile, 8) <= ep.U16_SMEM_BUDGET
    n = 1000
    v = np.arange(n)
    idx = np.stack([(v + 500) % n, (v + 500) % n])
    w = np.zeros_like(idx)
    w[1] = WBIG16  # empty in the uint16 domain only
    plan = ep.EpiloguePlan(64, 64, ep.HALO, (), ())
    t16 = ep.epilogue_traffic(idx, w, 16, plan, small_dist=True)
    t32 = ep.epilogue_traffic(idx, w, 16, plan)
    assert t16["active_pairs"] == n and t32["active_pairs"] == 2 * n
    assert 4 * t16["gather_bytes"] == t32["gather_bytes"]


def test_wrapper_checks_take_uint16_products():
    tables = tuple(torch.zeros((2, 4), dtype=torch.int32) for _ in range(4))
    ep._check_args(torch.zeros((4, 3), dtype=torch.uint16), tables, 1)
    ep._check_args(torch.zeros((4, 3), dtype=torch.int32), tables, 1)
    with pytest.raises(ValueError, match="int32 or uint16"):
        ep._check_args(torch.zeros((4, 3), dtype=torch.int64), tables, 1)
    with pytest.raises(ValueError, match="int32 tables"):
        bad = (tables[0].to(torch.uint16),) + tables[1:]
        ep._check_args(torch.zeros((4, 3), dtype=torch.uint16), bad, 1)
