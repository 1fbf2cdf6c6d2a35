"""The port's per-row masked relax against openr_tpu's, bit for bit.

Each row of a batch is an SPF from one source with that row's own edges
excluded (KSP re-runs, SRLG what-if, TI-LFA).  The same seeded masks go
through both packages' masked ELL relax (`spf_forward_ell_masked`,
`spf_forward_ell_sweeps`), the fixed-sweep banded relax
(`spf_forward_banded`, where an excluded band edge must act as a barrier
inside every composed window), the uint16 SP-DAG
(`sp_dag_mask16_from_T`), the dense edge-list relax (`batched_sssp`,
`sp_dag_mask`) and `SpfRunner.forward` (the learned `hint_masked`, the
uint16 latch).  Distances, DAGs and convergence verdicts must be equal
at every sweep count, converged or not.  Integer min-plus: tolerance 0.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.ops import banded as jbanded
from openr_tpu.ops import sssp as jsssp
from openr_tpu.utils.topo import random_topology
from openr_tpu_torch.device.engine import DeviceResidencyEngine
from openr_tpu_torch.ops import banded, sssp
from openr_tpu_torch.utils import topo

from openr_tpu.decision.csr import CsrTopology as JCsr
from openr_tpu_torch.decision.csr import CsrTopology
from torch_parity import LinkStatePair, adj, adj_dbs, mirrors, overload, to_port_dbs

CPU = torch.device("cpu")

TOPOLOGIES = {
    "ring65": lambda: topo.ring_topology(65),
    "grid12": lambda: topo.grid_topology(12),
    "wan256": lambda: topo.wan_topology(256),
    "random80": lambda: to_port_dbs(random_topology(80, 120, seed=3)),
    "ring65_drained": lambda: overload(topo.ring_topology(65), 7),
    "fat_tree4": lambda: topo.fat_tree_topology(4),
}


def _setup(name):
    csr, jcsr = mirrors(TOPOLOGIES[name]())
    runner = csr.runner(DeviceResidencyEngine(CPU))
    return csr, jcsr, runner, jcsr.runner


def _masks(csr, s: int, per_row: int = 4, seed: int = 0, edges=None):
    """[S, E_cap] bool: each row excludes `per_row` real edges (drawn
    from `edges` when given) and their reverse twins."""
    rng = np.random.default_rng(seed)
    pool = np.arange(csr.n_edges) if edges is None else np.asarray(edges)
    mask = np.ones((s, csr.edge_capacity), dtype=bool)
    for i in range(s):
        mask[i, rng.choice(pool, size=min(per_row, len(pool)), replace=False)] = False
    return mask


def _sources(csr, s: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, csr.n_nodes, s).astype(np.int32)


def _port_arrays(csr):
    return [
        torch.from_numpy(np.ascontiguousarray(a))
        for a in (csr.edge_src, csr.edge_dst, csr.edge_metric, csr.edge_up,
                  csr.node_overloaded)
    ]


def _jax_arrays(jcsr):
    return [
        jnp.asarray(a)
        for a in (jcsr.edge_src, jcsr.edge_dst, jcsr.edge_metric, jcsr.edge_up,
                  jcsr.node_overloaded)
    ]


def _ring(n: int, metric: int):
    """A ring of `n` nodes named in id order (r000, r001, ...), so its
    two bands are straight runs of the whole ring."""
    return adj_dbs(
        {
            f"r{i:03d}": [
                adj(f"r{i:03d}", f"r{j % n:03d}", metric=metric)
                for j in (i - 1, i + 1)
            ]
            for i in range(n)
        }
    )


def _runner_of(dbs):
    csr, jcsr = mirrors(dbs)
    return csr, jcsr, csr.runner(DeviceResidencyEngine(CPU)), jcsr.runner


# -- the masked ELL relax -----------------------------------------------------


@pytest.mark.parametrize("name", ["ring65", "grid12", "random80", "fat_tree4"])
@pytest.mark.parametrize("row_masks", [True, False])
def test_ell_masked_fixed_point_equals_reference(name, row_masks):
    csr, jcsr, _, _ = _setup(name)
    s = 5
    src = _sources(csr, s)
    mask = _masks(csr, s)
    if not row_masks:
        mask = mask[0]
    ell = csr.ell.to(CPU)
    dist, dag = sssp.spf_forward_ell_masked(
        torch.from_numpy(src), ell, *_port_arrays(csr), torch.from_numpy(mask)
    )
    jdist, jdag = jsssp.spf_forward_ell_masked(
        jnp.asarray(src), jcsr.ell, *_jax_arrays(jcsr), jnp.asarray(mask)
    )
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jdist))
    np.testing.assert_array_equal(dag.numpy(), np.asarray(jdag))


@pytest.mark.parametrize("name", ["random80", "fat_tree4"])
def test_ell_masked_hops_without_dag(name):
    csr, jcsr, _, _ = _setup(name)
    src = _sources(csr, 3)
    mask = _masks(csr, 3, seed=5)
    dist, dag = sssp.spf_forward_ell_masked(
        torch.from_numpy(src), csr.ell.to(CPU), *_port_arrays(csr),
        torch.from_numpy(mask), use_link_metric=False, want_dag=False,
    )
    jdist, jdag = jsssp.spf_forward_ell_masked(
        jnp.asarray(src), jcsr.ell, *_jax_arrays(jcsr), jnp.asarray(mask),
        use_link_metric=False, want_dag=False,
    )
    assert dag is None and jdag is None
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jdist))


@pytest.mark.parametrize("n_sweeps", [2, 5, 40])
def test_ell_sweeps_masked_with_dag(n_sweeps):
    """Every sweep count, converged or not: the same dist, DAG and
    verdict as the reference's fixed-sweep masked ELL forward."""
    csr, jcsr, runner, jrunner = _setup("fat_tree4")
    st = runner.call_arrays()
    src = _sources(csr, 4)
    mask = _masks(csr, 4, seed=2)
    dist, dag, ok = sssp.spf_forward_ell_sweeps(
        torch.from_numpy(src), st.ell, st.edge_metric, st.edge_up,
        st.node_overloaded, n_sweeps, edge_src=st.edge_src,
        edge_dst=st.edge_dst, extra_edge_mask=torch.from_numpy(mask),
        want_dag=True,
    )
    jdist, jdag, jok = jsssp.spf_forward_ell_sweeps(
        jnp.asarray(src), jrunner.ell, *jrunner.arrays, n_sweeps=n_sweeps,
        extra_edge_mask=jnp.asarray(mask), want_dag=True,
    )
    assert ok == bool(jok)
    np.testing.assert_array_equal(dist.T.numpy(), np.asarray(jdist))
    np.testing.assert_array_equal(dag.numpy(), np.asarray(jdag))


def test_ell_sweeps_uint16_dag_equals_reference():
    csr, jcsr, runner, jrunner = _setup("random80")
    assert runner.bg is None and runner.small_dist
    st = runner.call_arrays()
    src = _sources(csr, 4)
    mask = _masks(csr, 4, seed=9)
    dist, dag, ok = sssp.spf_forward_ell_sweeps(
        torch.from_numpy(src), st.ell, st.edge_metric, st.edge_up,
        st.node_overloaded, 32, small_dist=True, edge_src=st.edge_src,
        edge_dst=st.edge_dst, extra_edge_mask=torch.from_numpy(mask),
        want_dag=True,
    )
    jdist, jdag, jok = jsssp.spf_forward_ell_sweeps(
        jnp.asarray(src), jrunner.ell, *jrunner.arrays, n_sweeps=32,
        extra_edge_mask=jnp.asarray(mask), want_dag=True, small_dist=True,
    )
    assert ok and bool(jok)
    np.testing.assert_array_equal(dist.T.numpy(), np.asarray(jdist))
    np.testing.assert_array_equal(dag.numpy(), np.asarray(jdag))


def test_relax_allowed_T_with_row_and_edge_masks():
    csr, _, _, _ = _setup("ring65_drained")
    src = _sources(csr, 6)
    mask = _masks(csr, 6, seed=4)
    p = _port_arrays(csr)
    j = _jax_arrays(csr)
    for extra in (mask.T, mask[0]):
        got = sssp.make_relax_allowed_T(
            torch.from_numpy(src), p[0], p[3], p[4], torch.from_numpy(extra)
        )
        want = jsssp.make_relax_allowed_T(
            jnp.asarray(src), j[0], j[3], j[4], jnp.asarray(extra)
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the fixed-sweep banded relax ---------------------------------------------


def _banded_pair(runner, jrunner, src, mask, n_sweeps, **kw):
    st = runner.call_arrays()
    got = banded.spf_forward_banded(
        torch.from_numpy(src), runner.bg, st, n_sweeps, depth=runner.depth,
        chord_mode=runner.chord_mode,
        extra_edge_mask=None if mask is None else torch.from_numpy(mask), **kw,
    )
    want = jbanded.spf_forward_banded(
        jnp.asarray(src), jrunner.bg, *[jnp.asarray(a) for a in jrunner.arrays],
        n_supersweeps=n_sweeps, depth=jrunner.depth,
        chord_mode=jrunner.chord_mode,
        extra_edge_mask=None if mask is None else jnp.asarray(mask), **kw,
    )
    return got, want


def _assert_banded_equal(got, want, want_dag=True):
    dist, dag, ok = got
    jdist, jdag, jok = want
    assert bool(ok) == bool(jok)
    np.testing.assert_array_equal(dist.T.numpy(), np.asarray(jdist))
    if want_dag:
        np.testing.assert_array_equal(dag.numpy(), np.asarray(jdag))
    else:
        assert dag is None and jdag is None


@pytest.mark.parametrize("name", ["ring65", "grid12", "wan256", "ring65_drained"])
@pytest.mark.parametrize("n_sweeps", [1, 3, 12])
def test_banded_row_masks_equal_reference(name, n_sweeps):
    csr, jcsr, runner, jrunner = _setup(name)
    assert runner.bg is not None
    src = _sources(csr, 5)
    mask = _masks(csr, 5, seed=n_sweeps)
    _assert_banded_equal(*_banded_pair(runner, jrunner, src, mask, n_sweeps))


@pytest.mark.parametrize("name", ["grid12", "wan256"])
def test_banded_edge_mask_and_hops(name):
    """An [E] mask shared by every row, hop counts, no DAG."""
    csr, jcsr, runner, jrunner = _setup(name)
    src = _sources(csr, 4)
    mask = _masks(csr, 1, per_row=6, seed=7)[0]
    _assert_banded_equal(
        *_banded_pair(runner, jrunner, src, mask, 16, use_link_metric=False,
                      want_dag=False),
        want_dag=False,
    )


def _straight_run(bg, length: int = 4):
    """(band, c, v): band `b` of offset c holds the edges into v - k*c and
    v + k*c for k < length, a straight run through v."""
    n = bg.n_nodes
    counts = (bg.band_eid >= 0).sum(axis=1)
    b = int(np.argmax(counts))
    c = bg.offsets[b]
    for v in range(n):
        if all(
            bg.band_eid[b, (v + k * c) % n] >= 0
            for k in range(-length, length)
        ):
            return b, c, v
    raise AssertionError("no straight band run")


@pytest.mark.parametrize("n_sweeps", [1, 2, 4])
def test_cut_inside_a_composed_band_window(n_sweeps):
    """A ring named in id order is two straight band runs, which the
    supersweep relaxes through composed windows (depth >= 2).  With the
    band edge into v and its reverse cut for rows 0 and 1, no window
    spanning the cut may jump it, at every sweep count."""
    csr, jcsr, runner, jrunner = _runner_of(_ring(80, 1))
    bg = runner.bg
    assert not runner.chord_mode and runner.depth >= 2
    n = bg.n_nodes
    b, c, v = _straight_run(bg)
    cut = [int(bg.band_eid[b, v])]
    for b2, c2 in enumerate(bg.offsets):
        if (c2 + c) % n == 0 and bg.band_eid[b2, (v - c) % n] >= 0:
            cut.append(int(bg.band_eid[b2, (v - c) % n]))
    up = (v - 4 * c) % n
    src = np.asarray([up, (v - 3 * c) % n, up, (v + 3 * c) % n], dtype=np.int32)
    mask = np.ones((len(src), csr.edge_capacity), dtype=bool)
    mask[:2, cut] = False
    _assert_banded_equal(*_banded_pair(runner, jrunner, src, mask, n_sweeps))
    # the cut forces a detour: row 0 differs from the unmasked row 2
    dist, _, ok = _banded_pair(runner, jrunner, src, mask, 24)[0]
    assert bool(ok)
    assert int(dist[(v + 3 * c) % n, 0]) > int(dist[(v + 3 * c) % n, 2])


def test_banded_metric_plane_equals_reference():
    csr, jcsr, runner, jrunner = _setup("wan256")
    plane = csr.edge_metric.copy()
    plane[: csr.n_edges] = np.random.default_rng(17).integers(1, 101, csr.n_edges)
    src = _sources(csr, 3)
    mask = _masks(csr, 3, seed=11)
    st = runner.call_arrays()._replace(edge_metric=torch.from_numpy(plane))
    got = banded.spf_forward_banded(
        torch.from_numpy(src), runner.bg, st, 20, depth=runner.depth,
        chord_mode=runner.chord_mode, extra_edge_mask=torch.from_numpy(mask),
    )
    arr = [jnp.asarray(a) for a in jrunner.arrays]
    arr[2] = jnp.asarray(plane)
    want = jbanded.spf_forward_banded(
        jnp.asarray(src), jrunner.bg, *arr, n_supersweeps=20,
        depth=jrunner.depth, chord_mode=jrunner.chord_mode,
        extra_edge_mask=jnp.asarray(mask),
    )
    _assert_banded_equal(got, want)


@pytest.mark.parametrize("raw", [False, True])
def test_banded_uint16_dag_and_raw_product(raw):
    csr, jcsr, runner, jrunner = _setup("grid12")
    assert runner.small_dist
    src = _sources(csr, 4)
    mask = _masks(csr, 4, seed=13)
    got, want = _banded_pair(
        runner, jrunner, src, mask, 12, small_dist=True, want_dag=not raw,
        raw_u16=raw,
    )
    if raw:
        assert got[0].dtype == torch.uint16
        assert bool(got[2]) == bool(want[2])
        np.testing.assert_array_equal(
            sssp.u16_to_i32(got[0]).T.numpy(), np.asarray(want[0]).astype(np.int32)
        )
    else:
        _assert_banded_equal(got, want)


def test_sp_dag_mask16_equals_reference():
    csr, jcsr, runner, jrunner = _setup("wan256")
    src = _sources(csr, 4)
    dist16, _, _ = banded.spf_forward_banded(
        torch.from_numpy(src), runner.bg, runner.call_arrays(), 20,
        depth=runner.depth, chord_mode=runner.chord_mode, small_dist=True,
        want_dag=False, raw_u16=True,
    )
    p = _port_arrays(csr)
    allowed = sssp.make_relax_allowed_T(torch.from_numpy(src), p[0], p[3], p[4])
    got = sssp.sp_dag_mask16_from_T(dist16, p[0], p[1], p[2], allowed)
    j = _jax_arrays(csr)
    want = jsssp.sp_dag_mask16_from_T(
        jnp.asarray(sssp.u16_to_i32(dist16).numpy()).astype(jnp.uint16),
        j[0], j[1], j[2],
        jsssp.make_relax_allowed_T(jnp.asarray(src), j[0], j[3], j[4]),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the dense edge-list relax ------------------------------------------------


@pytest.mark.parametrize("name", ["ring65_drained", "random80"])
def test_dense_relax_and_dag_equal_reference(name):
    csr, jcsr, _, _ = _setup(name)
    src = _sources(csr, 4)
    mask = _masks(csr, 4, seed=21)
    p = _port_arrays(csr)
    j = _jax_arrays(csr)
    n_cap = csr.node_capacity
    allowed = sssp.make_relax_allowed(
        torch.from_numpy(src), p[0], p[3], p[4], torch.from_numpy(mask)
    )
    jallowed = jsssp.make_relax_allowed(
        jnp.asarray(src), j[0], j[3], j[4], jnp.asarray(mask)
    )
    np.testing.assert_array_equal(allowed.numpy(), np.asarray(jallowed))
    dist = sssp.batched_sssp(
        sssp.make_dist0(torch.from_numpy(src), n_cap), p[0], p[1], p[2], allowed
    )
    jdist = jsssp.batched_sssp(
        jsssp.make_dist0(jnp.asarray(src), n_cap), j[0], j[1], j[2], jallowed
    )
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jdist))
    dag = sssp.sp_dag_mask(dist, p[0], p[1], p[2], allowed)
    jdag = jsssp.sp_dag_mask(jdist, j[0], j[1], j[2], jallowed)
    np.testing.assert_array_equal(dag.numpy(), np.asarray(jdag))


# -- SpfRunner.forward: hints, the uint16 latch -------------------------------


@pytest.mark.parametrize("name", ["grid12", "wan256", "fat_tree4", "ring65_drained"])
def test_forward_learns_hint_masked_as_reference(name):
    csr, jcsr, runner, jrunner = _setup(name)
    src = _sources(csr, 6)
    mask = _masks(csr, 6, seed=31)
    for kw in ({}, {"extra_edge_mask": mask}, {"extra_edge_mask": mask[0]}):
        dist, dag = runner.forward(src, **kw)
        jdist, jdag = jrunner.forward(src, **kw)
        np.testing.assert_array_equal(dist, jdist)
        np.testing.assert_array_equal(dag, jdag)
        assert (runner.hint, runner.hint_masked) == (jrunner.hint, jrunner.hint_masked)
    assert runner.masked_runs >= 2


def test_forward_masked_latches_uint16_as_reference():
    """Every metric passes the uint16 gate, but the far side of the ring
    lies past WBIG16: the masked run saturates, the latch drops the mode
    and the int32 run answers, in both packages alike."""
    csr, jcsr, runner, jrunner = _runner_of(_ring(65, 4000))
    assert runner.small_dist and runner.bg is not None
    src = np.asarray([0, 5], dtype=np.int32)
    mask = _masks(csr, 2, per_row=2, seed=3)
    dist, dag = runner.forward(src, extra_edge_mask=mask)
    jdist, jdag = jrunner.forward(src, extra_edge_mask=mask)
    np.testing.assert_array_equal(dist, jdist)
    np.testing.assert_array_equal(dag, jdag)
    assert not runner.small_allowed and not jrunner.small_allowed
    assert (runner.hint, runner.hint_masked) == (jrunner.hint, jrunner.hint_masked)
    assert dist.max() > sssp.WBIG16


@pytest.mark.parametrize("name", ["wan256", "fat_tree4"])
def test_forward_runner_shares_the_resident(name):
    """The mirror's forward runner reads the tensors of the mirror's
    resident in the engine (the bands are its only own copy); a metric
    change reaches it as one incremental write into that resident, and
    its masked results then equal the reference's on the refreshed
    mirror."""
    dbs = TOPOLOGIES[name]()
    pair = LinkStatePair(dbs)
    csr = CsrTopology.from_link_state(pair.ls)
    jcsr = JCsr.from_link_state(pair.jls)
    engine = DeviceResidencyEngine(CPU)
    runner = csr.runner(engine)
    res = engine._residents[id(csr)]

    def shared() -> bool:
        st = runner.call_arrays()
        return (
            st.edge_metric is res.edge_metric
            and st.edge_up is res.edge_up
            and st.node_overloaded is res.node_overloaded
            and st.edge_src is res.edge_src
            and st.edge_dst is res.edge_dst
            and (runner.bg is not None or st.ell is res.ell)
        )

    assert shared()
    dbs[3].adjacencies[0].metric += 7
    pair.update(dbs[3])
    assert csr.refresh(pair.ls) and jcsr.refresh(pair.jls)
    counters = engine.get_counters()
    assert counters["device.engine.full_restages"] == 1
    assert counters["device.engine.incremental_updates"] == 1
    assert csr.runner(engine) is runner and shared()
    np.testing.assert_array_equal(res.edge_metric.numpy(), csr.edge_metric)
    src = _sources(csr, 6)
    mask = _masks(csr, 6, seed=37)
    dist, dag = runner.forward(src, extra_edge_mask=mask)
    jdist, jdag = jcsr.runner.forward(src, extra_edge_mask=mask)
    np.testing.assert_array_equal(dist, jdist)
    np.testing.assert_array_equal(dag, jdag)


def test_forward_fixed_sweeps_raise_when_short():
    csr, _, runner, _ = _setup("grid12")
    src = _sources(csr, 2)
    with pytest.raises(RuntimeError, match="did not converge"):
        runner.forward(src, extra_edge_mask=_masks(csr, 2), n_sweeps=1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["wan256", "fat_tree4"])
def test_masked_forward_on_card_equals_cpu(name):
    """The masked forward (bands, or the ELL) on the card equals the
    port's CPU result on the same inputs, hints included (runs with
    `-m cuda` on a machine with a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    csr, _ = mirrors(TOPOLOGIES[name]())
    src = _sources(csr, 6)
    mask = _masks(csr, 6, seed=41)
    results = []
    for device in ("cpu", "cuda"):
        csr._runner = None
        runner = csr.runner(DeviceResidencyEngine(device))
        dist, dag = runner.forward(src, extra_edge_mask=mask)
        results.append((dist, dag, runner.hint_masked, runner.sweeps))
    (d0, g0, h0, s0), (d1, g1, h1, s1) = results
    np.testing.assert_array_equal(d0, d1)
    np.testing.assert_array_equal(g0, g1)
    assert (h0, s0) == (h1, s1)
