"""The port's failure-protection runs against openr_tpu's.

SRLG what-if (`srlg_what_if`, `srlg_reachability_loss`) and TI-LFA
backups (`ti_lfa_backups`) through each of the port's three paths — the
forward runner (bands or ELL at an adaptive fixed sweep count), the
masked ELL relax and the dense edge-list relax — against the
reference's results and its host oracle (`LinkState.run_spf` with links
ignored), on the cases of tests/test_protection.py and on banded graphs
(N >= 64).  The operator surface (`protection_api.what_if` / `ti_lfa`
and `Decision.what_if` / `get_ti_lfa`) must return the reference's
dicts.  Integer min-plus: tolerance 0.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.decision import protection_api as jpapi
from openr_tpu.decision.csr import CsrTopology as JCsr
from openr_tpu.ops import protection as jprot
from openr_tpu.utils.topo import grid_topology, random_topology, ring_topology
from openr_tpu_torch import types as pt
from openr_tpu_torch.decision import protection_api as papi
from openr_tpu_torch.decision.csr import CsrTopology
from openr_tpu_torch.device.engine import DeviceResidencyEngine
from openr_tpu_torch.ops import protection as prot
from openr_tpu_torch.ops.sssp import INF32
from openr_tpu_torch.serializer import dumps
from openr_tpu_torch.utils import topo

from torch_parity import link_states, mirrors, to_port_dbs

CPU = torch.device("cpu")
PATHS = ("runner", "ell", "dense")


def _build(jdbs):
    """(port LinkState, port mirror, reference LinkState, reference
    mirror) over the same graph."""
    ls, jls = link_states(to_port_dbs(jdbs))
    return ls, CsrTopology.from_link_state(ls), jls, JCsr.from_link_state(jls)


def _arrays(csr):
    return (csr.edge_src, csr.edge_dst, csr.edge_metric, csr.edge_up,
            csr.node_overloaded)


def _path_kw(csr, path):
    if path == "runner":
        return {"runner": csr.runner(DeviceResidencyEngine(CPU))}
    if path == "ell":
        return {"ell": csr.ell.to(CPU)}
    return {"device": CPU}


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _link_masks(csr, link_ids):
    """Scenario masks killing both directions of each listed link."""
    out = []
    for link_id in link_ids:
        mask = np.ones(csr.edge_capacity, dtype=bool)
        link, _ = csr.edge_links[2 * link_id]
        for e in range(csr.n_edges):
            if csr.edge_links[e][0] is link:
                mask[e] = False
        out.append(mask)
    return np.stack(out)


# -- SRLG what-if --------------------------------------------------------------


@pytest.mark.parametrize("path", PATHS)
def test_what_if_matches_reference_and_oracle(path):
    ls, csr, jls, jcsr = _build(random_topology(16, 14, seed=3))
    sources = np.arange(csr.n_nodes, dtype=np.int32)
    fail_links = [0, min(3, csr.n_edges // 2 - 1), min(7, csr.n_edges // 2 - 1)]
    masks = _link_masks(csr, fail_links)
    dist = _np(prot.srlg_what_if(sources, *_arrays(csr), masks, **_path_kw(csr, path)))
    want = np.asarray(
        jprot.srlg_what_if(
            jnp.asarray(sources), *(jnp.asarray(a) for a in _arrays(jcsr)),
            jnp.asarray(masks),
        )
    )
    n = csr.n_nodes
    np.testing.assert_array_equal(dist[:, :, :n], want[:, :, :n])
    for f, link_id in enumerate(fail_links):
        link, _ = csr.edge_links[2 * link_id]
        for s_name in ["n0", "n5", "n11"]:
            oracle = ls.run_spf(s_name, links_to_ignore={link})
            row = dist[f, csr.node_id[s_name]]
            for v, name in enumerate(csr.node_names):
                want_v = int(oracle[name].metric) if name in oracle else INF32
                assert min(int(row[v]), INF32) == want_v, (f, s_name, name)


@pytest.mark.parametrize("path", PATHS)
def test_reachability_loss_counts(path):
    ls, csr, jls, jcsr = _build(grid_topology(3))
    sources = np.arange(csr.n_nodes, dtype=np.int32)
    all_up = np.ones(csr.edge_capacity, dtype=bool)
    masks = np.stack([all_up, ~all_up])
    dist = prot.srlg_what_if(sources, *_arrays(csr), masks, **_path_kw(csr, path))
    baseline = _np(dist)[0]
    lost, degraded = prot.srlg_reachability_loss(baseline, dist)
    jlost, jdeg = jprot.srlg_reachability_loss(
        jnp.asarray(baseline), jnp.asarray(_np(dist))
    )
    assert lost.tolist() == np.asarray(jlost).tolist() == [0, 9 * 8]
    assert degraded.tolist() == np.asarray(jdeg).tolist() == [0, 0]


@pytest.mark.parametrize("name", ["grid12", "wan256"])
def test_banded_what_if_runner_equals_reference_runner(name):
    dbs = {"grid12": lambda: topo.grid_topology(12),
           "wan256": lambda: topo.wan_topology(256)}[name]()
    csr, jcsr = mirrors(dbs)
    runner = csr.runner(DeviceResidencyEngine(CPU))
    assert runner.bg is not None
    rng = np.random.default_rng(42)
    rev = prot.build_reverse_edge_ids(csr.edge_src[: csr.n_edges], csr.edge_dst[: csr.n_edges])
    fail = rng.integers(0, csr.n_edges, size=40)
    masks = np.ones((40, csr.edge_capacity), dtype=bool)
    masks[np.arange(40), fail] = False
    masks[np.arange(40)[rev[fail] >= 0], rev[fail][rev[fail] >= 0]] = False
    sources = np.asarray([0, 3], dtype=np.int32)
    dist = prot.srlg_what_if(sources, *_arrays(csr), masks, runner=runner)
    want = jprot.srlg_what_if(sources, *_arrays(jcsr), masks, runner=jcsr.runner)
    np.testing.assert_array_equal(dist, want)
    assert runner.hint_masked == jcsr.runner.hint_masked
    lost, deg = prot.srlg_reachability_loss(dist[0], dist)
    jlost, jdeg = jprot.srlg_reachability_loss(jnp.asarray(dist[0]), jnp.asarray(dist))
    assert lost.tolist() == np.asarray(jlost).tolist()
    assert deg.tolist() == np.asarray(jdeg).tolist()


def test_runner_path_refuses_other_arrays():
    _, csr, _, _ = _build(grid_topology(3))
    runner = csr.runner(DeviceResidencyEngine(CPU))
    up = csr.edge_up.copy()
    up[0] = not up[0]
    with pytest.raises(ValueError, match="edge_up differs"):
        prot.srlg_what_if(
            np.zeros(1, np.int32), csr.edge_src, csr.edge_dst, csr.edge_metric,
            up, csr.node_overloaded, np.ones((1, csr.edge_capacity), bool),
            runner=runner,
        )


def test_dense_path_defaults_to_the_card(monkeypatch):
    """Without a runner, an ELL or a device, numpy inputs go to the CUDA
    card (an error where there is none); tensors keep their device."""
    _, csr, _, _ = _build(grid_topology(3))
    sources = np.zeros(1, np.int32)
    masks = np.ones((1, csr.edge_capacity), bool)
    rev = prot.build_reverse_edge_ids(csr.edge_src, csr.edge_dst)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prot.srlg_what_if(sources, *_arrays(csr), masks)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prot.ti_lfa_backups(np.int32(0), np.zeros(1, np.int32), *_arrays(csr),
                            rev, max_degree=1)
    dist = prot.srlg_what_if(torch.from_numpy(sources), *_arrays(csr), masks)
    want = prot.srlg_what_if(sources, *_arrays(csr), masks, device=CPU)
    assert dist.device == CPU
    assert torch.equal(dist, want)
    dist, dag = prot.ti_lfa_backups(torch.tensor(0, dtype=torch.int32),
                                    np.zeros(1, np.int32), *_arrays(csr), rev,
                                    max_degree=1)
    assert dist.device == dag.device == CPU


# -- TI-LFA ------------------------------------------------------------------------


def _ti_lfa(csr, src_id, out_ids, path):
    rev = np.full(csr.edge_capacity, -1, dtype=np.int32)
    rev[: csr.n_edges] = prot.build_reverse_edge_ids(
        csr.edge_src[: csr.n_edges], csr.edge_dst[: csr.n_edges]
    )
    dist, dag = prot.ti_lfa_backups(
        np.int32(src_id), out_ids, *_arrays(csr), rev,
        max_degree=len(out_ids), **_path_kw(csr, path),
    )
    return _np(dist), _np(dag), rev


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("seed", [0, 4])
def test_ti_lfa_matches_reference_and_oracle(path, seed):
    ls, csr, jls, jcsr = _build(random_topology(14, 12, seed=seed))
    src_id = csr.node_id["n2"]
    out_edges = [e for e in range(csr.n_edges) if int(csr.edge_src[e]) == src_id]
    out_ids = np.asarray(out_edges + [-1], dtype=np.int32)
    dist, dag, rev = _ti_lfa(csr, src_id, out_ids, path)
    jdist, jdag = jprot.ti_lfa_backups(
        jnp.int32(src_id), jnp.asarray(out_ids),
        *(jnp.asarray(a) for a in _arrays(jcsr)),
        jprot.build_reverse_edge_ids(jcsr.edge_src, jcsr.edge_dst),
        max_degree=len(out_ids),
    )
    n = csr.n_nodes
    np.testing.assert_array_equal(dist[:, :n], np.asarray(jdist)[:, :n])
    np.testing.assert_array_equal(dag, np.asarray(jdag))
    for d, e in enumerate(out_edges):
        link, _ = csr.edge_links[e]
        oracle = ls.run_spf("n2", links_to_ignore={link})
        for v, name in enumerate(csr.node_names):
            want_v = int(oracle[name].metric) if name in oracle else INF32
            assert min(int(dist[d, v]), INF32) == want_v, (e, name)


@pytest.mark.parametrize("path", PATHS)
def test_backup_avoids_failed_first_hop(path):
    _, csr, _, _ = _build(grid_topology(2))
    src_id = csr.node_id["node-0-0"]
    out_edges = [e for e in range(csr.n_edges) if int(csr.edge_src[e]) == src_id]
    dist, dag, _ = _ti_lfa(csr, src_id, np.asarray(out_edges, dtype=np.int32), path)
    dst_id = csr.node_id["node-1-1"]
    for d, e in enumerate(out_edges):
        assert not dag[d, e]
        assert dist[d, dst_id] == 2


@pytest.mark.parametrize("name", ["grid12", "wan256"])
def test_banded_ti_lfa_runner_equals_reference_runner(name):
    dbs = {"grid12": lambda: topo.grid_topology(12),
           "wan256": lambda: topo.wan_topology(256)}[name]()
    csr, jcsr = mirrors(dbs)
    src_id = 5
    out_edges = np.flatnonzero(csr.edge_src[: csr.n_edges] == src_id).astype(np.int32)
    dist, dag, rev = _ti_lfa(csr, src_id, out_edges, "runner")
    jdist, jdag = jprot.ti_lfa_backups(
        np.int32(src_id), out_edges, *_arrays(jcsr), rev,
        max_degree=len(out_edges), runner=jcsr.runner,
    )
    np.testing.assert_array_equal(dist, jdist)
    np.testing.assert_array_equal(dag, jdag)


def test_failure_masks_and_reverse_pairing_of_parallel_links():
    src = np.asarray([0, 1, 0, 1, 2], dtype=np.int32)
    dst = np.asarray([1, 0, 1, 0, 0], dtype=np.int32)
    rev = prot.build_reverse_edge_ids(src, dst)
    assert rev.tolist() == np.asarray(jprot.build_reverse_edge_ids(src, dst)).tolist()
    assert rev.tolist() == [1, 0, 3, 2, -1]
    out = np.asarray([0, -1, 4], dtype=np.int32)
    got = prot.build_edge_failure_masks(out, rev, 8)
    np.testing.assert_array_equal(got, jprot.build_edge_failure_masks(out, rev, 8))
    assert got[1].all() and not got[0, 0] and not got[0, 1] and not got[2, 4]


# -- the operator surface --------------------------------------------------------


def _api_pair(jdbs):
    ls, jls = link_states(to_port_dbs(jdbs))
    return ls, jls


@pytest.mark.parametrize(
    "scenarios, sources",
    [
        ([[("r0", "r1")]], None),
        ([[("r0", "r1"), ("r0", "r3")]], None),
        ([[("r0", "r1")], [("r0", "nope")]], None),
        ([[("r0", "r1")]], ["r0"]),
    ],
)
def test_api_what_if_equals_reference(scenarios, sources):
    ls, jls = _api_pair(ring_topology(4))
    got = papi.what_if(ls, scenarios, sources, device="cpu")
    assert got == jpapi.what_if(jls, scenarios, sources)


@pytest.mark.parametrize(
    "make, node",
    [(lambda: ring_topology(4), "r0"), (lambda: grid_topology(3), "node-0-0"),
     (lambda: ring_topology(3), "nope"), (lambda: grid_topology(12), "node-5-5")],
)
def test_api_ti_lfa_equals_reference(make, node):
    ls, jls = _api_pair(make())
    got = papi.ti_lfa(ls, node, device="cpu")
    assert got == jpapi.ti_lfa(jls, node)


@pytest.mark.parametrize("cap", [0, 5, 40])
def test_api_ti_lfa_truncation_equals_reference(cap):
    """The per-destination lists are cut at max_report_destinations per
    adjacency, in name order, with the reference's `truncated` flag;
    the counts stay whole."""
    dbs = grid_topology(12)
    dbs = [db for db in dbs if db.this_node_name != "node-1-1"]  # a hole
    ls, jls = _api_pair(dbs)
    got = papi.ti_lfa(ls, "node-0-0", max_report_destinations=cap, device="cpu")
    assert got == jpapi.ti_lfa(jls, "node-0-0", max_report_destinations=cap)
    assert all(a["truncated"] == (cap < 142) for a in got["adjacencies"])


def test_api_ti_lfa_of_a_hub_with_two_words_of_neighbours():
    """A hub linked to 70 leaves on a ring: its first-hop sets span two
    64-bit words; every backup set equals the reference's."""
    from torch_parity import adj, adj_dbs

    n = 70
    leaves = [f"l{i:02d}" for i in range(n)]
    adj_map = {"hub": [adj("hub", leaf, 1) for leaf in leaves]}
    for i, leaf in enumerate(leaves):
        adj_map[leaf] = [
            adj(leaf, "hub", 1),
            adj(leaf, leaves[(i + 1) % n], 1),
            adj(leaf, leaves[(i - 1) % n], 1),
        ]
    ls, jls = link_states(adj_dbs(adj_map))
    got = papi.ti_lfa(ls, "hub", device="cpu")
    assert got == jpapi.ti_lfa(jls, "hub")
    assert len(got["adjacencies"]) == n


def test_api_what_if_fails_every_parallel_link_of_a_pair():
    import dataclasses

    from torch_parity import square_dbs

    dbs = square_dbs()
    for db, other in ((dbs[0], "2"), (dbs[1], "1")):
        a = next(a for a in db.adjacencies if a.other_node_name == other)
        db.adjacencies.append(
            dataclasses.replace(
                a, if_name=a.if_name + "b", other_if_name=a.other_if_name + "b"
            )
        )
    ls, jls = link_states(dbs)
    assert len(ls.links_from_node("1")) == 3
    scenarios = [[("1", "2")], [("2", "1"), ("1", "3")], [("1", "4")]]
    got = papi.what_if(ls, scenarios, device="cpu")
    assert got == jpapi.what_if(jls, scenarios)
    assert got[1]["newly_unreachable_pairs"] == 6 and got[2]["unknown_links"]


def test_api_what_if_budget():
    ls, _ = _api_pair(grid_topology(3))
    csr = CsrTopology.from_link_state(ls)
    too_many = (1 << 28) // (csr.node_capacity + csr.edge_capacity) + 1
    with pytest.raises(ValueError, match="too large"):
        papi.what_if(ls, [[("node-0-0", "node-0-1")]] * too_many, ["node-0-0"], device="cpu")


def test_decision_queries_on_a_banded_graph():
    """Decision.what_if and get_ti_lfa of a 256-node WAN (banded) on the
    card backend's mirror, against the reference's Decision."""
    from test_torch_decision import DecisionPair, prefix_val

    p = DecisionPair(my_node="w000000", with_static=False).run()
    try:
        dbs = topo.wan_topology(256)
        kv = {
            pt.adj_key(db.this_node_name): pt.Value(1, db.this_node_name, dumps(db))
            for db in dbs
        }
        k, v = prefix_val("w000010", "fc00:10::/64")
        kv[k] = v
        p.push(pt.Publication(key_vals=kv, area="0"))
        p.update()
        names = sorted(db.this_node_name for db in dbs)
        scen = [[(names[0], names[1])], [(names[0], names[1]), (names[0], names[2])]]
        got, want = p.call(lambda d: d.what_if(scen, sources=names[:3]))
        assert got == want
        got, want = p.call(lambda d: d.get_ti_lfa(names[0]))
        assert got == want
        csr = p.port.spf_solver.spf.csr_mirror(p.port.area_link_states["0"])
        assert csr._runner is not None and csr._runner.bg is not None
        assert csr._runner.masked_runs >= 2
    finally:
        p.close()
