"""openr_tpu_torch's host tables against openr_tpu's, exactly.

The CSR mirror, the reversed runner's banded decomposition and relax
settings, the out-edge table and the epilogue's slot maps are numpy in
both packages; on every fixture family they must be identical arrays.
"""

from __future__ import annotations

import numpy as np
import pytest

from openr_tpu.decision.fleet import _reverse_runner as j_reverse_runner
from openr_tpu.ops import allsources as jasrc
from openr_tpu.utils import topo as jtopo
from openr_tpu_torch.decision.csr import ARRAY_FIELDS, CsrTopology
from openr_tpu_torch.decision.fleet import _reverse_runner
from openr_tpu_torch.ops import allsources as asrc
from openr_tpu_torch.utils import topo

from torch_parity import FAMILIES, mirrors

CSR_ARRAYS = ARRAY_FIELDS + ("out_slot",)
CSR_SCALARS = (
    "node_names",
    "n_nodes",
    "node_capacity",
    "edge_capacity",
    "n_edges",
    "max_out_slots",
)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    csr, jcsr = mirrors(FAMILIES[request.param]())
    return request.param, csr, jcsr, _reverse_runner(csr), j_reverse_runner(jcsr)


def _assert_csr_equal(csr, jcsr):
    for name in CSR_SCALARS:
        assert getattr(csr, name) == getattr(jcsr, name), name
    for name in CSR_ARRAYS:
        np.testing.assert_array_equal(
            getattr(csr, name), np.asarray(getattr(jcsr, name)), err_msg=name
        )


def test_csr_arrays(family):
    _, csr, jcsr, _, _ = family
    _assert_csr_equal(csr, jcsr)


def test_from_arrays_round_trips_reference_fields(family):
    _, _, jcsr, _, _ = family
    fields = {name: getattr(jcsr, name) for name in ARRAY_FIELDS}
    fields["n_edges"] = jcsr.n_edges
    fields["edge_live"] = jcsr.edge_live
    csr = CsrTopology.from_arrays(fields, jcsr.node_names, jcsr.version)
    _assert_csr_equal(csr, jcsr)
    assert csr.node_id == jcsr.node_id


def test_reverse_runner_banded_tables(family):
    name, csr, jcsr, runner, jrunner = family
    bg, jbg = runner.bg, jrunner.bg
    assert bg is not None and jbg is not None, name
    assert bg.offsets == jbg.offsets
    assert bg.n_nodes == jbg.n_nodes
    assert bg.resid_buckets == jbg.resid_buckets
    for attr in ("band_eid", "resid_nbr", "resid_eid"):
        np.testing.assert_array_equal(
            getattr(bg, attr), np.asarray(getattr(jbg, attr)), err_msg=attr
        )
    assert (runner.chord_mode, runner.depth, runner.resid_rounds, runner.hint) == (
        jrunner.chord_mode,
        jrunner.depth,
        jrunner.resid_rounds,
        jrunner.hint,
    )
    for a, ja in zip(runner.arrays, jrunner.arrays):
        np.testing.assert_array_equal(a, np.asarray(ja))


def test_out_ell_and_epilogue_maps(family):
    name, csr, jcsr, runner, jrunner = family
    out = asrc.build_out_ell(
        csr.edge_src, csr.edge_dst, csr.n_edges, csr.n_nodes, csr.out_slot
    )
    jout = jasrc.build_out_ell(
        jcsr.edge_src,
        jcsr.edge_dst,
        jcsr.n_edges,
        jcsr.n_nodes,
        out_slot=jcsr.out_slot,
    )
    assert out.n_words == jout.n_words
    if name == "hub_w2":
        assert out.n_words == 2
    for attr in ("nbr", "eid", "slot"):
        np.testing.assert_array_equal(
            getattr(out, attr), np.asarray(getattr(jout, attr)), err_msg=attr
        )
    # recomputing the slots when none are given lands on the same table
    np.testing.assert_array_equal(
        asrc.build_out_ell(
            csr.edge_src, csr.edge_dst, csr.n_edges, csr.n_nodes
        ).slot,
        out.slot,
    )
    maps = asrc.build_epilogue_maps(runner.bg, out)
    jmaps = jasrc.build_epilogue_maps(jrunner.bg, jout)
    np.testing.assert_array_equal(maps.resid_slot, np.asarray(jmaps.resid_slot))
    np.testing.assert_array_equal(maps.band_slot, np.asarray(jmaps.band_slot))


@pytest.mark.parametrize("n_side", [3, 20])
def test_grid_and_ring_generators_match_reference(n_side):
    for mine, ref in (
        (topo.grid_topology(n_side), jtopo.grid_topology(n_side)),
        (topo.ring_topology(n_side * 3), jtopo.ring_topology(n_side * 3)),
    ):
        assert [
            (db.this_node_name, db.node_label, db.area, [
                (a.other_node_name, a.if_name, a.other_if_name, a.metric,
                 a.next_hop_v6)
                for a in db.adjacencies
            ])
            for db in mine
        ] == [
            (db.this_node_name, db.node_label, db.area, [
                (a.other_node_name, a.if_name, a.other_if_name, a.metric,
                 a.next_hop_v6)
                for a in db.adjacencies
            ])
            for db in ref
        ]


@pytest.mark.parametrize("n_nodes,chords,seed", [(256, 2, 0), (96, 2, 3)])
def test_wan_topology_matches_synthetic_wan(n_nodes, chords, seed):
    from benchmarks import synthetic

    ref = synthetic.wan(n_nodes, chords=chords, seed=seed)
    csr, _ = mirrors(topo.wan_topology(n_nodes, chords=chords, seed=seed))
    e = ref.n_edges
    assert csr.n_edges == e
    assert csr.node_names == sorted(csr.node_names)
    for attr in ("edge_src", "edge_dst", "edge_metric", "edge_up"):
        np.testing.assert_array_equal(
            getattr(csr, attr)[:e], getattr(ref, attr)[:e], err_msg=attr
        )


def test_wan_topology_labels_only_named_advertisers():
    dbs = topo.wan_topology(128, labeled=[3, 70])
    labels = {db.this_node_name: db.node_label for db in dbs if db.node_label}
    assert labels == {"w000003": 19, "w000070": 86}
