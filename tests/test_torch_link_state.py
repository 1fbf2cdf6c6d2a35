"""The port's LinkState change reporting against openr_tpu's.

`update_adjacency_database` returns a `LinkStateChange` and bumps
`version` as the reference does (openr_tpu/decision/link_state.py
update_adjacency_database): a new node bumps once for the node set, a
topology change bumps again, and an attribute-only change (next-hop
address, adjacency label) is written in place without a bump, while a
surviving link keeps its weight.  On the 4-node square of
tests/torch_parity.square_dbs, after each change, the change fields,
`version`, every link's weights and attributes, the route DBs of every
node and the engine's per-source counters equal the reference's (its
backend forced to the device).
"""

from __future__ import annotations

import copy
import dataclasses

import pytest

from openr_tpu.decision.prefix_state import PrefixState as JPrefixState
from openr_tpu.decision.spf_solver import DeviceSpfBackend as JDeviceSpfBackend
from openr_tpu.decision.spf_solver import SpfSolver as JSpfSolver
from openr_tpu_torch.decision.link_state import LinkState, LinkStateChange
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.decision.spf_solver import DeviceSpfBackend, SpfSolver
from openr_tpu_torch.types import PrefixEntry

from torch_parity import (
    LinkStatePair,
    adj,
    adj_dbs,
    normalized_routes,
    square_dbs,
    to_jax_dbs,
    to_jax_entry,
)

# the per-source engine counters a change may move; the bytes of an
# incremental write differ by design (the port writes the changed indices,
# the reference pads them to a power of two), so they are compared only
# where no attribute write is due
COUNTERS = (
    "device.engine.queries",
    "device.engine.incremental_updates",
    "device.engine.full_restages",
)
BYTES = "device.engine.bytes_staged"


def _first_adj(field: str, value):
    """Node "1"'s database with its first adjacency's `field` set."""

    def change(dbs):
        db = copy.deepcopy(dbs[0])
        setattr(db.adjacencies[0], field, value)
        return [db]

    return change


def _new_node(dbs):
    """Node "5" joins, linked to "4"; then "4" advertises the link."""
    five = adj_dbs({"5": [adj("5", "4")]}, labels={"5": 105})[0]
    four = copy.deepcopy(dbs[3])
    four.adjacencies.append(adj("4", "5"))
    return [five, four]


CHANGES = {
    "next_hop_v4": _first_adj("next_hop_v4", "10.9.9.9"),
    "next_hop_v6": _first_adj("next_hop_v6", "fe80::99"),
    "adj_label": _first_adj("adj_label", 50001),
    "weight": _first_adj("weight", 5),
    "metric": _first_adj("metric", 3),
    "new_node": _new_node,
}


def _prefixes():
    ps, jps = PrefixState(), JPrefixState()
    for node, prefix in (("4", "::4:0/112"), ("2", "::2:0/112"), ("3", "::2:0/112")):
        entry = PrefixEntry(prefix=prefix)
        ps.update_prefix(node, "0", entry)
        jps.update_prefix(node, "0", to_jax_entry(entry))
    return ps, jps


def _link_key(link):
    ends = [name for name, _ in link.ordered_names]
    return (
        link.ordered_names,
        tuple(
            (
                link.metric_from_node(n),
                link.weight_from_node(n),
                link.adj_label_from_node(n),
                link.nh_v4_from_node(n),
                link.nh_v6_from_node(n),
            )
            for n in ends
        ),
        link.is_up(),
    )


def _links(ls) -> list:
    return sorted(_link_key(link) for link in ls.all_links)


def _counters(engine, with_bytes: bool = True) -> dict:
    got = engine.get_counters()
    return {k: got[k] for k in COUNTERS + ((BYTES,) if with_bytes else ())}


def test_initial_versions_equal_reference():
    pair = LinkStatePair(square_dbs())
    assert pair.ls.version == pair.jls.version == 7
    assert _links(pair.ls) == _links(pair.jls)


def test_change_fields_of_a_first_database():
    ls = LinkState()
    change = ls.update_adjacency_database(square_dbs()[0])
    assert change == LinkStateChange(node_label_changed=True)
    assert ls.version == 1


@pytest.mark.parametrize("name", sorted(CHANGES))
def test_change_equals_reference(name):
    pair = LinkStatePair(square_dbs())
    ps, jps = _prefixes()
    be = DeviceSpfBackend("cpu")
    jbe = JDeviceSpfBackend(min_device_nodes=1, min_device_sources=1)
    solver = SpfSolver("1", spf_backend=be)
    jsolver = JSpfSolver("1", spf_backend=jbe)
    nodes = pair.ls.node_names
    for node in nodes:
        solver.build_route_db({"0": pair.ls}, ps, my_node_name=node)
        jsolver.build_route_db({"0": pair.jls}, jps, my_node_name=node)
    before = (pair.ls.version, pair.jls.version)

    for db in CHANGES[name](square_dbs()):
        change = pair.ls.update_adjacency_database(copy.deepcopy(db))
        jchange = pair.jls.update_adjacency_database(to_jax_dbs([db])[0])
        assert dataclasses.astuple(change) == dataclasses.astuple(jchange), db
        assert pair.ls.version == pair.jls.version
    assert _links(pair.ls) == _links(pair.jls)
    if name in ("next_hop_v4", "next_hop_v6", "adj_label", "weight"):
        # attribute-only changes: no bump, and the weight is not written
        assert (pair.ls.version, pair.jls.version) == before
    else:
        assert pair.ls.version > before[0]

    for node in pair.ls.node_names:
        got = solver.build_route_db({"0": pair.ls}, ps, my_node_name=node)
        want = jsolver.build_route_db({"0": pair.jls}, jps, my_node_name=node)
        assert normalized_routes(got) == normalized_routes(want), node
    if name == "next_hop_v6":
        # the new address reaches the route DB with no recomputation
        got = solver.build_route_db({"0": pair.ls}, ps, my_node_name="1")
        assert "fe80::99" in repr(got.unicast_routes)
    with_bytes = name != "metric"
    assert _counters(be.engine, with_bytes) == _counters(jbe.engine, with_bytes)


def test_change_sequence_equals_reference():
    """Every change of CHANGES in one sequence, as a flapping network
    sends them: versions, links and counters stay equal throughout."""
    pair = LinkStatePair(square_dbs())
    be = DeviceSpfBackend("cpu")
    jbe = JDeviceSpfBackend(min_device_nodes=1, min_device_sources=1)
    for name in sorted(CHANGES):
        for db in CHANGES[name](square_dbs()):
            change = pair.ls.update_adjacency_database(copy.deepcopy(db))
            jchange = pair.jls.update_adjacency_database(to_jax_dbs([db])[0])
            assert dataclasses.astuple(change) == dataclasses.astuple(jchange)
            assert pair.ls.version == pair.jls.version, name
        be.get_spf_result(pair.ls, "1")
        jbe.get_spf_result(pair.jls, "1")
        assert _links(pair.ls) == _links(pair.jls), name
        assert _counters(be.engine, False) == _counters(jbe.engine, False), name
