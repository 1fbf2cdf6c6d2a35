"""Shared fixtures of the openr_tpu_torch parity tests: the same
topologies and prefixes, built once with the port's types and converted
field by field into the JAX package's types, so both packages see
identical inputs."""

from __future__ import annotations

import dataclasses

import numpy as np

from openr_tpu import types as jt
from openr_tpu.decision.csr import CsrTopology as JCsr
from openr_tpu.decision.link_state import LinkState as JLinkState
from openr_tpu.decision.prefix_state import PrefixState as JPrefixState
from openr_tpu_torch import types as pt
from openr_tpu_torch.decision.csr import CsrTopology
from openr_tpu_torch.decision.link_state import LinkState
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.utils import topo


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def to_jax_dbs(dbs):
    """Port AdjacencyDatabases as openr_tpu AdjacencyDatabases."""
    out = []
    for db in dbs:
        f = _fields(db)
        f["adjacencies"] = [jt.Adjacency(**_fields(a)) for a in db.adjacencies]
        out.append(jt.AdjacencyDatabase(**f))
    return out


def to_jax_entry(entry: pt.PrefixEntry) -> jt.PrefixEntry:
    f = _fields(entry)
    f["metrics"] = jt.PrefixMetrics(**_fields(entry.metrics))
    f["type"] = jt.PrefixType(int(entry.type))
    f["forwarding_type"] = jt.PrefixForwardingType(int(entry.forwarding_type))
    f["forwarding_algorithm"] = jt.PrefixForwardingAlgorithm(
        int(entry.forwarding_algorithm)
    )
    return jt.PrefixEntry(**f)


def overload(dbs, index: int):
    """The fixture with node `index` drained."""
    dbs[index].is_overloaded = True
    return dbs


# name -> port AdjacencyDatabases; every family is banded after reversal
FAMILIES = {
    "ring65": lambda: topo.ring_topology(65),
    "grid20": lambda: topo.grid_topology(20),
    "wan256": lambda: topo.wan_topology(256, labeled=range(0, 256, 9)),
    "ring65_drained": lambda: overload(topo.ring_topology(65), 7),
    "hub_w2": lambda: topo.hub_topology(labeled=[0, 5, 32]),
}


def link_states(dbs):
    """(port LinkState, openr_tpu LinkState) over the same databases."""
    ls, jls = LinkState(), JLinkState()
    for db in dbs:
        ls.update_adjacency_database(db)
    for db in to_jax_dbs(dbs):
        jls.update_adjacency_database(db)
    return ls, jls


def mirrors(dbs):
    """(port CsrTopology, openr_tpu CsrTopology) over the same graph."""
    ls, jls = link_states(dbs)
    return CsrTopology.from_link_state(ls), JCsr.from_link_state(jls)


def prefix_states(names, every: int = 5, anycast: bool = True):
    """(port PrefixState, openr_tpu PrefixState): one /64 on every
    `every`-th node, alternating IP and SR_MPLS forwarding with a
    prepend label on some, plus one anycast /64 on two nodes with a
    min-nexthop threshold."""
    entries = []
    for k, i in enumerate(range(0, len(names), every)):
        sr = k % 2 == 1
        entries.append(
            (
                names[i],
                pt.PrefixEntry(
                    prefix=f"fc00:{i:x}::/64",
                    forwarding_type=(
                        pt.PrefixForwardingType.SR_MPLS
                        if sr
                        else pt.PrefixForwardingType.IP
                    ),
                    prepend_label=100 + i if sr and k % 4 == 1 else None,
                ),
            )
        )
    if anycast:
        for i in (1, len(names) // 2):
            entries.append(
                (names[i], pt.PrefixEntry(prefix="fd00::/64", min_nexthop=1))
            )
    ps, jps = PrefixState(), JPrefixState()
    for node, entry in entries:
        ps.update_prefix(node, "0", entry)
        jps.update_prefix(node, "0", to_jax_entry(entry))
    return ps, jps


def _nh(nh) -> tuple:
    action = nh.mpls_action
    return (
        nh.address,
        nh.if_name,
        nh.metric,
        nh.weight,
        nh.area,
        nh.neighbor_node_name,
        None
        if action is None
        else (int(action.action), action.swap_label, action.push_labels),
    )


def normalized_routes(db) -> tuple[dict, dict]:
    """(prefix -> (sorted next hops, best area, best prefix),
    label -> sorted next hops) of a route DB of either package."""
    unicast = {
        p: (
            sorted(map(_nh, r.nexthops), key=repr),
            r.best_area,
            r.best_prefix_entry.prefix if r.best_prefix_entry else None,
            r.do_not_install,
        )
        for p, r in db.unicast_routes.items()
    }
    mpls = {
        label: sorted(map(_nh, r.nexthops), key=repr)
        for label, r in db.mpls_routes.items()
    }
    return unicast, mpls


def break_fixed_point(d: np.ndarray, idx, w, ov, inf: int, wbig: int):
    """A copy of the converged product `d` [N, P] with one finite entry
    lowered by 1 where some other node's shortest path runs through it
    (a tight, allowed, non-source relax candidate), so the epilogue's
    verdict must turn False.  Tables are numpy [G, N]."""
    for g in range(idx.shape[0]):
        du = d[idx[g]]
        allow = (w[g] < wbig)[:, None] & ((ov[g] == 0)[:, None] | (du == 0))
        tight = allow & (du < inf) & (du > 0) & (du + w[g][:, None] == d)
        tight &= d < inf
        hits = np.argwhere(tight)
        if len(hits):
            v, p = hits[0]
            out = d.copy()
            out[idx[g][v], p] -= 1
            return out
    raise AssertionError("no tight relax edge to break")
