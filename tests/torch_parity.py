"""Shared fixtures of the openr_tpu_torch parity tests: the same
topologies and prefixes, built once with the port's types and converted
field by field into the JAX package's types, so both packages see
identical inputs."""

from __future__ import annotations

import copy
import dataclasses
import enum
from types import SimpleNamespace

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


def to_ref(obj):
    """The openr_tpu counterpart of a port object (wire types, RIB
    entries and updates, RibPolicy configs), field by field."""
    from openr_tpu.decision import rib as jrib
    from openr_tpu.decision import rib_policy as jpol

    if isinstance(obj, enum.Enum):
        return getattr(jt, type(obj).__name__)(int(obj))
    if dataclasses.is_dataclass(obj):
        name = type(obj).__name__
        cls = next(
            getattr(m, name) for m in (jt, jrib, jpol) if hasattr(m, name)
        )
        return cls(
            **{f.name: to_ref(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
        )
    if isinstance(obj, dict):
        return {k: to_ref(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, frozenset, set)):
        return type(obj)(to_ref(v) for v in obj)
    return obj


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


def to_port_dbs(jdbs):
    """openr_tpu AdjacencyDatabases as port AdjacencyDatabases."""

    def port(cls, obj, **extra):
        names = [f.name for f in dataclasses.fields(cls)]
        return cls(**{**{n: getattr(obj, n) for n in names}, **extra})

    return [
        port(
            pt.AdjacencyDatabase,
            db,
            adjacencies=[port(pt.Adjacency, a) for a in db.adjacencies],
        )
        for db in jdbs
    ]


class LinkStatePair:
    """One port and one openr_tpu LinkState, changed together: every
    update hands each package its own copy of the database, so a caller
    may edit a database in place between updates.  Each update must
    report the same LinkStateChange and leave the same version in both."""

    def __init__(self, dbs=()) -> None:
        self.ls, self.jls = LinkState(), JLinkState()
        self.update(*dbs)

    def update(self, *dbs) -> None:
        for db in dbs:
            change = self.ls.update_adjacency_database(copy.deepcopy(db))
            jchange = self.jls.update_adjacency_database(to_jax_dbs([db])[0])
            assert dataclasses.astuple(change) == dataclasses.astuple(jchange), (
                db.this_node_name, change, jchange,
            )
            assert self.ls.version == self.jls.version, db.this_node_name


def spf_key(result) -> dict:
    """An SpfResult of either package as plain values: per node the
    metric, the ordered path links ((node, iface) pairs, from node) and
    the sorted next hops."""
    return {
        node: (
            r.metric,
            [(link.ordered_names, prev) for link, prev in r.path_links],
            sorted(r.next_hops),
        )
        for node, r in result.items()
    }


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


def normalized_update(update) -> tuple:
    """A DecisionRouteUpdate of either package as plain values: the
    updated unicast routes and MPLS routes as `normalized_routes` gives
    them, and the sorted deletions."""
    unicast, mpls = normalized_routes(
        SimpleNamespace(
            unicast_routes=update.unicast_routes_to_update,
            mpls_routes={e.label: e for e in update.mpls_routes_to_update},
        )
    )
    return (
        unicast,
        sorted(update.unicast_routes_to_delete),
        mpls,
        sorted(update.mpls_routes_to_delete),
    )


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


def adj(me: str, other: str, metric: int = 10, is_overloaded: bool = False):
    """A port Adjacency named like tests/test_spf_solver.py's `adj`."""
    return pt.Adjacency(
        other_node_name=other,
        if_name=f"{me}/{other}",
        other_if_name=f"{other}/{me}",
        metric=metric,
        is_overloaded=is_overloaded,
        next_hop_v6=f"fe80::{other}",
        next_hop_v4=f"10.0.0.{other}",
    )


def adj_dbs(adj_map: dict, labels=None, overloaded=frozenset()):
    """Port AdjacencyDatabases of {node: [Adjacency]} (tests/
    test_spf_solver.py's `build_link_state` inputs)."""
    return [
        pt.AdjacencyDatabase(
            this_node_name=node,
            adjacencies=adjs,
            is_overloaded=node in overloaded,
            node_label=(labels or {}).get(node, 0),
            area="0",
        )
        for node, adjs in adj_map.items()
    ]


def square_dbs():
    """tests/test_spf_solver.py's `square`: 1 - 2, 1 - 3, 2 - 4, 3 - 4,
    all metric 10, labels 101-104."""
    return adj_dbs(
        {
            "1": [adj("1", "2"), adj("1", "3")],
            "2": [adj("2", "1"), adj("2", "4")],
            "3": [adj("3", "1"), adj("3", "4")],
            "4": [adj("4", "2"), adj("4", "3")],
        },
        labels={"1": 101, "2": 102, "3": 103, "4": 104},
    )
