"""Padded directed-edge mirror of the link-state graph.

Port of `openr_tpu.decision.csr` (CsrTopology :102, _build_out_slots
:35).  Node names are interned to dense int32 ids in sorted-name order;
each link gives two directed edges sorted by (dst, src); capacities are
padded to powers of two, and padding edges are down and point at the
last padding node.  Every new LinkState version rebuilds the mirror; the
in-place refresh and rewire of the reference come in a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .link_state import LinkState


def _next_pow2(n: int, floor: int = 8) -> int:
    c = floor
    while c < n:
        c *= 2
    return c


def _build_out_slots(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    n_edges: int,
    live: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, int]:
    """out_slot[e] = rank of edge e's dst among src(e)'s sorted unique
    out-neighbors (parallel links share the slot); -1 for padding.
    Node ids are assigned in sorted-name order, so id rank == the
    reference's name-sorted neighbor ordering.

    `live` excludes edge slots inside [:n_edges]: they rank as padding."""
    e_cap = len(edge_src)
    out_slot = np.full(e_cap, -1, dtype=np.int32)
    if n_edges == 0:
        return out_slot, 0
    if live is None:
        ids = np.arange(n_edges, dtype=np.int64)
    else:
        ids = np.flatnonzero(live[:n_edges]).astype(np.int64)
        if ids.size == 0:
            return out_slot, 0
    src = edge_src[ids].astype(np.int64)
    dst = edge_dst[ids].astype(np.int64)
    order = np.lexsort((dst, src))
    s_o, d_o = src[order], dst[order]
    new_grp = np.r_[True, s_o[1:] != s_o[:-1]]
    new_nbr = new_grp | np.r_[False, d_o[1:] != d_o[:-1]]
    nbr_rank = np.cumsum(new_nbr) - 1  # global distinct-neighbor counter
    grp_id = np.cumsum(new_grp) - 1
    first_rank = nbr_rank[new_grp]  # [n_groups]
    slots = (nbr_rank - first_rank[grp_id]).astype(np.int32)
    out_slot[ids[order]] = slots
    return out_slot, int(slots.max()) + 1


# the numpy fields `from_arrays` reads, as the reference mirror names them
ARRAY_FIELDS = (
    "edge_src",
    "edge_dst",
    "edge_metric",
    "edge_up",
    "node_overloaded",
)


@dataclass
class CsrTopology:
    """Padded directed-edge arrays + host-side interning tables."""

    node_names: list[str]  # dense id -> name (sorted)
    node_id: dict[str, int]
    n_nodes: int  # real node count
    node_capacity: int
    edge_capacity: int
    edge_src: np.ndarray  # [E_cap] int32
    edge_dst: np.ndarray  # [E_cap] int32
    edge_metric: np.ndarray  # [E_cap] int32
    edge_up: np.ndarray  # [E_cap] bool
    node_overloaded: np.ndarray  # [N_cap] bool
    n_edges: int
    version: int  # LinkState.version this mirror was built from
    # out_slot[e]: rank of edge e's destination among its source node's
    # sorted unique out-neighbors (-1 padding) — the ECMP bit position
    out_slot: np.ndarray
    max_out_slots: int

    @classmethod
    def from_link_state(cls, ls: LinkState) -> "CsrTopology":
        names = ls.node_names
        node_id = {n: i for i, n in enumerate(names)}
        links = sorted(ls.all_links)
        n_links = len(links)
        ends = np.empty((n_links, 2), dtype=np.int64)
        metric = np.empty((n_links, 2), dtype=np.int64)
        up = np.empty(n_links, dtype=bool)
        for k, link in enumerate(links):
            ends[k] = (node_id[link.n1], node_id[link.n2])
            metric[k] = (link.metric1, link.metric2)
            up[k] = link.is_up()
        if n_links and int(metric.min()) < 1:
            raise ValueError(
                "edge metrics must be >= 1 (int32 distance math and the "
                "d == 0 source exception rely on positive metrics)"
            )
        # per link: n1 -> n2 then n2 -> n1; stable sort by (dst, src)
        src = ends.ravel()
        dst = ends[:, ::-1].ravel()
        order = np.lexsort((src, dst))
        overloaded = np.array(
            [ls.is_node_overloaded(name) for name in names], dtype=bool
        )
        return cls._build(
            names,
            src[order],
            dst[order],
            metric.ravel()[order],
            np.repeat(up, 2)[order],
            overloaded,
            ls.version,
        )

    @classmethod
    def from_arrays(
        cls, fields: dict, node_names: list[str], version: int = -1
    ) -> "CsrTopology":
        """The port's mirror of the graph in another mirror's numpy fields
        (ARRAY_FIELDS plus `n_edges`, as `openr_tpu`'s CsrTopology holds
        them), so both packages compute on the identical graph.  Retired
        edge slots (`edge_live` False) are dropped."""
        n = len(node_names)
        e = int(fields["n_edges"])
        live = fields.get("edge_live")
        ids = (
            np.arange(e) if live is None else np.flatnonzero(live[:e])
        )
        return cls._build(
            list(node_names),
            np.asarray(fields["edge_src"])[ids],
            np.asarray(fields["edge_dst"])[ids],
            np.asarray(fields["edge_metric"])[ids],
            np.asarray(fields["edge_up"])[ids],
            np.asarray(fields["node_overloaded"])[:n],
            version,
        )

    @classmethod
    def _build(
        cls, names, src, dst, metric, up, overloaded, version
    ) -> "CsrTopology":
        n = len(names)
        e = len(src)
        n_cap = _next_pow2(n + 1)
        e_cap = _next_pow2(e)
        pad_node = n_cap - 1
        edge_src = np.full(e_cap, pad_node, dtype=np.int32)
        edge_dst = np.full(e_cap, pad_node, dtype=np.int32)
        edge_metric = np.ones(e_cap, dtype=np.int32)
        edge_up = np.zeros(e_cap, dtype=bool)
        edge_src[:e] = src
        edge_dst[:e] = dst
        edge_metric[:e] = metric
        edge_up[:e] = up
        node_overloaded = np.zeros(n_cap, dtype=bool)
        node_overloaded[:n] = overloaded
        out_slot, max_out_slots = _build_out_slots(edge_src, edge_dst, e)
        return cls(
            node_names=list(names),
            node_id={name: i for i, name in enumerate(names)},
            n_nodes=n,
            node_capacity=n_cap,
            edge_capacity=e_cap,
            edge_src=edge_src,
            edge_dst=edge_dst,
            edge_metric=edge_metric,
            edge_up=edge_up,
            node_overloaded=node_overloaded,
            n_edges=e,
            version=version,
            out_slot=out_slot,
            max_out_slots=max_out_slots,
        )

    def slot_neighbors(self, node: str) -> list[str]:
        """Sorted unique out-neighbor names of `node` — the slot order of
        the ECMP bitmaps (ids are assigned in sorted-name order, so id
        rank == name rank)."""
        e = self.n_edges
        mine = self.edge_src[:e] == self.node_id[node]
        return [self.node_names[j] for j in np.unique(self.edge_dst[:e][mine])]
