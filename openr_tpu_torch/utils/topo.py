"""Topology generators emitting AdjacencyDatabases.

`ring_topology` and `grid_topology` are `openr_tpu.utils.topo`'s
generators.  `wan_topology` emits the links and metrics of
`benchmarks/synthetic.wan` (the 100k-node small-world WAN of BASELINE
config #3) for the same seed, with zero-padded node names so that the
name-sorted node ids equal the generator's indices.  `hub_topology` is a
circulant graph with one extra chord: its hub has more than 32 unique
out-neighbours (two ECMP bitmap words) while the graph stays banded.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from ..types import Adjacency, AdjacencyDatabase


def _adj(me: str, other: str, metric: int = 1) -> Adjacency:
    return Adjacency(
        other_node_name=other,
        if_name=f"if_{me}_{other}",
        other_if_name=f"if_{other}_{me}",
        metric=metric,
        next_hop_v6=f"fe80::{abs(hash((me, other))) % (1 << 32):x}",
    )


def _bidir(edges, a: str, b: str, metric_ab=1, metric_ba=None) -> None:
    edges.setdefault(a, []).append(_adj(a, b, metric_ab))
    edges.setdefault(b, []).append(
        _adj(b, a, metric_ba if metric_ba is not None else metric_ab)
    )


def _to_dbs(edges, area: str) -> list[AdjacencyDatabase]:
    return [
        AdjacencyDatabase(
            this_node_name=node,
            adjacencies=adjs,
            area=area,
            node_label=i + 1,
        )
        for i, (node, adjs) in enumerate(sorted(edges.items()))
    ]


def grid_topology(
    n_side: int, area: str = "0", metric_fn=None
) -> list[AdjacencyDatabase]:
    """n_side x n_side grid (reference: createGrid in
    RoutingBenchmarkUtils)."""
    edges: dict[str, list[Adjacency]] = {}

    def name(r: int, c: int) -> str:
        return f"node-{r}-{c}"

    for r in range(n_side):
        for c in range(n_side):
            edges.setdefault(name(r, c), [])
            if c + 1 < n_side:
                m = metric_fn(r, c, "h") if metric_fn else 1
                _bidir(edges, name(r, c), name(r, c + 1), m)
            if r + 1 < n_side:
                m = metric_fn(r, c, "v") if metric_fn else 1
                _bidir(edges, name(r, c), name(r + 1, c), m)
    return _to_dbs(edges, area)


def ring_topology(n_nodes: int, area: str = "0") -> list[AdjacencyDatabase]:
    edges: dict[str, list[Adjacency]] = {}
    names = [f"r{i}" for i in range(n_nodes)]
    for i in range(n_nodes):
        edges.setdefault(names[i], [])
        if n_nodes > 1 and (i + 1 < n_nodes or n_nodes > 2):
            _bidir(edges, names[i], names[(i + 1) % n_nodes])
    return _to_dbs(edges, area)


def node_names(n_nodes: int, stem: str) -> list[str]:
    """Zero-padded names whose sorted order is index order."""
    width = max(6, len(str(n_nodes - 1)))
    return [f"{stem}{i:0{width}d}" for i in range(n_nodes)]


def _indexed_dbs(
    names: list[str],
    links: np.ndarray,
    metrics: np.ndarray,
    labeled: Iterable[int],
    area: str,
) -> list[AdjacencyDatabase]:
    """AdjacencyDatabases for undirected `links` [L, 2] with per-direction
    `metrics` [L, 2] (column 0 for links[:, 0] -> links[:, 1]).  Next-hop
    addresses name the neighbour's index; `labeled` nodes get the valid
    MPLS node label 16 + index, every other node none."""
    adjs: list[list[Adjacency]] = [[] for _ in names]
    for (a, b), (m_ab, m_ba) in zip(links.tolist(), metrics.tolist()):
        na, nb = names[a], names[b]
        adjs[a].append(
            Adjacency(
                nb,
                f"if_{na}_{nb}",
                metric=m_ab,
                other_if_name=f"if_{nb}_{na}",
                next_hop_v6=f"fe80::{b:x}",
            )
        )
        adjs[b].append(
            Adjacency(
                na,
                f"if_{nb}_{na}",
                metric=m_ba,
                other_if_name=f"if_{na}_{nb}",
                next_hop_v6=f"fe80::{a:x}",
            )
        )
    labels = {int(i): 16 + int(i) for i in labeled}
    return [
        AdjacencyDatabase(
            this_node_name=name,
            adjacencies=adjs[i],
            area=area,
            node_label=labels.get(i, 0),
        )
        for i, name in enumerate(names)
    ]


def wan_links(n_nodes: int, chords: int, seed: int):
    """(links [L, 2], metrics [L, 2]) of `benchmarks/synthetic.wan`: a
    ring with +1 and +2 links, `chords` random long-haul links per node,
    asymmetric metrics 1..10, self-links and duplicate pairs dropped."""
    rng = np.random.RandomState(seed)
    ids = np.arange(n_nodes, dtype=np.int32)
    ring1 = np.stack([ids, (ids + 1) % n_nodes], axis=1)
    ring2 = np.stack([ids, (ids + 2) % n_nodes], axis=1)
    chord_list = []
    for _ in range(chords):
        perm = rng.permutation(n_nodes).astype(np.int32)
        chord_list.append(np.stack([ids, perm], axis=1))
    links = np.concatenate([ring1, ring2] + chord_list)
    links = links[links[:, 0] != links[:, 1]]
    key = np.sort(links, axis=1)
    _, keep = np.unique(
        key[:, 0].astype(np.int64) * n_nodes + key[:, 1], return_index=True
    )
    links = links[keep]
    metrics = rng.randint(1, 11, size=(len(links), 2)).astype(np.int32)
    return links, metrics


def wan_topology(
    n_nodes: int,
    chords: int = 2,
    seed: int = 0,
    labeled: Iterable[int] = (),
    area: str = "0",
) -> list[AdjacencyDatabase]:
    """The small-world WAN of `benchmarks/synthetic.wan` as
    AdjacencyDatabases named w000000, w000001, ..."""
    links, metrics = wan_links(n_nodes, chords, seed)
    return _indexed_dbs(
        node_names(n_nodes, "w"), links, metrics, labeled, area
    )


def hub_topology(
    n_nodes: int = 64,
    reach: int = 16,
    seed: int = 0,
    labeled: Iterable[int] = (),
    area: str = "0",
) -> list[AdjacencyDatabase]:
    """Circulant graph (node i linked to i+1 .. i+reach) plus the chord
    0 <-> n_nodes // 2, metrics 1..5 from `seed`.  With the defaults node
    0 has 33 unique neighbours, so its ECMP bitmap needs two words."""
    pairs = {
        tuple(sorted((i, (i + k) % n_nodes)))
        for i in range(n_nodes)
        for k in range(1, reach + 1)
    }
    pairs.add((0, n_nodes // 2))
    links = np.asarray(sorted(pairs), dtype=np.int32)
    rng = np.random.RandomState(seed)
    metrics = rng.randint(1, 6, size=(len(links), 2)).astype(np.int32)
    return _indexed_dbs(
        node_names(n_nodes, "h"), links, metrics, labeled, area
    )
