"""Operator-facing failure-protection analysis over a LinkState.

Port of `openr_tpu.decision.protection_api`: the batched runs of
`ops.protection` with name-level inputs and outputs, for the ctrl API
and the CLI.  Both are capabilities the reference's one-source-at-a-time
solver has no counterpart for.

- `what_if`: F failure scenarios (each a set of links, e.g. one SRLG) in
  one masked batch -> per-scenario reachability impact.
- `ti_lfa`: per out-adjacency post-convergence SPF of one node -> backup
  first hops per destination, the input to TI-LFA repair-path selection.

Both run on the mirror's forward runner (`CsrTopology.runner`, staged on
the engine's device): the bands where the topology has them, else the
ELL, at the runner's adaptive masked sweep count.  The JAX package runs
them through the masked ELL relax to the fixed point; the results are
the same arrays.  Results are plain JSON-able dicts (the ctrl wire
format).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..device.engine import DeviceResidencyEngine
from ..ops import protection as prot
from ..ops.sssp import INF32
from .csr import CsrTopology
from .link_state import LinkState

# element budget for one what-if call: F x S x N_cap int32 outputs
_WHAT_IF_MAX_ELEMENTS = 1 << 28  # 1 GiB of int32


def _pair_edge_ids(csr: CsrTopology):
    """A lookup (node, node) -> directed edge ids of every parallel link
    between the two (none for an unknown node or pair): one sort of the
    edges by their unordered endpoint pair, then a binary search per
    scenario link."""
    e = csr.n_edges
    src = csr.edge_src[:e].astype(np.int64)
    dst = csr.edge_dst[:e].astype(np.int64)
    cap = csr.node_capacity
    key = np.minimum(src, dst) * cap + np.maximum(src, dst)
    order = np.argsort(key, kind="stable")
    sorted_key = key[order]

    def ids(a: str, b: str) -> np.ndarray:
        ia, ib = csr.node_id.get(a), csr.node_id.get(b)
        if ia is None or ib is None:
            return order[:0]
        k = min(ia, ib) * cap + max(ia, ib)
        lo, hi = np.searchsorted(sorted_key, [k, k + 1])
        return order[lo:hi]

    return ids


def what_if(
    link_state: LinkState,
    scenarios: list[list[tuple[str, str]]],
    sources: Optional[list[str]] = None,
    csr: Optional[CsrTopology] = None,
    engine: Optional[DeviceResidencyEngine] = None,
    device=None,
) -> list[dict]:
    """Evaluate failure scenarios; each scenario is a list of (node, node)
    links that fail together (a shared-risk link group).

    Returns one dict per scenario: the links resolved, how many (source,
    destination) pairs became unreachable and how many degraded (still
    reachable at a higher metric).  `sources` bounds the impact view
    (Decision defaults it to the querying router); None means every
    node, refused beyond a size budget: the [F, S, N] output grows fast
    and this runs on the Decision event thread.  The batch runs on
    `csr`'s forward runner (a mirror of `link_state` when None) staged on
    `engine` (a new engine of `device` when None)."""
    if csr is None:
        csr = CsrTopology.from_link_state(link_state)
    if sources is None:
        source_names = csr.node_names
    else:
        source_names = [s for s in sources if s in csr.node_id]
    if not source_names or not scenarios:
        return []
    # budget both the [F*S, N_cap] distances and the [F*S, E_cap] masks
    total = (len(scenarios) + 1) * len(source_names) * (
        csr.node_capacity + csr.edge_capacity
    )
    if total > _WHAT_IF_MAX_ELEMENTS:
        raise ValueError(
            f"what-if request too large ({len(scenarios)} scenarios x "
            f"{len(source_names)} sources x {csr.node_capacity} nodes); "
            f"restrict `sources`"
        )
    src_ids = np.asarray([csr.node_id[s] for s in source_names], dtype=np.int32)

    # row 0 = the no-failure baseline, rows 1.. = scenarios: one batch
    pair_ids = _pair_edge_ids(csr)
    masks = np.ones((len(scenarios) + 1, csr.edge_capacity), dtype=bool)
    resolved: list[dict] = []
    for f, links in enumerate(scenarios):
        known: list[list[str]] = []
        unknown: list[list[str]] = []
        for a, b in links:
            ids = pair_ids(a, b)
            if len(ids):
                masks[f + 1, ids] = False
                known.append([a, b])
            else:
                unknown.append([a, b])
        resolved.append({"links": known, "unknown_links": unknown})

    runner = csr.runner(engine or DeviceResidencyEngine(device))
    all_dist = prot.srlg_what_if(
        src_ids,
        csr.edge_src,
        csr.edge_dst,
        csr.edge_metric,
        csr.edge_up,
        csr.node_overloaded,
        masks,
        runner=runner,
    )
    # impact counted over real nodes only
    real = np.arange(csr.n_nodes)
    unreachable, degraded = prot.srlg_reachability_loss(
        all_dist[0][:, real], all_dist[1:][:, :, real]
    )
    out = []
    for f in range(len(scenarios)):
        row = dict(resolved[f])
        row["scenario"] = f
        row["newly_unreachable_pairs"] = int(unreachable[f])
        row["degraded_pairs"] = int(degraded[f])
        out.append(row)
    return out


def ti_lfa(
    link_state: LinkState,
    node: str,
    csr: Optional[CsrTopology] = None,
    max_report_destinations: int = 1000,
    engine: Optional[DeviceResidencyEngine] = None,
    device=None,
) -> dict:
    """Per-out-adjacency backup analysis of `node`.

    For each up out-edge (node -> neighbour), the post-convergence SPF
    with that edge and its reverse failed, reported as backup first hops
    per destination: the loop-free alternates TI-LFA encodes as repair
    segments.  Destinations unreachable before the failure are left out
    (a topology problem, not a protection gap).  Counts cover every
    destination; the per-destination lists are cut at
    `max_report_destinations` per adjacency.  `csr`, `engine` and
    `device` are those of `what_if`."""
    if csr is None:
        csr = CsrTopology.from_link_state(link_state)
    if node not in csr.node_id:
        return {"node": node, "error": "unknown node"}
    src_id = csr.node_id[node]
    e = csr.n_edges
    out_edges = np.flatnonzero(
        (csr.edge_src[:e] == src_id) & csr.edge_up[:e]
    ).tolist()
    if not out_edges:
        return {"node": node, "adjacencies": []}

    rev_full = np.full(csr.edge_capacity, -1, dtype=np.int32)
    rev_full[:e] = prot.build_reverse_edge_ids(csr.edge_src[:e], csr.edge_dst[:e])

    # the last row (-1) fails nothing: the pre-failure baseline, from the
    # same batch
    runner = csr.runner(engine or DeviceResidencyEngine(device))
    dist, dag = prot.ti_lfa_backups(
        np.int32(src_id),
        np.asarray(out_edges + [-1], dtype=np.int32),
        csr.edge_src,
        csr.edge_dst,
        csr.edge_metric,
        csr.edge_up,
        csr.node_overloaded,
        rev_full,
        max_degree=len(out_edges) + 1,
        runner=runner,
    )
    # destinations reachable before the failure (id order == name order)
    before = np.flatnonzero(dist[-1, : csr.n_nodes] < INF32)
    before = before[before != src_id]
    names = csr.node_names
    cap = max_report_destinations

    adjacencies = []
    for d, e_failed in enumerate(out_edges):
        kept = dist[d, before] < INF32
        reachable, lost = before[kept], before[~kept]
        backups = _first_hops_from_dag(csr, src_id, dist[d], dag[d])
        adjacencies.append(
            {
                "neighbor": names[int(csr.edge_dst[e_failed])],
                "protected_destinations": len(reachable),
                "unprotected_count": len(lost),
                "unprotected_destinations": [names[v] for v in lost[:cap].tolist()],
                "backup_first_hops": {
                    names[v]: backups(v) for v in reachable[:cap].tolist()
                },
                "truncated": len(reachable) > cap or len(lost) > cap,
            }
        )
    return {"node": node, "adjacencies": adjacencies}


def _first_hops_from_dag(
    csr: CsrTopology, src_id: int, dist_row: np.ndarray, dag_row: np.ndarray
):
    """First-hop sets propagated along one row's SP-DAG on the host
    (reference: protection_api._first_hops_from_dag), returned as a
    function: node id -> sorted names of the source's neighbours that
    begin a shortest path to it.  The sets are bitmasks over the
    source's DAG neighbours (uint64 words), or-ed along the DAG edges one
    head distance at a time in ascending order: with metrics >= 1 an
    edge's tail is nearer than its head, so its set is final before the
    head's level reads it.  Only the nodes asked for are decoded."""
    e = csr.n_edges
    edges = np.flatnonzero(dag_row[:e])
    u, v = csr.edge_src[edges], csr.edge_dst[edges]
    from_src = u == src_id
    nbrs = np.unique(v[from_src])  # id order == name order
    words = max(1, -(-len(nbrs) // 64))
    own = np.zeros((len(edges), words), dtype=np.uint64)
    slot = np.searchsorted(nbrs, v[from_src])
    own[np.flatnonzero(from_src), slot // 64] = np.left_shift(
        np.uint64(1), (slot % 64).astype(np.uint64)
    )
    mask = np.zeros((csr.n_nodes, words), dtype=np.uint64)
    head_dist = dist_row[v]
    order = np.argsort(head_dist, kind="stable")
    for level in np.split(order, np.flatnonzero(np.diff(head_dist[order])) + 1):
        contrib = np.where(from_src[level, None], own[level], mask[u[level]])
        np.bitwise_or.at(mask, v[level], contrib)
    names = [csr.node_names[i] for i in nbrs.tolist()]

    def first_hops(node: int) -> list[str]:
        out = []
        for k, word in enumerate(mask[node].tolist()):
            while word:
                low = word & -word
                out.append(names[64 * k + low.bit_length() - 1])
                word ^= low
        return out

    return first_hops
