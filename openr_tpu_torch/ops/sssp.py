"""Distance-domain constants and the bucketed-ELL relax.

The constants are the values of `openr_tpu.ops.sssp` (INF32, INF16,
WBIG16) and `openr_tpu.ops.banded` (WBIG) as plain ints.  The port
computes in int32: distances stay below INF32 = 2^30 and clamped weights
at or below WBIG = 2^28, so every relax sum is below 2^31 and never
wraps.  INF16 and WBIG16 belong to the reference's uint16 distance mode,
which the port does not run yet; they are kept so the tests can map that
mode onto the int32 domain.

The ELL relax is the port of `openr_tpu.ops.sssp`'s fallback for
topologies without bands (`build_ell`, `batched_sssp_ell`,
`spf_forward_ell_sweeps`): nodes relabelled by descending in-degree,
grouped into buckets of equal power-of-two K, each row holding its
in-edges as (neighbour, edge id) slots.  A sweep is Jacobi: every slot
gathers from the sweep's input, so sweep counts (and the learned sweep
hint) equal the reference's.  Only the fixed-sweep form is ported:
`n_sweeps` sweeps plus one verification sweep, returning the converged
verdict.  The DAG and per-row masked variants (KSP, what-if) come in a
later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

INF32 = 1 << 30
WBIG = 1 << 28
INF16 = 40000
WBIG16 = 20000

# elements of one gathered [R, slots, S] chunk of a bucket: a sweep
# gathers as many slots at once as fit, so a wide bucket (a fat-tree
# spine's K = 128) costs a few launches instead of one per slot
CHUNK_ELEMS = 1 << 24


class EllBucket(NamedTuple):
    """Contiguous run of (relabelled) nodes sharing padded in-degree K."""

    nbr: np.ndarray  # [R, K] int32 — in-neighbour NEW ids (pad 0)
    w: np.ndarray  # [R, K] int32 — edge metric at build time (pad 1)
    edge_id: np.ndarray  # [R, K] int32 — directed edge id; -1 pad
    ok: np.ndarray  # [R, K] bool — real, up edge at build time
    transit_ok: np.ndarray  # [R, K] bool — in-neighbour not overloaded


class EllGraph(NamedTuple):
    buckets: tuple  # tuple[EllBucket, ...] — rows cover [0, N_cap) in order
    new_of_old: np.ndarray  # [N_cap] int32 — old node id -> relabelled id
    old_of_new: np.ndarray  # [N_cap] int32 — relabelled id -> old node id

    def to(self, device: torch.device) -> "EllGraph":
        """The same tables as tensors on `device`."""

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return EllGraph(
            tuple(EllBucket(*(put(a) for a in bk)) for bk in self.buckets),
            put(self.new_of_old),
            put(self.old_of_new),
        )


def build_ell(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_metric: np.ndarray,
    edge_up: np.ndarray,
    node_overloaded: np.ndarray,
    n_edges: int,
    k_floor: int = 4,
) -> EllGraph:
    """Host-side ELL construction from the padded directed-edge arrays,
    edges sorted by (dst, src) (reference: ops/sssp.py build_ell).

    A stable sort by descending in-degree relabels the nodes, so rows of
    equal K are contiguous; K is a power of two >= max(deg, k_floor); an
    edge's slot is its position in its destination's in-edge run.  The
    baked w/ok/transit_ok tables snapshot the runtime arrays; the relax
    re-derives all three from the runtime arrays through `edge_id`."""
    n_cap = len(node_overloaded)
    src = np.asarray(edge_src[:n_edges], dtype=np.int64)
    dst = np.asarray(edge_dst[:n_edges], dtype=np.int64)
    deg = np.bincount(dst, minlength=n_cap)

    old_of_new = np.argsort(-deg, kind="stable").astype(np.int32)
    new_of_old = np.empty_like(old_of_new)
    new_of_old[old_of_new] = np.arange(n_cap, dtype=np.int32)

    deg_sorted = deg[old_of_new]
    exp = np.ceil(np.log2(np.maximum(deg_sorted, 1))).astype(np.int64)
    k_node = np.maximum(np.int64(1) << exp, k_floor)

    starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
    slot = np.arange(n_edges, dtype=np.int64) - starts[dst]

    new_dst = new_of_old[dst].astype(np.int64)
    buckets: list[EllBucket] = []
    lo = 0
    while lo < n_cap:
        k = int(k_node[lo])
        hi = int(np.searchsorted(-k_node, -k, side="right"))
        r = hi - lo
        nbr = np.zeros((r, k), dtype=np.int32)
        w = np.ones((r, k), dtype=np.int32)
        eid = np.full((r, k), -1, dtype=np.int32)
        ok = np.zeros((r, k), dtype=bool)
        t_ok = np.zeros((r, k), dtype=bool)
        in_bucket = (new_dst >= lo) & (new_dst < hi)
        rows = new_dst[in_bucket] - lo
        cols = slot[in_bucket]
        es = np.flatnonzero(in_bucket)
        nbr[rows, cols] = new_of_old[src[es]]
        w[rows, cols] = edge_metric[es]
        eid[rows, cols] = es
        ok[rows, cols] = edge_up[es]
        t_ok[rows, cols] = ~node_overloaded[src[es]]
        buckets.append(EllBucket(nbr, w, eid, ok, t_ok))
        lo = hi
    return EllGraph(tuple(buckets), new_of_old, old_of_new)


def make_dist0_T(
    sources: torch.Tensor, new_of_old: torch.Tensor, n_cap: int
) -> torch.Tensor:
    """[N_cap, S] int32 dist0 in relabelled rows: 0 at each column's
    source, INF32 elsewhere (a dense compare, as in the reference)."""
    rows = new_of_old.index_select(0, sources)
    ids = torch.arange(n_cap, dtype=rows.dtype, device=rows.device)
    d0 = torch.full(
        (n_cap, rows.shape[0]), INF32, dtype=torch.int32, device=rows.device
    )
    return d0.masked_fill_(ids[:, None] == rows[None, :], 0)


def _slot_chunks(ell: EllGraph, edge_up, node_overloaded, edge_metric, s: int):
    """Loop-invariant relax tables per bucket: (row offset, rows, chunks
    of (flat gather index, ok, transit, weight) over the bucket's slots).
    Permission and weight come from the runtime arrays through edge_id;
    weights are clamped to WBIG so no int32 sum wraps."""
    ov_new = node_overloaded.index_select(0, ell.old_of_new)
    tables = []
    lo = 0
    for bk in ell.buckets:
        r, k = bk.nbr.shape
        e0 = bk.edge_id.clamp(min=0).reshape(-1)
        ok = (bk.edge_id >= 0) & edge_up.index_select(0, e0).reshape(r, k)
        transit = ~ov_new.index_select(0, bk.nbr.reshape(-1)).reshape(r, k)
        w = edge_metric.index_select(0, e0).reshape(r, k).clamp(max=WBIG)
        step = max(1, CHUNK_ELEMS // max(1, r * s))
        chunks = [
            (
                bk.nbr[:, j : j + step].reshape(-1),
                ok[:, j : j + step, None],
                transit[:, j : j + step, None],
                w[:, j : j + step, None],
            )
            for j in range(0, k, step)
        ]
        tables.append((lo, r, chunks))
        lo += r
    return tables


def batched_sssp_ell(
    dist0_T: torch.Tensor,
    ell: EllGraph,
    edge_up: torch.Tensor,
    node_overloaded: torch.Tensor,
    edge_metric: torch.Tensor,
    n_sweeps: int,
):
    """Fixed-sweep ELL relax (reference: ops/sssp.py batched_sssp_ell with
    `n_sweeps`): `n_sweeps` Jacobi sweeps from `dist0_T` [N_cap, S] int32
    (relabelled rows), then one verification sweep.  Returns (dist_T,
    converged host bool): converged means the verification sweep
    changed nothing.  `ell` holds tensors on the device of
    `dist0_T`; the runtime arrays are indexed by old node id / edge id.

    A slot relaxes iff its edge is up and its in-neighbour offers
    transit (not overloaded) or is the column's source (d_u == 0)."""
    n_cap, s = dist0_T.shape
    tables = _slot_chunks(ell, edge_up, node_overloaded, edge_metric, s)

    def relax(d):
        out = torch.empty_like(d)
        for lo, r, chunks in tables:
            acc = d[lo : lo + r]
            for idx, ok, transit, w in chunks:
                du = d.index_select(0, idx).view(r, -1, s)
                allow = ok & (transit | (du == 0)) & (du < INF32)
                cand = torch.where(allow, du + w, INF32)
                acc = torch.minimum(acc, cand.amin(dim=1))
            out[lo : lo + r] = acc
        return out

    d = dist0_T
    for _ in range(n_sweeps):
        d = relax(d)
    verify = relax(d)
    return verify, torch.equal(verify, d)


def ell_dist_to_old_T(dist_T: torch.Tensor, ell: EllGraph) -> torch.Tensor:
    """Relabelled [N_cap, S] -> original-id [N_cap, S]."""
    return dist_T.index_select(0, ell.new_of_old)


def spf_forward_ell_sweeps(
    sources: torch.Tensor,
    ell: EllGraph,
    edge_metric: torch.Tensor,
    edge_up: torch.Tensor,
    node_overloaded: torch.Tensor,
    n_sweeps: int,
):
    """Fixed-sweep ELL forward in the kernel's native layout (reference:
    ops/sssp.py spf_forward_ell_sweeps with want_dag=False,
    transpose=False): (dist [N_cap, S] int32 in original node ids,
    converged host bool)."""
    n_cap = int(node_overloaded.shape[0])
    dist_T, converged = batched_sssp_ell(
        make_dist0_T(sources, ell.new_of_old, n_cap),
        ell,
        edge_up,
        node_overloaded,
        edge_metric,
        n_sweeps,
    )
    return ell_dist_to_old_T(dist_T, ell), converged
