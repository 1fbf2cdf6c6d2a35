"""Distance-domain constants and the bucketed-ELL relax.

The constants are the values of `openr_tpu.ops.sssp` (INF32, INF16,
WBIG16) and `openr_tpu.ops.banded` (WBIG) as plain ints.  The port
computes in int32: distances stay below INF32 = 2^30 and clamped weights
at or below WBIG = 2^28, so every relax sum is below 2^31 and never
wraps.

The uint16 distance mode (the reference's `small_dist`) keeps the same
int32 arithmetic over the 16-bit domain: INF16 marks unreachable and
weights are clamped to WBIG16, so a finite distance below INF16 plus a
clamped weight stays below 2^16, exactly the reference's uint16 sums.
torch has no uint16 arithmetic, so a product is narrowed to
`torch.uint16` once, at its fixed point (`to_u16`), and widened where
plain code reads it (`u16_to_i32`); both go through an int16 view.
`u16_saturation_verdict` is the guard that certifies no true distance
overflowed the mode.

The ELL relax is the port of `openr_tpu.ops.sssp`'s fallback for
topologies without bands (`build_ell`, `batched_sssp_ell`,
`spf_forward_ell_sweeps`): nodes relabelled by descending in-degree,
grouped into buckets of equal power-of-two K, each row holding its
in-edges as (neighbour, edge id) slots.  A sweep is Jacobi: every slot
gathers from the sweep's input, so sweep counts (and the learned sweep
hint) equal the reference's.

The per-source forward path (`spf_forward_full`, the engine's query)
adds the edge-space SP-DAG (`make_relax_allowed_T`,
`sp_dag_mask_from_T`) and the bit-packed first hops (`first_hops_ell`):
first-hop sets propagated along the DAG through the same ELL tables,
bit b of word w set for (source, node) iff out-slot 32w + b of the
source begins a shortest path to the node.  torch has no uint32
arithmetic on CUDA, so the words hold the reference's uint32 bit
patterns in int32 (slot 31 is the sign bit; decode with
`int(w) & 0xFFFFFFFF`).  The fixed-sweep forms run `n_sweeps` sweeps
plus one verification sweep and return the converged verdict.

Per-row edge exclusions (KSP re-runs, SRLG what-if, TI-LFA) enter the
relax as an [E, S] permission (`make_relax_allowed_T` with `extra_T`),
gathered into slot space once per call (`row_allowed_T` of
`batched_sssp_ell`): `spf_forward_ell_masked` runs it to the fixed
point, `spf_forward_ell_sweeps` at a fixed sweep count.  The dense
edge-list relax (`batched_sssp`, `make_dist0`, `make_relax_allowed`,
`sp_dag_mask`) is the small-graph path of ops.protection: one
scatter-min per sweep.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device.sanitizer import fetch, fetch_point, stage

INF32 = 1 << 30
WBIG = 1 << 28
INF16 = 40000
WBIG16 = 20000


def domain(small_dist: bool) -> tuple[int, int]:
    """(inf, wbig) of the int32 domain or of the uint16 mode."""
    return (INF16, WBIG16) if small_dist else (INF32, WBIG)


def to_u16(x: torch.Tensor) -> torch.Tensor:
    """int32 values in [0, 2^16) as a torch.uint16 tensor of the same
    shape (through int16, whose casts every device has)."""
    return torch.where(x >= 1 << 15, x - (1 << 16), x).to(torch.int16).view(
        torch.uint16
    )


def u16_to_i32(x: torch.Tensor) -> torch.Tensor:
    """A torch.uint16 tensor widened to int32, values unchanged."""
    return x.view(torch.int16).to(torch.int32) & 0xFFFF


def u16_index_select(x: torch.Tensor, dim: int, index: torch.Tensor) -> torch.Tensor:
    """index_select of a torch.uint16 tensor (through its int16 view)."""
    return x.view(torch.int16).index_select(dim, index).view(torch.uint16)


def clamp_metric_u16(metric: torch.Tensor) -> torch.Tensor:
    """Weights of the uint16 mode, still int32: clamped to WBIG16 before
    any narrowing, so an oversized metric saturates to the band infinity
    and never wraps (reference: ops/sssp.py clamp_metric_u16)."""
    return metric.clamp(max=WBIG16)


def u16_saturation_verdict(dist: torch.Tensor, converged):
    """AND a convergence verdict with the saturation guard (reference:
    ops/sssp.py u16_saturation_verdict) over a product of the 16-bit
    domain (uint16, or int32 with the INF16 sentinel): with every weight
    below WBIG16, a true distance that would overflow INF16 forces some
    entry into the finite band [WBIG16, INF16) first, so a clean margin
    certifies that no distance saturated.  `converged` is a host bool or
    a 0-dim bool tensor; the result is of the same kind."""
    if dist.dtype == torch.uint16:
        dist = u16_to_i32(dist)
    saturated = ((dist >= WBIG16) & (dist < INF16)).any()
    if isinstance(converged, torch.Tensor):
        return converged & ~saturated
    with fetch_point("saturation verdict"):
        return bool(converged) and not bool(saturated)


def u16_dist_to_i32(dist: torch.Tensor) -> torch.Tensor:
    """The uint16 / INF16 domain mapped onto the int32 / INF32 contract
    (reference: ops/sssp.py u16_dist_to_i32)."""
    d = u16_to_i32(dist)
    return torch.where(d >= INF16, INF32, d)

# elements of one gathered [R, slots, S] chunk of a bucket: a sweep
# gathers as many slots at once as fit, so a wide bucket (a fat-tree
# spine's K = 128) costs a few launches instead of one per slot
CHUNK_ELEMS = 1 << 24

# int32 bit patterns of 1 << b, b in [0, 32): slot 31's word is negative
WORD_BITS = np.array([1 << b for b in range(32)], dtype=np.uint32).view(np.int32)


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
        """A copy of the tables as tensors on `device` (a copy on the CPU
        too, so it never aliases the host arrays)."""

        def put(a):
            return stage(a, device)

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
    sources: torch.Tensor,
    new_of_old: torch.Tensor,
    n_cap: int,
    small_dist: bool = False,
) -> torch.Tensor:
    """[N_cap, S] int32 dist0 in relabelled rows: 0 at each column's
    source, INF32 (INF16 with `small_dist`) elsewhere (a dense compare,
    as in the reference)."""
    rows = new_of_old.index_select(0, sources)
    ids = torch.arange(n_cap, dtype=rows.dtype, device=rows.device)
    d0 = torch.full(
        (n_cap, rows.shape[0]),
        domain(small_dist)[0],
        dtype=torch.int32,
        device=rows.device,
    )
    return d0.masked_fill_(ids[:, None] == rows[None, :], 0)


def _slot_chunks(
    ell: EllGraph, edge_up, node_overloaded, edge_metric, s: int,
    unit_metric: bool = False, small_dist: bool = False, row_allowed_T=None,
):
    """Loop-invariant relax tables per bucket: (row offset, rows, chunks
    of (flat gather index, ok, transit, weight) over the bucket's slots).
    Permission and weight come from the runtime arrays through edge_id
    (every weight 1 with `unit_metric`); weights are clamped to WBIG
    (WBIG16 with `small_dist`) so no sum leaves its domain.  With
    `row_allowed_T` [E_cap, S] the per-row exclusions are gathered into
    slot space here, once per call: a chunk's `ok` is then
    [R, slots, S] instead of [R, slots, 1]."""
    ov_new = node_overloaded.index_select(0, ell.old_of_new)
    tables = []
    lo = 0
    for bk in ell.buckets:
        r, k = bk.nbr.shape
        e0 = bk.edge_id.clamp(min=0).reshape(-1)
        ok = (bk.edge_id >= 0) & edge_up.index_select(0, e0).reshape(r, k)
        transit = ~ov_new.index_select(0, bk.nbr.reshape(-1)).reshape(r, k)
        if unit_metric:
            w = torch.ones((r, k), dtype=torch.int32, device=e0.device)
        else:
            w = edge_metric.index_select(0, e0).reshape(r, k)
            w = w.clamp(max=domain(small_dist)[1])
        step = max(1, CHUNK_ELEMS // max(1, r * s))
        chunks = []
        for j in range(0, k, step):
            ok_j = ok[:, j : j + step, None]
            if row_allowed_T is not None:
                ids = e0.view(r, k)[:, j : j + step]
                ok_j = ok_j & row_allowed_T.index_select(0, ids.reshape(-1)).view(
                    r, ids.shape[1], s
                )
            chunks.append(
                (
                    bk.nbr[:, j : j + step].reshape(-1),
                    ok_j,
                    transit[:, j : j + step, None],
                    w[:, j : j + step, None],
                )
            )
        tables.append((lo, r, chunks))
        lo += r
    return tables


def _ell_rows(ell: EllGraph, a: int, b: int) -> EllGraph:
    """The ELL restricted to relabelled rows [a, b): each bucket's slice
    of those rows, in order (node ids keep their meaning)."""
    buckets = []
    lo = 0
    for bk in ell.buckets:
        r = bk.nbr.shape[0]
        i, j = max(a, lo) - lo, min(b, lo + r) - lo
        if i < j:
            buckets.append(EllBucket(*(x[i:j] for x in bk)))
        lo += r
    return EllGraph(tuple(buckets), ell.new_of_old, ell.old_of_new)


def _ell_relax(ell: EllGraph, edge_up, node_overloaded, edge_metric, s: int,
               unit_metric: bool = False, small_dist: bool = False,
               row_allowed_T=None, rows=None):
    """One Jacobi sweep over [N_cap, S] relabelled distances, as a
    function of the sweep's input.  With `rows` (a, b) the sweep yields
    only relabelled rows [a, b) of the result, [b - a, S], still from
    the whole input: one node shard's part of a sweep on a device mesh
    (parallel.mesh)."""
    a = 0
    if rows is not None:
        a, b = rows
        ell = _ell_rows(ell, a, b)
    tables = _slot_chunks(
        ell, edge_up, node_overloaded, edge_metric, s, unit_metric, small_dist,
        row_allowed_T,
    )
    inf = domain(small_dist)[0]

    def relax(d):
        if rows is None:
            out = torch.empty_like(d)
        else:
            out = d.new_empty((b - a, d.shape[1]))
        for lo, r, chunks in tables:
            acc = d[a + lo : a + lo + r]
            for idx, ok, transit, w in chunks:
                du = d.index_select(0, idx).view(r, -1, s)
                allow = ok & (transit | (du == 0)) & (du < inf)
                cand = torch.where(allow, du + w, inf)
                acc = torch.minimum(acc, cand.amin(dim=1))
            out[lo : lo + r] = acc
        return out

    return relax


def _fixed_sweeps(relax, x0: torch.Tensor, n_sweeps: int):
    """`n_sweeps` sweeps from `x0` and one verification sweep:
    (verified result, converged as a 0-dim bool tensor on the device)."""
    x = x0
    for _ in range(n_sweeps):
        x = relax(x)
    verify = relax(x)
    return verify, (verify == x).all()


def batched_sssp_ell(
    dist0_T: torch.Tensor,
    ell: EllGraph,
    edge_up: torch.Tensor,
    node_overloaded: torch.Tensor,
    edge_metric: torch.Tensor,
    n_sweeps: Optional[int] = None,
    unit_metric: bool = False,
    small_dist: bool = False,
    row_allowed_T: Optional[torch.Tensor] = None,
):
    """ELL relax (reference: ops/sssp.py batched_sssp_ell) from `dist0_T`
    [N_cap, S] int32 (relabelled rows), in the 16-bit domain with
    `small_dist` (INF16, weights clamped to WBIG16; the reference keys
    that on dist0's uint16 dtype).  With `n_sweeps`: that many
    Jacobi sweeps, then one verification sweep; returns (dist_T,
    converged host bool), converged meaning the verification sweep
    changed nothing.  Without: sweeps to the fixed point (at most N_cap)
    and returns dist_T.  `ell` holds tensors on the device of `dist0_T`;
    the runtime arrays are indexed by old node id / edge id.

    A slot relaxes iff its edge is up and its in-neighbour offers
    transit (not overloaded) or is the column's source (d_u == 0), and,
    with `row_allowed_T` [E_cap, S], the column may use its edge.
    `unit_metric` counts hops (every weight 1)."""
    n_cap, s = dist0_T.shape
    relax = _ell_relax(
        ell, edge_up, node_overloaded, edge_metric, s, unit_metric, small_dist,
        row_allowed_T,
    )
    if n_sweeps is not None:
        verify, ok = _fixed_sweeps(relax, dist0_T, n_sweeps)
        return verify, bool(fetch(ok, "fixed-sweep verdict"))
    d = dist0_T
    for _ in range(n_cap):
        new = relax(d)
        with fetch_point("relax fixed point"):
            done = torch.equal(new, d)
        if done:
            break
        d = new
    return d


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
    small_dist: bool = False,
    raw_u16: bool = False,
    *,
    edge_src: Optional[torch.Tensor] = None,
    edge_dst: Optional[torch.Tensor] = None,
    extra_edge_mask: Optional[torch.Tensor] = None,
    use_link_metric: bool = True,
    want_dag: bool = False,
):
    """Fixed-sweep ELL forward (reference: ops/sssp.py
    spf_forward_ell_sweeps): (dist [N_cap, S] in original node ids, dag
    [S, E_cap] bool or None, converged host bool).  dist keeps the
    kernel's native layout (the reference's transpose=False) whatever
    `want_dag`.

    dist is int32 / INF32; with `small_dist` the relax runs in the 16-bit
    domain, the verdict includes the saturation guard, and `raw_u16`
    (without `want_dag`) returns the product as torch.uint16 with the
    INF16 sentinel (consumers key on dtype).  `extra_edge_mask` [S, E_cap]
    or [E_cap] bool (False excludes) adds per-row exclusions, which need
    `edge_src`; `use_link_metric` False counts hops.  `want_dag` (which
    needs `edge_src` and `edge_dst`) takes the SP-DAG in the run's own
    domain, through `sp_dag_mask16_from_T` in the uint16 mode."""
    n_cap = int(node_overloaded.shape[0])
    extra_T = None
    if extra_edge_mask is not None:
        extra_T = extra_edge_mask.T if extra_edge_mask.dim() == 2 else extra_edge_mask
    allowed_T = None
    if extra_T is not None or want_dag:
        allowed_T = make_relax_allowed_T(
            sources, edge_src, edge_up, node_overloaded, extra_T
        )
    dist_T, converged = batched_sssp_ell(
        make_dist0_T(sources, ell.new_of_old, n_cap, small_dist),
        ell,
        edge_up,
        node_overloaded,
        edge_metric,
        n_sweeps,
        unit_metric=not use_link_metric,
        small_dist=small_dist,
        row_allowed_T=allowed_T if extra_T is not None else None,
    )
    return forward_tail(
        ell_dist_to_old_T(dist_T, ell),
        converged,
        small_dist,
        raw_u16,
        want_dag,
        edge_src,
        edge_dst,
        edge_metric if use_link_metric else torch.ones_like(edge_metric),
        allowed_T,
    )


def forward_tail(
    dist, converged, small_dist: bool, raw_u16: bool, want_dag: bool,
    edge_src, edge_dst, metric, allowed_T,
):
    """The common end of the fixed-sweep forwards (ELL here, banded in
    ops.banded): the uint16 verdict and domain mapping, then the SP-DAG.
    `dist` is [N*, S] in original ids and in the run's domain; returns
    (dist, dag or None, converged)."""
    dist16 = None
    if small_dist:
        converged = u16_saturation_verdict(dist, converged)
        dist16 = dist
        if raw_u16 and not want_dag:
            return to_u16(dist), None, converged
        dist = torch.where(dist >= INF16, INF32, dist)
    if not want_dag:
        return dist, None, converged
    if dist16 is not None:
        dag = sp_dag_mask16_from_T(dist16, edge_src, edge_dst, metric, allowed_T)
    else:
        dag = sp_dag_mask_from_T(dist, edge_src, edge_dst, metric, allowed_T)
    return dist, dag, converged


def make_relax_allowed_T(
    sources: torch.Tensor,
    edge_src: torch.Tensor,
    edge_up: torch.Tensor,
    node_overloaded: torch.Tensor,
    extra_edge_mask_T: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[E, S] relax permission (reference: ops/sssp.py
    make_relax_allowed_T): edge up, its source not overloaded unless it
    is the column's own source, and not excluded by `extra_edge_mask_T`
    ([E, S] or [E] bool, False excludes)."""
    transit_ok = ~node_overloaded.index_select(0, edge_src)
    allowed = edge_up[:, None] & (
        transit_ok[:, None] | (edge_src[:, None] == sources[None, :])
    )
    if extra_edge_mask_T is not None:
        if extra_edge_mask_T.dim() == 1:
            extra_edge_mask_T = extra_edge_mask_T[:, None]
        allowed = allowed & extra_edge_mask_T
    return allowed


def _endpoint_rows(dist: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """dist rows of edge endpoints.  A banded product has only N rows,
    while padding edges point at the padding node N_cap - 1: those
    edges (down, so never allowed) read row N - 1 instead."""
    return dist.index_select(0, ids.clamp(max=dist.shape[0] - 1))


def sp_dag_mask_from_T(
    dist_old_T: torch.Tensor,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    edge_metric: torch.Tensor,
    allowed_T: torch.Tensor,
) -> torch.Tensor:
    """[S, E] shortest-path DAG (reference: ops/sssp.py
    sp_dag_mask_from_T): edge e = (u, v) is on some shortest path from a
    column's source iff it may relax there and d[u] + w(e) == d[v], with
    `dist_old_T` [N*, S] in original ids.  Every equal-cost in-edge is
    kept, as the host Dijkstra's path_links keep them."""
    d_u = _endpoint_rows(dist_old_T, edge_src)
    d_v = _endpoint_rows(dist_old_T, edge_dst)
    dag_T = allowed_T & (d_u < INF32) & (d_u + edge_metric[:, None] == d_v)
    return dag_T.T


def sp_dag_mask16_from_T(
    dist16_old_T: torch.Tensor,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    edge_metric: torch.Tensor,
    allowed_T: torch.Tensor,
) -> torch.Tensor:
    """`sp_dag_mask_from_T` in the 16-bit domain (reference: ops/sssp.py
    sp_dag_mask16_from_T): `dist16_old_T` [N*, S] is a uint16-mode
    product (torch.uint16, or int32 with the INF16 sentinel), metrics
    are clamped to WBIG16 and saturated entries are excluded by the
    d_u < INF16 guard.  A finite d plus a clamped metric stays below
    2^16, so these int32 sums equal the reference's uint16 ones."""
    if dist16_old_T.dtype == torch.uint16:
        dist16_old_T = u16_to_i32(dist16_old_T)
    m16 = clamp_metric_u16(edge_metric)
    d_u = _endpoint_rows(dist16_old_T, edge_src)
    d_v = _endpoint_rows(dist16_old_T, edge_dst)
    return (allowed_T & (d_u < INF16) & (d_u + m16[:, None] == d_v)).T


def spf_forward_ell(
    sources: torch.Tensor,
    ell: EllGraph,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    edge_metric: torch.Tensor,
    edge_up: torch.Tensor,
    node_overloaded: torch.Tensor,
    use_link_metric: bool = True,
):
    """Distances and SP-DAG at the fixed point (reference: ops/sssp.py
    spf_forward_ell): (dist [S, N_cap] int32 in original ids, dag
    [S, E_cap] bool)."""
    n_cap = int(node_overloaded.shape[0])
    dist_T = batched_sssp_ell(
        make_dist0_T(sources, ell.new_of_old, n_cap),
        ell,
        edge_up,
        node_overloaded,
        edge_metric,
        unit_metric=not use_link_metric,
    )
    dist_old_T = ell_dist_to_old_T(dist_T, ell)
    metric = edge_metric if use_link_metric else torch.ones_like(edge_metric)
    allowed_T = make_relax_allowed_T(sources, edge_src, edge_up, node_overloaded)
    dag = sp_dag_mask_from_T(dist_old_T, edge_src, edge_dst, metric, allowed_T)
    return dist_old_T.T, dag


def spf_forward_ell_masked(
    sources: torch.Tensor,
    ell: EllGraph,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    edge_metric: torch.Tensor,
    edge_up: torch.Tensor,
    node_overloaded: torch.Tensor,
    extra_edge_mask: torch.Tensor,
    use_link_metric: bool = True,
    want_dag: bool = True,
):
    """ELL forward with per-row edge exclusions, to the fixed point
    (reference: ops/sssp.py spf_forward_ell_masked): `extra_edge_mask`
    [S, E_cap] or [E_cap] bool, False excludes.  Returns (dist [S, N_cap]
    int32 in original ids, dag [S, E_cap] bool, or None without
    `want_dag`)."""
    n_cap = int(node_overloaded.shape[0])
    extra_T = extra_edge_mask.T if extra_edge_mask.dim() == 2 else extra_edge_mask
    allowed_T = make_relax_allowed_T(
        sources, edge_src, edge_up, node_overloaded, extra_T
    )
    dist_T = batched_sssp_ell(
        make_dist0_T(sources, ell.new_of_old, n_cap),
        ell,
        edge_up,
        node_overloaded,
        edge_metric,
        unit_metric=not use_link_metric,
        row_allowed_T=allowed_T,
    )
    dist_old_T = ell_dist_to_old_T(dist_T, ell)
    if not want_dag:
        return dist_old_T.T, None
    metric = edge_metric if use_link_metric else torch.ones_like(edge_metric)
    dag = sp_dag_mask_from_T(dist_old_T, edge_src, edge_dst, metric, allowed_T)
    return dist_old_T.T, dag


def _or_reduce(x: torch.Tensor) -> torch.Tensor:
    """Bitwise OR over dim 1, halving the dim per step."""
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        y = x[:, :h] | x[:, h : 2 * h]
        if x.shape[1] % 2:
            y[:, :1] |= x[:, 2 * h :]
        x = y
    return x[:, 0]


def first_hops_ell(
    ell: EllGraph,
    dag_T: torch.Tensor,
    out_slot: torch.Tensor,
    sources: torch.Tensor,
    edge_src: torch.Tensor,
    n_words: int,
    n_sweeps: int,
):
    """First-hop sets propagated along the SP-DAG, bit-packed (reference:
    ops/sssp.py first_hops_ell with `n_sweeps`): `n_sweeps` Jacobi sweeps
    through the ELL in-edge tables and one verification sweep.  Returns
    (nh [S, N_cap, n_words] int32 in original ids, converged 0-dim bool
    tensor).  Bit b of word w is set for (s, v) iff out-slot 32w + b of
    column s's source begins some shortest path to v.

    `dag_T` [E_cap, S] is the edge-major DAG; `out_slot` [E_cap] the
    rank of each edge's destination among its source's unique
    out-neighbours (-1 padding).  A DAG edge leaving the column's own
    source contributes its out-slot bit, every other DAG edge its
    predecessor's bits; both terms are loop invariants, built once."""
    n_cap = int(ell.new_of_old.shape[0])
    s = int(sources.shape[0])
    device = dag_T.device
    bits = stage(WORD_BITS, device)
    words = torch.arange(n_words, device=device)
    is_src_edge = edge_src[:, None] == sources[None, :]  # [E, S]
    tables = []
    lo = 0
    for bk in ell.buckets:
        r, k = bk.nbr.shape
        e0 = bk.edge_id.clamp(min=0).reshape(-1)
        on_dag = dag_T.index_select(0, e0).view(r, k, s) & (
            bk.edge_id >= 0
        )[:, :, None]
        from_src = is_src_edge.index_select(0, e0).view(r, k, s)
        slot = out_slot.index_select(0, e0).view(r, k).long()
        bit = torch.where(slot >= 0, bits[slot.clamp(min=0) % 32], 0)
        slot_words = torch.where(
            (slot.clamp(min=0) // 32)[:, :, None] == words, bit[:, :, None], 0
        )  # [R, K, W]
        src_on = on_dag & from_src
        step = max(1, CHUNK_ELEMS // max(1, r * s * n_words))
        src_contrib = torch.zeros((r, s, n_words), dtype=torch.int32, device=device)
        for j in range(0, k, step):
            src_contrib |= _or_reduce(
                torch.where(
                    src_on[:, j : j + step, :, None],
                    slot_words[:, j : j + step, None, :],
                    0,
                )
            )
        use_pred = on_dag & ~from_src
        chunks = [
            (bk.nbr[:, j : j + step].reshape(-1), use_pred[:, j : j + step, :, None])
            for j in range(0, k, step)
        ]
        tables.append((lo, r, src_contrib, chunks))
        lo += r

    def relax(nh_T):
        out = torch.empty_like(nh_T)
        for lo, r, src_contrib, chunks in tables:
            acc = nh_T[lo : lo + r] | src_contrib
            for idx, use in chunks:
                pred = nh_T.index_select(0, idx).view(r, -1, s, n_words)
                acc = acc | _or_reduce(torch.where(use, pred, 0))
            out[lo : lo + r] = acc
        return out

    nh0 = torch.zeros((n_cap, s, n_words), dtype=torch.int32, device=device)
    nh_T, ok = _fixed_sweeps(relax, nh0, n_sweeps)
    return nh_T.index_select(0, ell.new_of_old).transpose(0, 1), ok


def spf_forward_full(
    sources: torch.Tensor,
    ell: EllGraph,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    edge_metric: torch.Tensor,
    edge_up: torch.Tensor,
    node_overloaded: torch.Tensor,
    out_slot: torch.Tensor,
    n_words: int,
    n_sweeps: int,
    use_link_metric: bool = True,
):
    """Distances, SP-DAG and bit-packed first hops at a fixed sweep count
    (reference: ops/sssp.py spf_forward_full with `n_sweeps`, the body of
    the engine's query): (dist [S, N_cap] int32, dag [S, E_cap] bool,
    nh [S, N_cap, W] int32, converged 0-dim bool tensor), all on the
    device of `sources`.  The verdict ANDs the relax's and the first
    hops' verification sweeps; reading it is the caller's one host
    synchronisation."""
    n_cap = int(node_overloaded.shape[0])
    relax = _ell_relax(
        ell, edge_up, node_overloaded, edge_metric, int(sources.shape[0]),
        unit_metric=not use_link_metric,
    )
    dist_T, dist_ok = _fixed_sweeps(
        relax, make_dist0_T(sources, ell.new_of_old, n_cap), n_sweeps
    )
    dist_old_T = ell_dist_to_old_T(dist_T, ell)
    metric = edge_metric if use_link_metric else torch.ones_like(edge_metric)
    allowed_T = make_relax_allowed_T(sources, edge_src, edge_up, node_overloaded)
    dag = sp_dag_mask_from_T(dist_old_T, edge_src, edge_dst, metric, allowed_T)
    nh, nh_ok = first_hops_ell(
        ell, dag.T, out_slot, sources, edge_src, n_words, n_sweeps
    )
    return dist_old_T.T, dag, nh, dist_ok & nh_ok


# -- the dense edge-list relax (small graphs) --------------------------------


def make_dist0(sources: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """[S, N] int32 rows: 0 at each row's source, INF32 elsewhere
    (reference: ops/sssp.py make_dist0)."""
    ids = torch.arange(n_nodes, dtype=sources.dtype, device=sources.device)
    d0 = torch.full(
        (sources.shape[0], n_nodes), INF32, dtype=torch.int32, device=sources.device
    )
    return d0.masked_fill_(ids[None, :] == sources[:, None], 0)


def make_relax_allowed(
    sources: torch.Tensor,
    edge_src: torch.Tensor,
    edge_up: torch.Tensor,
    node_overloaded: torch.Tensor,
    extra_edge_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[S, E] relax permission (reference: ops/sssp.py
    make_relax_allowed): `make_relax_allowed_T` row-major, with
    `extra_edge_mask` [S, E] or [E] (False excludes)."""
    extra_T = None
    if extra_edge_mask is not None:
        extra_T = extra_edge_mask.T if extra_edge_mask.dim() == 2 else extra_edge_mask
    return make_relax_allowed_T(
        sources, edge_src, edge_up, node_overloaded, extra_T
    ).T


def batched_sssp(
    dist0: torch.Tensor,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    edge_metric: torch.Tensor,
    relax_allowed: torch.Tensor,
) -> torch.Tensor:
    """Edge-list relax to the fixed point (reference: ops/sssp.py
    batched_sssp): per sweep every allowed edge offers d[u] + w to its
    head and a scatter-min over the heads keeps the least, for at most
    N sweeps.  dist0 [S, N] int32 and relax_allowed [S, E] bool; returns
    dist [S, N] int32."""
    s, n = dist0.shape
    heads = edge_dst.long().expand(s, -1)
    dist = dist0
    for _ in range(n):
        d_u = dist.index_select(1, edge_src)
        cand = torch.where(relax_allowed & (d_u < INF32), d_u + edge_metric, INF32)
        best = torch.full_like(dist, INF32).scatter_reduce_(1, heads, cand, "amin")
        new = torch.minimum(dist, best)
        with fetch_point("relax fixed point"):
            done = torch.equal(new, dist)
        if done:
            break
        dist = new
    return dist


def sp_dag_mask(
    dist: torch.Tensor,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    edge_metric: torch.Tensor,
    relax_allowed: torch.Tensor,
) -> torch.Tensor:
    """[S, E] SP-DAG of row-major distances (reference: ops/sssp.py
    sp_dag_mask)."""
    d_u = dist.index_select(1, edge_src)
    d_v = dist.index_select(1, edge_dst)
    return relax_allowed & (d_u < INF32) & (d_u + edge_metric[None, :] == d_v)
