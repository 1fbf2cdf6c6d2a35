"""Band-augmented batched SSSP relax ops in PyTorch.

Port of `openr_tpu.ops.banded`: the circulant-band + residual-ELL
decomposition (`build_banded`, verbatim numpy) and the relax semantics
of `_RelaxOps` as PyTorch ops on [N, S] int32 distance tensors.  Band
edges ``(v - c) mod N -> v`` relax as a roll of the whole distance
matrix; the remaining residual edges relax as row gathers from a
uniform-K table in original node order.

Semantics (identical to the reference's relax kernels and host oracle):
down edges never relax; overloaded nodes are reachable but offer no
transit, except a row's own source (dist == 0, metrics being >= 1).
Composed band levels skip that source exception; the exact depth-0
stages apply it, so the fixed point is exactly the reference's.

Distances are int32 with INF32 unreachable and weights clamped to WBIG,
so no sum wraps (ops.sssp).  The uint16 distance mode (`small_dist`,
gated by `pick_small_dist`) runs the same int32 arithmetic over the
16-bit domain, INF16 unreachable and weights clamped to WBIG16 before
any narrowing, which is exactly the reference's uint16 relax: no sum of
either wraps.  `SpfRunner` carries both decompositions of a reversed
graph: the bands when `build_banded` finds them, else the bucketed ELL
of ops.sssp, which it runs at a learned fixed-sweep hint (`adapt`,
`run_once`); its `small_allowed` latches the uint16 mode off once a run
saturates.  `affected_mask` is the worsening-direction warm-start
support of the fleet view.

Per-row edge exclusions (KSP re-runs, SRLG what-if, TI-LFA) enter the
residual as slot masks and the bands as cut barriers: a composed window
of 2^(l+1) band edges that crosses an excluded edge is blocked for that
row, so a masked edge is never jumped over (`_RelaxOps` with
`row_allowed_T`).  `batched_sssp_banded` runs a fixed number of
supersweeps and one exact verification relax; `spf_forward_banded`
adds the uint16 verdict and the SP-DAG; `SpfRunner.forward` adapts the
sweep hint of unmasked and masked batches separately (`hint`,
`hint_masked`) and returns host arrays.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..device.sanitizer import fetch, fetch_point, stage
from .sssp import (
    WBIG16,
    EllGraph,
    domain,
    forward_tail,
    make_relax_allowed_T,
    spf_forward_ell_sweeps,
    u16_to_i32,
)


class BandedGraph:
    """Host-built circulant-band + residual-ELL decomposition (numpy).

    ``resid_buckets`` groups the residual columns by chord-length scale:
    the chord-mode supersweep fuses within a bucket (Jacobi) and chains
    across buckets (Gauss-Seidel)."""

    def __init__(
        self,
        offsets,
        band_eid: np.ndarray,  # [B, N] int32 — edge of (v-c)%N -> v; -1
        resid_nbr: np.ndarray,  # [N, K] int32 — residual in-nbrs (pad 0)
        resid_eid: np.ndarray,  # [N, K] int32 — residual edge ids; -1
        n_nodes: int,
        resid_buckets=None,
    ) -> None:
        self.offsets = tuple(int(c) for c in offsets)
        self.band_eid = band_eid
        self.resid_nbr = resid_nbr
        self.resid_eid = resid_eid
        self.n_nodes = int(n_nodes)
        if resid_buckets is None:
            resid_buckets = ((0, int(resid_nbr.shape[1])),)
        self.resid_buckets = tuple(
            (int(lo), int(hi)) for lo, hi in resid_buckets
        )


def build_banded(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    n_edges: int,
    n_nodes: int,
    min_band_frac: float = 0.125,
    max_bands: int = 8,
    max_resid_k: int = 32,
) -> Optional[BandedGraph]:
    """Detect circulant bands and build the decomposition.  Returns None
    when the topology has no useful band structure (e.g. a fat-tree) or
    the residual degree is too skewed for a uniform-K table — callers
    take the ELL path instead."""
    if n_edges == 0 or n_nodes < 64:
        return None
    src = edge_src[:n_edges].astype(np.int64)
    dst = edge_dst[:n_edges].astype(np.int64)
    # retired or padding slots inside [:n_edges] (endpoints at the pad
    # node >= n_nodes) are not edges of the graph
    ids = np.flatnonzero((src < n_nodes) & (dst < n_nodes))
    if ids.size == 0:
        return None
    src, dst = src[ids], dst[ids]
    off = (dst - src) % n_nodes
    vals, counts = np.unique(off, return_counts=True)
    thresh = max(int(n_nodes * min_band_frac), 32)
    cand = vals[counts >= thresh]
    if cand.size == 0:
        return None
    if cand.size > max_bands:
        top = np.argsort(-counts[counts >= thresh])[:max_bands]
        cand = cand[top]
    band_set = set(int(c) for c in cand)

    is_band = np.isin(off, cand)
    band_eid = np.full((len(cand), n_nodes), -1, dtype=np.int32)
    # one edge per (band, position); parallel band edges go to the
    # residual
    offs_sorted = sorted(band_set)
    eids = np.flatnonzero(is_band)
    rows = np.searchsorted(
        np.asarray(offs_sorted, dtype=np.int64), off[eids]
    )
    cols = dst[eids]
    order = np.lexsort((eids, cols, rows))
    r_o, c_o, e_o = rows[order], cols[order], eids[order]
    dup = np.r_[False, (r_o[1:] == r_o[:-1]) & (c_o[1:] == c_o[:-1])]
    band_eid[r_o[~dup], c_o[~dup]] = ids[e_o[~dup]].astype(np.int32)
    demoted = e_o[dup]
    is_band[demoted] = False

    resid = np.flatnonzero(~is_band)
    resid_deg = np.bincount(dst[resid], minlength=n_nodes)
    k = int(resid_deg.max()) if resid.size else 0
    k_pad = 1
    while k_pad < max(k, 1):
        k_pad *= 2
    if k_pad > max_resid_k:
        return None
    # bands must cover enough edges that the uniform-K residual is
    # smaller than the work the bucketed ELL would do
    if n_nodes * k_pad > len(src):
        return None
    resid_nbr = np.zeros((n_nodes, k_pad), dtype=np.int32)
    resid_eid = np.full((n_nodes, k_pad), -1, dtype=np.int32)
    resid_buckets = ((0, k_pad),)
    if resid.size:
        order = np.argsort(dst[resid], kind="stable")
        r_sorted = resid[order]
        d_sorted = dst[resid][order]
        starts = np.searchsorted(d_sorted, np.arange(n_nodes))
        slot = np.arange(r_sorted.size) - starts[d_sorted]
        resid_nbr[d_sorted, slot] = src[r_sorted].astype(np.int32)
        resid_eid[d_sorted, slot] = ids[r_sorted].astype(np.int32)
        # chord-bucketed residual order: each row's slots sorted by
        # folded chord length (short first), the columns split into a
        # short-chord and a long-chord bucket where the scales separate
        offs = (np.arange(n_nodes, dtype=np.int64)[:, None] - resid_nbr) % (
            n_nodes
        )
        folded = np.minimum(offs, n_nodes - offs)
        folded = np.where(resid_eid >= 0, folded, np.iinfo(np.int64).max)
        col_order = np.argsort(folded, axis=1, kind="stable")
        resid_nbr = np.take_along_axis(resid_nbr, col_order, axis=1)
        resid_eid = np.take_along_axis(resid_eid, col_order, axis=1)
        folded = np.take_along_axis(folded, col_order, axis=1)
        med = np.full(k_pad, np.inf)
        for k in range(k_pad):
            valid = resid_eid[:, k] >= 0
            if valid.any():
                med[k] = float(np.median(folded[valid, k]))
        is_long = med > max(16.0, float(n_nodes) ** 0.5)
        split = int(np.searchsorted(is_long, True))
        if 0 < split < k_pad:
            resid_buckets = ((0, split), (split, k_pad))
    return BandedGraph(
        offsets=tuple(offs_sorted),
        band_eid=band_eid,
        resid_nbr=resid_nbr,
        resid_eid=resid_eid,
        n_nodes=n_nodes,
        resid_buckets=resid_buckets,
    )


def make_dist0_orig(
    dest_ids: torch.Tensor, n_nodes: int, small_dist: bool = False
) -> torch.Tensor:
    """[N, S] int32 dist0 in original node order: 0 at row dest_ids[s] of
    column s, INF32 (INF16 with `small_dist`) elsewhere."""
    s = dest_ids.shape[0]
    d0 = torch.full(
        (n_nodes, s),
        domain(small_dist)[0],
        dtype=torch.int32,
        device=dest_ids.device,
    )
    d0[dest_ids.long(), torch.arange(s, device=dest_ids.device)] = 0
    return d0


class StagedArrays(NamedTuple):
    """A runner's tables and runtime arrays as tensors on one device: the
    banded tables when the runner has bands, else the ELL buckets."""

    band_eid: Optional[torch.Tensor]  # [B, N] int32
    resid_nbr: Optional[torch.Tensor]  # [N, K] int32
    resid_eid: Optional[torch.Tensor]  # [N, K] int32
    edge_metric: torch.Tensor  # [E_cap] int32
    edge_up: torch.Tensor  # [E_cap] bool
    node_overloaded: torch.Tensor  # [N_cap] bool
    ell: Optional[EllGraph] = None  # tensors; None on a banded runner
    edge_src: Optional[torch.Tensor] = None  # [E_cap] int32 (the SP-DAG)
    edge_dst: Optional[torch.Tensor] = None  # [E_cap] int32


def _gather(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values[idx] for an int32 index tensor of any shape."""
    return values.index_select(0, idx.reshape(-1)).reshape(idx.shape)


def _edge_weights(st: StagedArrays, eid: torch.Tensor, wbig: int) -> torch.Tensor:
    """Weight of each edge id clamped to `wbig`, `wbig` where the edge is
    padding or down (a `wbig` weight masks the edge).  The clamp comes
    before any narrowing, so in the uint16 mode an oversized metric
    saturates to the band infinity instead of wrapping."""
    e0 = eid.clamp(min=0)
    ok = (eid >= 0) & _gather(st.edge_up, e0)
    m = _gather(st.edge_metric, e0).clamp(max=wbig)
    return torch.where(ok, m, wbig)


def _band_tables(bg: BandedGraph, st: StagedArrays, ov_n, depth: int, wbig: int):
    """Per band: depth-0 weight [N, 1], overload-of-predecessor [N, 1]
    and the composed level weights min(wl + wr, wbig) (overload-blocked),
    all [N, 1]."""
    tables = []
    for b, c in enumerate(bg.offsets):
        w0 = _edge_weights(st, st.band_eid[b], wbig)[:, None]
        ov = torch.roll(ov_n, c, 0)[:, None]  # overloaded[(v-c)%N]
        wl = torch.where(ov, wbig, w0)
        levels = []
        for level in range(depth):
            wr = torch.roll(wl, (c << level) % bg.n_nodes, 0)
            wl = torch.where(
                (wl < wbig) & (wr < wbig), (wl + wr).clamp(max=wbig), wbig
            )
            levels.append(wl)
        tables.append((w0, ov, levels))
    return tables


class _RelaxOps:
    """Relax and verify ops over one (graph, runtime-state) binding — the
    single source of the relax semantics for the progressive loop and
    the epilogue's group tables.  Distances are int32 tensors; with
    `small_dist` they hold the 16-bit domain (`inf` INF16, `wbig`
    WBIG16), as the reference's uint16 relax does.

    `row_allowed_T` [E_cap, S] bool (False excludes) adds per-row
    exclusions: residual slot masks `resid_excl` [N, K, S] and per band
    the cut positions `band_cut0` [N, S], which the composed levels
    widen into barriers."""

    def __init__(
        self,
        bg: BandedGraph,
        st: StagedArrays,
        depth: int,
        resid_rounds: int,
        chord_mode: bool,
        small_dist: bool = False,
        row_allowed_T: Optional[torch.Tensor] = None,
    ) -> None:
        self.bg = bg
        self.n = bg.n_nodes
        self.chord_mode = chord_mode
        self.resid_rounds = resid_rounds
        self.inf, self.wbig = domain(small_dist)
        self.n_resid = int(st.resid_nbr.shape[1])
        self.n_bands = len(bg.offsets)
        ov_n = st.node_overloaded[: self.n]
        self.band_tabs = _band_tables(bg, st, ov_n, depth, self.wbig)
        self.rw = _edge_weights(st, st.resid_eid, self.wbig)  # [N, K]
        self.rov = _gather(ov_n, st.resid_nbr)  # [N, K]
        self.resid_nbr = st.resid_nbr
        self.resid_excl = None
        self.band_cut0 = None
        if row_allowed_T is not None:
            s = row_allowed_T.shape[1]
            eid = st.resid_eid
            self.resid_excl = (eid >= 0)[:, :, None] & ~row_allowed_T.index_select(
                0, eid.clamp(min=0).reshape(-1)
            ).view(*eid.shape, s)
            self.band_cut0 = [
                (be >= 0)[:, None] & ~row_allowed_T.index_select(0, be.clamp(min=0))
                for be in st.band_eid
            ]

    def resid_cand(self, d: torch.Tensor, k: int) -> torch.Tensor:
        du = d.index_select(0, self.resid_nbr[:, k])  # [N, S]
        w = self.rw[:, k][:, None]
        allow = (w < self.wbig) & (~self.rov[:, k][:, None] | (du == 0))
        if self.resid_excl is not None:
            allow = allow & ~self.resid_excl[:, k]
        return torch.where(allow & (du < self.inf), du + w, self.inf)

    def relax_resid(self, d: torch.Tensor) -> torch.Tensor:
        for k in range(self.n_resid):
            d = torch.minimum(d, self.resid_cand(d, k))
        return d

    def band0_cand(self, d: torch.Tensor, b: int) -> torch.Tensor:
        """Depth-0 band relax candidate with the exact source exception."""
        w0, ov, _ = self.band_tabs[b]
        du = torch.roll(d, self.bg.offsets[b], 0)
        allow = (w0 < self.wbig) & (~ov | (du == 0))
        if self.band_cut0 is not None:
            allow = allow & ~self.band_cut0[b]
        return torch.where(allow & (du < self.inf), du + w0, self.inf)

    def relax_band0(self, d: torch.Tensor, b: int) -> torch.Tensor:
        return torch.minimum(d, self.band0_cand(d, b))

    def relax_band_levels(self, d: torch.Tensor, b: int) -> torch.Tensor:
        """Composed-shift relaxes (transit-blocked; no source exception).
        With row exclusions a level's window of 2^(l+1) edges ending at v
        is blocked for a row when any of its edges is cut there: the cut
        mask doubles with the window (cut | cut rolled by c * 2^l)."""
        c = self.bg.offsets[b]
        _, _, levels = self.band_tabs[b]
        cut = self.band_cut0[b] if self.band_cut0 is not None else None
        for level, wl in enumerate(levels):
            du = torch.roll(d, (c << (level + 1)) % self.n, 0)
            cand = torch.where(
                (wl < self.wbig) & (du < self.inf), du + wl, self.inf
            )
            if cut is not None:
                cut = cut | torch.roll(cut, (c << level) % self.n, 0)
                cand = torch.where(cut, self.inf, cand)
            d = torch.minimum(d, cand)
        return d

    def supersweep(self, d: torch.Tensor) -> torch.Tensor:
        if self.chord_mode:
            # Jacobi within a chord-scale bucket (every candidate from the
            # bucket's input), chained across buckets, then all depth-0
            # band shifts from one input
            for lo, hi in self.bg.resid_buckets:
                base = d
                for k in range(lo, hi):
                    d = torch.minimum(d, self.resid_cand(base, k))
            base = d
            for b in range(self.n_bands):
                d = torch.minimum(d, self.band0_cand(base, b))
            return d
        for _ in range(self.resid_rounds):
            d = self.relax_resid(d)
        for b in range(self.n_bands):
            d = self.relax_band0(d, b)
            d = self.relax_band_levels(d, b)
        return d

    def verify(self, d: torch.Tensor) -> torch.Tensor:
        """One exact relax pass: v == d certifies the fixed point.  The
        chord-mode supersweep is an equally exact check: its stages are
        monotone non-increasing, so an unchanged composite means every
        single-edge candidate left d unchanged."""
        if self.chord_mode:
            return self.supersweep(d)
        v = self.relax_resid(d)
        for b in range(self.n_bands):
            v = self.relax_band0(v, b)
        return v


def affected_mask(
    dist: torch.Tensor,
    bg: BandedGraph,
    st: StagedArrays,
    worsened_resid: torch.Tensor,
    worsened_band: torch.Tensor,
    max_iters: int = 128,
):
    """Worsening-direction warm-start support (reference: ops/banded.py
    affected_mask): the entries of the OLD fixed point `dist` [N*, S]
    that a set of worsened edges (removed, metric-increased, or transit
    through a newly drained node) can have invalidated.  `bg` and `st`
    are the OLD graph's decomposition and staged arrays;
    `worsened_resid` [N, K] and `worsened_band` [B, N] (bool) mark the
    worsened residual slots and band positions.

    aff[v, s] is set iff some old tight chain into v (a chain of relax
    candidates achieving equality) crosses a worsened edge, propagated
    by OR along tight edges, slot by slot and band by band within a
    pass, until a full pass changes nothing.  Returns (aff [N, S] bool,
    done host bool, passes run): done False means `max_iters` passes
    ran out before the fixpoint, and the caller must cold-start.

    A torch.uint16 `dist` is a product of the uint16 mode: the tight
    candidates are then evaluated in its 16-bit domain (the reference's
    `small_dist`).  The tight masks depend only on `dist`, so they are
    computed once (one [N, S] bool per slot and band) and each pass is
    gathers and ORs of bool matrices."""
    n = bg.n_nodes
    small = dist.dtype == torch.uint16
    ops = _RelaxOps(bg, st, 0, 1, False, small_dist=small)
    d = u16_to_i32(dist[:n]) if small else dist[:n]
    fin = d < ops.inf
    resid = [
        (
            fin & (ops.resid_cand(d, k) == d),
            st.resid_nbr[:, k],
            worsened_resid[:, k][:, None],
        )
        for k in range(ops.n_resid)
    ]
    bands = [
        (fin & (ops.band0_cand(d, b) == d), c, worsened_band[b][:, None])
        for b, c in enumerate(bg.offsets)
    ]
    aff = torch.zeros(d.shape, dtype=torch.bool, device=d.device)
    passes = 0
    done = False
    while not done and passes < max_iters:
        new = aff
        for tight, nbr, seed in resid:
            new = new | (tight & (seed | new.index_select(0, nbr)))
        for tight, c, seed in bands:
            new = new | (tight & (seed | torch.roll(new, c, 0)))
        with fetch_point("affected fixed point"):
            done = torch.equal(new, aff)
        aff = new
        passes += 1
    return aff, done, passes


def batched_sssp_banded(
    dist0: torch.Tensor,
    bg: BandedGraph,
    st: StagedArrays,
    n_supersweeps: int,
    depth: int = 3,
    resid_rounds: int = 1,
    row_allowed_T: Optional[torch.Tensor] = None,
    small_dist: bool = False,
    chord_mode: bool = False,
):
    """Fixed-supersweep banded relax (reference: ops/banded.py
    batched_sssp_banded): `n_supersweeps` supersweeps from `dist0` [N, S]
    (original node order, int32 in the run's domain), then one exact
    verification relax.  Returns (dist [N, S], converged 0-dim bool
    tensor): converged means the verification changed nothing.  The
    chord-mode supersweep has no composed levels (depth 0)."""
    ops = _RelaxOps(
        bg,
        st,
        0 if chord_mode else depth,
        resid_rounds,
        chord_mode,
        small_dist=small_dist,
        row_allowed_T=row_allowed_T,
    )
    d = dist0
    for _ in range(n_supersweeps):
        d = ops.supersweep(d)
    v = ops.verify(d)
    return v, (v == d).all()


def spf_forward_banded(
    sources: torch.Tensor,
    bg: BandedGraph,
    st: StagedArrays,
    n_supersweeps: int,
    depth: int = 3,
    resid_rounds: int = 1,
    extra_edge_mask: Optional[torch.Tensor] = None,
    small_dist: bool = False,
    use_link_metric: bool = True,
    want_dag: bool = True,
    chord_mode: bool = False,
    raw_u16: bool = False,
):
    """Banded fixed-sweep forward (reference: ops/banded.py
    spf_forward_banded with progressive=False and no dist0): (dist
    [N, S] in original ids, dag [S, E_cap] bool or None, converged
    0-dim bool tensor), the dist layout the kernel's native one (the
    reference's transpose=False).  `st` holds the runtime arrays (a
    metric plane goes in as `st.edge_metric`; the DAG reads
    `st.edge_src` / `st.edge_dst`).  `extra_edge_mask` [S, E_cap] or
    [E_cap] bool (False excludes) carries the per-row exclusions; the
    bands and residual already apply up and overload.  The uint16 mode,
    `raw_u16` and the DAG are as in ops.sssp.forward_tail.  The
    progressive early-exit relax and its warm start live in
    ops.allsources (the fleet product)."""
    if not use_link_metric:
        st = st._replace(edge_metric=torch.ones_like(st.edge_metric))
    extra_T = None
    row_allowed_T = None
    if extra_edge_mask is not None:
        extra_T = extra_edge_mask.T if extra_edge_mask.dim() == 2 else extra_edge_mask[:, None]
        row_allowed_T = extra_T.expand(extra_T.shape[0], sources.shape[0])
    dist, converged = batched_sssp_banded(
        make_dist0_orig(sources, bg.n_nodes, small_dist=small_dist),
        bg,
        st,
        n_supersweeps,
        depth=depth,
        resid_rounds=resid_rounds,
        row_allowed_T=row_allowed_T,
        small_dist=small_dist,
        chord_mode=chord_mode,
    )
    allowed_T = None
    if want_dag:
        allowed_T = make_relax_allowed_T(
            sources, st.edge_src, st.edge_up, st.node_overloaded, extra_T
        )
    return forward_tail(
        dist, converged, small_dist, raw_u16, want_dag, st.edge_src,
        st.edge_dst, st.edge_metric, allowed_T,
    )


def pick_small_dist(edge_metric: np.ndarray, n_edges: int) -> bool:
    """True when every metric of the first `n_edges` edges (a numpy
    array) is below WBIG16 // 4 = 5000 (reference: ops/banded.py
    pick_small_dist): uint16 distances are then safe up to the
    saturation guard, since any overflowing path must first produce a
    finite distance in [WBIG16, INF16)."""
    if n_edges == 0:
        return True
    return int(np.asarray(edge_metric[:n_edges]).max()) < WBIG16 // 4


class SpfRunner:
    """The relax settings of one mirrored edge set (the reversed graph of
    the fleet view, or a mirror's forward graph).  With bands (`bg`):
    composed-shift depth, chord mode, and the fixed-sweep hint.  Without
    (`bg` None): the bucketed ELL (`ell`, ops.sssp).  `stage` pins its
    tables and runtime arrays on a device; `run_once` is one fixed-sweep
    run on either path and `forward` adapts the hint around it
    (`adapt`).  `sweeps` counts the relax sweeps run (ELL sweeps or
    banded supersweeps, verification sweeps included, and the fleet
    product's progressive supersweeps), `runs` the fixed-sweep calls
    (attempts and probes) and `masked_runs` those with per-row
    exclusions.  A mirror's forward runner `share`s the tensors of the
    mirror's resident instead of staging its own copy.

    Masked batches need deeper relaxes than unmasked ones, so they learn
    their own hint, `hint_masked` (reference: SpfRunner.hint_masked).
    `small_dist` says whether the next run takes the uint16 distance
    mode: `small_allowed` (latched off for good once a run saturated)
    and the metric gate, re-read from the numpy metrics on every run
    because a mirror refresh rewrites them in place; a run over another
    metric plane gates on that plane."""

    def __init__(
        self,
        ell: Optional[EllGraph],
        bg: Optional[BandedGraph],
        edge_src,
        edge_dst,
        edge_metric,
        edge_up,
        node_overloaded,
        n_edges: int,
        hint: int = 8,
        depth: Optional[int] = None,
        resid_rounds: int = 1,
    ) -> None:
        self.ell = ell
        self.bg = bg
        self.arrays = (edge_src, edge_dst, edge_metric, edge_up, node_overloaded)
        self.n_edges = n_edges
        # on chord-rich small-world graphs the supersweep count is floored
        # by chord hop depth, so the composed band levels are overhead and
        # the bucketed Jacobi supersweep (chord_mode) is used; band-
        # dominated graphs (grids) keep the sequential supersweep with
        # composed levels tuned to the longest straight band run
        self.chord_mode = False
        if depth is None:
            if bg is not None and n_edges > 0:
                resid_frac = float((bg.resid_eid >= 0).sum()) / float(n_edges)
                self.chord_mode = resid_frac > 0.25
                if self.chord_mode:
                    depth = 0
                else:
                    depth = max(
                        2,
                        min(
                            6,
                            int(
                                np.ceil(
                                    np.log2(
                                        max(4.0, float(bg.n_nodes) ** 0.5)
                                    )
                                )
                            )
                            - 1,
                        ),
                    )
            else:
                depth = 2
        self.depth = depth
        self.resid_rounds = resid_rounds
        self.hint = hint
        self.hint_masked = hint
        self.sweeps = 0
        self.runs = 0
        self.masked_runs = 0
        self.small_allowed = True
        self._staged: Optional[StagedArrays] = None

    @property
    def small_dist(self) -> bool:
        return self._small_for(None)

    def _small_for(self, metric_plane) -> bool:
        """The uint16 mode of a run over `metric_plane` (numpy; None for
        the runner's own metrics)."""
        plane = self.arrays[2] if metric_plane is None else metric_plane
        return self.small_allowed and pick_small_dist(plane, self.n_edges)

    def stage(self, device: torch.device) -> int:
        """Pin the tables (bands, else ELL buckets) and runtime arrays on
        `device`; returns the bytes staged."""
        src, dst, metric, up, overloaded = self.arrays

        def put(a):
            return stage(a, device)

        runtime = [put(a) for a in (metric, up, overloaded)]
        ends = [put(a) for a in (src, dst)]
        if self.bg is None:
            ell = self.ell.to(device)
            self._staged = StagedArrays(None, None, None, *runtime, ell, *ends)
            tensors = [t for bk in ell.buckets for t in bk]
            tensors += [ell.new_of_old, ell.old_of_new]
        else:
            bg = self.bg
            tables = [
                put(a) for a in (bg.band_eid, bg.resid_nbr, bg.resid_eid)
            ]
            self._staged = StagedArrays(*tables, *runtime, None, *ends)
            tensors = tables
        tensors += runtime + ends
        return sum(t.numel() * t.element_size() for t in tensors)

    def share(
        self, ell, edge_src, edge_dst, edge_metric, edge_up, node_overloaded
    ) -> int:
        """Run over tensors another owner keeps on one device (a mirror's
        resident in the engine): its ELL `ell` and its edge and node
        arrays, whose in-place writes the runner then reads.  Only the
        band tables are staged here, once per device; returns the bytes
        staged."""
        device = edge_up.device
        runtime = (edge_metric, edge_up, node_overloaded)
        if self.bg is None:
            self._staged = StagedArrays(
                None, None, None, *runtime, ell, edge_src, edge_dst
            )
            return 0
        old = self._staged
        if old is not None and old.band_eid.device == device:
            tables, staged = (old.band_eid, old.resid_nbr, old.resid_eid), 0
        else:
            tables = tuple(
                stage(a, device)
                for a in (self.bg.band_eid, self.bg.resid_nbr, self.bg.resid_eid)
            )
            staged = sum(t.numel() * t.element_size() for t in tables)
        self._staged = StagedArrays(*tables, *runtime, None, edge_src, edge_dst)
        return staged

    def call_arrays(self) -> StagedArrays:
        if self._staged is None:
            raise RuntimeError("SpfRunner.stage(device) has not run")
        return self._staged

    def adapt(
        self,
        hint_attr: str,
        attempt: Callable,
        probe: Callable,
        eff_small: Callable,
    ):
        """The fixed-sweep adaptation loop (reference: SpfRunner.adapt):
        run `attempt(sweeps)` at the learned hint, double the hint on a
        False verdict, and once a doubled run converges refine the hint
        back down with at most 3 binary `probe(mid)` steps.  Returns the
        converged attempt's result.

        A failed run in the uint16 mode at 32 sweeps or more latches
        `small_allowed` off instead of doubling (saturation also shows
        as a False verdict), so the next attempt runs the same sweeps in
        int32.  A shortest path has fewer than N_cap hops and every sweep
        settles at least one more, so an int32 run that fails past
        2 * N_cap sweeps raises instead of doubling for ever.
        attempt(sweeps) -> (result, ok); probe(sweeps) -> ok;
        eff_small() -> whether the run that just failed was in the
        uint16 mode."""
        doubled_from: Optional[int] = None
        while True:
            sweeps = getattr(self, hint_attr)
            result, ok = attempt(sweeps)
            if ok:
                if doubled_from is not None:
                    lo, hi = doubled_from, sweeps
                    probes = 0
                    while hi - lo > 1 and probes < 3:
                        probes += 1
                        mid = (lo + hi) // 2
                        if probe(mid):
                            hi = mid
                        else:
                            lo = mid
                    setattr(self, hint_attr, hi)
                return result
            if eff_small() and sweeps >= 32:
                self.small_allowed = False
            elif sweeps > 2 * len(self.arrays[4]):
                raise RuntimeError(
                    f"relax did not converge in {sweeps} sweeps"
                )
            else:
                doubled_from = sweeps
                setattr(self, hint_attr, sweeps * 2)

    def forward(
        self,
        sources,
        use_link_metric: bool = True,
        extra_edge_mask=None,
        want_dag: bool = True,
        n_sweeps: Optional[int] = None,
        metric_plane=None,
    ):
        """Distances (and the SP-DAG) of a batch of sources (reference:
        SpfRunner.forward): (dist numpy [S, N*] int32, dag numpy [S, E_cap]
        bool or None), N* being N on the banded path and N_cap on the ELL
        path.  `extra_edge_mask` (numpy [S, E_cap] or [E_cap] bool, False
        excludes) adds per-row exclusions and adapts `hint_masked`
        instead of `hint`; `metric_plane` (numpy [E_cap] int32) replaces
        the metrics for this call, the uint16 gate keyed on it.  With
        `n_sweeps` one fixed-sweep run, which must converge (raises
        otherwise); without, the learned hint through `adapt`."""
        st = self.call_arrays()
        device = st.edge_up.device
        src = stage(np.asarray(sources, dtype=np.int32), device)
        mask = None
        if extra_edge_mask is not None:
            mask = stage(np.asarray(extra_edge_mask, dtype=bool), device)
        plane = None
        if metric_plane is not None:
            plane = stage(np.asarray(metric_plane, dtype=np.int32), device)

        def run(sweeps: int, dag: bool):
            return self.run_once(
                src, sweeps, use_link_metric=use_link_metric,
                extra_edge_mask=mask, want_dag=dag, metric_plane=plane,
                small=self._small_for(metric_plane),
            )

        def attempt(sweeps: int):
            out = run(sweeps, want_dag)
            return out, out[2]

        if n_sweeps is not None:
            dist, dag, ok = run(n_sweeps, want_dag)
            if not ok:
                raise RuntimeError(f"fixed {n_sweeps}-sweep run did not converge")
        else:
            dist, dag, _ = self.adapt(
                "hint" if mask is None else "hint_masked",
                attempt,
                probe=lambda sweeps: run(sweeps, False)[2],
                eff_small=lambda: self._small_for(metric_plane),
            )
        return (
            fetch(dist.T, "forward result"),
            None if dag is None else fetch(dag, "forward result"),
        )

    def run_once(
        self,
        sources: torch.Tensor,
        n_sweeps: int,
        raw_u16: bool = False,
        *,
        use_link_metric: bool = True,
        extra_edge_mask: Optional[torch.Tensor] = None,
        want_dag: bool = False,
        metric_plane: Optional[torch.Tensor] = None,
        small: Optional[bool] = None,
    ):
        """One fixed-sweep run from `sources` [S] (original ids), on the
        bands when the runner has them, else on the ELL (at least 2
        sweeps there, as in the reference): (dist [N*, S] in original
        ids, dag [S, E_cap] bool or None, converged host bool).  dist is
        int32 / INF32, or with `raw_u16` a uint16 run's torch.uint16
        product (INF16 sentinel).  `extra_edge_mask` (a bool tensor
        [S, E_cap] or [E_cap], False excludes), `use_link_metric`,
        `want_dag` and `metric_plane` (an int32 tensor [E_cap] standing
        in for the metrics) are those of the reference's run_once.  The
        uint16 mode is `small` when given (the caller gated it on the
        plane's host copy), else `small_dist`."""
        st = self.call_arrays()
        if metric_plane is not None:
            st = st._replace(edge_metric=metric_plane)
        if small is None:
            small = self.small_dist
        self.runs += 1
        if extra_edge_mask is not None:
            self.masked_runs += 1
        if self.bg is not None:
            self.sweeps += n_sweeps + 1
            dist, dag, ok = spf_forward_banded(
                sources,
                self.bg,
                st,
                n_sweeps,
                depth=self.depth,
                resid_rounds=self.resid_rounds,
                extra_edge_mask=extra_edge_mask,
                small_dist=small,
                use_link_metric=use_link_metric,
                want_dag=want_dag,
                chord_mode=self.chord_mode,
                raw_u16=raw_u16,
            )
            return dist, dag, bool(fetch(ok, "fixed-sweep verdict"))
        n_sweeps = max(n_sweeps, 2)
        self.sweeps += n_sweeps + 1
        return spf_forward_ell_sweeps(
            sources,
            st.ell,
            st.edge_metric,
            st.edge_up,
            st.node_overloaded,
            n_sweeps,
            small_dist=small,
            raw_u16=raw_u16,
            edge_src=st.edge_src,
            edge_dst=st.edge_dst,
            extra_edge_mask=extra_edge_mask,
            use_link_metric=use_link_metric,
            want_dag=want_dag,
        )
