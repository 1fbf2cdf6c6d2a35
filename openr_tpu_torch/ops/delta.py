"""Incremental delta updates of the fleet product.

Port of `openr_tpu.ops.delta`.  One coalesced batch of LinkState events
(metric changes, links up or down, drains) is folded into the previous
converged reverse product [N, P] by three programs whose relax work is
proportional to the affected destination columns, not to N x P:

1. `delta_frontier` certifies which (router, destination) entries the
   batch can have changed.  The worsening direction runs the support-
   loss rule over the OLD graph: an entry is affected iff EVERY tight
   support (a relax slot achieving equality) is itself worsened or leads
   to an affected neighbour.  That is the AND-rule, sharper than
   `ops.banded.affected_mask`'s OR-rule (any tight chain through a
   worsened edge): under ECMP ties a worsened edge is tight almost
   everywhere, but a row that keeps one intact support keeps its
   distance.  Tight supports strictly decrease the distance (metrics are
   positive), so the support graph is acyclic and the monotone fixpoint
   is exact.  The improvement direction fires the NEW graph's exact
   candidates at the improved slots against the old distances; a
   candidate with cand <= d marks its column (an equality-creating
   improvement moves only the ECMP bitmap).  Every column outside the
   union is proven unchanged.
2. `delta_relax` gathers only the affected columns (padded to a bucket
   of the engine's ladder), re-sets the affected entries to INF,
   re-pins the destinations, runs the progressive banded relax to its
   fixed point and the fused verify + bitmap epilogue over the [N, Pb]
   slab, and writes the real columns back into the full product and
   bitmap.  The reference writes that epilogue out in lax; here it is
   the same function as kernel K1, so the slab goes through the
   engine's `epilogue` (K1 on the card).
3. `delta_rows_bitmap` re-encodes the bitmap rows whose out-slot layout
   changed after an edge-set change (OutEll.slot is a rank among the
   node's sorted unique out-neighbours, so gaining or losing one shifts
   the bits even where no route changed), from the exact distances.

The reference donates the product and rebuilds it with scatter-free
hit-matrix selects; the port writes the columns and rows in place with
indexed writes.  Distances are int32 (INF32), or torch.uint16 (INF16)
in the uint16 mode, whose arithmetic runs in int32 over the 16-bit
domain (ops.sssp); uint16 columns are gathered and written through
their int16 view, which keeps the bits.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .allsources import EpilogueMaps, OutEll, _fused_progressive_banded
from .banded import BandedGraph, SpfRunner, StagedArrays, _RelaxOps
from .epilogue import _BITS
from .sssp import (
    INF16,
    INF32,
    clamp_metric_u16,
    domain,
    u16_index_select,
    u16_to_i32,
)


def _widened(dist: torch.Tensor, n: int) -> torch.Tensor:
    """The first n rows of a product as int32 (a uint16 product keeps its
    16-bit values, INF16 included)."""
    d = dist[:n]
    return u16_to_i32(d) if d.dtype == torch.uint16 else d


def delta_frontier(
    dist: torch.Tensor,
    old_bg: BandedGraph,
    old_st: StagedArrays,
    worsened_resid: torch.Tensor,
    worsened_band: torch.Tensor,
    new_bg: BandedGraph,
    new_st: StagedArrays,
    improved_resid: np.ndarray,
    improved_band: np.ndarray,
    max_iters: int = 128,
):
    """Certified affected frontier of one coalesced event batch.

    `dist` [N*, P] is the previous converged product (int32, or uint16
    in the uint16 mode); `old_bg` / `old_st` the previous reverse
    runner's bands and staged arrays (the OLD graph), `new_bg` / `new_st`
    the new runner's.  `worsened_resid` [N, K_old] and `worsened_band`
    [B_old, N] (bool tensors on dist's device) mark the worsened slots
    in the OLD layout; `improved_resid` [N, K_new] and `improved_band`
    [B_new, N] (numpy bool) the improved slots in the NEW layout.

    Returns (aff [N, P] bool, col_mask [P] bool, done host bool, passes):
    - aff: the support-loss set over the OLD graph (module docstring);
    - col_mask: the columns to re-relax: any affected entry, any
      worsened slot that was tight (its ECMP bit turns off even where the
      row keeps its distance), any improved slot whose NEW candidate
      fires at cand <= d;
    - done: the fixpoint was reached within `max_iters` passes (False:
      the caller must fall back, an under-propagated set is wrong);
    - passes: the support-loss passes run.

    The tight masks depend only on the old distances, so each slot's
    intact-support mask is computed once, before the passes; a pass is
    gathers, rolls and ORs of bool matrices.  Residual padding slots
    hold neighbour 0 (in range) and are never tight.  Only the slots
    with a worsened (improved) entry are evaluated for the bitmap seeds
    (the firing); the others add nothing."""
    small = dist.dtype == torch.uint16
    n = old_bg.n_nodes
    old_ops = _RelaxOps(old_bg, old_st, 0, 1, False, small)
    d_old = _widened(dist, n)
    fin = d_old < old_ops.inf
    worsened_k = worsened_resid.any(dim=0).tolist()
    worsened_b = worsened_band.any(dim=1).tolist()

    # per slot: the tight supports that are not worsened ([N, P] bool),
    # with the neighbour rows they lean on; and the bitmap-only seeds, a
    # worsened slot that was tight (its ECMP bit was on and turns off)
    bit_off = torch.zeros(d_old.shape, dtype=torch.bool, device=d_old.device)
    supports = []
    for k in range(old_ops.n_resid):
        tight = fin & (old_ops.resid_cand(d_old, k) == d_old)
        seed = worsened_resid[:, k][:, None]
        if worsened_k[k]:
            bit_off |= tight & seed
        supports.append(("resid", tight & ~seed, old_st.resid_nbr[:, k]))
    for b, c in enumerate(old_bg.offsets):
        tight = fin & (old_ops.band0_cand(d_old, b) == d_old)
        seed = worsened_band[b][:, None]
        if worsened_b[b]:
            bit_off |= tight & seed
        supports.append(("band", tight & ~seed, c))
    movable = fin & (d_old > 0)

    def sweep(aff: torch.Tensor) -> torch.Tensor:
        # a row keeps its old value iff SOME support survives: an
        # unworsened tight slot whose neighbour is unaffected
        intact = torch.zeros_like(aff)
        for kind, support, at in supports:
            nbr_aff = (
                aff.index_select(0, at) if kind == "resid" else torch.roll(aff, at, 0)
            )
            intact |= support & ~nbr_aff
        return movable & ~intact

    aff = torch.zeros(d_old.shape, dtype=torch.bool, device=d_old.device)
    settled = False
    passes = 0
    while not settled and passes < max_iters:
        new = sweep(aff)
        settled = torch.equal(new, aff)
        aff = new
        passes += 1
    del supports  # K + B [N, P] masks: free them before the firing pass

    # improvement firing: the NEW exact depth-0 candidates at the
    # improved slots only (unchanged slots cannot fire below the old
    # fixed point, worsened ones only raised their candidates)
    n = new_bg.n_nodes
    d = _widened(dist, n)
    new_ops = _RelaxOps(new_bg, new_st, 0, 1, False, small)
    device = d.device
    fire = torch.zeros(d.shape, dtype=torch.bool, device=device)
    for k in np.flatnonzero(improved_resid.any(axis=0)).tolist():
        cand = new_ops.resid_cand(d, k)
        at = torch.from_numpy(improved_resid[:, k]).to(device)[:, None]
        fire |= at & (cand < new_ops.inf) & (cand <= d)
    for b in np.flatnonzero(improved_band.any(axis=1)).tolist():
        cand = new_ops.band0_cand(d, b)
        at = torch.from_numpy(improved_band[b]).to(device)[:, None]
        fire |= at & (cand < new_ops.inf) & (cand <= d)
    col_mask = aff.any(dim=0) | bit_off.any(dim=0) | fire.any(dim=0)
    return aff, col_mask, settled, passes


def delta_relax(
    dist: torch.Tensor,
    bitmap: torch.Tensor,
    aff: torch.Tensor,
    col_idx: np.ndarray,
    n_cols: int,
    dest_ids: np.ndarray,
    runner: SpfRunner,
    maps: EpilogueMaps,
    n_words: int,
    epilogue: Callable,
    check_every: int = 4,
    max_blocks: int = 64,
):
    """Re-relax the affected columns and write them back in place.

    `col_idx` [Pb] holds the `n_cols` affected columns, padded to the
    bucket with repeats of col_idx[0] (pad lanes compute real duplicate
    results, so the verdict stays meaningful); `dest_ids` [P] are the
    product's destination node ids; `runner` is the NEW graph's staged
    reverse runner (bands), `maps` its epilogue maps; `epilogue` the
    fused epilogue (the engine's counting front end: K1 on the card).
    The product's dtype selects the distance domain.

    Per column the seed is the old distances with the affected entries
    re-set to INF and the destination re-pinned to 0, the worsening
    upper bound of the warm gates (every kept entry has a surviving old
    shortest path; improvements in the batch only loosen it).  The relax
    (ops.allsources._fused_progressive_banded) runs to its fixed point,
    and the epilogue over the [N, Pb] slab certifies it and re-encodes
    the columns' bits under the NEW slot maps.  Only the first `n_cols`
    lanes are written back, into `dist` and `bitmap` themselves, and only
    when the verdict holds.

    Returns (dist, bitmap, converged host bool, blocks); converged False
    (the block budget ran out, or the uint16 saturation guard tripped)
    leaves the product untouched but NOT certified for this batch."""
    bg = runner.bg
    n = bg.n_nodes
    small = dist.dtype == torch.uint16
    inf, _ = domain(small)
    device = dist.device
    cols = torch.from_numpy(np.asarray(col_idx, dtype=np.int64)).to(device)
    if small:
        d_cols = u16_to_i32(u16_index_select(dist[:n], 1, cols))
    else:
        d_cols = dist[:n].index_select(1, cols)
    init = torch.where(aff.index_select(1, cols), inf, d_cols)
    sub_dest = torch.from_numpy(
        np.asarray(dest_ids, dtype=np.int32)[np.asarray(col_idx)]
    ).to(device)
    d, slab_bits, ok, blocks = _fused_progressive_banded(
        sub_dest, runner, maps, init, n_words, check_every, max_blocks,
        epilogue, small,
    )
    runner.sweeps += blocks * check_every
    if ok:
        real = cols[:n_cols]
        if small:
            dist.view(torch.int16)[:n, real] = d.view(torch.int16)[:, :n_cols]
        else:
            dist[:n, real] = d[:, :n_cols]
        bitmap[:, real] = slab_bits[:, :n_cols]
    return dist, bitmap, ok, blocks


def delta_rows_bitmap(
    bitmap: torch.Tensor,
    dist: torch.Tensor,
    row_idx: np.ndarray,
    n_rows: int,
    out: OutEll,
    f_edge_metric: torch.Tensor,
    f_edge_up: torch.Tensor,
    node_overloaded: torch.Tensor,
    n_words: int,
) -> torch.Tensor:
    """Re-encode the bitmap rows whose out-slot layout changed.

    `row_idx` [Rb] holds the `n_rows` rows, padded to a power of two with
    repeats of row_idx[0]; `out` is the NEW out-edge table; the edge and
    node arrays are the FORWARD mirror's, as tensors on the bitmap's
    device.  The distances are already exact for every column; only the
    bit positions moved.  The LFA-free condition of
    `ecmp_bitmap_from_reverse_dist` (metric(v, u) + dist(u, p) ==
    dist(v, p), an overloaded u only as the destination itself) is
    evaluated for the bucketed row set across all P columns, one out-slot
    at a time, and the real rows are written back into `bitmap` in
    place, which is returned.  In the uint16 mode the metrics are clamped
    to WBIG16 and INF16 marks unreachable."""
    n = bitmap.shape[0]
    small = dist.dtype == torch.uint16
    inf = INF16 if small else INF32
    device = bitmap.device
    rows = np.asarray(row_idx, dtype=np.int64)
    r = torch.from_numpy(rows).to(device)

    def rows_of(index: torch.Tensor) -> torch.Tensor:
        if small:
            return u16_to_i32(u16_index_select(dist[:n], 0, index))
        return dist[:n].index_select(0, index)

    d_self = rows_of(r)  # [Rb, P]
    bits = torch.from_numpy(_BITS).to(device)
    rb, p = d_self.shape
    rows_bm = torch.zeros((rb, p, n_words), dtype=torch.int32, device=device)
    lanes = torch.arange(rb, device=device)
    for k in range(out.nbr.shape[1]):
        eid = torch.from_numpy(out.eid[rows, k].astype(np.int64)).to(device)
        nbr = torch.from_numpy(out.nbr[rows, k].astype(np.int64)).to(device)
        slot = torch.from_numpy(out.slot[rows, k].astype(np.int64)).to(device)
        e0 = eid.clamp(min=0)
        ok = (eid >= 0) & f_edge_up[e0]
        w = f_edge_metric[e0].to(torch.int32)
        if small:
            w = clamp_metric_u16(w)
        d_nbr = rows_of(nbr)
        on = (
            ok[:, None]
            & (d_nbr < inf)
            & (d_nbr + w[:, None] == d_self)
            & (~node_overloaded[nbr][:, None] | (d_nbr == 0))
        )
        bit = torch.where(slot >= 0, bits[slot.clamp(min=0) % 32], 0)
        rows_bm[lanes, :, slot.clamp(min=0) // 32] |= torch.where(on, bit[:, None], 0)
    bitmap[r[:n_rows]] = rows_bm[:n_rows]
    return bitmap
