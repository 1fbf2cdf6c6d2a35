"""Reduced-output all-sources SPF: the product route building consumes.

Port of `openr_tpu.ops.allsources`.  Route building reads, per router,
only the distances and ECMP next hops toward the P prefix-originating
nodes; all-sources-to-P-destinations is ONE P-source SSSP on the
reversed graph (dist(v -> p) == reverse-SSSP from p, read at v), and the
bit-packed ECMP next-hop sets of every router follow from the reverse
distances: the reverse in-edges of router v are exactly v's forward
out-edges, so "metric(v, u) + dist(u, p) == dist(v, p)"
(Decision.cpp:1296-1300) is "this reverse relax candidate is tight".

On banded topologies the product runs the progressive banded relax to
its fixed point, optionally warm-started from a proven upper bound
(`init_dist`), and then the fused verify + bitmap epilogue
(ops.epilogue), which reads the [N, P] product once for both the
convergence verdict and the bitmap.  Topologies without bands take the
ELL fallback: the fixed-sweep ELL relax at the runner's adaptive hint,
then `ecmp_bitmap_from_reverse_dist`, which derives the same bitmap from
distances alone (the blocked APSP rung, parallel.blocked, uses it too).

Both paths take the reference's uint16 distance mode whenever the
runner's `small_dist` holds (every metric below 5000): the product is a
torch.uint16 tensor with the INF16 sentinel, half the bytes of int32,
and its verdict includes the saturation guard.  A saturating banded run
latches the mode off and retries once in int32; the ELL path latches
inside `SpfRunner.adapt`.  The reference's explicit fixed-sweep
(`n_sweeps`) and unfused bench paths are not ported.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .banded import BandedGraph, SpfRunner, _RelaxOps, make_dist0_orig
from .epilogue import _BITS, build_epilogue_groups, fused_epilogue
from .sssp import (
    INF16,
    INF32,
    clamp_metric_u16,
    to_u16,
    u16_index_select,
    u16_to_i32,
)


class OutEll(NamedTuple):
    """Per-node out-edge table in original node order (numpy)."""

    nbr: np.ndarray  # [N, K] int32 — out-neighbor node id (pad 0)
    eid: np.ndarray  # [N, K] int32 — directed edge id; -1 pad
    slot: np.ndarray  # [N, K] int32 — rank among the node's sorted unique
    #   out-neighbors (parallel links share a slot); -1 pad
    n_words: int  # ceil(max_slots / 32)


def build_out_ell(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    n_edges: int,
    n_nodes: int,
    out_slot: Optional[np.ndarray] = None,
) -> OutEll:
    """Vectorized out-edge table build.  `out_slot` (per-edge slot ids,
    csr._build_out_slots layout) is recomputed when not supplied.  Slots
    inside [:n_edges] whose endpoints are padding nodes are dropped."""
    src = np.asarray(edge_src[:n_edges], dtype=np.int64)
    dst = np.asarray(edge_dst[:n_edges], dtype=np.int64)
    ids = np.flatnonzero((src < n_nodes) & (dst < n_nodes))
    src, dst = src[ids], dst[ids]
    if out_slot is None:
        from ..decision.csr import _build_out_slots

        live = np.zeros(n_edges, dtype=bool)
        live[ids] = True
        out_slot, _ = _build_out_slots(
            np.asarray(edge_src), np.asarray(edge_dst), n_edges, live=live
        )
    e_slot = np.asarray(out_slot[:n_edges])[ids]
    deg = np.bincount(src, minlength=n_nodes)
    k = int(deg.max()) if ids.size else 1
    k_pad = 1
    while k_pad < max(k, 1):
        k_pad *= 2
    order = np.argsort(src, kind="stable")
    s_sorted = src[order]
    starts = np.searchsorted(s_sorted, np.arange(n_nodes))
    pos = np.arange(len(order)) - starts[s_sorted]
    nbr = np.zeros((n_nodes, k_pad), dtype=np.int32)
    eid = np.full((n_nodes, k_pad), -1, dtype=np.int32)
    slot = np.full((n_nodes, k_pad), -1, dtype=np.int32)
    nbr[s_sorted, pos] = dst[order].astype(np.int32)
    eid[s_sorted, pos] = ids[order].astype(np.int32)
    slot[s_sorted, pos] = e_slot[order]
    max_slots = int(e_slot.max()) + 1 if ids.size else 1
    return OutEll(
        nbr=nbr, eid=eid, slot=slot, n_words=max(1, -(-max_slots // 32))
    )


def ecmp_bitmap_from_reverse_dist(
    drev: torch.Tensor,
    out: OutEll,
    edge_metric,
    edge_up,
    node_overloaded,
    n_words: int,
) -> torch.Tensor:
    """[N, P, W] int32 (uint32 bit patterns): bit s of (v, p) is set iff
    out-slot s of router v is an ECMP next hop toward destination p —
    the LFA-free condition metric(v, u) + dist(u, p) == dist(v, p)
    (Decision.cpp:1296-1300), evaluated fleet-wide from the reverse
    distances `drev` [N*, P] (drev[v, p] = dist(v -> p); N* >= N rows):
    int32 with INF32 unreachable, or a uint16-mode product (torch.uint16,
    INF16 unreachable, metrics clamped to WBIG16 as in the reference's
    uint16 domain).  An overloaded neighbour u is a next hop only as the
    destination itself (d(u, p) == 0), the drain rule of the relax.
    Edge and node arrays are numpy or tensors.

    Plain PyTorch, one out-slot k at a time and only over the routers
    that have a k-th out-edge: each slot's bit is ORed into its word (one
    statement for the reference's single- and multi-word paths), so no
    [N, P, K] or per-slot [N, P, W] temporary exists (a fat-tree spine
    has hundreds of slots, most routers a handful)."""
    n, k_pad = out.nbr.shape
    p = drev.shape[1]
    device = drev.device
    small = drev.dtype == torch.uint16
    inf = INF16 if small else INF32

    def tensor(a, dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    def rows_of(index):
        if small:
            return u16_to_i32(u16_index_select(drev, 0, index))
        return drev.index_select(0, index)

    metric = tensor(edge_metric, torch.int32)
    if small:
        metric = clamp_metric_u16(metric)
    up = tensor(edge_up, torch.bool)
    overloaded = tensor(node_overloaded, torch.bool)
    bits = torch.from_numpy(_BITS).to(device)
    bitmap = torch.zeros((n, p, n_words), dtype=torch.int32, device=device)
    for k in range(k_pad):
        rows = np.flatnonzero(out.eid[:, k] >= 0)
        if rows.size == 0:
            continue
        r = torch.from_numpy(rows).to(device)
        eid = tensor(out.eid[rows, k], torch.int64)
        nbr = tensor(out.nbr[rows, k], torch.int64)
        slot = tensor(out.slot[rows, k], torch.int64)
        d_nbr = rows_of(nbr)  # [R, P]
        on = (
            up[eid][:, None]
            & (d_nbr < inf)
            & (d_nbr + metric[eid][:, None] == rows_of(r))
            & (~overloaded[nbr][:, None] | (d_nbr == 0))
        )
        bit = torch.where(slot >= 0, bits[slot.clamp(min=0) % 32], 0)
        bitmap[r, :, slot.clamp(min=0) // 32] |= torch.where(on, bit[:, None], 0)
    return bitmap


class EpilogueMaps(NamedTuple):
    """Reverse-slot -> forward-out-slot tables for the fused epilogue:
    the reverse residual slot (v, k) with neighbor u and the reverse band
    edge (v-c)%N -> v each correspond to one forward out-edge of v, whose
    ECMP bit position is the rank of that neighbor among v's sorted
    unique out-neighbors (OutEll.slot)."""

    resid_slot: np.ndarray  # [N, K] int32 — forward out-slot; -1 pad
    band_slot: np.ndarray  # [B, N] int32 — forward out-slot; -1 no edge


def build_epilogue_maps(bg: BandedGraph, out: OutEll) -> EpilogueMaps:
    """Map every reverse-graph relax slot to the forward out-slot bit it
    certifies.  Parallel forward links share a slot and their reverse
    counterparts occupy distinct residual slots (build_banded demotes
    band duplicates), so every candidate lands on the right bit."""
    nbr, eid, slot = out.nbr, out.eid, out.slot
    n = bg.n_nodes

    def rank(u_row: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """Forward out-slot of edge v -> u_row[v]; -1 where invalid."""
        m = (nbr[:n] == u_row[:, None]) & (eid[:n] >= 0)
        s = np.where(m, slot[:n], -1).max(axis=1)
        return np.where(valid, s, -1).astype(np.int32)

    rn, re_ = bg.resid_nbr, bg.resid_eid
    resid_slot = np.stack(
        [rank(rn[:, k], re_[:, k] >= 0) for k in range(rn.shape[1])],
        axis=1,
    )
    ids = np.arange(n, dtype=np.int64)
    band_slot = np.stack(
        [
            rank(((ids - c) % n).astype(np.int32), bg.band_eid[b] >= 0)
            for b, c in enumerate(bg.offsets)
        ]
    )
    return EpilogueMaps(resid_slot=resid_slot, band_slot=band_slot)


def _fused_progressive_banded(
    dest_ids: torch.Tensor,
    runner: SpfRunner,
    maps: EpilogueMaps,
    init_dist: Optional[torch.Tensor],
    n_words: int,
    check_every: int,
    max_blocks: int,
    epilogue: Callable,
    small_dist: bool,
):
    """Relax to the fixed point, then the fused verify + bitmap epilogue.
    Returns (dist [N, P], bitmap [N, P, W] int32, converged host bool,
    blocks run).  dist is int32 / INF32, or with `small_dist` the
    torch.uint16 product of the uint16 mode: the relax runs in int32
    over the 16-bit domain and the product is narrowed once, at the
    fixed point, for the epilogue (whose verdict then includes the
    saturation guard) and the view.  `init_dist` [N*, P] of either dtype
    warm-starts the relax: d0 is its elementwise min with the cold dist0
    (sources re-pinned to 0), after conversion to the run's domain.

    The relax runs blocks of `check_every` supersweeps with one host read
    per block (the block's last supersweep left d unchanged), at most
    `max_blocks` blocks.  The epilogue re-evaluates every exact relax
    candidate once; its verdict is the authoritative fixed-point check,
    and bits are meaningful only when it holds."""
    bg = runner.bg
    st = runner.call_arrays()
    ops = _RelaxOps(
        bg,
        st,
        0 if runner.chord_mode else runner.depth,
        runner.resid_rounds,
        runner.chord_mode,
        small_dist,
    )
    d = make_dist0_orig(dest_ids, bg.n_nodes, small_dist)
    if init_dist is not None:
        init = init_dist[: bg.n_nodes]
        if init.dtype == torch.uint16:
            init = u16_to_i32(init)
            if not small_dist:
                init = torch.where(init >= INF16, INF32, init)
        elif small_dist:
            init = init.clamp(max=INF16)
        d = torch.minimum(d, init)
    blocks = 0
    converged = False
    while not converged and blocks < max_blocks:
        for _ in range(check_every - 1):
            d = ops.supersweep(d)
        v = ops.supersweep(d)
        converged = torch.equal(v, d)
        d = v
        blocks += 1
    if small_dist:
        d = to_u16(d)
    device = d.device
    groups = build_epilogue_groups(
        ops,
        torch.from_numpy(maps.resid_slot).to(device),
        torch.from_numpy(maps.band_slot).to(device),
        n_words,
    )
    bitmap, ok = epilogue(d, *groups, n_words)
    return d, bitmap, bool(ok), blocks


def reduced_all_sources(
    dest_ids,
    reverse_runner: SpfRunner,
    out: OutEll,
    edge_metric,
    edge_up,
    node_overloaded,
    init_dist: Optional[torch.Tensor] = None,
    maps: Optional[EpilogueMaps] = None,
    check_every: int = 4,
    max_blocks: int = 64,
    epilogue: Optional[Callable] = None,
):
    """Fleet-wide route-building input: (dist [N*, P] tensor —
    dist[v, p] = dist(v -> dest p); nh_bitmap [N, P, W] int32 tensor of
    uint32 bit patterns; converged host bool), on the device the reverse
    runner is staged on.  dist is torch.uint16 with the INF16 sentinel
    when the run took the uint16 mode (the runner's `small_dist`), else
    int32 with INF32 unreachable; consumers key on dtype, as the
    reference's do.  N* is N on the banded path and N_cap (the node
    capacity, original ids) on the ELL path; rows past N are padding.

    `reverse_runner` is an ops.banded.SpfRunner over the REVERSED edges,
    staged.  `edge_metric`, `edge_up` and `node_overloaded` are the
    FORWARD graph's runtime arrays (numpy), which the ELL path's bitmap
    reads.

    Banded: the progressive relax and the fused epilogue.  `maps`
    (build_epilogue_maps) is built here when not supplied; `epilogue`
    defaults to ops.epilogue.fused_epilogue (the engine passes its
    counting front-end).  `init_dist` warm-starts the relax from a
    caller-proven elementwise upper bound (decision.fleet's gates); a
    converged warm round equals the cold one.  Only a converged COLD run
    teaches the runner's fixed-sweep hint: blocks * check_every
    supersweeps (warm runs converge in delta-sized counts).  A banded
    run in the uint16 mode whose verdict fails (saturation shows as
    non-convergence) latches the runner's `small_allowed` off and
    retries once in int32, from the same `init_dist`.

    Without bands: the fixed-sweep ELL relax through
    `SpfRunner.adapt` (run at the hint, double on a False verdict,
    refine down, latch the uint16 mode off on a failed run at 32 sweeps
    or more), then the bitmap from the converged distances, so a failed
    attempt never pays a bitmap pass.  It always cold-starts:
    `init_dist` is refused there."""
    st = reverse_runner.call_arrays()
    dest = torch.as_tensor(
        np.asarray(dest_ids, dtype=np.int32), device=st.edge_metric.device
    )
    if reverse_runner.bg is None:
        if init_dist is not None:
            raise ValueError("the ELL fallback does not warm-start")

        def attempt(sweeps: int):
            dist, _, ok = reverse_runner.run_once(dest, sweeps, raw_u16=True)
            return dist, ok

        dist = reverse_runner.adapt(
            "hint",
            attempt,
            probe=lambda sweeps: attempt(sweeps)[1],
            eff_small=lambda: reverse_runner.small_dist,
        )
        bitmap = ecmp_bitmap_from_reverse_dist(
            dist, out, edge_metric, edge_up, node_overloaded, out.n_words
        )
        return dist, bitmap, True
    if maps is None:
        maps = build_epilogue_maps(reverse_runner.bg, out)

    def run(small_dist: bool):
        result = _fused_progressive_banded(
            dest,
            reverse_runner,
            maps,
            init_dist,
            out.n_words,
            check_every,
            max_blocks,
            epilogue if epilogue is not None else fused_epilogue,
            small_dist,
        )
        reverse_runner.sweeps += result[3] * check_every
        return result

    small = reverse_runner.small_dist
    dist, bitmap, ok, blocks = run(small)
    if small and not ok:
        reverse_runner.small_allowed = False
        dist, bitmap, ok, blocks = run(False)
    if ok and init_dist is None:
        reverse_runner.hint = max(1, blocks * check_every)
    return dist, bitmap, ok
