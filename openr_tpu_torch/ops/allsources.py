"""Reduced-output all-sources SPF: the product route building consumes.

Port of `openr_tpu.ops.allsources`.  Route building reads, per router,
only the distances and ECMP next hops toward the P prefix-originating
nodes; all-sources-to-P-destinations is ONE P-source SSSP on the
reversed graph (dist(v -> p) == reverse-SSSP from p, read at v), and the
bit-packed ECMP next-hop sets of every router follow from the reverse
distances: the reverse in-edges of router v are exactly v's forward
out-edges, so "metric(v, u) + dist(u, p) == dist(v, p)"
(Decision.cpp:1296-1300) is "this reverse relax candidate is tight".

The fast path runs the progressive banded relax to its fixed point and
then the fused verify + bitmap epilogue (ops.epilogue), which reads the
[N, P] product once for both the convergence verdict and the bitmap.
The ELL fallback for topologies without bands, the fixed-sweep
(`n_sweeps`) and unfused paths and warm starts come in later slices.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .banded import BandedGraph, SpfRunner, _RelaxOps, make_dist0_orig
from .epilogue import build_epilogue_groups, fused_epilogue


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
    n_words: int,
    check_every: int,
    max_blocks: int,
    epilogue: Callable,
):
    """Relax to the fixed point, then the fused verify + bitmap epilogue.
    Returns (dist [N, P] int32, bitmap [N, P, W] int32, converged host
    bool, blocks run).

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
    )
    d = make_dist0_orig(dest_ids, bg.n_nodes)
    blocks = 0
    converged = False
    while not converged and blocks < max_blocks:
        for _ in range(check_every - 1):
            d = ops.supersweep(d)
        v = ops.supersweep(d)
        converged = torch.equal(v, d)
        d = v
        blocks += 1
    device = d.device
    groups = build_epilogue_groups(
        ops,
        torch.from_numpy(maps.resid_slot).to(device),
        torch.from_numpy(maps.band_slot).to(device),
    )
    bitmap, ok = epilogue(d, *groups, n_words)
    return d, bitmap, bool(ok), blocks


def reduced_all_sources(
    dest_ids,
    reverse_runner: SpfRunner,
    out: OutEll,
    maps: Optional[EpilogueMaps] = None,
    check_every: int = 4,
    max_blocks: int = 64,
    epilogue: Optional[Callable] = None,
):
    """Fleet-wide route-building input: (dist [N, P] int32 tensor —
    dist[v, p] = dist(v -> dest p), INF32 unreachable; nh_bitmap
    [N, P, W] int32 tensor of uint32 bit patterns; converged host bool),
    on the device the reverse runner is staged on.

    `reverse_runner` is an ops.banded.SpfRunner over the REVERSED edges,
    staged.  `maps` (build_epilogue_maps) is built here when not
    supplied.  `epilogue` defaults to ops.epilogue.fused_epilogue; the
    engine passes its counting front-end.  A converged run teaches the
    runner's fixed-sweep hint: blocks * check_every supersweeps are a
    proven-sufficient budget for this (topology, dest-set) shape."""
    if reverse_runner.bg is None:
        raise NotImplementedError(
            "topology has no banded decomposition: the ELL fallback of the "
            "fleet product comes in a later slice of the port"
        )
    if maps is None:
        maps = build_epilogue_maps(reverse_runner.bg, out)
    st = reverse_runner.call_arrays()
    dest = torch.as_tensor(
        np.asarray(dest_ids, dtype=np.int32), device=st.edge_metric.device
    )
    dist, bitmap, ok, blocks = _fused_progressive_banded(
        dest,
        reverse_runner,
        maps,
        out.n_words,
        check_every,
        max_blocks,
        epilogue if epilogue is not None else fused_epilogue,
    )
    if ok:
        reverse_runner.hint = max(1, blocks * check_every)
    return dist, bitmap, ok
