"""The fused verify + ECMP-bitmap epilogue of the fleet product.

Counterpart of kernel 1 of `openr_tpu/ops/pallas_kernels.py`
(`fused_epilogue` / `fused_epilogue_pallas`).  After the progressive
relax reaches its fixed point, one pass re-evaluates every exact relax
candidate once and uses it both for the convergence verdict (min) and
for the ECMP bit (candidate == distance, finite).  Every relax group —
a residual slot k, or a band of offset c written as the gather
(v - c) mod N — is normalized to one uniform row quadruple
(gather index, clamped weight, overloaded predecessor, forward
out-slot), which makes bands and residual slots the same statement.

Two variants, by the product's dtype: int32 (INF32, WBIG) and the
reference's uint16 distance mode (`fused_epilogue_pallas` with a uint16
`d`: INF16, WBIG16, weights clamped to WBIG16 by the relax binding that
built the tables).  The uint16 variant's verdict also holds the
saturation guard (`ops.sssp.u16_saturation_verdict`), which the
reference applies beside its kernel: the kernel reads every distance
anyway, so the guard costs one compare per element.

`fused_epilogue` launches the hand-written CUDA kernels
(`csrc/fused_epilogue.cu`) for tensors on a CUDA device and runs the
plain PyTorch version `fused_epilogue_reference` for tensors on the CPU.
Each variant has a kernel of its own, tiled by the plain function
`epilogue_plan`, which the CPU tests reach: int32 takes the tiled design
(column slabs sized to the L2 cache, node tiles with a halo of
neighbouring rows in shared memory, derived table entries); uint16 the
packed design (two columns per 32-bit register, each block's table
entries staged in shared memory, every gathered row read into
registers), on its wide path for P > NARROW_P (L2-sized slabs) and on
its narrow path otherwise (one slab, one launch).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..device.sanitizer import fetch, stage
from ._build import load
from .sssp import domain, u16_saturation_verdict, u16_to_i32

# the kernel keeps the bitmap words in registers, at most this many
MAX_WORDS = 8
# rows staged on each side of a node tile: band groups whose offset c has
# c <= HALO or N - c <= HALO read their gather rows from shared memory
HALO = 8
# slab widths the kernels take, widest first; an int32 block covers
# TILE_ELEMS // slab nodes of one slab
SLAB_WIDTHS = (256, 128, 64, 32)
TILE_ELEMS = 4096
# the int32 kernel's group chunk, its table entry size, and the shared
# memory a plan aims to stay under (several blocks per SM)
CHUNK = 2
ENTRY_BYTES = 16
SMEM_BUDGET = 96 * 1024
MIN_TILE = 16
# the uint16 kernel: products of at most NARROW_P columns take the narrow
# path; threads per block, columns per thread, and the shared memory of a
# block's table entries (8 bytes per node and group) a plan stays under
NARROW_P = 64
THREADS = 256
U16_COLS = 8
U16_ENTRY_BYTES = 8
U16_SMEM_BUDGET = 96 * 1024
# passes of the block's threads over a wide tile (its node rows)
U16_WIDE_PASSES = 4

_BITS = np.array([1 << i for i in range(32)], dtype=np.uint32).view(np.int32)


def build_epilogue_groups(ops, resid_slot, band_slot, n_words: int):
    """(idx, w, ov, slot), each [G, N] int32 and contiguous: one row per
    residual slot k, then one per band, from a banded `_RelaxOps`
    binding and the forward out-slot maps (ops.allsources.EpilogueMaps
    as tensors on the same device).  The tables are range-checked here,
    once per build, for `n_words` bitmap words (check_epilogue_groups)."""
    n = ops.n
    device = ops.rw.device
    ids = torch.arange(n, dtype=torch.int32, device=device)
    idx_rows, w_rows, ov_rows, slot_rows = [], [], [], []
    for k in range(ops.n_resid):
        idx_rows.append(ops.resid_nbr[:, k])
        w_rows.append(ops.rw[:, k])
        ov_rows.append(ops.rov[:, k])
        slot_rows.append(resid_slot[:, k])
    for b, c in enumerate(ops.bg.offsets):
        w0, ovb, _ = ops.band_tabs[b]
        # roll(d, c)[v] == d[(v - c) mod N]: the band relax as a gather
        idx_rows.append(torch.remainder(ids - c, n))
        w_rows.append(w0[:, 0])
        ov_rows.append(ovb[:, 0])
        slot_rows.append(band_slot[b])
    groups = tuple(
        torch.stack(rows).to(torch.int32).contiguous()
        for rows in (idx_rows, w_rows, ov_rows, slot_rows)
    )
    check_epilogue_groups(groups, n, n_words)
    return groups


def check_epilogue_groups(groups, n: int, n_words: int) -> None:
    """Raise ValueError unless every gather index lies in [0, n) and every
    out-slot below 32 * n_words.  Reads three reductions back to the
    host, so it runs where the tables are built, not per launch."""
    idx, _, _, slot = groups
    if not idx.numel():
        return
    lo, hi, top = fetch(
        torch.stack([idx.min(), idx.max(), slot.max()]), "table ranges"
    ).tolist()
    if lo < 0 or hi >= n or top >= 32 * n_words:
        raise ValueError(
            f"gather index range [{lo}, {hi}] or slot {top} outside "
            f"{n} nodes and {n_words} bitmap words"
        )


class EpiloguePlan(NamedTuple):
    """A kernel's tiling: column slab width, node tile, halo rows, and the
    band offsets it serves from the halo or gathers from L2; the path
    ("tiled" for int32, "wide" or "narrow" for uint16)."""

    slab_cols: int
    node_tile: int
    halo: int
    halo_bands: tuple
    far_bands: tuple
    path: str = "tiled"


def plan_smem_bytes(node_tile: int, slab_cols: int, halo: int, n_groups: int) -> int:
    """Shared memory of one int32 block: two stages (the next item's
    copies land while this one computes), each the tile's [G, tile] table
    entries, groups padded to a chunk, and the [tile + 2 halo, slab]
    window of d."""
    gpad = -(-n_groups // CHUNK) * CHUNK
    window = (node_tile + 2 * halo) * slab_cols * 4
    return 2 * (gpad * node_tile * ENTRY_BYTES + window)


def u16_smem_bytes(node_tile: int, n_groups: int) -> int:
    """Shared memory of one uint16 block: the table entries of its node
    tile, U16_ENTRY_BYTES per node and group."""
    return n_groups * node_tile * U16_ENTRY_BYTES


def _slab(n: int, p: int, l2_bytes: int, elem_bytes: int) -> int:
    """The widest slab of SLAB_WIDTHS no wider than p needs (a power of
    two from 32) whose n x slab elements fill at most half of
    `l2_bytes`; the narrowest when none fits."""
    need = 32
    while need < min(p, SLAB_WIDTHS[0]):
        need *= 2
    return next(
        (
            c
            for c in SLAB_WIDTHS
            if c <= need and n * c * elem_bytes <= l2_bytes // 2
        ),
        SLAB_WIDTHS[-1],
    )


def _bands(n: int, band_offsets: tuple, halo: int) -> tuple:
    """(halo bands, far bands): a band of offset c is served from a halo
    of `halo` rows when c <= halo or n - c <= halo."""
    near = tuple(c for c in band_offsets if c <= halo or n - c <= halo)
    return near, tuple(c for c in band_offsets if c not in near)


def epilogue_plan(n: int, p: int, band_offsets: tuple, l2_bytes: int,
                  n_groups: int = 0, elem_bytes: int = 4) -> EpiloguePlan:
    """The tiling of the epilogue kernel for an [n, p] product of
    `elem_bytes` per distance: 4 for int32 (`tiled_plan`), 2 for uint16
    (`u16_plan`)."""
    if elem_bytes == 2:
        return u16_plan(n, p, band_offsets, l2_bytes, n_groups)
    return tiled_plan(n, p, band_offsets, l2_bytes, n_groups)


def tiled_plan(n: int, p: int, band_offsets: tuple, l2_bytes: int,
               n_groups: int = 0) -> EpiloguePlan:
    """The int32 kernel's tiling.  The slab is the widest power of two
    from 32 to 256 whose column slab (n x slab int32) fills at most half
    of `l2_bytes`, and no wider than p needs; 32 when none fits.  The node
    tile covers TILE_ELEMS elements of the slab, halved (down to
    MIN_TILE, then the slab too) while a block with `n_groups` groups
    would need more than SMEM_BUDGET of shared memory."""
    slab = _slab(n, p, l2_bytes, 4)

    def smem(tile, slab):
        return plan_smem_bytes(tile, slab, HALO, n_groups)

    tile = TILE_ELEMS // slab
    while tile > MIN_TILE and smem(tile, slab) > SMEM_BUDGET:
        tile //= 2
    while slab > SLAB_WIDTHS[-1] and smem(tile, slab) > SMEM_BUDGET:
        slab //= 2
    return EpiloguePlan(slab, tile, HALO, *_bands(n, band_offsets, HALO))


def u16_plan(n: int, p: int, band_offsets: tuple, l2_bytes: int,
             n_groups: int = 0) -> EpiloguePlan:
    """The uint16 kernel's path and tiling.  Each thread owns U16_COLS
    columns of a node row, `lanes` = slab / U16_COLS threads a row.

    Narrow (p <= NARROW_P): one slab of the least power of two of lanes
    that covers p, one pass of THREADS threads per block (THREADS // lanes
    nodes).  Wide (p > NARROW_P): the slab of the int32 rule at 2 bytes
    per element (for wan100k 128 columns, 25.6 MB), U16_WIDE_PASSES passes
    per block (64 nodes at 128 columns).  Either tile is halved while the
    block's table entries of `n_groups` groups would need more than
    U16_SMEM_BUDGET.  No window: every gather row, bands included, comes
    from L1 or L2."""
    if p <= NARROW_P:
        lanes = 1
        while lanes * U16_COLS < p:
            lanes *= 2
        slab, tile, path = lanes * U16_COLS, THREADS // lanes, "narrow"
    else:
        slab = _slab(n, p, l2_bytes, 2)
        tile = U16_WIDE_PASSES * THREADS * U16_COLS // slab
        path = "wide"
    while tile > 1 and u16_smem_bytes(tile, n_groups) > U16_SMEM_BUDGET:
        tile //= 2
    return EpiloguePlan(slab, tile, 0, (), tuple(band_offsets), path)


def epilogue_traffic(idx: np.ndarray, w: np.ndarray, p: int, plan: EpiloguePlan,
                     small_dist: bool = False) -> dict:
    """What the kernel's data needs, from host copies of the [G, N]
    tables: the active (node, group) pairs (w below the variant's WBIG),
    and the gathers whose row falls outside the block's window (every
    gather on a plan without one), which the kernel reads from global
    memory (L2 or device memory) on top of the compulsory bytes."""
    g, n = idx.shape
    v = np.arange(n, dtype=np.int64)
    v0 = v // plan.node_tile * plan.node_tile
    r = (idx.astype(np.int64) - v0 + plan.halo) % n
    active = w < domain(small_dist)[1]
    far = active
    if plan.halo:
        far = active & (r >= plan.node_tile + 2 * plan.halo)
    return {
        "active_pairs": int(active.sum()),
        "gather_bytes": int(far.sum()) * p * (2 if small_dist else 4),
    }


def fused_epilogue_reference(d, idx, w, ov, slot, n_words: int):
    """Plain PyTorch epilogue: (bitmap [N, P, W] int32, converged 0-d bool
    tensor).  Evaluates one group at a time, so one [N, P] candidate is
    alive at a time.  A uint16 `d` is widened to int32 and evaluated with
    INF16 and WBIG16; its verdict also holds the saturation guard."""
    small = d.dtype == torch.uint16
    if small:
        d = u16_to_i32(d)
    inf, wbig = domain(small)
    n, p = d.shape
    bits = stage(_BITS, d.device)
    fin = d < inf
    vmin = d
    bitmap = torch.zeros((n, p, n_words), dtype=torch.int32, device=d.device)
    for g in range(idx.shape[0]):
        du = d.index_select(0, idx[g])
        wg = w[g][:, None]
        allow = (wg < wbig) & ((ov[g] == 0)[:, None] | (du == 0))
        cand = torch.where(allow & (du < inf), du + wg, inf)
        on = fin & (cand == d)
        sg = slot[g]
        bit = torch.where(
            sg >= 0, bits.index_select(0, sg.clamp(min=0) % 32), 0
        )[:, None]
        word = sg.clamp(min=0) // 32
        for wi in range(n_words):
            hit = on & (word == wi)[:, None]
            bitmap[:, :, wi] |= torch.where(hit, bit, 0)
        vmin = torch.minimum(vmin, cand)
    converged = (vmin == d).all()
    if small:
        converged = u16_saturation_verdict(d, converged)
    return bitmap, converged


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load("fused_epilogue")
    lib.fused_epilogue_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 4
    )
    lib.fused_epilogue_launch.restype = ctypes.c_int
    lib.fused_epilogue_u16_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3
    )
    lib.fused_epilogue_u16_launch.restype = ctypes.c_int
    lib.fused_epilogue_scratch_bytes.argtypes = [ctypes.c_int] * 3
    lib.fused_epilogue_scratch_bytes.restype = ctypes.c_longlong
    lib.fused_epilogue_l2_bytes.argtypes = [ctypes.c_int]
    lib.fused_epilogue_l2_bytes.restype = ctypes.c_longlong
    lib.fused_epilogue_error_string.argtypes = [ctypes.c_int]
    lib.fused_epilogue_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def l2_bytes(device_index: int) -> int:
    """The L2 cache size of CUDA device `device_index`, as the CUDA runtime
    reports it."""
    size = _library().fused_epilogue_l2_bytes(device_index)
    if size <= 0:
        raise RuntimeError(f"cannot read the L2 size of cuda:{device_index}")
    return size


def _check_args(d, tables, n_words: int) -> None:
    """Host-side checks only (no device read): dtype (d int32 or uint16,
    the tables int32), device, shape, contiguity and n_words; the
    tables' value ranges are checked where they are built
    (check_epilogue_groups).  Any P is taken: a ragged row (P not a
    multiple of 8) runs the kernels' scalar paths, which read no column
    past P."""
    if d.dtype not in (torch.int32, torch.uint16):
        raise ValueError(f"fused_epilogue takes an int32 or uint16 d; got {d.dtype}")
    n, _ = d.shape
    for t in (d, *tables):
        if t.device != d.device or (t is not d and t.dtype != torch.int32):
            raise ValueError(
                "fused_epilogue takes int32 tables on d's device; got "
                f"{t.dtype} on {t.device} beside {d.dtype} on {d.device}"
            )
        if not t.is_contiguous():
            raise ValueError("fused_epilogue takes contiguous tensors")
    shape = tables[0].shape
    if len(shape) != 2 or shape[1] != n or any(t.shape != shape for t in tables):
        raise ValueError(
            f"group tables must all be [G, {n}]; got "
            f"{[tuple(t.shape) for t in tables]}"
        )
    if not 1 <= n_words <= MAX_WORDS:
        raise ValueError(f"n_words={n_words} outside 1..{MAX_WORDS}")


def fused_epilogue(d, idx, w, ov, slot, n_words: int, plan=None):
    """(bitmap [N, P, W] int32, converged 0-d bool tensor) of the epilogue
    over the converged product `d` [N, P] and the group tables [G, N]
    int32 (`build_epilogue_groups`, whose range check the kernel relies
    on).  `d` is int32 on the domain [0, INF32], or torch.uint16 on
    [0, INF16] (the uint16 variant, whose verdict holds the saturation
    guard); weights are >= 0.  Every product of the relax lies in its
    domain.  Runs the variant's CUDA kernel for CUDA tensors, tiled by
    `plan` (default: `epilogue_plan` for the card's L2 and d's element
    size; a uint16 product takes a "wide" or "narrow" plan, int32 a
    "tiled" one), with no host sync, and the plain version for CPU
    tensors.  Each launch counts in `launches` and in `variant_launches`
    under d's dtype name."""
    if d.device.type == "cpu":
        return fused_epilogue_reference(d, idx, w, ov, slot, n_words)
    if d.device.type != "cuda":
        raise ValueError(f"fused_epilogue: no kernel for device {d.device}")
    tables = (idx, w, ov, slot)
    _check_args(d, tables, n_words)
    lib = _library()
    n, p = d.shape
    g = idx.shape[0]
    small = d.dtype == torch.uint16
    if plan is None:
        plan = epilogue_plan(
            n, p, (), l2_bytes(d.device.index), g, d.element_size()
        )
    if (plan.path != "tiled") != small:
        raise ValueError(f"a {plan.path} plan does not tile a {d.dtype} product")
    bitmap = torch.empty((n, p, n_words), dtype=torch.int32, device=d.device)
    verdict = torch.ones(1, dtype=torch.int32, device=d.device)
    pointers = [t.data_ptr() for t in (d, *tables)]
    # the launch goes to the current device: switch only when d lies elsewhere
    current = d.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if current else torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        if small:
            rc = lib.fused_epilogue_u16_launch(
                *pointers, n, p, g, n_words, plan.slab_cols, plan.node_tile,
                bitmap.data_ptr(), verdict.data_ptr(), stream,
            )
        else:
            # the derived table entries of every node tile, written by the launch
            scratch = torch.empty(
                lib.fused_epilogue_scratch_bytes(n, g, plan.node_tile) // 4,
                dtype=torch.int32,
                device=d.device,
            )
            rc = lib.fused_epilogue_launch(
                *pointers, n, p, g, n_words, plan.slab_cols, plan.node_tile,
                plan.halo, bitmap.data_ptr(), verdict.data_ptr(),
                scratch.data_ptr(), stream,
            )
    if rc != 0:
        msg = lib.fused_epilogue_error_string(rc).decode()
        raise RuntimeError(f"fused_epilogue kernel launch failed: {msg}")
    fused_epilogue.launches += 1
    fused_epilogue.variant_launches[variant_name(d.dtype)] += 1
    # the verdict's low byte as a 0-d bool view: no kernel to compare it
    return bitmap, verdict.view(torch.bool)[0]


def variant_name(dtype: torch.dtype) -> str:
    """The epilogue variant a product of `dtype` takes: "int32" or "uint16"."""
    return "uint16" if dtype == torch.uint16 else "int32"


fused_epilogue.launches = 0
fused_epilogue.variant_launches = {"int32": 0, "uint16": 0}
