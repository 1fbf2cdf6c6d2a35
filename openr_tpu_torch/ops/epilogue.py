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

`fused_epilogue` launches the hand-written CUDA kernel
(`csrc/fused_epilogue.cu`) for tensors on a CUDA device and runs the
plain PyTorch version `fused_epilogue_reference` for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ._build import load
from .sssp import INF32, WBIG

# the kernel keeps the bitmap words in registers, at most this many
MAX_WORDS = 8

_BITS = np.array([1 << i for i in range(32)], dtype=np.uint32).view(np.int32)


def build_epilogue_groups(ops, resid_slot, band_slot):
    """(idx, w, ov, slot), each [G, N] int32 and contiguous: one row per
    residual slot k, then one per band, from a banded `_RelaxOps`
    binding and the forward out-slot maps (ops.allsources.EpilogueMaps
    as tensors on the same device)."""
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
    return tuple(
        torch.stack(rows).to(torch.int32).contiguous()
        for rows in (idx_rows, w_rows, ov_rows, slot_rows)
    )


def fused_epilogue_reference(d, idx, w, ov, slot, n_words: int):
    """Plain PyTorch epilogue: (bitmap [N, P, W] int32, converged 0-d bool
    tensor).  Evaluates one group at a time, so one [N, P] candidate is
    alive at a time."""
    n, p = d.shape
    bits = torch.from_numpy(_BITS).to(d.device)
    fin = d < INF32
    vmin = d
    bitmap = torch.zeros((n, p, n_words), dtype=torch.int32, device=d.device)
    for g in range(idx.shape[0]):
        du = d.index_select(0, idx[g])
        wg = w[g][:, None]
        allow = (wg < WBIG) & ((ov[g] == 0)[:, None] | (du == 0))
        cand = torch.where(allow & (du < INF32), du + wg, INF32)
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
    return bitmap, (vmin == d).all()


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load("fused_epilogue")
    lib.fused_epilogue_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    )
    lib.fused_epilogue_launch.restype = ctypes.c_int
    lib.fused_epilogue_error_string.argtypes = [ctypes.c_int]
    lib.fused_epilogue_error_string.restype = ctypes.c_char_p
    return lib


def _check_args(d, tables, n_words: int) -> None:
    n, _ = d.shape
    for t in (d, *tables):
        if t.device != d.device or t.dtype != torch.int32:
            raise ValueError(
                "fused_epilogue takes int32 tensors on one device; got "
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
    if shape[0]:
        idx, _, _, slot = tables
        lo, hi, top = torch.stack(
            [idx.min(), idx.max(), slot.max()]
        ).tolist()
        if lo < 0 or hi >= n or top >= 32 * n_words:
            raise ValueError(
                f"gather index range [{lo}, {hi}] or slot {top} outside "
                f"{n} nodes and {n_words} bitmap words"
            )


def fused_epilogue(d, idx, w, ov, slot, n_words: int):
    """(bitmap [N, P, W] int32, converged 0-d bool tensor) of the epilogue
    over the converged product `d` [N, P] int32 and the group tables
    [G, N] int32 (`build_epilogue_groups`).  Runs the CUDA kernel for
    CUDA tensors and the plain version for CPU tensors."""
    if d.device.type == "cpu":
        return fused_epilogue_reference(d, idx, w, ov, slot, n_words)
    if d.device.type != "cuda":
        raise ValueError(f"fused_epilogue: no kernel for device {d.device}")
    tables = (idx, w, ov, slot)
    _check_args(d, tables, n_words)
    lib = _library()
    n, p = d.shape
    bitmap = torch.empty((n, p, n_words), dtype=torch.int32, device=d.device)
    verdict = torch.ones(1, dtype=torch.int32, device=d.device)
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fused_epilogue_launch(
            *(t.data_ptr() for t in (d, *tables)),
            n,
            p,
            idx.shape[0],
            n_words,
            bitmap.data_ptr(),
            verdict.data_ptr(),
            stream,
        )
    if rc != 0:
        msg = lib.fused_epilogue_error_string(rc).decode()
        raise RuntimeError(f"fused_epilogue kernel launch failed: {msg}")
    fused_epilogue.launches += 1
    return bitmap, verdict[0] != 0


fused_epilogue.launches = 0
