"""Phase 3 of a blocked Floyd-Warshall round: panel write-back and the
rank-B outer min-plus update.

Counterpart of kernel 2 of `openr_tpu/ops/pallas_kernels.py`
(`blocked_outer_pallas`) and of its XLA twin
`openr_tpu.parallel.blocked.blocked_outer`.  The distance matrix is the
tile tensor dist [S, T, B, T, B] (node g is tile g // B, lane g % B), so
[S, Np, Np] with Np = T * B is a free view of it.  Round k writes the row
panel row_p [S, B, T, B] and the column panel col_p [S, T, B, B] back
into tile k, then applies

    d[i, j] = min(d[i, j], min_m col[i, m] + row[m, j])

over the whole matrix, with the contributions through lane m dropped
where node k * B + m is drained (overloaded).  Distances are int32
tensors holding values in [0, INF32 = 2^30], bit-identical to the
reference's uint32; sums are formed as `minimum(a, INF - b) + b`, which
is min(a + b, INF) without the int32 overflow of INF + INF.

`blocked_outer` updates `dist` in place (the reference donates it) and
returns it: the hand-written CUDA kernel (`csrc/blocked_outer.cu`) for
tensors on a CUDA device, the plain PyTorch version
`blocked_outer_reference` for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load
from .sssp import INF32

# the kernel's shared memory holds a [64, B] and a [B, 64] panel block;
# 256 keeps them within one SM's 227 KB
MAX_TILE = 256


def sat_minplus(a, b):
    """Saturating min-plus term min(a + b, INF32) for int32 a, b in
    [0, INF32]; never overflows int32."""
    return torch.minimum(a, INF32 - b) + b


def _write_back(dist, row_p, col_p, k: int) -> None:
    dist[:, k] = row_p
    dist[:, :, :, k] = col_p


def blocked_outer_reference(dist, row_p, col_p, node_overloaded, k: int):
    """Plain PyTorch phase 3, in place on `dist`: the port of
    `parallel/blocked.blocked_outer` (:246) — panel write-back first (under
    the drain mask the outer product does not subsume the panel
    positions), then the rank-B update one lane m at a time, each lane's
    candidate dropped to INF where lane m of tile k is drained."""
    s, t, b = dist.shape[0], dist.shape[1], dist.shape[2]
    np_ = t * b
    _write_back(dist, row_p, col_p, k)
    d = dist.view(s, np_, np_)
    rm = row_p.reshape(s, b, np_)
    cm = col_p.reshape(s, np_, b)
    ov = node_overloaded[k * b : (k + 1) * b]
    for m in range(b):
        cand = sat_minplus(cm[:, :, m, None], rm[:, None, m, :])
        cand.masked_fill_(ov[m], INF32)
        torch.minimum(d, cand, out=d)
    return dist


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load("blocked_outer")
    lib.blocked_outer_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    )
    lib.blocked_outer_launch.restype = ctypes.c_int
    lib.blocked_outer_error_string.argtypes = [ctypes.c_int]
    lib.blocked_outer_error_string.restype = ctypes.c_char_p
    return lib


def _check_args(dist, row_p, col_p, node_overloaded, k: int) -> None:
    if dist.dim() != 5:
        raise ValueError(f"dist must be [S, T, B, T, B]; got {tuple(dist.shape)}")
    s, t, b, t2, b2 = dist.shape
    if (t2, b2) != (t, b):
        raise ValueError(f"dist must be [S, T, B, T, B]; got {tuple(dist.shape)}")
    want = {
        "row_p": (row_p, (s, b, t, b), torch.int32),
        "col_p": (col_p, (s, t, b, b), torch.int32),
        "dist": (dist, (s, t, b, t, b), torch.int32),
        "node_overloaded": (node_overloaded, (t * b,), torch.bool),
    }
    for name, (x, shape, dtype) in want.items():
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(
                f"blocked_outer: {name} must be {dtype} {shape}; got "
                f"{x.dtype} {tuple(x.shape)}"
            )
        if x.device != dist.device or not x.is_contiguous():
            raise ValueError(
                f"blocked_outer: {name} must be contiguous on {dist.device}"
            )
        if x.data_ptr() % 16:
            raise ValueError(f"blocked_outer: {name} is not 16-byte aligned")
    if b % 4 or not 4 <= b <= MAX_TILE:
        raise ValueError(
            f"blocked_outer: tile B={b} must be a multiple of 4 in "
            f"4..{MAX_TILE}"
        )
    if not 0 <= k < t:
        raise ValueError(f"blocked_outer: round k={k} outside 0..{t - 1}")


def blocked_outer(dist, row_p, col_p, node_overloaded, k: int):
    """Phase 3 of round `k`, in place on `dist` [S, T, B, T, B] int32,
    from the panels row_p [S, B, T, B] and col_p [S, T, B, B] int32 and
    the [T * B] bool drain mask; returns `dist`.  Values must lie in
    [0, 2^30].  Runs the CUDA kernel for CUDA tensors and the plain
    version for CPU tensors."""
    if dist.device.type == "cpu":
        return blocked_outer_reference(dist, row_p, col_p, node_overloaded, k)
    if dist.device.type != "cuda":
        raise ValueError(f"blocked_outer: no kernel for device {dist.device}")
    _check_args(dist, row_p, col_p, node_overloaded, k)
    lib = _library()
    s, t, b = dist.shape[0], dist.shape[1], dist.shape[2]
    with torch.cuda.device(dist.device):
        _write_back(dist, row_p, col_p, k)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.blocked_outer_launch(
            dist.data_ptr(),
            col_p.data_ptr(),
            row_p.data_ptr(),
            node_overloaded.data_ptr() + k * b,
            s,
            t * b,
            b,
            stream,
        )
    if rc != 0:
        msg = lib.blocked_outer_error_string(rc).decode()
        raise RuntimeError(f"blocked_outer kernel launch failed: {msg}")
    blocked_outer.launches += 1
    return dist


blocked_outer.launches = 0
