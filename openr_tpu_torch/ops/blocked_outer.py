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

On a device mesh (parallel.blocked, sharded) each shard of the tile
tensor is its own rectangle [S, T * Br, T * Bc], updated by one launch
from the panels' rows and columns of that shard (`lanes`).

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


def _write_back(dist, row_p, col_p, k: int, lanes) -> None:
    r0, c0 = lanes
    dist[:, k] = row_p[:, r0 : r0 + dist.shape[2]]
    dist[:, :, :, k] = col_p[..., c0 : c0 + dist.shape[4]]


def blocked_outer_reference(
    dist, row_p, col_p, node_overloaded, k: int, lanes=(0, 0)
):
    """Plain PyTorch phase 3, in place on `dist`: the port of
    `parallel/blocked.blocked_outer` (:246) — panel write-back first (under
    the drain mask the outer product does not subsume the panel
    positions), then the rank-B update one lane m at a time, each lane's
    candidate dropped to INF where lane m of tile k is drained.

    `dist` may be one shard [S, T, Br, T, Bc] of a tile tensor sharded
    over a ("batch", "row", "col") mesh: `row_p` [S, B, T, Bc] then holds
    the row panel's columns of the shard and every lane of tile k,
    `col_p` [S, T, Br, B] the column panel's rows of the shard, and
    `lanes` = (r0, c0) the shard's first row lane and first column lane
    within a tile, where its slices of the panels are written back."""
    s, t, br, bc = dist.shape[0], dist.shape[1], dist.shape[2], dist.shape[4]
    b = row_p.shape[1]
    mr, mc = t * br, t * bc
    _write_back(dist, row_p, col_p, k, lanes)
    d = dist.view(s, mr, mc)
    rm = row_p.reshape(s, b, mc)
    cm = col_p.reshape(s, mr, b)
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
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    lib.blocked_outer_launch.restype = ctypes.c_int
    lib.blocked_outer_error_string.argtypes = [ctypes.c_int]
    lib.blocked_outer_error_string.restype = ctypes.c_char_p
    return lib


def _check_args(dist, row_p, col_p, node_overloaded, k: int, lanes) -> None:
    if dist.dim() != 5 or dist.shape[1] != dist.shape[3]:
        raise ValueError(
            f"dist must be [S, T, Br, T, Bc]; got {tuple(dist.shape)}"
        )
    s, t, br, _, bc = dist.shape
    b = row_p.shape[1] if row_p.dim() == 4 else -1
    want = {
        "row_p": (row_p, (s, b, t, bc), torch.int32),
        "col_p": (col_p, (s, t, br, b), torch.int32),
        "dist": (dist, (s, t, br, t, bc), torch.int32),
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
    if not 1 <= b <= MAX_TILE:
        raise ValueError(f"blocked_outer: tile B={b} outside 1..{MAX_TILE}")
    r0, c0 = lanes
    if not (0 <= r0 <= b - br and 0 <= c0 <= b - bc):
        raise ValueError(
            f"blocked_outer: shard lanes {tuple(lanes)} of widths "
            f"({br}, {bc}) outside the tile of {b} lanes"
        )
    if not 0 <= k < t:
        raise ValueError(f"blocked_outer: round k={k} outside 0..{t - 1}")


def blocked_outer(dist, row_p, col_p, node_overloaded, k: int, lanes=(0, 0)):
    """Phase 3 of round `k`, in place on `dist` [S, T, Br, T, Bc] int32 (the
    whole tile tensor, Br = Bc = B, or one shard of it: see
    `blocked_outer_reference`), from the panels row_p [S, B, T, Bc] and
    col_p [S, T, Br, B] int32 and the [T * B] bool drain mask; returns
    `dist`.  Values must lie in [0, 2^30].  Runs the CUDA kernel for CUDA
    tensors and the plain version for CPU tensors."""
    if dist.device.type == "cpu":
        return blocked_outer_reference(
            dist, row_p, col_p, node_overloaded, k, lanes
        )
    if dist.device.type != "cuda":
        raise ValueError(f"blocked_outer: no kernel for device {dist.device}")
    _check_args(dist, row_p, col_p, node_overloaded, k, lanes)
    lib = _library()
    s, t, br, bc = dist.shape[0], dist.shape[1], dist.shape[2], dist.shape[4]
    b = row_p.shape[1]
    with torch.cuda.device(dist.device):
        _write_back(dist, row_p, col_p, k, lanes)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.blocked_outer_launch(
            dist.data_ptr(),
            col_p.data_ptr(),
            row_p.data_ptr(),
            node_overloaded.data_ptr() + k * b,
            s,
            t * br,
            t * bc,
            b,
            stream,
        )
    if rc != 0:
        msg = lib.blocked_outer_error_string(rc).decode()
        raise RuntimeError(f"blocked_outer kernel launch failed: {msg}")
    blocked_outer.launches += 1
    return dist


blocked_outer.launches = 0
