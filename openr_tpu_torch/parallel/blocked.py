"""Blocked min-plus APSP on one device: the third dispatch rung of the
fleet view.

Single-device port of `openr_tpu.parallel.blocked`.  The padded Np x Np
distance matrix is held as the tile tensor dist [S, T, B, T, B] (node g
is tile g // B, lane g % B; Np = T * B), and each of the T rounds k runs
the classic three phases of blocked Floyd-Warshall:

    phase 1 (diag):   closed = FW(dist[k][k])
    phase 2 (panels): row' = min(row, closed (*) row)
                      col' = min(col, col (*) closed)
    phase 3 (outer):  dist[k] <- row'; dist[:, :, k] <- col'
                      dist = min(dist, col' (*) row')   rank-B update

where (*) is the min-plus product masked at the intermediate: a
contribution through a drained (overloaded) node is dropped, which is
the fleet drain rule (an overloaded node relays nothing but stays a
valid endpoint).  Phases 1 and 2 are plain PyTorch on [S, B, B] and
[S, B, Np] panels; phase 3 is kernel K2 (`ops.blocked_outer`), which
updates the matrix in place.  Distances are int32 tensors holding values
in [0, INF32 = 2^30], bit-identical to the reference's saturating
uint32; sums are `minimum(a, INF - b) + b`.

The ECMP bitmap of the product is `ops.allsources.
ecmp_bitmap_from_reverse_dist`, called directly (the reference's
`_blocked_bitmap` is only its jit wrapper).

This module runs the reference's bulk-synchronous round loop
(`_rounds_bulk`).  The reference's lookahead-pipelined loop
(`blocked_round_pipelined`) only reorders compute on one device and is
bit-identical to the bulk loop there; it, the device mesh
(`make_blocked_mesh`, `OPENR_BLOCKED_MESH`) and their `mesh.blocked.*`
exchange and pipeline counters come with the multi-GPU slice.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..ops import allsources as asrc
from ..ops import blocked_outer as _outer
from ..ops.blocked_outer import sat_minplus
from ..ops.sssp import INF32

BLOCKED_COUNTER_KEYS = (
    "mesh.blocked.products",
    "mesh.blocked.rounds",
    "mesh.blocked.tile_updates",
    "mesh.blocked.diag_us",
    "mesh.blocked.panel_us",
    "mesh.blocked.outer_us",
    "mesh.blocked.extract_us",
    "mesh.blocked.fallbacks",
)


def _ov_lanes(node_overloaded, k: int, b: int):
    """[B] bool drain mask of the lanes of tile k."""
    return node_overloaded[k * b : (k + 1) * b]


def blocked_diag(dist, node_overloaded, k: int):
    """Phase 1: masked FW closure of the k-th diagonal tile, [S, B, B]."""
    b = dist.shape[2]
    d = dist[:, k, :, k, :]
    ov = _ov_lanes(node_overloaded, k, b)
    for m in range(b):
        cand = sat_minplus(d[:, :, m, None], d[:, None, m, :])
        d = torch.minimum(d, cand.masked_fill_(ov[m], INF32))
    return d


def blocked_panels(dist, closed, node_overloaded, k: int):
    """Phase 2: the k-th row panel [S, B, T, B] and column panel
    [S, T, B, B] updated through the closed diagonal tile.  The
    contractions read the original panels: `closed` is transitively
    closed, so one application suffices."""
    b = dist.shape[2]
    row = dist[:, k]
    col = dist[:, :, :, k]
    ov = _ov_lanes(node_overloaded, k, b)
    row_p, col_p = row, col
    for m in range(b):
        cand = sat_minplus(closed[:, :, m, None, None], row[:, None, m])
        row_p = torch.minimum(row_p, cand.masked_fill_(ov[m], INF32))
    for m in range(b):
        cand = sat_minplus(
            col[:, :, :, m, None], closed[:, None, None, m, :]
        )
        col_p = torch.minimum(col_p, cand.masked_fill_(ov[m], INF32))
    return row_p.contiguous(), col_p.contiguous()


def blocked_extract(dist, dest_ids, n: int):
    """[N, P] int32 destination columns of slice 0: drev[v, p] =
    dist(v -> dest p).  Unreachable is exactly INF32."""
    s, t, b = dist.shape[0], dist.shape[1], dist.shape[2]
    np_ = t * b
    return dist.view(s, np_, np_)[0, :n].index_select(1, dest_ids)


class BlockedApspEngine:
    """Tiling policy, staging, round loop and `mesh.blocked.*` accounting
    of the blocked APSP rung (delta < fused full < blocked in the
    reference's dispatch ladder) on one device.

    Engagement: `should_engage(n)` — `OPENR_NODE_SHARD=1` forces the
    rung on, `=0` forces it off, otherwise it engages above
    `node_shard_threshold` (the reference's single-chip ceiling, 2^15
    nodes).  The device is the parent engine's, else `device`.  Phase 3
    goes through the parent's counting front-end
    (`DeviceResidencyEngine.blocked_outer`) when there is a parent.

    Phase timing counters are enqueue-attributed (no per-phase device
    sync); the closing sync of `fleet_product` lands in `extract_us`."""

    def __init__(
        self,
        parent=None,
        tile: Optional[int] = None,
        node_shard_threshold: int = 1 << 15,
        device=None,
    ) -> None:
        self.counters: dict[str, int] = {k: 0 for k in BLOCKED_COUNTER_KEYS}
        self._parent = parent
        self.tile = tile
        self.node_shard_threshold = node_shard_threshold
        if parent is not None:
            self.device = parent.device
        else:
            from ..device.engine import resolve_device

            self.device = resolve_device(device)

    # -- counters -----------------------------------------------------------

    def get_counters(self) -> dict[str, int]:
        return dict(self.counters)

    def _bump(self, name: str, delta: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + delta

    # -- policy -------------------------------------------------------------

    def should_engage(self, n_nodes: int) -> bool:
        force = os.environ.get("OPENR_NODE_SHARD")
        if force == "1":
            return True
        if force == "0":
            return False
        return n_nodes > self.node_shard_threshold

    def tile_for(self, n_nodes: int) -> int:
        """Tile size B: the pinned `tile`, else the smallest power of two
        reaching 16 or the node count (16 for any real fabric), as the
        reference picks on a one-device mesh."""
        b = self.tile
        if b is None:
            b = 1
            while b < 16 and b < max(n_nodes, 1):
                b *= 2
        if b <= 0:
            raise ValueError(f"blocked tile {b} is not positive")
        return b

    # -- staging ------------------------------------------------------------

    def dense_dist0(
        self,
        n_nodes: int,
        n_pad: int,
        edge_src,
        edge_dst,
        edge_metric,
        edge_up,
        n_edges: int,
    ) -> torch.Tensor:
        """[Np, Np] int32 adjacency on this engine's device in the
        saturating min-plus domain: 0 diagonal, min metric over parallel
        usable edges (clamped to INF32), INF32 elsewhere.  Padding nodes
        are isolated and never perturb real entries."""
        src = np.asarray(edge_src[:n_edges], dtype=np.int64)
        dst = np.asarray(edge_dst[:n_edges], dtype=np.int64)
        met = np.asarray(edge_metric[:n_edges], dtype=np.int64)
        up = np.asarray(edge_up[:n_edges], dtype=bool)
        use = (
            up
            & (src >= 0)
            & (dst >= 0)
            & (src < n_nodes)
            & (dst < n_nodes)
            & (src != dst)
        )
        flat = torch.from_numpy(src[use] * n_pad + dst[use]).to(self.device)
        val = torch.from_numpy(
            np.minimum(met[use], INF32).astype(np.int32)
        ).to(self.device)
        d0 = torch.full(
            (n_pad, n_pad), INF32, dtype=torch.int32, device=self.device
        )
        d0.diagonal().zero_()
        d0.view(-1).scatter_reduce_(0, flat, val, reduce="amin")
        return d0

    # -- execution ----------------------------------------------------------

    def _outer(self) -> Callable:
        if self._parent is not None:
            return self._parent.blocked_outer
        return _outer.blocked_outer

    def run_apsp(self, dist0: torch.Tensor, node_overloaded, outer=None):
        """Full blocked closure of dist0 [S, Np, Np] int32 with the [Np]
        drain mask, in place on dist0's storage; returns the tile tensor
        [S, T, B, T, B] and the tile B.  `outer` replaces the phase-3
        front-end (a comparison run passes the plain version)."""
        s, n_pad, _ = dist0.shape
        b = self.tile_for(n_pad)
        if n_pad % b:
            raise ValueError(
                f"blocked APSP: padded node count {n_pad} is not a "
                f"multiple of tile {b}"
            )
        t = n_pad // b
        ov = torch.as_tensor(
            np.asarray(node_overloaded, dtype=bool), device=dist0.device
        )
        dist = dist0.view(s, t, b, t, b)
        return self._rounds_bulk(dist, ov, t, outer or self._outer()), b

    def _rounds_bulk(self, dist, ov, t: int, outer: Callable):
        """The bulk-synchronous round loop: every round serializes diag
        closure -> panels -> outer update."""
        for k in range(t):
            t0 = time.monotonic_ns()
            closed = blocked_diag(dist, ov, k)
            t1 = time.monotonic_ns()
            row_p, col_p = blocked_panels(dist, closed, ov, k)
            t2 = time.monotonic_ns()
            dist = outer(dist, row_p, col_p, ov, k)
            t3 = time.monotonic_ns()
            self._bump("mesh.blocked.tile_updates")
            self._bump("mesh.blocked.diag_us", (t1 - t0) // 1000)
            self._bump("mesh.blocked.panel_us", (t2 - t1) // 1000)
            self._bump("mesh.blocked.outer_us", (t3 - t2) // 1000)
        self._bump("mesh.blocked.rounds", t)
        return dist

    def fleet_product(self, csr, dest_ids, out, outer=None):
        """The fleet-product face of the rung: forward-graph blocked APSP,
        destination-column extract, ECMP bitmap.  Returns (dist [N, P]
        int32, bitmap [N, P, W] int32, True), the `reduced_all_sources`
        contract the fleet view stores."""
        n = int(csr.n_nodes)
        b = self.tile_for(n)
        n_pad = -(-n // b) * b
        d0 = self.dense_dist0(
            n,
            n_pad,
            csr.edge_src,
            csr.edge_dst,
            csr.edge_metric,
            csr.edge_up,
            int(csr.n_edges),
        )
        ov_pad = np.zeros(n_pad, dtype=bool)
        ov_pad[:n] = np.asarray(csr.node_overloaded[:n], dtype=bool)
        dist, b = self.run_apsp(d0[None], ov_pad, outer)
        t0 = time.monotonic_ns()
        dest = torch.as_tensor(
            np.asarray(dest_ids, dtype=np.int64), device=self.device
        )
        drev = blocked_extract(dist, dest, n)
        bitmap = asrc.ecmp_bitmap_from_reverse_dist(
            drev,
            out,
            csr.edge_metric,
            csr.edge_up,
            csr.node_overloaded,
            out.n_words,
        )
        # one sync: the product is complete here, and the enqueue-
        # attributed phase timers need a closing edge
        if bitmap.is_cuda:
            torch.cuda.synchronize(bitmap.device)
        self._bump("mesh.blocked.extract_us", (time.monotonic_ns() - t0) // 1000)
        self._bump("mesh.blocked.products")
        return drev, bitmap, True
