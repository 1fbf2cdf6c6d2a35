"""Blocked min-plus APSP over a ("batch", "row", "col") device mesh: the
third dispatch rung of the fleet view.

Port of `openr_tpu.parallel.blocked`.  The padded Np x Np distance
matrix is held as the tile tensor dist [S, T, B, T, B] (node g is tile
g // B, lane g % B; Np = T * B), sharded as the reference's
P("batch", None, "row", None, "col"): the tile dims stay whole and the
lane dims split over the mesh, so shard (b, r, c) holds
[S / nb, T, B / R, T, B / C] — the rectangle of rows T * B / R by
columns T * B / C, as its own contiguous tensor on its device
(`TileShards`).  Each of the T rounds k runs the three phases of
blocked Floyd-Warshall:

    phase 1 (diag):   closed = FW(dist[k][k])          replicated
    phase 2 (panels): row' = min(row, closed (*) row)  gathered over "row"
                      col' = min(col, col (*) closed)  gathered over "col"
    phase 3 (outer):  dist[k] <- row'; dist[:, :, k] <- col'
                      dist = min(dist, col' (*) row')   rank-B update

where (*) is the min-plus product masked at the intermediate: a
contribution through a drained (overloaded) node is dropped, which is
the fleet drain rule (an overloaded node relays nothing but stays a
valid endpoint).  The tile is gathered from every shard and replicated,
the row panel's lanes all-gather over "row" and the column panel's over
"col" (`parallel.mesh.Mesh`'s explicit copies); phases 1 and 2 are plain
PyTorch on [S, B, B] tiles and panels, run once per distinct device of
the shards that need them.  Phase 3 is kernel K2 (`ops.blocked_outer`),
once per shard per round on that shard's rectangle, in place.
Distances are int32 tensors holding values in [0, INF32 = 2^30],
bit-identical to the reference's saturating uint32; sums are
`minimum(a, INF - b) + b`.

Lookahead pipelining: closures of two rounds or more take the
reference's pipelined loop by default (`OPENR_BLOCKED_PIPELINE=0`, or a
pinned `pipeline_mode = "0"`, forces the bulk loop).  Each round k
first runs the read-only lookahead (`blocked_lookahead`: round k's
write-back emulated on the k+1 slices, round k's outer update restricted
to them, then round k+1's diagonal closure and panels), then K2 for
round k; the reference's split order (:792-800), since K2 updates dist
in place.  Integer min-plus is exact and order-free, so the pipelined
closure equals the bulk one bit for bit.  Both run on one CUDA stream;
overlapping the lookahead with K2 on a second stream is left open.

The ECMP bitmap of the product is `ops.allsources.
ecmp_bitmap_from_reverse_dist`, called directly (the reference's
`_blocked_bitmap` is only its jit wrapper).  With tracing armed
(`obs.trace`), `run_apsp` tags the active scope `engine.rung` =
`blocked`.  The chaos seam fires `blocked_round` before each round and
`blocked_product` before each fleet product, through the parent
engine's `fault_hook` when it has one, else this engine's own.

Deliberate differences from the reference: the pipelined loop demotes
to the bulk loop only on the fault hook's own exception at
`blocked_round` (counted in `mesh.blocked.pipeline_fallbacks`, with
dist0 staged again from `restage`, since the failed attempt wrote into
it); every other exception propagates, as a mesh-shape `ValueError`
does, and the fleet view raises it (no fallback to another rung).
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..device.sanitizer import stage
from ..obs import trace as _trace
from ..ops import allsources as asrc
from ..ops import blocked_outer as _outer
from ..ops.blocked_outer import sat_minplus
from ..ops.sssp import INF32
from .mesh import Mesh, cat, mesh_devices

#: exported through the ctrl handler's `mesh` surface; pre-seeded in
#: __init__ so every key dumps before the first dispatch
BLOCKED_COUNTER_KEYS = (
    "mesh.blocked.products",
    "mesh.blocked.rounds",
    "mesh.blocked.tile_updates",
    "mesh.blocked.panel_broadcasts",
    "mesh.blocked.bytes_exchanged",
    "mesh.blocked.diag_us",
    "mesh.blocked.panel_us",
    "mesh.blocked.outer_us",
    "mesh.blocked.extract_us",
    "mesh.blocked.fallbacks",
    "mesh.blocked.pipeline_rounds_overlapped",
    "mesh.blocked.pipeline_prefetch_issues",
    "mesh.blocked.pipeline_fallbacks",
    "mesh.blocked.pipeline_overlap_frac_est",
)

# largest candidate tensor of one min-plus product chunk, in elements
_CHUNK_ELEMS = 1 << 25


def make_blocked_mesh(
    devices: Optional[Sequence] = None,
    batch: int = 1,
    rows: Optional[int] = None,
    cols: Optional[int] = None,
) -> Mesh:
    """Build the ("batch", "row", "col") mesh over the given (or every
    CUDA) devices; a device may appear more than once (a logical mesh).
    Omitted row/col sizes are factored from the device count (squarest
    split); indivisible requests raise ValueError with the numbers
    spelled out."""
    devices = mesh_devices(devices)
    n = len(devices)
    if batch <= 0 or n % batch:
        raise ValueError(
            f"blocked mesh: {n} devices do not divide into a batch axis "
            f"of {batch} (need batch * rows * cols == {n})"
        )
    per = n // batch
    if rows is None and cols is None:
        r = max(1, int(math.isqrt(per)))
        while per % r:
            r -= 1
        rows, cols = r, per // r
    elif rows is None:
        if cols <= 0 or per % cols:
            raise ValueError(
                f"blocked mesh: {per} devices per batch slice "
                f"({n} devices / batch={batch}) do not divide into "
                f"cols={cols}"
            )
        rows = per // cols
    elif cols is None:
        if rows <= 0 or per % rows:
            raise ValueError(
                f"blocked mesh: {per} devices per batch slice "
                f"({n} devices / batch={batch}) do not divide into "
                f"rows={rows}"
            )
        cols = per // rows
    if rows <= 0 or cols <= 0 or rows * cols != per:
        raise ValueError(
            f"blocked mesh: rows={rows} x cols={cols} != {per} devices "
            f"per batch slice ({n} devices / batch={batch})"
        )
    dev = np.empty(n, dtype=object)
    dev[:] = devices
    return Mesh(dev.reshape(batch, rows, cols), ("batch", "row", "col"))


def _ov_lanes(node_overloaded, k: int, b: int):
    """[B] bool drain mask of the lanes of tile k."""
    return node_overloaded[k * b : (k + 1) * b]


def _minplus(a, b):
    """[S, I, J] saturating min-plus product min_m a[:, i, m] + b[:, m, j],
    chunked over m; the caller drops a drained lane m by making its
    operand INF (INF + x saturates to INF)."""
    s, i, m = a.shape
    j = b.shape[2]
    step = max(1, _CHUNK_ELEMS // max(1, s * i * j))
    out = None
    for lo in range(0, m, step):
        part = sat_minplus(
            a[:, :, lo : lo + step, None], b[:, None, lo : lo + step, :]
        ).amin(dim=2)
        out = part if out is None else torch.minimum(out, part)
    return out


def _closure(tile, ov):
    """Masked FW closure of one [S, B, B] diagonal tile, by min-plus
    squaring: after s squarings every path of up to 2^s edges through
    non-drained lanes is in, and a shortest path of B nodes has fewer
    than B edges.  Integer min-plus is exact, so this equals the
    reference's B rank-1 steps bit for bit."""
    b = tile.shape[-1]
    d = tile
    steps = 0
    while (1 << steps) < b:
        steps += 1
    for _ in range(steps):
        d = torch.minimum(d, _minplus(d.masked_fill(ov, INF32), d))
    return d


def _update_row(row, closed, ov):
    """Phase 2's row panel update: row [S, B, T, Bc] (every lane of tile
    k, the columns of one shard) through the closed tile."""
    s, b = row.shape[0], row.shape[1]
    flat = row.reshape(s, b, -1)
    upd = _minplus(closed.masked_fill(ov, INF32), flat)
    return torch.minimum(flat, upd).view(row.shape)


def _update_col(col, closed, ov):
    """Phase 2's column panel update: col [S, T, Br, B] (the rows of one
    shard, every lane of tile k) through the closed tile."""
    s, b = col.shape[0], col.shape[3]
    flat = col.reshape(s, -1, b)
    upd = _minplus(flat, closed.masked_fill(ov[:, None], INF32))
    return torch.minimum(flat, upd).view(col.shape)


def blocked_diag(dist, node_overloaded, k: int):
    """Phase 1 on a whole tile tensor: masked FW closure of the k-th
    diagonal tile, [S, B, B]."""
    b = dist.shape[2]
    return _closure(dist[:, k, :, k, :], _ov_lanes(node_overloaded, k, b))


def blocked_panels(dist, closed, node_overloaded, k: int):
    """Phase 2 on a whole tile tensor: the k-th row panel [S, B, T, B]
    and column panel [S, T, B, B] updated through the closed diagonal
    tile.  The contractions read the original panels: `closed` is
    transitively closed, so one application suffices."""
    ov = _ov_lanes(node_overloaded, k, dist.shape[2])
    return (
        _update_row(dist[:, k], closed, ov).contiguous(),
        _update_col(dist[:, :, :, k], closed, ov).contiguous(),
    )


def blocked_extract(dist, dest_ids, n: int):
    """[N, P] int32 destination columns of slice 0 of a whole tile
    tensor: drev[v, p] = dist(v -> dest p).  Unreachable is exactly
    INF32."""
    s, t, b = dist.shape[0], dist.shape[1], dist.shape[2]
    np_ = t * b
    return dist.view(s, np_, np_)[0, :n].index_select(1, dest_ids)


class TileShards:
    """The tile tensor [S, T, B, T, B] split over a blocked mesh: shard
    (bi, r, c) is the contiguous [S / nb, T, B / R, T, B / C] tensor
    `shards[bi, r, c]` on `mesh.devices[bi, r, c]`.  On a one-shard mesh
    the only shard is the tile tensor itself (a view of the staged
    dist0, updated in place)."""

    def __init__(self, mesh: Mesh, dist5: torch.Tensor) -> None:
        self.mesh = mesh
        nb, nr, nc = mesh.devices.shape
        s, t, b = dist5.shape[0], dist5.shape[1], dist5.shape[2]
        if s % nb:
            raise ValueError(
                f"blocked APSP: batch {s} does not split over a batch "
                f"axis of {nb}"
            )
        self.s, self.t, self.b = s, t, b
        self.sb, self.br, self.bc = s // nb, b // nr, b // nc
        self.shards = np.empty((nb, nr, nc), dtype=object)
        for (bi, r, c), dev in np.ndenumerate(mesh.devices):
            if mesh.size == 1:
                self.shards[bi, r, c] = dist5
                continue
            part = dist5[
                bi * self.sb : (bi + 1) * self.sb,
                :,
                r * self.br : (r + 1) * self.br,
                :,
                c * self.bc : (c + 1) * self.bc,
            ]
            self.shards[bi, r, c] = part.contiguous().to(dev)

    def full(self) -> torch.Tensor:
        """The whole tile tensor on the mesh's first device."""
        if self.mesh.size == 1:
            return self.shards.flat[0]
        first = self.mesh.first
        slices = []
        for bi in range(self.shards.shape[0]):
            rows = [
                cat(list(self.shards[bi, r]), 4, first)
                for r in range(self.shards.shape[1])
            ]
            slices.append(cat(rows, 2, first))
        return cat(slices, 0, first)

    def extract(self, dest: np.ndarray, n: int) -> torch.Tensor:
        """blocked_extract over the shards, gathered on the mesh's first
        device: each destination column is read from the column shard
        that owns its lane."""
        first = self.mesh.first
        if self.mesh.size == 1:
            return blocked_extract(
                self.shards.flat[0], stage(dest, first), n
            )
        t, b, br, bc = self.t, self.b, self.br, self.bc
        nr, nc = self.shards.shape[1], self.shards.shape[2]
        out = torch.empty((t, nr, br, len(dest)), dtype=torch.int32, device=first)
        lane = dest % b
        owner = lane // bc
        local = (dest // b) * bc + lane % bc
        for c in range(nc):
            cols = np.flatnonzero(owner == c)
            if not cols.size:
                continue
            for r in range(nr):
                shard = self.shards[0, r, c]
                sub = shard[0].reshape(t * br, t * bc).index_select(
                    1, stage(local[cols], shard.device)
                )
                out[:, r, :, stage(cols, first)] = sub.to(
                    first
                ).view(t, br, -1)
        return out.view(t * b, -1)[:n]


class _Demotion(Exception):
    """The fault hook fired at `blocked_round` inside the pipelined loop."""


class BlockedApspEngine:
    """Mesh, tiling policy, staging, round loops and `mesh.blocked.*`
    accounting of the blocked APSP rung (delta < fused full < blocked in
    the reference's dispatch ladder).

    Engagement: `should_engage(n)` — `OPENR_NODE_SHARD=1` forces the
    rung on, `=0` forces it off, otherwise it engages above
    `node_shard_threshold` (the reference's single-chip ceiling, 2^15
    nodes).  The mesh is the pinned `mesh`, else `OPENR_BLOCKED_MESH`
    ("RxC" or "BxRxC") over every CUDA card (over this engine's one
    device when it is the CPU), else the 1x1x1 mesh of this engine's
    device; an indivisible request raises ValueError.  The device is
    the parent engine's, else the mesh's first, else `device`.  Phase 3
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
        mesh: Optional[Mesh] = None,
    ) -> None:
        self.counters: dict[str, int] = {k: 0 for k in BLOCKED_COUNTER_KEYS}
        self._parent = parent
        self.tile = tile
        self.node_shard_threshold = node_shard_threshold
        self._mesh = mesh
        # chaos seam for engine-less use; with a parent, the parent's
        # hook takes precedence (`_hook`)
        self.fault_hook: Optional[Callable[[str], None]] = None
        # pinned pipeline override ("0" off / "1" on); None consults
        # OPENR_BLOCKED_PIPELINE
        self.pipeline_mode: Optional[str] = None
        if parent is not None:
            self.device = parent.device
        elif mesh is not None and device is None:
            self.device = mesh.first
        else:
            from ..device.engine import resolve_device

            self.device = resolve_device(device)

    # -- counters -----------------------------------------------------------

    def get_counters(self) -> dict[str, int]:
        return dict(self.counters)

    def _bump(self, name: str, delta: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + delta

    def _hook(self, op: str) -> None:
        hook = self._parent.fault_hook if self._parent is not None else None
        if hook is None:
            hook = self.fault_hook
        if hook is not None:
            hook(op)

    # -- policy -------------------------------------------------------------

    def should_engage(self, n_nodes: int) -> bool:
        force = os.environ.get("OPENR_NODE_SHARD")
        if force == "1":
            return True
        if force == "0":
            return False
        return n_nodes > self.node_shard_threshold

    def mesh(self) -> Mesh:
        if self._mesh is None:
            spec = os.environ.get("OPENR_BLOCKED_MESH", "")
            if spec:
                try:
                    dims = [int(x) for x in spec.lower().split("x")]
                except ValueError:
                    raise ValueError(
                        f"OPENR_BLOCKED_MESH={spec!r}: expected 'RxC' or "
                        f"'BxRxC' integers"
                    ) from None
                devices = None if self.device.type == "cuda" else [self.device]
                if len(dims) == 2:
                    self._mesh = make_blocked_mesh(
                        devices, rows=dims[0], cols=dims[1]
                    )
                elif len(dims) == 3:
                    self._mesh = make_blocked_mesh(
                        devices, batch=dims[0], rows=dims[1], cols=dims[2]
                    )
                else:
                    raise ValueError(
                        f"OPENR_BLOCKED_MESH={spec!r}: expected 2 or 3 "
                        f"'x'-separated sizes, got {len(dims)}"
                    )
            else:
                self._mesh = make_blocked_mesh([self.device])
        return self._mesh

    def pipeline_enabled(self, t: int) -> bool:
        """Lookahead pipelining is the default for multi-round closures;
        `OPENR_BLOCKED_PIPELINE=0` (or a pinned `pipeline_mode="0"`)
        forces the bulk-synchronous loop.  A single-round closure has
        nothing to prefetch."""
        if t < 2:
            return False
        mode = self.pipeline_mode
        if mode is None:
            mode = os.environ.get("OPENR_BLOCKED_PIPELINE", "")
        return str(mode) != "0"

    def tile_for(self, n_nodes: int, rows: int = 1, cols: int = 1) -> int:
        """Tile size B: lane dims shard over the mesh, so B must be a
        multiple of lcm(rows, cols); the pinned `tile` (else
        OPENR_BLOCKED_TILE) is checked against that, else B doubles from
        the lcm to 16 or the node count (16 for any real fabric)."""
        base = math.lcm(rows, cols)
        b = self.tile
        if b is None:
            b = int(os.environ.get("OPENR_BLOCKED_TILE", "0")) or None
        if b is None:
            b = base
            while b < 16 and b < max(n_nodes, 1):
                b *= 2
        if b <= 0 or b % base:
            raise ValueError(
                f"blocked tile {b} is not a positive multiple of "
                f"lcm(rows={rows}, cols={cols}) = {base}"
            )
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
        device=None,
    ) -> torch.Tensor:
        """[Np, Np] int32 adjacency on `device` (default this engine's) in
        the saturating min-plus domain: 0 diagonal, min metric over
        parallel usable edges (clamped to INF32), INF32 elsewhere.
        Padding nodes are isolated and never perturb real entries."""
        device = self.device if device is None else device
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
        flat = stage(src[use] * n_pad + dst[use], device)
        val = stage(np.minimum(met[use], INF32).astype(np.int32), device)
        d0 = torch.full((n_pad, n_pad), INF32, dtype=torch.int32, device=device)
        d0.diagonal().zero_()
        d0.view(-1).scatter_reduce_(0, flat, val, reduce="amin")
        return d0

    # -- execution ----------------------------------------------------------

    def _outer(self) -> Callable:
        if self._parent is not None:
            return self._parent.blocked_outer
        return _outer.blocked_outer

    def run_apsp(self, dist0: torch.Tensor, node_overloaded, outer=None,
                 restage: Optional[Callable] = None):
        """Full blocked closure of dist0 [S, Np, Np] int32 with the [Np]
        drain mask over this engine's mesh; returns (TileShards, B).  On
        a one-shard mesh the closure runs in place on dist0's storage.
        `outer` replaces the phase-3 front-end (a comparison run passes
        the plain version).  Armed, it tags the scope's spans
        `engine.rung` = `blocked`.

        Multi-round closures take the pipelined loop unless it is
        turned off.  When the fault hook fires at `blocked_round` there,
        the loop demotes: `mesh.blocked.pipeline_fallbacks` counts it
        and the bulk loop reruns from `restage()` (a fresh dist0).
        Without `restage` there is no demotion and the hook's exception
        propagates; any other exception always does."""
        tr = _trace.TRACE
        if tr is not None:
            tr.annotate("engine.rung", "blocked")
        mesh = self.mesh()
        rows, cols = mesh.shape["row"], mesh.shape["col"]
        s, n_pad, _ = dist0.shape
        b = self.tile_for(n_pad, rows, cols)
        if n_pad % b:
            raise ValueError(
                f"blocked APSP: padded node count {n_pad} is not a "
                f"multiple of tile {b}"
            )
        t = n_pad // b
        outer = outer or self._outer()
        # the drain mask, replicated on every shard's device
        devices = list(mesh.devices.flat)
        ov = dict(zip(devices, mesh.replicate(
            stage(np.asarray(node_overloaded, dtype=bool), mesh.first),
            devices,
        )))
        # modeled exchange per round: each panel's [S, B, Np] lane dim
        # replicates to the (R-1)/(C-1) non-owner rows/cols, the diag
        # tile to everyone
        round_bytes = 4 * s * (
            b * n_pad * (rows - 1) // max(rows, 1)
            + b * n_pad * (cols - 1) // max(cols, 1)
            + b * b
        )
        tiles = TileShards(mesh, dist0.view(s, t, b, t, b))
        del dist0
        if self.pipeline_enabled(t):
            try:
                self._rounds_pipelined(tiles, ov, t, outer, round_bytes)
                return tiles, b
            except _Demotion as demotion:
                if restage is None:
                    raise demotion.__cause__ from None
                # the failed attempt wrote into dist0's storage
                self._bump("mesh.blocked.pipeline_fallbacks")
                del tiles
                tiles = TileShards(mesh, restage().view(s, t, b, t, b))
        self._rounds_bulk(tiles, ov, t, outer, round_bytes)
        return tiles, b

    # -- the phases over the shards ------------------------------------------

    def _diag(self, tiles: TileShards, bi: int, pieces, ov, k: int) -> dict:
        """Phase 1 of batch slice `bi`: the tile pieces [S, Br, Bc] of
        every shard (a dict by (r, c)) gathered and replicated, closed
        once per distinct device.  Returns the closed tile by (r, c)."""
        mesh = tiles.mesh
        nr, nc = mesh.devices.shape[1:]
        keys = [(r, c) for r in range(nr) for c in range(nc)]
        devs = [mesh.devices[bi, r, c] for r, c in keys]

        def assemble(xs):
            return torch.cat(
                [torch.cat(xs[r * nc : (r + 1) * nc], 2) for r in range(nr)], 1
            )

        full = mesh.all_gather([pieces[key] for key in keys], devs, assemble)
        closed: dict = {}
        out = {}
        for key, dev, tile in zip(keys, devs, full):
            if dev not in closed:
                closed[dev] = _closure(tile, _ov_lanes(ov[dev], k, tiles.b))
            out[key] = closed[dev]
        return out

    def _panels(self, tiles: TileShards, bi: int, rows, cols, closed, ov,
                k: int) -> tuple:
        """Phase 2 of batch slice `bi` from each shard's row piece
        [S, Br, T, Bc] and column piece [S, T, Br, Bc] (dicts by (r, c)):
        the row panel of column c gathered over "row", the column panel
        of row r over "col", each updated once per distinct device.
        Returns (row panels [S, B, T, Bc], column panels [S, T, Br, B]),
        dicts by (r, c)."""
        mesh = tiles.mesh
        nr, nc = mesh.devices.shape[1:]
        row_p, col_p = {}, {}
        for c in range(nc):
            devs = [mesh.devices[bi, r, c] for r in range(nr)]
            full = mesh.all_gather(
                [rows[r, c] for r in range(nr)], devs, lambda xs: torch.cat(xs, 1)
            )
            done: dict = {}
            for r, (dev, panel) in enumerate(zip(devs, full)):
                if dev not in done:
                    done[dev] = _update_row(
                        panel, closed[r, c], _ov_lanes(ov[dev], k, tiles.b)
                    ).contiguous()
                row_p[r, c] = done[dev]
        for r in range(nr):
            devs = [mesh.devices[bi, r, c] for c in range(nc)]
            full = mesh.all_gather(
                [cols[r, c] for c in range(nc)], devs, lambda xs: torch.cat(xs, 3)
            )
            done = {}
            for c, (dev, panel) in enumerate(zip(devs, full)):
                if dev not in done:
                    done[dev] = _update_col(
                        panel, closed[r, c], _ov_lanes(ov[dev], k, tiles.b)
                    ).contiguous()
                col_p[r, c] = done[dev]
        return row_p, col_p

    def _round_panels(self, tiles: TileShards, ov, k: int) -> list:
        """Phases 1 and 2 of round k from the tile tensor itself: per
        batch slice, (row panels, column panels) by (r, c)."""
        t0 = time.monotonic_ns()
        closed = [
            self._diag(
                tiles, bi,
                {rc: x[:, k, :, k, :] for rc, x in _items(tiles, bi)}, ov, k,
            )
            for bi in range(tiles.shards.shape[0])
        ]
        t1 = time.monotonic_ns()
        panels = [
            self._panels(
                tiles, bi,
                {rc: x[:, k] for rc, x in _items(tiles, bi)},
                {rc: x[:, :, :, k] for rc, x in _items(tiles, bi)},
                closed[bi], ov, k,
            )
            for bi in range(tiles.shards.shape[0])
        ]
        t2 = time.monotonic_ns()
        self._bump("mesh.blocked.diag_us", (t1 - t0) // 1000)
        self._bump("mesh.blocked.panel_us", (t2 - t1) // 1000)
        return panels

    def _outer_step(self, tiles: TileShards, panels, ov, k: int,
                    outer: Callable) -> None:
        """Phase 3 of round k: K2 (through `outer`) once per shard, in
        place, from the shard's slices of the panels."""
        for (bi, r, c), shard in np.ndenumerate(tiles.shards):
            row_p, col_p = panels[bi]
            outer(
                shard, row_p[r, c], col_p[r, c], ov[shard.device], k,
                (r * tiles.br, c * tiles.bc),
            )

    def blocked_lookahead(self, tiles: TileShards, panels, ov, k: int) -> list:
        """Read-only round-(k+1) panels from round k's panels (the
        reference's `blocked_lookahead` / `_lookahead`, :278-445): round
        k's write-back emulated on the k+1 slices of each shard, round
        k's rank-B outer update restricted to them, then round k+1's
        diagonal closure and panel updates.  Integer min-plus is exact,
        so these equal the panels the bulk loop derives after round k."""
        kn = k + 1
        b, br, bc = tiles.b, tiles.br, tiles.bc
        out = []
        for bi in range(tiles.shards.shape[0]):
            row_p, col_p = panels[bi]
            nrows, ncols = {}, {}
            for (r, c), shard in _items(tiles, bi):
                ovk = _ov_lanes(ov[shard.device], k, b)
                rp, cp = row_p[r, c], col_p[r, c]
                s, t = rp.shape[0], rp.shape[2]
                # next row panel piece [S, Br, T, Bc]: its tile-k column
                # block is the column panel's tile-(k+1) block
                nrow = shard[:, kn].clone()
                nrow[:, :, k] = cp[:, kn, :, c * bc : (c + 1) * bc]
                upd = _minplus(
                    cp[:, kn].masked_fill(ovk, INF32), rp.reshape(s, b, t * bc)
                )
                nrows[r, c] = torch.minimum(nrow, upd.view(nrow.shape))
                # next column panel piece [S, T, Br, Bc]
                ncol = shard[:, :, :, kn].clone()
                ncol[:, k] = rp[:, r * br : (r + 1) * br, kn]
                upd = _minplus(
                    cp.reshape(s, t * br, b),
                    rp[:, :, kn].masked_fill(ovk[:, None], INF32),
                )
                ncols[r, c] = torch.minimum(ncol, upd.view(ncol.shape))
            closed = self._diag(
                tiles, bi, {rc: x[:, :, kn] for rc, x in nrows.items()}, ov, kn
            )
            out.append(self._panels(tiles, bi, nrows, ncols, closed, ov, kn))
        return out

    def _count_round(self, round_bytes: int, t0: int) -> None:
        self._bump("mesh.blocked.tile_updates")
        self._bump("mesh.blocked.panel_broadcasts", 2)
        self._bump("mesh.blocked.bytes_exchanged", round_bytes)
        self._bump("mesh.blocked.outer_us", (time.monotonic_ns() - t0) // 1000)

    def _rounds_bulk(self, tiles, ov, t: int, outer: Callable, round_bytes: int):
        """The bulk-synchronous round loop: every round serializes diag
        closure -> panels -> outer update."""
        for k in range(t):
            self._hook("blocked_round")
            panels = self._round_panels(tiles, ov, k)
            t2 = time.monotonic_ns()
            self._outer_step(tiles, panels, ov, k, outer)
            self._count_round(round_bytes, t2)
        self._bump("mesh.blocked.rounds", t)

    def _rounds_pipelined(self, tiles, ov, t: int, outer: Callable,
                          round_bytes: int):
        """The software-pipelined round loop (t >= 2): the prologue
        computes round 0's panels the bulk way; each round k < t - 1
        runs the read-only lookahead for round k + 1, then K2 for round
        k; the epilogue round runs K2 alone.  `multi` (more than one
        shard) counts the rounds whose exchanges could overlap
        compute."""
        multi = tiles.mesh.size > 1
        panels = self._round_panels(tiles, ov, 0)
        for k in range(t):
            try:
                self._hook("blocked_round")
            except Exception as exc:
                raise _Demotion() from exc
            t2 = time.monotonic_ns()
            nxt = None
            if k + 1 < t:
                nxt = self.blocked_lookahead(tiles, panels, ov, k)
            self._outer_step(tiles, panels, ov, k, outer)
            self._count_round(round_bytes, t2)
            if nxt is not None:
                self._bump("mesh.blocked.pipeline_prefetch_issues")
                if multi:
                    self._bump("mesh.blocked.pipeline_rounds_overlapped")
                panels = nxt
        self._bump("mesh.blocked.rounds", t)
        # gauge: modeled fraction of rounds whose exchanges overlap
        # compute (the prologue and a one-shard mesh overlap none)
        self.counters["mesh.blocked.pipeline_overlap_frac_est"] = (
            100 * (t - 1) // t if multi else 0
        )

    def fleet_product(self, csr, dest_ids, out, outer=None):
        """The fleet-product face of the rung: forward-graph blocked APSP,
        destination-column extract (gathered on the mesh's first device),
        ECMP bitmap.  Returns (dist [N, P] int32, bitmap [N, P, W] int32,
        True), the `reduced_all_sources` contract the fleet view
        stores."""
        self._hook("blocked_product")
        n = int(csr.n_nodes)
        mesh = self.mesh()
        b = self.tile_for(n, mesh.shape["row"], mesh.shape["col"])
        n_pad = -(-n // b) * b

        def stage():
            return self.dense_dist0(
                n,
                n_pad,
                csr.edge_src,
                csr.edge_dst,
                csr.edge_metric,
                csr.edge_up,
                int(csr.n_edges),
                device=mesh.first,
            )[None]

        ov_pad = np.zeros(n_pad, dtype=bool)
        ov_pad[:n] = np.asarray(csr.node_overloaded[:n], dtype=bool)
        tiles, b = self.run_apsp(stage(), ov_pad, outer, restage=stage)
        t0 = time.monotonic_ns()
        drev = tiles.extract(np.asarray(dest_ids, dtype=np.int64), n)
        del tiles
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


def _items(tiles: TileShards, bi: int):
    """((r, c), shard) of batch slice `bi`."""
    return (
        ((r, c), tiles.shards[bi, r, c])
        for r in range(tiles.shards.shape[1])
        for c in range(tiles.shards.shape[2])
    )
