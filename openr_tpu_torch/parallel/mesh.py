"""Device meshes and the mesh-sharded SSSP steps.

Port of `openr_tpu.parallel.mesh`.  The reference's mesh is JAX's
single-controller `Mesh`: one process places the shards and XLA inserts
the collectives.  The port keeps that model with no runtime of its own:
`Mesh` is an ndarray of `torch.device`s with named axes, one Python
thread places every shard, and the exchanges between shards are the
explicit copies of `Mesh.all_gather` / `Mesh.replicate`
(`tensor.to(device, non_blocking=True)`; peer copies over NVLink on
several cards).  Each exchange counts the bytes it moves between
distinct shards in `Mesh.bytes_moved`.

A mesh may name one device more than once (a deliberate difference from
JAX, whose meshes hold distinct devices): the tests build
`make_mesh(["cpu"] * 8)` where the reference uses 8 virtual CPU devices,
and a one-card machine runs the sharded code on a logical mesh whose
shards share the card.  Work that every shard of a group would repeat on
the same data (a replicated tile's closure, a gathered panel's update)
runs once per distinct device, and a copy to the device a tensor already
lives on is no copy.

Sharding layout of the SPF steps (mesh axes ("batch", "node")):

    sources [S]         split over "batch"
    dist    [S, N]      split over "batch"; the relax state [N_cap, S/b]
                        of a batch shard splits its relabelled rows over
                        "node", with one all-gather of the state per
                        sweep
    edge arrays [E]     replicated on every device
    dag     [S, E]      split over "batch"

On a batch-only mesh (every device on "batch", the default) the sources
are independent problems and no distance moves between shards.  The
ELL relax, the SP-DAG and the fleet product's banded relax are the
port's own single-device ops (`ops.sssp`, `ops.banded`), run per shard;
the fleet product's verify and ECMP bitmap run kernel K1 once per shard
(`ops.epilogue.fused_epilogue`), as `ops.allsources.reduced_all_sources`
does on one device.  Results are gathered on the mesh's first device.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..device.sanitizer import fetch, fetch_point, stage
from ..ops import sssp as ops


class Mesh:
    """Devices on named axes (`devices` an ndarray of `torch.device`,
    `shape` the axis sizes by name), held by one controller."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]) -> None:
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"mesh: {devices.ndim}-d device array for axes {tuple(axis_names)}"
            )
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        # bytes moved between distinct shards by the exchange helpers
        self.bytes_moved = 0

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first(self) -> torch.device:
        """The device results are gathered on."""
        return self.devices.flat[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"

    def all_gather(
        self, pieces: Sequence[torch.Tensor], devices: Sequence[torch.device],
        cat: Callable = None,
    ) -> list:
        """Shard i of a group (on `devices[i]`) holds `pieces[i]`; after the
        exchange every shard holds `cat` of all pieces (default: along
        dim 0).  Returns one tensor per shard, computed once per distinct
        device.  Each shard receives every piece but its own."""
        cat = cat or (lambda xs: torch.cat(xs, 0))
        self.bytes_moved += (len(devices) - 1) * sum(_nbytes(p) for p in pieces)
        made: dict = {}
        out = []
        for dev in devices:
            if dev not in made:
                moved = [_to(p, dev) for p in pieces]
                made[dev] = moved[0] if len(moved) == 1 else cat(moved)
            out.append(made[dev])
        return out

    def replicate(self, x: torch.Tensor, devices: Sequence[torch.device]) -> list:
        """`x`, held by the first shard of a group, on every shard of it
        (one copy per distinct device)."""
        self.bytes_moved += (len(devices) - 1) * _nbytes(x)
        made: dict = {}
        return [made.setdefault(dev, _to(x, dev)) for dev in devices]


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`x` on `device`, a copy only when it lives elsewhere; uint16
    tensors move through their int16 view."""
    if x.device == device:
        return x
    if x.dtype == torch.uint16:
        return x.view(torch.int16).to(device, non_blocking=True).view(torch.uint16)
    return x.to(device, non_blocking=True)


def cat(pieces: Sequence[torch.Tensor], dim: int, device: torch.device) -> torch.Tensor:
    """The pieces moved to `device` and concatenated along `dim` (uint16
    through the int16 view)."""
    moved = [_to(p, device) for p in pieces]
    if len(moved) == 1:
        return moved[0]
    if moved[0].dtype == torch.uint16:
        return torch.cat([m.view(torch.int16) for m in moved], dim).view(torch.uint16)
    return torch.cat(moved, dim)


def mesh_devices(devices=None) -> list:
    """`devices` as `torch.device`s; by default every CUDA card.  Raises
    when CUDA is asked for (named, or by default) and not available."""
    from ..device.engine import resolve_device

    if devices is None:
        resolve_device(None)
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            # the index its tensors report
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    return out


def make_mesh(devices=None, batch_axis: Optional[int] = None) -> Mesh:
    """Build a ("batch", "node") mesh over the given (or every CUDA)
    devices.  `batch_axis` fixes the batch-axis length; default puts all
    devices on the batch axis (the exchange-free layout)."""
    devices = mesh_devices(devices)
    n = len(devices)
    if batch_axis is None:
        batch_axis = n
    if batch_axis <= 0 or n % batch_axis:
        raise ValueError(
            f"make_mesh: {n} devices do not divide into a batch axis of "
            f"{batch_axis} (the node axis would get {n}/{batch_axis} "
            f"devices; pick a batch_axis that divides {n})"
        )
    dev = np.empty(n, dtype=object)
    dev[:] = devices
    return Mesh(dev.reshape(batch_axis, n // batch_axis), ("batch", "node"))


def _put(x, device: torch.device, dtype=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        t = _to(x, device)
    else:
        t = stage(x, device)
    return t if dtype is None else t.to(dtype)


def _ell_on(ell, device: torch.device):
    if isinstance(ell.new_of_old, torch.Tensor):
        return ops.EllGraph(
            tuple(ops.EllBucket(*(_to(a, device) for a in bk)) for bk in ell.buckets),
            _to(ell.new_of_old, device),
            _to(ell.old_of_new, device),
        )
    return ell.to(device)


class ShardedSpfStep:
    """The full SPF step (distances and SP-DAG) over `mesh`, optionally
    with per-row edge exclusions (the what-if batch axis).  Call it with
    (sources, ell, edge_src, edge_dst, edge_metric, edge_up,
    node_overloaded[, extra_mask_T]) — numpy arrays or tensors, `ell` an
    `ops.sssp.EllGraph`, `extra_mask_T` [E_cap, S] bool (False
    excludes); it returns (dist [S, N_cap] int32 in original ids, dag
    [S, E_cap] bool) on the mesh's first device.

    After a call, `shard_shapes` lists the relax state's shape on every
    shard (batch-major), `sweeps` the relax sweeps of each batch shard
    and `bytes_moved` the distance bytes the relax moved between shards
    (one all-gather of the node-sharded state per sweep)."""

    def __init__(self, mesh: Mesh, masked: bool) -> None:
        self.mesh = mesh
        self.masked = masked
        self.shard_shapes: list = []
        self.sweeps: list = []
        self.bytes_moved = 0

    def __call__(
        self, sources, ell, edge_src, edge_dst, edge_metric, edge_up,
        node_overloaded, extra_mask_T=None,
    ):
        if self.masked != (extra_mask_T is not None):
            raise ValueError(
                "the what-if step takes an [E_cap, S] mask; the SPF step none"
            )
        mesh = self.mesh
        n_batch = mesh.devices.shape[0]
        src = (
            fetch(sources, "mesh sources")
            if isinstance(sources, torch.Tensor)
            else np.asarray(sources)
        ).astype(np.int64)
        parts = np.array_split(np.arange(len(src)), n_batch)
        arrays: dict = {}

        def on(dev):
            if dev not in arrays:
                arrays[dev] = (
                    _ell_on(ell, dev),
                    _put(edge_src, dev, torch.int32),
                    _put(edge_dst, dev, torch.int32),
                    _put(edge_metric, dev, torch.int32),
                    _put(edge_up, dev, torch.bool),
                    _put(node_overloaded, dev, torch.bool),
                )
            return arrays[dev]

        before = mesh.bytes_moved
        self.shard_shapes, self.sweeps = [], []
        dists, dags = [], []
        for bi, cols in enumerate(parts):
            devs = list(mesh.devices[bi])
            dist_t, dag = self._batch_shard(
                devs, on, src[cols],
                None if extra_mask_T is None else extra_mask_T[:, cols],
            )
            dists.append(dist_t.T)
            dags.append(dag)
        self.bytes_moved = mesh.bytes_moved - before
        first = mesh.first
        return cat(dists, 0, first), cat(dags, 0, first)

    def _batch_shard(self, devs, on, src, mask_T):
        """One batch shard's relax over its node shards `devs`:
        (dist_T [N_cap, S_b] in original ids, dag [S_b, E_cap]) on
        devs[0]."""
        mesh = self.mesh
        home = devs[0]
        ell, e_src, e_dst, metric, up, ov = on(home)
        sources = stage(src, home, torch.int32)
        extra = None if mask_T is None else _put(mask_T, home, torch.bool)
        allowed_T = ops.make_relax_allowed_T(sources, e_src, up, ov, extra)
        n_cap = int(ov.shape[0])
        s = len(src)
        dist0 = ops.make_dist0_T(sources, ell.new_of_old, n_cap)
        bounds = [
            (int(r[0]), int(r[-1]) + 1) if len(r) else (0, 0)
            for r in np.array_split(np.arange(n_cap), len(devs))
        ]
        relaxes, pieces = [], []
        for dev, (a, b) in zip(devs, bounds):
            d_ell, _, _, d_metric, d_up, d_ov = on(dev)
            d_allowed = None if extra is None else _to(allowed_T, dev)
            relaxes.append(
                ops._ell_relax(
                    d_ell, d_up, d_ov, d_metric, s, row_allowed_T=d_allowed,
                    rows=(a, b),
                )
            )
            pieces.append(_to(dist0[a:b], dev))
            self.shard_shapes.append((b - a, s))
        sweeps = 0
        while True:
            full = mesh.all_gather(pieces, devs)
            new = [relax(f) for relax, f in zip(relaxes, full)]
            sweeps += 1
            with fetch_point("mesh relax fixed point"):
                done = all(torch.equal(x, y) for x, y in zip(new, pieces))
            if done or sweeps > n_cap:
                break
            pieces = new
        self.sweeps.append(sweeps)
        dist_old_T = ops.ell_dist_to_old_T(full[0], ell)
        dag = ops.sp_dag_mask_from_T(dist_old_T, e_src, e_dst, metric, allowed_T)
        return dist_old_T, dag


def spf_step_sharded(mesh: Mesh) -> ShardedSpfStep:
    """The unmasked SPF step over `mesh` (all-sources tiles; no distance
    moves between shards on a batch-only mesh)."""
    return ShardedSpfStep(mesh, masked=False)


def sharded_spf_forward(
    mesh: Mesh, sources, ell, edge_src, edge_dst, edge_metric, edge_up,
    node_overloaded,
):
    """One-shot convenience wrapper around `spf_step_sharded`."""
    return spf_step_sharded(mesh)(
        sources, ell, edge_src, edge_dst, edge_metric, edge_up, node_overloaded
    )


def whatif_step_sharded(mesh: Mesh) -> ShardedSpfStep:
    """The masked SPF step for failure-scenario fleets: the rows are
    (source, exclusion-mask) variants, independent of each other, so
    the scenario axis splits over "batch" with no exchange beyond the
    optional node sharding of the state."""
    return ShardedSpfStep(mesh, masked=True)


def fleet_product_sharded(
    mesh: Mesh,
    n_sweeps: int,
    n_words: int,
    depth: int = 0,
    resid_rounds: int = 1,
    small_dist: bool = True,
    chord_mode: bool = True,
):
    """The mesh-sharded reduced all-sources product (ops.allsources): the
    DESTINATION axis P splits over the mesh's "batch" axis.

        dest_ids [P]          split over "batch"
        dist     [N, P]       split over "batch" (columns)
        bitmap   [N, P, W]    split over "batch" (columns)
        graph tables          replicated

    Returns a step taking (dest_ids, bg, r_edge_src, r_edge_dst,
    r_edge_metric, r_edge_up, node_overloaded, out, f_edge_metric,
    f_edge_up) — the reversed graph's `BandedGraph` and edge arrays, the
    node drain mask, the forward `OutEll` and the forward metric and up
    arrays, numpy or tensors — and returning (dist [N, P], bitmap
    [N, P, W] int32, ok host bool) on the mesh's first device.

    Each batch shard runs the port's single-device pipeline over its
    P/b columns on the first device of its batch row (the node axis
    holds replicas in the reference and adds nothing here):
    `ops.banded.spf_forward_banded` for `n_sweeps` supersweeps and one
    verification (uint16 product with `small_dist`), then the verify and
    ECMP bitmap through kernel K1 (`ops.epilogue.fused_epilogue`), once
    per shard.  `ok` is the AND
    over the shards of the relax's verdict (with `small_dist`, its
    uint16 saturation guard) and K1's: a product that did not converge
    within `n_sweeps` is refused even where its last sweep happened to
    reach the fixed point.  K1's bitmap reads the reverse binding's
    groups, so `f_edge_metric` and `f_edge_up` (the reference's bitmap
    inputs) are not read."""
    from ..ops import allsources as asrc
    from ..ops.banded import StagedArrays, _RelaxOps, spf_forward_banded
    from ..ops.epilogue import build_epilogue_groups, fused_epilogue

    relax_depth = 0 if chord_mode else depth

    def step(dest_ids, bg, r_edge_src, r_edge_dst, r_edge_metric, r_edge_up,
             node_overloaded, out, f_edge_metric=None, f_edge_up=None):
        maps = asrc.build_epilogue_maps(bg, out)
        dest = (
            fetch(dest_ids, "mesh destinations")
            if isinstance(dest_ids, torch.Tensor)
            else np.asarray(dest_ids)
        ).astype(np.int32)
        staged: dict = {}

        def on(dev):
            if dev not in staged:
                st = StagedArrays(
                    *(_put(a, dev, torch.int32)
                      for a in (bg.band_eid, bg.resid_nbr, bg.resid_eid)),
                    _put(r_edge_metric, dev, torch.int32),
                    _put(r_edge_up, dev, torch.bool),
                    _put(node_overloaded, dev, torch.bool),
                    None,
                    _put(r_edge_src, dev, torch.int32),
                    _put(r_edge_dst, dev, torch.int32),
                )
                relax = _RelaxOps(
                    bg, st, relax_depth, resid_rounds, chord_mode, small_dist
                )
                groups = build_epilogue_groups(
                    relax,
                    _put(maps.resid_slot, dev),
                    _put(maps.band_slot, dev),
                    n_words,
                )
                staged[dev] = (st, groups)
            return staged[dev]

        dists, bitmaps, verdicts = [], [], []
        for bi, part in enumerate(np.array_split(dest, mesh.devices.shape[0])):
            dev = mesh.devices[bi, 0]
            st, groups = on(dev)
            d, _, relaxed = spf_forward_banded(
                stage(part, dev),
                bg,
                st,
                n_sweeps,
                depth=relax_depth,
                resid_rounds=resid_rounds,
                small_dist=small_dist,
                want_dag=False,
                chord_mode=chord_mode,
                raw_u16=True,
            )
            bitmap, verified = fused_epilogue(d, *groups, n_words)
            dists.append(d)
            bitmaps.append(bitmap)
            verdicts.append(relaxed & verified)
        first = mesh.first
        ok = all(bool(v) for v in verdicts)
        return cat(dists, 1, first), cat(bitmaps, 1, first), ok

    return step
