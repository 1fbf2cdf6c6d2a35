"""Decision-side coalescer of the incremental delta rung.

Port of `openr_tpu.decision.delta`.  `DeltaProductUpdater` folds every
LinkState change since the previous converged fleet view (link up or
down, metric changes, drains: k pending events) into that view's device
product as ONE frontier certification plus ONE frontier-sized relax
through `DeviceResidencyEngine.delta_dispatch` (ops.delta), instead of a
full [N, P] product.  The safety argument is the warm gates',
generalized to mixed batches:

- worsened slots (pairs removed or raised, newly drained transit) seed
  the support-loss fixpoint over the OLD graph (`_worsened_masks`, OLD
  layout);
- improved slots (pairs added or lowered, undrained transit) fire the
  NEW graph's exact candidates against the old distances
  (`_improved_masks`, NEW layout), at cand <= d;
- every column outside either set is proven unchanged and kept; the
  flagged columns re-relax from the worsening upper bound and re-certify
  on the device.

Every designed gate returns False and counts `decision.delta.fallbacks`:
a changed universe, no bands or another distance dtype, a drift of the
bitmap's word count, too many re-ranked out-rows, an uncertified
frontier, a frontier over the bucket ladder, a relax without its
certificate; the caller (FleetViewCache.view) then runs the legacy warm
or cold path, the bit-exact fallback.  After a relax without its
certificate the previous view is killed, so the legacy path goes cold,
as in the reference.  An optional parity gate (OPENR_DELTA_PARITY=1)
recomputes the cold product after every update and adopts it on a
mismatch, counting `decision.delta.parity_failures`.

Deliberate difference from the reference: it wraps the runner build
and all three dispatches in catch-alls that turn any exception into a
fallback.  The port catches only EpochMismatchError (a change landed
between coalescing and dispatch), counted as a fallback; any other
exception, such as a CUDA error or a failed K1 launch, propagates, so no
device fault hides behind the legacy path.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..device.engine import DeviceResidencyEngine, EpochMismatchError
from ..ops import allsources as asrc
from ..ops import delta as dops
from .fleet import FleetRouteView, _in_sorted, _reverse_runner, _worsened_masks

# pre-seeded into SpfSolver.counters, so the family is visible before the
# rung first engages
DELTA_COUNTER_KEYS = (
    "decision.delta.updates",
    "decision.delta.noop_updates",
    "decision.delta.events_coalesced",
    "decision.delta.dispatches",
    "decision.delta.affected_cols",
    "decision.delta.fallbacks",
    "decision.delta.parity_checks",
    "decision.delta.parity_failures",
)


def _improved_masks(prev: FleetRouteView, new: FleetRouteView, new_runner):
    """Per-reverse-slot masks of IMPROVED forward edges in the NEW view's
    reverse-runner layout (residual [N, K], bands [B, N]): the mirror of
    `_worsened_masks`.  Improved: a usable directed pair absent from the
    old table (a link up), a pair with a smaller min metric, or transit
    through a node that dropped its overload bit (every reverse slot
    whose neighbour is that node, the destination-row exception
    included, which only over-marks).  The keys are the port's
    (dst << 32) | src: reverse slot (v, k) with neighbour u is the
    forward edge v -> u."""
    old_keys, old_met = prev._edge_keys, prev._edge_met
    new_keys, new_met = new._edge_keys, new._edge_met
    present = _in_sorted(old_keys, new_keys)
    better = ~present
    if len(old_keys):
        pos = np.minimum(np.searchsorted(old_keys, new_keys), len(old_keys) - 1)
        better |= present & (new_met < old_met[pos])
    good_keys = new_keys[better]
    ov_drop = prev._overloaded & ~new._overloaded
    bg = new_runner.bg
    n = bg.n_nodes
    rn, re_ = bg.resid_nbr, bg.resid_eid
    v_ids = np.arange(n, dtype=np.int64)
    qk = (rn.astype(np.int64) << 32) | v_ids[:, None]
    improved_resid = (re_ >= 0) & (_in_sorted(good_keys, qk) | ov_drop[rn])
    rows = []
    for b, c in enumerate(bg.offsets):
        u = (v_ids - c) % n
        qk = (u << 32) | v_ids
        rows.append(
            (bg.band_eid[b] >= 0) & (_in_sorted(good_keys, qk) | ov_drop[u])
        )
    return improved_resid, np.stack(rows)


def _changed_out_rows(prev_out: asrc.OutEll, new_out: asrc.OutEll) -> Optional[np.ndarray]:
    """Node ids whose out-edge table row changed: their bitmap words need
    re-encoding even where no route changed, because OutEll.slot is the
    rank among sorted unique out-neighbours.  None when the table shapes
    differ (the caller falls back); order drift inside a row only
    over-marks."""
    on, nn = prev_out.nbr, new_out.nbr
    if on.shape != nn.shape:
        return None
    ov, nv = prev_out.eid >= 0, new_out.eid >= 0
    diff = (ov != nv) | (nv & ((on != nn) | (prev_out.slot != new_out.slot)))
    return np.flatnonzero(diff.any(axis=1)).astype(np.int32)


class DeltaProductUpdater:
    """One attempt folds one coalesced event batch into the previous
    view's device product, or returns False (the caller takes the legacy
    path).  `bump` is the counter sink (SpfSolver._bump; None counts
    nothing); below `min_p` destinations the full product is one cheap
    program and the rung stands aside.  `last_cols`, `last_pb`,
    `last_blocks` and `last_passes` attribute the last attempt's work:
    affected columns, slab width, relax blocks and frontier passes."""

    def __init__(
        self,
        bump=None,
        min_p: int = 32,
        parity: Optional[bool] = None,
        max_iters: int = 128,
    ) -> None:
        self._bump_fn = bump
        self.min_p = min_p
        self.max_iters = max_iters
        if parity is None:
            parity = os.environ.get("OPENR_DELTA_PARITY", "0") == "1"
        self.parity = parity
        self.last_blocks: Optional[int] = None
        self.last_pb: Optional[int] = None
        self.last_cols = 0
        self.last_passes: Optional[int] = None

    def _bump(self, name: str, delta: int = 1) -> None:
        if self._bump_fn is not None:
            self._bump_fn(name, delta)

    def eligible(self, prev: Optional[FleetRouteView]) -> bool:
        """Host-only screen of the previous view; `update` re-checks
        everything it needs."""
        return (
            prev is not None
            and prev.converged
            and prev._dist_dev is not None
            and prev._bitmap_dev is not None
            and prev._runner is not None
            and prev._runner.bg is not None
            and prev._out is not None
            and len(prev.dest_names) >= self.min_p
        )

    def _fallback(self) -> bool:
        self._bump("decision.delta.fallbacks")
        return False

    def update(
        self, prev: FleetRouteView, view: FleetRouteView, engine: DeviceResidencyEngine
    ) -> bool:
        """Fold the prev -> view LinkState delta into prev's device product
        and finish `view` from it (warm_mode "delta").  False means the
        caller must run the legacy path.  The product is updated in
        place, so prev gives up its tensors to `view` (or, after a relax
        without its certificate or an epoch refusal past the frontier,
        is killed: the legacy path then goes cold)."""
        if engine is None or not self.eligible(prev):
            return False
        if (
            prev.dest_names != view.dest_names
            or prev._node_id != view._node_id
            or prev._overloaded.shape != view._overloaded.shape
        ):
            return False  # the universe changed: columns are not comparable
        csr = view.csr
        prev_small = prev._dist_dev.dtype == torch.uint16
        runner = _reverse_runner(csr)
        if runner.bg is None or runner.small_dist != prev_small:
            # no bands, or the distance dtype must change
            return self._fallback()
        out = asrc.build_out_ell(
            csr.edge_src, csr.edge_dst, csr.n_edges, csr.n_nodes,
            out_slot=csr.out_slot,
        )
        if out.n_words != prev._out.n_words:
            return self._fallback()
        changed_rows = _changed_out_rows(prev._out, out)
        if changed_rows is None or 2 * len(changed_rows) > csr.n_nodes:
            # table shape drift, or a re-encode that would rival a full
            # bitmap pass
            return self._fallback()
        events = max(1, int(view.version) - int(prev.version))
        engine.stage(runner)
        device = engine.device
        worsened_resid, worsened_band = _worsened_masks(
            prev, view._edge_keys, view._edge_met, view._overloaded
        )
        improved_resid, improved_band = _improved_masks(prev, view, runner)

        p = len(view.dest_names)
        epoch = int(csr.version)
        topo_key = (csr.n_nodes, csr.n_edges, p)
        try:
            aff, col_mask, done, passes = engine.delta_dispatch(
                "frontier",
                dops.delta_frontier,
                prev._dist_dev,
                prev._runner.bg,
                prev._runner.call_arrays(),
                torch.from_numpy(worsened_resid).to(device),
                torch.from_numpy(worsened_band).to(device),
                runner.bg,
                runner.call_arrays(),
                improved_resid,
                improved_band,
                max_iters=self.max_iters,
                csr=csr,
                expect_epoch=epoch,
            )
        except EpochMismatchError:
            return self._fallback()
        self._bump("decision.delta.dispatches")
        self.last_passes = passes
        if not done:
            # an under-propagated frontier is silently wrong
            return self._fallback()
        col_idx = np.flatnonzero(col_mask.cpu().numpy()).astype(np.int32)
        n_cols = len(col_idx)
        self.last_cols = n_cols
        if n_cols == 0 and len(changed_rows) == 0:
            # certified no-op: adopt the previous tensors verbatim
            self._adopt(prev, view, runner, out, prev._dist_dev, prev._bitmap_dev)
            self.last_blocks, self.last_pb = 0, 0
            self._bump("decision.delta.noop_updates")
            self._bump("decision.delta.events_coalesced", events)
            return True

        new_dist, new_bm = prev._dist_dev, prev._bitmap_dev
        blocks = 0
        pb = 0
        if n_cols:
            pb = engine.delta_bucket(n_cols, p)
            if pb is None:
                # the full product is the cheaper program for this batch
                return self._fallback()
            col_pad = np.full(pb, col_idx[0], dtype=np.int32)
            col_pad[:n_cols] = col_idx
            dest_ids = np.asarray(
                [view._node_id[d] for d in view.dest_names], dtype=np.int32
            )
            maps = asrc.build_epilogue_maps(runner.bg, out)
            try:
                new_dist, new_bm, conv, blocks = engine.delta_dispatch(
                    "relax",
                    dops.delta_relax,
                    new_dist,
                    new_bm,
                    aff,
                    col_pad,
                    n_cols,
                    dest_ids,
                    runner,
                    maps,
                    out.n_words,
                    engine.epilogue,
                    csr=csr,
                    expect_epoch=epoch,
                    bucket_key=(
                        "relax", topo_key, pb, out.n_words, prev_small,
                        runner.depth, runner.chord_mode,
                    ),
                )
            except EpochMismatchError:
                self._kill(prev)
                return self._fallback()
            finally:
                # the product is written in place: prev's tensors are
                # the new view's, or dead
                prev._dist_dev = None
                prev._bitmap_dev = None
                prev._rows = {}
            self._bump("decision.delta.dispatches")
            if not conv:
                # the block budget ran out without the certificate
                self._kill(prev)
                return self._fallback()
        if len(changed_rows):
            rb = 1
            while rb < len(changed_rows):
                rb *= 2
            row_pad = np.full(rb, changed_rows[0], dtype=np.int32)
            row_pad[: len(changed_rows)] = changed_rows

            def forward(a, dtype):
                return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

            try:
                new_bm = engine.delta_dispatch(
                    "rows_bitmap",
                    dops.delta_rows_bitmap,
                    new_bm,
                    new_dist,
                    row_pad,
                    len(changed_rows),
                    out,
                    forward(csr.edge_metric, torch.int32),
                    forward(csr.edge_up, torch.bool),
                    forward(csr.node_overloaded, torch.bool),
                    out.n_words,
                    csr=csr,
                    expect_epoch=epoch,
                    bucket_key=("rows", topo_key, rb, out.n_words),
                )
            except EpochMismatchError:
                self._kill(prev)
                return self._fallback()
            finally:
                prev._dist_dev = None
                prev._bitmap_dev = None
                prev._rows = {}
            self._bump("decision.delta.dispatches")

        self._adopt(prev, view, runner, out, new_dist, new_bm)
        self.last_blocks = int(blocks)
        self.last_pb = int(pb)
        self._bump("decision.delta.updates")
        self._bump("decision.delta.events_coalesced", events)
        self._bump("decision.delta.affected_cols", n_cols)
        if self.parity:
            self._parity_gate(view, engine)
        return True

    @staticmethod
    def _kill(prev: FleetRouteView) -> None:
        """Make prev unusable for the legacy warm gates (they need a
        converged view with live tensors): the rebuild then goes cold."""
        prev._dist_dev = None
        prev._bitmap_dev = None
        prev._rows = {}
        prev.converged = False

    @staticmethod
    def _adopt(prev, view, runner, out, dist, bitmap) -> None:
        view._dist_dev = dist
        view._bitmap_dev = bitmap
        view._out = out
        view._runner = runner
        view.converged = True
        view.warm = True
        view.warm_mode = "delta"
        # the delta path learns no cold sweep count: carry prev's
        view.sweep_hint = prev.sweep_hint
        prev._dist_dev = None
        prev._bitmap_dev = None
        prev._rows = {}

    def _parity_gate(self, view: FleetRouteView, engine: DeviceResidencyEngine) -> None:
        """Recompute the cold product of the same snapshot and require it
        bit for bit; on a mismatch the oracle's tensors replace the delta
        result and `decision.delta.parity_failures` records the fault."""
        self._bump("decision.delta.parity_checks")
        oracle = FleetRouteView(view.csr, view.dest_names, engine)
        oracle.compute()
        d_a, d_o = view._dist_dev, oracle._dist_dev
        n = oracle._runner.bg.n_nodes if oracle._runner.bg is not None else d_o.shape[0]
        if d_a.dtype == torch.uint16 and d_o.dtype == torch.uint16:
            d_a, d_o = d_a.view(torch.int16), d_o.view(torch.int16)
        if (
            view._dist_dev.dtype != oracle._dist_dev.dtype
            or not torch.equal(d_a[:n], d_o[:n])
            or not torch.equal(view._bitmap_dev, oracle._bitmap_dev)
        ):
            self._bump("decision.delta.parity_failures")
            view._dist_dev = oracle._dist_dev
            view._bitmap_dev = oracle._bitmap_dev
            view._out = oracle._out
            view._runner = oracle._runner
            view._rows = {}
