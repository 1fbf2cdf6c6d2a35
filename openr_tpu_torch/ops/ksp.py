"""Fused k = 2 edge-disjoint shortest paths on the bands.

Port of `openr_tpu.ops.ksp` (BASELINE.json config #3, dual-metric KSP).
The reference router computes k edge-disjoint shortest paths by
re-running Dijkstra with the earlier paths' links excluded and tracing
each path on the host between runs (openr/decision/LinkState.cpp:763-793
getKthPaths, traceOnePath :399-418).  Here one call per metric plane
runs the base SPF with its SP-DAG, walks every destination's shortest
path backwards on the device, builds the per-destination exclusion
masks, and runs the masked k = 2 batch: no host trace between the runs.

The walk takes, at each node, the FIRST SP-DAG in-edge in the (dst,
src)-sorted edge order, the tie the host trace takes (its cand[0]), for
at most `max_hops` steps; a walker stops at the source (distance 0) or
on an unreachable node.  Traced edges and their reverse twins are
excluded; unused trace slots hold E_cap - 1, which must be a padding
edge (always down), so it excludes nothing real.  Banded runners only
(the 100k WAN); topologies without bands take the per-destination
masked batch of decision.spf_solver.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device.sanitizer import fetch, fetch_point, stage
from .banded import pick_small_dist, spf_forward_banded
from .sssp import INF32


class Ksp2PlaneResult(NamedTuple):
    k1: torch.Tensor  # [D] int32 — shortest distance per destination
    k2: torch.Tensor  # [D] int32 — edge-disjoint second distance (INF32 none)
    excl: torch.Tensor  # [D, max_hops] int32 — excluded edge ids (pad E_cap-1)
    ok_base: torch.Tensor  # 0-dim bool — base relax converged
    ok_masked: torch.Tensor  # 0-dim bool — masked batch converged
    trace_ok: torch.Tensor  # 0-dim bool — every walker ended on src/unreachable


def build_in_start(edge_dst: np.ndarray, n_edges: int, n_nodes: int) -> np.ndarray:
    """[N+1] int32: the in-edges of v are the run [in_start[v],
    in_start[v+1]) of the (dst, src)-sorted edge arrays."""
    return np.searchsorted(edge_dst[:n_edges], np.arange(n_nodes + 1)).astype(
        np.int32
    )


def _trace_paths(
    d_row: torch.Tensor,  # [N] int32 — base distances from the source
    dag_row: torch.Tensor,  # [E_cap] bool — SP-DAG of the base run
    dest_ids: torch.Tensor,  # [D] int32
    edge_src: torch.Tensor,  # [E_cap] int32
    in_start: torch.Tensor,  # [N+1] int32
    max_hops: int,
    k_in: int,
):
    """Backward walk of every destination at once: per step each walker
    takes the first SP-DAG in-edge of its node and moves to that edge's
    source.  Returns (excl [D, max_hops] int32 edge ids padded with
    E_cap - 1, trace_ok 0-dim bool): trace_ok is False when a walker is
    still short of the source or found no DAG in-edge."""
    d = int(dest_ids.shape[0])
    device = d_row.device
    pad = int(edge_src.shape[0]) - 1
    offs = torch.arange(k_in, dtype=torch.int32, device=device)
    v = dest_ids.long()
    excl = torch.full((d, max_hops), pad, dtype=torch.int32, device=device)
    err = torch.zeros(d, dtype=torch.bool, device=device)
    for t in range(max_hops):
        dv = d_row[v]
        active = (dv > 0) & (dv < INF32)
        base = in_start[v]
        deg = in_start[v + 1] - base
        valid = offs[None, :] < deg[:, None]
        eids = torch.where(valid, base[:, None] + offs[None, :], pad)
        bits = dag_row[eids.long()] & valid  # [D, K]
        has = bits.any(1)
        # argmax returns the first maximal index: the first DAG in-edge
        e_sel = eids.gather(1, bits.to(torch.uint8).argmax(1, keepdim=True))[:, 0]
        step = active & has
        excl[:, t] = torch.where(step, e_sel, pad)
        v = torch.where(step, edge_src[e_sel.long()].long(), v)
        err |= active & ~has
    dv = d_row[v]
    trace_ok = ((dv == 0) | (dv >= INF32)).all() & ~err.any()
    return excl, trace_ok


def fused_ksp2_banded(
    src: torch.Tensor,  # [1] int32
    dest_ids: torch.Tensor,  # [D] int32
    bg,  # ops.banded.BandedGraph
    st,  # ops.banded.StagedArrays of the runner
    metric_planes: torch.Tensor,  # [P, E_cap] int32, one row per cost plane
    in_start: torch.Tensor,  # [N+1] int32
    rev_eid: torch.Tensor,  # [E_cap] int32 — reverse directed edge, -1 none
    n_sweeps_base: int,
    n_sweeps_masked: int,
    depth: int,
    resid_rounds: int,
    small_dist: bool,
    max_hops: int,
    k_in: int,
    chord_mode: bool = False,
) -> list[Ksp2PlaneResult]:
    """Per metric plane: base SPF with its SP-DAG -> path trace ->
    edge-disjoint masked batch (reference: ops/ksp.py
    fused_ksp2_banded).  Edge-disjointness excludes both directions of
    every traced link (the reference router's link exclusion,
    LinkState.cpp:778-785).  Everything stays on the device of `st`."""
    d = int(dest_ids.shape[0])
    e_cap = int(st.edge_src.shape[0])
    rows = torch.arange(d, device=dest_ids.device)
    results = []
    for p in range(metric_planes.shape[0]):
        plane = st._replace(edge_metric=metric_planes[p])
        dist, dag, ok_base = spf_forward_banded(
            src, bg, plane, n_sweeps_base, depth=depth,
            resid_rounds=resid_rounds, small_dist=small_dist,
            want_dag=True, chord_mode=chord_mode,
        )
        d_row = dist[:, 0]
        excl, trace_ok = _trace_paths(
            d_row, dag[0], dest_ids, st.edge_src, in_start, max_hops, k_in
        )
        rev_e = rev_eid[excl.long()]
        rev_e = torch.where(rev_e >= 0, rev_e, e_cap - 1)
        mask = torch.ones((d, e_cap), dtype=torch.bool, device=dest_ids.device)
        mask[rows[:, None], excl.long()] = False
        mask[rows[:, None], rev_e.long()] = False
        dist2, _, ok_masked = spf_forward_banded(
            src.expand(d), bg, plane, n_sweeps_masked, depth=depth,
            resid_rounds=resid_rounds, extra_edge_mask=mask,
            small_dist=small_dist, want_dag=False, chord_mode=chord_mode,
        )
        dl = dest_ids.long()
        results.append(
            Ksp2PlaneResult(
                d_row[dl], dist2[dl, rows], excl, ok_base, ok_masked, trace_ok
            )
        )
    return results


class FusedKsp2Runner:
    """Host driver of `fused_ksp2_banded` over a staged banded runner
    (reference: ops/ksp.py FusedKsp2Runner): learns the sweep hints
    through the runner's own `forward` (its `adapt`), then answers a
    whole multi-plane KSP2 question in one call.

    The metric planes are fixed at construction and copied to the
    runner's device once, with the reverse-edge table and the in-edge
    offsets.  The runner's `runs`, `masked_runs` and `sweeps` count the
    fused call's base and masked runs.  A caller that changes the
    topology's arrays builds a new instance."""

    def __init__(
        self, runner, topo_edge_dst, n_edges, n_nodes, rev_eid, metric_planes
    ):
        if runner.bg is None:
            raise ValueError("fused KSP2 needs a banded runner")
        st = runner.call_arrays()
        e_cap = int(runner.arrays[0].shape[0])
        # the trace and mask pad id is E_cap - 1: it must be a padding
        # edge, or it would mask a real edge for every destination
        if n_edges >= e_cap:
            raise ValueError("edge capacity leaves no padding edge")
        device = st.edge_up.device
        self.runner = runner
        self.n_edges = n_edges
        self.planes_np = [np.asarray(m, dtype=np.int32) for m in metric_planes]
        self.planes = stage(np.stack(self.planes_np), device)
        self.planes_small = all(pick_small_dist(m, n_edges) for m in self.planes_np)
        in_start_np = build_in_start(np.asarray(topo_edge_dst), n_edges, n_nodes)
        self.in_start = stage(in_start_np, device)
        rev_full = np.full(e_cap, -1, dtype=np.int32)
        rev_full[: len(rev_eid)] = rev_eid
        self.rev_eid_np = rev_full
        self.rev_eid = stage(rev_full, device)
        self.k_in = max(1, int(np.diff(in_start_np).max()))
        # hop bound of the trace; grows when a converged base leaves
        # walkers short, and later calls reuse the learned bound
        self.learned_max_hops = 128

    def _fused_call(self, src, dests, max_hops: int) -> list[Ksp2PlaneResult]:
        r = self.runner
        n_planes = len(self.planes_np)
        r.runs += 2 * n_planes
        r.masked_runs += n_planes
        r.sweeps += n_planes * (r.hint + r.hint_masked + 2)
        return fused_ksp2_banded(
            src,
            dests,
            r.bg,
            r.call_arrays(),
            self.planes,
            self.in_start,
            self.rev_eid,
            n_sweeps_base=r.hint,
            n_sweeps_masked=r.hint_masked,
            depth=r.depth,
            resid_rounds=r.resid_rounds,
            small_dist=r.small_allowed and self.planes_small,
            max_hops=max_hops,
            k_in=self.k_in,
            chord_mode=r.chord_mode,
        )

    def _host_masks(self, res: list[Ksp2PlaneResult], d: int) -> list:
        """[D, E_cap] numpy exclusion masks rebuilt from each plane's
        traced edges, to teach hint_masked through forward()."""
        e_cap = int(self.runner.arrays[0].shape[0])
        masks = []
        for r in res:
            excl = fetch(r.excl, "ksp excluded edges")
            mask = np.ones((d, e_cap), dtype=bool)
            for i in range(d):
                ee = excl[i]
                ee = ee[ee < self.n_edges]
                mask[i, ee] = False
                rv = self.rev_eid_np[ee]
                mask[i, rv[rv >= 0]] = False
            masks.append(mask)
        return masks

    def run(
        self,
        src: int,
        dest_ids: np.ndarray,
        max_hops: int | None = None,
        adaptive: bool = True,
    ) -> list[Ksp2PlaneResult]:
        """One fused call over all planes.  With `adaptive`, the base hint
        is learned per plane through the runner's forward(), the hop
        bound quadruples while a converged base leaves walkers short,
        and a masked batch that did not converge teaches hint_masked on
        the real exclusion masks through forward() before the call is
        made again; a result still unconverged then raises.  Warm-up
        costs a few extra runs, a warm question one call."""
        r = self.runner
        if max_hops is None:
            max_hops = self.learned_max_hops
        device = self.planes.device
        src_np = np.asarray([src], dtype=np.int32)
        dest_np = np.asarray(dest_ids, dtype=np.int32)
        src_t = stage(src_np, device)
        dest_t = stage(dest_np, device)
        if adaptive:
            for m in self.planes_np:
                r.forward(src_np, want_dag=False, metric_plane=m)
        res = self._fused_call(src_t, dest_t, max_hops)
        if not adaptive:
            return res
        n_nodes = int(self.in_start.shape[0]) - 1
        while self._verdict(res, "ok_base") and not self._verdict(res, "trace_ok"):
            # a shortest path has fewer than N hops: the growth ends
            if max_hops >= n_nodes:
                raise RuntimeError(f"path trace did not end in {max_hops} hops")
            max_hops = min(max_hops * 4, n_nodes)
            self.learned_max_hops = max_hops
            res = self._fused_call(src_t, dest_t, max_hops)
        if not self._verdict(res, "ok_masked"):
            srcs = np.full(len(dest_np), src, dtype=np.int32)
            for p, mask in enumerate(self._host_masks(res, len(dest_np))):
                r.forward(
                    srcs,
                    extra_edge_mask=mask,
                    want_dag=False,
                    metric_plane=self.planes_np[p],
                )
            res = self._fused_call(src_t, dest_t, max_hops)
        if not all(
            self._verdict(res, k) for k in ("ok_base", "ok_masked", "trace_ok")
        ):
            raise RuntimeError("fused KSP2 warm-up did not converge")
        return res

    @staticmethod
    def _verdict(res, name: str) -> bool:
        """All planes' `name` verdict, read on the host."""
        with fetch_point("ksp verdicts"):
            return all(bool(getattr(x, name)) for x in res)
