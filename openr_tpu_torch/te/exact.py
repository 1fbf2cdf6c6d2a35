"""Exact evaluation of a TE metric candidate.

Port of `openr_tpu.te.exact`.  The acceptance gate of the TE optimizer:
a rounded integer metric vector is scored by the same exact solver the
fleet view publishes from, `ops.allsources.reduced_all_sources` over a
reversed SpfRunner built for the candidate metrics (on a banded
topology its epilogue is the K1 kernel), and the demand matrix is pushed
over the resulting hard-ECMP splits (equal division over min-cost
out-edges, the reference nextHops rule) in distance order.  No float
enters the distance computation; the load push is host numpy in float64
over the integer distances.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..device.engine import resolve_device
from ..device.sanitizer import fetch
from ..ops import allsources as asrc
from ..ops.banded import SpfRunner, build_banded
from ..ops.sssp import INF32, build_ell, u16_dist_to_i32


def _normalize_dist(dist: torch.Tensor, n_cap: int) -> np.ndarray:
    """reduced_all_sources dist -> int64 [n_cap, P] numpy with the INF32
    sentinel: a uint16 product widens on its device first, and the
    banded path's n_nodes rows are padded to the ELL path's n_cap."""
    if dist.dtype == torch.uint16:
        dist = u16_dist_to_i32(dist)
    d = fetch(dist, "exact distances").astype(np.int64)
    if d.shape[0] < n_cap:
        pad = np.full((n_cap - d.shape[0], d.shape[1]), INF32, np.int64)
        d = np.concatenate([d, pad], axis=0)
    return d


def push_loads(
    dist: np.ndarray,  # [>=n_nodes, P] int64, INF32 sentinel
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_metric: np.ndarray,
    edge_up: np.ndarray,
    node_overloaded: np.ndarray,
    n_edges: int,
    demand: np.ndarray,  # [n_cap, P] float
) -> np.ndarray:
    """Per-edge load [n_edges] under exact ECMP splits.

    For every destination column: an edge u->v is a next-hop edge iff
    metric + dist(v) == dist(u) (LFA-free equality,
    openr/decision/Decision.cpp:1296-1300) with the drain exception
    (overloaded v relays only as the destination itself).  Demand is
    pushed in strictly descending dist(u) order: next-hop edges strictly
    decrease the distance, so one vectorized pass per distance level
    conserves flow exactly."""
    e = int(n_edges)
    src = np.asarray(edge_src[:e], dtype=np.int64)
    dst = np.asarray(edge_dst[:e], dtype=np.int64)
    met = np.asarray(edge_metric[:e], dtype=np.int64)
    up = np.asarray(edge_up[:e], dtype=bool)
    over = np.asarray(node_overloaded, dtype=bool)
    load = np.zeros(e, dtype=np.float64)
    for p in range(dist.shape[1]):
        d = dist[:, p]
        ecmp = (
            up
            & (d[src] > 0)
            & (d[src] < INF32)
            & (d[dst] < INF32)
            & (met + d[dst] == d[src])
            & ~(over[dst] & (d[dst] > 0))
        )
        eidx = np.nonzero(ecmp)[0]
        if not len(eidx):
            continue
        deg = np.bincount(src[eidx], minlength=len(over))
        f = np.asarray(demand[:, p], dtype=np.float64).copy()
        order = np.argsort(-d[src[eidx]], kind="stable")
        eidx = eidx[order]
        dsrc = d[src[eidx]]
        _, starts = np.unique(-dsrc, return_index=True)
        bounds = np.append(starts, len(eidx))
        for gi in range(len(starts)):
            es = eidx[bounds[gi]: bounds[gi + 1]]
            fe = f[src[es]] / deg[src[es]]
            load[es] += fe
            np.add.at(f, dst[es], fe)
    return load


class ExactEvaluator:
    """Scores integer metric candidates for one (topology, demand) pair.

    The structure-only tables (the reversed edge permutation, its banded
    decomposition, the forward out-edge table) are built once; each
    `distances` builds the candidate's reversed runner (a metric change
    is a topology restage: the ELL when there are no bands), stages it
    on the device and runs the exact product, through the engine's
    `dispatch("te_exact", ...)` with its counting K1 front end when an
    engine is attached.  Computes on the engine's device, else on
    `device` (the CUDA card when None).

    `last_ms` splits the last `evaluate` into its host tables
    (`tables`), the staged product up to its fetched distances
    (`product`) and the load push (`push`)."""

    def __init__(
        self,
        edge_src: np.ndarray,
        edge_dst: np.ndarray,
        edge_up: np.ndarray,
        node_overloaded: np.ndarray,
        n_edges: int,
        n_nodes: int,
        dest_ids: np.ndarray,
        demand: np.ndarray,
        capacity: np.ndarray,
        engine=None,
        device=None,
    ) -> None:
        self.edge_src = np.asarray(edge_src, dtype=np.int32)
        self.edge_dst = np.asarray(edge_dst, dtype=np.int32)
        self.edge_up = np.asarray(edge_up, dtype=bool)
        self.node_overloaded = np.asarray(node_overloaded, dtype=bool)
        self.n_edges = int(n_edges)
        self.n_nodes = int(n_nodes)
        self.n_cap = len(self.node_overloaded)
        self.e_cap = len(self.edge_src)
        self.dest_ids = np.asarray(dest_ids, dtype=np.int32)
        self.demand = np.asarray(demand, dtype=np.float64)
        self.capacity = np.asarray(capacity, dtype=np.float64)
        self.engine = engine
        self.device = engine.device if engine is not None else resolve_device(device)
        e = self.n_edges
        pad = self.n_cap - 1
        # reversed-edge layout, sorted by (dst, src) like every mirror
        rsrc, rdst = self.edge_dst[:e], self.edge_src[:e]
        self._rev_order = np.lexsort((rsrc, rdst))
        self._rev_src = np.full(self.e_cap, pad, dtype=np.int32)
        self._rev_dst = np.full(self.e_cap, pad, dtype=np.int32)
        self._rev_up = np.zeros(self.e_cap, dtype=bool)
        self._rev_src[:e] = rsrc[self._rev_order]
        self._rev_dst[:e] = rdst[self._rev_order]
        self._rev_up[:e] = self.edge_up[:e][self._rev_order]
        self._rev_banded = build_banded(
            self._rev_src, self._rev_dst, e, self.n_nodes
        )
        self._out = asrc.build_out_ell(
            self.edge_src, self.edge_dst, e, self.n_nodes
        )
        self._hint: Optional[int] = None
        self.last_ms: dict[str, float] = {}

    def _runner(self, metric: np.ndarray) -> SpfRunner:
        """The candidate's reversed runner, staged on the device."""
        e = self.n_edges
        rev_metric = np.ones(self.e_cap, dtype=np.int32)
        rev_metric[:e] = metric[:e][self._rev_order]
        ell = None
        if self._rev_banded is None:
            ell = build_ell(
                self._rev_src, self._rev_dst, rev_metric, self._rev_up,
                self.node_overloaded, e,
            )
        runner = SpfRunner(
            ell, self._rev_banded, self._rev_src, self._rev_dst,
            rev_metric, self._rev_up, self.node_overloaded, e,
        )
        if self._hint is not None:
            runner.hint = self._hint
        if self.engine is not None:
            self.engine.stage(runner)
        else:
            runner.stage(self.device)
        return runner

    def distances(self, metric: np.ndarray) -> np.ndarray:
        """Exact int64 [n_cap, P] distances for integer metrics [E_cap]."""
        t0 = time.perf_counter()
        met = np.asarray(metric, dtype=np.int32)
        runner = self._runner(met)
        t1 = time.perf_counter()
        args = (
            self.dest_ids, runner, self._out,
            met, self.edge_up, self.node_overloaded,
        )
        if self.engine is not None:
            dist, _bitmap, ok = self.engine.dispatch(
                "te_exact", asrc.reduced_all_sources, *args,
                epilogue=self.engine.epilogue,
            )
        else:
            dist, _bitmap, ok = asrc.reduced_all_sources(*args)
        # one fetch of the distances: the load push consumes them on the
        # host; the verdict is a host bool already
        out = _normalize_dist(dist, self.n_cap)
        # openr: disable=device-dispatch-sync
        assert ok, "te: exact reverse SSSP did not reach its fixed point"
        self._hint = runner.hint  # learned sweep depth carries over
        self.last_ms = {
            "tables": (t1 - t0) * 1e3,
            "product": (time.perf_counter() - t1) * 1e3,
        }
        return out

    def evaluate(self, metric: np.ndarray) -> float:
        """Exact max-utilization of an integer metric candidate."""
        dist = self.distances(metric)
        t0 = time.perf_counter()
        load = push_loads(
            dist, self.edge_src, self.edge_dst, metric, self.edge_up,
            self.node_overloaded, self.n_edges, self.demand,
        )
        util = load / self.capacity[: self.n_edges]
        util = np.where(self.edge_up[: self.n_edges], util, 0.0)
        self.last_ms["push"] = (time.perf_counter() - t0) * 1e3
        return float(util.max()) if len(util) else 0.0
