"""TE optimizer loop: descend soft, validate exact, publish only wins.

Port of `openr_tpu.te.optimizer`.  `TeOptimizer.optimize` runs
temperature-annealed projected Adam on the smoothed objective (te.soft,
its gradient through torch.autograd), and after each anneal stage
rounds the float metric vector to the integer box and scores it through
the exact solver (te.exact.ExactEvaluator).  A candidate is accepted
only when the exact max-utilization strictly improves; the best
exactly-validated candidate is what `publish` receives: route state
never derives from the smoothed model.

The descent state lives on the optimizer's device (the engine's when
one is attached, else `device`, the CUDA card when None), and each
descent step goes through the engine's `dispatch("te_step", ...)` when
there is an engine.

Epoch discipline: when `epoch_fn` / `expect_epoch` are given (the
serving layer pins them at admission), every descent step and every
exact round trip re-checks the topology version and raises
`EpochMismatchError` on a flap: an optimization against a moved
topology aborts (`te.aborted`) and never publishes.

Counters (`te.*`, TE_COUNTER_KEYS) are pre-seeded at construction.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..device.engine import EpochMismatchError, resolve_device
from . import soft
from .exact import ExactEvaluator

TE_COUNTER_KEYS = (
    "te.runs",
    "te.steps",
    "te.round_trips",
    "te.accepted",
    "te.rejected",
    "te.aborted",
    "te.objective_before_milli",
    "te.objective_after_milli",
    "te.optimize_us",
)

# strict-improvement epsilon for exact objectives (float equality of
# host-float64 utilizations from identical splits is exact; this only
# guards residual rounding in the division)
_IMPROVE_EPS = 1e-12


@dataclass
class TeProblem:
    """One TE instance: padded edge arrays, demand matrix, metric box.

    `demand[n, p]` is the traffic volume node n sends toward
    `dest_ids[p]`; `capacity[e]` scales per-link utilization (uniform
    1.0 when link capacities are unknown: the objective then ranks
    metric vectors by raw max-load, which preserves the argmin)."""

    edge_src: np.ndarray  # [E_cap] int32
    edge_dst: np.ndarray  # [E_cap] int32
    edge_metric: np.ndarray  # [E_cap] int32, initial metrics
    edge_up: np.ndarray  # [E_cap] bool
    node_overloaded: np.ndarray  # [N_cap] bool
    n_edges: int
    n_nodes: int
    dest_ids: np.ndarray  # [P] int32
    demand: np.ndarray  # [N_cap, P] float
    capacity: Optional[np.ndarray] = None  # [E_cap] float (default 1.0)
    metric_lo: int = 1
    metric_hi: int = 64

    def __post_init__(self) -> None:
        if self.capacity is None:
            self.capacity = np.ones(len(self.edge_src), dtype=np.float32)
        if not (0 < self.metric_lo <= self.metric_hi):
            raise ValueError(
                f"te: bad metric bounds [{self.metric_lo}, {self.metric_hi}]"
            )

    @classmethod
    def from_topology(
        cls, topo, dest_ids, demand, capacity=None, metric_lo=1,
        metric_hi=64,
    ) -> "TeProblem":
        """From any object with the padded edge-array contract (a
        decision.csr.CsrTopology, or the reference's synthetic
        Topology)."""
        return cls(
            edge_src=np.asarray(topo.edge_src, dtype=np.int32),
            edge_dst=np.asarray(topo.edge_dst, dtype=np.int32),
            edge_metric=np.asarray(topo.edge_metric, dtype=np.int32),
            edge_up=np.asarray(topo.edge_up, dtype=bool),
            node_overloaded=np.asarray(topo.node_overloaded, dtype=bool),
            n_edges=int(topo.n_edges),
            n_nodes=int(topo.n_nodes),
            dest_ids=np.asarray(dest_ids, dtype=np.int32),
            demand=np.asarray(demand),
            capacity=capacity,
            metric_lo=metric_lo,
            metric_hi=metric_hi,
        )


@dataclass
class TeResult:
    """Outcome of one optimize run; `metrics` is always integer, within
    bounds, and exactly validated (the initial metrics when nothing
    improved)."""

    metrics: np.ndarray  # [E_cap] int32
    objective_before: float
    objective_after: float
    improved: bool
    steps: int
    round_trips: int
    accepted: int
    rejected: int
    wall_us: int
    changed_edges: list = field(default_factory=list)  # [(src, dst, m)]


def _clip_int(metric_f, problem: TeProblem) -> np.ndarray:
    """Round (half to even) and project a float metric vector into the
    integer box; padding edges keep metric 1 (the mirror convention)."""
    if isinstance(metric_f, torch.Tensor):
        metric_f = metric_f.cpu().numpy()
    cand = np.clip(
        np.rint(np.asarray(metric_f)), problem.metric_lo, problem.metric_hi
    ).astype(np.int32)
    return np.where(problem.edge_up, cand, np.int32(1))


class TeOptimizer:
    """Gradient-descent TE over the fleet product with an exact gate."""

    def __init__(self, engine=None, device=None) -> None:
        self.engine = engine
        self.device = engine.device if engine is not None else resolve_device(device)
        self._lock = threading.Lock()
        self.counters: dict[str, int] = {k: 0 for k in TE_COUNTER_KEYS}

    # -- counters ------------------------------------------------------------

    def _bump(self, name: str, delta: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + delta

    def get_counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self.counters)

    # -- exact round trip ----------------------------------------------------

    def _evaluator(self, problem: TeProblem) -> ExactEvaluator:
        return ExactEvaluator(
            problem.edge_src, problem.edge_dst, problem.edge_up,
            problem.node_overloaded, problem.n_edges, problem.n_nodes,
            problem.dest_ids, problem.demand, problem.capacity,
            engine=self.engine, device=self.device,
        )

    def _check_epoch(self, epoch_fn, expect_epoch) -> None:
        if epoch_fn is None or expect_epoch is None:
            return
        actual = int(epoch_fn())
        if actual != int(expect_epoch):
            self._bump("te.aborted")
            raise EpochMismatchError(int(expect_epoch), actual)

    # -- the optimizer -------------------------------------------------------

    def optimize(
        self,
        problem: TeProblem,
        *,
        steps: int = 48,
        round_trips: int = 4,
        lr: float = 0.75,
        tau0: float = 1.0,
        tau_min: float = 0.1,
        tau_obj: float = 0.1,
        n_sweeps: Optional[int] = None,
        flow_sweeps: Optional[int] = None,
        epoch_fn: Optional[Callable[[], int]] = None,
        expect_epoch: Optional[int] = None,
        publish: Optional[Callable[[np.ndarray, float], None]] = None,
    ) -> TeResult:
        """Anneal tau0 -> tau_min over `round_trips` stages of
        `steps // round_trips` Adam steps each; every stage boundary is
        one exact round trip gating acceptance.  `publish` fires at most
        once, with the best exactly-improving integer metrics."""
        t_start = time.perf_counter()
        n_sweeps = int(n_sweeps or min(96, max(8, problem.n_nodes)))
        flow_sweeps = int(flow_sweeps or n_sweeps)
        round_trips = max(1, int(round_trips))
        per_stage = max(1, int(steps) // round_trips)

        ev = self._evaluator(problem)
        metric0 = _clip_int(
            np.asarray(problem.edge_metric, dtype=np.float64), problem
        )
        self._check_epoch(epoch_fn, expect_epoch)
        obj_before = ev.evaluate(metric0)
        self._bump("te.round_trips")
        with self._lock:
            self.counters["te.objective_before_milli"] = int(
                round(obj_before * 1000)
            )

        # device-resident descent state
        dev = self.device

        def put(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)

        e_src = put(problem.edge_src, torch.int64)
        e_dst = put(problem.edge_dst, torch.int64)
        e_up = put(problem.edge_up, torch.bool)
        n_over = put(problem.node_overloaded, torch.bool)
        dests = put(problem.dest_ids, torch.int64)
        demand = put(problem.demand, torch.float32)
        capacity = put(problem.capacity, torch.float32)
        metric_f = put(metric0, torch.float32)
        adam_m = torch.zeros_like(metric_f)
        adam_v = torch.zeros_like(metric_f)
        lo_f, hi_f = float(problem.metric_lo), float(problem.metric_hi)

        def step_fn(*args, **kwargs):
            if self.engine is None:
                return soft.te_descent_step(*args, **kwargs)
            return self.engine.dispatch(
                "te_step", soft.te_descent_step, *args, **kwargs
            )

        taus = np.geomspace(max(tau0, 1e-3), max(tau_min, 1e-3),
                            round_trips)
        best_metric, best_obj = metric0, obj_before
        n_steps = accepted = rejected = trips = t_adam = 0
        for stage in range(round_trips):
            tau = np.float32(taus[stage])
            for _ in range(per_stage):
                self._check_epoch(epoch_fn, expect_epoch)
                n_steps += 1
                t_adam += 1
                _obj, metric_f, adam_m, adam_v = step_fn(
                    metric_f, adam_m, adam_v, np.float32(t_adam),
                    e_src, e_dst, e_up, n_over, dests, demand, capacity,
                    tau, np.float32(tau_obj), np.float32(lr),
                    np.float32(lo_f), np.float32(hi_f),
                    n_sweeps=n_sweeps, flow_sweeps=flow_sweeps,
                )
                self._bump("te.steps")
            candidate = _clip_int(metric_f, problem)
            self._check_epoch(epoch_fn, expect_epoch)
            cand_obj = ev.evaluate(candidate)
            trips += 1
            self._bump("te.round_trips")
            if cand_obj < best_obj - _IMPROVE_EPS:
                best_metric, best_obj = candidate, cand_obj
                accepted += 1
                self._bump("te.accepted")
            else:
                rejected += 1
                self._bump("te.rejected")
                # trust-region fallback: a rejected stage re-centers the
                # relaxation on the best exactly-validated point instead
                # of compounding a drift the exact solver already vetoed
                metric_f = put(best_metric, torch.float32)
                adam_m = torch.zeros_like(metric_f)
                adam_v = torch.zeros_like(metric_f)
                t_adam = 0  # bias correction restarts with the moments

        improved = best_obj < obj_before - _IMPROVE_EPS
        if improved and publish is not None:
            # the one publication seam: exactly-validated integer metrics
            publish(best_metric.copy(), best_obj)
        wall_us = int((time.perf_counter() - t_start) * 1e6)
        with self._lock:
            self.counters["te.objective_after_milli"] = int(
                round(best_obj * 1000)
            )
        self._bump("te.optimize_us", wall_us)
        self._bump("te.runs")
        e = problem.n_edges
        changed = np.nonzero(
            (best_metric[:e] != metric0[:e]) & problem.edge_up[:e]
        )[0]
        return TeResult(
            metrics=best_metric,
            objective_before=obj_before,
            objective_after=best_obj,
            improved=improved,
            steps=n_steps,
            round_trips=trips + 1,  # + the baseline evaluation
            accepted=accepted,
            rejected=rejected,
            wall_us=wall_us,
            changed_edges=[
                (
                    int(problem.edge_src[i]),
                    int(problem.edge_dst[i]),
                    int(best_metric[i]),
                )
                for i in changed
            ],
        )


def hill_climb(
    problem: TeProblem,
    *,
    rounds: int = 32,
    seed: int = 0,
    engine=None,
    device=None,
) -> tuple[np.ndarray, float, int]:
    """Host search baseline: random single-metric moves through the same
    exact evaluator, keep-if-improves.  Returns (metrics, exact
    objective, exact evaluations spent)."""
    rng = np.random.RandomState(seed)
    ev = ExactEvaluator(
        problem.edge_src, problem.edge_dst, problem.edge_up,
        problem.node_overloaded, problem.n_edges, problem.n_nodes,
        problem.dest_ids, problem.demand, problem.capacity, engine=engine,
        device=device,
    )
    best = _clip_int(
        np.asarray(problem.edge_metric, dtype=np.float64), problem
    )
    best_obj = ev.evaluate(best)
    evals = 1
    up_edges = np.nonzero(problem.edge_up[: problem.n_edges])[0]
    for _ in range(rounds):
        if not len(up_edges):
            break
        cand = best.copy()
        e = up_edges[rng.randint(len(up_edges))]
        cand[e] = rng.randint(problem.metric_lo, problem.metric_hi + 1)
        if cand[e] == best[e]:
            continue
        obj = ev.evaluate(cand)
        evals += 1
        if obj < best_obj - _IMPROVE_EPS:
            best, best_obj = cand, obj
    return best, best_obj, evals
