"""Batch backends for the QueryScheduler.

Port of `openr_tpu.serving.backend`.  Two deployments of one contract:

- `EngineBatchBackend`, standalone: the scheduler owns `{area:
  LinkState}` views and a `DeviceSpfBackend`, and dispatches straight
  into the residency engine (the CUDA card unless `device="cpu"` or an
  `spf_backend` says otherwise).
- `DecisionBatchBackend`, in the daemon: queries marshal onto the
  Decision event thread (`run_in_event_base_thread`) and compute over
  Decision's own LinkStates through its SpfSolver backend.  N coalesced
  queries cost one cross-thread marshal and one device dispatch.

Contract (each method raises `device.engine.EpochMismatchError` when
the area's topology version no longer matches `expect_epoch`):

- ``epoch(area) -> int``: the current topology version.
- ``run_paths(area, sources, use_link_metric, expect_epoch)`` ->
  ``{source: SpfResult}``.
- ``run_what_if(area, sources, scenarios, expect_epoch)`` -> one impact
  dict per scenario (protection_api.what_if).
- ``run_ksp(area, source, dests, k, expect_epoch)`` ->
  ``{dest: [Path]}``.
- ``run_optimize_metrics(area, demand, bounds, steps, expect_epoch)`` ->
  wire dict of exactly-validated proposed metrics and the objective
  change (one te.TeOptimizer run, epoch-checked per descent step).

The reference answers a paths batch from the host Dijkstra when the
engine fails for any reason but an epoch refusal (`serving.host_fallbacks`).
Here there is no such rung: a device or kernel failure reaches the
scheduler, which fails the batch's futures and counts `serving.errors`;
`serving.host_fallbacks` stays at 0.
"""

from __future__ import annotations

import numpy as np

from ..device.engine import EpochMismatchError


def _te_problem_from_csr(csr, demand, bounds):
    """A te.TeProblem over a CSR mirror from wire-shaped demand triples
    ((src_name, dest_name, volume), ...).  The edge arrays are copied:
    the optimizer runs for many steps on the serving executor while the
    owner thread may refresh the mirror in place; the epoch check aborts
    a moved topology, the copy keeps the in-flight arrays coherent until
    it does.  Unknown node names raise KeyError (an error reply)."""
    from ..te import TeProblem

    dest_names = sorted({d for (_s, d, _v) in demand})
    if not dest_names:
        raise ValueError("optimize_metrics: empty demand matrix")
    col = {d: j for j, d in enumerate(dest_names)}
    dest_ids = np.array([csr.node_id[d] for d in dest_names], dtype=np.int32)
    dm = np.zeros((csr.node_capacity, len(dest_names)), dtype=np.float32)
    for s, d, v in demand:
        dm[csr.node_id[s], col[d]] += float(v)
    lo, hi = int(bounds[0]), int(bounds[1])
    return TeProblem(
        edge_src=csr.edge_src.copy(),
        edge_dst=csr.edge_dst.copy(),
        edge_metric=csr.edge_metric.copy(),
        edge_up=csr.edge_up.copy(),
        node_overloaded=csr.node_overloaded.copy(),
        n_edges=int(csr.n_edges),
        n_nodes=int(csr.n_nodes),
        dest_ids=dest_ids,
        demand=dm,
        metric_lo=lo,
        metric_hi=hi,
    )


def _shape_te_result(node_names, result) -> dict:
    """TeResult -> wire dict; proposed metrics only for the edges the run
    changed (exactly validated), as (src, dest, metric) name triples."""
    return {
        "proposedMetrics": [
            [node_names[u], node_names[v], int(m)]
            for (u, v, m) in result.changed_edges
        ],
        "objectiveBefore": float(result.objective_before),
        "objectiveAfter": float(result.objective_after),
        "improved": bool(result.improved),
        "steps": int(result.steps),
        "roundTrips": int(result.round_trips),
        "accepted": int(result.accepted),
        "rejected": int(result.rejected),
    }


class EngineBatchBackend:
    """Standalone backend: {area: LinkState} and a DeviceSpfBackend."""

    def __init__(
        self,
        link_states: dict,
        spf_backend=None,
        device=None,
    ) -> None:
        from ..te import TeOptimizer

        if spf_backend is None:
            from ..decision.spf_solver import DeviceSpfBackend

            spf_backend = DeviceSpfBackend(device)
        self.link_states = link_states
        self.spf = spf_backend
        # the optimizer's exact round trips dispatch through the same
        # residency engine
        self.te = TeOptimizer(engine=spf_backend.engine)

    def _ls(self, area: str):
        ls = self.link_states.get(area)
        if ls is None:
            raise KeyError(f"no link state for area {area!r}")
        return ls

    def epoch(self, area: str) -> int:
        return int(self._ls(area).version)

    def _check_epoch(self, ls, expect_epoch: int) -> None:
        if int(ls.version) != int(expect_epoch):
            raise EpochMismatchError(int(expect_epoch), int(ls.version))

    def run_paths(
        self,
        area: str,
        sources: list,
        use_link_metric: bool = True,
        expect_epoch: int = 0,
    ) -> dict:
        ls = self._ls(area)
        self._check_epoch(ls, expect_epoch)
        known = [s for s in sources if ls.links_from_node(s)]
        csr = self.spf.csr_mirror(ls)
        # engine-level epoch pin: csr.version mirrors ls.version, so a
        # flap between coalescing and this dispatch raises before any
        # device work; any other failure propagates
        results = self.spf.engine.spf_results(
            csr,
            known,
            use_link_metric=use_link_metric,
            expect_epoch=expect_epoch,
        )
        # an isolated or unknown source: the host's self-only result, as
        # DeviceSpfBackend.get_spf_result answers it
        for s in sources:
            if s not in results:
                results[s] = ls.get_spf_result(
                    s, use_link_metric=use_link_metric
                )
        return results

    def run_what_if(
        self,
        area: str,
        sources: list,
        scenarios: list,
        expect_epoch: int = 0,
    ) -> list:
        from ..decision.protection_api import what_if

        ls = self._ls(area)
        self._check_epoch(ls, expect_epoch)
        return what_if(
            ls,
            [[tuple(link) for link in sc] for sc in scenarios],
            sources=list(sources) or None,
            csr=self.spf.csr_mirror(ls),
            engine=self.spf.engine,
        )

    def run_ksp(
        self,
        area: str,
        source: str,
        dests: list,
        k: int = 2,
        expect_epoch: int = 0,
    ) -> dict:
        ls = self._ls(area)
        self._check_epoch(ls, expect_epoch)
        # one masked device run for the whole destination set
        self.spf.prefetch_kth_paths(ls, source, list(dests))
        return {d: self.spf.get_kth_paths(ls, source, d, k) for d in dests}

    def run_optimize_metrics(
        self,
        area: str,
        demand,
        bounds,
        steps: int = 32,
        expect_epoch: int = 0,
    ) -> dict:
        ls = self._ls(area)
        self._check_epoch(ls, expect_epoch)
        csr = self.spf.csr_mirror(ls)
        problem = _te_problem_from_csr(csr, demand, bounds)
        result = self.te.optimize(
            problem,
            steps=int(steps),
            # live epoch read: every descent step and exact round trip
            # re-checks, and a flap aborts the run (the scheduler does
            # not retry this op)
            epoch_fn=lambda: int(ls.version),
            expect_epoch=expect_epoch,
        )
        return _shape_te_result(list(csr.node_names), result)


class DecisionBatchBackend:
    """In-daemon backend: batches marshal onto the Decision thread.  The
    optimizer runs on Decision's engine (on the CUDA card when its
    backend has none)."""

    def __init__(self, decision) -> None:
        from ..te import TeOptimizer

        self.decision = decision
        self.te = TeOptimizer(
            engine=getattr(decision.spf_solver.spf, "engine", None)
        )

    def epoch(self, area: str) -> int:
        # a plain int read; the batch re-validates on the Decision thread
        ls = self.decision.area_link_states.get(area)
        return int(ls.version) if ls is not None else -1

    def _ls_checked(self, area: str, expect_epoch: int):
        ls = self.decision.area_link_states.get(area)
        actual = int(ls.version) if ls is not None else -1
        if actual != int(expect_epoch):
            raise EpochMismatchError(int(expect_epoch), actual)
        if ls is None:
            raise KeyError(f"no link state for area {area!r}")
        return ls

    def run_paths(
        self,
        area: str,
        sources: list,
        use_link_metric: bool = True,
        expect_epoch: int = 0,
    ) -> dict:
        def _compute() -> dict:
            ls = self._ls_checked(area, expect_epoch)
            spf = self.decision.spf_solver.spf
            prefetch = getattr(spf, "prefetch", None)
            if prefetch is not None:
                # one batched device call for the whole source set; a
                # failure propagates
                prefetch(ls, list(sources))
            return {
                s: spf.get_spf_result(ls, s)
                for s in sources
                if ls.links_from_node(s)
            }

        return self.decision.run_in_event_base_thread(_compute).result()

    def run_what_if(
        self,
        area: str,
        sources: list,
        scenarios: list,
        expect_epoch: int = 0,
    ) -> list:
        def _check():
            self._ls_checked(area, expect_epoch)

        self.decision.run_in_event_base_thread(_check).result()
        return self.decision.what_if(
            [[tuple(link) for link in sc] for sc in scenarios],
            area=area,
            sources=list(sources) or None,
        )

    def run_ksp(
        self,
        area: str,
        source: str,
        dests: list,
        k: int = 2,
        expect_epoch: int = 0,
    ) -> dict:
        def _compute() -> dict:
            ls = self._ls_checked(area, expect_epoch)
            spf = self.decision.spf_solver.spf
            spf.prefetch_kth_paths(ls, source, list(dests))
            return {d: spf.get_kth_paths(ls, source, d, k) for d in dests}

        return self.decision.run_in_event_base_thread(_compute).result()

    def run_optimize_metrics(
        self,
        area: str,
        demand,
        bounds,
        steps: int = 32,
        expect_epoch: int = 0,
    ) -> dict:
        # only the snapshot marshals onto the Decision thread (mirror
        # access is single-threaded there); the descent runs on the
        # serving executor, so a whole optimization does not starve
        # route programming.  The copied problem arrays and the per-step
        # epoch check keep the off-thread run coherent.
        def _snapshot():
            ls = self._ls_checked(area, expect_epoch)
            csr = self.decision.spf_solver.spf.csr_mirror(ls)
            if csr is None:
                raise RuntimeError(
                    "optimize_metrics requires the device SPF backend"
                )
            return (
                _te_problem_from_csr(csr, demand, bounds),
                list(csr.node_names),
                ls,
            )

        problem, node_names, ls = self.decision.run_in_event_base_thread(
            _snapshot
        ).result()
        result = self.te.optimize(
            problem,
            steps=int(steps),
            epoch_fn=lambda: int(ls.version),
            expect_epoch=expect_epoch,
        )
        return _shape_te_result(node_names, result)
