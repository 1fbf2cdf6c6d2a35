"""Scripted multi-node chaos scenarios over the in-process daemon fabric.

Port of `openr_tpu.chaos.scenario`, over the port's `OpenrDaemon`.

A ChaosScenario records every scripted action (and every wait outcome)
into the shared ChaosEventLog's "scenario" stream, so two runs of the
same timeline from the same seed can be compared with
ChaosEventLog.matches().  Convergence is judged bit-exactly against a
host-oracle recompute of each daemon's routes (oracle_route_dbs) rather
than against another daemon — the oracle cannot itself be perturbed by
the chaos under test.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ..decision.spf_solver import HostSpfBackend, SpfSolver
from .chaos import (
    SCENARIO_STREAM,
    ChaosEventLog,
    wait_timeout_scale,
    wait_until,
)

FIB_CLIENT = 786


def fib_unicast_routes(daemon) -> dict[str, frozenset]:
    """The daemon's programmed unicast FIB as {dest: next-hop set}."""
    table = daemon.fib_agent.unicast.get(FIB_CLIENT, {})
    return {dest: frozenset(route.next_hops) for dest, route in table.items()}


def oracle_route_dbs(daemon) -> dict[str, frozenset]:
    """Host-oracle recompute of the daemon's own routes.

    Builds a fresh SpfSolver pinned to HostSpfBackend (the host
    Dijkstra, which needs no device) over the daemon's
    current link/prefix state (read inside the decision thread, so no
    torn state) and returns {dest: next-hop set} for installable routes.
    Static routes are not replicated — scenarios compare dynamic state.
    """
    decision = daemon.decision

    def _compute() -> dict[str, frozenset]:
        solver = SpfSolver(
            decision.my_node_name,
            enable_v4=decision.spf_solver.enable_v4,
            bgp_dry_run=decision.spf_solver.bgp_dry_run,
            enable_best_route_selection=(
                decision.spf_solver.enable_best_route_selection
            ),
            spf_backend=HostSpfBackend(),
        )
        db = solver.build_route_db(decision.area_link_states, decision.prefix_state)
        if db is None:
            return {}
        return {
            prefix: frozenset(entry.nexthops)
            for prefix, entry in db.unicast_routes.items()
            if not entry.do_not_install
        }

    return decision.run_in_event_base_thread(_compute).result()


def fib_matches_oracle(daemon) -> bool:
    return fib_unicast_routes(daemon) == oracle_route_dbs(daemon)


def hold_converged(
    daemons, timeout_s: float = 30.0, hold_s: float = 0.5
) -> bool:
    """True once every daemon's FIB bit-exactly matches its own host-
    oracle recompute AND the match holds for a full ``hold_s`` quiescence
    window with no new route publications.

    Two instantaneous polls are not enough on a loaded box: a rebuild can
    land between the FIB read and the oracle read, or (worse) the match
    can be momentarily true while a late update is still queued, so a
    snapshot taken right after the wait races the final write.  The hold
    window requires the match to stay continuously true and pins the
    daemons' route-publication write counters across it — if anything
    publishes mid-window the hold restarts from the new state.
    """

    def _writes() -> tuple[int, ...]:
        return tuple(d.route_updates_queue.get_num_writes() for d in daemons)

    # scale the SEARCH budget for instrumented/overridden runs, never
    # the hold window: quiescence semantics must stay identical (see
    # chaos.wait_timeout_scale's timing model)
    deadline = time.monotonic() + timeout_s * wait_timeout_scale()
    while time.monotonic() < deadline:
        if not all(fib_matches_oracle(d) for d in daemons):
            time.sleep(0.05)
            continue
        w0 = _writes()
        hold_end = time.monotonic() + hold_s
        held = True
        while time.monotonic() < hold_end:
            time.sleep(0.05)
            if _writes() != w0 or not all(
                fib_matches_oracle(d) for d in daemons
            ):
                held = False
                break
        if held and _writes() == w0:
            return True
    return False


class ChaosScenario:
    """A replayable fault timeline: named steps plus logged waits."""

    def __init__(self, log_: Optional[ChaosEventLog] = None) -> None:
        self.log = log_ if log_ is not None else ChaosEventLog()

    def step(self, name: str, fn: Optional[Callable[[], object]] = None):
        """Log a scripted action, then perform it."""
        self.log.append(SCENARIO_STREAM, name)
        return fn() if fn is not None else None

    def wait(
        self,
        name: str,
        cond: Callable[[], bool],
        timeout_s: float = 20.0,
    ) -> bool:
        """Wait on a condition; the outcome is part of the replay log."""
        ok = wait_until(cond, timeout_s)
        self.log.append(SCENARIO_STREAM, f"{name}:{'ok' if ok else 'timeout'}")
        return ok

    def wait_converged(
        self,
        daemons,
        timeout_s: float = 30.0,
        hold_s: float = 0.5,
    ) -> bool:
        """Wait until every daemon's FIB bit-exactly matches its own
        host-oracle recompute AND the match holds for a full ``hold_s``
        quiescence window with no new route publications.

        Two instantaneous polls are not enough on a loaded box: a rebuild
        can land between the FIB read and the oracle read, or (worse) the
        match can be momentarily true while a late update is still queued,
        so a snapshot taken right after the wait races the final write.
        The hold window requires the match to stay true continuously and
        pins the daemons' route-publication write counters across it — if
        anything publishes mid-window the hold restarts from the new state
        (module-level ``hold_converged``).  The log entry stays
        ``converged:ok``/``converged:timeout`` so same-seed replay logs
        still compare equal.
        """
        ok = hold_converged(daemons, timeout_s=timeout_s, hold_s=hold_s)
        self.log.append(
            SCENARIO_STREAM, f"converged:{'ok' if ok else 'timeout'}"
        )
        return ok
