"""ReplicaRouter: one front door over K daemon replicas.

Port of `openr_tpu.serving.router`: host code.  Every read of the
replica list takes the router's lock, which `add_replica` and
`remove_replica` swap it under.  The reference reads it bare in
`submit`, `get_counters` and `probe_replicas`: benign, since the list is
swapped whole and a bare read is atomic, but the race detector reports
the unordered read against a scale-out or scale-in (ROADMAP queue 3,
F9), and taking the lock keeps the armed runs clean without a
suppression beyond the reference's.
Under the schedule explorer (`analysis.sched`), the stop check of
`submit` is the `router.dispatch` region.  With tracing armed
(`obs.trace`), each call roots a `router.query` span;
every (re)dispatch adds a `dispatch` event tagged with its kind (first,
retry, hedge, failover, epoch_reroute) and submits under the call's
span, so the replica scheduler's `serving.query` nests in it; the
outcome (ok, hedge_win, shed, error) closes the trace.

One QueryScheduler saturates one residency engine; scaling past that
means replicas — and the moment there are replicas the hard problem is
robustness, not throughput.  The router owns exactly that problem:

- **Epoch pinning** — every reply carries the LinkState version it was
  answered at (`QueryResult.epoch`).  A session's pin only ever moves
  forward: a reply older than the session's pinned epoch is never
  delivered — the router re-routes the query to a caught-up replica
  (`serving.router.epoch_reroutes`) instead.  This is the DeltaPath
  discipline (PAPERS.md): answers are checkable against the exact
  version they were computed at, so "consistent" is an assertion, not a
  hope.
- **Health + failover** — replica health is tracked from reply outcomes
  plus a liveness probe (an `epoch()` read).  Failures feed a per-replica
  `utils.backoff.ExponentialBackoff`; a dead replica is skipped until its
  backoff window lets a probe try to revive it.  A query whose replica
  died mid-flight is re-dispatched to a survivor
  (`serving.router.failovers`) — never dropped.
- **Bounded hedge** — an unresolved query is speculatively re-dispatched
  to a second replica after `hedge_after_s` (`serving.router.hedges`);
  the first reply wins (`serving.router.hedge_wins` when the hedge beats
  the primary) and the loser's outcome is still observed — it feeds
  replica health and then drops, so duplicate execution is accounted,
  not silent.
- **Loud sheds** — when the router cannot issue even a first dispatch
  (stopped, or no live replica), the caller gets the same explicit
  `QueryShedError` the scheduler's admission queue uses
  (`serving.router.sheds`).  `LoadReport`'s accounted == submitted
  invariant holds over the fleet exactly as it does over one scheduler.

Dispatch ledger (asserted by `dispatch_ledger_closes`):
every dispatch beyond a query's first is counted in exactly one of
retries / hedges / failovers / epoch_reroutes, and `sheds` counts the
queries that never got a first dispatch, so

    dispatches == (submitted - sheds)
                  + retries + hedges + failovers + epoch_reroutes

reconciles the router's counters against the caller's count.  (A replica's
*own* admission shed propagates to the caller as QueryShedError after a
bounded retry, but lands in the replica's `serving.shed`, not here.)

The router duck-types `QueryScheduler.submit`/`get_counters`, so the
ctrl handler and the Thrift shim drive a fleet with no changes — pass `serving=router` instead of `serving=scheduler`.
"""

from __future__ import annotations

import concurrent.futures
import logging
import threading
import time
from typing import Any, Optional

from ..analysis import sched as _sched
from ..device.engine import EpochMismatchError
from ..obs import trace as _trace
from ..obs.histogram import Histogram, export_histogram
from ..utils.backoff import ExponentialBackoff
from .scheduler import QueryResult, QueryShedError

log = logging.getLogger(__name__)

ROUTER_COUNTER_KEYS = (
    "serving.router.dispatches",
    "serving.router.retries",
    "serving.router.hedges",
    "serving.router.hedge_wins",
    "serving.router.failovers",
    "serving.router.epoch_reroutes",
    "serving.router.sheds",
    "serving.router.replica_deaths",
    "serving.router.probe_failures",
)

# replica-scheduler gauges that must not be summed when aggregating the
# fleet's counters onto one wire surface (max is the honest roll-up)
_GAUGE_KEYS = frozenset(
    (
        "serving.batch_occupancy",
        "serving.p50_us",
        "serving.p99_us",
        "serving.p999_us",
        "serving.router.p50_us",
        "serving.router.p99_us",
        "serving.router.p999_us",
    )
)

_HEDGE_TICK_S = 0.005


def dispatch_ledger_closes(counters: dict, submitted: int) -> bool:
    """The router's exactly-closing dispatch identity (module docstring):

        dispatches == (submitted - sheds)
                      + retries + hedges + failovers + epoch_reroutes

    `counters` is a `ReplicaRouter.get_counters()` snapshot taken AFTER
    the router (and its replicas) stopped, so every callback's bumps are
    visible; `submitted` is the caller-side count of queries handed to
    `submit`."""
    redispatch = (
        counters["serving.router.retries"]
        + counters["serving.router.hedges"]
        + counters["serving.router.failovers"]
        + counters["serving.router.epoch_reroutes"]
    )
    return counters["serving.router.dispatches"] == (
        submitted - counters["serving.router.sheds"]
    ) + redispatch


class ReplicaUnavailableError(RuntimeError):
    """The replica is down or unreachable (killed process, partition).
    Replica handles raise this (or resolve sub-futures with it) so the
    router can tell a dead replica from an overloaded one."""


class SchedulerReplica:
    """Replica handle over an in-process QueryScheduler.

    The handle protocol the router needs is tiny: `submit(op, **kw)`
    returning a future, `epoch(area)` as the liveness probe, and
    optionally `get_counters()` for the fleet roll-up.  Remote replicas
    implement the same three calls over their wire client.
    """

    def __init__(self, name: str, scheduler) -> None:
        self.name = name
        self.scheduler = scheduler

    def submit(self, op: str, **kw) -> "concurrent.futures.Future":
        return self.scheduler.submit(op, **kw)

    def epoch(self, area: str = "0") -> int:
        return int(self.scheduler.backend.epoch(area))

    def get_counters(self) -> dict:
        return self.scheduler.get_counters()


class _ReplicaState:
    """Router-side view of one replica: handle + health."""

    def __init__(
        self, handle, initial_backoff_s: float, max_backoff_s: float
    ) -> None:
        self.handle = handle
        self.name = str(getattr(handle, "name", repr(handle)))
        self.alive = True
        self.backoff = ExponentialBackoff(initial_backoff_s, max_backoff_s)


class _Call:
    """One caller query's routing state across (re)dispatches."""

    __slots__ = (
        "op",
        "kw",
        "area",
        "session",
        "future",
        "attempts",
        "tried",
        "resolved",
        "hedge_launched",
        "lock",
        "t_submit",
        "span",
    )

    def __init__(self, op: str, kw: dict, area: str, session) -> None:
        self.op = op
        self.kw = kw
        self.area = area
        self.session = session
        self.t_submit = time.perf_counter()
        self.future: "concurrent.futures.Future[QueryResult]" = (
            concurrent.futures.Future()
        )
        self.attempts = 0
        self.tried: set = set()
        self.resolved = False
        self.hedge_launched = False
        self.lock = threading.Lock()
        self.span = None  # OPENR_TRACE: the call's router.query span


class ReplicaRouter:
    """Spread queries across K replica schedulers with epoch pinning,
    health-tracked failover, bounded hedging, and loud sheds."""

    def __init__(
        self,
        replicas,
        *,
        hedge_after_s: Optional[float] = 0.05,
        max_attempts: Optional[int] = None,
        initial_backoff_s: float = 0.02,
        max_backoff_s: float = 1.0,
        default_area: str = "0",
    ) -> None:
        self._replicas = [
            _ReplicaState(h, initial_backoff_s, max_backoff_s)
            for h in replicas
        ]
        self._initial_backoff_s = initial_backoff_s
        self._max_backoff_s = max_backoff_s
        self.hedge_after_s = hedge_after_s
        # auto-derived budget tracks the replica count across
        # add_replica/remove_replica; an explicit budget is pinned
        self._auto_max_attempts = max_attempts is None
        self.max_attempts = (
            int(max_attempts)
            if max_attempts is not None
            else max(4, 2 * len(self._replicas))
        )
        # final counter roll-ups of replicas removed by remove_replica:
        # the fleet's wire surface stays monotone across scale-in
        self._departed_counters: dict[str, int] = {}
        self.default_area = default_area
        self._lock = threading.Lock()
        self.counters: dict[str, int] = {k: 0 for k in ROUTER_COUNTER_KEYS}
        # delivered-reply latency (submit -> future resolution), shared
        # log2-bucket histogram -> serving.router.p50/p99/p999_us
        self._hist = Histogram()
        # session -> pinned epoch (monotonically non-decreasing)
        self._sessions: dict[Any, int] = {}
        # test seam: when set to a list, every ACCEPTED (session, epoch)
        # pair is appended under the router lock, in acceptance order —
        # the authoritative record for the monotonicity assertion
        self.pin_trace: Optional[list] = None
        self._rr = 0
        self._stopped = False
        # single monitor thread services every pending hedge deadline
        # (a Timer per query would be a thread per query)
        self._hedge_cv = threading.Condition()
        self._hedge_pending: list = []  # [(deadline, _Call)]
        self._hedge_thread: Optional[threading.Thread] = None
        if self.hedge_after_s and len(self._replicas) > 1:
            self._hedge_thread = threading.Thread(
                target=self._hedge_loop, name="router-hedge", daemon=True
            )
            self._hedge_thread.start()

    # -- counters --------------------------------------------------------------

    def _bump(self, name: str, delta: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + delta

    def get_counters(self) -> dict:
        """Fleet roll-up: summed replica scheduler counters (gauges take
        max) with the router's own `serving.router.*` family on top, so
        one ctrl / Thrift surface exports the whole fleet.  Departed
        replicas' final counters stay folded in (scale-in must never
        make the fleet surface go backwards)."""
        agg: dict[str, int] = {}
        with self._lock:
            agg.update(self._departed_counters)
            reps = self._replicas  # one read under the lock (F9)
        for rep in reps:
            fn = getattr(rep.handle, "get_counters", None)
            if fn is None:
                continue
            try:
                c = fn()
            except Exception:  # noqa: BLE001 — a dead replica still rolls up
                continue
            for k, v in c.items():
                if k in _GAUGE_KEYS:
                    agg[k] = max(agg.get(k, 0), int(v))
                else:
                    agg[k] = agg.get(k, 0) + int(v)
        with self._lock:
            agg.update(self.counters)
        export_histogram(agg, "serving.router", self._hist)
        return agg

    # -- health ----------------------------------------------------------------

    def _mark_dead(self, rep: _ReplicaState) -> None:
        with self._lock:
            was_alive = rep.alive
            rep.alive = False
        if was_alive:
            self._bump("serving.router.replica_deaths")

    def _probe(self, rep: _ReplicaState, area: Optional[str] = None) -> bool:
        """Liveness probe: one epoch read.  Success revives, failure
        counts and extends the replica's backoff."""
        try:
            rep.handle.epoch(area or self.default_area)
        except Exception:  # noqa: BLE001 — any probe error means down
            self._bump("serving.router.probe_failures")
            self._mark_dead(rep)
            rep.backoff.report_error()
            return False
        rep.backoff.report_success()
        with self._lock:
            rep.alive = True
        return True

    def probe_replicas(self, area: Optional[str] = None) -> int:
        """Probe every replica; returns how many are alive."""
        with self._lock:
            reps = self._replicas  # one read under the lock (F9)
        return sum(1 for rep in reps if self._probe(rep, area))

    def alive_replicas(self) -> int:
        with self._lock:
            return sum(1 for rep in self._replicas if rep.alive)

    def session_pin(self, session) -> Optional[int]:
        with self._lock:
            return self._sessions.get(session)

    # -- elastic membership (join/leave under live load) -----------------------

    def add_replica(self, handle) -> None:
        """Join a replica under live load.  The membership list is
        swapped atomically under the lock (dispatch paths read it once
        per pick), so in-flight calls keep their ledger accounting and
        the very next pick may route to the newcomer.  Growing past one
        replica starts the hedge monitor if hedging is configured."""
        st = _ReplicaState(
            handle, self._initial_backoff_s, self._max_backoff_s
        )
        with self._lock:
            self._replicas = self._replicas + [st]
            n = len(self._replicas)
            if self._auto_max_attempts:
                self.max_attempts = max(4, 2 * n)
            start_hedge = (
                self.hedge_after_s
                and n > 1
                and self._hedge_thread is None
                and not self._stopped
            )
            if start_hedge:
                self._hedge_thread = threading.Thread(
                    target=self._hedge_loop,
                    name="router-hedge",
                    daemon=True,
                )
        if start_hedge:
            self._hedge_thread.start()

    def remove_replica(self, name: str):
        """Leave under live load: the replica stops receiving new picks
        immediately; its final counters fold into the departed roll-up
        so the fleet surface stays monotone.  Queries already in flight
        on it resolve through _on_reply — a handle its owner stops next
        resolves those futures, which the router re-dispatches as
        failovers — so the dispatch ledger still closes exactly.
        Returns the removed handle (None when unknown)."""
        with self._lock:
            keep = [r for r in self._replicas if r.name != name]
            gone = [r for r in self._replicas if r.name == name]
            if not gone:
                return None
            self._replicas = keep
            if self._auto_max_attempts:
                self.max_attempts = max(4, 2 * max(len(keep), 1))
        rep = gone[0]
        fn = getattr(rep.handle, "get_counters", None)
        final: dict = {}
        if fn is not None:
            try:
                final = fn()
            except Exception:  # noqa: BLE001 — dead at departure is fine
                final = {}
        with self._lock:
            for k, v in final.items():
                if k in _GAUGE_KEYS:
                    self._departed_counters[k] = max(
                        self._departed_counters.get(k, 0), int(v)
                    )
                else:
                    self._departed_counters[k] = (
                        self._departed_counters.get(k, 0) + int(v)
                    )
        return rep.handle

    # -- submission (any thread) -----------------------------------------------

    def submit(
        self,
        op: str,
        *,
        session=None,
        area: str = "0",
        sources=(),
        scenarios=(),
        dests=(),
        k: int = 2,
        use_link_metric: bool = True,
        demand=(),
        bounds=(1, 64),
        steps: int = 32,
    ) -> "concurrent.futures.Future[QueryResult]":
        """QueryScheduler-shaped submit plus optional `session` for epoch
        pinning.  Never blocks; a query the router cannot dispatch at all
        sheds loudly (QueryShedError)."""
        kw = dict(
            area=area,
            sources=sources,
            scenarios=scenarios,
            dests=dests,
            k=k,
            use_link_metric=use_link_metric,
            demand=demand,
            bounds=bounds,
            steps=steps,
        )
        call = _Call(op, kw, area, session)
        tr = _trace.TRACE
        if tr is not None:
            call.span = tr.root("router.query", op=op)
        sc = _sched.SCHED
        if sc is not None:
            # OPENR_SCHED: the stop-latch read against a concurrent stop()
            # or replica death is the router's schedule-sensitive window
            sc.region("router.dispatch")
        with self._lock:
            # F9: the membership is swapped whole under this lock by
            # add_replica / remove_replica; a bare read, as the
            # reference's, is atomic but unordered, and the race detector
            # reports it against a scale-out or scale-in
            empty = not self._replicas
        if self._stopped or empty:
            self._resolve_shed(call, "router stopped or no replicas")
            return call.future
        self._dispatch(call, "first")
        return call.future

    # ctrl handler feature probe: pass `session` through the wire params
    supports_sessions = True

    # -- replica selection -----------------------------------------------------

    def _usable(self, rep: _ReplicaState) -> bool:
        if rep.alive:
            return rep.backoff.can_try_now()
        # dead: one probe per expired backoff window may revive it
        if rep.backoff.can_try_now():
            return self._probe(rep)
        return False

    def _pick(
        self,
        call: _Call,
        *,
        require_untried: bool,
        need_epoch: Optional[int],
    ) -> Optional[_ReplicaState]:
        with self._lock:
            start = self._rr
            self._rr += 1
            reps = self._replicas  # one read — membership swaps atomically
        n = len(reps)
        if n == 0:
            return None
        order = [reps[(start + i) % n] for i in range(n)]
        untried = [r for r in order if r.name not in call.tried]
        passes = [untried] if require_untried else [untried, order]
        for candidates in passes:
            behind: list[_ReplicaState] = []
            for rep in candidates:
                if not self._usable(rep):
                    continue
                if need_epoch is not None:
                    try:
                        if int(rep.handle.epoch(call.area)) < need_epoch:
                            behind.append(rep)
                            continue
                    except Exception:  # noqa: BLE001 — probe-style failure
                        self._bump("serving.router.probe_failures")
                        self._mark_dead(rep)
                        rep.backoff.report_error()
                        continue
                return rep
            # no caught-up candidate: a behind-but-alive replica is still
            # better than failing — the stale-reply check re-routes again
            # (bounded by max_attempts) if it answers old
            if behind:
                return behind[0]
        return None

    # -- dispatch --------------------------------------------------------------

    def _dispatch(
        self,
        call: _Call,
        kind: str,
        last_exc: Optional[Exception] = None,
        need_epoch: Optional[int] = None,
    ) -> None:
        """Issue one (re)dispatch of `call`; `kind` names which ledger
        bucket a re-dispatch lands in."""
        while True:
            if self._stopped:
                self._terminal(call, kind, last_exc, "router stopped")
                return
            rep = self._pick(
                call,
                require_untried=(kind == "hedge"),
                need_epoch=need_epoch,
            )
            if rep is None:
                if kind == "hedge":
                    return  # nothing to hedge onto; primary still owns it
                self._terminal(call, kind, last_exc, "no live replica")
                return
            try:
                sp = call.span
                tr = _trace.TRACE if sp is not None else None
                if tr is not None:
                    # the dispatch edge is structural; under the call's
                    # span the replica's serving.query nests in this trace
                    with tr.activate((sp,)):
                        tr.event("dispatch", kind=kind)
                        fut = rep.handle.submit(call.op, **call.kw)
                else:
                    fut = rep.handle.submit(call.op, **call.kw)
            except Exception as e:  # noqa: BLE001 — sync refusal = down
                # no dispatch was issued: not in the ledger, but the
                # replica is marked so the next pick skips it
                self._mark_dead(rep)
                rep.backoff.report_error()
                call.tried.add(rep.name)
                last_exc = e
                continue
            break
        call.tried.add(rep.name)
        with call.lock:
            call.attempts += 1
        if kind == "retry":
            self._bump("serving.router.retries")
        elif kind == "failover":
            self._bump("serving.router.failovers")
        elif kind == "epoch_reroute":
            self._bump("serving.router.epoch_reroutes")
        elif kind == "hedge":
            self._bump("serving.router.hedges")
        self._bump("serving.router.dispatches")
        if kind == "first":
            self._arm_hedge(call)
        hedged = kind == "hedge"
        fut.add_done_callback(
            lambda f, rep=rep, hedged=hedged: self._on_reply(
                call, rep, f, hedged
            )
        )

    def _terminal(
        self,
        call: _Call,
        kind: str,
        last_exc: Optional[Exception],
        why: str,
    ) -> None:
        if kind == "first":
            # never dispatched: the router's own admission shed
            self._resolve_shed(call, f"router shed: {why}")
        else:
            self._resolve_error(
                call,
                last_exc
                or RuntimeError(f"router: re-dispatch impossible ({why})"),
            )

    # -- reply handling (replica executor threads) -----------------------------

    def _on_reply(
        self,
        call: _Call,
        rep: _ReplicaState,
        fut: "concurrent.futures.Future",
        hedged: bool,
    ) -> None:
        try:
            res = fut.result()
        except EpochMismatchError as e:
            # the replica is healthy, its topology just moved between
            # coalesce and dispatch past the scheduler's own retry budget
            self._redispatch(call, "retry", e, hedged)
            return
        except QueryShedError as e:
            # overloaded (or stopping) replica: shed there, retry here
            rep.backoff.report_error()
            self._redispatch(call, "retry", e, hedged)
            return
        except Exception as e:  # noqa: BLE001 — anything else means down
            self._mark_dead(rep)
            rep.backoff.report_error()
            self._redispatch(call, "failover", e, hedged)
            return
        # health first: even a hedge loser's reply is evidence of life
        rep.backoff.report_success()
        need_epoch: Optional[int] = None
        deliver = False
        with self._lock:
            rep.alive = True
            if call.resolved:
                return  # hedge loser: observed, accounted, dropped
            if call.session is not None:
                pin = self._sessions.get(call.session, -1)
                if int(res.epoch) < pin:
                    need_epoch = pin  # stale: re-route, never deliver
                else:
                    self._sessions[call.session] = int(res.epoch)
                    if self.pin_trace is not None:
                        self.pin_trace.append((call.session, int(res.epoch)))
                    call.resolved = True
                    deliver = True
            else:
                call.resolved = True
                deliver = True
        if deliver:
            if hedged:
                self._bump("serving.router.hedge_wins")
            self._hist.record_us(
                int((time.perf_counter() - call.t_submit) * 1e6)
            )
            self._trace_terminal(call, "hedge_win" if hedged else "ok")
            if not call.future.done():
                call.future.set_result(res)
            return
        self._redispatch(
            call,
            "epoch_reroute",
            EpochMismatchError(need_epoch, int(res.epoch)),
            hedged,
            need_epoch=need_epoch,
        )

    def _redispatch(
        self,
        call: _Call,
        kind: str,
        exc: Exception,
        hedged: bool,
        need_epoch: Optional[int] = None,
    ) -> None:
        with self._lock:
            if call.resolved:
                return
        if hedged and kind != "epoch_reroute":
            # a failed hedge never re-dispatches — the primary chain owns
            # the call; its outcome already fed the replica's health
            return
        with call.lock:
            exhausted = call.attempts >= self.max_attempts
        if exhausted:
            self._resolve_error(call, exc)
            return
        self._dispatch(call, kind, last_exc=exc, need_epoch=need_epoch)

    # -- terminal resolution ---------------------------------------------------

    def _resolve_shed(self, call: _Call, msg: str) -> None:
        with self._lock:
            if call.resolved:
                return
            call.resolved = True
        self._bump("serving.router.sheds")
        self._trace_terminal(call, "shed")
        if not call.future.done():
            call.future.set_exception(QueryShedError(msg))

    def _resolve_error(self, call: _Call, exc: Exception) -> None:
        with self._lock:
            if call.resolved:
                return
            call.resolved = True
        self._trace_terminal(call, "error")
        if not call.future.done():
            call.future.set_exception(exc)

    @staticmethod
    def _trace_terminal(call: _Call, outcome: str) -> None:
        sp = call.span
        if sp is not None:
            tr = _trace.TRACE
            if tr is not None:
                sp.tags["outcome"] = outcome
                tr.finish_root(sp)

    # -- hedging ---------------------------------------------------------------

    def _arm_hedge(self, call: _Call) -> None:
        if self._hedge_thread is None or not self.hedge_after_s:
            return
        deadline = time.monotonic() + self.hedge_after_s
        with self._hedge_cv:
            self._hedge_pending.append((deadline, call))
            self._hedge_cv.notify()

    def _hedge_loop(self) -> None:
        while True:
            with self._hedge_cv:
                if self._stopped:
                    return
                if not self._hedge_pending:
                    self._hedge_cv.wait(timeout=0.2)
                    continue
                now = time.monotonic()
                due = [c for (d, c) in self._hedge_pending if d <= now]
                self._hedge_pending = [
                    (d, c)
                    for (d, c) in self._hedge_pending
                    if d > now and not c.resolved
                ]
            if not due:
                time.sleep(_HEDGE_TICK_S)
                continue
            for call in due:
                with self._lock:
                    if call.resolved or call.hedge_launched:
                        continue
                    call.hedge_launched = True
                self._dispatch(call, "hedge")

    # -- lifecycle -------------------------------------------------------------

    def stop(self) -> None:
        """Stop routing new work.  Replica lifecycles belong to whoever
        built them (main.ServingFleet tears the fleet down); the
        replicas' own stop() resolves any in-flight sub-futures, which
        resolves any caller futures still chained through _on_reply."""
        self._stopped = True
        with self._hedge_cv:
            self._hedge_cv.notify_all()
        if self._hedge_thread is not None:
            self._hedge_thread.join(timeout=2.0)
