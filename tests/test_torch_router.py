"""The port's ReplicaRouter (`openr_tpu_torch.serving.router`) against
`openr_tpu.serving.router`, on the CPU.

Oracle: tests/test_router.py.  Each scenario below is one of its
`FakeReplica` scripts (replica modes flipped by hand: ok, shed,
unavailable, sync_raise, hold), run once through each package's router
with that package's own QueryResult / QueryShedError /
EpochMismatchError.  A scenario returns what a caller and an operator
see: the delivered replies (which replica answered, at which epoch) or
the error class, the `serving.router.*` counters, the session pins and
how the submits spread over the replicas.  The two records must be
equal, and each also meets the reference test's own expectations.
Router counters are host integers: no tolerance.

Every router is stopped (its hedge thread joined) before a scenario
returns; waits are bounded.
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
from types import SimpleNamespace

import pytest

from openr_tpu.device.engine import EpochMismatchError as JEpochMismatchError
from openr_tpu.serving import (
    ROUTER_COUNTER_KEYS as J_ROUTER_COUNTER_KEYS,
    QueryResult as JQueryResult,
    QueryShedError as JQueryShedError,
    ReplicaRouter as JReplicaRouter,
    ReplicaUnavailableError as JReplicaUnavailableError,
    dispatch_ledger_closes as j_dispatch_ledger_closes,
)
from openr_tpu_torch.device.engine import EpochMismatchError
from openr_tpu_torch.serving import (
    ROUTER_COUNTER_KEYS,
    QueryResult,
    QueryShedError,
    ReplicaRouter,
    ReplicaUnavailableError,
    SchedulerReplica,
    dispatch_ledger_closes,
)

PKGS = {
    "port": SimpleNamespace(
        Router=ReplicaRouter, Result=QueryResult, Shed=QueryShedError,
        Unavailable=ReplicaUnavailableError, Mismatch=EpochMismatchError,
        ledger=dispatch_ledger_closes,
    ),
    "reference": SimpleNamespace(
        Router=JReplicaRouter, Result=JQueryResult, Shed=JQueryShedError,
        Unavailable=JReplicaUnavailableError, Mismatch=JEpochMismatchError,
        ledger=j_dispatch_ledger_closes,
    ),
}


class FakeReplica:
    """tests/test_router.py's FakeReplica over one package's types."""

    def __init__(self, pkg, name: str, epoch: int = 1, mode: str = "ok") -> None:
        self.pkg = pkg
        self.name = name
        self.epoch_value = epoch
        self.mode = mode
        self.submits: list = []
        self.held: list = []
        self.mismatch_first = False

    def submit(self, op: str, **kw) -> "concurrent.futures.Future":
        if self.mode == "sync_raise":
            raise self.pkg.Unavailable(f"{self.name} down hard")
        self.submits.append((op, kw))
        fut: "concurrent.futures.Future" = concurrent.futures.Future()
        if self.mismatch_first:
            self.mismatch_first = False
            fut.set_exception(self.pkg.Mismatch(1, 2))
        elif self.mode == "ok":
            fut.set_result(self._result())
        elif self.mode == "shed":
            fut.set_exception(self.pkg.Shed(f"{self.name} overloaded"))
        elif self.mode == "unavailable":
            fut.set_exception(self.pkg.Unavailable(f"{self.name} down"))
        else:  # hold
            self.held.append(fut)
        return fut

    def _result(self):
        return self.pkg.Result(
            value={"from": self.name}, latency_us=1, batch_size=1, epoch=self.epoch_value
        )

    def release(self) -> None:
        for fut in self.held:
            if not fut.done():
                fut.set_result(self._result())
        self.held = []

    def epoch(self, area: str = "0") -> int:
        if self.mode in ("unavailable", "sync_raise"):
            raise self.pkg.Unavailable(f"{self.name} down")
        return self.epoch_value

    def get_counters(self) -> dict:
        return {"serving.admitted": 1, "serving.p99_us": 100}


class Run:
    """One scenario's router, replicas and record."""

    def __init__(self, pkg, reps, **kw) -> None:
        kw.setdefault("hedge_after_s", None)
        self.pkg = pkg
        self.reps = reps
        self.router = pkg.Router(reps, **kw)
        self.router.pin_trace = []
        self.submitted = 0
        self.delivered: list = []

    def ask(self, session=None, timeout: float = 10.0):
        self.submitted += 1
        fut = self.router.submit("paths", sources=("a",), session=session)
        try:
            res = fut.result(timeout)
        except concurrent.futures.TimeoutError:
            raise
        except Exception as e:  # noqa: BLE001 — recorded by class name
            self.delivered.append(type(e).__name__)
            return None
        self.delivered.append((res.value["from"], int(res.epoch)))
        return res

    def record(self) -> dict:
        self.router.stop()
        counters = self.router.get_counters()
        return {
            "delivered": self.delivered,
            "counters": {k: counters[k] for k in ROUTER_COUNTER_KEYS},
            "rollup": {k: v for k, v in counters.items() if not k.startswith("serving.router.")},
            "spread": [len(r.submits) for r in self.reps],
            "pins": list(self.router.pin_trace),
            "alive": self.router.alive_replicas(),
            "ledger": self.pkg.ledger(counters, self.submitted),
        }


def round_robin(pkg):
    run = Run(pkg, [FakeReplica(pkg, f"r{i}") for i in range(3)])
    for _ in range(6):
        run.ask()
    rec = run.record()
    assert rec["spread"] == [2, 2, 2] and rec["counters"]["serving.router.dispatches"] == 6
    return rec


def rollup_sums_and_maxes_gauges(pkg):
    run = Run(pkg, [FakeReplica(pkg, "a"), FakeReplica(pkg, "b")])
    rec = run.record()
    assert rec["rollup"]["serving.admitted"] == 2 and rec["rollup"]["serving.p99_us"] == 100
    return rec


def async_unavailable_fails_over(pkg):
    run = Run(pkg, [FakeReplica(pkg, "down", mode="unavailable"), FakeReplica(pkg, "up")])
    run.ask()
    rec = run.record()
    c = rec["counters"]
    assert rec["delivered"] == [("up", 1)]
    assert (c["serving.router.failovers"], c["serving.router.replica_deaths"]) == (1, 1)
    return rec


def sync_refusal_is_not_a_dispatch(pkg):
    run = Run(pkg, [FakeReplica(pkg, "hard", mode="sync_raise"), FakeReplica(pkg, "up")])
    run.ask()
    rec = run.record()
    assert rec["counters"]["serving.router.dispatches"] == 1
    return rec


def probe_revives_a_healed_replica(pkg):
    rep = FakeReplica(pkg, "r", mode="unavailable")
    run = Run(pkg, [rep], initial_backoff_s=0.005)
    probes = [run.router.probe_replicas()]
    rep.mode = "ok"
    time.sleep(0.02)  # past the backoff window
    probes.append(run.router.probe_replicas())
    rec = run.record()
    rec["probes"] = probes
    assert probes == [0, 1] and rec["alive"] == 1
    return rec


def replica_shed_retries_elsewhere(pkg):
    run = Run(pkg, [FakeReplica(pkg, "shedding", mode="shed"), FakeReplica(pkg, "up")])
    run.ask()
    rec = run.record()
    assert rec["counters"]["serving.router.retries"] == 1 and rec["alive"] == 2
    return rec


def fleetwide_shed_propagates(pkg):
    run = Run(pkg, [FakeReplica(pkg, f"r{i}", mode="shed") for i in range(2)])
    run.ask()
    rec = run.record()
    assert rec["delivered"] == ["QueryShedError"] and rec["counters"]["serving.router.sheds"] == 0
    return rec


def no_replicas_sheds_at_admission(pkg):
    run = Run(pkg, [])
    run.ask()
    rec = run.record()
    assert rec["counters"]["serving.router.sheds"] == 1
    return rec


def stopped_router_sheds(pkg):
    run = Run(pkg, [FakeReplica(pkg, "r")])
    run.router.stop()
    run.ask()
    rec = run.record()
    assert rec["delivered"] == ["QueryShedError"]
    return rec


def stale_reply_reroutes(pkg):
    run = Run(pkg, [FakeReplica(pkg, "ahead", epoch=5), FakeReplica(pkg, "behind", epoch=3)])
    run.ask(session="s")
    run.ask(session="s")
    rec = run.record()
    assert rec["delivered"] == [("ahead", 5), ("ahead", 5)]
    assert rec["counters"]["serving.router.epoch_reroutes"] == 1
    return rec


def stale_never_delivered(pkg):
    ahead = FakeReplica(pkg, "ahead", epoch=5)
    run = Run(pkg, [ahead, FakeReplica(pkg, "behind", epoch=3)], max_attempts=4)
    run.ask(session="s")
    ahead.mode = "unavailable"
    run.ask(session="s")
    rec = run.record()
    assert rec["delivered"][0] == ("ahead", 5) and rec["delivered"][1] == "EpochMismatchError"
    rec["pin"] = run.router.session_pin("s")
    assert rec["pin"] == 5
    return rec


def sessionless_has_no_pin(pkg):
    run = Run(pkg, [FakeReplica(pkg, "behind", epoch=3)])
    run.ask()
    rec = run.record()
    assert rec["pins"] == [] and rec["delivered"] == [("behind", 3)]
    return rec


def pin_only_moves_forward(pkg):
    rep = FakeReplica(pkg, "r", epoch=5)
    run = Run(pkg, [rep])
    run.ask(session="s")
    rep.epoch_value = 9
    run.ask(session="s")
    rec = run.record()
    assert [e for _s, e in rec["pins"]] == [5, 9]
    return rec


def hedge_wins_when_primary_stalls(pkg):
    slow, fast = FakeReplica(pkg, "slow", mode="hold"), FakeReplica(pkg, "fast")
    run = Run(pkg, [slow, fast], hedge_after_s=0.01)
    run.ask()
    slow.release()  # the loser resolves late: observed, dropped
    rec = run.record()
    c = rec["counters"]
    assert rec["delivered"] == [("fast", 1)]
    assert (c["serving.router.hedges"], c["serving.router.hedge_wins"]) == (1, 1)
    assert rec["alive"] == 2
    return rec


def no_hedge_before_the_deadline(pkg):
    run = Run(pkg, [FakeReplica(pkg, "a"), FakeReplica(pkg, "b")], hedge_after_s=5.0)
    run.ask()
    time.sleep(0.02)
    rec = run.record()
    assert rec["counters"]["serving.router.hedges"] == 0
    return rec


def epoch_mismatch_is_retried(pkg):
    rep = FakeReplica(pkg, "flappy", epoch=2)
    rep.mismatch_first = True
    run = Run(pkg, [rep])
    run.ask()
    rec = run.record()
    c = rec["counters"]
    assert rec["delivered"] == [("flappy", 2)]
    assert (c["serving.router.retries"], c["serving.router.replica_deaths"]) == (1, 0)
    return rec


def join_and_leave_keep_the_rollup_monotone(pkg):
    a = FakeReplica(pkg, "a")
    run = Run(pkg, [a], hedge_after_s=0.05)
    run.ask()
    before = run.router.get_counters()["serving.admitted"]
    run.router.add_replica(FakeReplica(pkg, "b"))
    hedging = run.router._hedge_thread is not None
    for _ in range(4):
        run.ask()
    gone = run.router.remove_replica("b")
    missing = run.router.remove_replica("nobody")
    run.ask()
    after = run.router.get_counters()["serving.admitted"]
    rec = run.record()
    rec.update(
        hedging=hedging, gone=gone.name, missing=missing,
        admitted=(before, after), max_attempts=run.router.max_attempts,
    )
    assert hedging and gone.name == "b" and missing is None
    assert after == before + 1  # b's final counters folded in
    return rec


SCENARIOS = {
    f.__name__: f
    for f in (
        round_robin,
        rollup_sums_and_maxes_gauges,
        async_unavailable_fails_over,
        sync_refusal_is_not_a_dispatch,
        probe_revives_a_healed_replica,
        replica_shed_retries_elsewhere,
        fleetwide_shed_propagates,
        no_replicas_sheds_at_admission,
        stopped_router_sheds,
        stale_reply_reroutes,
        stale_never_delivered,
        sessionless_has_no_pin,
        pin_only_moves_forward,
        hedge_wins_when_primary_stalls,
        no_hedge_before_the_deadline,
        epoch_mismatch_is_retried,
        join_and_leave_keep_the_rollup_monotone,
    )
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scenario_as_the_reference(scenario):
    fn = SCENARIOS[scenario]
    port = fn(PKGS["port"])
    ref = fn(PKGS["reference"])
    assert port == ref
    assert port["ledger"]


def test_counter_keys_and_exports_are_the_references():
    import openr_tpu.serving as jserving
    import openr_tpu_torch.serving as serving

    assert ROUTER_COUNTER_KEYS == J_ROUTER_COUNTER_KEYS
    assert set(jserving.__all__) == set(serving.__all__)
    assert ReplicaRouter.supports_sessions is True
    router = ReplicaRouter([FakeReplica(PKGS["port"], "a")], hedge_after_s=None)
    assert all(router.counters[k] == 0 for k in ROUTER_COUNTER_KEYS)
    router.stop()


@pytest.mark.parametrize("which", sorted(PKGS))
def test_dispatch_ledger_closes_reads_the_identity(which):
    ledger = PKGS[which].ledger
    c = {k: 0 for k in ROUTER_COUNTER_KEYS}
    c.update({"serving.router.dispatches": 7, "serving.router.sheds": 1,
              "serving.router.retries": 1, "serving.router.hedges": 2})
    assert ledger(c, 5)
    assert not ledger(c, 6)


def test_stop_joins_the_hedge_thread():
    router = ReplicaRouter(
        [FakeReplica(PKGS["port"], "a"), FakeReplica(PKGS["port"], "b")], hedge_after_s=0.01
    )
    thread = router._hedge_thread
    assert thread is not None and thread.is_alive()
    router.stop()
    assert not thread.is_alive()


def test_scheduler_replica_wraps_a_scheduler():
    """SchedulerReplica reads the scheduler's backend epoch and counters
    and submits into it, as the reference's does."""
    from openr_tpu_torch.serving import EngineBatchBackend, QueryScheduler
    from torch_parity import LinkStatePair, square_dbs

    pair = LinkStatePair(square_dbs())
    sched = QueryScheduler(EngineBatchBackend({"0": pair.ls}, device="cpu"))
    sched.run()
    try:
        rep = SchedulerReplica("r0", sched)
        router = ReplicaRouter([rep], hedge_after_s=None)
        res = router.submit("paths", sources=("1",), session="s").result(30)
        assert rep.epoch("0") == int(pair.ls.version) == res.epoch
        assert router.session_pin("s") == res.epoch
        assert rep.get_counters()["serving.replies"] == 1
        router.stop()
        assert dispatch_ledger_closes(router.get_counters(), 1)
    finally:
        sched.stop()
    assert not [t for t in threading.enumerate() if t.name == "router-hedge" and t.is_alive()]
