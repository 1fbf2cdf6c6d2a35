"""The port's replica-fleet chaos and open-loop load generator
(`openr_tpu_torch.chaos.replicafleet`, `openr_tpu_torch.chaos.overload`)
against `openr_tpu.chaos`, on the CPU.

Oracles: tests/test_replicafleet.py (TestReplicaFleetChaos,
TestElasticFleetChaos, the diverging seed) and
tests/test_router.py::TestLoadGenIntegration.  The same seed gives the
same scripted event log in both packages (kills, restarts, partitions,
lags, scale-out and scale-in); reply and retry counts are timing-
dependent and, as in the reference, not logged.  Each run meets the
reference's acceptance bar: no silent drop, every answer bit-exact
against the host Dijkstra at the epoch it claims, session pins only
forward, the router's dispatch ledger closing.  The load generator
offers the reference's query sequence for a seed.
"""

from __future__ import annotations

import concurrent.futures
import os
import random

import pytest

from openr_tpu.chaos import ChaosEventLog as JLog
from openr_tpu.chaos import OpenLoopLoadGen as JLoadGen
from openr_tpu.chaos import ReplicaFleetController as JController
from openr_tpu.decision.spf_solver import DeviceSpfBackend as JDeviceSpfBackend
from openr_tpu_torch.chaos import (
    ChaosEventLog,
    LoadReport,
    OpenLoopLoadGen,
    ReplicaFleetController,
)
from openr_tpu_torch.decision.spf_solver import DeviceSpfBackend

pytestmark = pytest.mark.chaos

_SEED = int(os.environ.get("OPENR_REPLICAFLEET_SEED", "7"))
_FLEET = dict(n=12, replicas=3, rounds=8, clients=8, per_client=7)
_ELASTIC = dict(
    n=12, replicas=2, rounds=4, clients=4, per_client=5, kill_round=-1, restart_round=-1,
    partition_round=-1, heal_round=-1, lag_rounds=(), scaleout_round=1, scalein_round=3,
)


def _port(seed: int, log_, **kw):
    return ReplicaFleetController(seed=seed, log_=log_, device="cpu", **kw).run()


def assert_acceptance(result) -> None:
    assert result.accounted == result.submitted, (result.submitted, result.accounted)
    assert result.unknown_epochs == 0
    assert result.bit_exact, result.mismatches
    assert result.pin_violations == 0
    assert result.ledger_ok


@pytest.fixture(scope="module")
def fleet():
    log = ChaosEventLog()
    result = _port(_SEED, log, spf_backend=DeviceSpfBackend("cpu"), **_FLEET)
    return result, log


def test_fleet_meets_the_acceptance_bar(fleet):
    result, _ = fleet
    assert result.submitted >= 400
    assert_acceptance(result)
    assert len(result.epochs_served) >= 2, result.epochs_served
    c = result.counters
    redispatches = (c["serving.router.retries"] + c["serving.router.hedges"]
                    + c["serving.router.failovers"] + c["serving.router.epoch_reroutes"])
    assert c["serving.router.dispatches"] == (
        result.submitted - c["serving.router.sheds"]) + redispatches


def test_faults_actually_fired(fleet):
    result, _ = fleet
    c = result.counters
    assert c["serving.router.failovers"] >= 1
    assert c["serving.router.replica_deaths"] >= 1
    assert c["serving.router.probe_failures"] >= 1
    assert c["serving.router.epoch_reroutes"] >= 1


def test_fleet_log_is_the_references(fleet):
    """The scripted stream, the replay contract, against the reference's
    run of the same seed (its device backend thresholds lowered, as its
    own test does)."""
    _, log = fleet
    jlog = JLog()
    ref = JController(
        seed=_SEED, spf_backend=JDeviceSpfBackend(min_device_nodes=1, min_device_sources=1),
        log_=jlog, **_FLEET,
    ).run()
    assert ref.accounted == ref.submitted and ref.bit_exact
    assert log.scenario() == jlog.scenario()
    assert log.matches(jlog)


def test_elastic_membership_is_the_references():
    log, jlog = ChaosEventLog(), JLog()
    port = _port(_SEED, log, spf_backend=None, **_ELASTIC)
    JController(seed=_SEED, spf_backend=None, log_=jlog, **_ELASTIC).run()
    assert_acceptance(port)
    assert log.scenario() == jlog.scenario()
    steps = [s for s in log.scenario() if "fleet:scale" in s]
    assert any(s.endswith((":install", ":replay")) for s in steps), steps
    assert any("fleet:scalein:replica-" in s for s in steps), steps


def test_same_seed_replays_and_another_diverges(fleet):
    _, log = fleet
    again = ChaosEventLog()
    assert_acceptance(_port(_SEED, again, spf_backend=DeviceSpfBackend("cpu"), **_FLEET))
    assert log.matches(again)
    tiny = dict(n=8, replicas=2, rounds=4, clients=2, per_client=3)
    one, two = ChaosEventLog(), ChaosEventLog()
    backend = DeviceSpfBackend("cpu")
    _port(1, one, spf_backend=backend, **tiny)
    _port(2, two, spf_backend=backend, **tiny)
    assert not one.matches(two)


# -- the open-loop load generator ----------------------------------------------


class Recorder:
    """A scheduler that answers every query at once and records it."""

    def __init__(self, result_cls) -> None:
        self.result_cls = result_cls
        self.offered: list = []

    def submit(self, op, **kw):
        self.offered.append((op, tuple(sorted(kw.items()))))
        fut: concurrent.futures.Future = concurrent.futures.Future()
        fut.set_result(self.result_cls(value={}, latency_us=7, batch_size=2, epoch=1))
        return fut


def test_offered_load_is_the_references():
    from openr_tpu.serving import QueryResult as JQueryResult
    from openr_tpu_torch.serving import QueryResult

    nodes = [f"n{i}" for i in range(9)]
    ops = ("paths", "what_if", "ksp")
    offered = []
    for gen_cls, result_cls in ((OpenLoopLoadGen, QueryResult), (JLoadGen, JQueryResult)):
        sched = Recorder(result_cls)
        gen = gen_cls(sched, nodes, seed=5, clients=3, ops=ops, sessions=True)
        for i in range(3):
            rng = random.Random(gen.seed * 1000 + i)
            for _ in range(20):
                gen._submit_one(rng, i)
        offered.append(sched.offered)
    assert offered[0] == offered[1]
    assert {op for op, _ in offered[0]} == set(ops)


def test_open_loop_ledger_reconciles_over_fakes():
    """tests/test_router.py::TestLoadGenIntegration over the port's router."""
    from test_torch_router import PKGS, FakeReplica

    pkg = PKGS["port"]
    reps = [FakeReplica(pkg, f"r{i}", epoch=4) for i in range(3)]
    router = pkg.Router(reps, hedge_after_s=None)
    gen = OpenLoopLoadGen(router, ["a", "b", "c"], seed=3, clients=4, sessions=True)
    report = gen.run_burst(25)
    router.stop()
    assert report.submitted == 100
    assert report.accounted == report.submitted == report.replied
    assert pkg.ledger(router.get_counters(), report.submitted)
    assert report.mean_batch_occupancy == 1 and report.pctl_us(99) == 1


def test_load_report_accounting():
    rep = LoadReport(submitted=5, replied=3, shed=1, errors=1, wall_s=0.5,
                     latencies_us=[5, 1, 3], batch_sizes=[1, 3])
    assert rep.accounted == rep.submitted
    assert rep.qps == 6.0 and rep.mean_batch_occupancy == 2.0
    assert (rep.pctl_us(0), rep.pctl_us(50), rep.pctl_us(99)) == (1, 3, 5)
    assert LoadReport().pctl_us(99) == 0 and LoadReport().qps == 0.0
