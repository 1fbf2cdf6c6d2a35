"""The port's deterministic schedule explorer
(`openr_tpu_torch.analysis.sched`) against the reference's, on the CPU.

Oracle: tests/test_sched.py and tests/sched_corpus/.  The port's queue
and event-base seams declare the reference's yield points, so with the
same seed its DPOR explores the same schedules, prunes as many and
collects the same coverage tokens in every scenario, and one choice
string replays to the same trace in both packages; a difference would
be a yield point that differs.  The planted lost update is found,
replayed bit-identically and shrunk; the corpus entry still fails its
oracle; patches are scoped to a run; the tier-1 sweep, `sample_tokens`
and the CLI keep the reference's contract; and the serving seams
(`serving.admission`, `router.dispatch`) and the runtime's declare the
reference's calls in the reference's order.
"""

from __future__ import annotations

import concurrent.futures
import glob
import json
import os
import threading
from types import SimpleNamespace

import pytest

from openr_tpu.analysis import sched as j_sched
from openr_tpu_torch.analysis import sched

pytestmark = pytest.mark.sched

CORPUS_DIR = os.path.join(os.path.dirname(__file__), "sched_corpus")
PLANTED = "router_hedge_vs_death"
RUNS = [(name, False) for name in sched.SCENARIOS] + [
    (name, True) for name, sc in sched.SCENARIOS.items() if sc.plantable
]


def _corpus_entries() -> list:
    return sorted(glob.glob(os.path.join(CORPUS_DIR, "*.json")))


def test_scenarios_are_the_references():
    assert list(sched.SCENARIOS) == list(j_sched.SCENARIOS)
    assert sched.EXHAUSTIVE_SCENARIOS == j_sched.EXHAUSTIVE_SCENARIOS
    assert {n: s.plantable for n, s in sched.SCENARIOS.items()} == {
        n: s.plantable for n, s in j_sched.SCENARIOS.items()
    }
    assert sched.SCHED_COUNTER_KEYS == j_sched.SCHED_COUNTER_KEYS


class TestScheduleIds:
    def test_format_parse_round_trip(self):
        sid = sched.format_schedule_id("queue_shed_vs_carry", 3, [0, 2, 1])
        assert sid == "queue_shed_vs_carry:s3:0.2.1"
        assert sched.parse_schedule_id(sid) == ("queue_shed_vs_carry", False, 3, [0, 2, 1])
        sid = sched.format_schedule_id(PLANTED, 0, [], plant=True)
        assert sid == f"{PLANTED}+plant:s0:-"
        assert sched.parse_schedule_id(sid) == (PLANTED, True, 0, [])

    @pytest.mark.parametrize(
        "bad",
        ["", "no-colons", "queue_shed_vs_carry:s0", "queue_shed_vs_carry:sX:0",
         "queue_shed_vs_carry:s0:1.x", "unknown_scenario:s0:-"],
    )
    def test_malformed_ids_raise_value_error(self, bad):
        with pytest.raises(ValueError):
            sched.parse_schedule_id(bad)


class TestZeroOverheadUnarmed:
    def test_unarmed_state(self):
        assert sched.SCHED is None
        assert not sched.patches_installed()
        assert concurrent.futures.Future.result is not sched._patched_result
        assert threading.Thread.start is not sched._patched_thread_start

    def test_patches_scoped_to_a_run_and_removed_after(self):
        fut = concurrent.futures.Future
        before = (fut.set_result, fut.set_exception, fut.result, fut.exception,
                  threading.Thread.start, threading.Thread.join)
        run = sched.run_schedule("queue_shed_vs_carry", [])
        assert run.steps > 0
        assert not sched.patches_installed() and sched.SCHED is None
        assert (fut.set_result, fut.set_exception, fut.result, fut.exception,
                threading.Thread.start, threading.Thread.join) == before


@pytest.mark.parametrize("scenario, plant", RUNS,
                         ids=[f"{n}{'+plant' if p else ''}" for n, p in RUNS])
def test_dpor_explores_as_the_reference_does(scenario, plant):
    got = sched.explore(scenario, plant=plant, seed=0, mode="dpor")
    want = j_sched.explore(scenario, plant=plant, seed=0, mode="dpor")
    assert (got.schedules, got.prunes, got.complete) == (
        want.schedules, want.prunes, want.complete)
    assert got.complete
    assert got.coverage_tokens == want.coverage_tokens
    assert [(f.schedule_id, f.failures, f.trace_fingerprint) for f in got.failures] == [
        (f.schedule_id, f.failures, f.trace_fingerprint) for f in want.failures
    ]
    assert bool(got.failures) == plant


@pytest.mark.parametrize("scenario", list(sched.SCENARIOS))
def test_a_choice_string_replays_to_the_references_trace(scenario):
    for choices in ([], [1, 1, 1], [2, 0, 1, 2]):
        got = sched.run_schedule(scenario, choices)
        want = j_sched.run_schedule(scenario, choices)
        assert (got.trace, got.choices, got.failures, got.steps) == (
            want.trace, want.choices, want.failures, want.steps)


class TestDporReduction:
    @pytest.mark.parametrize("scenario", sched.EXHAUSTIVE_SCENARIOS)
    def test_dpor_explores_fewer_schedules_than_naive(self, scenario):
        d = sched.explore(scenario, seed=0, mode="dpor")
        n = sched.explore(scenario, seed=0, mode="naive")
        assert d.complete and n.complete
        assert d.schedules < n.schedules and d.prunes > 0
        assert not d.failures and not n.failures
        jn = j_sched.explore(scenario, seed=0, mode="naive")
        assert (n.schedules, n.prunes) == (jn.schedules, jn.prunes)

    def test_exploration_is_deterministic(self):
        a = sched.explore("queue_shed_vs_carry", seed=0, mode="dpor")
        b = sched.explore("queue_shed_vs_carry", seed=0, mode="dpor")
        assert (a.schedules, a.prunes, a.coverage_tokens) == (
            b.schedules, b.prunes, b.coverage_tokens)


class TestPlantedBug:
    def test_explore_finds_replays_and_shrinks_the_plant(self):
        r = sched.explore(PLANTED, plant=True, seed=0, mode="dpor")
        assert r.complete and r.failures, "planted bug not found"
        found = r.failures[0]
        assert any("ledger-lost-update" in f for f in found.failures)
        r1 = sched.replay_schedule(found.schedule_id)
        r2 = sched.replay_schedule(found.schedule_id)
        assert r1.trace == r2.trace
        assert r1.trace_fingerprint() == found.trace_fingerprint
        assert r1.failures == found.failures
        shrunk, best = sched.shrink_schedule(PLANTED, found.choices, plant=True)
        assert len(shrunk) <= 2 < len(found.choices)
        assert sched._failure_signature(best.failures) == sched._failure_signature(
            found.failures)
        j_shrunk, _ = j_sched.shrink_schedule(PLANTED, found.choices, plant=True)
        assert shrunk == j_shrunk

    def test_unplanted_scenario_is_clean_everywhere(self):
        r = sched.explore(PLANTED, plant=False, seed=0, mode="dpor")
        assert r.complete and not r.failures

    def test_counters_count_the_session(self):
        before = sched.SCHED_COUNTERS.get_counters()
        r = sched.explore(PLANTED, plant=True, seed=0, mode="dpor")
        sched.replay_schedule(r.failures[0].schedule_id)
        now = sched.SCHED_COUNTERS.get_counters()
        delta = {k: now[k] - before[k] for k in now}
        assert delta["sched.schedules_explored"] == r.schedules
        assert delta["sched.dpor_prunes"] == r.prunes
        assert delta["sched.planted_finds"] == len(r.failures)
        assert delta["sched.replays"] == 1
        assert sched.SchedCounters().get_counters() == {
            k: 0 for k in sched.SCHED_COUNTER_KEYS}


class TestSchedCorpus:
    def test_corpus_directory_is_nonempty(self):
        assert _corpus_entries()

    @pytest.mark.parametrize("path", _corpus_entries(),
                             ids=[os.path.basename(p) for p in _corpus_entries()])
    def test_corpus_entry_still_fails_its_oracle(self, path):
        with open(path) as fh:
            entry = json.load(fh)
        scenario, plant, _seed, choices = sched.parse_schedule_id(entry["schedule_id"])
        assert len(choices) <= 4, entry["schedule_id"]
        run = sched.replay_schedule(entry["schedule_id"])
        assert entry["oracle"] in sched._failure_signature(run.failures), (
            entry["schedule_id"], run.failures)
        if plant:
            clean = sched.run_schedule(scenario, choices, plant=False)
            assert not clean.failures, clean.failures


class TestTier1Smoke:
    def test_library_sweep_is_clean_with_certificates(self):
        out = sched.tier1_smoke(total_budget_s=60.0)
        assert out["failures"] == [] and out["shed"] == []
        assert set(out["scenarios"]) == set(sched.SCENARIOS)
        for name in sched.EXHAUSTIVE_SCENARIOS:
            row = out["scenarios"][name]
            assert row["mode"] == "dpor" and row["complete"], (name, row)

    def test_budget_sheds_loudly_never_silently(self):
        out = sched.tier1_smoke(total_budget_s=1e-4)
        assert set(out["scenarios"]) | set(out["shed"]) == set(sched.SCENARIOS)
        assert out["shed"]

    def test_budget_is_read_the_references_way(self, monkeypatch):
        monkeypatch.setenv("OPENR_SCHED_BUDGET_S", "7.5")
        assert sched.budget_s() == j_sched.budget_s() == 7.5
        monkeypatch.setenv("OPENR_SCHED_BUDGET_S", "junk")
        assert sched.budget_s(3.0) == j_sched.budget_s(3.0) == 3.0


class TestFuzzFrontierTokens:
    def test_sample_tokens_equal_the_references(self):
        a = sched.sample_tokens(7, n_schedules=8)
        assert a and a == sched.sample_tokens(7, n_schedules=8)
        assert a == j_sched.sample_tokens(7, n_schedules=8)
        for tok in a:
            kind, scenario, fp = tok.split(":")
            assert kind == "sched" and scenario in sched.SCENARIOS
            assert len(fp) == 10 and int(fp, 16) >= 0


class TestCliContract:
    @staticmethod
    def ns(**kw):
        base = dict(sched_replay=None, sched_shrink=None, sched_seed=0)
        base.update(kw)
        return SimpleNamespace(**base)

    def test_replay_exit_codes(self, capsys):
        assert sched.run_cli(self.ns(sched_replay=f"{PLANTED}+plant:s0:1.1")) == 1
        assert "ledger-lost-update" in capsys.readouterr().out
        assert sched.run_cli(self.ns(sched_replay=f"{PLANTED}:s0:1.1")) == 0

    def test_malformed_id_is_infra_not_finding(self, capsys):
        assert sched.run_cli(self.ns(sched_replay="bogus:s0:-")) == 2
        assert "infra error" in capsys.readouterr().out

    def test_shrink_mode_prints_minimal_id(self, capsys):
        assert sched.run_cli(self.ns(sched_shrink=f"{PLANTED}+plant:s0:0.0.1.1.0.0")) == 1
        out = capsys.readouterr().out
        assert "shrunk 6 ->" in out and "FAIL ledger-lost-update" in out

    def test_analysis_cli_routes_sched_flags(self, capsys):
        from openr_tpu_torch.analysis import cli

        assert cli.main(["--sched-replay", f"{PLANTED}+plant:s0:1.1"]) == 1
        assert cli.main(["--sched-replay", "bogus:s0:-"]) == 2
        assert cli.main(["--sched"]) == 0
        out = capsys.readouterr().out
        assert "sched router_hedge_vs_death:" in out and "exhaustive" in out


# ---------------------------------------------------------------------------
# The runtime and serving seams declare the reference's yield points
# ---------------------------------------------------------------------------


class Recorder:
    """A stand-in controller that records the seam calls made on the
    thread that installed it (module threads pass through)."""

    def __init__(self) -> None:
        self.tid = threading.get_ident()
        self.calls: list = []

    def _rec(self, *call) -> None:
        if threading.get_ident() == self.tid:
            self.calls.append(call)

    def queue_op(self, q, kind):
        self._rec("queue_op", type(q).__name__, kind)

    def queue_get_gate(self, q, ready):
        self._rec("queue_get_gate", type(q).__name__)
        return False

    def handoff(self, eb):
        self._rec("handoff", type(eb).__name__)

    def region(self, point):
        self._rec("region", point)


def _drive_seams(pkg: str) -> list:
    import importlib

    smod = importlib.import_module(f"{pkg}.analysis.sched")
    queue = importlib.import_module(f"{pkg}.runtime.queue")
    eventbase = importlib.import_module(f"{pkg}.runtime.eventbase")
    serving = importlib.import_module(f"{pkg}.serving")
    eb = eventbase.OpenrEventBase("seams")
    eb.run()
    sch = serving.QueryScheduler(backend=None)
    router = serving.ReplicaRouter([serving.SchedulerReplica("r0", sch)], hedge_after_s=None)
    rec = Recorder()
    smod.SCHED = rec
    try:
        q = queue.RWQueue()
        q.push(1)
        q.try_get()
        q.push(2)
        q.get(timeout=1)
        q.close()
        rq = queue.ReplicateQueue()
        r1, r2 = rq.get_reader(), rq.get_reader()
        rq.push("x")
        r1.try_get()
        eb.run_in_event_base_thread(lambda: 1).result(5)
        done = concurrent.futures.Future()
        eb.schedule_timeout(0.0, lambda: done.set_result(True))
        done.result(5)

        async def fiber():
            return None

        eb.add_fiber_task(fiber(), name="seam-fiber")
        sch.submit("paths", sources=("a",))
        router.stop()
        shed = router.submit("paths", sources=("a",))
    finally:
        smod.SCHED = None
        eb.stop()
        sch._pool.shutdown(wait=False)
    assert shed.done() and shed.exception() is not None
    return rec.calls


def test_seams_declare_the_references_yield_points():
    got = _drive_seams("openr_tpu_torch")
    assert got == _drive_seams("openr_tpu")
    assert ("region", "serving.admission") in got and ("region", "router.dispatch") in got
    assert [c for c in got if c[0] == "handoff"] == [("handoff", "OpenrEventBase")] * 3


def test_a_controlled_get_takes_the_gated_pop():
    """Under a controller, a blocking get is granted only once an item
    is there (or the queue closed) and then pops without waiting."""
    run = sched.run_schedule("queue_shed_vs_carry", [1, 0, 1, 0, 1])
    want = j_sched.run_schedule("queue_shed_vs_carry", [1, 0, 1, 0, 1])
    assert run.trace == want.trace and not run.failures
    assert ("consumer", "queue.get", "q:1") in run.trace
