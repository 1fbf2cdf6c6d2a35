"""The port's coverage-guided chaos fuzzer (`openr_tpu_torch.chaos.fuzz`)
against `openr_tpu.chaos.fuzz`, on the CPU.

Oracle: tests/test_fuzz.py.  The same timeline and seed give the same
scenario log, the same counter deltas and the same fingerprint in both
packages after the documented mapping (the module's docstring):

- the reference's `device.engine.pallas_*` keys have no counterpart,
  and the port's `device.engine.kernel_launches.*` keys stay 0 on the
  CPU, whose wrappers run their plain versions uncounted;
  `mesh.blocked.pipeline_fallbacks` is compared as it is;
- an armed `pallas` fault fires at the port's `kernel` gate only in the
  world's `interpret` mode, propagates, and is retried once: the port's
  log holds one more `fuzz:fault:fired:` step where the reference
  demotes to XLA;
- a fault that fires inside a replica's query is answered on the host in
  the reference (`serving.host_fallbacks`) and re-dispatched by the
  router in the port, which moves only the engine's residency counters.

Every checked-in corpus entry replays clean through both packages, and
`planted_kv_ledger.json` still fails `ledger_kv` armed in both.
"""

from __future__ import annotations

import glob
import os
import threading

import pytest

from openr_tpu.chaos import fuzz as rfz
from openr_tpu_torch.chaos import fuzz as fz

pytestmark = pytest.mark.fuzz

CORPUS_DIR = os.path.join(os.path.dirname(__file__), "chaos_corpus")
SMOKE_N = 26
SMOKE_SEED = 20260807
PARITY_N = 12
CPU = "cpu"

# the reference-only counters, and the port's stand-ins for them
REF_ONLY = ("device.engine.pallas_",)
PORT_ONLY = ("device.engine.kernel_launches.",)
# what a replica-side fault moves: the replicas' residency on the shared
# engine (the port re-dispatches the query, the reference answers it on
# the host)
RESIDENCY = ("device.engine.queries", "device.engine.full_restages",
             "device.engine.incremental_updates")


def _entries() -> list:
    return sorted(glob.glob(os.path.join(CORPUS_DIR, "*.json")))


def _text(path: str) -> str:
    with open(path) as fh:
        return fh.read()


def mapped(result, only) -> tuple:
    """(fingerprint, counters) of a run with the other package's names
    taken out."""
    tokens = frozenset(t for t in result.fingerprint if not t.startswith(only))
    counters = {k: v for k, v in result.counters.items() if not k.startswith(only)}
    return tokens, counters


def assert_port_is_ref(port, ref, served_fault=False) -> None:
    assert port.ok == ref.ok and port.failures == ref.failures
    assert port.log.streams() == ref.log.streams()
    assert (port.applied, port.skipped, port.faults_fired) == (
        ref.applied, ref.skipped, ref.faults_fired)
    assert all(port.counters[k] == 0 for k in port.counters if k.startswith(PORT_ONLY))
    p_tokens, p_counters = mapped(port, PORT_ONLY)
    r_tokens, r_counters = mapped(ref, REF_ONLY)
    if not served_fault:
        assert p_tokens == r_tokens
        assert p_counters == r_counters
        return
    moved = {k for k in p_counters if p_counters[k] != r_counters[k]}
    assert moved <= set(RESIDENCY), moved
    assert {t.rsplit(":", 1)[0] for t in p_tokens ^ r_tokens} <= set(RESIDENCY)


class ServedFaults:
    """Records, per run, whether an armed fault fired off the fuzzing
    thread (inside a replica's scheduler)."""

    def __init__(self, monkeypatch) -> None:
        self.runs: list[bool] = []
        self.main = threading.get_ident()
        real = fz._FuzzWorld._fault_hook
        real_run = fz.run_timeline
        served = self

        def hook(world, op):
            fired = len(world.fired)
            try:
                real(world, op)
            finally:
                if len(world.fired) > fired and threading.get_ident() != served.main:
                    served.runs[-1] = True

        def run_timeline(*args, **kwargs):
            served.runs.append(False)
            return real_run(*args, **kwargs)

        monkeypatch.setattr(fz._FuzzWorld, "_fault_hook", hook)
        monkeypatch.setattr(fz, "run_timeline", run_timeline)


# -- corpus replays through both packages -------------------------------------


@pytest.mark.parametrize("path", _entries(), ids=[os.path.basename(p) for p in _entries()])
def test_corpus_entry_replays_clean_in_both(path):
    text = _text(path)
    port = fz.run_timeline(fz.FuzzTimeline.loads(text), device=CPU)
    ref = rfz.run_timeline(rfz.FuzzTimeline.loads(text))
    assert port.ok, (os.path.basename(path), port.failures)
    assert_port_is_ref(port, ref)


def test_corpus_directory_is_nonempty_and_readonly():
    entries = _entries()
    assert len(entries) >= 5
    before = {p: _text(p) for p in entries}
    fz.run_timeline(fz.FuzzTimeline.loads(before[entries[0]]), device=CPU)
    assert {p: _text(p) for p in _entries()} == before


def test_planted_reproducer_still_fails_armed_in_both():
    text = _text(os.path.join(CORPUS_DIR, "planted_kv_ledger.json"))
    t = fz.FuzzTimeline.loads(text)
    assert t.oracle == "ledger_kv" and len(t.events) <= 10
    port = fz.run_timeline(t, plant=True, device=CPU)
    ref = rfz.run_timeline(rfz.FuzzTimeline.loads(text), plant=True)
    assert not port.ok and "ledger_kv" in port.failures
    assert_port_is_ref(port, ref)


# -- seeded sessions ------------------------------------------------------------


def test_session_is_the_references(monkeypatch):
    served = ServedFaults(monkeypatch)
    port = fz.fuzz(PARITY_N, seed=SMOKE_SEED, device=CPU)
    ref = rfz.fuzz(PARITY_N, seed=SMOKE_SEED)
    assert [t.to_json() for t in port.corpus] == [t.to_json() for t in ref.corpus]
    assert len(port.results) == len(ref.results) == len(served.runs) == PARITY_N
    for p, r, off_thread in zip(port.results, ref.results, served.runs):
        assert p.timeline.to_json() == r.timeline.to_json()
        assert_port_is_ref(p, r, served_fault=off_thread)
    # the search met every family and fired faults on both sides
    assert set().union(*(r.timeline.families() for r in port.results)) == set(fz.FAMILIES)
    assert any(served.runs) and sum(r.faults_fired for r in port.results) > 0


def test_smoke_oracles_coverage_and_same_seed_replay():
    c0 = fz.FUZZ_COUNTERS.get_counters()
    s1 = fz.fuzz(SMOKE_N, seed=SMOKE_SEED, budget_s=420.0, device=CPU)
    assert s1.shed == 0 and len(s1.results) == SMOKE_N
    for res in s1.results:
        assert len(res.timeline.families()) >= 3, res.timeline.dumps()
        assert res.ok, (res.failures, res.timeline.dumps())
    hist = s1.coverage_history
    assert hist == sorted(hist) and hist[-1] > hist[2]
    c1 = fz.FUZZ_COUNTERS.get_counters()
    assert c1["chaos.fuzz.runs"] - c0["chaos.fuzz.runs"] == SMOKE_N
    for key in ("chaos.fuzz.mutations", "chaos.fuzz.crossovers",
                "chaos.fuzz.novel_fingerprints"):
        assert c1[key] > c0[key], key
    s2 = fz.fuzz(SMOKE_N, seed=SMOKE_SEED, budget_s=420.0, device=CPU)
    assert [t.to_json() for t in s1.corpus] == [t.to_json() for t in s2.corpus]
    for a, b in zip(s1.results, s2.results):
        assert a.timeline.to_json() == b.timeline.to_json()
        assert a.log.matches(b.log)
        assert a.fingerprint == b.fingerprint
        assert a.counters == b.counters


# a session's run whose armed `spf` fault fires inside a replica's query
# during the fleet burst: the router marks that replica dead and backs it
# off, and whether the burst's later queries reach it decided, by the wall
# clock, whether its mirror was staged on the shared engine
SERVED_FAULT_TIMELINE = {
    "seed": 443996183,
    "version": 2,
    "events": [
        {"family": "kv", "kind": "heal", "params": {}},
        {"family": "ocs", "kind": "swap", "params": {"fresh": [3, 11], "victim": [1, 9]}},
        {"family": "flap", "kind": "chunk", "params": {}},
        {"family": "snapshot", "kind": "restore", "params": {}},
        {"family": "engine", "kind": "arm", "params": {"op": "spf"}},
        {"family": "flap", "kind": "chunk", "params": {}},
        {"family": "fleet", "kind": "burst", "params": {"q": 3}},
        {"family": "fleet", "kind": "flap", "params": {"node": 1}},
        {"family": "engine", "kind": "pallas_mode", "params": {"mode": "interpret"}},
        {"family": "kv", "kind": "partition", "params": {}},
        {"family": "ocs", "kind": "swap", "params": {"fresh": [0, 4], "victim": [10, 2]}},
        {"family": "flap", "kind": "chunk", "params": {}},
        {"family": "engine", "kind": "spf", "params": {"off": 14}},
    ],
}


def test_served_fault_replay_does_not_depend_on_the_wall_clock(monkeypatch):
    """Same timeline, two extremes of host speed: every router backoff
    window still open at the next query (a fast host) and every one
    already expired (a loaded one).  The log, the counters and the
    fingerprint are the same: the world revives a healthy replica after
    each routed query instead of leaving it to the backoff's clock."""
    from openr_tpu_torch.utils.backoff import ExponentialBackoff

    t = fz.FuzzTimeline.from_json(SERVED_FAULT_TIMELINE)
    runs = []
    for expired in (False, True):
        with monkeypatch.context() as m:
            m.setattr(
                ExponentialBackoff, "get_time_remaining_until_retry",
                lambda self, expired=expired: (
                    0.0 if expired or self._current == 0.0 else float("inf")
                ),
            )
            runs.append(fz.run_timeline(t, device=CPU))
    fast, loaded = runs
    assert fast.ok and loaded.ok, (fast.failures, loaded.failures)
    assert fast.faults_fired == loaded.faults_fired >= 1
    assert fast.log.matches(loaded.log)
    assert fast.counters == loaded.counters
    assert fast.fingerprint == loaded.fingerprint


def test_corpus_json_round_trips():
    t = fz.seed_timeline(9)
    assert fz.FuzzTimeline.loads(t.dumps()).to_json() == t.to_json()
    assert t.to_json() == rfz.seed_timeline(9).to_json()
    with pytest.raises(ValueError, match="corpus version"):
        fz.FuzzTimeline.from_json({"version": 99, "seed": 0})


# -- the documented mapping ------------------------------------------------------


def _timeline(mod, *events):
    return mod.FuzzTimeline(seed=5, events=[mod.FuzzEvent(f, k, p) for f, k, p in events])


def test_pallas_fault_arms_the_kernel_gate_only_in_interpret_mode():
    """An armed `pallas` fault stays pending in the world's `off` mode in
    both packages.  In `interpret` mode the port's fires at the first
    kernel (K2 of the blocked event), propagates, is logged and the
    product retried.  The reference's fires at its Pallas gate and
    demotes the round to XLA on a one-device mesh; on the suite's
    8-device CPU mesh its blocked rung keeps XLA and never reaches the
    gate, so the fault stays pending there."""
    off = (("engine", "arm", {"op": "pallas"}), ("engine", "blocked", {}))
    port = fz.run_timeline(_timeline(fz, *off), device=CPU)
    ref = rfz.run_timeline(_timeline(rfz, *off))
    assert port.ok and port.faults_fired == 0
    assert_port_is_ref(port, ref)

    on = (("engine", "pallas_mode", {"mode": "interpret"}), *off)
    port = fz.run_timeline(_timeline(fz, *on), device=CPU)
    ref = rfz.run_timeline(_timeline(rfz, *on))
    assert port.ok and ref.ok and port.faults_fired == 1
    extra = [s for s in port.log.scenario() if s not in ref.log.scenario()]
    assert extra == ["fuzz:fault:fired:fuzz: injected fault at engine:kernel"]
    assert [s for s in port.log.scenario() if s not in extra] == ref.log.scenario()
    p_tokens, r_tokens = mapped(port, PORT_ONLY)[0], mapped(ref, REF_ONLY)[0]
    if ref.faults_fired:
        assert ref.counters["device.engine.pallas_fallbacks"] == 1
        assert p_tokens == r_tokens
    else:
        assert p_tokens - r_tokens == {"fault:pallas"} and r_tokens < p_tokens
    assert port.counters["mesh.blocked.products"] == ref.counters["mesh.blocked.products"] == 1


def test_races_oracle_drains_the_ports_detector_only(monkeypatch):
    from openr_tpu.analysis import race as jrace
    from openr_tpu_torch.analysis import race

    class Detector:
        def __init__(self, findings):
            self.findings = findings

        def drain(self):
            out, self.findings = self.findings, []
            return out

    monkeypatch.setattr(jrace, "TSAN", Detector(["reference finding"]))
    monkeypatch.setattr(race, "TSAN", None)
    t = fz.FuzzTimeline(seed=1, events=[fz.FuzzEvent("engine", "spf", {"off": 0})])
    assert fz.run_timeline(t, device=CPU).ok
    assert jrace.TSAN.findings == ["reference finding"]
    monkeypatch.setattr(race, "TSAN", Detector(["port finding"]))
    res = fz.run_timeline(t, device=CPU)
    assert res.failures == ["races"] and "fuzz:races:1" in res.log.scenario()


# -- the shrinker and the CLI -----------------------------------------------------


def test_planted_bug_found_and_shrunk_end_to_end():
    c0 = fz.FUZZ_COUNTERS.get_counters()
    s = fz.fuzz(6, seed=7, plant=True, stop_on_failure=True, device=CPU)
    assert s.failures and "ledger_kv" in s.failures[0].failures
    bad = s.failures[0]
    mini = fz.shrink(bad.timeline, plant=True, oracle="ledger_kv", device=CPU)
    assert len(mini.events) <= 10 and len(mini.events) < len(bad.timeline.events)
    assert mini.oracle == "ledger_kv"
    c1 = fz.FUZZ_COUNTERS.get_counters()
    assert c1["chaos.fuzz.shrink_steps"] > c0["chaos.fuzz.shrink_steps"]
    assert c1["chaos.fuzz.oracle_failures"] > c0["chaos.fuzz.oracle_failures"]
    armed = fz.run_timeline(mini, plant=True, device=CPU)
    assert not armed.ok and "ledger_kv" in armed.failures
    assert fz.run_timeline(mini, device=CPU).ok
    with pytest.raises(ValueError, match="does not violate"):
        fz.shrink(fz.FuzzTimeline(seed=1, events=[fz.FuzzEvent("engine", "spf", {"off": 0})]),
                  device=CPU)


def test_shrink_preserving_coverage_keeps_the_tokens():
    t = fz.FuzzTimeline.loads(_text(os.path.join(CORPUS_DIR, "coverage_s19_r7.json")))
    tokens = frozenset({"ocs:swap", "flap:down"})
    mini = fz.shrink_preserving_coverage(t, tokens, device=CPU)
    assert len(mini.events) <= len(t.events)
    assert tokens <= fz.run_timeline(mini, device=CPU).fingerprint


def test_cli_fuzz_shrink_and_budget_shed(tmp_path, capsys):
    out = tmp_path / "corpus"
    assert fz.main(["--fuzz-n", "2", "--seed", "11", "--out", str(out), "--device", CPU]) == 0
    rc = fz.main(["--fuzz-n", "2", "--seed", "7", "--plant", "--out", str(out), "--device", CPU])
    assert rc == 1
    entries = sorted(out.glob("*.json"))
    assert entries and all("ledger_kv" in e.name for e in entries)
    assert fz.main(["--shrink", str(entries[0]), "--plant", "--device", CPU]) == 0
    assert (out / (entries[0].name[: -len(".json")] + ".min.json")).exists()
    capsys.readouterr()
    assert fz.main(["--fuzz-n", "50", "--seed", "11", "--budget-s", "0.01",
                    "--device", CPU]) == 0
    err = capsys.readouterr().err
    assert "shedding" in err and "--budget-s" in err


@pytest.mark.slow
def test_long_fuzz_soak_logs_its_seed():
    seed = int(os.environ.get("OPENR_FUZZ_SEED", "0"))
    budget = float(os.environ.get("OPENR_FUZZ_BUDGET_S", "900"))
    print(f"chaos.fuzz soak: seed={seed} budget={budget:.0f}s (reproduce with OPENR_FUZZ_SEED)")
    s = fz.fuzz(200, seed=seed, budget_s=budget, device=CPU)
    for res in s.results:
        assert res.ok, (f"seed={seed}", res.failures, res.timeline.dumps())
    assert s.coverage_history[-1] >= s.coverage_history[0]
