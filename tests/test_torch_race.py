"""The port's OPENR_TSAN happens-before detector
(`openr_tpu_torch.analysis.race`) against the reference's, on the CPU.

Oracle: tests/test_race.py.  Its dynamic scenarios live in
tests/analysis_fixtures/race_dynamic.py, which imports the reference's
RWQueue, so the port's copies are written here, on the port's runtime,
with their own `# RACE-*` marker lines.  Each seeded race is run twice:
the reference's scenario under the reference's detector and the port's
under the port's; the finding's kind, attribute and thread names must
agree, and the port's sites are the marker lines here.  The engine units,
the arming round trip, the two detectors side by side (never armed at
once, each leaving `threading` as it found it; the port's refusing to arm
while the reference's holds the patches), the module import made
while the reference's detector is armed, and the runtime seams (queue
tokens, event-base hand-offs) follow.
"""

from __future__ import annotations

import _thread
import asyncio
import concurrent.futures
import importlib.util
import logging
import sys
import threading
import time
from pathlib import Path

import pytest

from openr_tpu.analysis import race as j_race
from openr_tpu_torch.analysis import race
from openr_tpu_torch.runtime.eventbase import OpenrEventBase
from openr_tpu_torch.runtime.queue import RWQueue

# Every case here arms and disarms detectors; a suite already armed under
# OPENR_TSAN=1 holds the reference's for its whole run, beside which the
# port's refuses to arm.
pytestmark = [
    pytest.mark.analysis,
    pytest.mark.skipif(
        j_race.TSAN is not None,
        reason="the suite runs under OPENR_TSAN=1 with the reference's detector armed",
    ),
]

REPO_ROOT = Path(__file__).resolve().parent.parent
THIS = Path(__file__).resolve()
_LINES = THIS.read_text().splitlines()

_DYN_PATH = REPO_ROOT / "tests" / "analysis_fixtures" / "race_dynamic.py"
_spec = importlib.util.spec_from_file_location("race_dynamic", _DYN_PATH)
race_dynamic = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(race_dynamic)


def _marked_line(marker: str) -> int:
    """1-based line of the unique trailing `# <marker>` comment here."""
    hits = [i for i, line in enumerate(_LINES, 1) if line.rstrip().endswith("# " + marker)]
    assert len(hits) == 1, f"marker {marker} not unique: {hits}"
    return hits[0]


def _site(stack: tuple) -> tuple:
    return stack[0][:2] if stack else ("<unknown>", 0)


# ---------------------------------------------------------------------------
# The seeded scenarios on the port's runtime (race_dynamic.py's shapes)
# ---------------------------------------------------------------------------


class State:
    """Tracked fixture class: plain attribute storage."""

    def __init__(self):
        self.value = 0


def _run(*threads: threading.Thread) -> None:
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def bare_write_race():
    state = State()

    def writer_a():
        state.value = 1  # PORT-RACE-A

    def writer_b():
        state.value = 2  # PORT-RACE-B

    _run(threading.Thread(target=writer_a, name="race-a"),
         threading.Thread(target=writer_b, name="race-b"))


def bare_read_race():
    state = State()
    out = []

    def reader():
        out.append(state.value)  # PORT-RACE-READ

    def writer():
        state.value = 7  # PORT-RACE-WRITE

    _run(threading.Thread(target=reader, name="race-reader"),
         threading.Thread(target=writer, name="race-writer"))


def dedup_double_race():
    s1, s2 = State(), State()

    def writer(tag):
        for obj in (s1, s2):
            obj.value = tag  # PORT-RACE-DEDUP

    _run(threading.Thread(target=writer, args=(1,), name="dedup-a"),
         threading.Thread(target=writer, args=(2,), name="dedup-b"))


def token_missing_race():
    state = State()
    box = []

    def producer():
        state.value = 1  # PORT-RACE-TOKEN-A
        box.append(None)

    t = threading.Thread(target=producer, name="token-producer")
    t.start()
    while not box:
        time.sleep(0.001)
    state.value = 2  # PORT-RACE-TOKEN-B
    t.join()


def queue_handoff_clean():
    state = State()
    q = RWQueue()

    def producer():
        state.value = 1
        q.push("ready")

    def consumer():
        q.get(timeout=10)
        state.value = 2

    _run(threading.Thread(target=producer, name="q-producer"),
         threading.Thread(target=consumer, name="q-consumer"))


def two_hop_relay_clean():
    state = State()
    q1, q2 = RWQueue(), RWQueue()

    def origin():
        state.value = 1
        q1.push("hop")

    def relay():
        q1.get(timeout=10)
        q2.push("hop")

    def sink():
        q2.get(timeout=10)
        state.value = 2

    _run(*[threading.Thread(target=fn, name=f"hop-{fn.__name__}")
           for fn in (origin, relay, sink)])


def lock_protected_clean():
    state = State()
    mu = threading.Lock()

    def flip():
        for _ in range(50):
            with mu:
                state.value += 1

    _run(*[threading.Thread(target=flip, name=f"flip-{i}") for i in range(2)])
    return state


def token_ordered_clean(det):
    state = State()
    box = []

    def producer():
        state.value = 1
        box.append(det.publish_token())

    t = threading.Thread(target=producer, name="token-producer")
    t.start()
    while not box:
        time.sleep(0.001)
    det.acquire_token(box[0])
    state.value = 2
    t.join()


@pytest.fixture
def det():
    """The port's detector, armed for this test with only `State`
    tracked and disarmed after; findings drained on both sides."""
    assert race.TSAN is None and j_race.TSAN is None
    d = race.enable(tracked_paths=[])
    race.track_class(State)
    d.drain()
    try:
        yield d
    finally:
        d.drain()
        race.disable()


def _port_findings(d) -> list:
    return [f for f in d.drain() if f.cls_name == "State"]


def _reference_findings(scenario: str) -> list:
    """race_dynamic's `scenario` under the reference's detector, armed
    only around it (the port's is disarmed)."""
    assert race.TSAN is None and j_race.TSAN is None
    d = j_race.enable(tracked_paths=[])
    try:
        j_race.track_class(race_dynamic.State)
        d.drain()
        getattr(race_dynamic, scenario)()
        return [f for f in d.drain() if f.cls_name == "State"]
    finally:
        j_race.disable()


def _shape(findings) -> list:
    return sorted(
        (f.kind, f.attr, tuple(sorted((f.prior_thread, f.thread)))) for f in findings
    )


SEEDED = {
    "bare_write_race": ("PORT-RACE-A", "PORT-RACE-B"),
    "dedup_double_race": ("PORT-RACE-DEDUP", "PORT-RACE-DEDUP"),
    "token_missing_race": ("PORT-RACE-TOKEN-A", "PORT-RACE-TOKEN-B"),
}


@pytest.mark.parametrize("scenario", sorted(SEEDED))
def test_seeded_race_found_as_the_reference_finds_it(scenario):
    want = _reference_findings(scenario)
    d = race.enable(tracked_paths=[])
    try:
        race.track_class(State)
        d.drain()
        globals()[scenario]()
        got = _port_findings(d)
    finally:
        race.disable()
    assert len(got) == 1 and _shape(got) == _shape(want)
    (f,) = got
    a, b = SEEDED[scenario]
    assert sorted((_site(f.prior_stack), _site(f.stack))) == sorted(
        ((str(THIS), _marked_line(a)), (str(THIS), _marked_line(b)))
    )


def test_bare_read_race_found_as_the_reference_finds_it():
    want = _reference_findings("bare_read_race")
    d = race.enable(tracked_paths=[])
    try:
        race.track_class(State)
        d.drain()
        bare_read_race()
        got = _port_findings(d)
    finally:
        race.disable()
    # which access comes first is the schedule's: the kind is either
    assert len(got) == len(want) == 1
    assert got[0].kind in ("write-read", "read-write") and want[0].kind in (
        "write-read", "read-write")
    assert (got[0].attr, {got[0].prior_thread, got[0].thread}) == (
        want[0].attr, {want[0].prior_thread, want[0].thread}) == (
        "value", {"race-reader", "race-writer"})
    assert sorted((_site(got[0].prior_stack), _site(got[0].stack))) == sorted(
        ((str(THIS), _marked_line("PORT-RACE-READ")),
         (str(THIS), _marked_line("PORT-RACE-WRITE")))
    )


# ---------------------------------------------------------------------------
# Happens-before edges silence the same shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scenario", ["queue_handoff_clean", "two_hop_relay_clean"])
def test_queue_tokens_order_the_writes(det, scenario):
    globals()[scenario]()
    assert _port_findings(det) == []


def test_lock_release_acquire_edges(det):
    state = lock_protected_clean()
    assert _port_findings(det) == []
    assert state.value == 100  # the lock actually locked


def test_publish_acquire_token_orders_writes(det):
    token_ordered_clean(det)
    assert _port_findings(det) == []


def test_armed_push_stores_a_token_per_item(det):
    q = RWQueue(maxlen=2)
    for i in range(3):
        q.push(i)
    # the bounded queue shed its oldest item and its token together
    assert len(q._tsan_tokens) == len(q._items) == 2
    assert q.try_get() == 1 and len(q._tsan_tokens) == 1


class Module(OpenrEventBase):
    """A tracked module (OpenrEventBase is tracked through the MRO)."""


def test_event_base_hand_off_orders_the_callers_write():
    """run_in_event_base_thread and schedule_timeout carry the caller's
    clock onto the loop thread; a closure handed to the loop with no
    seam races the caller's write."""
    d = race.enable()
    m = Module("tsan-module")
    m.run()
    try:
        d.drain()
        m.probe = 1
        m.run_in_event_base_thread(lambda: setattr(m, "probe", 2)).result(10)
        m.probe = 3
        done = concurrent.futures.Future()
        m.schedule_timeout(0.0, lambda: (setattr(m, "probe", 4), done.set_result(None)))
        done.result(10)
        m.probe = 5
        assert [f for f in d.drain() if f.attr == "probe"] == []
        # the same write marshalled by hand, with no seam
        raw = threading.Event()
        m.probe = 6
        m._loop.call_soon_threadsafe(lambda: (setattr(m, "probe", 7), raw.set()))
        raw.wait(10)
        found = [f for f in d.drain() if f.attr == "probe"]
        assert [(f.kind, f.cls_name) for f in found] == [("write-write", "Module")]
    finally:
        m.stop()
        d.drain()
        race.disable()


def test_run_coroutine_orders_the_callers_write():
    d = race.enable()
    m = Module("tsan-coro")
    m.run()
    try:
        d.drain()
        m.probe = 1

        async def body():
            m.probe = 2

        m.run_coroutine(body()).result(10)
        m.probe = 3
        assert [f for f in d.drain() if f.attr == "probe"] == []
    finally:
        m.stop()
        d.drain()
        race.disable()


# ---------------------------------------------------------------------------
# Engine units
# ---------------------------------------------------------------------------


def test_leq_componentwise():
    assert race._leq({}, {})
    assert race._leq({}, {1: 1})
    assert not race._leq({1: 1}, {})
    assert race._leq({1: 1}, {1: 2, 2: 5})
    assert not race._leq({1: 2, 2: 1}, {1: 2})


def _acc(tid, site_line, name="t"):
    return race._Access(tid, {tid: 1}, name, (("f.py", site_line, "fn"),))


def test_report_dedup_is_order_insensitive():
    d = race.RaceDetector()
    a, b = _acc(1, 10), _acc(2, 20)
    d._report("write-write", ("State", "object"), "value", a, b)
    d._report("write-write", ("State", "object"), "value", b, a)
    assert len(d.findings) == 1
    d._report("read-write", ("State", "object"), "other", a, b)
    d._report("write-read", ("State", "object"), "other", b, a)
    assert len(d.findings) == 2


def test_suppression_requires_rationale():
    d = race.RaceDetector()
    with pytest.raises(ValueError):
        d.suppress("State", "value", "  ")
    d.suppress("State", "value", "benign: monotonic latch")
    d._report("write-write", ("State", "object"), "value", _acc(1, 1), _acc(2, 2))
    assert d.findings == []
    assert [(f.cls_name, f.attr, why) for f, why in d.suppressed] == [
        ("State", "value", "benign: monotonic latch")
    ]


def test_suppressions_match_through_the_mro():
    d = race.RaceDetector()
    d.suppress("Base", "value", "benign on the base class")
    d._report("write-write", ("Derived", "Base", "object"), "value", _acc(1, 1), _acc(2, 2))
    assert d.findings == [] and len(d.suppressed) == 1


def test_default_suppressions_are_the_references():
    assert race.DEFAULT_RUNTIME_SUPPRESSIONS == j_race.DEFAULT_RUNTIME_SUPPRESSIONS
    for (cls, attr), why in race.DEFAULT_RUNTIME_SUPPRESSIONS.items():
        assert why.strip(), f"({cls}, {attr}) has no rationale"


def test_format_equals_the_references():
    def fmt(mod):
        d = mod.RaceDetector()
        d._report("write-write", ("State", "object"), "value",
                  mod._Access(1, {1: 1}, "thread-a", (("f.py", 10, "fn"),)),
                  mod._Access(2, {2: 1}, "thread-b", (("f.py", 20, "fn"),)))
        return mod.format_findings(d.drain())

    text = fmt(race)
    assert text == fmt(j_race)
    assert "1 unsuppressed race finding" in text
    assert "write-write race on State.value" in text


def test_stats_count_accesses_objects_and_tokens(det):
    s = State()
    s.value = 1
    s.value = 2
    tok = det.publish_token()
    det.acquire_token(tok)
    st = det.stats()
    assert (st["accesses"], st["watched_objects"]) >= (2, 1)
    assert st["tokens"] >= 1 and st["findings"] == 0


def test_reads_off_keeps_write_tracking(monkeypatch):
    monkeypatch.setenv("OPENR_TSAN_READS", "0")
    d = race.enable(tracked_paths=[])
    try:
        assert d.track_reads is False
        race.track_class(State)
        d.drain()
        bare_write_race()
        assert [f.kind for f in _port_findings(d)] == ["write-write"]
        bare_read_race()
        assert _port_findings(d) == []
    finally:
        race.disable()


# ---------------------------------------------------------------------------
# Arming: zero cost when off, reversible when on, never beside the
# reference's
# ---------------------------------------------------------------------------


def _threading_state() -> tuple:
    fut = concurrent.futures.Future
    return (
        threading.Lock, threading.RLock, threading.Thread.start, threading.Thread.join,
        fut.set_result, fut.set_exception, fut.result, fut.exception,
        concurrent.futures.ThreadPoolExecutor.submit,
    )


def test_unarmed_runtime_is_untouched():
    assert race.TSAN is None
    assert threading.Lock is _thread.allocate_lock
    assert "__setattr__" not in OpenrEventBase.__dict__
    assert "__getattribute__" not in OpenrEventBase.__dict__
    q = RWQueue()
    assert q.push(1)
    assert q._tsan_tokens is None  # push never allocated the token deque
    assert q.get(timeout=1) == 1


def test_enable_disable_round_trips():
    before = _threading_state()
    race.enable()
    try:
        assert race.TSAN is not None
        assert threading.Lock is race.TsanLock
        assert threading.RLock is race.TsanRLock
        assert "__setattr__" in OpenrEventBase.__dict__
        assert all(a is not b for a, b in zip(before[2:], _threading_state()[2:]))
    finally:
        race.disable()
    assert race.TSAN is None
    assert _threading_state() == before
    assert "__setattr__" not in OpenrEventBase.__dict__


def test_the_two_detectors_each_leave_threading_as_found():
    before = _threading_state()
    race.enable(tracked_paths=[])
    try:
        assert j_race.TSAN is None
        assert threading.Lock is race.TsanLock
    finally:
        race.disable()
    assert _threading_state() == before
    j_race.enable(tracked_paths=[])
    try:
        assert race.TSAN is None
        assert threading.Lock is j_race.TsanLock
    finally:
        j_race.disable()
    assert _threading_state() == before


def test_the_port_refuses_to_arm_beside_the_references_detector(monkeypatch, caplog):
    """While the reference's detector holds `threading`'s patches,
    `enable` raises and `maybe_enable` (the daemon's gate) logs an error,
    both leaving `threading` and the reference's detector as they were."""
    before = _threading_state()
    j_race.enable(tracked_paths=[])
    try:
        armed = _threading_state()
        assert race.foreign_patches()
        with pytest.raises(RuntimeError, match="another race detector"):
            race.enable(tracked_paths=[])
        monkeypatch.setattr(race, "_ENV_ARMED", True)
        with caplog.at_level(logging.ERROR, logger=race.__name__):
            assert race.maybe_enable() is None
        assert any("stays off" in r.getMessage() for r in caplog.records)
        assert race.TSAN is None and j_race.TSAN is not None
        assert _threading_state() == armed and threading.Lock is j_race.TsanLock
    finally:
        j_race.disable()
    assert _threading_state() == before and race.foreign_patches() == []


def test_module_loaded_under_the_references_detector_holds_real_locks():
    """The reference captures `threading.Lock` at import; the port takes
    its primitives from `_thread`, so a copy of the module executed while
    the reference's detector has `threading.Lock` patched still holds
    real locks, and its own proxies wrap real ones."""
    spec = importlib.util.spec_from_file_location("port_race_copy", race.__file__)
    copy = importlib.util.module_from_spec(spec)
    j_race.enable(tracked_paths=[])
    sys.modules[spec.name] = copy
    try:
        assert threading.Lock is j_race.TsanLock
        spec.loader.exec_module(copy)
    finally:
        j_race.disable()
        del sys.modules[spec.name]
    assert copy._REAL_LOCK is _thread.allocate_lock
    assert copy._REAL_RLOCK is _thread.RLock
    inner = copy.TsanLock()._tsan_inner
    assert type(inner) is type(_thread.allocate_lock())
    assert type(copy.TsanRLock()._tsan_inner) is _thread.RLock


def test_tracked_classes_resolve_to_the_ports():
    paths = race._config_tracked_paths()
    assert paths == race.DEFAULT_TRACKED_PATHS
    classes = race._resolve_tracked(paths)
    assert [c.__module__ for c in classes] == [
        "openr_tpu_torch.runtime.eventbase",
        "openr_tpu_torch.serving.router",
        "openr_tpu_torch.serving.router",
    ]


def test_maybe_enable_is_gated_by_the_environment(monkeypatch):
    monkeypatch.setattr(race, "_ENV_ARMED", False)
    assert race.maybe_enable() is None and race.TSAN is None
    monkeypatch.setattr(race, "_ENV_ARMED", True)
    try:
        d = race.maybe_enable()
        assert d is not None and race.TSAN is d and race.maybe_enable() is d
    finally:
        race.disable()


def test_tsan_rlock_serves_a_condition(det):
    cond = threading.Condition()
    assert isinstance(cond._lock, race.TsanRLock)
    box = []

    def waiter():
        with cond:
            cond.wait_for(lambda: box, timeout=10)

    t = threading.Thread(target=waiter, name="cond-waiter")
    t.start()
    with cond:
        box.append(1)
        cond.notify_all()
    t.join(10)
    assert not t.is_alive()


def test_async_queue_get_joins_the_put_token(det):
    state = State()
    q = RWQueue()

    def producer():
        state.value = 1
        q.push("ready")

    async def consume():
        await q.aget()
        state.value = 2

    t = threading.Thread(target=producer, name="aq-producer")
    t.start()
    asyncio.run(consume())
    t.join()
    assert _port_findings(det) == []


# ---------------------------------------------------------------------------
# F9: the router's replica list read outside its lock (a detector finding)
# ---------------------------------------------------------------------------


class _Replica:
    """A replica handle answering every query at epoch 1."""

    def __init__(self, name, result_cls):
        self.name = name
        self._result_cls = result_cls

    def submit(self, op, **kw):
        fut = concurrent.futures.Future()
        fut.set_result(self._result_cls(value={}, latency_us=1, batch_size=1, epoch=1))
        return fut

    def epoch(self, area="0"):
        return 1

    def get_counters(self):
        return {}


def _scale_under_load(serving, det_mod) -> list:
    """A load thread, started before the scale-out, is told by a plain
    list (no happens-before edge) to submit once the main thread has
    added a replica: only the lock `submit` takes can order its read of
    the replica list after the swap.  Returns the findings on it."""
    d = det_mod.enable()
    router = None
    try:
        router = serving.ReplicaRouter(
            [_Replica("r0", serving.QueryResult)], hedge_after_s=None)
        go, done = [], []

        def load():
            while not go:
                time.sleep(0.001)
            done.append(router.submit("paths", sources=("a",)).result(10))

        t = threading.Thread(target=load, name="f9-load")
        t.start()
        d.drain()
        router.add_replica(_Replica("r1", serving.QueryResult))
        go.append(1)
        while not done:
            time.sleep(0.001)
        found = [f for f in d.drain() if f.attr == "_replicas"]
        t.join()
        return found
    finally:
        if router is not None:
            router.stop()
        det_mod.disable()


def test_router_reads_its_replica_list_under_its_lock():
    """F9: the reference's `submit` reads `_replicas` bare, unordered
    against `add_replica`'s swap under the lock.  The list is swapped
    whole, so the bare read is atomic and benign, but the detector
    reports it; the port's takes the lock, so its read is ordered after
    the swap and the detector reports nothing."""
    import openr_tpu.serving as j_serving
    import openr_tpu_torch.serving as serving

    ref = _scale_under_load(j_serving, j_race)
    assert [(f.kind, f.cls_name, f.thread) for f in ref] == [
        ("write-read", "ReplicaRouter", "f9-load")]
    assert _scale_under_load(serving, race) == []
