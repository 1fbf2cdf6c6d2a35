"""The port's query-serving layer (openr_tpu_torch.serving) against
`openr_tpu.serving`, on the CPU.

Both packages' QueryScheduler + EngineBatchBackend run over LinkStates
built from the same databases (tests/torch_parity.py): tests/
test_serving.py's `square()` and a 3-node chain with a chord.  Every
coalesced answer equals the serial one and the reference's (routes are
integers: no tolerance); the pipeline's mechanics (double buffer,
explicit shedding, invalidation and retry, no retry of
`optimize_metrics`, shutdown) give the same outcomes in both.  The one
deliberate difference: the port has no host rung, so an engine failure
that is not an epoch refusal reaches the caller (`serving.errors` 1,
`serving.host_fallbacks` 0) where the reference answers from its host
Dijkstra.  Coalescing is made deterministic by parking the pipeline
(one batch held inside the executor, one in the staging slot, one in
the coalescer's blocked put), so everything submitted afterwards rides
one batch.
"""

from __future__ import annotations

import threading
import time

import pytest

from openr_tpu.decision.spf_solver import DeviceSpfBackend as JDeviceSpfBackend
from openr_tpu.device.engine import EpochMismatchError as JEpochMismatchError
from openr_tpu.serving import SERVING_COUNTER_KEYS as J_SERVING_COUNTER_KEYS
from openr_tpu.serving import EngineBatchBackend as JEngineBatchBackend
from openr_tpu.serving import QueryScheduler as JQueryScheduler
from openr_tpu.serving import QueryShedError as JQueryShedError
from openr_tpu.te import TE_COUNTER_KEYS as J_TE_COUNTER_KEYS
from openr_tpu_torch import types as pt
from openr_tpu_torch.decision.decision import Decision
from openr_tpu_torch.device.engine import EpochMismatchError
from openr_tpu_torch.runtime.queue import ReplicateQueue
from openr_tpu_torch.serializer import dumps
from openr_tpu_torch.serving import (
    SERVING_COUNTER_KEYS,
    DecisionBatchBackend,
    EngineBatchBackend,
    QueryScheduler,
    QueryShedError,
)
from openr_tpu_torch.te import TE_COUNTER_KEYS
from torch_parity import LinkStatePair, adj, adj_dbs, spf_key, square_dbs

# the reference's device path on tiny topologies (its default sends
# them to the host Dijkstra)
_J_DEVICE = dict(min_device_nodes=1, min_device_sources=1)

PACKAGES = {
    "port": (
        lambda ls: EngineBatchBackend({"0": ls}, device="cpu"),
        QueryScheduler, QueryShedError, EpochMismatchError,
    ),
    "reference": (
        lambda ls: JEngineBatchBackend(
            {"0": ls}, spf_backend=JDeviceSpfBackend(**_J_DEVICE)
        ),
        JQueryScheduler, JQueryShedError, JEpochMismatchError,
    ),
}


def chord_dbs():
    """1-2-3 (10 + 10) plus a 50-metric 1-3 chord: k = 2 from 1 has a
    real second path."""
    return adj_dbs(
        {
            "1": [adj("1", "2"), adj("1", "3", metric=50)],
            "2": [adj("2", "1"), adj("2", "3")],
            "3": [adj("3", "2"), adj("3", "1", metric=50)],
        }
    )


def wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


class _Gate:
    """trace_hook that records the pipeline's events and holds every
    execute until released."""

    def __init__(self) -> None:
        self.events: list[tuple[str, int, int]] = []
        self.release = threading.Event()
        self._lock = threading.Lock()
        self.on_execute = None

    def __call__(self, event: str, batch) -> None:
        with self._lock:
            self.events.append((event, id(batch), len(batch.pendings)))
        if event == "execute_begin":
            self.release.wait(15)
            if self.on_execute is not None:
                self.on_execute(batch)

    def count(self, event: str) -> int:
        with self._lock:
            return sum(1 for e in self.events if e[0] == event)


def park_pipeline(sched, gate):
    """Fill the double buffer: batch 1 held in the executor, batch 2 in
    the staging slot, batch 3 in the coalescer's blocked put."""
    warm = [sched.submit("paths", sources=("1",))]
    assert wait_for(lambda: gate.count("execute_begin") == 1)
    warm.append(sched.submit("paths", sources=("1",)))
    assert wait_for(lambda: gate.count("stage") == 2)
    warm.append(sched.submit("paths", sources=("1",)))
    assert wait_for(lambda: gate.count("stage") == 3)
    return warm


class Side:
    """One package's LinkState, backend and running scheduler."""

    def __init__(self, package: str, ls, **kwargs) -> None:
        make_backend, sched_cls, self.shed_error, self.epoch_error = PACKAGES[package]
        self.ls = ls
        self.backend = make_backend(ls)
        self.serial = make_backend(ls)
        self.sched = sched_cls(self.backend, **kwargs)
        self.gate = _Gate()
        self.sched.trace_hook = self.gate
        self.sched.run()

    def close(self) -> None:
        self.gate.release.set()
        self.sched.stop()


@pytest.fixture
def sides():
    made = []

    def make(dbs=None, **kwargs):
        pair = LinkStatePair(dbs or square_dbs())
        made.extend(
            [Side("port", pair.ls, **kwargs), Side("reference", pair.jls, **kwargs)]
        )
        return made[-2], made[-1], pair

    yield make
    for side in made:
        side.close()


def paths_view(result) -> dict:
    return {s: spf_key(r) for s, r in result.items()}


def ksp_view(result) -> dict:
    return {d: [[l.ordered_names for l in p] for p in paths] for d, paths in result.items()}


def test_paths_coalesced_equal_serial_and_reference(sides):
    port, ref, pair = sides()
    answers = {}
    for side in (port, ref):
        warm = park_pipeline(side.sched, side.gate)
        futs = {s: side.sched.submit("paths", sources=(s,)) for s in "1234"}
        side.gate.release.set()
        results = {s: f.result(20) for s, f in futs.items()}
        for f in warm:
            f.result(20)
        assert {r.batch_size for r in results.values()} == {4}
        assert {r.epoch for r in results.values()} == {int(side.ls.version)}
        got = {s: paths_view(r.value) for s, r in results.items()}
        for s in "1234":
            serial = side.serial.run_paths("0", [s], expect_epoch=int(side.ls.version))
            assert got[s] == paths_view({s: serial[s]})
            assert got[s][s] == spf_key(side.ls.get_spf_result(s))
        counters = side.sched.get_counters()
        assert counters["serving.replies"] == 7
        assert counters["serving.coalesced"] >= 3
        assert counters["serving.batch_occupancy"] > 1000
        assert counters["serving.p99_us"] >= counters["serving.p50_us"]
        answers[side] = got
    assert answers[port] == answers[ref]


def test_what_if_coalesced_equal_serial_and_reference(sides):
    port, ref, _ = sides()
    answers = []
    for side in (port, ref):
        warm = park_pipeline(side.sched, side.gate)
        fa = side.sched.submit("what_if", sources=("1",), scenarios=((("1", "2"),),))
        fb = side.sched.submit(
            "what_if", sources=("1",), scenarios=((("3", "4"),), (("2", "4"),))
        )
        side.gate.release.set()
        ra, rb = fa.result(20), fb.result(20)
        for f in warm:
            f.result(20)
        assert ra.batch_size == rb.batch_size == 2
        epoch = int(side.ls.version)
        assert ra.value == side.serial.run_what_if("0", ["1"], [[("1", "2")]], expect_epoch=epoch)
        assert rb.value == side.serial.run_what_if(
            "0", ["1"], [[("3", "4")], [("2", "4")]], expect_epoch=epoch
        )
        assert [row["scenario"] for row in rb.value] == [0, 1]
        answers.append((ra.value, rb.value))
    assert answers[0] == answers[1]


def test_ksp_coalesced_equal_serial_and_reference(sides):
    port, ref, _ = sides(chord_dbs())
    answers = []
    for side in (port, ref):
        warm = park_pipeline(side.sched, side.gate)
        fa = side.sched.submit("ksp", sources=("1",), dests=("3",), k=2)
        fb = side.sched.submit("ksp", sources=("1",), dests=("2", "3"), k=2)
        side.gate.release.set()
        ra, rb = fa.result(20), fb.result(20)
        for f in warm:
            f.result(20)
        assert ra.batch_size == rb.batch_size == 2
        epoch = int(side.ls.version)
        assert ksp_view(ra.value) == ksp_view(side.serial.run_ksp("0", "1", ["3"], k=2, expect_epoch=epoch))
        assert ksp_view(rb.value) == ksp_view(
            side.serial.run_ksp("0", "1", ["2", "3"], k=2, expect_epoch=epoch)
        )
        # the k = 2 (edge-disjoint) tier is exactly the 1-3 chord
        assert ksp_view(ra.value) == {"3": [[(("1", "1/3"), ("3", "3/1"))]]}
        answers.append((ksp_view(ra.value), ksp_view(rb.value)))
    assert answers[0] == answers[1]


def test_optimize_metrics_coalesced_equal_reference(sides):
    port, ref, _ = sides()
    demand = (("1", "3", 4.0), ("2", "3", 2.0))
    answers = []
    for side in (port, ref):
        warm = park_pipeline(side.sched, side.gate)
        futs = [
            side.sched.submit("optimize_metrics", demand=demand, bounds=(1, 16), steps=24)
            for _ in range(2)
        ]
        side.gate.release.set()
        results = [f.result(60) for f in futs]
        for f in warm:
            f.result(20)
        # identical requests share one descent run and one answer
        assert [r.batch_size for r in results] == [2, 2]
        assert results[0].value == results[1].value
        assert results[0].epoch == int(side.ls.version)
        for u, v, m in results[0].value["proposedMetrics"]:
            assert isinstance(m, int) and 1 <= m <= 16
        te = side.backend.te.get_counters()
        assert (te["te.runs"], te["te.steps"]) == (1, 24)
        answers.append(results[0].value)
    assert answers[0] == answers[1]


def test_double_buffer_overlaps_stage_with_execute(sides):
    for side in sides()[:2]:
        warm = park_pipeline(side.sched, side.gate)
        side.gate.release.set()
        for f in warm:
            f.result(20)
        events = [e[0] for e in side.gate.events]
        # batch 2 was staged while batch 1 was still executing
        second_stage = [i for i, e in enumerate(events) if e == "stage"][1]
        assert second_stage < events.index("execute_end"), events


def test_admission_overflow_sheds_oldest_explicitly(sides):
    outcomes = []
    for side in sides(max_pending=4)[:2]:
        warm = park_pipeline(side.sched, side.gate)
        futs = [side.sched.submit("paths", sources=("1",)) for _ in range(12)]
        side.gate.release.set()
        replied = shed = 0
        for f in futs + warm:
            try:
                f.result(20)
                replied += 1
            except side.shed_error:
                shed += 1
        counters = side.sched.get_counters()
        outcomes.append(
            (
                shed, replied, [f.done() for f in futs + warm],
                counters["serving.admitted"], counters["serving.shed"],
                counters["serving.replies"], side.sched.admission.stats()["overflows"],
            )
        )
    assert outcomes[0] == outcomes[1] == (8, 7, [True] * 15, 15, 8, 7, 8)


def test_flap_invalidates_undispatched_batch_and_retries_fresh(sides):
    port, ref, pair = sides()
    warm = {side: park_pipeline(side.sched, side.gate) for side in (port, ref)}
    before = int(port.ls.version)
    # removing the 2-4 link moves the topology under every parked batch
    pair.update(adj_dbs({"2": [adj("2", "1")]}, labels={"2": 102})[0])
    assert int(port.ls.version) != before
    answers = []
    for side in (port, ref):
        side.gate.release.set()
        results = [f.result(20) for f in warm[side]]
        # dispatch saw the mismatch, re-pinned and recomputed fresh
        assert side.sched.get_counters()["serving.invalidations"] >= 1
        oracle = side.ls.get_spf_result("1")
        for r in results:
            assert r.epoch == int(side.ls.version)
            assert r.value["1"]["4"].next_hops == oracle["4"].next_hops == {"3"}
        answers.append([paths_view(r.value) for r in results])
    assert answers[0] == answers[1]


def test_optimize_metrics_is_never_retried(sides):
    port, ref, pair = sides()
    down = adj_dbs({"2": [adj("2", "1")]}, labels={"2": 102})[0]
    up = next(db for db in square_dbs() if db.this_node_name == "2")
    for side, db in ((port, down), (ref, up)):
        def flap(batch, db=db):
            if batch.op == "optimize_metrics":
                pair.update(db)  # lands after coalescing pinned the epoch

        side.gate.on_execute = flap
        side.gate.release.set()
        fut = side.sched.submit(
            "optimize_metrics", demand=(("1", "3", 4.0),), bounds=(1, 16), steps=8
        )
        with pytest.raises(side.epoch_error):
            fut.result(60)
        counters = side.sched.get_counters()
        assert (
            counters["serving.invalidations"],
            counters["serving.errors"],
            counters["serving.replies"],
        ) == (1, 1, 0)
        # the backend refused the moved epoch before any descent
        assert side.backend.te.get_counters()["te.runs"] == 0


def test_shutdown_resolves_every_future(sides):
    for side in sides()[:2]:
        side.gate.release.set()
        futs = [side.sched.submit("paths", sources=(s,)) for s in "1234" * 8]
        side.sched.stop()
        assert all(f.done() for f in futs)
        replied = shed = 0
        for f in futs:
            try:
                f.result(0)
                replied += 1
            except side.shed_error:
                shed += 1
        assert replied + shed == len(futs)
        counters = side.sched.get_counters()
        assert (counters["serving.replies"], counters["serving.shed"]) == (replied, shed)


@pytest.mark.parametrize(
    "port_keys, ref_keys",
    [(SERVING_COUNTER_KEYS, J_SERVING_COUNTER_KEYS), (TE_COUNTER_KEYS, J_TE_COUNTER_KEYS)],
    ids=["serving", "te"],
)
def test_counter_keys_equal_reference(port_keys, ref_keys):
    assert port_keys == ref_keys


def test_engine_failure_reaches_the_caller_without_host_rung(sides):
    """The deliberate difference from the reference's overload scenario:
    a non-epoch engine failure is an error reply, never a host answer."""
    port, _, _ = sides()
    port.gate.release.set()

    def fail(*args, **kwargs):
        raise RuntimeError("injected device fault")

    port.backend.spf.engine.spf_results = fail
    fut = port.sched.submit("paths", sources=("1",))
    with pytest.raises(RuntimeError, match="injected device fault"):
        fut.result(20)
    counters = port.sched.get_counters()
    assert counters["serving.errors"] == 1
    assert counters["serving.host_fallbacks"] == 0
    assert counters["serving.replies"] == 0


def test_entry_points_default_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pair = LinkStatePair(square_dbs())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EngineBatchBackend({"0": pair.ls})


def _square_publication() -> pt.Publication:
    kv = {
        pt.adj_key(db.this_node_name): pt.Value(
            version=1, originator_id=db.this_node_name, value=dumps(db)
        )
        for db in square_dbs()
    }
    return pt.Publication(key_vals=kv, area="0")


def test_decision_backend_equals_engine_backend_and_defers():
    kvq, routeq = ReplicateQueue(), ReplicateQueue()
    updates = routeq.get_reader()
    decision = Decision(
        "1", kvq.get_reader(), None, routeq, device="cpu",
        debounce_min_s=0.005, debounce_max_s=0.02,
    )
    decision.run()
    hints = iter([1, 1, 1])
    sched = QueryScheduler(
        DecisionBatchBackend(decision), defer_hint=lambda: next(hints, 0)
    )
    engine_side = Side("port", LinkStatePair(square_dbs()).ls)
    engine_side.gate.release.set()
    try:
        kvq.push(_square_publication())
        updates.get(timeout=10)
        sched.run()
        queries = [("paths", dict(sources=(s,))) for s in "1234"] + [
            ("what_if", dict(sources=("1",), scenarios=((("1", "2"),), (("3", "4"),)))),
            ("ksp", dict(sources=("1",), dests=("4",), k=2)),
        ]
        got = [sched.submit(op, **kw) for op, kw in queries]
        want = [engine_side.sched.submit(op, **kw) for op, kw in queries]
        views = {"paths": paths_view, "what_if": lambda v: v, "ksp": ksp_view}
        for (op, _), g, w in zip(queries, got, want):
            assert views[op](g.result(20).value) == views[op](w.result(20).value)
        counters = sched.get_counters()
        assert counters["serving.deferrals"] == 1
        assert counters["serving.errors"] == 0
        assert counters["serving.replies"] == len(queries)
        assert decision.pending_event_hint() == 0
    finally:
        sched.stop()
        engine_side.close()
        kvq.close()
        routeq.close()
        decision.stop()
