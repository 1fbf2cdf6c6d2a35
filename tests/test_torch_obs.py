"""The port's tracer and histogram (`openr_tpu_torch.obs`) and the queue
and event-base scope carry against `openr_tpu.obs`, on the CPU.

Oracle: tests/test_obs.py, every class but TestSpanStructureDeterminism
(it needs the chaos package, which the port does not have yet).  Each
scenario runs once per package on that package's own tracer, queues and
event base, and returns what it observed as plain data: span
structures, counters, dump shapes, scope identities.  The two records
must be equal.  Everything compared is a string or an integer: no
tolerance.  Times are compared only by shape (a key present, an offset
not negative).

Both packages keep their own `TRACE` global; the `tracers` fixture arms
both for one test and disarms both in `finally`, so no later test of the
file runs traced.
"""

from __future__ import annotations

import ast
import asyncio
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import pytest

from openr_tpu import obs as jobs
from openr_tpu.obs import trace as jtrace
from openr_tpu.runtime import eventbase as jeventbase
from openr_tpu.runtime import queue as jqueue
from openr_tpu_torch import obs as pobs
from openr_tpu_torch.obs import trace as ptrace
from openr_tpu_torch.runtime import eventbase as peventbase
from openr_tpu_torch.runtime import queue as pqueue

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "port": SimpleNamespace(obs=pobs, trace=ptrace, queue=pqueue, evb=peventbase),
    "reference": SimpleNamespace(obs=jobs, trace=jtrace, queue=jqueue, evb=jeventbase),
}


@pytest.fixture
def tracers():
    """Both packages' tracers armed for one test, both disarmed after."""
    try:
        yield {name: p.trace.enable() for name, p in PKGS.items()}
    finally:
        for p in PKGS.values():
            p.trace.disable()


def each(scenario, *args) -> dict:
    """`scenario(pkg, *args)` once per package: {package: record}."""
    return {name: scenario(p, *args) for name, p in PKGS.items()}


def same(records: dict):
    assert records["port"] == records["reference"], records
    return records["port"]


def shape(d):
    """A dump's structure without its times: keys, names, tags, notes'
    keys, children in order."""
    if isinstance(d, dict):
        return {
            k: (sorted(v) if k == "notes" else shape(v))
            for k, v in d.items()
            if k not in ("t_offset_us", "duration_us", "max_us")
        }
    if isinstance(d, list):
        return [shape(x) for x in d]
    return d


# -- the histogram -------------------------------------------------------------------


def hist_bounds(p):
    h = p.obs.Histogram()
    out = []
    for v in (1, 3, 100, 1000, 100_000):
        h.record_us(v)
        got = h.percentile_us(100.0)
        assert v <= got < 2 * v, (v, got)
        out.append(got)
    return out


def hist_monotone(p):
    h = p.obs.Histogram()
    for i in range(1000):
        h.record_us(i + 1)
    got = [h.percentile_us(q) for q in (50, 99, 99.9)]
    assert 0 < got[0] <= got[1] <= got[2]
    return got


def hist_empty_and_zero(p):
    h = p.obs.Histogram()
    empty = h.percentile_us(99)
    h.record_us(0)
    return empty, h.percentile_us(99), h.snapshot()


def hist_merge(p):
    a, b = p.obs.Histogram(), p.obs.Histogram()
    a.record_us(10)
    b.record_us(10)
    b.record_us(100_000)
    a.merge(b)
    counts, n = a.snapshot()
    assert sum(counts) == n == 3
    assert a.percentile_us(99) >= 100_000
    # the merged-from histogram is left as it was
    return counts, n, b.snapshot()


def hist_export(p):
    h = p.obs.Histogram()
    for v in (100, 200, 3000):
        h.record_us(v)
    counters: dict = {}
    p.obs.export_histogram(counters, "fam", h)
    assert counters["fam.hist_us.count"] == 3
    assert sum(v for k, v in counters.items() if ".hist_us.b" in k) == 3
    return counters


@pytest.mark.parametrize(
    "scenario",
    [hist_bounds, hist_monotone, hist_empty_and_zero, hist_merge, hist_export],
    ids=lambda f: f.__name__,
)
def test_histogram_as_the_reference(scenario):
    same(each(scenario))


# -- arming discipline -----------------------------------------------------------


def test_unarmed_by_default_and_queues_allocate_nothing():
    assert ptrace.TRACE is None
    q = pqueue.RWQueue()
    q.push(1)
    assert q.get() == 1
    assert q._obs_tokens is None
    rq = pqueue.ReplicateQueue()
    reader = rq.get_reader()
    rq.push("x")
    assert reader.get(timeout=1) == "x"
    assert reader._impl._obs_tokens is None


def test_enable_disable_round_trip():
    assert ptrace.TRACE is None
    tr = ptrace.enable(sample_every=2, ring=8)
    try:
        assert ptrace.TRACE is tr
        assert (tr.sample_every, tr._ring.maxlen) == (2, 8)
    finally:
        ptrace.disable()
    assert ptrace.TRACE is None


@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"OPENR_TRACE": "0"}, None),
    ({"OPENR_TRACE": "1"}, (1, 256)),
    ({"OPENR_TRACE": "1", "OPENR_TRACE_SAMPLE": "3", "OPENR_TRACE_RING": "5"}, (3, 5)),
])
def test_maybe_enable_reads_the_environment_as_the_reference(monkeypatch, env, want):
    for key in ("OPENR_TRACE", "OPENR_TRACE_SAMPLE", "OPENR_TRACE_RING"):
        monkeypatch.delenv(key, raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    got = {}
    try:
        for name, p in PKGS.items():
            tr = p.trace.maybe_enable()
            got[name] = None if tr is None else (tr.sample_every, tr._ring.maxlen)
            # armed already: the same tracer again
            assert p.trace.maybe_enable() is tr
    finally:
        for p in PKGS.values():
            p.trace.disable()
    assert got["port"] == got["reference"] == want


def test_openr_trace_arms_at_import():
    """OPENR_TRACE=1 in the environment arms the tracer when the module is
    first imported, as the daemon process relies on."""
    probe = (
        "import openr_tpu_torch.obs.trace as t; "
        "print(t.TRACE is not None, t.TRACE.sample_every)"
    )
    env = {**os.environ, "OPENR_TRACE": "1", "OPENR_TRACE_SAMPLE": "4"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "4"]


def test_maybe_child_unarmed_is_shared_noop():
    assert ptrace.maybe_child("x") is ptrace.maybe_child("y")


def test_obs_stats_unarmed_answers_the_references_zeroed_shape():
    stats, jstats = pobs.ObsStats(), jobs.ObsStats()
    assert pobs.OBS_COUNTER_KEYS == jobs.OBS_COUNTER_KEYS
    assert stats.get_counters() == jstats.get_counters() == {
        k: 0 for k in pobs.OBS_COUNTER_KEYS
    }
    assert stats.dump_traces() == jstats.dump_traces() == []
    assert stats.span_samples() == jstats.span_samples() == []


def test_unarmed_handoff_installs_no_wrapper(tracers):
    def fn():
        return None

    ptrace.disable()
    assert peventbase._obs_handoff(fn) is fn
    tr = ptrace.enable()
    # armed but with no active scope: still no wrapper
    assert peventbase._obs_handoff(fn) is fn
    root = tr.root("r")
    with tr.activate((root,)):
        assert peventbase._obs_handoff(fn) is not fn


def _seam_files():
    base = os.path.join(ROOT, "openr_tpu_torch")
    for dirpath, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_every_seam_reads_the_tracer_late_bound():
    """No module of the port binds TRACE at import (`from ..obs.trace
    import TRACE` would freeze the unarmed None); every seam module
    imports the trace module as `_trace`."""
    seams = []
    for path in _seam_files():
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                names = {a.name for a in node.names}
                assert "TRACE" not in names, path
                if node.module == "obs" and "trace" in names:
                    assert [a.asname for a in node.names if a.name == "trace"] == ["_trace"]
                    seams.append(os.path.relpath(path, ROOT))
    assert sorted(seams) == sorted([
        "openr_tpu_torch/runtime/queue.py",
        "openr_tpu_torch/runtime/eventbase.py",
        "openr_tpu_torch/kvstore/kvstore.py",
        "openr_tpu_torch/spark/spark.py",
        "openr_tpu_torch/decision/decision.py",
        "openr_tpu_torch/fib/fib.py",
        "openr_tpu_torch/device/engine.py",
        "openr_tpu_torch/parallel/blocked.py",
        "openr_tpu_torch/serving/scheduler.py",
        "openr_tpu_torch/serving/router.py",
        "openr_tpu_torch/snapshot/snapshot.py",
        # the fuzzer drains span-structure tokens for its fingerprint
        "openr_tpu_torch/chaos/fuzz.py",
    ])


def test_trace_module_imports_the_standard_library_only():
    tree = ast.parse(open(os.path.join(ROOT, "openr_tpu_torch/obs/trace.py")).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, node.module
            roots.add(node.module.split(".")[0])
    assert roots <= set(sys.stdlib_module_names), roots


# -- the tracer's units ------------------------------------------------------------


def sampling(p):
    tr = p.trace.enable(sample_every=3)
    roots = [tr.root("r") for _ in range(9)]
    kept = [i for i, r in enumerate(roots) if r is not None]
    assert kept == [0, 3, 6]
    return kept, tr.get_counters()


def ring_eviction(p):
    tr = p.trace.enable(ring=4)
    for i in range(7):
        tr.finish(tr.root("r", i=i))
    dumped = tr.dump(100)
    assert len(dumped) == 4
    return [d["tags"] for d in dumped], tr.get_counters()


def structure_order(p):
    def build(order):
        root = p.trace.Span("root")
        root.tags["outcome"] = "ok"
        for name in order:
            kid = p.trace.Span(name, parent=root)
            kid.notes["t"] = time.time()  # not structural
            kid.tags["k"] = name
            root.children.append(kid)
        return root.structure()

    assert build(["a", "b", "c"]) == build(["c", "a", "b"])
    assert "t=" not in build(["a"])
    return build(["b", "a"])


def root_extends(p, tr):
    outer = tr.root("router.query", op="paths")
    with tr.activate((outer,)):
        inner = tr.root("serving.query", op="paths")
    assert inner.parent is outer and outer.children == [inner]
    tr.finish(outer)
    return outer.structure(), tr.get_counters()


def fan_in(p, tr):
    a, b = tr.root("a"), tr.root("b")
    with tr.activate((a, b)):
        tr.annotate("engine.rung", "delta")
        tr.event("epoch_retry")
        tr.note("size", 3)
        with tr.child("stage", x=1):
            tr.annotate("inner", True)
    for sp in (a, b):
        tr.finish(sp)
    return [sp.structure() for sp in (a, b)], shape(tr.dump()), tr.get_counters()


def stage_bounds(p, tr):
    root = tr.root("q")
    kid = tr.stage(root, "admission", root.t_start_us + 5, root.t_start_us + 9, k=1)
    tr.finish(root)
    d = tr.dump(1)[0]
    assert d["children"][0]["t_offset_us"] == 5 and d["children"][0]["duration_us"] == 4
    assert kid.parent is root
    return shape(d)


def finish_root_once(p, tr):
    root = tr.root("r")
    kid = tr.child_open(root, "k")
    tr.finish_root(kid)
    tr.finish_root(kid)
    tr.finish_root(root)
    kid.finish()
    return tr.get_counters(), len(tr.dump())


def samples_and_tokens(p, tr):
    for i in range(5):
        sp = tr.root("q", op="paths" if i % 2 else "ksp")
        tr.child_open(sp, "dispatch")
        tr.finish(sp)
    samples = tr.span_samples()
    assert [g["count"] for g in samples] == [3, 2]
    tokens = tr.drain_structure_tokens()
    assert tr.drain_structure_tokens() == frozenset()
    return shape(samples), sorted(tokens), tr.span_samples(1)[0]["structure"]


def bind_scope_threads(p, tr):
    root = tr.root("r")
    seen = []

    def probe():
        seen.append(tr.scope())

    assert tr.bind_scope(probe) is probe  # nothing to carry
    with tr.activate((root,)):
        bound = tr.bind_scope(probe)
    t = threading.Thread(target=bound)
    t.start()
    t.join(5)
    return [s == (root,) for s in seen]


def eventbase_handoffs(p, tr):
    """run_in_event_base_thread and schedule_timeout carry the caller's
    scope onto the loop; add_fiber_task carries it into the task's
    creation only (the coroutine's steps run outside it)."""
    evb = p.evb.OpenrEventBase("obs-test")
    evb.run()
    try:
        root = tr.root("r")
        got = {}
        timer_seen = threading.Event()
        task_seen = threading.Event()

        def on_timer():
            got["timeout"] = tr.scope() == (root,)
            timer_seen.set()

        async def fiber():
            got["fiber"] = tr.scope() == (root,)
            task_seen.set()

        with tr.activate((root,)):
            fut = evb.run_in_event_base_thread(tr.scope)
            evb.schedule_timeout(0.0, on_timer)
            evb.add_fiber_task(fiber(), name="probe")
        got["call"] = fut.result(5) == (root,)
        assert timer_seen.wait(5) and task_seen.wait(5)
        # outside any scope: nothing is carried
        got["unscoped"] = evb.run_in_event_base_thread(tr.scope).result(5)
        return got
    finally:
        evb.stop()
        evb.wait_until_stopped(5)


def concurrent_annotations(p, tr):
    """A hedged call: two threads annotate and add events to one span."""
    root = tr.root("router.query")

    def worker(k):
        with tr.activate((root,)):
            for i in range(200):
                tr.event("dispatch", kind=f"w{k}")
                tr.annotate(f"w{k}", i)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    tr.finish(root)
    return len(root.children), sorted(root.tags.items()), tr.get_counters()


@pytest.mark.parametrize("scenario", [sampling, ring_eviction, structure_order],
                         ids=lambda f: f.__name__)
def test_tracer_unit_as_the_reference(scenario):
    try:
        same(each(scenario))
    finally:
        for p in PKGS.values():
            p.trace.disable()


@pytest.mark.parametrize(
    "scenario",
    [root_extends, fan_in, stage_bounds, finish_root_once, samples_and_tokens,
     bind_scope_threads, eventbase_handoffs, concurrent_annotations],
    ids=lambda f: f.__name__,
)
def test_armed_tracer_as_the_reference(tracers, scenario):
    got = same({name: scenario(p, tracers[name]) for name, p in PKGS.items()})
    if scenario is eventbase_handoffs:
        assert got == {"call": True, "timeout": True, "fiber": False, "unscoped": ()}
    if scenario is bind_scope_threads:
        assert got == [True]


# -- the queue carry ---------------------------------------------------------------


def carry_across_threads(p, tr):
    q = p.queue.RWQueue()
    root = tr.root("r")
    with tr.activate((root,)):
        q.push("item")
    got = []

    def consumer():
        q.get(timeout=5)
        got.append(tr.take_carried() == (root,))

    t = threading.Thread(target=consumer)
    t.start()
    t.join(5)
    return got


def carry_through_aget_and_try_get(p, tr):
    q = p.queue.RWQueue()
    root = tr.root("r")
    with tr.activate((root,)):
        q.push("a")
        q.push("b")

    async def take():
        await q.aget()
        return tr.take_carried() == (root,)

    first = asyncio.run(take())
    q.try_get()
    return first, tr.take_carried() == (root,), q.try_get(), tr.take_carried()


def pop_clears_stale_token(p, tr):
    q = p.queue.RWQueue()
    root = tr.root("r")
    with tr.activate((root,)):
        q.push("traced")
    q.push("untraced")
    q.get(timeout=5)
    q.get(timeout=5)
    # the second pop cleared the first pop's token
    return tr.take_carried()


def disarmed_items_carry_nothing(p, tr):
    p.trace.disable()
    q = p.queue.RWQueue()
    q.push("old")
    assert q._obs_tokens is None
    tr = p.trace.enable()
    root = tr.root("r")
    with tr.activate((root,)):
        q.push("new")
    q.get(timeout=5)
    first = tr.take_carried()
    q.get(timeout=5)
    return first, tr.take_carried() == (root,)


def bounded_shed_keeps_tokens_aligned(p, tr):
    shed = []
    q = p.queue.RWQueue(maxlen=2, on_shed=shed.append)
    roots = [tr.root("r", i=i) for i in range(4)]
    for i, root in enumerate(roots):
        with tr.activate((root,)):
            q.push(i)
    assert q.size() == 2 and len(q._obs_tokens) == 2
    out = []
    for _ in range(2):
        item = q.get(timeout=5)
        tok = tr.take_carried()
        out.append((item, tok[0].tags["i"]))
    return shed, out


def replicate_to_every_reader(p, tr):
    rq = p.queue.ReplicateQueue()
    readers = [rq.get_reader() for _ in range(2)]
    root = tr.root("r")
    with tr.activate((root,)):
        rq.push("x")
    got = []
    for r in readers:
        r.get(timeout=5)
        got.append(tr.take_carried() == (root,))
    return got


@pytest.mark.parametrize(
    "scenario",
    [carry_across_threads, carry_through_aget_and_try_get, pop_clears_stale_token,
     disarmed_items_carry_nothing, bounded_shed_keeps_tokens_aligned,
     replicate_to_every_reader],
    ids=lambda f: f.__name__,
)
def test_queue_carry_as_the_reference(tracers, scenario):
    got = same({name: scenario(p, tracers[name]) for name, p in PKGS.items()})
    want = {
        carry_across_threads: [True],
        carry_through_aget_and_try_get: (True, True, None, ()),
        pop_clears_stale_token: (),
        disarmed_items_carry_nothing: ((), True),
        bounded_shed_keeps_tokens_aligned: ([0, 1], [(2, 2), (3, 3)]),
        replicate_to_every_reader: [True, True],
    }[scenario]
    assert got == want
