"""The port's trace seams along its flows against `openr_tpu`'s, on the CPU.

Oracle: tests/test_obs.py (TestServingSpanTree, TestRouterSpanNesting,
TestFlapSpanTree) and the reference's seams it reaches.  Each flow runs
once per package on the same inputs (tests/torch_parity.py builds both
packages' LinkStates from the same databases) with that package's tracer
armed, and the finished traces' `Span.structure()` strings are compared
exactly:

- a serving query's tree (admission, coalesce, dispatch with the engine
  rung, reply), coalesced queries' fan-in, a shed query, an epoch retry
  and a failed optimize_metrics;
- the router's trace nesting the scheduler's, and its dispatch edges
  (retry, failover, hedge, epoch reroute) and outcomes on the
  reference's FakeReplica scripts (tests/test_torch_router.py);
- the publication path through a daemon (KvStore → Decision → Fib),
  from a merged publication and from a locally originated TTL expiry,
  and what the ctrl wire serves of it (dumpTraces, getSpanSamples, the
  obs.* counters);
- Spark's neighbor events in a ring of daemons;
- the snapshot's take and restore stages on each restore rung;
- the engine's rung tags: the delta rung, and the blocked rung with its
  kernel tag.

The reference keeps graphs under `min_device_nodes` on the host, where
its spans carry no rung; its backends are built with every query sent to
its engine (`min_device_nodes=1, min_device_sources=1`), as the port
always computes on its engine.  The blocked rung's kernel tag is mapped:
the reference's `outer:<pallas|xla|fallback>` is the port's
`outer:plain` on the CPU (`outer:cuda` on the card), ROADMAP queue 3.
"""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace

import pytest

from openr_tpu.decision.spf_solver import DeviceSpfBackend as JDeviceSpfBackend
from openr_tpu.obs import trace as jtrace
from openr_tpu.serving import EngineBatchBackend as JEngineBatchBackend
from openr_tpu.serving import QueryScheduler as JQueryScheduler
from openr_tpu.serving import QueryShedError as JQueryShedError
from openr_tpu.serving import ReplicaRouter as JReplicaRouter
from openr_tpu.serving import SchedulerReplica as JSchedulerReplica
from openr_tpu_torch.obs import trace as ptrace
from openr_tpu_torch.serving import (
    EngineBatchBackend,
    QueryScheduler,
    QueryShedError,
    ReplicaRouter,
    SchedulerReplica,
)
from torch_parity import LinkStatePair, adj, adj_dbs, square_dbs

PORT, REF = "port", "reference"
TRACE = {PORT: ptrace, REF: jtrace}
_J_DEVICE = dict(min_device_nodes=1, min_device_sources=1)


@pytest.fixture
def tracers():
    """Both packages' tracers armed for one test, both disarmed after."""
    try:
        yield {name: t.enable() for name, t in TRACE.items()}
    finally:
        for t in TRACE.values():
            t.disable()


def wait_for(cond, timeout=20.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


def finished(tr, name: str) -> list:
    """Finished traces named `name` in the ring, oldest first."""
    with tr._lock:
        ring = list(tr._ring)
    return [sp for sp in ring if sp.name == name]


def samples(tr) -> list:
    """(structure, count) of every shape in the ring, sorted."""
    return sorted((g["structure"], g["count"]) for g in tr.span_samples(1024))


# -- the scheduler ---------------------------------------------------------------


class Serving:
    """Both packages' schedulers over LinkStates of the same databases."""

    def __init__(self, dbs=None, **kwargs) -> None:
        self.pair = LinkStatePair(dbs or square_dbs())
        self.sched = {
            PORT: QueryScheduler(EngineBatchBackend({"0": self.pair.ls}, device="cpu"), **kwargs),
            REF: JQueryScheduler(
                JEngineBatchBackend({"0": self.pair.jls},
                                    spf_backend=JDeviceSpfBackend(**_J_DEVICE)),
                **kwargs),
        }
        self.shed = {PORT: QueryShedError, REF: JQueryShedError}
        for s in self.sched.values():
            s.run()

    def stop(self) -> None:
        for s in self.sched.values():
            s.stop()


@pytest.fixture
def serving():
    made = []

    def make(**kwargs):
        made.append(Serving(**kwargs))
        return made[-1]

    yield make
    for s in made:
        s.stop()


class Gate:
    """trace_hook holding every execute until released (tests/
    test_torch_serving.py's _Gate)."""

    def __init__(self) -> None:
        self.events: list = []
        self.release = threading.Event()
        self.on_execute = None

    def __call__(self, event: str, batch) -> None:
        self.events.append(event)
        if event == "execute_begin":
            self.release.wait(15)
            if self.on_execute is not None:
                self.on_execute(batch)

    def count(self, event: str) -> int:
        return self.events.count(event)


def park(sched, gate) -> list:
    """Batch 1 held in the executor, 2 staged, 3 in the coalescer's put."""
    warm = [sched.submit("paths", sources=("1",))]
    assert wait_for(lambda: gate.count("execute_begin") == 1)
    warm.append(sched.submit("paths", sources=("1",)))
    assert wait_for(lambda: gate.count("stage") == 2)
    warm.append(sched.submit("paths", sources=("1",)))
    assert wait_for(lambda: gate.count("stage") == 3)
    return warm


def test_query_tree_attributes_every_stage_and_the_rung(tracers, serving):
    s = serving()
    got = {}
    for name, sched in s.sched.items():
        res = sched.submit("paths", sources=("1",)).result(20)
        assert res.value["1"]
        tr = tracers[name]
        assert wait_for(lambda: finished(tr, "serving.query"))
        tree = finished(tr, "serving.query")[-1]
        d = tree.to_dict()
        assert d["duration_us"] is not None
        assert [c["name"] for c in d["children"]] == ["dispatch", "admission", "coalesce", "reply"]
        assert all(c["duration_us"] is not None for c in d["children"])
        got[name] = tree.structure(), tr.get_counters()
    assert got[PORT] == got[REF]
    assert got[PORT][0] == (
        "serving.query(op=paths,outcome=ok)[admission()[],coalesce()[],"
        "dispatch(engine.rung=restage)[],reply()[]]"
    )


def test_every_op_tags_its_dispatch_as_the_reference(tracers, serving):
    """paths and KSP dispatches carry the engine rung; what-if and
    optimize_metrics run on the forward runner and TE's evaluator, which
    tag none in either package."""
    s = serving()
    got = {}
    for name, sched in s.sched.items():
        sched.submit("paths", sources=("1",)).result(20)
        sched.submit("what_if", sources=("1",), scenarios=[[("1", "2")]]).result(20)
        sched.submit("ksp", sources=("1",), dests=("4",), k=2).result(20)
        sched.submit("optimize_metrics", demand=(("1", "3", 4.0),), bounds=(1, 16),
                     steps=4).result(60)
        tr = tracers[name]
        assert wait_for(lambda: len(finished(tr, "serving.query")) == 4)
        got[name] = [sp.structure() for sp in finished(tr, "serving.query")]
    assert got[PORT] == got[REF]
    rungs = [st.split("dispatch(")[1].split(")")[0] for st in got[PORT]]
    assert rungs == ["engine.rung=restage", "", "engine.rung=spf", ""]


def test_coalesced_queries_each_carry_the_rung(tracers, serving):
    """Fan-in: the batch's one engine call tags every query's dispatch."""
    s = serving()
    got = {}
    for name, sched in s.sched.items():
        gate = Gate()
        sched.trace_hook = gate
        warm = park(sched, gate)
        batch = [sched.submit("paths", sources=(src,)) for src in ("2", "3", "4")]
        gate.release.set()
        for f in warm + batch:
            f.result(20)
        tr = tracers[name]
        assert wait_for(lambda: len(finished(tr, "serving.query")) == 6)
        assert gate.count("execute_begin") == 4
        got[name] = samples(tr)
    assert got[PORT] == got[REF]
    assert [count for _, count in got[PORT]] == [1, 5]


def test_shed_query_closes_its_trace(tracers, serving):
    s = serving()
    got = {}
    for name, sched in s.sched.items():
        sched.stop()  # closed admission: every submit sheds
        with pytest.raises(s.shed[name]):
            sched.submit("paths", sources=("1",)).result(5)
        tr = tracers[name]
        got[name] = samples(tr), tr.get_counters()
    assert got[PORT] == got[REF]
    assert got[PORT][0] == [("serving.query(op=paths,outcome=shed)[]", 1)]


def test_admission_overflow_closes_the_shed_query(tracers, serving):
    s = serving(max_pending=1)
    got = {}
    for name, sched in s.sched.items():
        gate = Gate()
        sched.trace_hook = gate
        warm = park(sched, gate)
        waiting = [sched.submit("paths", sources=(src,)) for src in ("2", "3")]
        with pytest.raises(s.shed[name]):
            waiting[0].result(5)  # shed by the second
        gate.release.set()
        for f in warm + waiting[1:]:
            f.result(20)
        tr = tracers[name]
        assert wait_for(lambda: len(finished(tr, "serving.query")) == 5)
        got[name] = samples(tr)
    assert got[PORT] == got[REF]
    assert ("serving.query(op=paths,outcome=shed)[]", 1) in got[PORT]


def test_epoch_retry_is_an_event_of_the_dispatch(tracers, serving):
    s = serving()
    gates = {name: Gate() for name in s.sched}
    warm = {}
    for name, sched in s.sched.items():
        sched.trace_hook = gates[name]
        warm[name] = park(sched, gates[name])
    # one update moves both packages' topologies under the parked batches
    s.pair.update(adj_dbs({"2": [adj("2", "1")]}, labels={"2": 102})[0])
    got = {}
    for name in s.sched:
        gates[name].release.set()
        for f in warm[name]:
            f.result(20)
        tr = tracers[name]
        assert wait_for(lambda: len(finished(tr, "serving.query")) == 3)
        got[name] = samples(tr)
    assert got[PORT] == got[REF]
    assert any("epoch_retry()" in st for st, _ in got[PORT])


def test_failed_optimize_metrics_closes_with_error(tracers, serving):
    s = serving()
    down = adj_dbs({"2": [adj("2", "1")]}, labels={"2": 102})[0]
    up = next(db for db in square_dbs() if db.this_node_name == "2")
    got = {}
    for (name, sched), db in zip(s.sched.items(), (down, up)):
        gate = Gate()

        def flap(batch, db=db):
            if batch.op == "optimize_metrics":
                s.pair.update(db)  # after coalescing pinned the epoch

        gate.on_execute = flap
        gate.release.set()
        sched.trace_hook = gate
        fut = sched.submit("optimize_metrics", demand=(("1", "3", 4.0),), bounds=(1, 16),
                           steps=8)
        with pytest.raises(Exception):
            fut.result(60)
        tr = tracers[name]
        got[name] = samples(tr)
    assert got[PORT] == got[REF]
    assert got[PORT] == [
        ("serving.query(op=optimize_metrics,outcome=error)[dispatch()[epoch_retry()[]]]", 1)
    ]


# -- the router ------------------------------------------------------------------


def test_router_trace_nests_the_scheduler_trace(tracers, serving):
    s = serving()
    routers = {
        PORT: ReplicaRouter([SchedulerReplica("rep-0", s.sched[PORT])], hedge_after_s=None),
        REF: JReplicaRouter([JSchedulerReplica("rep-0", s.sched[REF])], hedge_after_s=None),
    }
    got = {}
    try:
        for name, router in routers.items():
            assert router.submit("paths", sources=("1",)).result(20).value["1"]
            tr = tracers[name]
            assert wait_for(lambda: finished(tr, "router.query")
                            and "outcome" in finished(tr, "router.query")[-1].tags)
            tree = finished(tr, "router.query")[-1]
            assert [c.name for c in tree.children] == ["dispatch", "serving.query"]
            got[name] = tree.structure(), tr.get_counters()
    finally:
        for router in routers.values():
            router.stop()
    assert got[PORT] == got[REF]
    assert got[PORT][0] == (
        "router.query(op=paths,outcome=ok)[dispatch(kind=first)[],"
        "serving.query(op=paths,outcome=ok)[admission()[],coalesce()[],"
        "dispatch(engine.rung=restage)[],reply()[]]]"
    )


def test_a_retried_routed_query_is_finished_by_the_router(tracers, serving):
    """F8 (ROADMAP queue 3): under a router's trace the scheduler closes
    only its own span, and the router finishes the root when it delivers.
    The reference's scheduler finishes the router's root from the nested
    span: a query shed by one replica and retried on another is finished
    at the shed, before the retry, so its structure token lacks the retry
    and the outcome, and the nested spans never finish.  The final
    structures are equal."""
    live, dead = serving(), serving()
    for sched in dead.sched.values():
        sched.stop()
    routers = {
        PORT: ReplicaRouter([SchedulerReplica("dead", dead.sched[PORT]),
                             SchedulerReplica("live", live.sched[PORT])], hedge_after_s=None),
        REF: JReplicaRouter([JSchedulerReplica("dead", dead.sched[REF]),
                             JSchedulerReplica("live", live.sched[REF])], hedge_after_s=None),
    }
    got = {}
    try:
        for name, router in routers.items():
            tr = tracers[name]
            assert router.submit("paths", sources=("1",)).result(20).value["1"]
            assert wait_for(lambda: finished(tr, "router.query")
                            and "outcome" in finished(tr, "router.query")[-1].tags)
            tree = finished(tr, "router.query")[-1]
            nested = [c.t_end_us is not None for c in tree.children if c.name == "serving.query"]
            got[name] = tree.structure(), sorted(tr.drain_structure_tokens()), nested
    finally:
        for router in routers.values():
            router.stop()
    assert got[PORT][0] == got[REF][0] == (
        "router.query(op=paths,outcome=ok)[dispatch(kind=first)[],dispatch(kind=retry)[],"
        "serving.query(op=paths,outcome=ok)[admission()[],coalesce()[],"
        "dispatch(engine.rung=restage)[],reply()[]],serving.query(op=paths,outcome=shed)[]]"
    )
    assert got[PORT][1:] == ([got[PORT][0]], [True, True])
    assert got[REF][1] == [
        "router.query(op=paths)[dispatch(kind=first)[],serving.query(op=paths,outcome=shed)[]]"
    ]
    assert got[REF][2] == [False, False]


ROUTER_SCENARIOS = [
    "round_robin",
    "async_unavailable_fails_over",
    "sync_refusal_is_not_a_dispatch",
    "replica_shed_retries_elsewhere",
    "fleetwide_shed_propagates",
    "no_replicas_sheds_at_admission",
    "stopped_router_sheds",
    "stale_reply_reroutes",
    "epoch_mismatch_is_retried",
    "hedge_wins_when_primary_stalls",
]


@pytest.mark.parametrize("scenario", ROUTER_SCENARIOS)
def test_router_edges_and_outcomes_as_the_reference(tracers, scenario):
    import test_torch_router as tr_tests

    fn = getattr(tr_tests, scenario)
    got = {}
    for name, pkg_name in ((PORT, "port"), (REF, "reference")):
        fn(tr_tests.PKGS[pkg_name])
        tr = tracers[name]
        got[name] = samples(tr), tr.get_counters()
    assert got[PORT] == got[REF]
    assert got[PORT][0], "no router trace finished"
    want_edge = {
        "async_unavailable_fails_over": "kind=failover",
        "replica_shed_retries_elsewhere": "kind=retry",
        "stale_reply_reroutes": "kind=epoch_reroute",
        "hedge_wins_when_primary_stalls": "outcome=hedge_win",
        "no_replicas_sheds_at_admission": "outcome=shed",
        "fleetwide_shed_propagates": "outcome=error",
    }.get(scenario)
    if want_edge is not None:
        assert any(want_edge in st for st, _ in got[PORT][0]), got[PORT]


# -- the publication path through a daemon ---------------------------------------


def _daemon(name: str, node: str, ctrl: bool = True):
    import test_torch_daemon as dt

    p = dt.P["port" if name == PORT else "ref"]
    kwargs = dict(p.kwargs)
    if name == REF:
        kwargs["spf_backend"] = JDeviceSpfBackend(**_J_DEVICE)
    fabric = p.MockIoProvider()
    d = p.main.OpenrDaemon(
        dt.make_config(p, node, ctrl_port=0),
        io_provider=fabric.endpoint(node),
        kvstore_transport=p.InProcessTransport().bind(node),
        **kwargs,
    )
    d.start()
    return p, d


def _flap_key_vals(T, dumps):
    def _adj(me, other):
        return T.Adjacency(other_node_name=other, if_name=f"{me}/{other}",
                           other_if_name=f"{other}/{me}", metric=10,
                           next_hop_v6=f"fe80::{1 if other == 'solo' else 2}")

    pfx = "::9:0/112"
    return {
        T.adj_key("solo"): T.Value(1, "solo", dumps(T.AdjacencyDatabase("solo", [_adj("solo", "peer")]))),
        T.adj_key("peer"): T.Value(1, "peer", dumps(T.AdjacencyDatabase("peer", [_adj("peer", "solo")]))),
        T.prefix_key("peer", pfx, "0"): T.Value(
            1, "peer", dumps(T.PrefixDatabase("peer", [T.PrefixEntry(prefix=pfx)]))),
    }


def _programmed_after(tr, t0_us: int):
    """The first publication trace rooted after t0 whose decision stage
    holds fib.program, once finished."""
    for sp in finished(tr, "kvstore.publication"):
        if sp.t_start_us < t0_us:
            continue
        if any(c.name == "decision" and any(g.name == "fib.program" for g in c.children)
               for c in sp.children):
            return sp
    return None


def _ctrl_view(name, d):
    if name == PORT:
        from openr_tpu_torch.ctrl import CtrlClient

        client = CtrlClient("::1", d.ctrl_port)
    else:
        from openr_tpu.ctrl import CtrlClient

        client = CtrlClient(port=d.ctrl_port)
    try:
        dumped = client.call("dumpTraces", n=64)
        spans = client.call("getSpanSamples")
        counters = client.call("getCounters")
    finally:
        client.close()
    return dumped, spans, counters


def ptrace_breeze():
    from openr_tpu_torch.cli import breeze

    return breeze


def jtrace_breeze():
    from openr_tpu.cli import breeze

    return breeze


def _monitor_traces_text(breeze, answer) -> str:
    """What `breeze monitor traces -n 64` prints for a dumpTraces answer."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        breeze.cmd_monitor_traces(SimpleNamespace(call=lambda method, **kw: answer),
                                  SimpleNamespace(n=64))
    return out.getvalue()


def _keys(d) -> list:
    """The key sets of a dumped tree, depth first."""
    return [sorted(d), *(k for c in d["children"] for k in _keys(c))]


def test_publication_trace_through_a_daemon_and_over_ctrl(tracers):
    got = {}
    for name in (PORT, REF):
        p, d = _daemon(name, "solo")
        try:
            from importlib import import_module

            dumps = import_module(f"{'openr_tpu_torch' if name == PORT else 'openr_tpu'}.serializer").dumps
            tr = tracers[name]
            t0 = TRACE[name]._now_us()
            d.kvstore.set_key_vals("0", _flap_key_vals(p.T, dumps))
            assert wait_for(lambda: _programmed_after(tr, t0) is not None, 30)
            tree = _programmed_after(tr, t0)
            assert tree.tags["area"] == "0" and tree.t_end_us is not None
            dumped, spans, counters = _ctrl_view(name, d)
            if name == PORT:
                # `breeze monitor traces` prints these trees as the
                # reference's breeze prints them
                assert _monitor_traces_text(ptrace_breeze(), dumped) == (
                    _monitor_traces_text(jtrace_breeze(), dumped))
                assert "kvstore.publication [" in _monitor_traces_text(ptrace_breeze(), dumped)
            pub = [t for t in dumped if t["name"] == "kvstore.publication"]
            assert pub and spans and all(set(s) == {"structure", "count", "max_us"} for s in spans)
            assert counters["obs.traces_finished"] > 0
            got[name] = (
                tree.structure(),
                _keys(pub[-1]),
                sorted(k for k in counters if k.startswith("obs.")),
            )
        finally:
            d.stop()
    assert got[PORT] == got[REF]
    assert got[PORT][0] == (
        "kvstore.publication(area=0)[decision(engine.rung=restage,event=DECISION_DEBOUNCE)"
        "[fib.program()[]],kvstore.merge()[]]"
    )


# above the store's TTL threshold, so the mortal key floods to Decision
MORTAL_TTL_MS = 1500


def test_expired_key_roots_at_the_flood_chokepoint(tracers):
    """F7 (ROADMAP queue 3): a TTL expiry is published locally, and the
    flood chokepoint is meant to root its trace.  The reference's TTL
    timer is armed inside the traced merge of the mortal key and carries
    that publication's scope into the expiry, so the expiry roots
    nothing: its Decision stage lands on the mortal key's trace, which
    Fib finished long before.  The port arms the timer outside any scope:
    the expiry roots its own trace (no merge stage), finished by Fib."""
    got = {}
    for name in (PORT, REF):
        p, d = _daemon(name, "solo")
        try:
            from importlib import import_module

            dumps = import_module(f"{'openr_tpu_torch' if name == PORT else 'openr_tpu'}.serializer").dumps
            tr = tracers[name]
            d.kvstore.set_key_vals("0", _flap_key_vals(p.T, dumps))
            assert wait_for(lambda: _programmed_after(tr, 0) is not None, 30)
            # a second prefix with a TTL: programmed, then withdrawn
            mortal = p.T.Value(1, "peer", dumps(p.T.PrefixDatabase(
                "peer", [p.T.PrefixEntry(prefix="::8:0/112")])), ttl_ms=MORTAL_TTL_MS)
            key = p.T.prefix_key("peer", "::8:0/112", "0")
            t0 = TRACE[name]._now_us()
            d.kvstore.set_key_vals("0", {key: mortal})
            assert wait_for(lambda: len(d.fib_agent.unicast.get(786, {})) == 2, 30)
            assert wait_for(lambda: not d.kvstore.get_key_vals("0", [key]).key_vals, 30)
            # the expiry's route withdrawal is programmed
            assert wait_for(lambda: len(d.fib_agent.unicast.get(786, {})) == 1, 30)
            time.sleep(0.2)
            roots = [sp for sp in finished(tr, "kvstore.publication") if sp.t_start_us >= t0]
            got[name] = sorted(sp.structure() for sp in roots)
        finally:
            d.stop()
    # a prefix-only change rebuilds from the cached SPF results: no rung
    merged = ("kvstore.publication(area=0)[decision(event=DECISION_DEBOUNCE)"
              "[fib.program()[]],kvstore.merge()[]]")
    expired = "kvstore.publication(area=0)[decision(event=DECISION_DEBOUNCE)[fib.program()[]]]"
    assert got[PORT] == sorted([merged, expired])
    # the reference: one trace, the mortal key's, holding both rebuilds
    assert got[REF] == [
        "kvstore.publication(area=0)[decision(event=DECISION_DEBOUNCE)[fib.program()[]],"
        "decision(event=DECISION_DEBOUNCE)[fib.program()[]],kvstore.merge()[]]"
    ]


def test_spark_neighbor_events_in_a_ring(tracers):
    """Every Spark adjacency coming up roots a shallow, finished
    spark.neighbor_event trace; in a ring of three each node is seen up
    by its two neighbours, and the publications those events cause reach
    Decision and Fib."""
    import test_torch_daemon as dt

    got = {}
    for name in (PORT, REF):
        p = dt.P["port" if name == PORT else "ref"]
        kwargs = dict(p.kwargs)
        if name == REF:
            kwargs["spf_backend"] = JDeviceSpfBackend(**_J_DEVICE)
        spark_fabric, kv_fabric, daemons = p.MockIoProvider(), p.InProcessTransport(), []
        try:
            for i in range(3):
                node, addr = f"openr-{i}", f"fe80::openr-{i}"
                d = p.main.OpenrDaemon(dt.make_config(p, node),
                                       io_provider=spark_fabric.endpoint(node),
                                       kvstore_transport=kv_fabric.bind(addr),
                                       spark_v6_addr=addr, **kwargs)
                kv_fabric.register(addr, d.kvstore)
                daemons.append(d)
                d.start()
            for i in range(3):
                j = (i + 1) % 3
                spark_fabric.connect(f"openr-{i}", f"if-{i}-{j}", f"openr-{j}", f"if-{j}-{i}")
            for i, d in enumerate(daemons):
                d.netlink_events_queue.push(p.T.LinkEvent(f"if-{i}-{(i + 1) % 3}", 1, True))
                d.netlink_events_queue.push(p.T.LinkEvent(f"if-{i}-{(i - 1) % 3}", 2, True))
            tr = tracers[name]

            def ups():
                return [sp.structure() for sp in finished(tr, "spark.neighbor_event")
                        if sp.tags["event"] == "NEIGHBOR_UP"]

            # each node is seen up by its two ring neighbours (a flap under
            # load may add events, never remove one)
            assert wait_for(lambda: len(set(ups())) == 3
                            and all(ups().count(st) >= 2 for st in set(ups())), 30), ups()
            assert wait_for(lambda: any(
                any(c.name == "decision" and any(g.name == "fib.program" for g in c.children)
                    for c in sp.children)
                for sp in finished(tr, "kvstore.publication")), 30)
            got[name] = sorted(set(ups()))
        finally:
            for d in daemons:
                d.stop()
    assert got[PORT] == got[REF] == [
        f"spark.neighbor_event(event=NEIGHBOR_UP,node=openr-{i})[]" for i in range(3)
    ]


# -- the snapshot ------------------------------------------------------------------


@pytest.mark.parametrize("rung", ["replay_after_drift", "install_on_a_fresh_replica",
                                  "stale_snapshot_to_cold", "rewire_chain_gap_to_cold"])
def test_snapshot_stages_on_each_rung(tracers, rung):
    import test_torch_snapshot as st

    fn, want_mode = st.RUNGS[rung]
    port, ref = st.pair(st.TOPOLOGIES["grid4"])
    got = {}
    for name, side in ((PORT, port), (REF, ref)):
        tr = tracers[name]
        root = tr.root("op")
        with tr.activate((root,)):
            mode = fn(side)[0]
        tr.finish(root)
        assert mode == want_mode
        got[name] = root.structure()
    assert got[PORT] == got[REF]
    assert f"snapshot.rung={want_mode}" in got[PORT]
    assert "op=take)" in got[PORT] and "op=restore," in got[PORT]


def test_snapshot_prewarm_is_a_stage_of_the_restore(tracers):
    import test_torch_snapshot as st

    port, ref = st.pair(st.TOPOLOGIES["grid4"])
    got = {}
    for name, side in ((PORT, port), (REF, ref)):
        st.answers(side.engine, side.csr, side.ls.node_names[:3])
        blob = side.snap.take(side.engine, side.csr).to_bytes()
        _, csr = side.mirror(st.TOPOLOGIES["grid4"]())
        tr = tracers[name]
        root = tr.root("scale_out")
        with tr.activate((root,)):
            assert side.snap.from_bytes(blob).restore(side.fresh_engine(), csr) == "install"
        tr.finish(root)
        got[name] = root.structure()
    assert got[PORT] == got[REF] == (
        "scale_out()[engine.snapshot(op=restore,snapshot.rung=install)"
        "[engine.snapshot.prewarm()[]]]"
    )


# -- the engine's rung tags ------------------------------------------------------


def test_delta_dispatch_tags_the_delta_rung(tracers):
    from openr_tpu.device import DeviceResidencyEngine as JEngine
    from openr_tpu_torch.device.engine import DeviceResidencyEngine

    got = {}
    for name, engine in ((PORT, DeviceResidencyEngine("cpu")), (REF, JEngine())):
        tr = tracers[name]
        root = tr.root("view")
        with tr.activate((root,)):
            assert engine.delta_dispatch("relax", lambda x: x + 1, 1, bucket_key=("b", 8)) == 2
        tr.finish(root)
        got[name] = root.structure()
    assert got[PORT] == got[REF] == "view(engine.rung=delta)[]"


def test_blocked_rung_tags_the_rung_and_the_kernel(tracers, monkeypatch):
    """The blocked view tags `engine.rung=blocked` and the flavour that ran
    phase 3.  The reference's flavour is the mode it asked for: with the
    Pallas mode left to its default on the CPU it resolves to off, runs
    the XLA phase (`pallas_skips`) and still tags `outer:pallas` (F7,
    ROADMAP queue 3); the port tags what launched: `outer:plain` on the
    CPU."""
    import jax

    from openr_tpu.decision.fleet import FleetViewCache as JFleetViewCache
    from openr_tpu.device import DeviceResidencyEngine as JEngine
    from openr_tpu.parallel import blocked as blk
    from openr_tpu_torch.decision.fleet import FleetViewCache
    from openr_tpu_torch.device.engine import DeviceResidencyEngine
    from openr_tpu_torch.ops import blocked_outer as bo
    from openr_tpu_torch.utils import topo
    from torch_parity import link_states

    monkeypatch.delenv("OPENR_NODE_SHARD", raising=False)
    monkeypatch.delenv("OPENR_PALLAS", raising=False)
    ls, jls = link_states(topo.fat_tree_topology(4))
    nodes = sorted(ls.node_names)
    dests = [nodes[0], nodes[3], nodes[-1]]
    tags = {}
    for mode in (None, "interpret", "off"):
        jengine = JEngine()
        jengine.pallas_mode = mode
        jengine.blocked.node_shard_threshold = 0
        jengine.blocked._mesh = blk.make_blocked_mesh(jax.devices()[:1])
        root = tracers[REF].root("view")
        with tracers[REF].activate((root,)):
            assert JFleetViewCache(delta=False).view(jls, dests, engine=jengine).node_sharded
        c = jengine.get_counters()
        tags[mode] = (dict(root.tags), c["device.engine.pallas_outer_updates"] > 0,
                      c["device.engine.pallas_skips"] > 0)
    assert tags["interpret"] == ({"engine.rung": "blocked", "engine.kernel": "outer:pallas"},
                                 True, False)
    assert tags["off"] == ({"engine.rung": "blocked", "engine.kernel": "outer:xla"}, False, True)
    # F7: no Pallas launch, every launch skipped, tagged pallas all the same
    assert tags[None] == ({"engine.rung": "blocked", "engine.kernel": "outer:pallas"},
                          False, True)

    engine = DeviceResidencyEngine("cpu")
    engine.blocked.node_shard_threshold = 0
    launches = bo.blocked_outer.launches
    root = tracers[PORT].root("view")
    with tracers[PORT].activate((root,)):
        assert FleetViewCache().view(ls, dests, engine=engine).node_sharded
    assert bo.blocked_outer.launches == launches  # the CPU launches no kernel
    assert root.tags == {"engine.rung": "blocked", "engine.kernel": "outer:plain"}
    # the mapping: the rung equal, the kernel's flavour named for the port
    mapped = {k: ("outer:plain" if k == "engine.kernel" else v)
              for k, v in tags["off"][0].items()}
    assert mapped == root.tags


def test_unarmed_flows_open_no_spans(serving):
    """Unarmed, a query, a routed call and a Decision keep no span state:
    the per-query slots stay None and no token deque is made."""
    assert ptrace.TRACE is None
    s = serving()
    sched = s.sched[PORT]
    router = ReplicaRouter([SchedulerReplica("rep-0", sched)], hedge_after_s=None)
    try:
        captured = []
        real = sched.admission.push

        def spy(pending):
            captured.append(pending)
            return real(pending)

        sched.admission.push = spy
        assert router.submit("paths", sources=("1",)).result(20).value["1"]
        assert captured and captured[0].span is None
        assert sched.admission._obs_tokens is None
    finally:
        router.stop()
