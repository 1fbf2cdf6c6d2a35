"""The port's Fib and MockFibAgent against `openr_tpu`'s, on the CPU.

Each scenario of tests/test_fib.py pushes the same route deltas into
the port's Fib and the reference's, each programming its own
MockFibAgent, and holds the two agents' tables (and the tracked route
state) equal.  The wedged-agent scenario, whose reference drives a TCP
agent process, runs here against an agent whose calls time out.
"""

from __future__ import annotations

import time

import pytest

from openr_tpu import fib as jfib
from openr_tpu.runtime.queue import ReplicateQueue as JReplicateQueue
from openr_tpu_torch import fib as pfib
from openr_tpu_torch.decision.rib import (
    DecisionRouteUpdate,
    RibMplsEntry,
    RibUnicastEntry,
)
from openr_tpu_torch.fib.fib import FIB_CLIENT_OPENR as CLIENT
from openr_tpu_torch.runtime.queue import ReplicateQueue
from openr_tpu_torch.types import MplsAction, MplsActionCode, NextHop, PerfEvents
from torch_parity import to_ref

FIB_KW = dict(
    keepalive_interval_s=0.05, sync_initial_backoff_s=0.02, sync_max_backoff_s=0.2
)


def route(prefix: str, nh: str = "fe80::1", **kw) -> RibUnicastEntry:
    return RibUnicastEntry(
        prefix=prefix, nexthops=frozenset({NextHop(address=nh, if_name="eth0")}), **kw
    )


def update(*routes, delete=(), mpls=(), mpls_del=(), perf=None) -> DecisionRouteUpdate:
    u = DecisionRouteUpdate(perf_events=perf)
    for r in routes:
        u.add_route_to_update(r)
    u.unicast_routes_to_delete.extend(delete)
    u.mpls_routes_to_update.extend(mpls)
    u.mpls_routes_to_delete.extend(mpls_del)
    return u


def wait_for(cond, timeout=5.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return False


class FibPair:
    """The port's Fib and the reference's, each with its own agent and
    queues; `push` hands both the same delta."""

    def __init__(self, port_agent=None, ref_agent=None) -> None:
        self.sides = {}
        for name, mod, queue, agent in (
            ("port", pfib, ReplicateQueue, port_agent or pfib.MockFibAgent()),
            ("ref", jfib, JReplicateQueue, ref_agent or jfib.MockFibAgent()),
        ):
            routeq, fibq = queue(), queue()
            fib = mod.Fib(
                "node1", routeq.get_reader(), agent, fib_updates_queue=fibq, **FIB_KW
            )
            self.sides[name] = dict(
                routeq=routeq, fibq=fibq, stream=fibq.get_reader(), agent=agent, fib=fib
            )
        for side in self.sides.values():
            side["fib"].run()

    def __getitem__(self, name):
        return self.sides[name]

    def push(self, u: DecisionRouteUpdate) -> None:
        self["port"]["routeq"].push(u)
        self["ref"]["routeq"].push(to_ref(u))

    def both(self, cond) -> bool:
        return all(wait_for(lambda s=s: cond(s)) for s in self.sides.values())

    def tables_equal(self) -> None:
        p, r = self["port"]["agent"], self["ref"]["agent"]
        assert to_ref(p.unicast) == r.unicast
        assert to_ref(p.mpls) == r.mpls
        got = self["port"]["fib"].get_route_db()
        want = self["ref"]["fib"].get_route_db()
        assert to_ref(got) == want
        assert to_ref(self["port"]["fib"].get_route_db(programmed_only=True)) == (
            self["ref"]["fib"].get_route_db(programmed_only=True)
        )

    def close(self) -> None:
        for side in self.sides.values():
            side["routeq"].close()
            side["fibq"].close()
            side["fib"].stop()
            side["fib"].wait_until_stopped(5)


@pytest.fixture
def pair():
    p = FibPair()
    assert p.both(lambda s: s["agent"].counters["sync_fib"] >= 1)
    yield p
    p.close()


def unicast(s) -> dict:
    return s["agent"].unicast.get(CLIENT, {})


def mpls(s) -> dict:
    return s["agent"].mpls.get(CLIENT, {})


@pytest.mark.parametrize(
    "addr",
    ["10.1.1.5", "10.2.0.1", "2001::1", "192.168.0.1", "10.1.0.0", "::"],
)
def test_longest_prefix_match_equals_reference(addr):
    prefixes = ["10.0.0.0/8", "10.1.0.0/16", "10.1.1.0/24", "::/0"]
    assert pfib.longest_prefix_match(addr, prefixes) == jfib.longest_prefix_match(
        addr, prefixes
    )


def test_initial_sync_then_incremental(pair):
    pair.push(update(route("::1:0/112"), route("10.0.0.0/24", "10.0.0.1")))
    assert pair.both(lambda s: "::1:0/112" in unicast(s))
    pair.tables_equal()
    assert pair["port"]["agent"].counters == pair["ref"]["agent"].counters
    pair.push(update(delete=["::1:0/112"]))
    assert pair.both(lambda s: "::1:0/112" not in unicast(s))
    pair.tables_equal()


def test_mpls_programming(pair):
    nh = NextHop(address="fe80::2", mpls_action=MplsAction(MplsActionCode.PHP))
    pair.push(update(mpls=[RibMplsEntry(label=100, nexthops=frozenset({nh}))]))
    assert pair.both(lambda s: 100 in mpls(s))
    pair.tables_equal()
    pair.push(update(mpls_del=[100]))
    assert pair.both(lambda s: 100 not in mpls(s))
    pair.tables_equal()


def test_failure_triggers_resync(pair):
    for s in pair.sides.values():
        s["agent"].fail = True
    pair.push(update(route("::2:0/112")))
    assert pair.both(lambda s: s["fib"].counters.get("fib.sync_retries", 0) >= 1)
    assert not unicast(pair["port"]) and not unicast(pair["ref"])
    for s in pair.sides.values():
        s["agent"].fail = False
    assert pair.both(lambda s: "::2:0/112" in unicast(s))
    pair.tables_equal()


def test_agent_restart_resync(pair):
    pair.push(update(route("::3:0/112")))
    assert pair.both(lambda s: "::3:0/112" in unicast(s))
    for s in pair.sides.values():
        s["agent"].restart()
    assert pair.both(
        lambda s: "::3:0/112" in unicast(s)
        and s["fib"].counters.get("fib.agent_restarts", 0) >= 1
    )
    pair.tables_equal()


def test_do_not_install(pair):
    pair.push(update(route("::4:0/112", do_not_install=True), route("::5:0/112")))
    assert pair.both(lambda s: "::5:0/112" in unicast(s))
    assert "::4:0/112" not in unicast(pair["port"])
    pair.tables_equal()
    # flipping to installable programs it; flipping back withdraws it
    pair.push(update(route("::4:0/112")))
    assert pair.both(lambda s: "::4:0/112" in unicast(s))
    pair.push(update(route("::4:0/112", do_not_install=True)))
    assert pair.both(lambda s: "::4:0/112" not in unicast(s))
    pair.tables_equal()


def test_perf_events_and_fib_stream(pair):
    perf = PerfEvents()
    perf.add("node1", "DECISION_RECEIVED", 1000)
    pair.push(update(route("::6:0/112"), perf=perf))
    got = pair["port"]["stream"].get(timeout=5)
    want = pair["ref"]["stream"].get(timeout=5)
    names = [e.event_name for e in got.perf_events.events]
    assert names == [e.event_name for e in want.perf_events.events]
    assert names[0] == "DECISION_RECEIVED" and names[-1] == "OPENR_FIB_ROUTES_PROGRAMMED"
    assert list(got.unicast_routes_to_update) == list(want.unicast_routes_to_update)
    assert len(pair["port"]["fib"].get_perf_db()) == len(pair["ref"]["fib"].get_perf_db()) == 1
    for s in pair.sides.values():
        assert s["fib"].get_counters()["fib.route_convergence_count"] == 1


def test_get_unicast_routes_longest_match(pair):
    pair.push(update(route("fc01::/64"), route("fc01::/48"), route("10.1.0.0/16", "10.0.0.1")))
    assert pair.both(lambda s: len(unicast(s)) == 3)
    for query in (["fc01::0001/64"], ["fc01::5"], ["10.1.2.3/32", "bad", "fc01::/64"], None):
        got = pair["port"]["fib"].get_unicast_routes(query)
        want = pair["ref"]["fib"].get_unicast_routes(query)
        assert to_ref(got) == want, query


class _TimingOutAgent:
    """A FibService that accepts calls and never answers in time: every
    call raises TimeoutError until `answer` is set, then delegates to a
    MockFibAgent."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.answer = False

    def __getattr__(self, name):
        method = getattr(self.inner, name)

        def call(*args):
            if not self.answer:
                raise TimeoutError(f"{name}: agent did not answer")
            return method(*args)

        return call


def test_wedged_agent_trips_keepalive_and_recovery_resyncs():
    """A wedged agent (calls time out) is counted by the keepalive and
    never reaches `synced`; once it answers, the backoff'd sync programs
    the full state (reference: keepAliveCheck + syncRouteDbDebounced)."""
    p = FibPair(
        _TimingOutAgent(pfib.MockFibAgent()), _TimingOutAgent(jfib.MockFibAgent())
    )
    try:
        p.push(update(route("::9:0/112")))
        assert p.both(
            lambda s: s["fib"].counters.get("fib.thrift.failure.keepalive", 0) >= 2
        )
        assert not p["port"]["fib"].route_state.synced
        for s in p.sides.values():
            s["agent"].answer = True
        assert p.both(lambda s: "::9:0/112" in s["agent"].inner.unicast.get(CLIENT, {}))
        assert p.both(lambda s: s["fib"].route_state.synced)
        assert to_ref(p["port"]["agent"].inner.unicast) == p["ref"]["agent"].inner.unicast
    finally:
        p.close()
