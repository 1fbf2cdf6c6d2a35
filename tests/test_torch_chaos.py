"""The port's chaos injectors and fault seams (`openr_tpu_torch.chaos`,
the engine's `fault_hook`, `InProcessTransport.set_chaos`,
`MockFibAgent.chaos`, the daemon's `chaos.fuzz.*` surface) against
`openr_tpu.chaos`, on the CPU.

Oracle: tests/test_chaos.py.  Everything compared is seeded, so there is
no tolerance:

- every schedule (link drop / dup / reorder plans, Fib verdicts, KvStore
  transport failures, TTL storms) is the reference's, decision for
  decision, and so are the `ChaosEventLog` streams they write;
- the fault seams fire where the reference's fire, and an injected fault
  propagates out of every gate but one: the hook's own exception at
  `rewire`, which demotes to a restage counted in `rewire_fallbacks`.
  The reference's demotions (Pallas to XLA, the Decision's host oracle,
  the delta rung's full product) have no counterpart, so the live-daemon
  tests hold the port's contract instead: the failure surfaces and is
  counted (`decision.route_rebuild_failures`), the pending publication is
  kept, and the first rebuild after `disarm()` programs the host oracle's
  routes;
- the scripted 4-node scenario converges to the host oracle and a same-
  seed replay writes the same scenario log and fault decisions.

Waits poll converged state against deadlines scaled by
`wait_timeout_scale`; nothing sleeps a fixed time for convergence.
"""

from __future__ import annotations

import os
import random
import socket
import struct
import time

import numpy as np
import pytest

from openr_tpu import chaos as rchaos
from openr_tpu_torch import chaos as pchaos
from openr_tpu_torch.chaos import (
    ChaosEventLog,
    ChaosIoProvider,
    ChaosScenario,
    ChaosSpfBackend,
    FibChaosPlan,
    KvChaosInjector,
    fib_unicast_routes,
    oracle_route_dbs,
)
from openr_tpu_torch.chaos.chaos import SCENARIO_STREAM, wait_timeout_scale, wait_until
from openr_tpu_torch.chaos.scenario import hold_converged
from openr_tpu_torch.device.engine import DeviceResidencyEngine
from openr_tpu_torch.fib import MockFibAgent
from openr_tpu_torch.kvstore import InProcessTransport
from openr_tpu_torch.kvstore.kvstore import TransportError
from openr_tpu_torch.main import OpenrDaemon, fleet_node_config
from openr_tpu_torch.types import LinkEvent, PrefixEntry, PrefixType, normalize_prefix

pytestmark = pytest.mark.chaos

FIB_CLIENT = 786


# -- seeded schedules: the reference's, decision for decision ----------------


def _link_plans(mod, seed: int, n: int = 300):
    fabric = mod.ChaosIoProvider(seed=seed)
    fabric.set_link_profile("a", "b", drop=0.3, dup=0.2, reorder=0.2, jitter_s=0.01)
    plans = [fabric._plan_delivery("a", "b") for _ in range(n)]
    return plans, fabric.log.streams()


@pytest.mark.parametrize("seed", [7, 8, 20260805])
def test_link_schedule_is_the_references(seed):
    plans, log = _link_plans(rchaos, seed)
    assert _link_plans(pchaos, seed) == (plans, log)
    assert any(p == [] for p in plans) and any(len(p) == 2 for p in plans)


def test_unprofiled_and_partitioned_traffic_consume_no_draws():
    """The k-th profiled packet's fate is what replays: traffic before the
    profile and partitioned traffic leave the schedule where it was, in
    both packages alike."""
    out = {}
    for name, mod in (("port", pchaos), ("ref", rchaos)):
        f1, f2 = mod.ChaosIoProvider(seed=11), mod.ChaosIoProvider(seed=11)
        for _ in range(17):
            f1._plan_delivery("a", "b")
        for f in (f1, f2):
            f.set_link_profile("a", "b", drop=0.5)
        f1.set_partitioned("a", "b", True)
        assert [f1._plan_delivery("a", "b") for _ in range(9)] == [[]] * 9
        f1.set_partitioned("a", "b", False)
        p1 = [f1._plan_delivery("a", "b") for _ in range(100)]
        p2 = [f2._plan_delivery("a", "b") for _ in range(100)]
        assert p1 == p2
        out[name] = p1
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("seed", [5, 6])
def test_fib_plan_is_the_references(seed):
    def verdicts(cls):
        plan = cls(seed, fail_prob=0.2, restart_prob=0.1, fail_ops={"sync_fib", "add_unicast_routes"})
        ops = ("sync_fib", "add_unicast_routes", "alive_since")
        v = [plan.on_call(ops[k % 3]) for k in range(300)]
        return v, plan.log.streams()

    port, ref = verdicts(FibChaosPlan), verdicts(rchaos.FibChaosPlan)
    assert port == ref
    assert {"ok", "fail", "restart"} <= set(port[0])


@pytest.mark.parametrize("seed", [9, 10])
def test_kv_injector_is_the_references(seed):
    def outcomes(cls):
        inj = cls(seed, full_dump_fail=0.4, key_set_fail=0.2)
        out = []
        for k in range(200):
            op = ("full_dump", "key_set", "dual")[k % 3]
            try:
                inj.check(op, "x", "y" if k % 2 else "z")
                out.append("ok")
            except RuntimeError as e:
                out.append(type(e).__name__)
        inj.disarm()
        inj.check("full_dump", "x", "y")
        return out, inj.log.streams()

    port, ref = outcomes(KvChaosInjector), outcomes(rchaos.KvChaosInjector)
    assert port == ref
    assert "TransportError" in port[0]


def test_kv_injector_raises_the_ports_transport_error():
    inj = KvChaosInjector(1, full_dump_fail=1.0)
    with pytest.raises(TransportError, match="injected full_dump"):
        inj.check("full_dump", "a", "b")


def test_ttl_storm_is_the_references():
    class Sink:
        def set_key_vals(self, area, key_vals):
            self.area, self.key_vals = area, key_vals

    got = {}
    for name, cls in (("port", KvChaosInjector), ("ref", rchaos.KvChaosInjector)):
        inj, sink = cls(seed=31), Sink()
        keys = inj.ttl_storm(sink, n_keys=12, ttl_ms=150)
        got[name] = (keys, sink.area, {k: (v.version, v.originator_id, v.value, v.ttl_ms)
                                       for k, v in sink.key_vals.items()},
                     inj.log.streams())
    assert got["port"] == got["ref"]


def test_event_log_matching_semantics_are_the_references():
    for cls, stream in ((ChaosEventLog, SCENARIO_STREAM), (rchaos.ChaosEventLog, "scenario")):
        a, b = cls(), cls()
        for log in (a, b):
            log.append(stream, "step-1")
            log.append("link:x->y", "0:drop")
        a.append("link:x->y", "4:drop")
        assert a.matches(b) and b.matches(a)
        a.append(stream, "step-2")
        assert not a.matches(b)
        b.append(stream, "step-2")
        assert a.matches(b)
        b.append("link:x->y", "4:reorder")
        assert not a.matches(b)


# -- the agent and transport seams ------------------------------------------


def test_fib_agent_chaos_fails_and_restarts_as_the_references():
    agent = MockFibAgent()
    agent.chaos = FibChaosPlan(1, fail_prob=1.0, fail_ops={"sync_fib"})
    agent.add_unicast_routes(FIB_CLIENT, [])  # unlisted op: untouched
    with pytest.raises(RuntimeError, match="injected"):
        agent.sync_fib(FIB_CLIENT, [])
    agent.chaos.disarm()
    agent.sync_fib(FIB_CLIENT, [])

    agent2 = MockFibAgent()
    before = agent2.alive_since()
    agent2.chaos = FibChaosPlan(2, restart_prob=1.0)
    with pytest.raises(RuntimeError, match="restarted"):
        agent2.sync_fib(FIB_CLIENT, [])
    agent2.chaos = None
    assert agent2.alive_since() > before
    assert agent2.unicast == {}


def test_transport_seam_checks_full_dump_and_key_set():
    import asyncio

    from openr_tpu_torch.kvstore.kvstore import KeyDumpParams, KeySetParams
    from openr_tpu_torch.types import PeerSpec

    seen = []

    class Recorder:
        def check(self, op, src, dst):
            seen.append((op, src, dst))
            raise TransportError(f"injected {op}")

    fabric = InProcessTransport()
    fabric.set_chaos(Recorder())
    bound = fabric.bind("a")
    peer = PeerSpec(peer_addr="b")
    for call in (
        bound.full_dump(peer, "0", KeyDumpParams()),
        bound.key_set(peer, "0", KeySetParams(key_vals={})),
    ):
        with pytest.raises(TransportError, match="injected"):
            asyncio.run(call)
    assert seen == [("full_dump", "a", "b"), ("key_set", "a", "b")]


# -- the engine's gates -------------------------------------------------------


def _square_csr():
    from openr_tpu_torch.decision.csr import CsrTopology
    from torch_parity import link_states, square_dbs

    port_ls, _ = link_states(square_dbs())
    return port_ls, CsrTopology.from_link_state(port_ls)


class Raise:
    def __init__(self, op):
        self.op, self.seen = op, []

    def __call__(self, op):
        self.seen.append(op)
        if op == self.op:
            raise RuntimeError(f"injected {op}")


@pytest.mark.parametrize("op", ["sync", "spf"])
def test_sync_and_spf_faults_propagate(op):
    ls, csr = _square_csr()
    engine = DeviceResidencyEngine("cpu")
    engine.fault_hook = hook = Raise(op)
    with pytest.raises(RuntimeError, match=f"injected {op}"):
        engine.spf_results(csr, [ls.node_names[0]])
    assert engine.get_counters()["device.engine.queries"] == 0
    assert hook.seen[0] == "spf"


def test_dispatch_fault_propagates_before_the_work():
    engine = DeviceResidencyEngine("cpu")
    engine.fault_hook = Raise("fleet_product")
    ran = []
    with pytest.raises(RuntimeError, match="injected fleet_product"):
        engine.dispatch("fleet_product", lambda: ran.append(1))
    assert ran == [] and engine.counters["device.engine.dispatches"] == 0


def test_fault_hook_sees_delta_ops_as_the_references():
    """tests/test_delta.py::TestEngineDeltaRung::test_fault_hook_sees_delta_ops
    in both packages."""
    from openr_tpu.device import DeviceResidencyEngine as JEngine

    seqs = []
    for engine in (DeviceResidencyEngine("cpu"), JEngine()):
        seen = []
        engine.fault_hook = seen.append
        for op in ("frontier", "relax", "rows"):
            engine.delta_dispatch(op, lambda: None)
        seqs.append(seen)
    assert seqs[0] == seqs[1] == ["delta_frontier", "delta_relax", "delta_rows"]


def test_delta_fault_propagates_without_the_full_product():
    """The reference's delta rung demotes an injected fault to the full
    product (decision.delta.fallbacks); the port's lets it leave view()."""
    from openr_tpu_torch.decision import fleet
    from test_torch_delta import Pair, _raise_0_1

    pair = Pair.ring()
    dests = pair.dests()
    bump_log = {}

    def bump(name, delta=1):
        bump_log[name] = bump_log.get(name, 0) + delta

    engine = DeviceResidencyEngine("cpu")
    cache = fleet.FleetViewCache(delta=True, bump=bump)
    view = cache.view(pair.ls, dests, engine=engine)
    engine.delta_register(view._dist_dev.nbytes + view._bitmap_dev.nbytes)
    pair.set_node(0, metric=_raise_0_1)
    engine.fault_hook = Raise("delta_frontier")
    with pytest.raises(RuntimeError, match="injected delta_frontier"):
        cache.view(pair.ls, dests, engine=engine)
    assert bump_log.get("decision.delta.fallbacks", 0) == 0
    engine.fault_hook = None
    again = cache.view(pair.ls, dests, engine=engine)
    assert again.warm_mode == "delta"


def _banded_view_inputs():
    from openr_tpu_torch.utils import topo
    from torch_parity import link_states

    ls, _ = link_states(topo.ring_topology(65))
    return ls, sorted(ls.node_names)[:8]


def test_kernel_fault_propagates_and_nothing_runs_in_its_place(monkeypatch):
    """The `kernel` gate fires before the wrapper: on the CPU the plain
    version the wrapper would call is never reached, and the view raises
    (the reference's Pallas gate demotes to XLA instead)."""
    from openr_tpu_torch.decision.fleet import FleetViewCache
    from openr_tpu_torch.ops import epilogue as ep

    calls = []
    real = ep.fused_epilogue_reference
    monkeypatch.setattr(ep, "fused_epilogue_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ls, dests = _banded_view_inputs()
    engine = DeviceResidencyEngine("cpu")
    engine.fault_hook = hook = Raise("kernel")
    with pytest.raises(RuntimeError, match="injected kernel"):
        FleetViewCache().view(ls, dests, engine=engine)
    assert "kernel" in hook.seen and calls == []
    assert engine.counters["device.engine.kernel_launches"] == 0
    engine.fault_hook = None
    view = FleetViewCache().view(ls, dests, engine=engine)
    assert view._runner.bg is not None and calls == [1]


@pytest.mark.cuda
def test_kernel_fault_launches_nothing_on_card():
    """On the card the injected fault leaves before K1's wrapper: its
    launch count does not move, and the retry launches it once (runs
    with `-m cuda` on a machine with an sm_90 card)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from openr_tpu_torch.decision.fleet import FleetViewCache
    from openr_tpu_torch.ops import epilogue as ep

    ls, dests = _banded_view_inputs()
    engine = DeviceResidencyEngine("cuda")
    engine.fault_hook = Raise("kernel")
    before = ep.fused_epilogue.launches
    with pytest.raises(RuntimeError, match="injected kernel"):
        FleetViewCache().view(ls, dests, engine=engine)
    assert ep.fused_epilogue.launches == before
    assert engine.counters["device.engine.kernel_launches"] == 0
    engine.fault_hook = None
    FleetViewCache().view(ls, dests, engine=engine)
    assert ep.fused_epilogue.launches == before + 1
    assert engine.counters["device.engine.kernel_launches.fused_epilogue"] == 1


@pytest.mark.parametrize("op", ["blocked_product", "blocked_round"])
def test_blocked_faults_propagate_through_the_parents_hook(op):
    from openr_tpu_torch.ops import allsources as asrc
    from openr_tpu_torch.parallel.blocked import BlockedApspEngine

    ls, csr = _square_csr()
    out = asrc.build_out_ell(csr.edge_src, csr.edge_dst, int(csr.n_edges), int(csr.n_nodes),
                             out_slot=csr.out_slot)
    dest_ids = np.arange(int(csr.n_nodes), dtype=np.int32)
    engine = DeviceResidencyEngine("cpu")
    engine.fault_hook = hook = Raise(op)
    with pytest.raises(RuntimeError, match=f"injected {op}"):
        engine.blocked.fleet_product(csr, dest_ids, out)
    assert engine.blocked.counters["mesh.blocked.products"] == 0
    assert hook.seen[0] == "blocked_product"
    # an engine-less rung takes its own hook
    alone = BlockedApspEngine(device="cpu")
    alone.fault_hook = Raise(op)
    with pytest.raises(RuntimeError, match=f"injected {op}"):
        alone.fleet_product(csr, dest_ids, out)


def _rewired_pair():
    """A chorded ring's mirror, resident, then one chord swapped: the
    next sync takes the rewire rung."""
    from openr_tpu_torch.chaos import OcsController
    from openr_tpu_torch.decision.csr import CsrTopology

    ctl = OcsController(seed=3, n=24, rounds=1, fault_round=-1)
    chords = ctl._initial_chords()
    ls = ctl._build_ls(chords, {})
    csr = CsrTopology.from_link_state(ls)
    engine = DeviceResidencyEngine("cpu")
    engine.sync(csr)
    chords.discard((0, 12))
    chords.add((0, 6))
    ctl._push(ls, chords, {})
    assert csr.refresh(ls)
    return ls, csr, engine


def test_only_the_hooks_exception_demotes_the_rewire_rung(monkeypatch):
    ls, csr, engine = _rewired_pair()
    engine.fault_hook = Raise("rewire")
    res = engine.sync(csr)
    c = engine.get_counters()
    assert c["device.engine.rewire_fallbacks"] == 1
    assert c["device.engine.full_restages"] == 2
    assert c["device.engine.rewire_dispatches"] == 0
    assert res.rewire_seq == csr.rewire_seq

    # any other exception of the replay propagates, nothing demoted
    ls, csr, engine = _rewired_pair()

    def broken(res, delta):
        raise ValueError("replay failed")

    monkeypatch.setattr(engine, "_apply_rewire", broken)
    with pytest.raises(ValueError, match="replay failed"):
        engine.sync(csr)
    assert engine.get_counters()["device.engine.rewire_fallbacks"] == 0
    assert engine.get_counters()["device.engine.full_restages"] == 1


def test_chaos_spf_backend_binds_the_engine_hook_on_the_references_schedule():
    from openr_tpu.chaos import ChaosSpfBackend as JChaos
    from types import SimpleNamespace

    verdicts = []
    for cls in (ChaosSpfBackend, JChaos):
        engine = SimpleNamespace(fault_hook=None)
        backend = cls(SimpleNamespace(engine=engine), seed=4, fail_prob=0.5)
        out = []
        for k in range(60):
            try:
                engine.fault_hook(("sync", "spf", "kernel")[k % 3])
                out.append("ok")
            except RuntimeError:
                out.append("fail")
        backend.disarm()
        engine.fault_hook("spf")
        verdicts.append((out, backend.log.streams()))
    port, ref = verdicts
    # the same draws; the reference names the kernel gate `pallas`
    assert port[0] == ref[0]
    assert [e.replace("engine:kernel", "x") for e in port[1]["spf"]] == [
        e.replace("engine:kernel", "x") for e in ref[1]["spf"]
    ]


class TestWaitTimeoutScale:
    def test_unarmed_default_is_identity(self, monkeypatch):
        from openr_tpu_torch.analysis import race

        monkeypatch.delenv("OPENR_CHAOS_TIMEOUT_SCALE", raising=False)
        monkeypatch.setattr(race, "TSAN", None)
        assert wait_timeout_scale() == 1.0

    def test_reads_the_ports_detector_never_the_references(self, monkeypatch):
        from openr_tpu.analysis import race as jrace
        from openr_tpu_torch.analysis import race

        monkeypatch.delenv("OPENR_CHAOS_TIMEOUT_SCALE", raising=False)
        monkeypatch.setattr(race, "TSAN", None)
        monkeypatch.setattr(jrace, "TSAN", object())
        assert wait_timeout_scale() == 1.0
        monkeypatch.setattr(race, "TSAN", object())
        assert wait_timeout_scale() == 3.0
        flip_at = time.monotonic() + 0.9
        assert wait_until(lambda: time.monotonic() >= flip_at, timeout_s=0.5)

    def test_env_override_wins_and_is_floored(self, monkeypatch):
        from openr_tpu_torch.analysis import race

        monkeypatch.setattr(race, "TSAN", None)
        monkeypatch.setenv("OPENR_CHAOS_TIMEOUT_SCALE", "5")
        assert wait_timeout_scale() == 5.0
        monkeypatch.setenv("OPENR_CHAOS_TIMEOUT_SCALE", "0.25")
        assert wait_timeout_scale() == 1.0


# -- live daemons over the chaos fabrics -------------------------------------


class ChaosRing:
    """tests/test_chaos.py's ChaosRing over the port's daemons on the
    CPU: a seeded ChaosIoProvider for Spark and an InProcessTransport
    with a seeded KvChaosInjector, all writing one ChaosEventLog."""

    def __init__(self, n: int, seed: int, *, kv_full_dump_fail: float = 0.0,
                 kv_armed: bool = False) -> None:
        self.n = n
        self.seed = seed
        self.log = ChaosEventLog()
        self.spark_fabric = ChaosIoProvider(seed=seed, log_=self.log)
        self.kv_fabric = InProcessTransport()
        self.kv_chaos = KvChaosInjector(seed, full_dump_fail=kv_full_dump_fail, log_=self.log)
        if not kv_armed:
            self.kv_chaos.disarm()
        self.kv_fabric.set_chaos(self.kv_chaos)
        self.daemons = [self._build(i) for i in range(n)]
        for daemon in self.daemons:
            daemon.start()
        for i in range(n):
            j = (i + 1) % n
            if n == 2 and i == 1:
                break
            self.spark_fabric.connect(f"openr-{i}", f"if-{i}-{j}", f"openr-{j}", f"if-{j}-{i}")
        for i in range(n):
            self._push_link_events(i)

    def _build(self, i: int) -> OpenrDaemon:
        name = f"openr-{i}"
        addr = f"fe80::{name}"
        daemon = OpenrDaemon(
            fleet_node_config(name),
            io_provider=self.spark_fabric.endpoint(name),
            kvstore_transport=self.kv_fabric.bind(addr),
            spark_v6_addr=addr,
            device="cpu",
        )
        self.kv_fabric.register(addr, daemon.kvstore)
        return daemon

    def _push_link_events(self, i: int) -> None:
        j, k = (i + 1) % self.n, (i - 1) % self.n
        daemon = self.daemons[i]
        daemon.netlink_events_queue.push(LinkEvent(f"if-{i}-{j}", 1, True))
        if self.n > 2:
            daemon.netlink_events_queue.push(LinkEvent(f"if-{i}-{k}", 2, True))

    def advertise_loopbacks(self) -> None:
        for i, daemon in enumerate(self.daemons):
            daemon.prefix_manager.advertise_prefixes(
                PrefixType.LOOPBACK, [PrefixEntry(prefix=f"fc00:{i}::/64")]
            )

    def prefix_exists(self, daemon, prefix: str) -> bool:
        return normalize_prefix(prefix) in daemon.fib_agent.unicast.get(FIB_CLIENT, {})

    def full_mesh(self) -> bool:
        return all(
            self.prefix_exists(d, f"fc00:{j}::/64")
            for i, d in enumerate(self.daemons) for j in range(self.n) if i != j
        )

    def respawn(self, i: int):
        old = self.daemons[i]
        for _ in range(3):
            old.spark.flood_restarting_msg()
        old.stop()
        daemon = self._build(i)
        self.daemons[i] = daemon
        daemon.start()
        self._push_link_events(i)
        daemon.prefix_manager.advertise_prefixes(
            PrefixType.LOOPBACK, [PrefixEntry(prefix=f"fc00:{i}::/64")]
        )
        return daemon

    def stop(self) -> None:
        for daemon in self.daemons:
            daemon.stop()


def _in_decision(daemon, fn):
    return daemon.decision.run_in_event_base_thread(fn).result()


def test_device_fault_surfaces_counted_and_the_rebuild_after_disarm_programs():
    """tests/test_chaos.py's host demotion, as the port's contract: every
    device dispatch fails through the engine's hook, the rebuild failure
    is counted, the solver keeps its device backend, the advertised
    prefix waits in the pending updates, and the first rebuild after
    `disarm()` programs the host oracle's routes."""
    ring = ChaosRing(2, seed=42)
    try:
        ring.advertise_loopbacks()
        assert wait_until(ring.full_mesh, 30)
        d0 = ring.daemons[0]
        solver = d0.decision.spf_solver
        device_backend = solver.spf
        backend = ChaosSpfBackend(device_backend, seed=1, fail_prob=1.0, log_=ring.log)
        _in_decision(d0, lambda: setattr(solver, "spf", backend))
        failures0 = d0.decision.get_counters()["decision.route_rebuild_failures"]
        ring.daemons[1].prefix_manager.advertise_prefixes(
            PrefixType.LOOPBACK, [PrefixEntry(prefix="fc00:99::/64")]
        )
        assert wait_until(
            lambda: d0.decision.get_counters()["decision.route_rebuild_failures"] > failures0, 30
        )
        assert not ring.prefix_exists(d0, "fc00:99::/64")
        assert ring.log.streams()["spf"][0].endswith(":fail")
        assert solver.spf is backend and backend.inner is device_backend
        assert _in_decision(d0, lambda: d0.decision.pending_updates.needs_route_update())
        writes = d0.route_updates_queue.get_num_writes()
        backend.disarm()
        # the next publication triggers the first rebuild after disarm
        ring.daemons[1].prefix_manager.advertise_prefixes(
            PrefixType.LOOPBACK, [PrefixEntry(prefix="fc00:98::/64")]
        )
        assert wait_until(lambda: ring.prefix_exists(d0, "fc00:99::/64"), 30)
        assert ring.prefix_exists(d0, "fc00:98::/64") or wait_until(
            lambda: ring.prefix_exists(d0, "fc00:98::/64"), 30)
        assert d0.route_updates_queue.get_num_writes() > writes
        assert d0.route_updates_queue.stats()["overflows"] == 0
        assert hold_converged([d0], 30), (fib_unicast_routes(d0), oracle_route_dbs(d0))
    finally:
        ring.stop()


def test_rebuild_failure_keeps_the_publication_for_the_next_rebuild():
    ring = ChaosRing(2, seed=43)
    try:
        ring.advertise_loopbacks()
        assert wait_until(ring.full_mesh, 30)
        d0 = ring.daemons[0]
        solver = d0.decision.spf_solver
        orig = solver.create_route_for_prefix_or_get_static_route
        state = {"armed": True}

        def flaky(*args, **kwargs):
            if state["armed"]:
                state["armed"] = False
                raise RuntimeError("injected rebuild failure")
            return orig(*args, **kwargs)

        _in_decision(d0, lambda: setattr(
            solver, "create_route_for_prefix_or_get_static_route", flaky))
        ring.daemons[1].prefix_manager.advertise_prefixes(
            PrefixType.LOOPBACK, [PrefixEntry(prefix="fc00:9::/64")]
        )
        assert wait_until(
            lambda: d0.decision.get_counters()["decision.route_rebuild_failures"] >= 1, 30)
        ring.daemons[1].prefix_manager.advertise_prefixes(
            PrefixType.LOOPBACK, [PrefixEntry(prefix="fc00:8::/64")]
        )
        assert wait_until(lambda: ring.prefix_exists(d0, "fc00:9::/64"), 30)
        assert wait_until(lambda: ring.prefix_exists(d0, "fc00:8::/64"), 30)
        assert hold_converged([d0], 30)
    finally:
        ring.stop()


def test_fib_sync_retries_with_backoff_then_recovery():
    ring = ChaosRing(2, seed=44)
    try:
        ring.advertise_loopbacks()
        assert wait_until(ring.full_mesh, 30)
        d0 = ring.daemons[0]
        d0.fib_agent.chaos = FibChaosPlan(
            3, fail_prob=1.0, fail_ops={"add_unicast_routes", "sync_fib"}, log_=ring.log
        )
        ring.daemons[1].prefix_manager.advertise_prefixes(
            PrefixType.LOOPBACK, [PrefixEntry(prefix="fc00:55::/64")]
        )
        assert wait_until(lambda: d0.fib.counters.get("fib.sync_retries", 0) >= 2, 30)
        d0.fib_agent.chaos.disarm()
        assert wait_until(lambda: ring.prefix_exists(d0, "fc00:55::/64"), 30)
        assert ring.log.streams()["fib"][0] == "0:add_unicast_routes:fail"
    finally:
        ring.stop()


def test_kvstore_full_sync_retries_then_recovery():
    ring = ChaosRing(2, seed=45, kv_full_dump_fail=1.0, kv_armed=True)
    try:
        assert wait_until(
            lambda: ring.daemons[0].kvstore.get_counters().get("kvstore.full_sync_retries", 0) >= 1,
            30,
        )
        ring.kv_chaos.disarm()
        ring.advertise_loopbacks()
        assert wait_until(ring.full_mesh, 30)
        assert any(s.startswith("kv:full_dump:") for s in ring.log.streams())
    finally:
        ring.stop()


def _thrift_counters(port: int) -> dict:
    from openr_tpu_torch.interop import thrift_binary as tb

    with socket.create_connection(("::1", port), timeout=30) as sock:
        sock.sendall(tb.frame(tb.encode_message("getCounters", tb.MSG_CALL, 1, b"\x00")))
        head = b""
        while len(head) < 4:
            head += sock.recv(4 - len(head))
        (length,) = struct.unpack("!i", head)
        data = b""
        while len(data) < length:
            data += sock.recv(length - len(data))
    _name, mtype, _seqid, body = tb.decode_message(data)
    assert mtype == tb.MSG_REPLY
    spec = tb.StructSpec("result", None, (tb.Field(
        0, "success", ("map", tb.T_STRING, tb.T_I64),
        dec=lambda m: {k.decode(): v for k, v in m.items()},
    ),))
    return tb.read_struct(body, spec)["success"]


def test_daemon_answers_the_fuzz_family_on_both_wires():
    """The daemon's `fuzz` surface: the six pre-seeded `chaos.fuzz.*`
    keys over ctrl and through the Thrift shim, live-valued."""
    from openr_tpu_torch.chaos.fuzz import FUZZ_COUNTER_KEYS, FUZZ_COUNTERS
    from openr_tpu_torch.ctrl import CtrlClient
    from openr_tpu_torch.spark import MockIoProvider

    cfg = fleet_node_config("fuzz-0")
    cfg.thrift_shim_port = -1
    d = OpenrDaemon(cfg, io_provider=MockIoProvider().endpoint("fuzz-0"), device="cpu")
    d.start()
    try:
        with CtrlClient("::1", d.ctrl_port) as client:
            ctrl = client.call("getCounters")
        shim = _thrift_counters(d.thrift_shim.port)
    finally:
        d.stop()
    want = FUZZ_COUNTERS.get_counters()
    assert set(want) == set(FUZZ_COUNTER_KEYS)
    for counters in (ctrl, shim):
        assert {k: counters[k] for k in FUZZ_COUNTER_KEYS} == want


# -- the scripted multi-node scenario ----------------------------------------


def run_chaos_scenario(seed: int):
    """tests/test_chaos.py's run_chaos_scenario over the port's daemons:
    returns (log, converged, tables, oracle)."""
    ring = ChaosRing(4, seed, kv_full_dump_fail=0.25)
    scenario = ChaosScenario(log_=ring.log)
    try:
        scenario.step("advertise-loopbacks", ring.advertise_loopbacks)
        ok = scenario.wait("initial-convergence", ring.full_mesh, 30)
        scenario.step(
            "lossy-link-0-1",
            lambda: ring.spark_fabric.set_link_profile(
                "openr-0", "openr-1", drop=0.2, dup=0.1, reorder=0.1, jitter_s=0.005),
        )
        scenario.step("kv-chaos-on", ring.kv_chaos.arm)
        scenario.step(
            "flap-0-1-down",
            lambda: ring.spark_fabric.disconnect("openr-0", "if-0-1", "openr-1", "if-1-0"),
        )

        def rerouted() -> bool:
            route = ring.daemons[0].fib_agent.unicast.get(FIB_CLIENT, {}).get(
                normalize_prefix("fc00:1::/64"))
            return route is not None and {
                nh.neighbor_node_name for nh in route.next_hops} == {"openr-3"}

        ok &= scenario.wait("rerouted-around-0-1", rerouted, 30)
        scenario.step(
            "kv-partition-1-2",
            lambda: ring.kv_fabric.set_partitioned("fe80::openr-1", "fe80::openr-2", True),
        )
        scenario.step(
            "fib-chaos-node-2",
            lambda: setattr(ring.daemons[2].fib_agent, "chaos", FibChaosPlan(
                seed, fail_prob=0.25, restart_prob=0.1, log_=ring.log, stream="fib:openr-2")),
        )
        scenario.step("ttl-storm", lambda: ring.kv_chaos.ttl_storm(ring.daemons[1].kvstore))
        scenario.step(
            "prefix-churn",
            lambda: ring.daemons[1].prefix_manager.advertise_prefixes(
                PrefixType.LOOPBACK, [PrefixEntry(prefix="fc00:33::/64")]),
        )
        scenario.step(
            "flap-0-1-up",
            lambda: ring.spark_fabric.connect("openr-0", "if-0-1", "openr-1", "if-1-0"),
        )
        scenario.step("restart-daemon-3", lambda: ring.respawn(3))

        def heal() -> None:
            ring.spark_fabric.clear_all_profiles()
            ring.kv_chaos.disarm()
            ring.kv_fabric.set_partitioned("fe80::openr-1", "fe80::openr-2", False)
            plan = ring.daemons[2].fib_agent.chaos
            if plan is not None:
                plan.disarm()

        scenario.step("heal", heal)
        ok &= scenario.wait("post-heal-mesh", ring.full_mesh, 45)
        ok &= scenario.wait_converged(ring.daemons, 45)
        tables = {d.config.node_name: fib_unicast_routes(d) for d in ring.daemons}
        oracle = {d.config.node_name: oracle_route_dbs(d) for d in ring.daemons}
        return ring.log, ok, tables, oracle
    finally:
        ring.stop()


# the reference's scripted timeline, as its scenario stream reads after a
# converged run (tests/test_chaos.py's steps and waits, in order)
SCENARIO_STEPS = [
    "advertise-loopbacks", "initial-convergence:ok", "lossy-link-0-1", "kv-chaos-on",
    "flap-0-1-down", "rerouted-around-0-1:ok", "kv-partition-1-2", "fib-chaos-node-2",
    "ttl-storm", "prefix-churn", "flap-0-1-up", "restart-daemon-3", "heal",
    "post-heal-mesh:ok", "converged:ok",
]


def test_scenario_converges_to_oracle_and_replays():
    seed = 20260805
    log1, ok1, tables1, oracle1 = run_chaos_scenario(seed)
    assert ok1, log1.scenario()
    assert log1.scenario() == SCENARIO_STEPS
    assert tables1 == oracle1
    assert len(tables1) == 4 and all(tables1.values())
    log2, ok2, tables2, oracle2 = run_chaos_scenario(seed)
    assert ok2, log2.scenario()
    assert tables2 == oracle2
    assert log1.matches(log2), (log1.streams(), log2.streams())
    assert tables1 == tables2


@pytest.mark.slow
def test_randomized_soak(cpu_burner):
    seed = int(os.environ.get("OPENR_CHAOS_SEED", random.SystemRandom().randrange(2**31)))
    try:
        log, ok, tables, oracle = run_chaos_scenario(seed)
        assert ok, log.scenario()
        assert tables == oracle
    except AssertionError as exc:
        raise AssertionError(
            f"chaos soak failed; replay with OPENR_CHAOS_SEED={seed}: {exc}") from exc
