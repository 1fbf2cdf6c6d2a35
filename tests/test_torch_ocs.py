"""The port's OCS reconfiguration chaos (`openr_tpu_torch.chaos.ocs`)
against `openr_tpu.chaos.ocs`, on the CPU.

Oracle: tests/test_ocs.py.  The same seed drives both controllers over
the same chorded ring: the swaps, flaps and the mid-rewire fault replay
into equal scenario logs, the engines' rewire accounting is equal
(every bounded swap on the rewire rung, the fault demoting one round to
a restage), every round and the post-heal sweep are bit-exact against
the host Dijkstra in both, and the engine's hook sees the reference's
op sequence.  Daemon-level rewires converge to the host oracle through
the hold-based wait.
"""

from __future__ import annotations

import os
import random

import pytest

from openr_tpu.chaos import ChaosEventLog as JLog
from openr_tpu.chaos import OcsController as JOcs
from openr_tpu_torch.chaos import ChaosEventLog, ChaosScenario, OcsController
from openr_tpu_torch.chaos.scenario import fib_unicast_routes, oracle_route_dbs
from openr_tpu_torch.types import LinkEvent

pytestmark = pytest.mark.chaos

COUNTS = ("rounds", "rewires", "rewire_dispatches", "rewire_fallbacks", "full_restages",
          "flaps", "links_swapped", "bit_exact", "round_exact")


@pytest.fixture(scope="module")
def ocs_pair():
    log, jlog = ChaosEventLog(), JLog()
    port = OcsController(seed=11, log_=log, device="cpu").run()
    ref = JOcs(seed=11, log_=jlog).run()
    return port, log, ref, jlog


def test_counts_and_logs_are_the_references(ocs_pair):
    port, log, ref, jlog = ocs_pair
    assert {k: getattr(port, k) for k in COUNTS} == {k: getattr(ref, k) for k in COUNTS}
    assert log.scenario() == jlog.scenario()
    assert log.streams() == jlog.streams()


def test_rolling_rewires_ride_the_rewire_rung(ocs_pair):
    port, *_ = ocs_pair
    assert port.rewires == port.rounds - 1
    assert port.rewire_dispatches == port.rounds - 1
    assert port.rewire_fallbacks == 1
    assert port.full_restages == 2
    assert port.links_swapped == 2 * port.rounds
    assert port.counters["device.engine.rewire_bytes_staged"] > 0


def test_bit_exact_every_round_and_post_heal(ocs_pair):
    port, log, *_ = ocs_pair
    assert port.bit_exact and all(port.round_exact), port.round_exact
    events = log.scenario()
    assert any(e.startswith("ocs:fault:armed:") for e in events)
    assert any(e.startswith("ocs:fault:fired:") for e in events)
    assert events[-1] == "ocs:settled:exact"


def test_same_seed_replays_and_another_diverges(ocs_pair):
    _, log, *_ = ocs_pair
    again, other = ChaosEventLog(), ChaosEventLog()
    OcsController(seed=11, log_=again, device="cpu").run()
    OcsController(seed=12, log_=other, device="cpu").run()
    assert log.matches(again)
    assert not log.matches(other)


def test_unfaulted_run_keeps_single_restage():
    kw = dict(seed=3, n=24, rounds=6, fault_round=-1)
    port, ref = OcsController(device="cpu", **kw).run(), JOcs(**kw).run()
    assert port.bit_exact and ref.bit_exact
    assert port.full_restages == ref.full_restages == 1
    assert port.rewire_fallbacks == 0 and port.rewires == ref.rewires == 6


def _hook_ops(pkg: str) -> list:
    """The ops the engine's hook sees over a query, a chord swap (the
    rewire rung), a metric flap (the attribute rung), a second query and
    a generic dispatch, in package `pkg`."""
    if pkg == "port":
        from openr_tpu_torch.decision.csr import CsrTopology
        from openr_tpu_torch.device.engine import DeviceResidencyEngine

        ctl, engine = OcsController(seed=3, n=24), DeviceResidencyEngine("cpu")
    else:
        from openr_tpu.decision.csr import CsrTopology
        from openr_tpu.device import DeviceResidencyEngine

        ctl, engine = JOcs(seed=3, n=24), DeviceResidencyEngine()
    chords = ctl._initial_chords()
    ls = ctl._build_ls(chords, {})
    csr = CsrTopology.from_link_state(ls)
    seen = []
    engine.fault_hook = seen.append
    engine.spf_results(csr, ls.node_names[:2])
    chords.discard((0, 12))
    chords.add((0, 6))
    ctl._push(ls, chords, {})
    assert csr.refresh(ls)
    engine.spf_results(csr, ls.node_names[:2])
    ctl._push(ls, chords, {5: 70})
    csr.refresh(ls)
    engine.spf_results(csr, ls.node_names[3:4])
    engine.dispatch("fleet_product", lambda: None)
    return seen


def test_hook_sees_the_references_op_sequence():
    port = _hook_ops("port")
    assert port == _hook_ops("ref")
    assert port == ["spf", "sync", "spf", "sync", "rewire", "spf", "sync", "fleet_product"]


# -- daemon-level rewires -----------------------------------------------------


def _chord_events(ring, a: int, b: int, *, up: bool, if_index: int) -> None:
    ring.daemons[a].netlink_events_queue.push(LinkEvent(f"if-{a}-{b}", if_index, up))
    ring.daemons[b].netlink_events_queue.push(LinkEvent(f"if-{b}-{a}", if_index, up))


def run_daemon_rewires(seed: int, rounds: int = 2):
    """tests/test_ocs.py's run_daemon_rewires over the port's daemons."""
    from test_torch_chaos import ChaosRing

    ring = ChaosRing(4, seed=seed)
    try:
        ring.advertise_loopbacks()
        scenario = ChaosScenario(ring.log)
        ok = scenario.wait("initial-mesh", ring.full_mesh, 45)
        ok &= scenario.wait_converged(ring.daemons, 45)
        for r in range(rounds):
            scenario.step(f"ocs:connect:0-2:{r}", lambda: ring.spark_fabric.connect(
                "openr-0", "if-0-2", "openr-2", "if-2-0"))
            _chord_events(ring, 0, 2, up=True, if_index=7)
            ok &= scenario.wait_converged(ring.daemons, 45)
            scenario.step(f"ocs:retire:1-2:{r}", lambda: ring.spark_fabric.disconnect(
                "openr-1", "if-1-2", "openr-2", "if-2-1"))
            ok &= scenario.wait_converged(ring.daemons, 45)
            scenario.step(f"ocs:heal:{r}", lambda: ring.spark_fabric.connect(
                "openr-1", "if-1-2", "openr-2", "if-2-1"))
            scenario.step(f"ocs:unprogram:0-2:{r}", lambda: ring.spark_fabric.disconnect(
                "openr-0", "if-0-2", "openr-2", "if-2-0"))
            _chord_events(ring, 0, 2, up=False, if_index=7)
            ok &= scenario.wait_converged(ring.daemons, 45)
        ok &= scenario.wait("post-heal-mesh", ring.full_mesh, 45)
        tables = {d.config.node_name: fib_unicast_routes(d) for d in ring.daemons}
        oracle = {d.config.node_name: oracle_route_dbs(d) for d in ring.daemons}
        return ring.log, ok, tables, oracle
    finally:
        ring.stop()


def test_rolling_circuit_swaps_converge_bit_exact():
    log, ok, tables, oracle = run_daemon_rewires(seed=20260805)
    assert ok, log.scenario()
    assert tables == oracle
    assert len(tables) == 4 and all(tables.values())
    assert log.scenario().count("converged:ok") == 7


@pytest.mark.slow
def test_randomized_rewire_soak_under_cpu_burn(cpu_burner):
    seed = int(os.environ.get("OPENR_OCS_SEED", random.SystemRandom().randrange(2**31)))
    try:
        log, ok, tables, oracle = run_daemon_rewires(seed, rounds=4)
        assert ok, log.scenario()
        assert tables == oracle
        result = OcsController(seed=seed, rounds=16, device="cpu").run()
        assert result.bit_exact
        assert result.rewire_fallbacks == 1
    except AssertionError as exc:
        raise AssertionError(
            f"ocs soak failed; replay with OPENR_OCS_SEED={seed}: {exc}") from exc


def test_fleet_view_converges_past_the_references_block_budget():
    """The controller's unrewired ring at 6 000 nodes (chords all spanning
    half of it) needs more than the reference's 64 blocks of 4
    supersweeps; the port's banded relax runs up to n and converges, its
    distances and next hops the host Dijkstra's."""
    import numpy as np

    from openr_tpu_torch.decision.csr import CsrTopology
    from openr_tpu_torch.decision.fleet import FleetViewCache
    from openr_tpu_torch.decision.link_state import LinkState
    from openr_tpu_torch.device.engine import DeviceResidencyEngine

    class Ring(OcsController):
        def _name(self, i: int) -> str:
            return f"w{i % self.n:06d}"

    n = 6000
    ctl = Ring(seed=13, n=n)
    by_node = [set() for _ in range(n)]
    for a, b in ctl._initial_chords():
        by_node[a].add((a, b))
        by_node[b].add((a, b))
    ls = LinkState("0")
    for i in range(n):
        ls.update_adjacency_database(ctl._node_db(i, by_node[i], {}))
    dests = [ctl._name(int(i)) for i in np.random.default_rng(7).choice(n, 4, replace=False)]
    engine = DeviceResidencyEngine("cpu")
    view = FleetViewCache().view(ls, dests, csr=CsrTopology.from_link_state(ls), engine=engine)
    assert view._runner.bg is not None and view.sweep_hint > 64 * 4
    for router in ls.node_names[:: n // 5]:
        want = ls.run_spf(router)
        for t in dests:
            assert view.dist(router, t) == want[t].metric
            assert view.next_hop_neighbors(router, t) == want[t].next_hops
