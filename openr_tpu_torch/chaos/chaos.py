"""Deterministic fault injectors: one seed, replayable schedules.

Port of `openr_tpu.chaos.chaos`.  Every stream is seeded exactly as the
reference seeds it (`random.Random(f"{seed}:...")`), so one seed gives
the same schedule, the same verdicts and the same `ChaosEventLog` in
both packages.

Every injector derives an independent `random.Random` stream per fault
site (directed link, transport edge, agent) from the master seed, so
thread interleaving across sites cannot perturb any one site's decision
sequence: the k-th packet on link A->B sees the same verdict in every
run with the same seed, regardless of what other links are doing.

The `ChaosEventLog` mirrors that structure — one ordered stream per
fault site plus a "scenario" stream for timeline steps — because a
single global ordering would depend on thread scheduling and defeat
replay comparison.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Optional

from ..spark.io_provider import MockIoProvider

log = logging.getLogger(__name__)

SCENARIO_STREAM = "scenario"


class ChaosEventLog:
    """Per-stream ordered fault record.

    Within a stream the entry order is the decision order — a pure
    function of the seed and the per-site event index.  Across streams
    no order is defined (delivery threads interleave freely), which is
    why `matches` compares stream-by-stream: the scenario stream must
    be identical, fault streams must agree on their common prefix (two
    runs may observe different packet COUNTS — timers drift — but the
    k-th decision at a site is seed-determined)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._streams: dict[str, list[str]] = {}

    def append(self, stream: str, event: str) -> None:
        with self._lock:
            self._streams.setdefault(stream, []).append(event)

    def streams(self) -> dict[str, list[str]]:
        with self._lock:
            return {k: list(v) for k, v in self._streams.items()}

    def scenario(self) -> list[str]:
        with self._lock:
            return list(self._streams.get(SCENARIO_STREAM, []))

    def matches(self, other: "ChaosEventLog") -> bool:
        a, b = self.streams(), other.streams()
        if a.get(SCENARIO_STREAM, []) != b.get(SCENARIO_STREAM, []):
            return False
        for stream in set(a) & set(b):
            ea, eb = a[stream], b[stream]
            n = min(len(ea), len(eb))
            if ea[:n] != eb[:n]:
                return False
        return True


@dataclass
class LinkFaultProfile:
    """Per-directed-link fault rates; all decisions seed-driven."""

    drop: float = 0.0  # P(packet silently dropped)
    dup: float = 0.0  # P(packet delivered twice)
    reorder: float = 0.0  # P(packet delayed past later traffic)
    delay_s: float = 0.0  # fixed extra one-way delay
    jitter_s: float = 0.0  # uniform extra delay in [0, jitter_s)
    reorder_delay_s: float = 0.08  # how far a reordered packet slips


class ChaosIoProvider(MockIoProvider):
    """MockIoProvider with seeded per-link drop/dup/reorder/delay faults
    and node-pair partitions, all replayable from one seed.

    Profiles key on (src node, dst node) — every interface pair between
    the two nodes shares the schedule, which keeps the fault streams
    stable when a test rewires interfaces."""

    def __init__(
        self, seed: int = 0, log_: Optional[ChaosEventLog] = None
    ) -> None:
        super().__init__()
        self.seed = seed
        self.log = log_ or ChaosEventLog()
        self._chaos_lock = threading.Lock()
        self._profiles: dict[tuple[str, str], LinkFaultProfile] = {}
        self._chaos_partitions: set[frozenset[str]] = set()
        self._rngs: dict[tuple[str, str], random.Random] = {}
        self._pkt_index: dict[tuple[str, str], int] = {}

    # -- schedule configuration ---------------------------------------------

    def set_link_profile(
        self,
        node_a: str,
        node_b: str,
        profile: Optional[LinkFaultProfile] = None,
        *,
        symmetric: bool = True,
        **rates,
    ) -> None:
        profile = profile or LinkFaultProfile(**rates)
        with self._chaos_lock:
            self._profiles[(node_a, node_b)] = profile
            if symmetric:
                self._profiles[(node_b, node_a)] = profile

    def clear_link_profile(
        self, node_a: str, node_b: str, *, symmetric: bool = True
    ) -> None:
        with self._chaos_lock:
            self._profiles.pop((node_a, node_b), None)
            if symmetric:
                self._profiles.pop((node_b, node_a), None)

    def clear_all_profiles(self) -> None:
        with self._chaos_lock:
            self._profiles.clear()
            self._chaos_partitions.clear()

    def set_partitioned(
        self, node_a: str, node_b: str, partitioned: bool
    ) -> None:
        """Hard partition: every packet between the two nodes vanishes
        (the spark-fabric analogue of InProcessTransport partitions)."""
        key = frozenset((node_a, node_b))
        with self._chaos_lock:
            if partitioned:
                self._chaos_partitions.add(key)
            else:
                self._chaos_partitions.discard(key)

    # -- fault decisions -----------------------------------------------------

    def _link_rng(self, src_node: str, dst_node: str) -> random.Random:
        key = (src_node, dst_node)
        rng = self._rngs.get(key)
        if rng is None:
            rng = random.Random(f"{self.seed}:{src_node}->{dst_node}")
            self._rngs[key] = rng
        return rng

    def _plan_delivery(self, src_node: str, dst_node: str) -> list[float]:
        """Extra delays for each delivered copy of one packet; [] drops
        it.  One ordered decision stream per directed node pair.

        The packet index (and the RNG) only advances for PROFILED
        packets: partitioned or unprofiled traffic is timing-dependent
        in count, and letting it consume draws would shift every later
        verdict between two same-seed runs.  Keyed this way, the k-th
        profiled packet on a link sees the same fate in every replay."""
        stream = f"link:{src_node}->{dst_node}"
        with self._chaos_lock:
            if frozenset((src_node, dst_node)) in self._chaos_partitions:
                return []
            prof = self._profiles.get((src_node, dst_node))
            if prof is None:
                return [0.0]
            k = self._pkt_index.get((src_node, dst_node), 0)
            self._pkt_index[(src_node, dst_node)] = k + 1
            rng = self._link_rng(src_node, dst_node)
            if prof.drop > 0 and rng.random() < prof.drop:
                self.log.append(stream, f"{k}:drop")
                return []
            delay = prof.delay_s
            if prof.jitter_s > 0:
                delay += rng.random() * prof.jitter_s
            plan = [delay]
            events = []
            if prof.reorder > 0 and rng.random() < prof.reorder:
                plan[0] += prof.reorder_delay_s
                events.append("reorder")
            if prof.dup > 0 and rng.random() < prof.dup:
                plan.append(delay + prof.reorder_delay_s * rng.random())
                events.append("dup")
            if events:
                self.log.append(stream, f"{k}:{'+'.join(events)}")
        return plan

    def _deliver(self, src: tuple[str, str], data: bytes) -> None:
        with self._lock:
            targets = [
                (self._endpoints.get(dst), dst, latency)
                for dst, latency in self._links.get(src, [])
            ]
        for ep, dst, latency in targets:
            if ep is None:
                continue
            for extra in self._plan_delivery(src[0], dst[0]):
                ep._enqueue_after(
                    latency + extra, dst[1], data, f"fe80::{src[0]}"
                )


class FibChaosPlan:
    """Seeded failure schedule for MockFibAgent: per-call program/sync
    errors and spontaneous agent restarts, replayable from the seed.

    The agent consults `on_call(op)` before every thrift-surface call;
    ops draw from ONE stream in call order — deterministic because a
    Fib instance serializes agent calls on its event-base thread."""

    FAIL = "fail"
    RESTART = "restart"
    OK = "ok"

    def __init__(
        self,
        seed: int = 0,
        *,
        fail_prob: float = 0.0,
        restart_prob: float = 0.0,
        fail_ops: Optional[set[str]] = None,
        log_: Optional[ChaosEventLog] = None,
        stream: str = "fib",
    ) -> None:
        self.fail_prob = fail_prob
        self.restart_prob = restart_prob
        self.fail_ops = fail_ops
        self.log = log_ or ChaosEventLog()
        self.stream = stream
        self.armed = True
        self._rng = random.Random(f"{seed}:{stream}")
        self._call_index = 0
        self._lock = threading.Lock()

    def disarm(self) -> None:
        self.armed = False

    def arm(self) -> None:
        self.armed = True

    def on_call(self, op: str) -> str:
        with self._lock:
            if not self.armed:
                return self.OK
            if self.fail_ops is not None and op not in self.fail_ops:
                return self.OK
            k = self._call_index
            self._call_index += 1
            u = self._rng.random()
            if u < self.restart_prob:
                self.log.append(self.stream, f"{k}:{op}:restart")
                return self.RESTART
            if u < self.restart_prob + self.fail_prob:
                self.log.append(self.stream, f"{k}:{op}:fail")
                return self.FAIL
            return self.OK


class KvChaosInjector:
    """Seeded failures on the in-process KvStore transport: flood/full-
    sync request errors per directed store pair, plus stale-TTL storms.

    Wire with `InProcessTransport.set_chaos(injector)`; each bound
    transport call passes (op, src addr, dst addr) and the injector
    raises the transport's error type when the seeded draw says so."""

    def __init__(
        self,
        seed: int = 0,
        *,
        full_dump_fail: float = 0.0,
        key_set_fail: float = 0.0,
        log_: Optional[ChaosEventLog] = None,
    ) -> None:
        self.seed = seed
        self.full_dump_fail = full_dump_fail
        self.key_set_fail = key_set_fail
        self.log = log_ or ChaosEventLog()
        self.armed = True
        self._lock = threading.Lock()
        self._rngs: dict[str, random.Random] = {}
        self._indices: dict[str, int] = {}

    def disarm(self) -> None:
        self.armed = False

    def arm(self) -> None:
        self.armed = True

    def check(self, op: str, src: str, dst: str) -> None:
        """Raises TransportError when the seeded schedule fails this
        call; called by _BoundInProcessTransport before dispatch."""
        prob = {
            "full_dump": self.full_dump_fail,
            "key_set": self.key_set_fail,
        }.get(op, 0.0)
        if prob <= 0:
            return
        stream = f"kv:{op}:{src}->{dst}"
        with self._lock:
            if not self.armed:
                return
            k = self._indices.get(stream, 0)
            self._indices[stream] = k + 1
            rng = self._rngs.get(stream)
            if rng is None:
                rng = random.Random(f"{self.seed}:{stream}")
                self._rngs[stream] = rng
            failed = rng.random() < prob
            if failed:
                self.log.append(stream, f"{k}:fail")
        if failed:
            from ..kvstore.kvstore import TransportError

            raise TransportError(f"injected {op} failure {src}->{dst}")

    def ttl_storm(
        self,
        kvstore,
        area: str = "0",
        n_keys: int = 16,
        ttl_ms: int = 120,
    ) -> list[str]:
        """Stale-TTL storm: flood `n_keys` seeded keys that expire almost
        immediately, exercising the TTL countdown/eviction machinery
        network-wide (every store must age them out consistently)."""
        from ..types import Value

        rng = random.Random(f"{self.seed}:ttl-storm")
        keys = []
        key_vals = {}
        for i in range(n_keys):
            key = f"chaos-ttl-{i}"
            keys.append(key)
            key_vals[key] = Value(
                version=1,
                originator_id="chaos",
                value=rng.randbytes(8),
                ttl_ms=ttl_ms,
            )
        kvstore.set_key_vals(area, key_vals)
        self.log.append("kv:ttl-storm", f"storm:{n_keys}:{ttl_ms}ms")
        return keys


class ChaosSpfBackend:
    """SpfBackend decorator that injects device-dispatch failures on a
    seeded schedule.

    Forwards the full backend surface (including the optional
    csr_mirror/prefetch attributes the solver probes with getattr) and
    raises before delegating when the schedule says so.  The reference
    uses it to prove its Decision's demotion to the host oracle; the
    port has no such demotion: the injected failure leaves the route
    build, Decision counts it (`decision.route_rebuild_failures`) and
    keeps its pending updates, and the first rebuild after `disarm()`
    programs the routes."""

    def __init__(
        self,
        inner,
        seed: int = 0,
        *,
        fail_prob: float = 0.0,
        fail_ops: Optional[set[str]] = None,
        log_: Optional[ChaosEventLog] = None,
    ) -> None:
        self.inner = inner
        self.fail_prob = fail_prob
        self.fail_ops = fail_ops
        self.log = log_ or ChaosEventLog()
        self.armed = True
        self._rng = random.Random(f"{seed}:spf")
        self._lock = threading.Lock()
        self._call_index = 0
        # device-residency engine seam: faults fire INSIDE the engine's
        # entry points (sync/spf/dispatch/kernel), so an injected failure
        # takes the path a real device fault would
        engine = getattr(inner, "engine", None)
        if engine is not None:
            engine.fault_hook = lambda op: self._gate(f"engine:{op}")

    def disarm(self) -> None:
        self.armed = False

    def _gate(self, op: str) -> None:
        with self._lock:
            if not self.armed:
                return
            if self.fail_ops is not None and op not in self.fail_ops:
                return
            k = self._call_index
            self._call_index += 1
            if self._rng.random() < self.fail_prob:
                self.log.append("spf", f"{k}:{op}:fail")
                raise RuntimeError(f"injected device dispatch failure: {op}")

    def get_spf_result(self, link_state, src):
        self._gate("get_spf_result")
        return self.inner.get_spf_result(link_state, src)

    def get_kth_paths(self, link_state, src, dest, k):
        self._gate("get_kth_paths")
        return self.inner.get_kth_paths(link_state, src, dest, k)

    def __getattr__(self, name):
        # csr_mirror / prefetch* / min_device_* probe-through, gated the
        # same way so fleet-view construction fails where dispatch would
        attr = getattr(self.inner, name)
        if name in ("csr_mirror", "prefetch", "prefetch_kth_paths"):
            def _wrapped(*args, **kwargs):
                self._gate(name)
                return attr(*args, **kwargs)

            return _wrapped
        return attr


def wait_timeout_scale() -> float:
    """Multiplier applied to every chaos wait/convergence timeout.

    It reads the port's detector (`openr_tpu_torch.analysis.race`),
    never the reference's.

    Timing model: chaos timeouts are calibrated on an UNINSTRUMENTED
    1-CPU full-suite run — convergence is a fixed amount of daemon work
    (SPF recomputes, queue drains, FIB programs), so wall time scales
    with per-operation cost, not with the timeout constant.  Arming the
    happens-before race detector (`OPENR_TSAN=1`) multiplies that
    per-operation cost: every queue put/get, lock acquire, eventbase
    handoff, and future resolution takes the detector's vector-clock
    path, and under full-suite load the same scripted timeline can need
    ~2-3x the wall clock to reach the identical converged state.  A
    fixed timeout therefore turns instrumentation overhead into a fake
    liveness failure — the replay-determinism flake — while scaling the
    timeout (never the hold window or the poll cadence: quiescence
    semantics must not change) keeps the pass condition identical and
    only gives the slowed run time to get there.

    `OPENR_CHAOS_TIMEOUT_SCALE` overrides for even slower rigs
    (emulators, heavily shared CI); otherwise 3x whenever the detector
    is armed, 1x unarmed so the calibrated budgets stay tight."""
    env = os.environ.get("OPENR_CHAOS_TIMEOUT_SCALE")
    if env:
        return max(1.0, float(env))
    from ..analysis import race

    if race.TSAN is not None:
        return 3.0
    return 1.0


def wait_until(cond, timeout_s: float = 20.0, poll_s: float = 0.05) -> bool:
    deadline = time.monotonic() + timeout_s * wait_timeout_scale()
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(poll_s)
    return False
