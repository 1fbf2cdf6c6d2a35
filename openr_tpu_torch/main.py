"""Composition root: build and run the full daemon.

Port of `openr_tpu.main` (reference: main(), openr/Main.cpp:165-688):
create the replicate queues, start every module in dependency order, wire
the ctrl server over all of them, and tear down in reverse order.

`OpenrDaemon` is both the daemon entry (`python -m openr_tpu_torch.main
--config cfg.json`) and the in-process multi-node harness (the
OpenrWrapper pattern, openr/tests/OpenrWrapper.h:38): pass a
MockIoProvider endpoint and an in-process KvStore fabric to run N daemons
in one process with no network or kernel.  Its Decision computes on the
CUDA card unless the caller passes `device` ("cpu" in the tests), and
`main()` refuses to start without a card.

A config that asks for the rtnetlink socket (`enable_netlink`), the TCP
FIB agent (`fib_agent_port`, a `python -m
openr_tpu_torch.platform.fib_agent` process; unless the caller passes
`fib_agent`) or the Thrift shim (`thrift_shim_port`, -1 for a port the
kernel picks) gets that part built and started with the daemon, or the
daemon fails to start.  A failed agent call raises into Fib's retry and
backoff; nothing stands in for the agent.  The ctrl handler's
`snapshot` surface answers the pre-seeded `snapshot.*` family and its
`obs` surface (`_obs_stats`) the `obs.*` family, zeroed unless tracing
is armed (`OPENR_TRACE=1` in the daemon's environment), with
`dumpTraces` and `getSpanSamples` answering the tracer's trees; its
`sched` surface (`_sched_counters`) answers the schedule explorer's
pre-seeded `sched.*` family.  With `OPENR_TSAN=1` in its environment,
`OpenrDaemon.__init__` arms the port's race detector (`analysis.race`)
before any module object exists.  Its `fuzz` surface
(`_fuzz_counters`) answers the chaos fuzzer's pre-seeded `chaos.fuzz.*`
family, live-valued when a fuzz session ran in the process.

`ServingFleet` runs K daemons in one process, peered over a KvStore full
mesh and fronted by one `serving.ReplicaRouter`; it scales out with a
snapshot warm start (`snapshot.EngineSnapshot`) and in under live load.

Queue wiring (reference: Main.cpp:275-287; SURVEY §1 dataflow):

    netlink -> netlinkEventsQueue ----------------> LinkMonitor
    LinkMonitor -> interfaceUpdatesQueue ---------> Spark
    Spark -> neighborUpdatesQueue ----------------> LinkMonitor
    LinkMonitor -> peerUpdatesQueue --------------> KvStore
    LinkMonitor/allocator -> prefixUpdatesQueue --> PrefixManager
    PrefixManager/LinkMonitor -> (client) --------> KvStore
    KvStore -> kvStoreUpdatesQueue ---------------> Decision, clients
    KvStore -> kvStoreSyncEventsQueue ------------> LinkMonitor
    Decision -> routeUpdatesQueue ----------------> Fib, PrefixManager
    Fib -> fibUpdatesQueue -----------------------> ctrl streaming
    everyone -> logSampleQueue -------------------> Monitor
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import tempfile
import threading
from typing import Optional

from .allocators import PrefixAllocator
from .analysis import race as _race
from .config import OpenrConfig, load_config
from .config_store import PersistentStore
from .ctrl import CtrlServer, OpenrCtrlHandler, TcpKvStoreTransport
from .decision.decision import Decision
from .decision.spf_solver import DeviceSpfBackend
from .device.engine import resolve_device
from .fib import Fib, FibAgent, MockFibAgent
from .kvstore import KvStore, KvStoreClientInternal, KvStoreFilters
from .link_monitor import LinkMonitor
from .monitor import Monitor, Watchdog
from .prefix_manager import PrefixManager
from .runtime.queue import ReplicateQueue
from .spark import IoProvider, Spark, UdpIoProvider

log = logging.getLogger(__name__)


def _obs_stats():
    """The tracing surface (obs.* counters, dumpTraces, getSpanSamples).
    ObsStats reads the tracer late-bound, so an unarmed daemon answers
    zeroed counters and empty trace lists."""
    from .obs import ObsStats

    return ObsStats()


def _fuzz_counters():
    """The chaos fuzzer's process-wide registry (chaos.fuzz.*, pre-seeded
    zeros): a daemon that never fuzzes still answers the whole family on
    both wires, and an in-process session's runs and shrinks show there.
    Imported lazily: the daemon never needs the fuzzer's harness."""
    from .chaos.fuzz import FUZZ_COUNTERS

    return FUZZ_COUNTERS


def _sched_counters():
    """The schedule explorer's process-wide registry (sched.*, pre-seeded
    zeros): a daemon that never explores still answers the whole family
    on both wires."""
    from .analysis.sched import SCHED_COUNTERS

    return SCHED_COUNTERS


def _snapshot_counters():
    """The engine-snapshot registry (snapshot.*, pre-seeded zeros): a
    daemon that never takes or restores a snapshot still answers the
    whole family on both wires."""
    from .snapshot import SNAPSHOT_COUNTERS

    return SNAPSHOT_COUNTERS


class OpenrDaemon:
    def __init__(
        self,
        config: OpenrConfig,
        *,
        io_provider: Optional[IoProvider] = None,
        kvstore_transport=None,
        fib_agent: Optional[FibAgent] = None,
        spark_v6_addr: str = "",
        device=None,
    ) -> None:
        # OPENR_TSAN=1 arms the happens-before race detector before any
        # module object exists (a no-op otherwise)
        _race.maybe_enable()
        self.config = config
        name = config.node_name
        areas = config.area_ids

        # -- queues (reference: Main.cpp:275-287) ----------------------------
        self.kvstore_updates_queue: ReplicateQueue = ReplicateQueue()
        self.kvstore_sync_events_queue: ReplicateQueue = ReplicateQueue()
        self.interface_updates_queue: ReplicateQueue = ReplicateQueue()
        self.neighbor_updates_queue: ReplicateQueue = ReplicateQueue()
        self.peer_updates_queue: ReplicateQueue = ReplicateQueue()
        self.prefix_updates_queue: ReplicateQueue = ReplicateQueue()
        self.route_updates_queue: ReplicateQueue = ReplicateQueue()
        self.static_routes_queue: ReplicateQueue = ReplicateQueue()
        self.fib_updates_queue: ReplicateQueue = ReplicateQueue()
        self.log_sample_queue: ReplicateQueue = ReplicateQueue()
        self.netlink_events_queue: ReplicateQueue = ReplicateQueue()
        self._queues = {
            "kvstore_updates": self.kvstore_updates_queue,
            "kvstore_sync_events": self.kvstore_sync_events_queue,
            "interface_updates": self.interface_updates_queue,
            "neighbor_updates": self.neighbor_updates_queue,
            "peer_updates": self.peer_updates_queue,
            "prefix_updates": self.prefix_updates_queue,
            "route_updates": self.route_updates_queue,
            "static_routes": self.static_routes_queue,
            "fib_updates": self.fib_updates_queue,
            "log_sample": self.log_sample_queue,
            # found by thread-queue-registration: the netlink event stream
            # was invisible to queue.* counters and the shutdown drain
            "netlink_events": self.netlink_events_queue,
        }

        # -- watchdog (reference: Main.cpp:295-300) --------------------------
        self.watchdog: Optional[Watchdog] = None
        if config.enable_watchdog:
            wc = config.watchdog_config
            self.watchdog = Watchdog(
                interval_s=wc.interval_s,
                thread_timeout_s=wc.thread_timeout_s,
                max_memory_bytes=wc.max_memory_mb * 1024 * 1024,
            )

        # -- config store (reference: Main.cpp:370-375) ----------------------
        self.config_store = PersistentStore(
            config.persistent_config_store_path
            or os.path.join(tempfile.gettempdir(), f"openr_tpu_{name}.bin"),
            dryrun=not config.persistent_config_store_path,
        )

        # -- monitor ---------------------------------------------------------
        self.monitor = Monitor(name, self.log_sample_queue.get_reader())

        # -- kvstore (reference: Main.cpp:389-408) ---------------------------
        kvc = config.kvstore_config
        self.kvstore = KvStore(
            name,
            self.kvstore_updates_queue,
            self.kvstore_sync_events_queue,
            self.peer_updates_queue.get_reader(),
            transport=kvstore_transport
            or TcpKvStoreTransport(
                default_port=config.openr_ctrl_port, tls=self._tls_config()
            ),
            areas=areas,
            filters=(
                KvStoreFilters(kvc.key_prefix_filters)
                if kvc.key_prefix_filters
                else None
            ),
            flood_rate=(
                (kvc.flood_msg_per_sec, kvc.flood_msg_burst_size)
                if kvc.flood_msg_per_sec > 0
                else None
            ),
            ttl_decr_ms=kvc.ttl_decrement_ms,
            enable_flood_optimization=kvc.enable_flood_optimization,
            is_flood_root=kvc.is_flood_root,
        )

        # -- spark (reference: Main.cpp:443-456) -----------------------------
        self.io_provider = io_provider or UdpIoProvider()
        self.spark = Spark(
            name,
            self.interface_updates_queue.get_reader(),
            self.neighbor_updates_queue,
            self.io_provider,
            config=config.spark_timers(),
            areas=config.spark_area_configs(),
            domain=config.domain,
            ctrl_port=config.openr_ctrl_port,
            v6_addr=spark_v6_addr,
        )

        # -- link monitor (reference: Main.cpp:458-478) ----------------------
        lmc = config.link_monitor_config
        self.link_monitor = LinkMonitor(
            name,
            interface_updates_queue=self.interface_updates_queue,
            peer_updates_queue=self.peer_updates_queue,
            prefix_updates_queue=self.prefix_updates_queue,
            neighbor_updates=self.neighbor_updates_queue.get_reader(),
            kvstore_sync_events=self.kvstore_sync_events_queue.get_reader(),
            netlink_events=self.netlink_events_queue.get_reader(),
            config_store=self.config_store,
            areas=areas,
            node_label=config.node_label,
            enable_rtt_metric=lmc.use_rtt_metric,
            include_if_regexes=tuple(lmc.include_interface_regexes),
            exclude_if_regexes=tuple(lmc.exclude_interface_regexes),
            redistribute_if_regexes=tuple(lmc.redistribute_interface_regexes),
            assume_drained=config.assume_drained,
            override_drain_state=config.override_drain_state,
        )

        # -- decision (reference: Main.cpp:518-531) --------------------------
        dc = config.decision_config
        self.decision = Decision(
            name,
            self.kvstore_updates_queue.get_reader(),
            self.static_routes_queue.get_reader(),
            self.route_updates_queue,
            debounce_min_s=dc.debounce_min_ms / 1000.0,
            debounce_max_s=dc.debounce_max_ms / 1000.0,
            eor_time_s=config.eor_time_s,
            enable_v4=config.enable_v4,
            enable_ordered_fib=config.enable_ordered_fib_programming,
            enable_best_route_selection=config.enable_best_route_selection,
            enable_rib_policy=config.enable_rib_policy,
            spf_backend=DeviceSpfBackend(device),
            device=device,
            # the incremental delta rung dispatches through the device
            # backend's engine; inert below delta_min_p dests
            fleet_delta=True,
        )

        # -- fib (reference: Main.cpp:533-545) -------------------------------
        if fib_agent is None and config.fib_agent_port:
            from .platform import TcpFibAgent

            fib_agent = TcpFibAgent(
                host=config.fib_agent_host, port=config.fib_agent_port
            )
        self.fib_agent = fib_agent or MockFibAgent()
        self.fib = Fib(
            name,
            self.route_updates_queue.get_reader(),
            self.fib_agent,
            fib_updates_queue=self.fib_updates_queue,
            log_sample_queue=self.log_sample_queue,
            dryrun=config.dryrun,
            enable_segment_routing=config.enable_segment_routing,
        )

        # modules created after start(): client-dependent ones
        self.kvstore_client: Optional[KvStoreClientInternal] = None
        self.prefix_manager: Optional[PrefixManager] = None
        self.prefix_allocator: Optional[PrefixAllocator] = None
        self.serving = None  # serving.QueryScheduler (started in start())
        self.ctrl_server: Optional[CtrlServer] = None
        self.thrift_shim = None  # interop.shim.ThriftBinaryShim when enabled
        self._plugin = None
        self._plugin_handle = None
        self.netlink = None
        self._started = False

    # -- lifecycle (reference: Main.cpp startup order + reverse teardown) ----

    def start(self) -> None:
        assert not self._started
        self._started = True
        # netlink FIRST so the initial kernel state replay is queued before
        # LinkMonitor starts consuming (reference: Main.cpp:330-343 brings
        # the netlink evb up before every module)
        if self.config.enable_netlink:
            from .nl import NetlinkProtocolSocket

            self.netlink = NetlinkProtocolSocket(self.netlink_events_queue)
            self.netlink.run()
        modules = [self.monitor, self.kvstore, self.spark, self.link_monitor]
        for module in modules:
            module.run()
            if self.watchdog is not None:
                self.watchdog.add_evb(module)

        # kvstore client lives on the link-monitor evb (its main user)
        self.kvstore_client = KvStoreClientInternal(
            self.link_monitor,
            self.config.node_name,
            self.kvstore,
            self.kvstore_updates_queue.get_reader(),
        )
        # composition-root wiring: single startup assignment, read only by
        # work scheduled onto the link-monitor loop after this point
        # openr: disable=thread-cross-module-write
        self.link_monitor.kvstore_client = self.kvstore_client

        self.prefix_manager = PrefixManager(
            self.config.node_name,
            self.kvstore_client,
            prefix_updates=self.prefix_updates_queue.get_reader(),
            route_updates=self.route_updates_queue.get_reader(),
            areas=self.config.area_ids,
        )
        self.prefix_manager.run()

        if self.config.prefix_allocation_config is not None:
            pac = self.config.prefix_allocation_config
            self.prefix_allocator = PrefixAllocator(
                self.link_monitor,
                self.config.node_name,
                self.kvstore_client,
                pac.seed_prefix,
                pac.allocate_prefix_len,
                area=self.config.area_ids[0],
                prefix_updates_queue=self.prefix_updates_queue,
                config_store=self.config_store,
                assign_to_interface=pac.assign_to_interface,
            )
            self.prefix_allocator.start()

        # plugin (BGP-speaker seam) BEFORE Decision so its origins are in
        # place for the first SPF (reference: Main.cpp:501-510)
        if self.config.plugin_module:
            from .plugin import PluginArgs, load_plugin, plugin_start

            module = load_plugin(self.config.plugin_module)
            self._plugin_handle = plugin_start(
                module,
                PluginArgs(
                    prefix_updates_queue=self.prefix_updates_queue,
                    static_routes_update_queue=self.static_routes_queue,
                    route_updates_queue=self.route_updates_queue.get_reader(),
                    config=self.config,
                    node_name=self.config.node_name,
                ),
            )
            # recorded only after a successful start so a plugin_start
            # failure doesn't make stop() call plugin_stop(module, None)
            self._plugin = module

        # decision AFTER kvstore/link-monitor so SPF sees self
        # (reference: Main.cpp:518 comment)
        self.decision.run()
        self.fib.run()
        for module in (self.prefix_manager, self.decision, self.fib):
            if self.watchdog is not None:
                self.watchdog.add_evb(module)

        # serving layer BEFORE the wire surfaces that submit into it:
        # queries marshal onto the Decision thread in coalesced batches
        # (serving.DecisionBatchBackend), so Decision must already be up
        from .serving import DecisionBatchBackend, QueryScheduler

        self.serving = QueryScheduler(
            DecisionBatchBackend(self.decision),
            # hold freshly coalesced batches (bounded) while topology
            # events are mid-fold, so they pin the post-storm epoch
            defer_hint=self.decision.pending_event_hint,
        )
        self.serving.run()
        if self.watchdog is not None:
            self.watchdog.add_evb(self.serving)
        # admission-queue stats ride the queue.* counter surface next to
        # the inter-module fabric (queue.serving_admission.overflows is
        # the first overload signal; see docs/OPERATIONS.md)
        self._queues["serving_admission"] = self.serving.admission

        handler = OpenrCtrlHandler(
            self.config.node_name,
            kvstore=self.kvstore,
            decision=self.decision,
            fib=self.fib,
            link_monitor=self.link_monitor,
            prefix_manager=self.prefix_manager,
            spark=self.spark,
            monitor=self.monitor,
            netlink=self.netlink,
            config=self.config,
            # device-residency engine counters (device.engine.*) ride the
            # same getCounters surface as every module's
            device=getattr(self.decision.spf_solver.spf, "engine", None),
            # node-sharding rung counters (mesh.blocked.*) ride along;
            # pre-seeded at engine construction so they dump before the
            # first blocked dispatch
            mesh=getattr(
                getattr(self.decision.spf_solver.spf, "engine", None),
                "blocked",
                None,
            ),
            serving=self.serving,
            # TE optimizer counters (te.*, pre-seeded at construction)
            # ride the same surface; the optimizer lives on the serving
            # backend so optimizeMetrics runs and counter reads agree
            te=getattr(self.serving.backend, "te", None),
            # chaos fuzzer counters (chaos.fuzz.*, pre-seeded zeros): a
            # daemon that never fuzzes still answers the whole family
            fuzz=_fuzz_counters(),
            # schedule-explorer counters (sched.*, pre-seeded zeros):
            # exploration sessions' schedules, prunes and replays
            sched=_sched_counters(),
            # trace-span surface (obs.*, zeroed when OPENR_TRACE is off):
            # the same wire shape armed or not
            obs=_obs_stats(),
            # engine-snapshot counters (snapshot.*, pre-seeded zeros)
            snapshot=_snapshot_counters(),
            kvstore_updates_queue=self.kvstore_updates_queue,
            fib_updates_queue=self.fib_updates_queue,
            config_store=self.config_store,
            watchdog=self.watchdog,
            queues=self._queues,
        )
        self.ctrl_server = CtrlServer(
            handler,
            host=self.config.listen_addr,
            port=self.config.openr_ctrl_port,
            tls=self._tls_config(),
        )
        self.ctrl_server.run()
        if self.config.thrift_shim_port:
            # stock-openr-shaped thrift Binary+framed listener over the
            # same modules (interop.shim)
            from .interop.shim import ThriftBinaryShim

            self.thrift_shim = ThriftBinaryShim(
                self.kvstore,
                host=self.config.listen_addr,
                port=max(self.config.thrift_shim_port, 0),
                node_name=self.config.node_name,
                decision=self.decision,
                fib=self.fib,
                serving=self.serving,
                counters_fn=self.ctrl_server.handler._all_counters,
                kvstore_updates_queue=self.kvstore_updates_queue,
            )
            self.thrift_shim.run()
        if self.watchdog is not None:
            self.watchdog.add_evb(self.ctrl_server)
            self.watchdog.start()

    def _tls_config(self):
        """config.TlsConf -> ctrl.tls.TlsConfig (None when TLS is off)."""
        tc = self.config.tls_config
        if tc is None or not tc.cert_path:
            return None
        from .ctrl.tls import TlsConfig

        return TlsConfig(
            cert_path=tc.cert_path,
            key_path=tc.key_path,
            ca_path=tc.ca_path,
            acl_regex=tc.acl_regex,
        )

    @property
    def ctrl_port(self) -> int:
        assert self.ctrl_server is not None
        return self.ctrl_server.port

    def stop(self) -> None:
        """Reverse-order teardown (reference: Main.cpp:617-668)."""
        if self._plugin is not None:
            from .plugin import plugin_stop

            plugin_stop(self._plugin, self._plugin_handle)
            self._plugin = None
        if self.watchdog is not None:
            self.watchdog.stop()
        for queue in self._queues.values():
            queue.close()
        modules = [
            self.thrift_shim,
            self.ctrl_server,
            # serving after its wire surfaces (no new submissions), before
            # the Decision thread its batches marshal onto
            self.serving,
            self.fib,
            self.decision,
            self.prefix_manager,
            self.link_monitor,
            self.spark,
            self.kvstore,
            self.monitor,
        ]
        if self.prefix_allocator is not None:
            self.prefix_allocator.stop()
        if self.kvstore_client is not None:
            self.kvstore_client.stop()
        for module in modules:
            if module is not None:
                module.stop()
        for module in modules:
            if module is not None:
                module.wait_until_stopped(5)
        if self.netlink is not None:
            self.netlink.stop()
            self.netlink.wait_until_stopped(5)
            self.netlink = None
        close_agent = getattr(self.fib_agent, "close", None)
        if callable(close_agent):
            close_agent()  # TcpFibAgent holds a persistent socket
        self.config_store.close()


def fleet_node_config(name: str, ctrl_port: int = 0) -> OpenrConfig:
    """Fast-timer config for an in-process serving-fleet replica (the
    OpenrWrapper posture: mock fabrics, no watchdog, sub-second Spark)."""
    from .config import AreaConf, DecisionConf, SparkConf

    return OpenrConfig(
        node_name=name,
        areas=[AreaConf()],
        openr_ctrl_port=ctrl_port,
        spark_config=SparkConf(
            hello_time_s=0.3,
            fastinit_hello_time_ms=20,
            keepalive_time_s=0.05,
            hold_time_s=0.5,
            graceful_restart_time_s=1.0,
        ),
        decision_config=DecisionConf(debounce_min_ms=5, debounce_max_ms=20),
        enable_watchdog=False,
        node_label=0,
    ).validate()


class ServingFleet:
    """K full daemons in one process, peered over a KvStore full mesh and
    fronted by one serving.ReplicaRouter (reference: openr_tpu.main
    ServingFleet).

    Every daemon runs the whole stack (Spark adjacency over a mock
    fabric, KvStore flooding, Decision on `device`, serving.QueryScheduler),
    so each replica converges to the same LinkState version on its own
    and answers any query at its current epoch.  The router spreads
    queries across the K schedulers with per-session epoch pinning,
    health-aware failover and bounded hedging; `handler` is the
    front-door OpenrCtrlHandler whose queryPaths / queryWhatIf / queryKsp
    go through the router, so the fleet looks like one daemon to ctrl
    clients while serving.router.* counters expose the spread.

    Where the reference takes `spf_backend=` / `use_device_spf=`, every
    daemon here computes on `device` (the CUDA card when None), and a
    scale-out's snapshot warm start that fails raises out of `scale()`.
    """

    def __init__(
        self,
        k: int = 3,
        *,
        node_prefix: str = "fleet",
        hedge_after_s: Optional[float] = 0.05,
        config_fn=None,
        device=None,
    ) -> None:
        from .kvstore import InProcessTransport
        from .spark import MockIoProvider

        if k < 1:
            raise ValueError("ServingFleet needs at least one replica")
        self._make = config_fn or fleet_node_config
        self._node_prefix = node_prefix
        self._device = device
        self.spark_fabric = MockIoProvider()
        self.kv_fabric = InProcessTransport()
        self.daemons: list[OpenrDaemon] = []
        self._names: list[str] = []
        # creation index per live daemon: interface names (if-{i}-{j}) and
        # mock addresses are minted from it and never reused, so a
        # scale-in followed by a scale-out can't collide with the fabric
        # state the departed replica left behind
        self._indices: list[int] = []
        self._next_idx = 0
        for _ in range(k):
            self._new_daemon()
        self._hedge_after_s = hedge_after_s
        self.router = None  # serving.ReplicaRouter (built in start())
        self.handler = None  # front-door OpenrCtrlHandler over the router

    def _new_daemon(self) -> OpenrDaemon:
        """Mint the next replica (not yet started or meshed)."""
        i = self._next_idx
        self._next_idx += 1
        name = f"{self._node_prefix}-{i}"
        addr = f"fe80::{name}"
        daemon = OpenrDaemon(
            self._make(name),
            io_provider=self.spark_fabric.endpoint(name),
            kvstore_transport=self.kv_fabric.bind(addr),
            spark_v6_addr=addr,
            device=self._device,
        )
        self.kv_fabric.register(addr, daemon.kvstore)
        self.daemons.append(daemon)
        self._names.append(name)
        self._indices.append(i)
        return daemon

    def start(self) -> None:
        from .serving import ReplicaRouter, SchedulerReplica
        from .types import LinkEvent

        for daemon in self.daemons:
            daemon.start()
        # full-mesh adjacency: every replica peers with every other, so
        # one surviving replica keeps the whole fleet's KvStore coherent
        # through any single partition
        k = len(self.daemons)
        for i in range(k):
            for j in range(i + 1, k):
                self.spark_fabric.connect(
                    self._names[i], f"if-{i}-{j}", self._names[j], f"if-{j}-{i}"
                )
        for i, daemon in enumerate(self.daemons):
            for j in range(k):
                if j != i:
                    daemon.netlink_events_queue.push(
                        LinkEvent(f"if-{i}-{j}", j + 1, True)
                    )
        self.router = ReplicaRouter(
            [
                SchedulerReplica(self._names[i], d.serving)
                for i, d in enumerate(self.daemons)
            ],
            hedge_after_s=self._hedge_after_s if k > 1 else None,
        )
        # front door: daemon 0's introspection surfaces plus the router
        # as the serving module, so queryPaths et al spread over the fleet
        front = self.daemons[0]
        self.handler = OpenrCtrlHandler(
            f"{self._names[0]}-front",
            kvstore=front.kvstore,
            decision=front.decision,
            fib=front.fib,
            link_monitor=front.link_monitor,
            prefix_manager=front.prefix_manager,
            spark=front.spark,
            monitor=front.monitor,
            config=front.config,
            serving=self.router,
            fuzz=_fuzz_counters(),
            sched=_sched_counters(),
            obs=_obs_stats(),
            snapshot=_snapshot_counters(),
            queues=front._queues,
        )

    def wait_converged(self, timeout_s: float = 30.0) -> bool:
        """True once every replica's Decision sees the full mesh of the
        live replicas AND all replicas answer the same topology epoch:
        the fleet precondition for equal replies across replicas.

        The reference counts `len(ls.node_names) == k`, which a departed
        replica's adjacency database (it stays in every store until its
        TTL) keeps false after any scale-in, so a later scale-out waited
        out the whole timeout (ROADMAP queue 3, F6).  Here each replica's
        LinkState is read on its own Decision thread, and a departed
        node, whose links are down, does not count."""
        import time

        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if all(self._sees_full_mesh(d) for d in self.daemons):
                epochs = {d.serving.backend.epoch("0") for d in self.daemons}
                if len(epochs) == 1:
                    return True
            time.sleep(0.05)
        return False

    def _sees_full_mesh(self, daemon: OpenrDaemon) -> bool:
        """True when `daemon`'s LinkState has an up link between every two
        live replicas."""
        names = set(self._names)

        def check() -> bool:
            ls = daemon.decision.area_link_states.get("0")
            if ls is None:
                return False
            return all(
                {link.other_node_name(a) for link in ls.links_from_node(a) if link.is_up()}
                >= names - {a}
                for a in names
            )

        return daemon.decision.run_in_event_base_thread(check).result()

    # -- elastic membership ---------------------------------------------------

    def scale(self, k_new: int) -> list:
        """Elastic membership under live load: grow or shrink the fleet to
        `k_new` replicas one step at a time.  A scale-out replica is
        warm-started from daemon 0's engine snapshot before it joins the
        router; a scale-in folds the departed replica's final counters
        into the router's roll-up, so the fleet's wire surface stays
        monotone.  Returns the restore rung ("replay" / "install" /
        "cold") of each scale-out step."""
        if k_new < 1:
            raise ValueError("ServingFleet cannot scale below one replica")
        if self.router is None:
            raise RuntimeError("scale() requires a started fleet")
        modes: list = []
        while len(self.daemons) > k_new:
            self._scale_in()
        while len(self.daemons) < k_new:
            modes.append(self._scale_out())
        return modes

    def autoscale_step(self, policy):
        """One autoscaling observation: feed the router's fleet counter
        roll-up and the deepest replica admission queue to the policy
        (snapshot.AutoscalePolicy) and apply its decision through
        scale().  Returns the AutoscaleDecision."""
        k = len(self.daemons)
        depth = max((d.serving.admission.size() for d in self.daemons), default=0)
        decision = policy.observe(k, self.router.get_counters(), admission_depth=depth)
        if decision.action != "hold" and decision.target_k != k:
            self.scale(decision.target_k)
        return decision

    def _scale_out(self) -> str:
        from .serving import SchedulerReplica
        from .snapshot import SNAPSHOT_COUNTERS
        from .types import LinkEvent

        donor = self.daemons[0]
        peers = list(zip(self._indices, self._names, self.daemons))
        daemon = self._new_daemon()
        idx = self._indices[-1]
        name = self._names[-1]
        daemon.start()
        # mesh the joiner with every live peer, then announce the links on
        # both sides (start()'s choreography, with minted indices)
        for j, jname, _ in peers:
            self.spark_fabric.connect(jname, f"if-{j}-{idx}", name, f"if-{idx}-{j}")
        for j, jname, peer in peers:
            peer.netlink_events_queue.push(LinkEvent(f"if-{j}-{idx}", idx + 1, True))
            daemon.netlink_events_queue.push(LinkEvent(f"if-{idx}-{j}", j + 1, True))
        if not self.wait_converged():
            raise RuntimeError(f"scale-out: the fleet did not converge with {name}")
        mode = self._warm_start(donor, daemon)
        # join the router last: the first routed query finds the restored
        # residency
        self.router.add_replica(SchedulerReplica(name, daemon.serving))
        SNAPSHOT_COUNTERS._bump("snapshot.scaleouts")
        return mode

    def _scale_in(self) -> None:
        from .snapshot import SNAPSHOT_COUNTERS

        if len(self.daemons) <= 1:
            raise ValueError("ServingFleet cannot scale below one replica")
        # always retire the youngest replica: daemon 0 owns the front door
        # handler and is the snapshot donor
        name = self._names[-1]
        daemon = self.daemons[-1]
        # stops new picks at once and folds the replica's final counters
        # into the departed roll-up before the handle dies
        self.router.remove_replica(name)
        daemon.stop()
        self.daemons.pop()
        self._names.pop()
        self._indices.pop()
        SNAPSHOT_COUNTERS._bump("snapshot.scaleins")

    @staticmethod
    def _warm_start(donor: OpenrDaemon, joiner: OpenrDaemon) -> str:
        """Snapshot-restore the joiner's engine from the donor's.  Each
        side runs on its own Decision thread, the one thread that touches
        its engine, so neither races a route build or a serving batch.  A
        converged fleet takes the install rung (the joiner's fresh mirror
        equals the donor's); drift demotes to an accounted cold build.
        Every daemon computes on its card, so there is no skip, and a
        failure raises."""
        from .snapshot import EngineSnapshot

        def take():
            spf = donor.decision.spf_solver.spf
            csr = spf.csr_mirror(donor.decision.area_link_states["0"])
            return EngineSnapshot.take(spf.engine, csr)

        snap = donor.decision.run_in_event_base_thread(take).result()

        def restore():
            spf = joiner.decision.spf_solver.spf
            csr = spf.csr_mirror(joiner.decision.area_link_states["0"])
            return snap.restore(spf.engine, csr)

        return joiner.decision.run_in_event_base_thread(restore).result()

    def stop(self) -> None:
        if self.router is not None:
            self.router.stop()
        for daemon in self.daemons:
            daemon.stop()


def build_flag_parser() -> argparse.ArgumentParser:
    """Process-level flag surface (reference: openr/common/Flags.cpp — the
    operationally-relevant subset; most knobs live in the JSON config, and
    every flag here overrides its config field, mirroring GflagConfig's
    flag->config bridge, openr/config/GflagConfig.h).  The reference's
    --use-device-spf / --no-device-spf pair is left out: the port's
    daemon computes on the CUDA card and has no switch to the host."""
    parser = argparse.ArgumentParser(description="openr_tpu_torch daemon")
    parser.add_argument("--config", required=True, help="JSON config file")
    # identity / ports (reference: --node_name, --openr_ctrl_port,
    # --fib_port)
    parser.add_argument("--node-name", default=None)
    parser.add_argument("--listen-addr", default=None)
    parser.add_argument("--openr-ctrl-port", type=int, default=None)
    parser.add_argument("--fib-agent-host", default=None)
    parser.add_argument("--fib-agent-port", type=int, default=None)
    # drain / operation (reference: --assume_drained,
    # --override_drain_state, --dryrun, --enable_watchdog)
    parser.add_argument("--assume-drained", action="store_true", default=None)
    parser.add_argument(
        "--override-drain-state", action="store_true", default=None
    )
    parser.add_argument("--dryrun", action="store_true", default=None)
    parser.add_argument(
        "--disable-watchdog",
        dest="enable_watchdog",
        action="store_false",
        default=None,
    )
    # features (reference: --enable_flood_optimization, --is_flood_root,
    # --enable_netlink analog, --bgp_use_igp_metric plugin seam)
    parser.add_argument(
        "--enable-flood-optimization", action="store_true", default=None
    )
    parser.add_argument("--enable-netlink", action="store_true", default=None)
    parser.add_argument("--plugin-module", default=None)
    # decision timers (reference: --decision_debounce_min/max_ms)
    parser.add_argument("--decision-debounce-min-ms", type=int, default=None)
    parser.add_argument("--decision-debounce-max-ms", type=int, default=None)
    # persistent state (reference: --config_store_filepath)
    parser.add_argument("--config-store-path", default=None)
    # ctrl mTLS + peer ACL (reference: --x509_cert_path etc.)
    parser.add_argument("--tls-cert-path", default=None)
    parser.add_argument("--tls-key-path", default=None)
    parser.add_argument("--tls-ca-path", default=None)
    parser.add_argument("--tls-acl-regex", default=None)
    parser.add_argument("-v", "--verbose", action="store_true")
    return parser


def apply_flag_overrides(config, args) -> None:
    """Flag-over-config precedence (reference: GflagConfig bridge)."""
    overrides = {
        "node_name": args.node_name,
        "listen_addr": args.listen_addr,
        "openr_ctrl_port": args.openr_ctrl_port,
        "fib_agent_host": args.fib_agent_host,
        "fib_agent_port": args.fib_agent_port,
        "assume_drained": args.assume_drained,
        "override_drain_state": args.override_drain_state,
        "dryrun": args.dryrun,
        "enable_watchdog": args.enable_watchdog,
        "enable_netlink": args.enable_netlink,
        "plugin_module": args.plugin_module,
        "persistent_config_store_path": args.config_store_path,
    }
    for name, value in overrides.items():
        if value is not None:
            setattr(config, name, value)
    if (
        args.tls_cert_path
        or args.tls_key_path
        or args.tls_ca_path
        or args.tls_acl_regex
    ):
        from .config import TlsConf

        tls = config.tls_config or TlsConf()
        for cfg_field, flag in (
            ("cert_path", args.tls_cert_path),
            ("key_path", args.tls_key_path),
            ("ca_path", args.tls_ca_path),
            ("acl_regex", args.tls_acl_regex),
        ):
            if flag is not None:
                setattr(tls, cfg_field, flag)
        config.tls_config = tls
    if args.enable_flood_optimization is not None:
        config.kvstore_config.enable_flood_optimization = (
            args.enable_flood_optimization
        )
    if args.decision_debounce_min_ms is not None:
        config.decision_config.debounce_min_ms = args.decision_debounce_min_ms
    if args.decision_debounce_max_ms is not None:
        config.decision_config.debounce_max_ms = args.decision_debounce_max_ms


def main(argv: Optional[list[str]] = None) -> int:
    # the card first: without one the daemon does not start at all
    device = resolve_device(None)
    args = build_flag_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    config = load_config(args.config)
    apply_flag_overrides(config, args)
    config.validate()
    daemon = OpenrDaemon(config, device=device)
    daemon.start()
    log.info(
        "openr_tpu_torch %s up on %s; ctrl on [%s]:%d",
        config.node_name,
        device,
        config.listen_addr,
        daemon.ctrl_port,
    )
    stop_event = threading.Event()
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGINT, lambda *a: stop_event.set())
        signal.signal(signal.SIGTERM, lambda *a: stop_event.set())
    stop_event.wait()
    daemon.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
