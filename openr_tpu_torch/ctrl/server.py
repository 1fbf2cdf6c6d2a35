"""Ctrl server: NDJSON-RPC over TCP with server streaming.

Port of `openr_tpu.ctrl.server`: the same methods on the same wire.
The daemon wires the handler's `snapshot` surface (the pre-seeded
`snapshot.*` family) and its `obs` surface (`obs.ObsStats`: the `obs.*`
counters, zeroed when tracing is unarmed, and the tracer's trees on
`dumpTraces` and `getSpanSamples`), its `sched` surface (the
schedule explorer's pre-seeded `sched.*` family) and its `fuzz` surface
(the chaos fuzzer's pre-seeded `chaos.fuzz.*` family); its `mesh`
surface stays None until the port has that module, and each method
then answers as the reference's does without it.

Wire protocol (one JSON object per line):
    request:   {"id": N, "method": "...", "params": {...}}
    response:  {"id": N, "result": <wire-encoded>}
             | {"id": N, "error": "..."}
    streaming: {"id": N, "stream": <item>} ... ; client sends
               {"id": N, "cancel": true} to stop.

Dataclass values are wire-tagged via serializer.to_wire/from_wire.
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
from typing import Any, Awaitable, Callable, Optional

from ..runtime.eventbase import OpenrEventBase
from ..runtime.queue import QueueClosedError, ReplicateQueue
from ..serializer import from_wire, to_wire
from ..types import ADJ_MARKER, Publication
from .client import WIRE_LINE_LIMIT

log = logging.getLogger(__name__)

OPENR_VERSION = 20
OPENR_LOWEST_SUPPORTED_VERSION = 20


class CtrlError(RuntimeError):
    pass


class OpenrCtrlHandler:
    """Method registry over the module set (reference:
    OpenrCtrlHandler.h:53 — raw pointers to every module)."""

    def __init__(
        self,
        node_name: str,
        *,
        kvstore=None,
        decision=None,
        fib=None,
        link_monitor=None,
        prefix_manager=None,
        spark=None,
        monitor=None,
        netlink=None,
        device=None,
        serving=None,
        mesh=None,
        te=None,
        fuzz=None,
        sched=None,
        obs=None,
        snapshot=None,
        config=None,
        kvstore_updates_queue: Optional[ReplicateQueue[Publication]] = None,
        fib_updates_queue: Optional[ReplicateQueue] = None,
        config_store=None,
        watchdog=None,
        queues: Optional[dict[str, ReplicateQueue]] = None,
    ) -> None:
        self.node_name = node_name
        self.config_store = config_store
        self.watchdog = watchdog
        self.queues = queues
        self.kvstore = kvstore
        self.decision = decision
        self.fib = fib
        self.link_monitor = link_monitor
        self.prefix_manager = prefix_manager
        self.spark = spark
        self.monitor = monitor
        self.netlink = netlink
        # device-residency engine (device.engine.DeviceResidencyEngine):
        # exports device.engine.* through get_counters like any module
        self.device = device
        # query scheduler (serving.QueryScheduler): async query
        # methods below submit into its admission queue; exports serving.*
        self.serving = serving
        # blocked-APSP node-sharding rung (openr_tpu.parallel.blocked
        # .BlockedApspEngine): exports mesh.blocked.* the same way
        self.mesh = mesh
        # differentiable-TE optimizer (te.TeOptimizer): exports
        # te.* counters (pre-seeded at construction) the same way
        self.te = te
        # chaos fuzzer registry (chaos.fuzz.FUZZ_COUNTERS):
        # exports chaos.fuzz.* (pre-seeded zeros) the same way
        self.fuzz = fuzz
        # schedule-exploration registry (analysis.sched.SCHED_COUNTERS):
        # exports sched.* (pre-seeded zeros) the same way
        self.sched = sched
        # observability surface (obs.ObsStats): exports obs.*
        # trace counters (zeroed when unarmed) plus the dumpTraces /
        # getSpanSamples methods below
        self.obs = obs
        # engine-snapshot registry (openr_tpu.snapshot.SNAPSHOT_COUNTERS):
        # exports snapshot.* (pre-seeded zeros) the same way
        self.snapshot = snapshot
        self.config = config
        self.kvstore_updates_queue = kvstore_updates_queue
        self.fib_updates_queue = fib_updates_queue
        self.methods: dict[str, Callable[[dict], Any]] = {}
        # coroutine-valued methods awaited on the server loop instead of
        # the executor: serving queries park on the scheduler's future,
        # so an executor thread per in-flight query would defeat the
        # admission queue's purpose
        self.async_methods: dict[str, Callable[[dict], Awaitable[Any]]] = {}
        self._register_methods()

    def _need(self, module, name: str):
        if module is None:
            raise CtrlError(f"module {name} not available")
        return module

    def _register_methods(self) -> None:
        m = self.methods
        # -- meta ------------------------------------------------------------
        m["getMyNodeName"] = lambda p: self.node_name
        m["getOpenrVersion"] = lambda p: {
            "version": OPENR_VERSION,
            "lowestSupportedVersion": OPENR_LOWEST_SUPPORTED_VERSION,
        }
        m["getRunningConfig"] = lambda p: (
            self.config.to_dict() if self.config is not None else {}
        )
        # parse+validate config file CONTENTS without applying anything
        # (reference: dryrunConfig, OpenrCtrlHandler.h:69-78)
        m["dryrunConfig"] = self._dryrun_config
        m["getCounters"] = lambda p: self._all_counters()
        m["getRegexCounters"] = lambda p: {
            k: v
            for k, v in self._all_counters().items()
            if re.search(p["regex"], k)
        }
        m["getBuildInfo"] = lambda p: {
            "buildPackageName": "openr_tpu_torch",
            "buildPackageVersion": OPENR_VERSION,
            "buildMode": "cuda",
        }
        # -- observability (span traces; empty lists when unarmed) -----------
        m["dumpTraces"] = lambda p: (
            [] if self.obs is None else self.obs.dump_traces(p.get("n", 16))
        )
        m["getSpanSamples"] = lambda p: (
            [] if self.obs is None else self.obs.span_samples(p.get("n", 32))
        )

        # -- persistent config store (reference: set/get/eraseConfigKey,
        #    OpenrCtrlHandler.h:60-67 over PersistentStore)
        m["setConfigKey"] = lambda p: self._need(
            self.config_store, "config-store"
        ).store(p["key"], p["value"])
        m["getConfigKey"] = lambda p: self._need(
            self.config_store, "config-store"
        ).load(p["key"])
        m["eraseConfigKey"] = lambda p: self._need(
            self.config_store, "config-store"
        ).erase(p["key"])

        # -- kvstore ----------------------------------------------------------
        m["getKvStoreKeyValsArea"] = lambda p: self._need(
            self.kvstore, "kvstore"
        ).get_key_vals(p.get("area", "0"), p["keys"])
        m["getKvStoreKeyValsFilteredArea"] = self._kvstore_dump_filtered
        m["getKvStoreHashFilteredArea"] = lambda p: self._need(
            self.kvstore, "kvstore"
        ).dump_hashes(
            p.get("area", "0"),
            p.get("prefixes", []),
            p.get("originators", []),
        )
        m["setKvStoreKeyVals"] = self._kvstore_set
        m["getKvStorePeersArea"] = lambda p: self._need(
            self.kvstore, "kvstore"
        ).dump_peers(p.get("area", "0"))
        m["getKvStoreAreaSummary"] = self._kvstore_summary
        # DUAL flood-topology (reference: OpenrCtrl.thrift getSpanningTreeInfos
        # + updateFloodTopologyChild; dual messages rode the ZMQ channel in
        # the reference, here they are plain ctrl methods)
        m["processKvStoreDualMessage"] = lambda p: self._need(
            self.kvstore, "kvstore"
        ).process_dual_messages(p.get("area", "0"), p["messages"])
        m["updateFloodTopologyChild"] = lambda p: self._need(
            self.kvstore, "kvstore"
        ).process_flood_topo_set(p.get("area", "0"), p["params"])
        m["getSpanningTreeInfos"] = lambda p: self._need(
            self.kvstore, "kvstore"
        ).get_flood_topo(p.get("area", "0"))

        # -- decision ---------------------------------------------------------
        m["getRouteDb"] = lambda p: self._need(
            self.decision, "decision"
        ).get_route_db(p.get("node", ""))
        # fleet-wide route dump from the reduced all-sources product (new
        # capability vs the reference's one-node-at-a-time
        # getRouteDbComputed, Decision.cpp:1510-1530)
        m["getFleetRoutes"] = lambda p: self._need(
            self.decision, "decision"
        ).get_fleet_route_dbs(p.get("nodes"))
        m["getDecisionAdjacenciesFiltered"] = lambda p: self._need(
            self.decision, "decision"
        ).get_adjacency_databases(
            set(p["areas"]) if p.get("areas") else None
        )
        m["getReceivedRoutesFiltered"] = lambda p: self._need(
            self.decision, "decision"
        ).get_received_routes(
            prefixes=p.get("prefixes"),
            node_name=p.get("node"),
            area_name=p.get("area"),
        )
        # failure-protection analysis (new capabilities; no reference RPC)
        m["decisionWhatIf"] = lambda p: self._need(
            self.decision, "decision"
        ).what_if(
            [[tuple(link) for link in sc] for sc in p["scenarios"]],
            area=p.get("area", "0"),
            sources=p.get("sources"),
        )
        m["decisionTiLfa"] = lambda p: self._need(
            self.decision, "decision"
        ).get_ti_lfa(p.get("node", ""), area=p.get("area", "0"))
        m["setRibPolicy"] = lambda p: self._need(
            self.decision, "decision"
        ).set_rib_policy(p["policy"])
        m["getRibPolicy"] = lambda p: self._need(
            self.decision, "decision"
        ).get_rib_policy()
        m["clearRibPolicy"] = lambda p: self._need(
            self.decision, "decision"
        ).clear_rib_policy()

        # -- serving (async: admission-queued, coalesced, batched) ------------
        a = self.async_methods
        a["queryPaths"] = lambda p: self._serving_query("paths", p)
        a["queryWhatIf"] = lambda p: self._serving_query("what_if", p)
        a["queryKsp"] = lambda p: self._serving_query("ksp", p)
        # differentiable TE: demand matrix + bounds in, exactly-validated
        # proposed metrics + objective delta out; rides the scheduler's
        # admission/epoch machinery (a flap mid-run aborts, never retries)
        a["optimizeMetrics"] = self._optimize_metrics

        # -- fib --------------------------------------------------------------
        m["getRouteDbFib"] = self._fib_route_db
        m["getUnicastRoutesFiltered"] = lambda p: self._need(
            self.fib, "fib"
        ).get_unicast_routes(p.get("prefixes"))
        # MPLS route dumps (reference: getMplsRoutes/getMplsRoutesFiltered)
        m["getMplsRoutes"] = lambda p: self._need(self.fib, "fib").get_route_db()[1]
        m["getMplsRoutesFiltered"] = self._mpls_routes_filtered
        m["getPerfDb"] = lambda p: self._need(self.fib, "fib").get_perf_db()

        # -- link-monitor -----------------------------------------------------
        lm = lambda: self._need(self.link_monitor, "link-monitor")  # noqa: E731
        m["getInterfaces"] = lambda p: lm().get_interfaces()
        m["getLinkMonitorAdjacenciesFiltered"] = lambda p: lm().get_adjacencies(
            p.get("area", "0")
        )
        m["getLinkMonitorState"] = lambda p: self._lm_state()
        m["setNodeOverload"] = lambda p: lm().set_node_overload(True)
        m["unsetNodeOverload"] = lambda p: lm().set_node_overload(False)
        # soft-drain (reference: semiDrainNode / nodeMetricIncrementVal)
        m["setNodeInterfaceMetricIncrease"] = lambda p: (
            lm().set_node_metric_increment(p["metricIncrementVal"])
        )
        m["unsetNodeInterfaceMetricIncrease"] = lambda p: (
            lm().set_node_metric_increment(0)
        )
        m["setInterfaceOverload"] = lambda p: lm().set_link_overload(
            p["interface"], True
        )
        m["unsetInterfaceOverload"] = lambda p: lm().set_link_overload(
            p["interface"], False
        )
        m["setInterfaceMetric"] = lambda p: lm().set_link_metric(
            p["interface"], p["metric"]
        )
        m["unsetInterfaceMetric"] = lambda p: lm().set_link_metric(
            p["interface"], None
        )
        m["setAdjacencyMetric"] = lambda p: lm().set_adj_metric(
            p["interface"], p["node"], p["metric"]
        )
        m["unsetAdjacencyMetric"] = lambda p: lm().set_adj_metric(
            p["interface"], p["node"], None
        )

        # -- prefix-manager ---------------------------------------------------
        pm = lambda: self._need(self.prefix_manager, "prefix-manager")  # noqa: E731
        m["advertisePrefixes"] = lambda p: pm().advertise_prefixes(
            p["type"], p["prefixes"]
        )
        m["withdrawPrefixes"] = lambda p: pm().withdraw_prefixes(
            p["type"], [e.prefix if hasattr(e, "prefix") else e for e in p["prefixes"]]
        )
        m["syncPrefixesByType"] = lambda p: pm().sync_prefixes_by_type(
            p["type"], p["prefixes"]
        )
        m["withdrawPrefixesByType"] = lambda p: pm().withdraw_prefixes_by_type(
            p["type"]
        )
        m["getPrefixes"] = lambda p: pm().get_prefixes()
        m["getPrefixesByType"] = lambda p: pm().get_prefixes(p["type"])
        m["getOriginatedPrefixes"] = lambda p: pm().get_originated_prefixes()

        # -- spark ------------------------------------------------------------
        m["getSparkNeighbors"] = self._spark_neighbors
        m["getNeighbors"] = self._spark_neighbors  # deprecated ref alias
        # announce our own graceful restart to all neighbors (reference:
        # floodRestartingMsg, OpenrCtrlHandler.h / Spark.h:99)
        m["floodRestartingMsg"] = lambda p: self._need(
            self.spark, "spark"
        ).flood_restarting_msg()

        # -- deprecated area-less reference names: every area-taking
        # handler above defaults to area "0", so these are pure aliases
        # (the reference kept both during its area migration,
        # OpenrCtrlHandler.h getKvStoreKeyVals vs ...Area etc.)
        m["getKvStoreKeyVals"] = m["getKvStoreKeyValsArea"]
        m["getKvStoreKeyValsFiltered"] = m["getKvStoreKeyValsFilteredArea"]
        m["getKvStoreHashFiltered"] = m["getKvStoreHashFilteredArea"]
        m["getKvStorePeers"] = m["getKvStorePeersArea"]
        m["getLinkMonitorAdjacencies"] = m["getLinkMonitorAdjacenciesFiltered"]
        m["getReceivedRoutes"] = m["getReceivedRoutesFiltered"]
        m["getUnicastRoutes"] = m["getUnicastRoutesFiltered"]
        m["getDecisionAdjacencyDbs"] = m["getDecisionAdjacenciesFiltered"]
        m["getAdvertisedRoutes"] = self._advertised_routes
        m["getAdvertisedRoutesFiltered"] = self._advertised_routes
        m["getRouteDetailDb"] = self._route_detail_db

    # -- serving queries ------------------------------------------------------

    async def _serving_query(self, op: str, p: dict) -> dict:
        """Submit one query into the scheduler's admission queue and park
        on its future (no executor thread held while queued/coalesced).
        Sheds surface as explicit QueryShedError wire errors."""
        serving = self._need(self.serving, "serving")
        kw: dict = {}
        if p.get("session") and getattr(serving, "supports_sessions", False):
            # fleet front-door (serving.ReplicaRouter): a client-supplied
            # session id opts into epoch pinning — replies only ever move
            # forward in topology version for that session
            kw["session"] = str(p["session"])
        fut = serving.submit(
            op,
            area=p.get("area", "0"),
            sources=p.get("sources") or (),
            scenarios=[
                [tuple(link) for link in sc]
                for sc in (p.get("scenarios") or [])
            ],
            dests=p.get("dests") or (),
            k=p.get("k", 2),
            use_link_metric=p.get("useLinkMetric", True),
            **kw,
        )
        res = await asyncio.wrap_future(fut)
        return {
            "result": self._shape_query_value(op, res.value),
            "epoch": res.epoch,
            "batchSize": res.batch_size,
            "latencyUs": res.latency_us,
        }

    async def _optimize_metrics(self, p: dict) -> dict:
        """Wire surface of the TE optimizer.  Params: ``demand`` as
        [[src, dest, volume], ...], ``metricLo``/``metricHi`` bounds,
        ``steps`` descent budget, ``area``.  The reply's proposed
        metrics come from the exact uint32 validation gate — never from
        the smoothed model."""
        serving = self._need(self.serving, "serving")
        fut = serving.submit(
            "optimize_metrics",
            area=p.get("area", "0"),
            demand=[
                (row[0], row[1], row[2]) for row in (p.get("demand") or [])
            ],
            bounds=(p.get("metricLo", 1), p.get("metricHi", 64)),
            steps=p.get("steps", 32),
        )
        res = await asyncio.wrap_future(fut)
        return {
            "result": res.value,
            "epoch": res.epoch,
            "batchSize": res.batch_size,
            "latencyUs": res.latency_us,
        }

    @staticmethod
    def _shape_query_value(op: str, value) -> Any:
        if op == "paths":
            # {source: SpfResult} -> JSON-able metric + next-hop sets
            return {
                src: {
                    dest: {
                        "metric": int(r.metric),
                        "nextHops": sorted(r.next_hops),
                    }
                    for dest, r in spf.items()
                }
                for src, spf in value.items()
            }
        if op == "ksp":
            # {dest: [Path]} -> hop-pair lists
            return {
                dest: [
                    [[link.n1, link.n2] for link in path] for path in paths
                ]
                for dest, paths in value.items()
            }
        return value  # what_if rows are already wire-safe dicts

    # -- non-lambda handlers --------------------------------------------------

    def _all_counters(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for module in (
            self.kvstore,
            self.decision,
            self.fib,
            self.link_monitor,
            self.prefix_manager,
            self.spark,
            self.monitor,
            self.netlink,
            self.device,
            self.serving,
            self.mesh,
            self.te,
            self.fuzz,
            self.sched,
            self.obs,
            self.snapshot,
        ):
            if module is None:
                continue
            get = getattr(module, "get_counters", None)
            if callable(get):
                out.update(get())
            elif hasattr(module, "counters"):
                out.update(module.counters)
        if self.watchdog is not None:
            out.update(self.watchdog.get_counters())
        if self.queues:
            from ..runtime.queue import queue_counters

            out.update(queue_counters(self.queues))
        return out

    def _kvstore_dump_filtered(self, p: dict) -> Any:
        from ..kvstore.kvstore import KeyDumpParams

        kvstore = self._need(self.kvstore, "kvstore")
        area = p.get("area", "0")
        if p.get("match_all") or p.get("hash_only"):
            # display-oriented dump variants (no 3-way semantics)
            return kvstore.dump_all(
                area,
                key_prefixes=p.get("prefixes", []),
                originator_ids=p.get("originators", []),
                match_all=p.get("match_all", False),
                do_not_publish_value=p.get("hash_only", False),
            )
        # the same path the in-process peer transport uses (3-way diff when
        # key_val_hashes is present, remaining-TTL adjustment always)
        return kvstore.process_full_dump(
            area,
            KeyDumpParams(
                keys=p.get("prefixes", []),
                originator_ids=p.get("originators", []),
                key_val_hashes=p.get("key_val_hashes"),
            ),
        )

    def _dryrun_config(self, p: dict) -> dict:
        """Validate config-file CONTENTS; returns the parsed config dict
        or raises (surfaced to the client as the RPC error) — nothing is
        applied (reference: dryrunConfig)."""
        import json as _json

        from ..config import config_from_dict

        data = _json.loads(p["file_contents"])
        return config_from_dict(data).to_dict()

    def _mpls_routes_filtered(self, p: dict) -> list:
        routes = self._need(self.fib, "fib").get_route_db()[1]
        labels = p.get("labels")
        if not labels:
            return routes
        wanted = set(labels)
        return [r for r in routes if r.top_label in wanted]

    def _kvstore_set(self, p: dict) -> None:
        kvstore = self._need(self.kvstore, "kvstore")
        kvstore.set_key_vals(
            p.get("area", "0"),
            p["key_vals"],
            node_ids=p.get("node_ids"),
            flood_root_id=p.get("flood_root_id"),
        )

    def _kvstore_summary(self, p: dict) -> list[dict]:
        kvstore = self._need(self.kvstore, "kvstore")
        out = []
        for area in kvstore.areas:
            pub = kvstore.dump_all(area)
            out.append(
                {
                    "area": area,
                    "keyValsCount": len(pub.key_vals),
                    "keyValsBytes": sum(
                        len(v.value or b"") for v in pub.key_vals.values()
                    ),
                    "peersCount": len(kvstore.dump_peers(area)),
                }
            )
        return out

    def _lm_state(self) -> dict:
        state = self._need(self.link_monitor, "link-monitor").get_state()
        return {
            "is_overloaded": state.is_overloaded,
            "overloaded_links": sorted(state.overloaded_links),
            "link_metric_overrides": dict(state.link_metric_overrides),
            "node_label": state.node_label,
            "adj_metric_overrides": {
                f"{if_name}|{node}": metric
                for (if_name, node), metric in state.adj_metric_overrides.items()
            },
        }

    def _fib_route_db(self, p: dict) -> dict:
        fib = self._need(self.fib, "fib")
        unicast, mpls = fib.get_route_db(
            programmed_only=bool(p.get("programmedOnly"))
        )
        return {"unicastRoutes": unicast, "mplsRoutes": mpls}

    def _advertised_routes(self, p: dict) -> list[dict]:
        """Per-prefix advertisement detail from PrefixManager (reference:
        getAdvertisedRoutesFiltered, OpenrCtrlHandler.h:129-140 — one row
        per prefix with every per-type entry; filterable by prefixes)."""
        pm = self._need(self.prefix_manager, "prefix-manager")
        from ..types import PrefixType, normalize_prefix

        wanted = (
            {normalize_prefix(x) for x in p["prefixes"]}
            if p.get("prefixes")
            else None
        )
        by_prefix: dict[str, list[tuple[int, Any]]] = {}
        for ptype in PrefixType:
            for entry in pm.get_prefixes(ptype):
                prefix = normalize_prefix(entry.prefix)
                if wanted is not None and prefix not in wanted:
                    continue
                by_prefix.setdefault(prefix, []).append(
                    (int(ptype), entry)
                )
        return [
            {"prefix": prefix, "routes": rows}
            for prefix, rows in sorted(by_prefix.items())
        ]

    def _route_detail_db(self, p: dict) -> dict:
        """Computed unicast/MPLS entries WITH their best-prefix-entry
        detail (reference: getRouteDetailDb, OpenrCtrlHandler.h:98 —
        the Fib view annotated with route provenance).  Served from
        Decision's RibEntries, which carry best_prefix_entry/best_area."""
        decision = self._need(self.decision, "decision")
        db = decision.get_route_db()
        return {
            "unicastRoutes": db.unicast_routes,
            "mplsRoutes": db.mpls_routes,
        }

    def _spark_neighbors(self, p: dict) -> list[dict]:
        spark = self._need(self.spark, "spark")
        return [
            {
                "nodeName": n.node_name,
                "ifName": n.if_name,
                "remoteIfName": n.remote_if_name,
                "state": n.state.name,
                "area": n.area,
                "rttUs": n.rtt_us,
                "transportAddressV6": n.transport_addr_v6,
                "openrCtrlThriftPort": n.ctrl_port,
            }
            for n in spark.get_neighbors()
        ]


class CtrlServer(OpenrEventBase):
    """TCP server event base (reference: ThriftServer setup,
    openr/Main.cpp:546-612; deliberately few worker threads — handlers
    marshal onto the owning modules)."""

    def __init__(
        self,
        handler: OpenrCtrlHandler,
        host: str = "::1",
        port: int = 2018,
        tls=None,  # Optional[tls.TlsConfig] — mTLS + peer-name ACL
    ) -> None:
        super().__init__(name="ctrl-server")
        self.handler = handler
        self.host = host
        self.port = port
        self.tls = tls
        self._server: Optional[asyncio.AbstractServer] = None

    def run(self) -> None:
        super().run()
        self.wait_until_running()
        fut = self.run_coroutine(self._start())
        fut.result(timeout=10)

    async def _start(self) -> None:
        ssl_ctx = None
        if self.tls is not None:
            from .tls import server_context

            ssl_ctx = server_context(self.tls)
        self._server = await asyncio.start_server(
            self._handle_conn,
            self.host,
            self.port,
            ssl=ssl_ctx,
            limit=WIRE_LINE_LIMIT,
        )
        if self.port == 0:  # ephemeral: record the real port
            self.port = self._server.sockets[0].getsockname()[1]

    def stop(self) -> None:
        if self._server is not None and self._loop is not None:
            server, self._server = self._server, None

            def _close() -> None:
                server.close()

            try:
                self.run_in_event_base_thread(_close).result(timeout=5)
            except Exception:
                pass
        super().stop()

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        # peer-name ACL (reference: Main.cpp:546-612 wires the client-CN
        # allowlist into the thrift server's TLS policy)
        if self.tls is not None:
            from .tls import check_acl, peer_common_name

            ssl_object = writer.get_extra_info("ssl_object")
            peer_cn = peer_common_name(ssl_object) if ssl_object else None
            if not check_acl(self.tls, peer_cn):
                log.warning(
                    "ctrl: rejecting peer %r (ACL %r)",
                    peer_cn,
                    self.tls.acl_regex,
                )
                writer.close()
                return

        streams: dict[int, asyncio.Task] = {}
        write_lock = asyncio.Lock()

        async def send(obj: dict) -> None:
            async with write_lock:
                writer.write(json.dumps(obj).encode() + b"\n")
                await writer.drain()

        try:
            while True:
                try:
                    line = await reader.readline()
                except ValueError:  # over WIRE_LINE_LIMIT: say so, hang up
                    await send(
                        {"id": None, "error": "request line too long"}
                    )
                    break
                if not line:
                    break
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError:
                    await send({"id": None, "error": "bad json"})
                    continue
                if not isinstance(msg, dict):
                    await send({"id": None, "error": "bad request"})
                    continue
                msg_id = msg.get("id")
                if msg.get("cancel"):
                    task = streams.pop(msg_id, None)
                    if task is not None:
                        task.cancel()
                    continue
                method = msg.get("method", "")
                try:
                    params = from_wire(msg.get("params") or {})
                except Exception as e:  # bad payload must not kill the conn
                    await send(
                        {"id": msg_id, "error": f"bad params: {e}"}
                    )
                    continue
                # reference stream names accepted as aliases
                # (subscribeAndGetKvStore[Filtered] / subscribeAndGetFib,
                # OpenrCtrlHandler.h:240-267)
                if method in (
                    "subscribeKvStore",
                    "subscribeAndGetKvStore",
                    "subscribeAndGetKvStoreFiltered",
                ):
                    streams[msg_id] = asyncio.ensure_future(
                        self._stream_kvstore(msg_id, params, send)
                    )
                    self._track(streams[msg_id])
                elif method in ("subscribeFib", "subscribeAndGetFib"):
                    streams[msg_id] = asyncio.ensure_future(
                        self._stream_fib(msg_id, params, send)
                    )
                    self._track(streams[msg_id])
                elif method in (
                    "longPollKvStoreAdjArea",
                    "longPollKvStoreAdj",
                ):
                    streams[msg_id] = asyncio.ensure_future(
                        self._long_poll_adj(msg_id, params, send)
                    )
                    self._track(streams[msg_id])
                else:
                    await self._dispatch(msg_id, method, params, send)
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass
        finally:
            for task in streams.values():
                task.cancel()
            writer.close()

    async def _dispatch(self, msg_id, method, params, send) -> None:
        afn = self.handler.async_methods.get(method)
        if afn is not None:
            # serving queries park on the scheduler future for the whole
            # admission->coalesce->dispatch pipeline: run them as tracked
            # tasks so one connection can pipeline many in-flight queries
            task = asyncio.ensure_future(
                self._run_async_method(msg_id, afn, params, send)
            )
            self._track(task)
            return
        fn = self.handler.methods.get(method)
        if fn is None:
            await send({"id": msg_id, "error": f"unknown method {method!r}"})
            return
        try:
            # module APIs block on cross-thread futures: keep them off the
            # server loop
            result = await asyncio.get_running_loop().run_in_executor(
                None, fn, params
            )
            await send({"id": msg_id, "result": to_wire(result)})
        except Exception as e:  # noqa: BLE001
            log.debug("ctrl: %s failed", method, exc_info=True)
            await send({"id": msg_id, "error": f"{type(e).__name__}: {e}"})

    async def _run_async_method(self, msg_id, afn, params, send) -> None:
        try:
            result = await afn(params)
            await send({"id": msg_id, "result": to_wire(result)})
        except (asyncio.CancelledError, ConnectionResetError):
            pass
        except Exception as e:  # noqa: BLE001
            log.debug("ctrl: async method failed", exc_info=True)
            try:
                await send({"id": msg_id, "error": f"{type(e).__name__}: {e}"})
            except (ConnectionResetError, RuntimeError):
                pass

    # -- streaming (reference: OpenrCtrlHandler.h:240-273) --------------------

    async def _stream_kvstore(self, msg_id, params, send) -> None:
        """subscribeAndGetKvStore: snapshot + filtered delta stream."""
        queue = self.handler.kvstore_updates_queue
        if queue is None:
            await send({"id": msg_id, "error": "kvstore stream unavailable"})
            return
        area = params.get("area", "0")
        prefixes = params.get("prefixes") or []
        reader = queue.get_reader()
        try:
            if self.handler.kvstore is not None:
                snapshot = self.handler.kvstore.dump_all(
                    area, key_prefixes=prefixes
                )
                await send({"id": msg_id, "stream": to_wire(snapshot)})
            while True:
                pub = await reader.aget()
                if pub.area != area:
                    continue
                if prefixes:
                    filtered = Publication(
                        key_vals={
                            k: v
                            for k, v in pub.key_vals.items()
                            if any(k.startswith(p) for p in prefixes)
                        },
                        expired_keys=[
                            k
                            for k in pub.expired_keys
                            if any(k.startswith(p) for p in prefixes)
                        ],
                        area=pub.area,
                    )
                    if not filtered.key_vals and not filtered.expired_keys:
                        continue
                    pub = filtered
                await send({"id": msg_id, "stream": to_wire(pub)})
        except (QueueClosedError, asyncio.CancelledError, ConnectionResetError):
            pass
        finally:
            queue.close_reader(reader)

    async def _stream_fib(self, msg_id, params, send) -> None:
        queue = self.handler.fib_updates_queue
        if queue is None:
            await send({"id": msg_id, "error": "fib stream unavailable"})
            return
        reader = queue.get_reader()
        try:
            while True:
                update = await reader.aget()
                await send({"id": msg_id, "stream": to_wire(update)})
        except (QueueClosedError, asyncio.CancelledError, ConnectionResetError):
            pass
        finally:
            queue.close_reader(reader)

    async def _long_poll_adj(self, msg_id, params, send) -> None:
        """longPollKvStoreAdjArea: resolve when any adj: key changes beyond
        the client's snapshot (reference: OpenrCtrlHandler.h:269)."""
        queue = self.handler.kvstore_updates_queue
        if queue is None:
            await send({"id": msg_id, "error": "kvstore stream unavailable"})
            return
        area = params.get("area", "0")
        snapshot: dict[str, int] = params.get("snapshot") or {}
        reader = queue.get_reader()
        try:
            # immediate resolution if current state already differs
            if self.handler.kvstore is not None:
                current = self.handler.kvstore.dump_all(
                    area, key_prefixes=[ADJ_MARKER]
                )
                for key, val in current.key_vals.items():
                    if snapshot.get(key) != val.version:
                        await send({"id": msg_id, "result": True})
                        return
            while True:
                pub = await reader.aget()
                if pub.area != area:
                    continue
                changed = any(
                    k.startswith(ADJ_MARKER)
                    and snapshot.get(k) != v.version
                    for k, v in pub.key_vals.items()
                ) or any(k.startswith(ADJ_MARKER) for k in pub.expired_keys)
                if changed:
                    await send({"id": msg_id, "result": True})
                    return
        except (QueueClosedError, asyncio.CancelledError, ConnectionResetError):
            pass
        finally:
            queue.close_reader(reader)
