"""breeze — operator CLI for openr_tpu_torch.

Port of `openr_tpu.cli.breeze` (reference: the click-based breeze,
openr/py/openr/cli/breeze.py + clis/*): per-module command groups over the
ctrl API.  argparse-based (no third-party CLI dependency).

    python -m openr_tpu_torch.cli.breeze [-H host] [-p port] <group> <command> [args]

`fib validate` audits the daemon's programmed routes against a FIB agent
(`python -m openr_tpu_torch.platform.fib_agent`) over its TCP wire.

Groups: kvstore, decision, fib, lm, prefixmgr, spark, monitor, config.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any

from ..ctrl.client import CtrlClient
from ..fib.fib import FIB_CLIENT_OPENR
from ..serializer import loads, to_wire
from ..types import PrefixEntry, PrefixType


def _print_json(obj: Any) -> None:
    print(json.dumps(to_wire(obj), indent=2, sort_keys=True))


def _table(rows: list[list[str]], header: list[str]) -> None:
    widths = [
        max(len(str(r[i])) for r in rows + [header]) for i in range(len(header))
    ]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    print(fmt.format(*header))
    print(fmt.format(*["-" * w for w in widths]))
    for row in rows:
        print(fmt.format(*[str(c) for c in row]))


# -- command implementations -------------------------------------------------


def cmd_kvstore_keys(client: CtrlClient, args) -> None:
    pub = client.call(
        "getKvStoreKeyValsFilteredArea",
        area=args.area,
        prefixes=[args.prefix] if args.prefix else [],
        hash_only=True,
    )
    rows = [
        [k, v.originator_id, v.version, v.ttl_version, v.ttl_ms]
        for k, v in sorted(pub.key_vals.items())
    ]
    _table(rows, ["Key", "Originator", "Version", "TTL Version", "TTL (ms)"])


def cmd_kvstore_keyvals(client: CtrlClient, args) -> None:
    pub = client.call("getKvStoreKeyValsArea", area=args.area, keys=args.keys)
    for key, val in sorted(pub.key_vals.items()):
        print(f"> {key}")
        if val.value is None:
            print("  (no value)")
            continue
        try:
            _print_json(loads(val.value))
        except Exception:
            print(f"  {val.value!r}")


def cmd_kvstore_peers(client: CtrlClient, args) -> None:
    peers = client.call("getKvStorePeersArea", area=args.area)
    rows = [
        [name, spec.peer_addr, spec.ctrl_port, spec.state.name]
        for name, spec in sorted(peers.items())
    ]
    _table(rows, ["Peer", "Address", "Port", "State"])


def cmd_kvstore_summary(client: CtrlClient, args) -> None:
    _print_json(client.call("getKvStoreAreaSummary"))


def cmd_kvstore_floodtopo(client: CtrlClient, args) -> None:
    """DUAL SPT view (reference: OpenrCtrlHandler
    semifuture_getSpanningTreeInfos, OpenrCtrlHandler.h:220)."""
    infos = client.call("getSpanningTreeInfos", area=args.area)
    print(f"flood-root: {infos.flood_root_id}")
    print(f"flood-peers: {', '.join(infos.flood_peers) or '(full mesh)'}")
    rows = [
        [root, "PASSIVE" if spt.passive else "ACTIVE", spt.cost,
         spt.parent or "-", ",".join(spt.children) or "-"]
        for root, spt in sorted(infos.infos.items())
    ]
    _table(rows, ["Root", "State", "Cost", "Parent", "Children"])


def cmd_kvstore_snoop(client: CtrlClient, args) -> None:
    """Stream KvStore deltas (reference: KvStoreSnooper tool)."""
    for pub in client.stream(
        "subscribeKvStore", area=args.area, prefixes=args.prefixes or []
    ):
        for key, val in sorted(pub.key_vals.items()):
            print(f"UPDATE {key} v={val.version} from={val.originator_id}")
        for key in pub.expired_keys:
            print(f"EXPIRE {key}")


def cmd_decision_routes(client: CtrlClient, args) -> None:
    db = client.call("getRouteDb", node=args.node)
    print(f"== Unicast Routes ({len(db.unicast_routes)}) ==")
    for prefix, entry in sorted(db.unicast_routes.items()):
        print(f"> {prefix}")
        for nh in sorted(entry.nexthops, key=lambda n: n.address):
            label = f" mpls {nh.mpls_action.action.name}" if nh.mpls_action else ""
            print(
                f"  via {nh.address}%{nh.if_name} metric {nh.metric}{label}"
            )
    if db.mpls_routes:
        print(f"== MPLS Routes ({len(db.mpls_routes)}) ==")
        for label, entry in sorted(db.mpls_routes.items()):
            nhs = ", ".join(
                f"{nh.address}({nh.mpls_action.action.name if nh.mpls_action else '-'})"
                for nh in sorted(entry.nexthops, key=lambda n: n.address)
            )
            print(f"> {label} via {nhs}")


def cmd_decision_fleet_routes(client: CtrlClient, args) -> None:
    """Fleet-wide route dump: every router's unicast routes from ONE
    reduced all-sources device round (getFleetRoutes)."""
    dbs = client.call("getFleetRoutes", nodes=args.nodes or None)
    for node in sorted(dbs):
        db = dbs[node]
        print(
            f"== {node}: {len(db.unicast_routes)} unicast, "
            f"{len(db.mpls_routes)} mpls =="
        )
        if not args.summary:
            for prefix, entry in sorted(db.unicast_routes.items()):
                nhs = ", ".join(
                    f"{nh.neighbor_node_name or nh.address}"
                    for nh in sorted(entry.nexthops, key=lambda n: n.address)
                )
                print(f"> {prefix} via {nhs}")


def cmd_decision_adj(client: CtrlClient, args) -> None:
    dbs = client.call(
        "getDecisionAdjacenciesFiltered", areas=[args.area] if args.area else None
    )
    rows = []
    for db in sorted(dbs, key=lambda d: d.this_node_name):
        for adj in db.adjacencies:
            rows.append(
                [
                    db.this_node_name,
                    adj.other_node_name,
                    adj.if_name,
                    adj.metric,
                    "overloaded" if db.is_overloaded else "",
                ]
            )
    _table(rows, ["Node", "Neighbor", "Interface", "Metric", "Flags"])


def cmd_decision_received_routes(client: CtrlClient, args) -> None:
    _print_json(client.call("getReceivedRoutesFiltered", prefixes=args.prefixes))


def cmd_decision_what_if(client: CtrlClient, args) -> None:
    """Batched SRLG what-if failure analysis.  Each LINK is "nodeA/nodeB";
    by default all listed links form ONE scenario (a shared-risk group);
    --each makes every link its own scenario."""
    links = []
    for spec in args.links:
        if "/" not in spec:
            print(f"error: bad link spec {spec!r} (expected nodeA/nodeB)")
            raise SystemExit(2)
        links.append(tuple(spec.split("/", 1)))
    scenarios = [[list(l)] for l in links] if args.each else [[list(l) for l in links]]
    rows = client.call(
        "decisionWhatIf", scenarios=scenarios, area=args.area
    )
    table = []
    for row in rows:
        table.append(
            [
                row["scenario"],
                " ".join(f"{a}/{b}" for a, b in row["links"]) or "-",
                row["newly_unreachable_pairs"],
                row["degraded_pairs"],
                " ".join(f"{a}/{b}" for a, b in row["unknown_links"]) or "-",
            ]
        )
    _table(
        table,
        ["Scenario", "Failed links", "Unreachable pairs", "Degraded pairs", "Unknown"],
    )


def cmd_decision_tilfa(client: CtrlClient, args) -> None:
    """Per-adjacency TI-LFA backup analysis for a node."""
    report = client.call("decisionTiLfa", node=args.node, area=args.area)
    if "error" in report:
        print(f"error: {report['error']}")
        return
    print(f"node: {report['node']}")
    rows = []
    for adj in report["adjacencies"]:
        rows.append(
            [
                adj["neighbor"],
                adj["protected_destinations"],
                adj["unprotected_count"],
            ]
        )
    _table(rows, ["Failed adjacency", "Protected dests", "Unprotected dests"])
    if args.verbose:
        for adj in report["adjacencies"]:
            print(f"-- via {adj['neighbor']} failed:")
            for dest, hops in sorted(adj["backup_first_hops"].items()):
                print(f"   {dest}: {', '.join(hops) or '(none)'}")


def cmd_decision_path(client: CtrlClient, args) -> None:
    """Client-side path computation over adj DBs (reference:
    breeze decision path, openr/py/openr/cli/commands/decision.py:293)."""
    from ..decision.link_state import LinkState

    dbs = client.call("getDecisionAdjacenciesFiltered", areas=None)
    ls = LinkState(area=dbs[0].area if dbs else "0")
    for db in dbs:
        ls.update_adjacency_database(db)
    src = args.src or client.call("getMyNodeName")
    result = ls.get_spf_result(src)
    if args.dst not in result:
        print(f"no path from {src} to {args.dst}")
        sys.exit(1)
    # walk one shortest path backwards
    hops = [args.dst]
    node = args.dst
    while node != src:
        node = result[node].path_links[0][1]
        hops.append(node)
    hops.reverse()
    print(
        f"path from {src} to {args.dst} (metric {result[args.dst].metric}): "
        + " -> ".join(hops)
    )


def cmd_fib_routes(client: CtrlClient, args) -> None:
    db = client.call("getRouteDbFib")
    for route in sorted(db["unicastRoutes"], key=lambda r: r.dest):
        nhs = ", ".join(
            f"{nh.address}%{nh.if_name}" for nh in route.next_hops
        )
        print(f"{route.dest} via {nhs}")
    for route in sorted(db["mplsRoutes"], key=lambda r: r.top_label):
        print(f"label {route.top_label} nexthops {len(route.next_hops)}")


def cmd_fib_validate(client: CtrlClient, args) -> None:
    """Audit daemon FIB state against the platform agent's programmed
    table (reference: breeze fib validate against the FibService agent)."""
    from ..platform import TcpFibAgent

    # programmedOnly: do_not_install prefixes and (with segment routing
    # off) label routes are tracked by Fib but never sent to the agent
    db = client.call("getRouteDbFib", programmedOnly=True)
    daemon_unicast = {r.dest: r for r in db["unicastRoutes"]}
    daemon_mpls = {r.top_label: r for r in db["mplsRoutes"]}

    agent = TcpFibAgent(host=args.agent_host, port=args.agent_port)
    try:
        agent_unicast = {
            r.dest: r for r in agent.get_route_table_by_client(args.client_id)
        }
        agent_mpls = {
            r.top_label: r
            for r in agent.get_mpls_route_table_by_client(args.client_id)
        }
    except OSError as e:
        print(
            f"cannot reach fib agent at "
            f"[{args.agent_host}]:{args.agent_port}: {e}"
        )
        raise SystemExit(1)
    finally:
        agent.close()

    ok = True
    for label, daemon_table, agent_table in (
        ("unicast", daemon_unicast, agent_unicast),
        ("mpls", daemon_mpls, agent_mpls),
    ):
        missing = sorted(set(daemon_table) - set(agent_table))
        extra = sorted(set(agent_table) - set(daemon_table))
        mismatched = sorted(
            k
            for k in set(daemon_table) & set(agent_table)
            if set(daemon_table[k].next_hops) != set(agent_table[k].next_hops)
        )
        for kind, keys in (
            ("missing from agent", missing),
            ("extra in agent", extra),
            ("nexthop mismatch", mismatched),
        ):
            for key in keys:
                ok = False
                print(f"FAIL [{label}] {kind}: {key}")
        print(
            f"{label}: daemon={len(daemon_table)} agent={len(agent_table)}"
        )
    print("PASS" if ok else "FAIL")
    if not ok:
        raise SystemExit(1)


def cmd_fib_perf(client: CtrlClient, args) -> None:
    for perf in client.call("getPerfDb"):
        print(f"== convergence {perf.total_duration_ms()}ms ==")
        base = perf.events[0].unix_ts_ms if perf.events else 0
        for event in perf.events:
            print(f"  {event.event_name:<32} +{event.unix_ts_ms - base}ms")


def cmd_lm_links(client: CtrlClient, args) -> None:
    interfaces = client.call("getInterfaces")
    rows = [
        [name, "UP" if info.is_up else "DOWN", info.if_index, ",".join(info.networks)]
        for name, info in sorted(interfaces.items())
    ]
    _table(rows, ["Interface", "Status", "Index", "Addresses"])
    state = client.call("getLinkMonitorState")
    print(f"\nnode overloaded: {state['is_overloaded']}")
    if state["overloaded_links"]:
        print(f"overloaded links: {', '.join(state['overloaded_links'])}")
    if state["link_metric_overrides"]:
        print(f"metric overrides: {state['link_metric_overrides']}")


def cmd_lm_set_node_overload(client: CtrlClient, args) -> None:
    client.call("setNodeOverload")
    print("node overload set")


def cmd_lm_unset_node_overload(client: CtrlClient, args) -> None:
    client.call("unsetNodeOverload")
    print("node overload unset")


def cmd_lm_set_link_overload(client: CtrlClient, args) -> None:
    client.call("setInterfaceOverload", interface=args.interface)
    print(f"link overload set on {args.interface}")


def cmd_lm_unset_link_overload(client: CtrlClient, args) -> None:
    client.call("unsetInterfaceOverload", interface=args.interface)
    print(f"link overload unset on {args.interface}")


def cmd_lm_set_link_metric(client: CtrlClient, args) -> None:
    client.call(
        "setInterfaceMetric", interface=args.interface, metric=args.metric
    )
    print(f"metric {args.metric} set on {args.interface}")


def cmd_lm_unset_link_metric(client: CtrlClient, args) -> None:
    client.call("unsetInterfaceMetric", interface=args.interface)
    print(f"metric override removed from {args.interface}")


def cmd_prefixmgr_view(client: CtrlClient, args) -> None:
    entries = client.call("getPrefixes")
    rows = [
        [
            e.prefix,
            e.type.name,
            e.forwarding_type.name,
            e.forwarding_algorithm.name,
        ]
        for e in sorted(entries, key=lambda e: e.prefix)
    ]
    _table(rows, ["Prefix", "Type", "Forwarding", "Algorithm"])


def cmd_prefixmgr_advertise(client: CtrlClient, args) -> None:
    client.call(
        "advertisePrefixes",
        type=PrefixType[args.type],
        prefixes=[PrefixEntry(prefix=p, type=PrefixType[args.type]) for p in args.prefixes],
    )
    print(f"advertised {len(args.prefixes)} prefixes")


def cmd_prefixmgr_withdraw(client: CtrlClient, args) -> None:
    client.call(
        "withdrawPrefixes", type=PrefixType[args.type], prefixes=args.prefixes
    )
    print(f"withdrew {len(args.prefixes)} prefixes")


def cmd_prefixmgr_originated(client: CtrlClient, args) -> None:
    _print_json(client.call("getOriginatedPrefixes"))


def cmd_spark_neighbors(client: CtrlClient, args) -> None:
    neighbors = client.call("getSparkNeighbors")
    rows = [
        [
            n["nodeName"],
            n["state"],
            n["ifName"],
            n["remoteIfName"],
            n["area"],
            n["rttUs"],
        ]
        for n in neighbors
    ]
    _table(rows, ["Neighbor", "State", "Local If", "Remote If", "Area", "RTT (us)"])


def cmd_monitor_counters(client: CtrlClient, args) -> None:
    counters = (
        client.call("getRegexCounters", regex=args.regex)
        if args.regex
        else client.call("getCounters")
    )
    for key in sorted(counters):
        print(f"{key} : {counters[key]}")


def _print_span(span: dict, depth: int = 0) -> None:
    tags = " ".join(f"{k}={v}" for k, v in sorted(span["tags"].items()))
    dur = span["duration_us"]
    dur_s = "?" if dur is None else f"{dur}us"
    pad = "  " * depth
    print(f"{pad}{span['name']} [{dur_s}]" + (f" {tags}" if tags else ""))
    for child in sorted(span["children"], key=lambda c: c["t_offset_us"]):
        _print_span(child, depth + 1)


def cmd_monitor_traces(client: CtrlClient, args) -> None:
    traces = client.call("dumpTraces", n=args.n)
    if not traces:
        print("no traces (is the daemon running with OPENR_TRACE=1?)")
        return
    for i, root in enumerate(traces):
        if i:
            print()
        _print_span(root)


def cmd_monitor_histograms(client: CtrlClient, args) -> None:
    counters = client.call("getCounters")
    families = sorted(
        k[: -len(".p50_us")] for k in counters if k.endswith(".p50_us")
    )
    if not families:
        print("no histogram families exported")
        return
    rows = [
        [
            fam,
            counters.get(f"{fam}.hist_us.count", 0),
            counters[f"{fam}.p50_us"],
            counters.get(f"{fam}.p99_us", 0),
            counters.get(f"{fam}.p999_us", 0),
        ]
        for fam in families
    ]
    _table(rows, ["Family", "Count", "p50 (us)", "p99 (us)", "p99.9 (us)"])


def cmd_config(client: CtrlClient, args) -> None:
    _print_json(client.call("getRunningConfig"))


def cmd_config_dryrun(client: CtrlClient, args) -> None:
    """Validate a config file through the daemon WITHOUT applying it
    (reference: dryrunConfig RPC, OpenrCtrlHandler.h:69-78)."""
    try:
        with open(args.file) as f:
            contents = f.read()
    except OSError as exc:
        # distinguish a bad file path from main()'s "cannot reach ctrl
        # server" OSError handler
        print(f"cannot read {args.file}: {exc}")
        raise SystemExit(2)
    try:
        parsed = client.call("dryrunConfig", file_contents=contents)
    except RuntimeError as exc:
        print(f"INVALID: {exc}")
        raise SystemExit(1)
    print("VALID")
    if args.verbose:
        _print_json(parsed)


def cmd_kvstore_compare(client: CtrlClient, args) -> None:
    """Diff this node's store against another node's (reference:
    breeze kvstore compare, openr/py/openr/cli/commands/kvstore.py)."""
    other = CtrlClient(args.other_host, args.other_port, tls=client.tls)
    try:
        # hash_only: the compare is on (version, originator, hash) —
        # fetching every value blob from both nodes would be waste
        mine = client.call(
            "getKvStoreKeyValsFilteredArea",
            area=args.area,
            match_all=True,
            hash_only=True,
        ).key_vals
        try:
            theirs = other.call(
                "getKvStoreKeyValsFilteredArea",
                area=args.area,
                match_all=True,
                hash_only=True,
            ).key_vals
        except OSError as exc:
            print(
                f"cannot reach remote ctrl server at "
                f"[{args.other_host}]:{args.other_port}: {exc}"
            )
            raise SystemExit(2)
    finally:
        other.close()
    rows = []
    for key in sorted(set(mine) | set(theirs)):
        a, b = mine.get(key), theirs.get(key)
        if a is None:
            rows.append([key, "MISSING-LOCAL", "", f"v{b.version}@{b.originator_id}"])
        elif b is None:
            rows.append([key, "MISSING-REMOTE", f"v{a.version}@{a.originator_id}", ""])
        elif (a.version, a.originator_id, a.hash) != (
            b.version,
            b.originator_id,
            b.hash,
        ):
            rows.append(
                [
                    key,
                    "DIFFERS",
                    f"v{a.version}@{a.originator_id}",
                    f"v{b.version}@{b.originator_id}",
                ]
            )
    if not rows:
        print(f"stores agree on {len(mine)} keys")
        return
    _table(rows, ["Key", "Status", "Local", "Remote"])
    raise SystemExit(1)


def cmd_fib_mpls(client: CtrlClient, args) -> None:
    routes = client.call(
        "getMplsRoutesFiltered", labels=args.labels or None
    )
    rows = [
        [
            r.top_label,
            ", ".join(
                f"{nh.address}@{nh.if_name or '-'}"
                + (
                    f" {nh.mpls_action.action.name}"
                    if nh.mpls_action is not None
                    else ""
                )
                for nh in r.next_hops
            ),
        ]
        for r in routes
    ]
    _table(rows, ["Label", "NextHops"])


def cmd_prefixmgr_withdraw_by_type(client: CtrlClient, args) -> None:
    client.call("withdrawPrefixesByType", type=PrefixType[args.type])
    print(f"withdrew all {args.type} prefixes")


def cmd_tech_support(client: CtrlClient, args) -> None:
    """One-shot operational snapshot (reference: breeze tech-support):
    every section is best-effort so a wedged module doesn't hide the
    others."""
    sections = [
        ("VERSION", lambda: client.call("getOpenrVersion")),
        ("NODE", lambda: client.call("getMyNodeName")),
        ("RUNNING CONFIG", lambda: client.call("getRunningConfig")),
        ("INTERFACES", lambda: client.call("getInterfaces")),
        ("SPARK NEIGHBORS", lambda: client.call("getSparkNeighbors")),
        (
            "KVSTORE SUMMARY",
            lambda: client.call("getKvStoreAreaSummary"),
        ),
        ("KVSTORE PEERS", lambda: client.call("getKvStorePeersArea")),
        (
            "ADJACENCIES",
            lambda: client.call("getDecisionAdjacenciesFiltered"),
        ),
        ("PREFIXES", lambda: client.call("getPrefixes")),
        ("DECISION ROUTES", lambda: client.call("getRouteDb", node="")),
        ("FIB ROUTES", lambda: client.call("getRouteDbFib")),
        ("FIB PERF", lambda: client.call("getPerfDb")),
        ("COUNTERS", lambda: client.call("getCounters")),
    ]
    for title, fetch in sections:
        print(f"\n======== {title} ========")
        try:
            _print_json(fetch())
        except Exception as exc:  # a dead module must not hide the rest
            print(f"<unavailable: {exc}>")


def cmd_version(client: CtrlClient, args) -> None:
    _print_json(client.call("getOpenrVersion"))


# -- parser ------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="breeze", description=__doc__)
    parser.add_argument("-H", "--host", default="::1")
    parser.add_argument("-p", "--port", type=int, default=2018)
    # mTLS against a TLS-enabled ctrl server (cert CN must pass its ACL)
    parser.add_argument("--tls-cert", default=None)
    parser.add_argument("--tls-key", default=None)
    parser.add_argument("--tls-ca", default=None)
    sub = parser.add_subparsers(dest="group", required=True)

    kv = sub.add_parser("kvstore").add_subparsers(dest="cmd", required=True)
    p = kv.add_parser("keys")
    p.add_argument("--prefix", default="")
    p.add_argument("--area", default="0")
    p.set_defaults(fn=cmd_kvstore_keys)
    p = kv.add_parser("keyvals")
    p.add_argument("keys", nargs="+")
    p.add_argument("--area", default="0")
    p.set_defaults(fn=cmd_kvstore_keyvals)
    p = kv.add_parser("peers")
    p.add_argument("--area", default="0")
    p.set_defaults(fn=cmd_kvstore_peers)
    p = kv.add_parser("summary")
    p.set_defaults(fn=cmd_kvstore_summary)
    p = kv.add_parser("floodtopo")
    p.add_argument("--area", default="0")
    p.set_defaults(fn=cmd_kvstore_floodtopo)
    p = kv.add_parser("compare")
    p.add_argument("other_host")
    p.add_argument("--other-port", type=int, default=2018)
    p.add_argument("--area", default="0")
    p.set_defaults(fn=cmd_kvstore_compare)
    p = kv.add_parser("snoop")
    p.add_argument("--area", default="0")
    p.add_argument("--prefixes", nargs="*")
    p.set_defaults(fn=cmd_kvstore_snoop)

    dec = sub.add_parser("decision").add_subparsers(dest="cmd", required=True)
    p = dec.add_parser("routes")
    p.add_argument("--node", default="")
    p.set_defaults(fn=cmd_decision_routes)
    p = dec.add_parser("fleet-routes")
    p.add_argument("--nodes", nargs="*")
    p.add_argument("--summary", action="store_true")
    p.set_defaults(fn=cmd_decision_fleet_routes)
    p = dec.add_parser("adj")
    p.add_argument("--area", default="")
    p.set_defaults(fn=cmd_decision_adj)
    p = dec.add_parser("received-routes")
    p.add_argument("prefixes", nargs="*")
    p.set_defaults(fn=cmd_decision_received_routes)
    p = dec.add_parser("path")
    p.add_argument("--src", default="")
    p.add_argument("dst")
    p.set_defaults(fn=cmd_decision_path)
    p = dec.add_parser("what-if")
    p.add_argument("links", nargs="+", metavar="LINK", help="nodeA/nodeB")
    p.add_argument("--each", action="store_true")
    p.add_argument("--area", default="0")
    p.set_defaults(fn=cmd_decision_what_if)
    p = dec.add_parser("tilfa")
    p.add_argument("node", nargs="?", default="")
    p.add_argument("--area", default="0")
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_decision_tilfa)

    fib = sub.add_parser("fib").add_subparsers(dest="cmd", required=True)
    p = fib.add_parser("validate")
    p.add_argument("--agent-host", default="::1")
    p.add_argument("--agent-port", type=int, default=60100)
    p.add_argument("--client-id", type=int, default=FIB_CLIENT_OPENR)
    p.set_defaults(fn=cmd_fib_validate)
    p = fib.add_parser("routes")
    p.set_defaults(fn=cmd_fib_routes)
    p = fib.add_parser("mpls")
    p.add_argument("--labels", nargs="*", type=int, default=None)
    p.set_defaults(fn=cmd_fib_mpls)
    p = fib.add_parser("perf")
    p.set_defaults(fn=cmd_fib_perf)

    lm = sub.add_parser("lm").add_subparsers(dest="cmd", required=True)
    p = lm.add_parser("links")
    p.set_defaults(fn=cmd_lm_links)
    p = lm.add_parser("set-node-overload")
    p.set_defaults(fn=cmd_lm_set_node_overload)
    p = lm.add_parser("unset-node-overload")
    p.set_defaults(fn=cmd_lm_unset_node_overload)
    p = lm.add_parser("set-link-overload")
    p.add_argument("interface")
    p.set_defaults(fn=cmd_lm_set_link_overload)
    p = lm.add_parser("unset-link-overload")
    p.add_argument("interface")
    p.set_defaults(fn=cmd_lm_unset_link_overload)
    p = lm.add_parser("set-link-metric")
    p.add_argument("interface")
    p.add_argument("metric", type=int)
    p.set_defaults(fn=cmd_lm_set_link_metric)
    p = lm.add_parser("unset-link-metric")
    p.add_argument("interface")
    p.set_defaults(fn=cmd_lm_unset_link_metric)

    pm = sub.add_parser("prefixmgr").add_subparsers(dest="cmd", required=True)
    p = pm.add_parser("view")
    p.set_defaults(fn=cmd_prefixmgr_view)
    p = pm.add_parser("advertise")
    p.add_argument("prefixes", nargs="+")
    p.add_argument("--type", default="BREEZE")
    p.set_defaults(fn=cmd_prefixmgr_advertise)
    p = pm.add_parser("withdraw")
    p.add_argument("prefixes", nargs="+")
    p.add_argument("--type", default="BREEZE")
    p.set_defaults(fn=cmd_prefixmgr_withdraw)
    p = pm.add_parser("withdraw-by-type")
    p.add_argument("--type", required=True)
    p.set_defaults(fn=cmd_prefixmgr_withdraw_by_type)
    p = pm.add_parser("originated")
    p.set_defaults(fn=cmd_prefixmgr_originated)

    spark = sub.add_parser("spark").add_subparsers(dest="cmd", required=True)
    p = spark.add_parser("neighbors")
    p.set_defaults(fn=cmd_spark_neighbors)

    mon = sub.add_parser("monitor").add_subparsers(dest="cmd", required=True)
    p = mon.add_parser("counters")
    p.add_argument("--regex", default="")
    p.set_defaults(fn=cmd_monitor_counters)
    p = mon.add_parser("traces")
    p.add_argument("-n", type=int, default=16)
    p.set_defaults(fn=cmd_monitor_traces)
    p = mon.add_parser("histograms")
    p.set_defaults(fn=cmd_monitor_histograms)

    cfg = sub.add_parser("config").add_subparsers(dest="cmd")
    p = cfg.add_parser("show")
    p.set_defaults(fn=cmd_config)
    p = cfg.add_parser("dryrun")
    p.add_argument("file")
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_config_dryrun)
    # bare `breeze config` keeps showing the running config
    sub.choices["config"].set_defaults(fn=cmd_config, cmd=None)
    p = sub.add_parser("tech-support")
    p.set_defaults(fn=cmd_tech_support)
    p = sub.add_parser("version")
    p.set_defaults(fn=cmd_version)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    tls = None
    if args.tls_cert or args.tls_key or args.tls_ca:
        if not (args.tls_cert and args.tls_key and args.tls_ca):
            print("error: --tls-cert, --tls-key and --tls-ca are all required")
            return 2
        from ..ctrl.tls import TlsConfig

        tls = TlsConfig(
            cert_path=args.tls_cert,
            key_path=args.tls_key,
            ca_path=args.tls_ca,
        )
    client = CtrlClient(args.host, args.port, tls=tls)
    try:
        args.fn(client, args)
        return 0
    except OSError as e:
        # covers ConnectionError, ssl.SSLError (cert rejected / wrong CA),
        # and FileNotFoundError for bad cert paths
        print(f"cannot reach ctrl server at [{args.host}]:{args.port}: {e}")
        return 1
    finally:
        client.close()


if __name__ == "__main__":
    sys.exit(main())
