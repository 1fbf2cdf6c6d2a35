"""The port's ctrl layer (`openr_tpu_torch.ctrl`) against `openr_tpu`'s.

- Every sync method the reference's `OpenrCtrlHandler` registers, asked
  of a port daemon and a reference daemon that hold equal module state
  (the same node "1" of tests/test_spf_solver.py's square, its
  neighbors' databases set through `setKvStoreKeyVals`), answers the
  same wire JSON, errors included.  The exceptions are listed in
  `UNEQUAL` with the reason.  The async serving methods answer the same
  `result`; the KvStore stream and the adjacency long poll deliver the
  same items.
- A port `CtrlClient` works against a reference `CtrlServer` and a
  reference client against a port server, streams included.
- TLS (oracle `tests/test_tls.py`): mTLS in both directions across the
  packages; a plaintext client, a client whose CN the ACL refuses, and a
  server whose CN the client's ACL refuses are rejected alike.
- A port KvStore and a reference KvStore, each behind its own package's
  ctrl server, reach equal hashes over `TcpKvStoreTransport`.
- Fault F4 (ROADMAP queue 3): two port KvStores full-sync a store whose
  dump is far past asyncio's 64 KiB line limit over that transport, and
  a request over the wire's own limit gets the protocol's error.

Every wait polls converged state against a deadline; sockets bind
port 0.
"""

from __future__ import annotations

import asyncio
import json
import socket
import subprocess
import time
from types import SimpleNamespace

import numpy as np
import pytest

from torch_parity import adj, adj_dbs

PACKAGES = ("port", "ref")
FIB_CLIENT = 786
HOST = "::1"

# methods whose answers may differ between the packages, and why
UNEQUAL = {
    "getCounters": "counter values are timings and event counts, and the "
    "reference also exports its tracing, fuzzing, exploration and snapshot "
    "families",
    "getRegexCounters": "as getCounters",
    "getBuildInfo": "names the package and its build mode",
    "getPerfDb": "perf events carry wall-clock times (names compared)",
}


def pkg(name: str) -> SimpleNamespace:
    if name == "port":
        from openr_tpu_torch import config, ctrl, serializer, types
        from openr_tpu_torch.cli import breeze
        from openr_tpu_torch.ctrl import tls
        from openr_tpu_torch.kvstore import KvStore
        from openr_tpu_torch.main import OpenrDaemon
        from openr_tpu_torch.runtime.queue import ReplicateQueue
        from openr_tpu_torch.spark import MockIoProvider

        kwargs = {"device": "cpu"}
    else:
        from openr_tpu import config, ctrl, serializer, types
        from openr_tpu.cli import breeze
        from openr_tpu.ctrl import tls
        from openr_tpu.kvstore import KvStore
        from openr_tpu.main import OpenrDaemon
        from openr_tpu.runtime.queue import ReplicateQueue
        from openr_tpu.spark import MockIoProvider

        kwargs = {}
    return SimpleNamespace(
        name=name, config=config, ctrl=ctrl, ser=serializer, T=types, breeze=breeze,
        tls=tls, KvStore=KvStore, OpenrDaemon=OpenrDaemon,
        ReplicateQueue=ReplicateQueue, MockIoProvider=MockIoProvider, kwargs=kwargs,
    )


P = {name: pkg(name) for name in PACKAGES}


def wait_for(cond, timeout=20.0, interval=0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


def make_config(p, name: str, ctrl_port: int = 0, **kwargs):
    c = p.config
    return c.OpenrConfig(
        node_name=name, areas=[c.AreaConf()], openr_ctrl_port=ctrl_port,
        spark_config=c.SparkConf(hello_time_s=0.3, fastinit_hello_time_ms=20,
                                 keepalive_time_s=0.05, hold_time_s=0.5,
                                 graceful_restart_time_s=1.0),
        decision_config=c.DecisionConf(debounce_min_ms=5, debounce_max_ms=20),
        enable_watchdog=False, node_label=0, **kwargs,
    ).validate()


def strip(obj):
    """Wire JSON less its perf-event trails (wall-clock times)."""
    if isinstance(obj, dict):
        return {k: strip(v) for k, v in obj.items() if k != "perf_events"}
    if isinstance(obj, list):
        return [strip(v) for v in obj]
    return obj


def raw_call(port: int, method: str, params, line: bytes | None = None) -> dict:
    """One request on a fresh connection; the answer's JSON less its id."""
    with socket.create_connection((HOST, port), timeout=30) as sock:
        if line is None:
            line = json.dumps({"id": 7, "method": method,
                               "params": P["port"].ser.to_wire(params)}).encode() + b"\n"
        sock.sendall(line)
        msg = json.loads(sock.makefile("rb").readline())
    msg.pop("id", None)
    return strip(msg)


# -- equal module state ---------------------------------------------------------

SQUARE = {"1": ["2", "3"], "2": ["1", "4"], "3": ["1", "4"], "4": ["2", "3"]}
PREFIXES = {"2": "fc00:2::/64", "3": "fc00:3::/64", "4": "fc00:4::/64"}


def square_key_vals():
    """Port Values of the square's adjacency databases (labels 101-104)
    and of nodes 2-4's loopbacks."""
    from openr_tpu_torch import types as T
    from openr_tpu_torch.serializer import dumps

    dbs = adj_dbs({n: [adj(n, o) for o in nbrs] for n, nbrs in SQUARE.items()},
                  labels={n: 100 + int(n) for n in SQUARE})
    kv = {T.adj_key(db.this_node_name): T.Value(version=1, originator_id=db.this_node_name,
                                                value=dumps(db)) for db in dbs}
    for node, prefix in PREFIXES.items():
        db = T.PrefixDatabase(node, [T.PrefixEntry(prefix=prefix)])
        kv[T.prefix_key(node, prefix, "0")] = T.Value(
            version=1, originator_id=node, value=dumps(db))
    return kv


@pytest.fixture(scope="module")
def twins():
    """Node "1" as a port daemon and as a reference daemon, each on its
    own mock fabric with no neighbor, holding the square's databases."""
    daemons = {}
    try:
        for name, p in P.items():
            d = p.OpenrDaemon(
                make_config(p, "1", enable_rib_policy=True),
                io_provider=p.MockIoProvider().endpoint("1"), spark_v6_addr=HOST,
                **p.kwargs,
            )
            d.start()
            daemons[name] = d
            raw_call(d.ctrl_port, "setKvStoreKeyVals",
                     {"area": "0", "key_vals": square_key_vals()})
        for d in daemons.values():
            assert wait_for(lambda d=d: len(d.fib_agent.unicast.get(FIB_CLIENT, {})) == 3)
        yield daemons
    finally:
        for d in daemons.values():
            d.stop()


def ask_both(twins, method, params=None, line=None) -> dict:
    got = {name: raw_call(d.ctrl_port, method, params or {}, line) for name, d in twins.items()}
    return got


def rib_policy():
    from openr_tpu_torch.decision.rib_policy import (
        RibPolicyConfig,
        RibPolicyStatementConfig,
        RibRouteActionWeight,
    )

    return RibPolicyConfig(
        statements=[RibPolicyStatementConfig(
            name="w", prefixes=["fc00:4::/64"],
            set_weight=RibRouteActionWeight(default_weight=1, neighbor_to_weight={"2": 3}),
        )],
        ttl_secs=3600,
    )


def read_calls():
    from openr_tpu_torch import types as T

    p4 = "fc00:4::/64"
    return [
        ("getMyNodeName", {}),
        ("getOpenrVersion", {}),
        ("getRunningConfig", {}),
        ("dryrunConfig", {"file_contents": json.dumps({"node_name": "dry"})}),
        ("dryrunConfig", {"file_contents": json.dumps({"node_name": "bad name"})}),
        ("dryrunConfig", {"file_contents": "{"}),
        ("dumpTraces", {"n": 4}),
        ("getSpanSamples", {}),
        ("getConfigKey", {"key": "absent"}),
        ("getKvStoreKeyValsArea", {"keys": ["adj:1", "adj:4", "nope"]}),
        ("getKvStoreKeyVals", {"keys": ["adj:2"]}),
        ("getKvStoreKeyValsFilteredArea", {"prefixes": ["adj:"]}),
        ("getKvStoreKeyValsFilteredArea", {"prefixes": ["prefix:"], "hash_only": True}),
        ("getKvStoreKeyValsFilteredArea", {"match_all": True, "originators": ["4"]}),
        ("getKvStoreKeyValsFiltered", {"prefixes": ["adj:3"]}),
        ("getKvStoreHashFilteredArea", {"prefixes": ["prefix:"]}),
        ("getKvStoreHashFiltered", {}),
        ("getKvStorePeersArea", {}),
        ("getKvStorePeers", {}),
        ("getKvStoreAreaSummary", {}),
        ("getSpanningTreeInfos", {}),
        ("getRouteDb", {"node": ""}),
        ("getRouteDb", {"node": "4"}),
        ("getFleetRoutes", {"nodes": ["1", "4"]}),
        ("getFleetRoutes", {}),
        ("getDecisionAdjacenciesFiltered", {"areas": ["0"]}),
        ("getDecisionAdjacencyDbs", {}),
        ("getReceivedRoutesFiltered", {}),
        ("getReceivedRoutes", {"prefixes": [p4]}),
        ("decisionWhatIf", {"scenarios": [[["1", "2"]], [["2", "4"], ["3", "4"]]]}),
        ("decisionTiLfa", {"node": "1"}),
        ("decisionTiLfa", {"node": "9"}),
        ("getRibPolicy", {}),
        ("getRouteDbFib", {}),
        ("getRouteDbFib", {"programmedOnly": True}),
        ("getUnicastRoutesFiltered", {"prefixes": [p4]}),
        ("getUnicastRoutes", {}),
        ("getMplsRoutes", {}),
        ("getMplsRoutesFiltered", {"labels": [102, 104]}),
        ("getInterfaces", {}),
        ("getLinkMonitorAdjacenciesFiltered", {}),
        ("getLinkMonitorAdjacencies", {}),
        ("getLinkMonitorState", {}),
        ("getPrefixes", {}),
        ("getPrefixesByType", {"type": T.PrefixType.LOOPBACK}),
        ("getOriginatedPrefixes", {}),
        ("getAdvertisedRoutes", {}),
        ("getAdvertisedRoutesFiltered", {"prefixes": [p4]}),
        ("getRouteDetailDb", {}),
        ("getSparkNeighbors", {}),
        ("getNeighbors", {}),
        ("noSuchMethod", {}),
        ("getKvStoreKeyValsArea", {}),
    ]


@pytest.mark.parametrize("call", range(len(read_calls())),
                         ids=[f"{m}-{i}" for i, (m, _) in enumerate(read_calls())])
def test_read_methods_answer_equally(twins, call):
    method, params = read_calls()[call]
    got = ask_both(twins, method, params)
    assert got["port"] == got["ref"], method


def test_every_reference_method_is_registered(twins):
    handlers = {n: d.ctrl_server.handler for n, d in twins.items()}
    assert set(handlers["port"].methods) == set(handlers["ref"].methods)
    assert set(handlers["port"].async_methods) == set(handlers["ref"].async_methods)
    # setKvStoreKeyVals builds the twins' state
    asked = {m for m, _ in read_calls() + write_calls()} | set(UNEQUAL) | {"setKvStoreKeyVals"}
    assert set(handlers["ref"].methods) <= asked


def test_unequal_methods_differ_only_as_listed(twins):
    got = ask_both(twins, "getBuildInfo")
    port, ref = got["port"]["result"], got["ref"]["result"]
    assert port.keys() == ref.keys()
    assert port["buildPackageVersion"] == ref["buildPackageVersion"]
    assert (port["buildPackageName"], port["buildMode"]) == ("openr_tpu_torch", "cuda")
    got = ask_both(twins, "getPerfDb")
    names = {
        n: [[e["event_name"] for e in perf["!d"]["events"]] for perf in g["result"]]
        for n, g in got.items()
    }
    assert names["port"] == names["ref"]
    # every counter of the ported modules' families that the reference
    # exports, the port exports too
    keys = {n: set(g["result"]) for n, g in ask_both(twins, "getCounters").items()}
    families = ("decision.", "fib.", "kvstore.", "link_monitor.", "monitor.",
                "prefix_manager.", "spark.", "queue.", "serving.", "te.")
    assert {k for k in keys["ref"] if k.startswith(families)} <= keys["port"]
    got = ask_both(twins, "getRegexCounters", {"regex": "^no\\.such\\.counter$"})
    assert got["port"] == got["ref"] == {"result": {}}
    # the port seeds its rebuild-failure count; the reference bumps it lazily
    got = ask_both(twins, "getRegexCounters", {"regex": "^decision\\.route_rebuild_failures$"})
    assert got["port"] == {"result": {"decision.route_rebuild_failures": 0}}
    assert got["ref"]["result"].get("decision.route_rebuild_failures", 0) == 0


def write_calls():
    from openr_tpu_torch import types as T

    loop = T.PrefixType.LOOPBACK
    entry = T.PrefixEntry(prefix="fd00::/64", type=T.PrefixType.BREEZE)
    return [
        ("setConfigKey", {"key": "k", "value": b"v\x00"}),
        ("getConfigKey", {"key": "k"}),
        ("eraseConfigKey", {"key": "k"}),
        ("eraseConfigKey", {"key": "k"}),
        ("setRibPolicy", {"policy": rib_policy()}),
        ("getRibPolicy", {}),
        ("clearRibPolicy", {}),
        ("clearRibPolicy", {}),
        ("advertisePrefixes", {"type": T.PrefixType.BREEZE, "prefixes": [entry]}),
        ("getPrefixes", {}),
        ("withdrawPrefixes", {"type": T.PrefixType.BREEZE, "prefixes": ["fd00::/64"]}),
        ("syncPrefixesByType", {"type": loop, "prefixes": [
            T.PrefixEntry(prefix="fd01::/64", type=loop)]}),
        ("getPrefixesByType", {"type": loop}),
        ("withdrawPrefixesByType", {"type": loop}),
        ("getPrefixes", {}),
        ("setInterfaceOverload", {"interface": "if-x"}),
        ("setInterfaceMetric", {"interface": "if-x", "metric": 7}),
        ("setAdjacencyMetric", {"interface": "if-x", "node": "2", "metric": 9}),
        ("setNodeInterfaceMetricIncrease", {"metricIncrementVal": 5}),
        ("getLinkMonitorState", {}),
        ("unsetInterfaceOverload", {"interface": "if-x"}),
        ("unsetInterfaceMetric", {"interface": "if-x"}),
        ("unsetAdjacencyMetric", {"interface": "if-x", "node": "2"}),
        ("unsetNodeInterfaceMetricIncrease", {}),
        ("setNodeOverload", {}),
        ("getLinkMonitorState", {}),
        ("unsetNodeOverload", {}),
        ("getLinkMonitorState", {}),
        ("floodRestartingMsg", {}),
        ("updateFloodTopologyChild", {"params": T.FloodTopoSetParams(
            root_id="1", src_id="2", set_child=True)}),
        ("processKvStoreDualMessage", {"messages": T.DualMessages(src_id="2")}),
    ]


def test_write_methods_answer_equally(twins):
    """The mutating methods in order on both daemons (they run after the
    module-scoped read checks of the same daemons)."""
    for method, params in write_calls():
        got = ask_both(twins, method, params)
        assert got["port"] == got["ref"], method


def test_bad_requests_answer_equally(twins):
    for line in (b"{not json\n", b"[1, 2]\n",
                 b'{"id": 3, "method": "getMyNodeName", "params": {"!t": "Nope", "!d": {}}}\n'):
        got = ask_both(twins, None, line=line)
        assert got["port"] == got["ref"], line


@pytest.mark.parametrize("method,params", [
    ("queryPaths", {"sources": ["1", "4"]}),
    ("queryKsp", {"sources": ["1"], "dests": ["4"], "k": 2}),
    ("queryWhatIf", {"scenarios": [[["1", "2"]]], "sources": ["1"]}),
    ("queryPaths", {"sources": ["nobody"]}),
])
def test_serving_methods_answer_equally(twins, method, params):
    got = ask_both(twins, method, params)
    for g in got.values():
        for key in ("epoch", "batchSize", "latencyUs"):
            if "result" in g:
                g["result"].pop(key, None)
    assert got["port"] == got["ref"]


def test_kvstore_stream_and_long_poll_deliver_equally(twins):
    from openr_tpu_torch import types as T

    items = {}
    for name, d in twins.items():
        with socket.create_connection((HOST, d.ctrl_port), timeout=30) as sock:
            rfile = sock.makefile("rb")
            req = {"id": 1, "method": "subscribeKvStore",
                   "params": P["port"].ser.to_wire({"prefixes": ["stream:"]})}
            sock.sendall(json.dumps(req).encode() + b"\n")
            first = json.loads(rfile.readline())
            val = T.Value(version=3, originator_id="9", value=b"s")
            raw_call(d.ctrl_port, "setKvStoreKeyVals",
                     {"area": "0", "key_vals": {"stream:a": val}})
            second = json.loads(rfile.readline())
            sock.sendall(json.dumps({"id": 1, "cancel": True}).encode() + b"\n")
        adj_versions = {k: 1 for k in ("adj:2", "adj:3", "adj:4")}
        adj_versions["adj:1"] = raw_call(d.ctrl_port, "getKvStoreKeyValsArea", {
            "keys": ["adj:1"]})["result"]["!d"]["key_vals"]["adj:1"]["version"]
        stale = raw_call(d.ctrl_port, "longPollKvStoreAdjArea",
                         {"snapshot": {**adj_versions, "adj:2": 0}})
        items[name] = (strip(first), strip(second), stale)
    assert items["port"] == items["ref"]
    assert items["port"][2]["result"] is True


# -- cross-package clients --------------------------------------------------------


@pytest.mark.parametrize("client_pkg", PACKAGES)
def test_client_against_the_other_packages_server(twins, client_pkg):
    """A `CtrlClient` of one package asks the other package's daemon; its
    answers, re-encoded with its own serializer, are what the server's own
    package sends."""
    c = P[client_pkg]
    server = "ref" if client_pkg == "port" else "port"
    d = twins[server]
    with c.ctrl.CtrlClient(HOST, d.ctrl_port) as client:
        for method, params in (("getRouteDb", {"node": ""}), ("getKvStoreKeyValsArea",
                               {"keys": ["adj:1", "adj:4"]}), ("getOriginatedPrefixes", {}),
                               ("getDecisionAdjacenciesFiltered", {}),
                               ("getRouteDbFib", {})):
            got = strip(json.loads(json.dumps(c.ser.to_wire(client.call(method, **params)))))
            want = raw_call(d.ctrl_port, method, params)["result"]
            assert got == want, method
        with pytest.raises(RuntimeError, match="unknown method"):
            client.call("noSuchMethod")
        stream = client.stream("subscribeKvStore", prefixes=["adj:4"])
        snapshot = next(stream)
        assert sorted(snapshot.key_vals) == ["adj:4"]
        assert type(snapshot).__module__.startswith(
            "openr_tpu_torch" if client_pkg == "port" else "openr_tpu.")


# -- TLS -----------------------------------------------------------------------------


def _openssl(*argv: str) -> None:
    subprocess.run(["openssl", *argv], check=True, capture_output=True)


@pytest.fixture(scope="module")
def pki(tmp_path_factory):
    """One CA and node certificates 'tls-0', 'tls-1', 'rogue-node'."""
    root = tmp_path_factory.mktemp("pki")
    ca_key, ca_crt = root / "ca.key", root / "ca.crt"
    _openssl("req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", str(ca_key),
             "-out", str(ca_crt), "-days", "1", "-subj", "/CN=openr-test-ca")
    certs = {}
    for name in ("tls-0", "tls-1", "rogue-node"):
        key, csr, crt = root / f"{name}.key", root / f"{name}.csr", root / f"{name}.crt"
        _openssl("req", "-newkey", "rsa:2048", "-nodes", "-keyout", str(key),
                 "-out", str(csr), "-subj", f"/CN={name}")
        _openssl("x509", "-req", "-in", str(csr), "-CA", str(ca_crt), "-CAkey", str(ca_key),
                 "-CAcreateserial", "-out", str(crt), "-days", "1")
        certs[name] = (str(crt), str(key))
    return str(ca_crt), certs


def tls_cfg(p, pki, name: str, acl: str = "tls-.*"):
    ca, certs = pki
    crt, key = certs[name]
    return p.tls.TlsConfig(cert_path=crt, key_path=key, ca_path=ca, acl_regex=acl)


@pytest.fixture
def tls_servers(pki):
    """A ctrl server of each package with mTLS, CN ACL "tls-.*", serving a
    handler that knows only its node name."""
    servers = {}
    try:
        for name, p in P.items():
            handler = p.ctrl.OpenrCtrlHandler(f"tls-{name}")
            server = p.ctrl.CtrlServer(handler, host=HOST, port=0,
                                       tls=tls_cfg(p, pki, "tls-0"))
            server.run()
            servers[name] = server
        yield servers
    finally:
        for server in servers.values():
            server.stop()


@pytest.mark.parametrize("client_pkg", PACKAGES)
@pytest.mark.parametrize("server_pkg", PACKAGES)
def test_mtls_across_packages(pki, tls_servers, client_pkg, server_pkg):
    c = P[client_pkg]
    port = tls_servers[server_pkg].port
    with c.ctrl.CtrlClient(HOST, port, tls=tls_cfg(c, pki, "tls-1")) as client:
        assert client.call("getMyNodeName") == f"tls-{server_pkg}"
    # a CN the server's ACL refuses: the connection closes unanswered
    rogue = c.ctrl.CtrlClient(HOST, port, tls=tls_cfg(c, pki, "rogue-node"))
    with pytest.raises((ConnectionError, OSError)):
        rogue.call("getMyNodeName")
    rogue.close()
    # the server's CN is not in the client's ACL
    picky = c.ctrl.CtrlClient(HOST, port, tls=tls_cfg(c, pki, "tls-1", acl="other-.*"))
    with pytest.raises(OSError):
        picky.call("getMyNodeName")
    picky.close()


@pytest.mark.parametrize("server_pkg", PACKAGES)
def test_plaintext_client_rejected(tls_servers, server_pkg):
    plain = P["port"].ctrl.CtrlClient(HOST, tls_servers[server_pkg].port, timeout_s=5)
    with pytest.raises((ConnectionError, OSError, json.JSONDecodeError)):
        plain.call("getMyNodeName")
    plain.close()


def test_check_acl_equal():
    rng = np.random.default_rng(4)
    for _ in range(40):
        cn = rng.choice(["tls-0", "tls-12", "rogue", "", "TLS-1", "tls-"])
        acl = rng.choice(["tls-.*", ".*", "tls-[0-9]+", "rogue"])
        got = {n: p.tls.check_acl(p.tls.TlsConfig("c", "k", "a", str(acl)), str(cn) or None)
               for n, p in P.items()}
        assert got["port"] == got["ref"]


def test_breeze_over_mtls(pki, tls_servers, capsys):
    ca, certs = pki
    crt, key = certs["tls-1"]
    rc = P["port"].breeze.main(["-H", HOST, "-p", str(tls_servers["ref"].port),
                                "--tls-cert", crt, "--tls-key", key, "--tls-ca", ca,
                                "version"])
    assert rc == 0 and '"version": 20' in capsys.readouterr().out
    rc = P["port"].breeze.main(["-H", HOST, "-p", str(tls_servers["port"].port), "version"])
    assert rc == 1 and "cannot reach ctrl server" in capsys.readouterr().out


# -- KvStore over TCP across the packages ------------------------------------------


def test_port_and_reference_kvstores_sync_over_tcp():
    """Each KvStore behind its own package's ctrl server, each peered
    with the other over TcpKvStoreTransport: seeded keys on both sides
    (some on both, at other versions) end in equal hashes."""
    stores, servers, queues = {}, {}, []
    try:
        for name, p in P.items():
            updates, syncs, peers = p.ReplicateQueue(), p.ReplicateQueue(), p.ReplicateQueue()
            queues += [updates, syncs, peers]
            store = p.KvStore(f"kv-{name}", updates, syncs, peers.get_reader(),
                              transport=p.ctrl.TcpKvStoreTransport())
            store.run()
            server = p.ctrl.CtrlServer(p.ctrl.OpenrCtrlHandler(f"kv-{name}", kvstore=store),
                                       host=HOST, port=0)
            server.run()
            stores[name], servers[name] = store, server
        rng = np.random.default_rng(9)
        for name, p in P.items():
            kv = {}
            for _ in range(40):
                key = f"key{int(rng.integers(0, 60))}"
                kv[key] = p.T.Value(version=int(rng.integers(1, 4)), originator_id=name,
                                    value=bytes(rng.integers(0, 256, size=8).tolist()))
            stores[name].set_key_vals("0", kv)
        for name, p in P.items():
            other = "ref" if name == "port" else "port"
            stores[name].add_peers("0", {f"kv-{other}": p.T.PeerSpec(
                peer_addr=HOST, ctrl_port=servers[other].port)})

        def hashes(name):
            pub = stores[name].dump_hashes("0")
            return {k: (v.version, v.originator_id, v.hash) for k, v in pub.key_vals.items()}

        assert wait_for(lambda: hashes("port") == hashes("ref") and len(hashes("port")) > 40,
                        timeout=30), (len(hashes("port")), len(hashes("ref")))
        # a later write floods across
        stores["port"].set_key_vals("0", {"late": P["port"].T.Value(
            version=1, originator_id="port", value=b"x")})
        assert wait_for(lambda: "late" in hashes("ref"))
        assert hashes("port") == hashes("ref")
    finally:
        for q in queues:
            q.close()
        for name in servers:
            servers[name].stop()
        for store in stores.values():
            store.stop()


def test_kvstores_full_sync_a_large_store_over_tcp():
    """Two port KvStores, each holding 3 000 adjacency databases of its
    own, peer over TcpKvStoreTransport.  The full dump, its request of
    every key's hash and the 3-way sync's reply each travel as one JSON
    line far past asyncio's 64 KiB default line limit; both stores end
    holding all 6 000 keys at equal hashes."""
    from openr_tpu_torch.serializer import dumps, to_wire

    p = P["port"]
    stores, servers, queues = {}, {}, []
    try:
        for name in ("a", "b"):
            updates, syncs, peers = p.ReplicateQueue(), p.ReplicateQueue(), p.ReplicateQueue()
            queues += [updates, syncs, peers]
            store = p.KvStore(name, updates, syncs, peers.get_reader(),
                              transport=p.ctrl.TcpKvStoreTransport())
            store.run()
            server = p.ctrl.CtrlServer(p.ctrl.OpenrCtrlHandler(name, kvstore=store),
                                       host=HOST, port=0)
            server.run()
            stores[name], servers[name] = store, server
        for name in ("a", "b"):
            dbs = adj_dbs({f"{name}{i}": [adj(f"{name}{i}", f"{name}{(i + 1) % 3000}")]
                           for i in range(3000)})
            stores[name].set_key_vals("0", {
                f"adj:{db.this_node_name}": p.T.Value(
                    version=1, originator_id=db.this_node_name, value=dumps(db))
                for db in dbs})
        line = json.dumps(to_wire(stores["a"].dump_all("0")))
        assert len(line) > 16 * (1 << 16), len(line)
        stores["b"].add_peers("0", {"a": p.T.PeerSpec(
            peer_addr=HOST, ctrl_port=servers["a"].port)})

        def hashes(name):
            pub = stores[name].dump_hashes("0")
            return {k: (v.version, v.originator_id, v.hash) for k, v in pub.key_vals.items()}

        assert wait_for(lambda: len(hashes("a")) == len(hashes("b")) == 6000, timeout=60), (
            len(hashes("a")), len(hashes("b")))
        assert hashes("a") == hashes("b")
    finally:
        for q in queues:
            q.close()
        for server in servers.values():
            server.stop()
        for store in stores.values():
            store.stop()


def test_ctrl_server_refuses_a_line_over_the_limit(monkeypatch):
    """A request line past the wire's line limit gets the protocol's
    error before the server hangs up; it never drops the connection
    without an answer."""
    from openr_tpu_torch.ctrl import server as server_mod

    monkeypatch.setattr(server_mod, "WIRE_LINE_LIMIT", 1 << 10)
    server = P["port"].ctrl.CtrlServer(
        P["port"].ctrl.OpenrCtrlHandler("big"), host=HOST, port=0)
    server.run()
    try:
        with socket.create_connection((HOST, server.port), timeout=10) as sock:
            request = {"id": 7, "method": "getMyNodeName", "params": {"pad": "x" * 4096}}
            sock.sendall(json.dumps(request).encode() + b"\n")
            reply = sock.makefile("rb").readline()
        assert json.loads(reply) == {"id": None, "error": "request line too long"}
    finally:
        server.stop()


def test_run_coroutine_and_run_async():
    """The event base's cross-loop coroutine calls (the ctrl server's
    start uses them)."""
    from openr_tpu_torch.runtime.eventbase import OpenrEventBase

    evb = OpenrEventBase(name="coro")
    evb.run()
    try:
        async def where():
            await asyncio.sleep(0)
            return evb.in_event_base_thread()

        assert evb.run_coroutine(where()).result(timeout=5) is True
        assert asyncio.run(evb.run_async(where())) is True
    finally:
        evb.stop()
