"""The port's wire types and serializer against `openr_tpu`'s.

Seeded instances of every ported wire type (numpy `default_rng`),
among them a PrefixEntry with a metric vector (`mv`) and an
AdjacencyDatabase with perf events: the port's `dumps` gives the
reference's bytes for the counterpart object, and each package's
`loads` reads the other's bytes into equal fields.  Also the KvStore key
helpers, PerfEvents, the RPC encoding (`to_wire` / `from_wire`), and
`torch_parity.to_ref` on the dataclasses of the node's modules.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import pytest

from openr_tpu import serializer as jser
from openr_tpu import types as jt
from openr_tpu_torch import serializer as pser
from openr_tpu_torch import types as pt
from openr_tpu_torch.decision import rib as prib
from openr_tpu_torch.decision import rib_policy as ppol
from torch_parity import to_ref

def _name(rng, stem="n"):
    return f"{stem}{int(rng.integers(0, 1000))}"


def _perf_events(rng):
    return pt.PerfEvents(
        [
            pt.PerfEvent(_name(rng), f"EVENT_{k}", int(rng.integers(0, 1 << 40)))
            for k in range(int(rng.integers(1, 4)))
        ]
    )


def _adjacency(rng):
    other = _name(rng)
    return pt.Adjacency(
        other_node_name=other,
        if_name=f"if_{other}",
        metric=int(rng.integers(1, 100)),
        adj_label=int(rng.integers(0, 1 << 20)),
        is_overloaded=bool(rng.integers(0, 2)),
        rtt_us=int(rng.integers(0, 10_000)),
        timestamp_s=int(rng.integers(0, 1 << 31)),
        weight=int(rng.integers(1, 8)),
        other_if_name=f"if_back_{other}",
        next_hop_v6=f"fe80::{int(rng.integers(1, 1 << 16)):x}",
        next_hop_v4=f"10.0.0.{int(rng.integers(1, 255))}",
    )


def _adj_db(rng):
    return pt.AdjacencyDatabase(
        this_node_name=_name(rng),
        adjacencies=[_adjacency(rng) for _ in range(int(rng.integers(0, 5)))],
        is_overloaded=bool(rng.integers(0, 2)),
        node_label=int(rng.integers(0, 1 << 20)),
        area=str(int(rng.integers(0, 3))),
        perf_events=_perf_events(rng),
        node_metric_increment_val=int(rng.integers(0, 50)),
    )


def _metric_vector(rng):
    return pt.MetricVector(
        version=int(rng.integers(1, 3)),
        metrics=[
            pt.MetricEntity(
                type=int(rng.integers(0, 10)),
                priority=int(rng.integers(0, 100)),
                op=pt.CompareType(int(rng.integers(1, 4))),
                is_best_path_tie_breaker=bool(rng.integers(0, 2)),
                metric=tuple(int(x) for x in rng.integers(0, 1000, size=2)),
            )
            for _ in range(int(rng.integers(1, 4)))
        ],
    )


def _prefix_entry(rng):
    return pt.PrefixEntry(
        prefix=f"fc00:{int(rng.integers(0, 1 << 16)):x}::/64",
        type=pt.PrefixType(int(rng.integers(1, 9))),
        forwarding_type=pt.PrefixForwardingType(int(rng.integers(0, 2))),
        forwarding_algorithm=pt.PrefixForwardingAlgorithm(
            int(rng.choice([0, 1, 3, 4]))
        ),
        metrics=pt.PrefixMetrics(
            version=1,
            path_preference=int(rng.integers(0, 2000)),
            source_preference=int(rng.integers(0, 200)),
            distance=int(rng.integers(0, 10)),
        ),
        tags=("t1", _name(rng, "t")),
        area_stack=(str(int(rng.integers(0, 3))),),
        min_nexthop=int(rng.integers(1, 4)),
        prepend_label=int(rng.integers(16, 1 << 20)),
        weight=int(rng.integers(1, 100)),
        mv=_metric_vector(rng),
    )


def _next_hop(rng):
    action = pt.MplsAction(
        pt.MplsActionCode.PUSH,
        push_labels=tuple(int(x) for x in rng.integers(16, 1 << 20, size=2)),
    )
    return pt.NextHop(
        address=f"fe80::{int(rng.integers(1, 1 << 16)):x}",
        if_name=_name(rng, "if"),
        metric=int(rng.integers(0, 100)),
        weight=int(rng.integers(0, 5)),
        area="0",
        neighbor_node_name=_name(rng),
        mpls_action=action if rng.integers(0, 2) else None,
    )


def _prefix_db(rng):
    return pt.PrefixDatabase(
        this_node_name=_name(rng),
        prefix_entries=[_prefix_entry(rng)],
        delete_prefix=bool(rng.integers(0, 2)),
        area="0",
        perf_events=_perf_events(rng),
    )


def _value(rng):
    return pt.Value(
        version=int(rng.integers(1, 100)),
        originator_id=_name(rng),
        value=pser.dumps(_adj_db(rng)),
        ttl_ms=int(rng.integers(-1, 100_000)),
        ttl_version=int(rng.integers(0, 10)),
        hash=int(rng.integers(0, 1 << 62)),
    )


def _publication(rng):
    return pt.Publication(
        key_vals={pt.adj_key(_name(rng)): _value(rng) for _ in range(3)},
        expired_keys=[pt.prefix_key(_name(rng), "fc00::/64", "0")],
        node_ids=[_name(rng)],
        tobe_updated_keys=[pt.adj_key(_name(rng))],
        area="0",
        flood_root_id=_name(rng),
    )


def _route_db(rng):
    return pt.RouteDatabase(
        this_node_name=_name(rng),
        unicast_routes=[
            pt.UnicastRoute("fc00::/64", [_next_hop(rng) for _ in range(2)])
        ],
        mpls_routes=[pt.MplsRoute(100, [_next_hop(rng)])],
        perf_events=_perf_events(rng),
    )


def _rib_update(rng):
    update = prib.DecisionRouteUpdate(perf_events=_perf_events(rng))
    update.add_route_to_update(
        prib.RibUnicastEntry(
            prefix="fc00::/64",
            nexthops=frozenset(_next_hop(rng) for _ in range(3)),
            best_prefix_entry=_prefix_entry(rng),
            best_area="0",
            do_not_install=bool(rng.integers(0, 2)),
        )
    )
    update.unicast_routes_to_delete.append("fd00::/64")
    update.mpls_routes_to_update.append(
        prib.RibMplsEntry(label=101, nexthops=frozenset({_next_hop(rng)}))
    )
    update.mpls_routes_to_delete.append(102)
    return update


def _policy(rng):
    return ppol.RibPolicyConfig(
        statements=[
            ppol.RibPolicyStatementConfig(
                name="s",
                prefixes=["fc00::/64"],
                tags=None,
                set_weight=ppol.RibRouteActionWeight(
                    default_weight=int(rng.integers(0, 4)),
                    area_to_weight={"0": int(rng.integers(0, 9))},
                    neighbor_to_weight={_name(rng): int(rng.integers(0, 9))},
                ),
            )
        ],
        ttl_secs=int(rng.integers(0, 100)),
    )


def _peer_spec(rng):
    return pt.PeerSpec(
        peer_addr=f"fe80::{int(rng.integers(1, 1 << 16)):x}",
        ctrl_port=int(rng.integers(0, 1 << 16)),
        state=pt.KvStorePeerState(int(rng.integers(0, 3))),
    )


def _peer_event(rng):
    return pt.PeerEvent(
        area=str(int(rng.integers(0, 3))),
        peers_to_add={_name(rng): _peer_spec(rng) for _ in range(2)},
        peers_to_del=[_name(rng)],
    )


def _sync_event(rng):
    return pt.KvStoreSyncEvent(_name(rng), str(int(rng.integers(0, 3))))


def _reflected(rng):
    return pt.ReflectedNeighborInfo(
        last_nbr_msg_sent_ts_us=int(rng.integers(0, 1 << 50)),
        last_my_msg_rcvd_ts_us=int(rng.integers(0, 1 << 50)),
    )


def _hello(rng):
    return pt.SparkHelloMsg(
        domain_name="openr",
        node_name=_name(rng),
        if_name=_name(rng, "if"),
        seq_num=int(rng.integers(0, 1 << 31)),
        neighbor_infos={_name(rng): _reflected(rng) for _ in range(2)},
        version=int(rng.integers(1, 3)),
        solicit_response=bool(rng.integers(0, 2)),
        restarting=bool(rng.integers(0, 2)),
        sent_ts_us=int(rng.integers(0, 1 << 50)),
    )


def _handshake(rng):
    return pt.SparkHandshakeMsg(
        node_name=_name(rng),
        is_adjacency_established=bool(rng.integers(0, 2)),
        hold_time_ms=int(rng.integers(0, 10_000)),
        gr_hold_time_ms=int(rng.integers(0, 30_000)),
        transport_addr_v6=f"fe80::{int(rng.integers(1, 1 << 16)):x}",
        transport_addr_v4=f"10.0.0.{int(rng.integers(1, 255))}",
        openr_ctrl_port=int(rng.integers(0, 1 << 16)),
        kvstore_cmd_port=int(rng.integers(0, 1 << 16)),
        area=str(int(rng.integers(0, 3))),
        neighbor_node_name=_name(rng) if rng.integers(0, 2) else None,
    )


def _heartbeat(rng):
    return pt.SparkHeartbeatMsg(
        _name(rng), int(rng.integers(0, 1 << 31)), int(rng.integers(0, 10_000))
    )


def _spark_packet(rng):
    kind = int(rng.integers(0, 3))
    return pt.SparkPacket(
        hello=_hello(rng) if kind == 0 else None,
        handshake=_handshake(rng) if kind == 1 else None,
        heartbeat=_heartbeat(rng) if kind == 2 else None,
    )


def _neighbor_event(rng):
    return pt.NeighborEvent(
        event_type=pt.NeighborEventType(int(rng.integers(1, 7))),
        node_name=_name(rng),
        if_name=_name(rng, "if"),
        remote_if_name=_name(rng, "if"),
        area=str(int(rng.integers(0, 3))),
        neighbor_addr_v6=f"fe80::{int(rng.integers(1, 1 << 16)):x}",
        neighbor_addr_v4=f"10.0.0.{int(rng.integers(1, 255))}",
        ctrl_port=int(rng.integers(0, 1 << 16)),
        rtt_us=int(rng.integers(0, 100_000)),
        kvstore_port=int(rng.integers(0, 1 << 16)),
        adj_only_used_by_other_node=bool(rng.integers(0, 2)),
    )


def _interface_info(rng):
    return pt.InterfaceInfo(
        if_name=_name(rng, "if"),
        is_up=bool(rng.integers(0, 2)),
        if_index=int(rng.integers(1, 100)),
        networks=[f"fc00:{int(rng.integers(0, 1 << 16)):x}::1/128"],
    )


def _interface_db(rng):
    infos = [_interface_info(rng) for _ in range(3)]
    return pt.InterfaceDatabase(_name(rng), {i.if_name: i for i in infos})


def _link_event(rng):
    return pt.LinkEvent(
        _name(rng, "if"), int(rng.integers(1, 100)), bool(rng.integers(0, 2))
    )


def _addr_event(rng):
    return pt.AddrEvent(
        _name(rng, "if"),
        f"fc00:{int(rng.integers(0, 1 << 16)):x}::1/128",
        bool(rng.integers(0, 2)),
    )


def _prefix_update_request(rng):
    return pt.PrefixUpdateRequest(
        prefixes_to_add=[_prefix_entry(rng)],
        prefixes_to_del=[f"fd00:{int(rng.integers(0, 1 << 16)):x}::/64"],
        type=pt.PrefixType(int(rng.integers(1, 9))),
        dst_areas=(str(int(rng.integers(0, 3))),),
    )


def _dual_message(rng):
    return pt.DualMessage(
        dst_id=_name(rng),
        distance=int(rng.choice([int(rng.integers(0, 100)), (1 << 63) - 1])),
        type=pt.DualMessageType(int(rng.integers(1, 4))),
    )


def _dual_messages(rng):
    return pt.DualMessages(_name(rng), [_dual_message(rng) for _ in range(3)])


def _topo_set(rng):
    return pt.FloodTopoSetParams(
        root_id=_name(rng),
        src_id=_name(rng),
        set_child=bool(rng.integers(0, 2)),
        all_roots=[None, False, True][int(rng.integers(0, 3))],
    )


def _spt_info(rng):
    return pt.SptInfo(
        passive=bool(rng.integers(0, 2)),
        cost=int(rng.integers(0, 100)),
        parent=_name(rng) if rng.integers(0, 2) else None,
        children=[_name(rng) for _ in range(2)],
    )


def _spt_infos(rng):
    return pt.SptInfos(
        infos={_name(rng): _spt_info(rng) for _ in range(2)},
        flood_root_id=_name(rng),
        flood_peers=[_name(rng)],
    )


MAKERS = {
    # the KvStore-peer, Spark, interface, netlink, PrefixManager and DUAL
    # messages; an enum goes through the message that carries it
    "DualMessage": _dual_message,
    "DualMessageType": _dual_message,
    "DualMessages": _dual_messages,
    "FloodTopoSetParams": _topo_set,
    "KvStorePeerState": _peer_spec,
    "KvStoreSyncEvent": _sync_event,
    "PeerSpec": _peer_spec,
    "SptInfo": _spt_info,
    "SptInfos": _spt_infos,
    "SparkHelloMsg": _hello,
    "SparkHeartbeatMsg": _heartbeat,
    "SparkHandshakeMsg": _handshake,
    "SparkPacket": _spark_packet,
    "ReflectedNeighborInfo": _reflected,
    "NeighborEvent": _neighbor_event,
    "NeighborEventType": _neighbor_event,
    "InterfaceDatabase": _interface_db,
    "InterfaceInfo": _interface_info,
    "LinkEvent": _link_event,
    "AddrEvent": _addr_event,
    "PeerEvent": _peer_event,
    "PrefixUpdateRequest": _prefix_update_request,
    "PerfEvents": _perf_events,
    "Adjacency": _adjacency,
    "AdjacencyDatabase": _adj_db,
    "MetricVector": _metric_vector,
    "PrefixEntry": _prefix_entry,
    "PrefixDatabase": _prefix_db,
    "NextHop": _next_hop,
    "Value": _value,
    "Publication": _publication,
    "RouteDatabase": _route_db,
    "DecisionRouteUpdate": _rib_update,
    "RibPolicyConfig": _policy,
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_dumps_equals_reference_bytes(kind, seed):
    obj = MAKERS[kind](np.random.default_rng(seed))
    assert pser.dumps(obj) == jser.dumps(to_ref(obj))


@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_each_package_loads_the_others_bytes(kind):
    rng = np.random.default_rng(11)
    obj = MAKERS[kind](rng)
    ref = to_ref(obj)
    back = pser.loads(jser.dumps(ref))
    assert back == obj and type(back) is type(obj)
    jback = jser.loads(pser.dumps(obj))
    assert jback == ref and type(jback) is type(ref)


def test_field_order_and_defaults_match_reference():
    """F2: every ported wire type carries the reference's fields, in its
    order, with its defaults (`perf_events` before
    `node_metric_increment_val`, `mv` last in PrefixEntry)."""
    ported = [
        name for name in dir(pt) if dataclasses.is_dataclass(getattr(pt, name))
    ]
    assert len(ported) == len(
        [name for name in dir(jt) if dataclasses.is_dataclass(getattr(jt, name))]
    )
    for name in ported:
        mine = dataclasses.fields(getattr(pt, name))
        ref = dataclasses.fields(getattr(jt, name))
        assert [f.name for f in mine] == [f.name for f in ref], name
        for a, b in zip(mine, ref):
            assert (a.default is dataclasses.MISSING) == (
                b.default is dataclasses.MISSING
            ), (name, a.name)
            if a.default is not dataclasses.MISSING:
                assert a.default == b.default, (name, a.name)
    assert pser.dumps(pt.AdjacencyDatabase("x")) == jser.dumps(jt.AdjacencyDatabase("x"))
    assert pser.dumps(pt.PrefixEntry("::/0")) == jser.dumps(jt.PrefixEntry("::/0"))


@pytest.mark.parametrize(
    "key",
    [
        "prefix:[node1]:[0]:[fc00:0:0::1/64]",
        "prefix:[n]:[area-2]:[10.0.0.0/24]",
        "prefix:[n]:[0]:[not-a-prefix]",
        "prefix:n:0:fc00::/64",
        "adj:node1",
        "adj:[node1]",
        "fibTime:node7",
        "nocolon",
    ],
)
def test_key_helpers_equal_reference(key):
    assert pt.parse_prefix_key(key) == jt.parse_prefix_key(key)
    assert pt.node_name_from_key(key) == jt.node_name_from_key(key)
    assert pt.prefix_key("n", "fc00:0::/64", "1") == jt.prefix_key("n", "fc00:0::/64", "1")
    assert pt.adj_key("n") == jt.adj_key("n")
    assert (pt.ADJ_MARKER, pt.PREFIX_MARKER, pt.TTL_INFINITY) == (
        jt.ADJ_MARKER,
        jt.PREFIX_MARKER,
        jt.TTL_INFINITY,
    )


def test_perf_events_equal_reference():
    mine, ref = pt.PerfEvents(), jt.PerfEvents()
    for name, ts in (("A", 10), ("B", 25), ("C", 40)):
        mine.add("n", name, ts)
        ref.add("n", name, ts)
    pt.add_perf_event(None, "n", "X")
    assert mine.total_duration_ms() == ref.total_duration_ms() == 30
    assert mine.duration_between_ms("B", "C") == ref.duration_between_ms("B", "C")
    for args in (("A", "Z"), ("C", "A")):
        with pytest.raises(ValueError):
            mine.duration_between_ms(*args)
        with pytest.raises(ValueError):
            ref.duration_between_ms(*args)


def test_rpc_wire_encoding_equals_reference():
    rng = np.random.default_rng(5)
    payload = {
        "db": _adj_db(rng),
        "routes": [_next_hop(rng)],
        "blob": b"\x00\x01",
        "!t": "user data that collides with a sentinel",
    }
    ref_payload = {k: to_ref(v) for k, v in payload.items()}
    assert pser.to_wire(payload) == jser.to_wire(ref_payload)
    assert pser.from_wire(jser.to_wire(ref_payload)) == payload


def _plain(obj):
    """Fields as plain values (enums by value), for comparing a port
    object with its openr_tpu counterpart."""
    import enum

    if isinstance(obj, enum.Enum):
        return obj.value
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__, {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return type(obj)(_plain(v) for v in obj)
    return obj


def _node_dataclasses():
    from openr_tpu_torch.kvstore import dual, kvstore
    from openr_tpu_torch.link_monitor import link_monitor as lm
    from openr_tpu_torch.prefix_manager import prefix_manager as pm
    from openr_tpu_torch.spark import spark

    rng = np.random.default_rng(3)
    value = _value(rng)
    return {
        "KeyDumpParams": kvstore.KeyDumpParams(["adj:"], ["n1"], {"adj:n1": value}),
        "KeySetParams": kvstore.KeySetParams({"adj:n1": value}, ["n1", "n2"], "n0", 17),
        "TtlCountdownEntry": kvstore.TtlCountdownEntry(1.5, "adj:n1", 3, 2, "n1"),
        "NeighborInfo": dual.NeighborInfo(7, True, False),
        "DualPerRootCounters": dual.DualPerRootCounters(*range(8)),
        "AreaConfig": spark.AreaConfig("7", ["if.*"], ["n1"]),
        "SparkConfig": spark.SparkConfig(hello_time_s=0.3, step_detector_abs_threshold=9),
        "LinkMonitorState": lm.LinkMonitorState(True, {"if1"}, {"if2": 5}, 9, {("if1", "n2"): 3}, 4),
        "OriginatedPrefixConfig": pm.OriginatedPrefixConfig("fc00::/16", 2, True, 1, ("t",)),
        "OriginatedRouteState": pm.OriginatedRouteState(
            pm.OriginatedPrefixConfig("fc00::/16"), {"fc00:1::/32"}, True
        ),
    }


@pytest.mark.parametrize("kind", sorted(_node_dataclasses()))
def test_to_ref_takes_the_node_modules_dataclasses(kind):
    """`torch_parity.to_ref` gives the openr_tpu class of the same name,
    field for field, for the dataclasses of the port's KvStore, DUAL,
    Spark, LinkMonitor and PrefixManager modules."""
    obj = _node_dataclasses()[kind]
    ref = to_ref(obj)
    assert type(ref).__module__.startswith("openr_tpu.")
    assert type(ref).__name__ == kind
    assert _plain(ref) == _plain(obj)
