"""DUAL (Diffusing Update Algorithm) — per-root flooding spanning trees.

Port of `openr_tpu.kvstore.dual` (reference: `openr/dual/Dual.{h,cpp}`): every
node runs one `Dual` instance per discovered root computing its shortest
route to that root via EIGRP-style diffusing computations (the SNC feasible
condition, ACTIVE0-3/PASSIVE state machine, query/reply diffusion).  The
union of (nexthop -> parent) choices forms a spanning tree per root; KvStore
floods along the tree of the smallest passive root instead of full-mesh
(`KvStoreDb.get_flood_peers`).

Algorithm background: J.J. Garcia-Lunes-Aceves, "Loop-Free Routing Using
Diffusing Computations" (the paper the reference cites at Dual.h:29).

Mapping to the reference:
- `DualStateMachine.process_event`  <- Dual.cpp:12-60
- `Dual.peer_up/peer_down/peer_cost_change` <- Dual.cpp:401-527
- `Dual.process_update/query/reply` <- Dual.cpp:529-715
- feasible condition (SNC)          <- Dual.cpp:148-169 meetFeasibleCondition
- `DualNode`                        <- Dual.cpp:717-971

All distances are int; `INFINITY64` stands for thrift INT64_MAX.
"""

from __future__ import annotations

import enum
import logging
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..types import DualMessage, DualMessages, DualMessageType

log = logging.getLogger(__name__)

INFINITY64 = (1 << 63) - 1  # thrift int64 max == "no route"


class DualState(enum.Enum):
    """PASSIVE: converged, usable.  ACTIVE0-3: diffusing computation in
    progress (reference: Dual.h:31-37)."""

    ACTIVE0 = 0
    ACTIVE1 = 1
    ACTIVE2 = 2
    ACTIVE3 = 3
    PASSIVE = 4


class DualEvent(enum.Enum):
    """Reference: Dual.h:42-47."""

    QUERY_FROM_SUCCESSOR = 0
    LAST_REPLY = 1
    INCREASE_D = 2
    OTHERS = 3


class DualStateMachine:
    """Reference: DualStateMachine::processEvent (Dual.cpp:12-60)."""

    def __init__(self) -> None:
        self.state = DualState.PASSIVE

    def process_event(self, event: DualEvent, fc: bool = True) -> None:
        s, e = self.state, event
        if s == DualState.PASSIVE:
            if fc:
                return
            self.state = (
                DualState.ACTIVE3
                if e == DualEvent.QUERY_FROM_SUCCESSOR
                else DualState.ACTIVE1
            )
        elif s == DualState.ACTIVE0:
            if e != DualEvent.LAST_REPLY:
                return
            self.state = DualState.PASSIVE if fc else DualState.ACTIVE2
        elif s == DualState.ACTIVE1:
            if e == DualEvent.INCREASE_D:
                self.state = DualState.ACTIVE0
            elif e == DualEvent.LAST_REPLY:
                self.state = DualState.PASSIVE
            elif e == DualEvent.QUERY_FROM_SUCCESSOR:
                self.state = DualState.ACTIVE2
        elif s == DualState.ACTIVE2:
            if e != DualEvent.LAST_REPLY:
                return
            self.state = DualState.PASSIVE if fc else DualState.ACTIVE3
        elif s == DualState.ACTIVE3:
            if e == DualEvent.LAST_REPLY:
                self.state = DualState.PASSIVE
            elif e == DualEvent.INCREASE_D:
                self.state = DualState.ACTIVE2


@dataclass(slots=True)
class NeighborInfo:
    """Reference: Dual::NeighborInfo (Dual.h:127-134)."""

    report_distance: int = INFINITY64
    expect_reply: bool = False
    need_to_reply: bool = False


@dataclass(slots=True)
class DualPerRootCounters:
    """Reference: thrift::DualPerRootCounters."""

    query_sent: int = 0
    query_recv: int = 0
    reply_sent: int = 0
    reply_recv: int = 0
    update_sent: int = 0
    update_recv: int = 0
    total_sent: int = 0
    total_recv: int = 0


@dataclass(slots=True)
class RouteInfo:
    """Reference: Dual::RouteInfo (Dual.h:137-195)."""

    distance: int = INFINITY64
    report_distance: int = INFINITY64
    feasible_distance: int = INFINITY64
    nexthop: Optional[str] = None
    sm: DualStateMachine = field(default_factory=DualStateMachine)
    neighbor_infos: dict[str, NeighborInfo] = field(default_factory=dict)
    cornet: list[str] = field(default_factory=list)  # stack of queriers

    def __str__(self) -> str:
        return (
            f"[{self.sm.state.name}] {self.nexthop or 'None'} "
            f"({self.distance}, {self.report_distance}, "
            f"{self.feasible_distance})"
        )


MsgsToSend = dict[str, DualMessages]
NexthopCb = Callable[[Optional[str], Optional[str]], None]


def add_distances(d1: int, d2: int) -> int:
    """Saturating add (reference: Dual::addDistances, Dual.cpp:392-399)."""
    if d1 == INFINITY64 or d2 == INFINITY64:
        return INFINITY64
    return d1 + d2


class Dual:
    """Per-(node, root) DUAL computation (reference: class Dual,
    Dual.h:67-294)."""

    def __init__(
        self,
        node_id: str,
        root_id: str,
        local_distances: dict[str, int],
        nexthop_cb: Optional[NexthopCb] = None,
    ) -> None:
        self.node_id = node_id
        self.root_id = root_id
        # SHARED with DualNode (reference passes by ref — peerUp on the
        # node updates all duals' view through per-dual copies; we copy
        # like the reference's constructor and update in peer events)
        self.local_distances: dict[str, int] = dict(local_distances)
        self.nexthop_cb = nexthop_cb
        self.info = RouteInfo()
        self.counters: dict[str, DualPerRootCounters] = {}
        self._children: set[str] = set()
        if root_id == node_id:
            self.info.distance = 0
            self.info.report_distance = 0
            self.info.feasible_distance = 0
            self.info.nexthop = node_id

    # -- counters ------------------------------------------------------------

    def _cnt(self, neighbor: str) -> DualPerRootCounters:
        return self.counters.setdefault(neighbor, DualPerRootCounters())

    def clear_counters(self, neighbor: str) -> None:
        if neighbor in self.counters:
            self.counters[neighbor] = DualPerRootCounters()

    # -- SPT children --------------------------------------------------------

    def add_child(self, child: str) -> None:
        self._children.add(child)

    def remove_child(self, child: str) -> None:
        self._children.discard(child)

    def children(self) -> set[str]:
        return set(self._children)

    def spt_peers(self) -> set[str]:
        """nexthop + children when the route is valid (Dual.cpp:380-390)."""
        if not self.has_valid_route():
            return set()
        peers = self.children()
        peers.add(self.info.nexthop)
        return peers

    def has_valid_route(self) -> bool:
        return (
            self.info.sm.state == DualState.PASSIVE
            and self.info.distance != INFINITY64
            and self.info.nexthop is not None
        )

    # -- internals (Dual.cpp:84-293) ----------------------------------------

    def _neighbor_up(self, neighbor: str) -> bool:
        return self.local_distances.get(neighbor, INFINITY64) != INFINITY64

    def _min_distance(self) -> int:
        if self.node_id == self.root_id:
            return 0
        dmin = INFINITY64
        for nb, ld in self.local_distances.items():
            rd = self.info.neighbor_infos.setdefault(
                nb, NeighborInfo()
            ).report_distance
            dmin = min(dmin, add_distances(ld, rd))
        return dmin

    def _route_affected(self) -> bool:
        if not self.local_distances:
            return False
        if self.info.nexthop == self.node_id:
            return False  # I'm the root
        dmin = self._min_distance()
        if self.info.distance != dmin:
            return True
        if dmin == INFINITY64:
            return False
        nexthops = {
            nb
            for nb, ld in self.local_distances.items()
            if add_distances(
                ld, self.info.neighbor_infos[nb].report_distance
            )
            == dmin
        }
        assert self.info.nexthop is not None
        return self.info.nexthop not in nexthops

    def _meet_feasible_condition(self) -> Optional[tuple[str, int]]:
        """SNC: a neighbor with report-distance < my feasible distance on a
        min-distance path (Dual.cpp:148-169)."""
        dmin = self._min_distance()
        for nb, ld in self.local_distances.items():
            if ld == INFINITY64:
                continue
            rd = self.info.neighbor_infos.setdefault(
                nb, NeighborInfo()
            ).report_distance
            if rd < self.info.feasible_distance and add_distances(ld, rd) == dmin:
                return nb, dmin
        return None

    def _mk_msg(self, mtype: DualMessageType, distance: int) -> DualMessage:
        return DualMessage(dst_id=self.root_id, distance=distance, type=mtype)

    def _queue(self, out: MsgsToSend, neighbor: str, msg: DualMessage) -> None:
        out.setdefault(neighbor, DualMessages()).messages.append(msg)
        cnt = self._cnt(neighbor)
        if msg.type == DualMessageType.UPDATE:
            cnt.update_sent += 1
        elif msg.type == DualMessageType.QUERY:
            cnt.query_sent += 1
        else:
            cnt.reply_sent += 1
        cnt.total_sent += 1

    def _flood_updates(self, out: MsgsToSend) -> None:
        for nb, ld in self.local_distances.items():
            if ld == INFINITY64:
                continue
            self._queue(
                out,
                nb,
                self._mk_msg(DualMessageType.UPDATE, self.info.report_distance),
            )

    def _set_nexthop(self, new_nh: Optional[str]) -> None:
        if self.info.nexthop != new_nh:
            if self.nexthop_cb:
                self.nexthop_cb(self.info.nexthop, new_nh)
            self.info.nexthop = new_nh

    def _local_computation(
        self, new_nexthop: str, new_distance: int, out: MsgsToSend
    ) -> None:
        """Dual.cpp:191-211."""
        same_rd = new_distance == self.info.report_distance
        self._set_nexthop(new_nexthop)
        self.info.distance = new_distance
        self.info.report_distance = new_distance
        self.info.feasible_distance = new_distance
        if not same_rd:
            self._flood_updates(out)

    def _diffusing_computation(self, out: MsgsToSend) -> bool:
        """Dual.cpp:213-246."""
        ld = self.local_distances[self.info.nexthop]
        rd = self.info.neighbor_infos[self.info.nexthop].report_distance
        new_distance = add_distances(ld, rd)
        self.info.distance = new_distance
        self.info.report_distance = new_distance
        self.info.feasible_distance = new_distance

        success = False
        for nb, ld in self.local_distances.items():
            if ld == INFINITY64:
                continue
            self._queue(
                out,
                nb,
                self._mk_msg(DualMessageType.QUERY, self.info.report_distance),
            )
            self.info.neighbor_infos.setdefault(
                nb, NeighborInfo()
            ).expect_reply = True
            success = True
        return success

    def _send_reply(self, out: MsgsToSend) -> None:
        """Dual.cpp:566-594."""
        assert self.info.cornet, "send reply called on empty cornet"
        dst = self.info.cornet.pop()
        if not self._neighbor_up(dst):
            # link down on my end: reply when it comes up (Dual.cpp:574-584)
            self.info.neighbor_infos.setdefault(
                dst, NeighborInfo()
            ).need_to_reply = True
            return
        self._queue(
            out,
            dst,
            self._mk_msg(DualMessageType.REPLY, self.info.report_distance),
        )

    def _try_local_or_diffusing(
        self, event: DualEvent, need_reply: bool, out: MsgsToSend
    ) -> None:
        """Dual.cpp:248-293."""
        if not self._route_affected():
            if need_reply:
                self._send_reply(out)
            return
        fc = self._meet_feasible_condition()
        if self.info.nexthop is None:
            assert fc is not None, "nexthop invalid, must meet FC"
        if fc is not None:
            self._local_computation(fc[0], fc[1], out)
            if need_reply:
                self._send_reply(out)
        else:
            if need_reply and event != DualEvent.QUERY_FROM_SUCCESSOR:
                self._send_reply(out)
            success = self._diffusing_computation(out)
            if success:
                self.info.sm.process_event(event, False)
            if self.info.nexthop is not None and not self._neighbor_up(
                self.info.nexthop
            ):
                self._set_nexthop(None)

    # -- events (Dual.cpp:401-527) ------------------------------------------

    def peer_up(self, neighbor: str, cost: int, out: MsgsToSend) -> None:
        if self.info.nexthop == neighbor:
            # chose this neighbor before a non-graceful restart: reset
            # as-if peer-down had been seen (Dual.cpp:409-418)
            self._set_nexthop(None)
            self.info.distance = INFINITY64
        self.local_distances[neighbor] = cost
        self.info.neighbor_infos.setdefault(neighbor, NeighborInfo())

        if self.info.sm.state == DualState.PASSIVE:
            self._try_local_or_diffusing(DualEvent.OTHERS, False, out)
        else:
            if self.info.neighbor_infos[neighbor].expect_reply:
                # expected reply arrived via link-up (Dual.cpp:429-438)
                self.process_reply(
                    neighbor,
                    self._mk_msg(
                        DualMessageType.REPLY,
                        self.info.neighbor_infos[neighbor].report_distance,
                    ),
                    out,
                )

        # send my current report distance (Dual.cpp:441-451)
        self._queue(
            out,
            neighbor,
            self._mk_msg(DualMessageType.UPDATE, self.info.report_distance),
        )
        if self.info.neighbor_infos[neighbor].need_to_reply:
            self.info.neighbor_infos[neighbor].need_to_reply = False
            self._queue(
                out,
                neighbor,
                self._mk_msg(DualMessageType.REPLY, self.info.report_distance),
            )

    def peer_down(self, neighbor: str, out: MsgsToSend) -> None:
        self.clear_counters(neighbor)
        self.remove_child(neighbor)
        self.local_distances[neighbor] = INFINITY64
        self.info.neighbor_infos.setdefault(
            neighbor, NeighborInfo()
        ).report_distance = INFINITY64
        if self.info.sm.state == DualState.PASSIVE:
            self._try_local_or_diffusing(DualEvent.INCREASE_D, False, out)
        else:
            self.info.sm.process_event(DualEvent.INCREASE_D)
            if self.info.neighbor_infos[neighbor].expect_reply:
                # equivalent to a max-distance reply (Dual.cpp:490-499)
                self.process_reply(
                    neighbor,
                    self._mk_msg(DualMessageType.REPLY, INFINITY64),
                    out,
                )

    def peer_cost_change(self, neighbor: str, cost: int, out: MsgsToSend) -> None:
        event = (
            DualEvent.INCREASE_D
            if cost > self.local_distances.get(neighbor, INFINITY64)
            else DualEvent.OTHERS
        )
        self.local_distances[neighbor] = cost
        if self.info.sm.state == DualState.PASSIVE:
            self._try_local_or_diffusing(event, False, out)
        else:
            if self.info.nexthop == neighbor:
                self.info.distance = add_distances(
                    cost, self.info.neighbor_infos[neighbor].report_distance
                )
            self.info.sm.process_event(event)

    # -- messages (Dual.cpp:529-715) ----------------------------------------

    def process_update(
        self, neighbor: str, update: DualMessage, out: MsgsToSend
    ) -> None:
        assert update.type == DualMessageType.UPDATE
        assert update.dst_id == self.root_id
        cnt = self._cnt(neighbor)
        cnt.update_recv += 1
        cnt.total_recv += 1
        self.info.neighbor_infos.setdefault(
            neighbor, NeighborInfo()
        ).report_distance = update.distance
        if neighbor not in self.local_distances:
            return  # UPDATE before LINK-UP (Dual.cpp:548-551)
        if self.info.sm.state == DualState.PASSIVE:
            self._try_local_or_diffusing(DualEvent.OTHERS, False, out)
        else:
            if self.info.nexthop == neighbor:
                self.info.distance = add_distances(
                    self.local_distances[neighbor], update.distance
                )
            self.info.sm.process_event(DualEvent.OTHERS)

    def process_query(
        self, neighbor: str, query: DualMessage, out: MsgsToSend
    ) -> None:
        assert query.type == DualMessageType.QUERY
        assert query.dst_id == self.root_id
        cnt = self._cnt(neighbor)
        cnt.query_recv += 1
        cnt.total_recv += 1
        self.info.neighbor_infos.setdefault(
            neighbor, NeighborInfo()
        ).report_distance = query.distance
        self.info.cornet.append(neighbor)
        event = (
            DualEvent.QUERY_FROM_SUCCESSOR
            if self.info.nexthop == neighbor
            else DualEvent.OTHERS
        )
        if self.info.sm.state == DualState.PASSIVE:
            self._try_local_or_diffusing(event, True, out)
        else:
            if self.info.nexthop == neighbor:
                self.info.distance = add_distances(
                    self.local_distances[neighbor],
                    self.info.neighbor_infos[neighbor].report_distance,
                )
            self.info.sm.process_event(event)
            self._send_reply(out)

    def process_reply(
        self, neighbor: str, reply: DualMessage, out: MsgsToSend
    ) -> None:
        assert reply.type == DualMessageType.REPLY
        assert reply.dst_id == self.root_id
        cnt = self._cnt(neighbor)
        cnt.reply_recv += 1
        cnt.total_recv += 1
        ninfo = self.info.neighbor_infos.setdefault(neighbor, NeighborInfo())
        if not ninfo.expect_reply:
            # link-down raced the reply; ignore (Dual.cpp:651-658)
            return
        ninfo.report_distance = reply.distance
        ninfo.expect_reply = False
        if any(i.expect_reply for i in self.info.neighbor_infos.values()):
            return

        # last reply: free to pick the optimal route (Dual.cpp:676-706)
        self.info.sm.process_event(DualEvent.LAST_REPLY, True)
        dmin = INFINITY64
        new_nh: Optional[str] = None
        for nb, ld in self.local_distances.items():
            d = add_distances(
                ld, self.info.neighbor_infos[nb].report_distance
            )
            if d < dmin:
                dmin = d
                new_nh = nb
        same_rd = dmin == self.info.report_distance
        self.info.distance = dmin
        self.info.report_distance = dmin
        self.info.feasible_distance = dmin
        self._set_nexthop(new_nh)
        if not same_rd:
            self._flood_updates(out)

        if self.info.cornet:
            assert len(self.info.cornet) == 1, (
                "one diffusing per destination"
            )
            self._send_reply(out)

    # -- introspection -------------------------------------------------------

    def status_string(self) -> str:
        return f"root({self.root_id})::{self.node_id}: {self.info}"


class DualNode:
    """Multi-root DUAL driver (reference: class DualNode, Dual.h:315-412).

    Subclass or compose: provide `send_dual_messages(neighbor, msgs)` and
    `process_nexthop_change(root_id, old_nh, new_nh)` callbacks."""

    def __init__(
        self,
        node_id: str,
        is_root: bool = False,
        send_dual_messages: Optional[
            Callable[[str, DualMessages], bool]
        ] = None,
        process_nexthop_change: Optional[
            Callable[[str, Optional[str], Optional[str]], None]
        ] = None,
    ) -> None:
        self.node_id = node_id
        self.is_root = is_root
        self._send = send_dual_messages
        self._nexthop_change = process_nexthop_change
        self.local_distances: dict[str, int] = {}
        self.duals: dict[str, Dual] = {}
        self.pkt_counters: dict[str, dict[str, int]] = {}
        if is_root:
            self._add_dual(node_id)

    # -- hooks ---------------------------------------------------------------

    def send_dual_messages(self, neighbor: str, msgs: DualMessages) -> bool:
        if self._send is None:
            return False
        return self._send(neighbor, msgs)

    def process_nexthop_change(
        self, root_id: str, old_nh: Optional[str], new_nh: Optional[str]
    ) -> None:
        if self._nexthop_change is not None:
            self._nexthop_change(root_id, old_nh, new_nh)

    # -- events --------------------------------------------------------------

    def peer_up(self, neighbor: str, cost: int) -> None:
        self.local_distances[neighbor] = cost
        out: MsgsToSend = {}
        for dual in self.duals.values():
            dual.peer_up(neighbor, cost, out)
        self._send_all(out)

    def peer_down(self, neighbor: str) -> None:
        self.local_distances[neighbor] = INFINITY64
        self.pkt_counters.pop(neighbor, None)
        out: MsgsToSend = {}
        for dual in self.duals.values():
            dual.peer_down(neighbor, out)
        self._send_all(out)

    def peer_cost_change(self, neighbor: str, cost: int) -> None:
        self.local_distances[neighbor] = cost
        out: MsgsToSend = {}
        for dual in self.duals.values():
            dual.peer_cost_change(neighbor, cost, out)
        self._send_all(out)

    def process_dual_messages(self, messages: DualMessages) -> None:
        out: MsgsToSend = {}
        neighbor = messages.src_id
        cnt = self.pkt_counters.setdefault(
            neighbor, {"pkt_recv": 0, "msg_recv": 0, "pkt_sent": 0, "msg_sent": 0}
        )
        cnt["pkt_recv"] += 1
        cnt["msg_recv"] += len(messages.messages)
        for msg in messages.messages:
            root_id = msg.dst_id
            self._add_dual(root_id)
            dual = self.duals[root_id]
            if msg.type == DualMessageType.UPDATE:
                dual.process_update(neighbor, msg, out)
            elif msg.type == DualMessageType.QUERY:
                dual.process_query(neighbor, msg, out)
            elif msg.type == DualMessageType.REPLY:
                dual.process_reply(neighbor, msg, out)
        self._send_all(out)

    # -- getters -------------------------------------------------------------

    def has_dual(self, root_id: str) -> bool:
        return root_id in self.duals

    def get_dual(self, root_id: str) -> Dual:
        return self.duals[root_id]

    def get_spt_root_id(self) -> Optional[str]:
        """Smallest root-id with a valid route (Dual.cpp:788-803)."""
        for root_id in sorted(self.duals):
            if self.duals[root_id].has_valid_route():
                return root_id
        return None

    def get_spt_peers(self, root_id: Optional[str]) -> set[str]:
        if root_id is None or root_id not in self.duals:
            return set()
        return self.duals[root_id].spt_peers()

    def get_info(self, root_id: str) -> Optional[RouteInfo]:
        dual = self.duals.get(root_id)
        return dual.info if dual else None

    def get_infos(self) -> dict[str, RouteInfo]:
        return {r: d.info for r, d in self.duals.items()}

    def neighbor_up(self, neighbor: str) -> bool:
        return self.local_distances.get(neighbor, INFINITY64) != INFINITY64

    def status_strings(self) -> dict[str, str]:
        return {r: d.status_string() for r, d in self.duals.items()}

    # -- internal ------------------------------------------------------------

    def _send_all(self, out: MsgsToSend) -> None:
        for neighbor, msgs in out.items():
            if not msgs.messages:
                continue
            msgs.src_id = self.node_id
            if not self.send_dual_messages(neighbor, msgs):
                log.error("failed to send dual messages to %s", neighbor)
                continue
            cnt = self.pkt_counters.setdefault(
                neighbor,
                {"pkt_recv": 0, "msg_recv": 0, "pkt_sent": 0, "msg_sent": 0},
            )
            cnt["pkt_sent"] += 1
            cnt["msg_sent"] += len(msgs.messages)

    def _add_dual(self, root_id: str) -> None:
        if root_id in self.duals:
            return

        def cb(old_nh: Optional[str], new_nh: Optional[str], root=root_id):
            self.process_nexthop_change(root, old_nh, new_nh)

        self.duals[root_id] = Dual(
            self.node_id, root_id, self.local_distances, cb
        )
