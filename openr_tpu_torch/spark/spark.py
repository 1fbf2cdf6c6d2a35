"""Spark: the neighbor-discovery event base.

Port of `openr_tpu.spark.spark` (reference: openr/spark/Spark.{h,cpp};
FSM documented in openr/docs/Protocol_Guide/Spark.md "State Transition
Map"):

- per-(interface, neighbor) FSM: IDLE / WARM / NEGOTIATE / ESTABLISHED /
  RESTART, transitions exactly per the reference's table;
- SparkHelloMsg per interface (neighbor solicitation + visibility
  reflection for RTT), SparkHandshakeMsg per neighbor (hold/GR time and
  area negotiation), SparkHeartbeatMsg per interface (keep-alive);
- RTT from reflected timestamps, smoothed through StepDetector ->
  NEIGHBOR_RTT_CHANGE events;
- graceful restart: HELLO_RCVD_RESTART -> RESTART state + GR hold timer;
  `flood_restarting_msg` announces our own restart.

With tracing armed (`obs.trace`), each neighbor event roots a shallow
`spark.neighbor_event` trace, finished right after its push.
"""

from __future__ import annotations

import enum
import hashlib
import logging
import random
import re
import time
from dataclasses import dataclass, field
from typing import Optional

from ..obs import trace as _trace
from ..runtime.eventbase import OpenrEventBase
from ..runtime.queue import QueueClosedError, ReplicateQueue, RQueue
from ..serializer import dumps, loads
from ..types import (
    InterfaceDatabase,
    NeighborEvent,
    NeighborEventType,
    ReflectedNeighborInfo,
    SparkHandshakeMsg,
    SparkHelloMsg,
    SparkHeartbeatMsg,
    SparkPacket,
)
from ..utils.step_detector import StepDetector
from .io_provider import IoProvider

log = logging.getLogger(__name__)


class SparkNeighState(enum.IntEnum):
    IDLE = 0
    WARM = 1
    NEGOTIATE = 2
    ESTABLISHED = 3
    RESTART = 4


class SparkNeighEvent(enum.IntEnum):
    HELLO_RCVD_INFO = 0
    HELLO_RCVD_NO_INFO = 1
    HELLO_RCVD_RESTART = 2
    HEARTBEAT_RCVD = 3
    HANDSHAKE_RCVD = 4
    HEARTBEAT_TIMER_EXPIRE = 5
    NEGOTIATE_TIMER_EXPIRE = 6
    GR_TIMER_EXPIRE = 7
    NEGOTIATION_FAILURE = 8


S = SparkNeighState
E = SparkNeighEvent
# reference FSM table (Spark.md "State Transition Map")
_FSM: dict[tuple[SparkNeighState, SparkNeighEvent], SparkNeighState] = {
    (S.IDLE, E.HELLO_RCVD_INFO): S.WARM,
    (S.IDLE, E.HELLO_RCVD_NO_INFO): S.WARM,
    (S.WARM, E.HELLO_RCVD_INFO): S.NEGOTIATE,
    (S.NEGOTIATE, E.HANDSHAKE_RCVD): S.ESTABLISHED,
    (S.NEGOTIATE, E.NEGOTIATE_TIMER_EXPIRE): S.WARM,
    (S.NEGOTIATE, E.NEGOTIATION_FAILURE): S.WARM,
    (S.ESTABLISHED, E.HELLO_RCVD_NO_INFO): S.IDLE,
    (S.ESTABLISHED, E.HELLO_RCVD_RESTART): S.RESTART,
    (S.ESTABLISHED, E.HEARTBEAT_RCVD): S.ESTABLISHED,
    (S.ESTABLISHED, E.HEARTBEAT_TIMER_EXPIRE): S.IDLE,
    (S.RESTART, E.HELLO_RCVD_INFO): S.ESTABLISHED,
    (S.RESTART, E.GR_TIMER_EXPIRE): S.IDLE,
}


@dataclass(slots=True)
class AreaConfig:
    """Reference: thrift::AreaConfig (openr/if/OpenrConfig.thrift:322)."""

    area_id: str = "0"
    interface_regexes: list[str] = field(default_factory=lambda: [".*"])
    neighbor_regexes: list[str] = field(default_factory=lambda: [".*"])

    def matches(self, if_name: str, neighbor: str) -> bool:
        return any(re.fullmatch(p, if_name) for p in self.interface_regexes) and any(
            re.fullmatch(p, neighbor) for p in self.neighbor_regexes
        )


@dataclass(slots=True)
class SparkConfig:
    """Reference: thrift::SparkConfig (openr/if/OpenrConfig.thrift:116)."""

    hello_time_s: float = 20.0
    fastinit_hello_time_s: float = 0.5
    keepalive_time_s: float = 2.0  # heartbeat send interval
    hold_time_s: float = 10.0  # heartbeat hold
    graceful_restart_time_s: float = 30.0
    negotiate_hold_time_s: float = 1.0
    step_detector_fast_window_size: int = 10
    step_detector_slow_window_size: int = 60
    step_detector_lower_threshold_pct: float = 0.4
    step_detector_upper_threshold_pct: float = 0.6
    step_detector_abs_threshold: int = 500


class SparkNeighbor:
    """Reference: Spark::SparkNeighbor (openr/spark/Spark.h:273)."""

    __slots__ = (
        "node_name",
        "if_name",
        "state",
        "area",
        "seq_num",
        "transport_addr_v6",
        "transport_addr_v4",
        "ctrl_port",
        "kvstore_port",
        "rtt_us",
        "rtt_latest_us",
        "step_detector",
        "remote_if_name",
        "last_hello_sent_ts_us",
        "last_nbr_hello_rcvd_ts_us",
        "last_nbr_hello_sent_ts_us",
        "heartbeat_hold_timer",
        "negotiate_hold_timer",
        "gr_hold_timer",
        "gr_hold_time_ms",
        "hold_time_ms",
        "seen_restarting",
    )

    def __init__(self, node_name: str, if_name: str) -> None:
        self.node_name = node_name
        self.if_name = if_name
        self.state = SparkNeighState.IDLE
        self.area = ""
        self.seq_num = 0
        self.transport_addr_v6 = ""
        self.transport_addr_v4 = ""
        self.ctrl_port = 0
        self.kvstore_port = 0
        self.rtt_us = 0
        self.rtt_latest_us = 0
        self.remote_if_name = ""
        self.step_detector: Optional[StepDetector] = None
        self.last_hello_sent_ts_us = 0
        self.last_nbr_hello_rcvd_ts_us = 0
        self.last_nbr_hello_sent_ts_us = 0
        self.heartbeat_hold_timer = None
        self.negotiate_hold_timer = None
        self.gr_hold_timer = None
        self.gr_hold_time_ms = 0
        self.hold_time_ms = 0
        self.seen_restarting = False


class Spark(OpenrEventBase):
    def __init__(
        self,
        node_name: str,
        interface_updates: RQueue[InterfaceDatabase],
        neighbor_updates_queue: ReplicateQueue[NeighborEvent],
        io_provider: IoProvider,
        *,
        config: Optional[SparkConfig] = None,
        areas: Optional[list[AreaConfig]] = None,
        domain: str = "openr",
        ctrl_port: int = 2018,
        kvstore_port: int = 60002,
        v4_addr: str = "",
        v6_addr: str = "",
    ) -> None:
        super().__init__(name=f"spark-{node_name}")
        self.node_name = node_name
        self.domain = domain
        self.config = config or SparkConfig()
        self.areas = areas or [AreaConfig()]
        self.ctrl_port = ctrl_port
        self.kvstore_port = kvstore_port
        digest = int.from_bytes(
            hashlib.blake2b(node_name.encode(), digest_size=2).digest(), "big"
        )
        self.v4_addr = v4_addr or f"169.254.{digest % 250 + 1}.{digest // 256 % 250 + 1}"
        self.v6_addr = v6_addr or f"fe80::{node_name}"
        self._interface_updates = interface_updates
        self._neighbor_updates_queue = neighbor_updates_queue
        self.io = io_provider
        # if_name -> {neighbor_name -> SparkNeighbor}
        self.neighbors: dict[str, dict[str, SparkNeighbor]] = {}
        self._interfaces: set[str] = set()
        self._hello_timers: dict[str, object] = {}
        self._heartbeat_timers: dict[str, object] = {}
        self._seq_num = 0
        self._restarting = False
        self._fastinit_rounds: dict[str, int] = {}
        self.counters: dict[str, int] = {}
        self._max_fastinit_rounds = 10

    # -- lifecycle -----------------------------------------------------------

    def run(self) -> None:
        super().run()
        self.wait_until_running()
        self.run_in_event_base_thread(self._setup).result()

    def _setup(self) -> None:
        self.io.attach(self.node_name)
        self.add_fiber_task(self._recv_fiber(), name="sparkRecv")
        self.add_fiber_task(self._interface_fiber(), name="ifUpdates")

    def _bump(self, counter: str, n: int = 1) -> None:
        self.counters[counter] = self.counters.get(counter, 0) + n

    # -- fibers --------------------------------------------------------------

    async def _recv_fiber(self) -> None:
        while True:
            pkt = await self.io.recv()
            try:
                self._process_packet(pkt.if_name, pkt.data, pkt.recv_ts_us)
            except Exception:
                log.exception("spark: bad packet on %s", pkt.if_name)
                self._bump("spark.parse_error")

    async def _interface_fiber(self) -> None:
        while True:
            try:
                if_db = await self._interface_updates.aget()
            except QueueClosedError:
                return
            self.process_interface_updates(if_db)

    # -- interface tracking (reference: processInterfaceUpdates) -------------

    def process_interface_updates(self, if_db: InterfaceDatabase) -> None:
        up_ifs = {
            name for name, info in if_db.interfaces.items() if info.is_up
        }
        for if_name in up_ifs - self._interfaces:
            self._add_interface(if_name)
        for if_name in self._interfaces - up_ifs:
            self._remove_interface(if_name)

    def _add_interface(self, if_name: str) -> None:
        self._interfaces.add(if_name)
        self.neighbors.setdefault(if_name, {})
        self.io.add_interface(if_name)
        # fast-init hellos solicit immediate responses
        self._fastinit_rounds[if_name] = 0
        self._schedule_hello(if_name, fastinit=True)
        self._schedule_heartbeat(if_name)

    def _remove_interface(self, if_name: str) -> None:
        self._interfaces.discard(if_name)
        for timers in (self._hello_timers, self._heartbeat_timers):
            timer = timers.pop(if_name, None)
            if timer is not None:
                timer.cancel()
        for neighbor in list(self.neighbors.get(if_name, {}).values()):
            if neighbor.state in (
                SparkNeighState.ESTABLISHED,
                SparkNeighState.RESTART,
            ):
                self._neighbor_down(neighbor, NeighborEventType.NEIGHBOR_DOWN)
            else:
                # disarm orphaned timers so they can't fire against a
                # future re-established neighbor with the same key
                for attr in (
                    "heartbeat_hold_timer",
                    "negotiate_hold_timer",
                    "gr_hold_timer",
                ):
                    self._cancel_timer(neighbor, attr)
        self.neighbors.pop(if_name, None)
        self.io.remove_interface(if_name)

    # -- senders (reference: Spark.h:180-193) --------------------------------

    def _schedule_hello(self, if_name: str, fastinit: bool = False) -> None:
        if if_name not in self._interfaces:
            return
        existing = self._hello_timers.pop(if_name, None)
        if existing is not None:
            existing.cancel()
        period = (
            self.config.fastinit_hello_time_s
            if fastinit
            else self.config.hello_time_s
        )
        # jitter avoids synchronized multicast bursts
        period *= random.uniform(0.9, 1.1)
        self._hello_timers[if_name] = self.schedule_timeout(
            period, lambda: self._hello_tick(if_name, fastinit)
        )

    def _hello_tick(self, if_name: str, was_fastinit: bool) -> None:
        if if_name not in self._interfaces:
            return
        self.send_hello(if_name)
        # stay in fastinit until a neighbor is past WARM, bounded by a
        # round budget so an idle port decays to the slow hello rate
        rounds = self._fastinit_rounds.get(if_name, 0) + 1
        self._fastinit_rounds[if_name] = rounds
        fastinit = (
            was_fastinit
            and rounds < self._max_fastinit_rounds
            and not any(
                n.state
                in (SparkNeighState.NEGOTIATE, SparkNeighState.ESTABLISHED)
                for n in self.neighbors.get(if_name, {}).values()
            )
        )
        self._schedule_hello(if_name, fastinit=fastinit)

    def send_hello(
        self, if_name: str, restarting: bool = False, solicit: bool = False
    ) -> None:
        self._seq_num += 1
        # CLOCK_REALTIME: the RTT timestamp domain must match the
        # transport's KERNEL rx timestamps (UdpIoProvider SO_TIMESTAMPNS,
        # reference: Spark.cpp:447-448) — t4 (kernel rx) and t1 (this
        # send stamp) difference only makes sense on one clock.  NTP
        # steps between t1 and t4 produce outliers; StepDetector exists
        # to filter exactly those.
        now_us = int(time.clock_gettime(time.CLOCK_REALTIME) * 1e6)
        neighbor_infos = {}
        for name, neighbor in self.neighbors.get(if_name, {}).items():
            neighbor_infos[name] = ReflectedNeighborInfo(
                last_nbr_msg_sent_ts_us=neighbor.last_nbr_hello_sent_ts_us,
                last_my_msg_rcvd_ts_us=neighbor.last_nbr_hello_rcvd_ts_us,
            )
        msg = SparkHelloMsg(
            domain_name=self.domain,
            node_name=self.node_name,
            if_name=if_name,
            seq_num=self._seq_num,
            neighbor_infos=neighbor_infos,
            solicit_response=solicit,
            restarting=restarting or self._restarting,
            sent_ts_us=now_us,
        )
        for neighbor in self.neighbors.get(if_name, {}).values():
            neighbor.last_hello_sent_ts_us = now_us
        self.io.send(if_name, dumps(SparkPacket(hello=msg)))
        self._bump("spark.hello.packets_sent")

    def _send_handshake(self, if_name: str, neighbor_name: str, established: bool) -> None:
        msg = SparkHandshakeMsg(
            node_name=self.node_name,
            is_adjacency_established=established,
            hold_time_ms=int(self.config.hold_time_s * 1000),
            gr_hold_time_ms=int(self.config.graceful_restart_time_s * 1000),
            transport_addr_v6=self.v6_addr,
            transport_addr_v4=self.v4_addr,
            openr_ctrl_port=self.ctrl_port,
            kvstore_cmd_port=self.kvstore_port,
            area=self._negotiate_area(if_name, neighbor_name) or "",
            neighbor_node_name=neighbor_name,
        )
        self.io.send(if_name, dumps(SparkPacket(handshake=msg)))
        self._bump("spark.handshake.packets_sent")

    def _schedule_heartbeat(self, if_name: str) -> None:
        existing = self._heartbeat_timers.pop(if_name, None)
        if existing is not None:
            existing.cancel()
        self._heartbeat_timers[if_name] = self.schedule_timeout(
            self.config.keepalive_time_s * random.uniform(0.9, 1.1),
            lambda: self._heartbeat_tick(if_name),
        )

    def _heartbeat_tick(self, if_name: str) -> None:
        if if_name not in self._interfaces:
            return
        self._seq_num += 1
        msg = SparkHeartbeatMsg(
            node_name=self.node_name,
            seq_num=self._seq_num,
            hold_time_ms=int(self.config.hold_time_s * 1000),
        )
        self.io.send(if_name, dumps(SparkPacket(heartbeat=msg)))
        self._bump("spark.heartbeat.packets_sent")
        self._schedule_heartbeat(if_name)

    # -- receive path --------------------------------------------------------

    def _process_packet(self, if_name: str, data: bytes, recv_ts_us: int) -> None:
        if if_name not in self._interfaces:
            return
        packet = loads(data, SparkPacket)
        if packet.hello is not None:
            self._process_hello(if_name, packet.hello, recv_ts_us)
        elif packet.handshake is not None:
            self._process_handshake(if_name, packet.handshake)
        elif packet.heartbeat is not None:
            self._process_heartbeat(if_name, packet.heartbeat)

    def _fsm(self, neighbor: SparkNeighbor, event: SparkNeighEvent) -> bool:
        """Apply an FSM transition; returns False for invalid (ignored)
        events (the reference CHECKs; we tolerate + count)."""
        new_state = _FSM.get((neighbor.state, event))
        if new_state is None:
            self._bump("spark.invalid_state_transition")
            return False
        if new_state != neighbor.state:
            log.debug(
                "spark[%s]: %s/%s %s -> %s on %s",
                self.node_name,
                neighbor.if_name,
                neighbor.node_name,
                neighbor.state.name,
                new_state.name,
                event.name,
            )
        neighbor.state = new_state
        return True

    def _process_hello(
        self, if_name: str, hello: SparkHelloMsg, recv_ts_us: int
    ) -> None:
        """Reference: processHelloMsg (openr/spark/Spark.cpp)."""
        if hello.node_name == self.node_name:
            return  # our own multicast echo
        if hello.domain_name != self.domain:
            self._bump("spark.hello.invalid_domain")
            return
        self._bump("spark.hello.packets_recv")

        neighbors = self.neighbors.setdefault(if_name, {})
        neighbor = neighbors.get(hello.node_name)
        if neighbor is None:
            neighbor = neighbors[hello.node_name] = SparkNeighbor(
                hello.node_name, if_name
            )
            # a brand-new neighbor: restart fast hellos to converge quickly
            self._fastinit_rounds[if_name] = 0
            self._schedule_hello(if_name, fastinit=True)

        neighbor.last_nbr_hello_rcvd_ts_us = recv_ts_us
        neighbor.last_nbr_hello_sent_ts_us = hello.sent_ts_us
        neighbor.remote_if_name = hello.if_name
        neighbor.seq_num = hello.seq_num

        my_info = hello.neighbor_infos.get(self.node_name)
        seen_me = my_info is not None

        # RTT: (t4 - t1) - (t3 - t2) where t1 = my hello sent, t2 = their
        # receipt of it, t3 = their hello sent, t4 = my receipt
        if seen_me and my_info.last_my_msg_rcvd_ts_us and my_info.last_nbr_msg_sent_ts_us:
            rtt_us = (recv_ts_us - my_info.last_nbr_msg_sent_ts_us) - (
                hello.sent_ts_us - my_info.last_my_msg_rcvd_ts_us
            )
            if rtt_us > 0:
                self._update_rtt(neighbor, rtt_us)

        state = neighbor.state
        if state == SparkNeighState.IDLE:
            event = (
                SparkNeighEvent.HELLO_RCVD_INFO
                if seen_me
                else SparkNeighEvent.HELLO_RCVD_NO_INFO
            )
            self._fsm(neighbor, event)
            if neighbor.state == SparkNeighState.WARM and seen_me:
                # already mutually visible: go straight to NEGOTIATE
                self._fsm(neighbor, SparkNeighEvent.HELLO_RCVD_INFO)
                self._start_negotiate(neighbor)
        elif state == SparkNeighState.WARM:
            if seen_me:
                self._fsm(neighbor, SparkNeighEvent.HELLO_RCVD_INFO)
                self._start_negotiate(neighbor)
        elif state == SparkNeighState.ESTABLISHED:
            if hello.restarting:
                self._neighbor_restarting(neighbor)
            elif not seen_me:
                # neighbor no longer sees us (e.g. it restarted fast)
                self._fsm(neighbor, SparkNeighEvent.HELLO_RCVD_NO_INFO)
                self._neighbor_down(neighbor, NeighborEventType.NEIGHBOR_DOWN)
                self._schedule_hello(if_name, fastinit=True)
        elif state == SparkNeighState.RESTART:
            if seen_me and not hello.restarting:
                self._fsm(neighbor, SparkNeighEvent.HELLO_RCVD_INFO)
                self._cancel_timer(neighbor, "gr_hold_timer")
                self._start_heartbeat_hold(neighbor)
                self._publish_event(
                    NeighborEventType.NEIGHBOR_RESTARTED, neighbor
                )

        if hello.solicit_response:
            self.send_hello(if_name)

    def _start_negotiate(self, neighbor: SparkNeighbor) -> None:
        area = self._negotiate_area(neighbor.if_name, neighbor.node_name)
        if area is None:
            self._bump("spark.negotiate.area_mismatch")
            self._fsm(neighbor, SparkNeighEvent.NEGOTIATION_FAILURE)
            return
        neighbor.area = area
        self._send_handshake(neighbor.if_name, neighbor.node_name, False)
        self._cancel_timer(neighbor, "negotiate_hold_timer")
        neighbor.negotiate_hold_timer = self.schedule_timeout(
            self.config.negotiate_hold_time_s,
            lambda: self._negotiate_expired(neighbor),
        )

    def _negotiate_expired(self, neighbor: SparkNeighbor) -> None:
        neighbor.negotiate_hold_timer = None
        if neighbor.state == SparkNeighState.NEGOTIATE:
            self._fsm(neighbor, SparkNeighEvent.NEGOTIATE_TIMER_EXPIRE)

    def _negotiate_area(self, if_name: str, neighbor_name: str) -> Optional[str]:
        """First matching area config wins (reference: getNeighborArea)."""
        for area_cfg in self.areas:
            if area_cfg.matches(if_name, neighbor_name):
                return area_cfg.area_id
        return None

    def _process_handshake(self, if_name: str, msg: SparkHandshakeMsg) -> None:
        """Reference: processHandshakeMsg."""
        if msg.node_name == self.node_name:
            return
        if (
            msg.neighbor_node_name is not None
            and msg.neighbor_node_name != self.node_name
        ):
            return  # destined to someone else on the segment
        self._bump("spark.handshake.packets_recv")
        neighbor = self.neighbors.get(if_name, {}).get(msg.node_name)
        if neighbor is None:
            return

        # reply (once) so the peer can establish too
        if not msg.is_adjacency_established:
            self._send_handshake(if_name, msg.node_name, True)

        if neighbor.state != SparkNeighState.NEGOTIATE:
            return

        # area must agree (reference: area negotiation check)
        my_area = self._negotiate_area(if_name, msg.node_name)
        if my_area is None or (msg.area and msg.area != my_area):
            self._fsm(neighbor, SparkNeighEvent.NEGOTIATION_FAILURE)
            self._cancel_timer(neighbor, "negotiate_hold_timer")
            return

        neighbor.area = my_area
        neighbor.transport_addr_v6 = msg.transport_addr_v6
        neighbor.transport_addr_v4 = msg.transport_addr_v4
        neighbor.ctrl_port = msg.openr_ctrl_port
        neighbor.kvstore_port = msg.kvstore_cmd_port
        neighbor.hold_time_ms = msg.hold_time_ms
        neighbor.gr_hold_time_ms = msg.gr_hold_time_ms
        self._fsm(neighbor, SparkNeighEvent.HANDSHAKE_RCVD)
        self._cancel_timer(neighbor, "negotiate_hold_timer")
        self._start_heartbeat_hold(neighbor)
        self._publish_event(NeighborEventType.NEIGHBOR_UP, neighbor)

    def _process_heartbeat(self, if_name: str, msg: SparkHeartbeatMsg) -> None:
        """Reference: processHeartbeatMsg — refresh hold timer."""
        if msg.node_name == self.node_name:
            return
        neighbor = self.neighbors.get(if_name, {}).get(msg.node_name)
        if neighbor is None or neighbor.state != SparkNeighState.ESTABLISHED:
            return
        self._fsm(neighbor, SparkNeighEvent.HEARTBEAT_RCVD)
        self._start_heartbeat_hold(neighbor)

    # -- timers / events -----------------------------------------------------

    def _cancel_timer(self, neighbor: SparkNeighbor, attr: str) -> None:
        timer = getattr(neighbor, attr)
        if timer is not None:
            timer.cancel()
            setattr(neighbor, attr, None)

    def _start_heartbeat_hold(self, neighbor: SparkNeighbor) -> None:
        self._cancel_timer(neighbor, "heartbeat_hold_timer")
        hold_s = (
            neighbor.hold_time_ms / 1000.0
            if neighbor.hold_time_ms
            else self.config.hold_time_s
        )
        neighbor.heartbeat_hold_timer = self.schedule_timeout(
            hold_s, lambda: self._heartbeat_hold_expired(neighbor)
        )

    def _heartbeat_hold_expired(self, neighbor: SparkNeighbor) -> None:
        neighbor.heartbeat_hold_timer = None
        if neighbor.state == SparkNeighState.ESTABLISHED:
            self._fsm(neighbor, SparkNeighEvent.HEARTBEAT_TIMER_EXPIRE)
            self._neighbor_down(neighbor, NeighborEventType.NEIGHBOR_DOWN)
            self._schedule_hello(neighbor.if_name, fastinit=True)

    def _neighbor_restarting(self, neighbor: SparkNeighbor) -> None:
        """ESTABLISHED -> RESTART with GR hold (reference: GR handling)."""
        self._fsm(neighbor, SparkNeighEvent.HELLO_RCVD_RESTART)
        self._cancel_timer(neighbor, "heartbeat_hold_timer")
        gr_s = (
            neighbor.gr_hold_time_ms / 1000.0
            if neighbor.gr_hold_time_ms
            else self.config.graceful_restart_time_s
        )
        self._cancel_timer(neighbor, "gr_hold_timer")
        neighbor.gr_hold_timer = self.schedule_timeout(
            gr_s, lambda: self._gr_expired(neighbor)
        )
        self._publish_event(NeighborEventType.NEIGHBOR_RESTARTING, neighbor)

    def _gr_expired(self, neighbor: SparkNeighbor) -> None:
        neighbor.gr_hold_timer = None
        if neighbor.state == SparkNeighState.RESTART:
            self._fsm(neighbor, SparkNeighEvent.GR_TIMER_EXPIRE)
            self._neighbor_down(neighbor, NeighborEventType.NEIGHBOR_DOWN)
            self._schedule_hello(neighbor.if_name, fastinit=True)

    def _neighbor_down(
        self, neighbor: SparkNeighbor, event_type: NeighborEventType
    ) -> None:
        for attr in ("heartbeat_hold_timer", "negotiate_hold_timer", "gr_hold_timer"):
            self._cancel_timer(neighbor, attr)
        self._publish_event(event_type, neighbor)
        neighbor.state = SparkNeighState.IDLE

    def _update_rtt(self, neighbor: SparkNeighbor, rtt_us: int) -> None:
        """RTT smoothing through StepDetector; significant changes publish
        NEIGHBOR_RTT_CHANGE (reference: kernel-timestamped RTT ->
        StepDetector, openr/spark/Spark.h:273)."""
        neighbor.rtt_latest_us = rtt_us
        if neighbor.step_detector is None:
            cfg = self.config
            neighbor.step_detector = StepDetector(
                fast_window_size=cfg.step_detector_fast_window_size,
                slow_window_size=cfg.step_detector_slow_window_size,
                lower_threshold_pct=cfg.step_detector_lower_threshold_pct,
                upper_threshold_pct=cfg.step_detector_upper_threshold_pct,
                abs_threshold=cfg.step_detector_abs_threshold,
            )
            neighbor.rtt_us = rtt_us
        if neighbor.step_detector.add_value(rtt_us):
            neighbor.rtt_us = rtt_us
            if neighbor.state == SparkNeighState.ESTABLISHED:
                self._publish_event(
                    NeighborEventType.NEIGHBOR_RTT_CHANGE, neighbor
                )

    def _publish_event(
        self, event_type: NeighborEventType, neighbor: SparkNeighbor
    ) -> None:
        event = NeighborEvent(
            event_type=event_type,
            node_name=neighbor.node_name,
            if_name=neighbor.if_name,
            remote_if_name=neighbor.remote_if_name,
            area=neighbor.area,
            neighbor_addr_v6=neighbor.transport_addr_v6,
            neighbor_addr_v4=neighbor.transport_addr_v4,
            ctrl_port=neighbor.ctrl_port,
            rtt_us=neighbor.rtt_us,
            kvstore_port=neighbor.kvstore_port,
        )
        tr = _trace.TRACE
        if tr is not None:
            # a neighbor transition roots a shallow trace, finished right
            # after the push: downstream work shows up as the KvStore
            # publications it causes
            root = tr.root(
                "spark.neighbor_event",
                event=event_type.name,
                node=neighbor.node_name,
            )
            if root is not None:
                with tr.activate((root,)):
                    self._neighbor_updates_queue.push(event)
                tr.finish(root)
                return
        self._neighbor_updates_queue.push(event)

    # -- public API (reference: Spark.h:99-105) ------------------------------

    def flood_restarting_msg(self) -> None:
        """Announce our own graceful restart on all interfaces."""

        def _flood() -> None:
            self._restarting = True
            for if_name in self._interfaces:
                self.send_hello(if_name, restarting=True)

        self.run_in_event_base_thread(_flood).result()

    def get_neighbors(self) -> list[SparkNeighbor]:
        return self.run_in_event_base_thread(
            lambda: [
                n for by_if in self.neighbors.values() for n in by_if.values()
            ]
        ).result()

    def get_neigh_state(
        self, if_name: str, neighbor_name: str
    ) -> Optional[SparkNeighState]:
        return self.run_in_event_base_thread(
            lambda: (
                n.state
                if (n := self.neighbors.get(if_name, {}).get(neighbor_name))
                else None
            )
        ).result()
