"""Watchdog: module-thread liveness + memory guard.

Port of `openr_tpu.monitor.watchdog` (reference: Watchdog,
openr/watchdog/Watchdog.{h,cpp}:24-122): every module event base is
registered (`add_evb`, wired in startEventBase — Main.cpp:153); the
watchdog thread samples each module's heartbeat timestamp and the process
RSS, and fires a crash (os.abort for supervisor restart — or a callback in
tests) on thread stall or memory explosion.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional

from ..runtime.eventbase import OpenrEventBase
from .monitor import SystemMetrics

log = logging.getLogger(__name__)


class Watchdog:
    def __init__(
        self,
        *,
        interval_s: float = 20.0,
        thread_timeout_s: float = 300.0,
        max_memory_bytes: int = 800 * 1024 * 1024,
        on_crash: Optional[Callable[[str], None]] = None,
    ) -> None:
        self._interval_s = interval_s
        self._thread_timeout_s = thread_timeout_s
        self._max_memory_bytes = max_memory_bytes
        self._on_crash = on_crash
        self._evbs: list[OpenrEventBase] = []
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.fired: Optional[str] = None
        self.counters: dict[str, int] = {
            "watchdog.stall_events": 0,
            "watchdog.fired": 0,
        }

    def get_counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self.counters)

    def add_evb(self, evb: OpenrEventBase) -> None:
        """Reference: Watchdog::addEvb (Watchdog.h:32)."""
        with self._lock:
            self._evbs.append(evb)

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="watchdog")
        self._thread.daemon = True
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.wait(self._interval_s):
            self.check_once()

    def check_once(self) -> None:
        now = time.monotonic()
        with self._lock:
            evbs = list(self._evbs)
        # scan EVERY module before deciding: one wedged thread must not
        # mask another stall or the memory check (an early return here
        # previously skipped both)
        reasons: list[str] = []
        stalls = 0
        for evb in evbs:
            if not evb.is_running:
                continue
            stall = now - evb.get_timestamp()
            if stall > self._thread_timeout_s:
                stalls += 1
                reasons.append(f"thread {evb.name!r} stalled for {stall:.0f}s")
        rss = SystemMetrics.rss_bytes()
        if rss is not None and rss > self._max_memory_bytes:
            reasons.append(
                f"memory limit exceeded: rss={rss} > {self._max_memory_bytes}"
            )
        if stalls:
            with self._lock:
                self.counters["watchdog.stall_events"] += stalls
        if reasons:
            self._fire_crash("; ".join(reasons))

    def _fire_crash(self, reason: str) -> None:
        """Reference: Watchdog::fireCrash (Watchdog.cpp:110-122) — abort so
        the supervisor (systemd) restarts the daemon."""
        log.critical("watchdog: %s", reason)
        self.fired = reason
        with self._lock:
            self.counters["watchdog.fired"] += 1
        if self._on_crash is not None:
            self._on_crash(reason)
        else:
            os.abort()
