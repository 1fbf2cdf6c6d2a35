"""Monitor: event-log sink + process counters.

Port of `openr_tpu.monitor.monitor` (reference: Monitor,
openr/monitor/Monitor.h:17, MonitorBase.h:32, SystemMetrics.h:23,
LogSample.h:43): consumes the LogSample queue, keeps a bounded recent-event
ring, exports process counters (uptime, RSS, CPU time).
"""

from __future__ import annotations

import json
import logging
import os
import resource
import time
from collections import deque
from typing import Any, Optional

from ..runtime.eventbase import OpenrEventBase
from ..runtime.queue import QueueClosedError, RQueue

log = logging.getLogger(__name__)

MAX_LOG_EVENTS = 100  # reference: MonitorBase maxLogEvents


class LogSample:
    """Structured JSON event builder (reference: LogSample.h:43)."""

    def __init__(self, **values: Any) -> None:
        self.values: dict[str, Any] = {"time": int(time.time()), **values}

    def add(self, key: str, value: Any) -> "LogSample":
        self.values[key] = value
        return self

    def to_json(self) -> str:
        return json.dumps(self.values, sort_keys=True)


class SystemMetrics:
    """RSS / CPU from rusage (reference: SystemMetrics.h:23-41)."""

    @staticmethod
    def rss_bytes() -> Optional[int]:
        try:
            with open(f"/proc/{os.getpid()}/statm") as f:
                pages = int(f.read().split()[1])
            return pages * os.sysconf("SC_PAGE_SIZE")
        except (OSError, ValueError, IndexError):
            ru = resource.getrusage(resource.RUSAGE_SELF)
            return ru.ru_maxrss * 1024 if ru.ru_maxrss else None

    @staticmethod
    def cpu_seconds() -> float:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return ru.ru_utime + ru.ru_stime


class Monitor(OpenrEventBase):
    def __init__(
        self,
        node_name: str,
        log_sample_queue: RQueue,
        *,
        counter_interval_s: float = 10.0,
        syslog: bool = False,
    ) -> None:
        super().__init__(name=f"monitor-{node_name}")
        self.node_name = node_name
        self._log_samples = log_sample_queue
        self._counter_interval_s = counter_interval_s
        self._syslog = syslog
        self._start_time = time.time()
        self.recent_events: deque = deque(maxlen=MAX_LOG_EVENTS)
        self._process_counters: dict[str, int] = {}

    def run(self) -> None:
        super().run()
        self.wait_until_running()
        self.run_in_event_base_thread(self._setup).result()

    def _setup(self) -> None:
        self.add_fiber_task(self._log_fiber(), name="logSamples")
        self._update_counters()

    async def _log_fiber(self) -> None:
        while True:
            try:
                sample = await self._log_samples.aget()
            except QueueClosedError:
                return
            self.process_event_log(sample)

    def process_event_log(self, sample: Any) -> None:
        """Reference: MonitorBase::processEventLog — record + syslog."""
        if isinstance(sample, LogSample):
            rendered = sample.to_json()
        elif isinstance(sample, dict):
            rendered = json.dumps(sample, sort_keys=True, default=str)
        else:
            rendered = str(sample)
        self.recent_events.append(rendered)
        if self._syslog:
            log.info("event-log: %s", rendered)

    def _update_counters(self) -> None:
        """Reference: Monitor periodic process counters."""
        self._process_counters["monitor.uptime_s"] = int(
            time.time() - self._start_time
        )
        rss = SystemMetrics.rss_bytes()
        if rss is not None:
            self._process_counters["monitor.process_rss_bytes"] = rss
        self._process_counters["monitor.process_cpu_ms"] = int(
            SystemMetrics.cpu_seconds() * 1000
        )
        self.schedule_timeout(self._counter_interval_s, self._update_counters)

    def get_counters(self) -> dict[str, int]:
        return dict(self._process_counters)

    def get_event_logs(self) -> list[str]:
        return self.run_in_event_base_thread(
            lambda: list(self.recent_events)
        ).result()
