"""Debounce / throttle primitives for batching bursty work.

Port of `openr_tpu.runtime.async_util`: the reference's AsyncDebounce
(openr/common/AsyncDebounce.h:27 — used by Decision to batch KvStore
publications before an SPF rebuild with min/max 10ms/250ms, openr/Main.cpp:526)
and AsyncThrottle (openr/common/AsyncThrottle.h:33).

Both are single-loop objects: call them only from the owning module's loop.
"""

from __future__ import annotations

import asyncio
from typing import Any, Callable, Optional


class AsyncDebounce:
    """Invoke -> callback fires after backoff_min; further invocations while
    pending double the wait (measured from the first invocation), capped at
    backoff_max.  A burst of updates thus coalesces into one callback no later
    than backoff_max after the burst began."""

    def __init__(
        self,
        backoff_min_s: float,
        backoff_max_s: float,
        callback: Callable[[], Any],
    ) -> None:
        if backoff_min_s <= 0 or backoff_max_s < backoff_min_s:
            raise ValueError("invalid debounce bounds")
        self._min = backoff_min_s
        self._max = backoff_max_s
        self._callback = callback
        self._handle: Optional[asyncio.TimerHandle] = None
        self._current_backoff = 0.0
        self._first_call_ts = 0.0

    def __call__(self) -> None:
        loop = asyncio.get_running_loop()
        now = loop.time()
        if self._handle is None:
            self._current_backoff = self._min
            self._first_call_ts = now
            self._handle = loop.call_at(now + self._min, self._fire)
        else:
            self._current_backoff = min(self._current_backoff * 2, self._max)
            deadline = self._first_call_ts + self._current_backoff
            # once capped, the deadline stops moving — don't churn the timer
            if deadline > now and deadline != self._handle.when():
                self._handle.cancel()
                self._handle = loop.call_at(deadline, self._fire)

    def _fire(self) -> None:
        self._handle = None
        self._current_backoff = 0.0
        self._callback()

    def is_scheduled(self) -> bool:
        return self._handle is not None

    def cancel(self) -> None:
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None
            self._current_backoff = 0.0


class AsyncThrottle:
    """Invoke -> callback fires after `timeout`; invocations while pending are
    absorbed into that single firing (reference: AsyncThrottle.h:33)."""

    def __init__(self, timeout_s: float, callback: Callable[[], Any]) -> None:
        self._timeout = timeout_s
        self._callback = callback
        self._handle: Optional[asyncio.TimerHandle] = None

    def __call__(self) -> None:
        if self._handle is not None:
            return
        loop = asyncio.get_running_loop()
        if self._timeout <= 0:
            self._callback()
            return
        self._handle = loop.call_later(self._timeout, self._fire)

    def _fire(self) -> None:
        self._handle = None
        self._callback()

    def is_active(self) -> bool:
        return self._handle is not None

    def cancel(self) -> None:
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None
