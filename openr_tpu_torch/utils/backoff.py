"""Exponential backoff (reference: openr/common/ExponentialBackoff.{h,cpp}:22).

Port of `openr_tpu.utils.backoff`: starts at `initial` on the first
error, doubles on each further error up to `max`; report_success()
resets.  With `is_abort_at_max`, an error while already at max raises
(the reference aborts the process there so its supervisor restarts it).
"""

from __future__ import annotations

import time


class MaxBackoffAbortError(RuntimeError):
    """report_error() at max backoff with is_abort_at_max set."""


class ExponentialBackoff:
    def __init__(
        self,
        initial_backoff_s: float,
        max_backoff_s: float,
        is_abort_at_max: bool = False,
        clock=time.monotonic,
    ) -> None:
        if initial_backoff_s <= 0 or max_backoff_s < initial_backoff_s:
            raise ValueError("invalid backoff bounds")
        self._initial = initial_backoff_s
        self._max = max_backoff_s
        self._is_abort_at_max = is_abort_at_max
        self._clock = clock
        self._current = 0.0
        self._last_error_time = float("-inf")

    def report_success(self) -> None:
        self._last_error_time = float("-inf")
        self._current = 0.0

    def report_error(self) -> None:
        if self._current >= self._max and self._is_abort_at_max:
            raise MaxBackoffAbortError(
                f"max backoff {self._max}s reached with abort-at-max set"
            )
        self._last_error_time = self._clock()
        if self._current == 0.0:
            self._current = self._initial
        else:
            self._current = min(self._current * 2, self._max)

    def can_try_now(self) -> bool:
        return self.get_time_remaining_until_retry() <= 0

    def get_time_remaining_until_retry(self) -> float:
        return max(0.0, (self._last_error_time + self._current) - self._clock())

    def at_max_backoff(self) -> bool:
        return self._current >= self._max

    def get_current_backoff(self) -> float:
        return self._current
