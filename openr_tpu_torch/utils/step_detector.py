"""Step detection over a noisy time series (port of
`openr_tpu.utils.step_detector`; reference:
openr/common/StepDetector.h:39 — used by Spark to detect significant RTT
changes and emit NEIGHBOR_RTT_CHANGE only on real steps, not jitter).

Two-window mean comparison: the slow window holds the established baseline,
the fast window tracks recent samples.  A step is reported when the fast mean
deviates from the slow mean by more than abs_threshold AND the applicable
percentage threshold; the slow window is then re-seeded from the fast window
so the baseline re-converges at the new level.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Deque, Optional


class StepDetector:
    def __init__(
        self,
        fast_window_size: int = 10,
        slow_window_size: int = 60,
        lower_threshold_pct: float = 0.4,
        upper_threshold_pct: float = 0.6,
        abs_threshold: float = 500.0,
        on_step: Optional[Callable[[float], None]] = None,
    ) -> None:
        if fast_window_size <= 0 or slow_window_size < fast_window_size:
            raise ValueError("invalid window sizes")
        self._fast: Deque[float] = deque(maxlen=fast_window_size)
        self._slow: Deque[float] = deque(maxlen=slow_window_size)
        self._lower_pct = lower_threshold_pct
        self._upper_pct = upper_threshold_pct
        self._abs = abs_threshold
        self._on_step = on_step

    @property
    def baseline(self) -> Optional[float]:
        if not self._slow:
            return None
        return sum(self._slow) / len(self._slow)

    def add_value(self, sample: float) -> bool:
        """Feed one sample; returns True when a step was detected."""
        self._fast.append(sample)
        if len(self._fast) < self._fast.maxlen or not self._slow:
            # warm-up: seed the slow window once the fast window fills
            self._slow.append(sample)
            return False
        baseline = self.baseline
        fast_mean = sum(self._fast) / len(self._fast)
        diff = abs(fast_mean - baseline)
        pct = diff / baseline if baseline > 0 else float("inf")
        threshold_pct = self._upper_pct if fast_mean > baseline else self._lower_pct
        if diff >= self._abs and pct >= threshold_pct:
            self._slow.clear()
            self._slow.extend(self._fast)
            if self._on_step is not None:
                self._on_step(fast_mean)
            return True
        self._slow.append(sample)
        return False
