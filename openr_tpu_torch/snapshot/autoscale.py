"""Counter-driven elastic autoscaling for the serving fleet.

Port of `openr_tpu.snapshot.autoscale`, line for line: host code with
no device work.

The policy is deliberately simple and deterministic: `observe()` is a
pure function of the counter deltas since the previous observation plus
the current admission-queue depth, so it unit-tests without a fleet and
never introduces schedule nondeterminism of its own.  It reads only
surfaces the fleet already exports — the router's ``serving.router.*``
family and the admission RWQueue depth — and returns a decision; the
caller (``ServingFleet.autoscale_step``) applies it through
``ServingFleet.scale``, which owns the snapshot warm-start and the
``snapshot.scaleouts`` / ``snapshot.scaleins`` accounting.

Scale-out pressure is either signal of saturation: router sheds since
the last observation (queries that never got a first dispatch), or the
admission queue standing deeper than ``depth_high``.  Scale-in needs
``idle_intervals`` consecutive quiet observations (dispatch delta at or
below ``idle_dispatches``) — a single quiet tick is noise, not idleness.
Every scaling action arms a ``cooldown`` of observations so the policy
never flaps faster than replicas can join or leave.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class AutoscaleDecision:
    action: str  # "scale_out" | "scale_in" | "hold"
    target_k: int
    reason: str


class AutoscalePolicy:
    def __init__(
        self,
        *,
        min_replicas: int = 1,
        max_replicas: int = 4,
        shed_high: int = 1,
        depth_high: int = 64,
        idle_dispatches: int = 0,
        idle_intervals: int = 3,
        cooldown: int = 2,
    ) -> None:
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.shed_high = int(shed_high)
        self.depth_high = int(depth_high)
        self.idle_dispatches = int(idle_dispatches)
        self.idle_intervals = int(idle_intervals)
        self.cooldown = int(cooldown)
        self._last_sheds = 0
        self._last_dispatches = 0
        self._idle_streak = 0
        self._cooldown_left = 0

    def observe(
        self, k: int, counters: dict, admission_depth: int = 0
    ) -> AutoscaleDecision:
        """One policy tick over a `ReplicaRouter.get_counters()` snapshot
        (cumulative — the policy differences it internally) and the
        current admission-queue depth."""
        sheds = int(counters.get("serving.router.sheds", 0))
        dispatches = int(counters.get("serving.router.dispatches", 0))
        d_sheds = sheds - self._last_sheds
        d_dispatches = dispatches - self._last_dispatches
        self._last_sheds = sheds
        self._last_dispatches = dispatches

        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            return AutoscaleDecision("hold", k, "cooldown")

        pressed = d_sheds >= self.shed_high or (
            admission_depth >= self.depth_high
        )
        if pressed:
            self._idle_streak = 0
            if k < self.max_replicas:
                self._cooldown_left = self.cooldown
                why = (
                    f"sheds+{d_sheds}"
                    if d_sheds >= self.shed_high
                    else f"admission_depth={admission_depth}"
                )
                return AutoscaleDecision("scale_out", k + 1, why)
            return AutoscaleDecision("hold", k, "at max_replicas")

        if d_dispatches <= self.idle_dispatches:
            self._idle_streak += 1
            if self._idle_streak >= self.idle_intervals:
                self._idle_streak = 0
                if k > self.min_replicas:
                    self._cooldown_left = self.cooldown
                    return AutoscaleDecision(
                        "scale_in", k - 1, "idle intervals"
                    )
                return AutoscaleDecision("hold", k, "at min_replicas")
            return AutoscaleDecision("hold", k, "idle, streak building")

        self._idle_streak = 0
        return AutoscaleDecision("hold", k, "steady")
