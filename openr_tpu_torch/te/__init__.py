"""Differentiable traffic engineering on the fleet product.

Port of `openr_tpu.te`: link metrics become parameters, a smoothed
(softmin, temperature-annealed) float32 variant of the fleet min-plus
product feeds a traffic-matrix load model, and projected gradient
descent (torch.autograd) minimizes max-utilization on the device.
Rounded integer candidates are validated through the exact solver
(ops.allsources.reduced_all_sources, K1 on a banded topology) and only
an exactly-improving candidate is ever published.
"""

from .optimizer import (  # noqa: F401
    TE_COUNTER_KEYS,
    TeOptimizer,
    TeProblem,
    TeResult,
    hill_climb,
)
