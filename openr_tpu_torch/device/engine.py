"""Device engine: the resolved device and dispatch accounting.

Minimal counterpart of `openr_tpu.device.engine.DeviceResidencyEngine`:
it holds the device the port computes on, stages a view's reversed
runner arrays once, owns the blocked APSP rung (`blocked`), and counts
dispatches and kernel launches, in all and per kernel, and the ELL
relax sweeps and affected-set passes the fleet view runs.  The reference
engine's masked incremental sync, rewire replay, S-bucket program
cache, snapshots and chaos seams come in later slices.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

from ..ops import blocked_outer as _outer
from ..ops import epilogue as _epilogue
from ..parallel.blocked import BlockedApspEngine

KERNELS = ("fused_epilogue", "blocked_outer")

ENGINE_COUNTER_KEYS = (
    "device.engine.dispatches",
    "device.engine.kernel_launches",
    *(f"device.engine.kernel_launches.{name}" for name in KERNELS),
    # plain-PyTorch device work that shows which path a view took: ELL
    # relax sweeps (verification sweeps and hint probes included) and
    # affected-set passes of worsening warm starts
    "device.engine.ell_sweeps",
    "device.engine.affected_passes",
)


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """`device`, or the CUDA card when None.  Raises when CUDA is asked
    for (explicitly or by default) and not available: the port never
    drops to the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to compute on the CPU"
        )
    return dev


class DeviceResidencyEngine:
    def __init__(self, device: Union[str, torch.device, None] = None) -> None:
        self.device = resolve_device(device)
        self.counters = {k: 0 for k in ENGINE_COUNTER_KEYS}
        # third dispatch rung (delta < fused full < blocked); it reads
        # this engine's device and launches phase 3 through
        # `blocked_outer` below
        self.blocked = BlockedApspEngine(parent=self)

    def stage(self, runner) -> None:
        """Pin a runner's tables and runtime arrays on this device."""
        runner.stage(self.device)

    def dispatch(self, op: str, fn: Callable, *args, **kwargs):
        """Run one unit of device work (`op` names it) and count it."""
        self.counters["device.engine.dispatches"] += 1
        return fn(*args, **kwargs)

    def _launch(self, name: str, kernel: Callable, *args):
        """Call a kernel wrapper and count the launches it made."""
        before = kernel.launches
        out = kernel(*args)
        launched = kernel.launches - before
        self.counters["device.engine.kernel_launches"] += launched
        self.counters[f"device.engine.kernel_launches.{name}"] += launched
        return out

    def epilogue(self, d, idx, w, ov, slot, n_words: int):
        """ops.epilogue.fused_epilogue, counting the kernel launches."""
        return self._launch(
            "fused_epilogue",
            _epilogue.fused_epilogue,
            d, idx, w, ov, slot, n_words,
        )

    def blocked_outer(self, dist, row_p, col_p, node_overloaded, k: int):
        """ops.blocked_outer.blocked_outer, counting the kernel launches."""
        return self._launch(
            "blocked_outer",
            _outer.blocked_outer,
            dist, row_p, col_p, node_overloaded, k,
        )

