"""Device engine: the resolved device and dispatch accounting.

Minimal counterpart of `openr_tpu.device.engine.DeviceResidencyEngine`:
it holds the device the port computes on, stages a view's reversed
runner arrays once, and counts dispatches and kernel launches.  The
reference engine's masked incremental sync, rewire replay, S-bucket
program cache, snapshots and chaos seams come in later slices.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

from ..ops import epilogue as _epilogue

ENGINE_COUNTER_KEYS = (
    "device.engine.dispatches",
    "device.engine.kernel_launches",
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

    def stage(self, runner) -> None:
        """Pin a runner's tables and runtime arrays on this device."""
        runner.stage(self.device)

    def dispatch(self, op: str, fn: Callable, *args, **kwargs):
        """Run one unit of device work (`op` names it) and count it."""
        self.counters["device.engine.dispatches"] += 1
        return fn(*args, **kwargs)

    def epilogue(self, d, idx, w, ov, slot, n_words: int):
        """ops.epilogue.fused_epilogue, counting the kernel launches."""
        before = _epilogue.fused_epilogue.launches
        out = _epilogue.fused_epilogue(d, idx, w, ov, slot, n_words)
        self.counters["device.engine.kernel_launches"] += (
            _epilogue.fused_epilogue.launches - before
        )
        return out

