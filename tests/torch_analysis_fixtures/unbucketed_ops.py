"""Kernel layer for the device-unbucketed-dispatch fixture (in
device_paths).

Mirrors tests/analysis_fixtures/unbucketed_ops.py: device roots the
daemon fixture calls directly, kept free of other dispatch-hygiene
violations so the rule assertions stay exact.
"""

import torch


def kernel_add(a: torch.Tensor, b: torch.Tensor):
    return a + b


def kernel_scale(a: torch.Tensor, n: int):
    return a * n


def plain_helper(a: list) -> list:
    return a
