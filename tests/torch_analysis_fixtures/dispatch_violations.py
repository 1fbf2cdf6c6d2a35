"""Seeded dispatch-hygiene violations for the port's analyzer self-tests.

Mirrors tests/analysis_fixtures/jit_violations.py construct for construct;
its static-argument constructs have no counterpart (eager PyTorch has no
static arguments).  Parsed by openr_tpu_torch.analysis, never imported or
executed.  Line numbers are asserted exactly in tests/test_torch_analysis.py
— keep edits append-only or renumber the expectations.
"""

import numpy as np
import torch

from openr_tpu_torch.device.sanitizer import fetch, fetch_point, stage


def host_sync_in_root(x: torch.Tensor):
    y = torch.cumsum(x, 0)
    total = float(y[-1])  # line 18: device-host-sync (float on a device value)
    arr = np.asarray(y)  # line 19: device-host-sync (np.asarray on a device value)
    print(y)  # line 20: device-host-sync (print of a device value)
    y.item()  # line 21: device-host-sync (sync method)
    return total + arr.sum()


def tensor_branch(x: torch.Tensor):
    s = torch.sum(x)
    if s > 0:  # line 27: device-tensor-branch
        return s
    while s < 0:  # line 29: device-tensor-branch
        s = s + 1
    return -s


def host_arg_branch(x: torch.Tensor, flag: bool):
    # clean: branching on a host argument reads no device value
    if flag:
        return x + 1
    return x - 1


def _helper_reached_from_root(v):
    # device-valued via the call in device_caller below
    if v.sum() > 0:  # line 43: device-tensor-branch (interprocedural)
        return v
    return -v


def device_caller(x: torch.Tensor):
    return _helper_reached_from_root(x * 2)


def suppressed_sync(x: torch.Tensor):
    y = torch.sum(x)
    return float(y)  # deliberate fixture suppression  # openr: disable=device-host-sync


def dispatch_layer(x: np.ndarray):
    dist = device_caller(stage(x, torch.device("cpu")))
    if dist[0] > 0:  # line 59: device-dispatch-sync (branch on device value)
        return int(dist[1])  # line 60: device-dispatch-sync (int on device value)
    return 0


def dispatch_explicit_fetch(x: np.ndarray):
    # clean: one declared fetch, host branching on host values
    dist = fetch(device_caller(stage(x, torch.device("cpu"))), "fixture read")
    if dist[0] > 0:
        return int(dist[1])
    return 0


def clean_kernel(x: torch.Tensor, y: torch.Tensor):
    # clean: is-None checks, shape/dtype reads, torch.where and a read at a
    # declared fetch point
    if y is not None:
        x = x + y
    n = x.shape[0]
    if x.dtype == torch.int32:
        x = x * 2
    with fetch_point("fixture verdict"):
        done = bool((x < n).all())
    if done:
        return torch.where(x > n, x, n)
    return x
