"""Daemon layer for the device-unbucketed-dispatch fixture.

Mirrors tests/analysis_fixtures/unbucketed_daemon.py: outside
device_paths and engine_dispatch_paths, so every direct root call here
is a seeded violation; the plain-helper call and the rationale-
suppressed call stay silent.
"""

import functools

from . import unbucketed_ops as uops
from .unbucketed_ops import kernel_add, plain_helper


_adhoc_kernel = functools.partial(uops.kernel_scale, n=2)


def handle_query(a, b):
    out = kernel_add(a, b)
    return uops.kernel_scale(out, 2)


def handle_adhoc(a):
    return _adhoc_kernel(a)


def handle_host(a):
    return plain_helper(a)


def handle_pinned(a, b):
    # caller pins one shape for the process lifetime; measured faster than
    # engine dispatch and exempt from the engine by design
    # openr: disable=device-unbucketed-dispatch
    return kernel_add(a, b)
