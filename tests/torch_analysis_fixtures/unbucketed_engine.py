"""Sanctioned dispatch front-end for the device-unbucketed-dispatch
fixture.

Mirrors tests/analysis_fixtures/unbucketed_engine.py: listed under
engine_dispatch_paths in the test config, its direct root calls model
the device engine and must not be flagged.
"""

from .unbucketed_ops import kernel_add


def engine_dispatch(a, b):
    return kernel_add(a, b)
