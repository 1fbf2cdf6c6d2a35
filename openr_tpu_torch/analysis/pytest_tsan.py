"""pytest plugin arming the port's OPENR_TSAN detector.

``python -m openr_tpu_torch.analysis --races`` loads it with
``-p openr_tpu_torch.analysis.pytest_tsan`` in a subprocess whose
environment leaves ``OPENR_TSAN`` unset, so the reference's detector
(armed by the test suite's conftest under that variable) stays off and
the two never patch ``threading`` at once.  The detector is armed at
``pytest_configure``, before the test modules build their locks, queues
and modules; each test is failed, with both stacks, when its run left an
unsuppressed finding.
"""

from __future__ import annotations

import pytest

from . import race as _race


def pytest_configure(config) -> None:
    _race.enable()


def pytest_unconfigure(config) -> None:
    _race.disable()


@pytest.fixture(autouse=True)
def torch_tsan_guard():
    """Zero-unsuppressed-findings gate: drains stale findings before the
    test and fails the test whose run produced a race after it."""
    det = _race.TSAN
    if det is None:
        yield
        return
    det.drain()
    yield
    findings = det.drain()
    if findings:
        pytest.fail(_race.format_findings(findings), pytrace=False)
