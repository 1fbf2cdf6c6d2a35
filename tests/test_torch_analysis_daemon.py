"""The analysis layer's seams in the port's daemon (`openr_tpu_torch.main`),
on the CPU.

Oracles: tests/test_ctrl_config_monitor.py::TestCounterRegistrySweep::
test_sched_family_on_both_wire_surfaces (the whole `sched.*` family on
one getCounters of the ctrl server and of the Thrift shim, before any
exploration) and the reference's `OpenrDaemon.__init__`, which arms the
race detector under `OPENR_TSAN=1` before any module object exists.  A
daemon built armed runs, answers and stops with no unsuppressed race; a
daemon built under the gate while the reference's detector is armed
leaves the port's off.
"""

from __future__ import annotations

import _thread
import logging
import re
import threading

import pytest
from test_torch_serving_fleet import _thrift_counters

from openr_tpu.analysis import race as j_race
from openr_tpu_torch.analysis import race
from openr_tpu_torch.analysis.sched import SCHED_COUNTER_KEYS, SchedCounters
from openr_tpu_torch.main import OpenrDaemon, fleet_node_config
from openr_tpu_torch.runtime.eventbase import OpenrEventBase

pytestmark = pytest.mark.analysis

# cases that arm and disarm detectors cannot run inside a suite that holds
# the reference's armed for its whole run (OPENR_TSAN=1)
_REFERENCE_ARMED = pytest.mark.skipif(
    j_race.TSAN is not None,
    reason="the suite runs under OPENR_TSAN=1 with the reference's detector armed",
)


def _solo(name: str) -> OpenrDaemon:
    from openr_tpu_torch.spark import MockIoProvider

    cfg = fleet_node_config(name)
    cfg.thrift_shim_port = -1
    return OpenrDaemon(cfg, io_provider=MockIoProvider().endpoint(name), device="cpu")


def _wire_counters(d: OpenrDaemon) -> tuple:
    from openr_tpu_torch.ctrl import CtrlClient

    with CtrlClient("::1", d.ctrl_port) as client:
        ctrl = client.call("getCounters")
    return ctrl, _thrift_counters(d.thrift_shim.port)


def test_sched_family_on_both_wire_surfaces():
    family = set(SCHED_COUNTER_KEYS)
    assert family == {
        "sched.schedules_explored", "sched.dpor_prunes", "sched.replays",
        "sched.shrinks", "sched.planted_finds",
    }
    name_re = re.compile(r"[a-z][a-z0-9_]*(\.[a-z0-9_]+)+\Z")
    assert all(name_re.match(k) for k in family)
    assert SchedCounters().get_counters() == {k: 0 for k in family}
    d = _solo("sched-0")
    d.start()
    try:
        native, shimmed = _wire_counters(d)
    finally:
        d.stop()
    assert family <= set(native) and family <= set(shimmed)
    # the family round-trips the strict-binary i64 map intact
    assert all(shimmed[k] == native[k] for k in family)


@_REFERENCE_ARMED
def test_daemon_arms_the_ports_detector_under_the_gate(monkeypatch):
    """`OpenrDaemon.__init__` arms the port's detector (never the
    reference's) before it builds a module, so every module lock is a
    proxy and every module is tracked; the armed daemon starts, answers
    both wires and stops with no unsuppressed race."""
    assert race.TSAN is None
    monkeypatch.setattr(race, "_ENV_ARMED", True)
    try:
        d = _solo("tsan-0")
        det = race.TSAN
        assert det is not None and j_race.TSAN is None
        assert "__setattr__" in OpenrEventBase.__dict__
        assert isinstance(d.kvstore._stop_once, race.TsanLock)
        det.drain()
        d.start()
        try:
            native, shimmed = _wire_counters(d)
        finally:
            d.stop()
        findings = det.drain()
        assert not findings, race.format_findings(findings)
        stats = det.stats()
        assert stats["accesses"] > 0 and stats["tokens"] > 0
        assert set(SCHED_COUNTER_KEYS) <= set(native) and set(SCHED_COUNTER_KEYS) <= set(shimmed)
    finally:
        race.disable()
    assert race.TSAN is None and "__setattr__" not in OpenrEventBase.__dict__


@_REFERENCE_ARMED
def test_daemon_leaves_the_ports_detector_off_beside_the_references(monkeypatch, caplog):
    """Under the gate, a daemon built while the reference's detector holds
    `threading`'s patches logs an error and leaves the port's off: its
    locks are the reference's proxies, no port class is tracked, and the
    reference's detector is still the one armed."""
    monkeypatch.setattr(race, "_ENV_ARMED", True)
    j_race.enable(tracked_paths=[])
    try:
        with caplog.at_level(logging.ERROR, logger=race.__name__):
            d = _solo("beside-0")
        try:
            assert race.TSAN is None and j_race.TSAN is not None
            assert threading.Lock is j_race.TsanLock
            assert isinstance(d.kvstore._stop_once, j_race.TsanLock)
            assert "__setattr__" not in OpenrEventBase.__dict__
        finally:
            d.config_store.close()
        assert any("stays off" in r.getMessage() for r in caplog.records)
    finally:
        j_race.disable()
    assert race.TSAN is None and threading.Lock is _thread.allocate_lock


def test_daemon_leaves_the_detector_off_without_the_gate(monkeypatch):
    monkeypatch.setattr(race, "_ENV_ARMED", False)
    d = _solo("plain-0")
    try:
        assert race.TSAN is None
        assert type(d.kvstore._stop_once) is not race.TsanLock
    finally:
        d.config_store.close()
