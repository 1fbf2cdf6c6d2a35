"""The port's runtime dispatch sanitizer
(`openr_tpu_torch.device.sanitizer`), on the CPU.

Oracle: tests/test_sanitizer.py, class for class, on the same warm
fixture (a 16-node grid, the engine warmed on the 1- and 8-source
buckets, one attribute flap pending so the sanitized query runs the
incremental indexed write).  Each property is proven in both directions:

- the engine's real dispatch paths are clean under the guard, with the
  results equal to the host Dijkstra's, and the fetch points they pass
  are counted by name;
- the guard catches a seeded host->device violation: with the engine's
  explicit staging (`_put`) patched to hand the host array over as it is,
  the same query consumes host data outside the staging and the block
  fails.  On the CPU "device" is the host, so the guard tells host data
  by where it came from (`aten.lift_fresh`), not by a device mismatch;
- it catches a seeded device->host sync (an `.item()` outside a fetch
  point) and lets a declared fetch point through;
- after warmup, steady-state queries stay within a zero-new-key budget,
  and a query that lands on a new ladder key (9 sources -> the 64
  bucket) inside the block is caught.

The dispatch-mode stack is per thread: a guard sees only its own
thread's work, and it composes with the port's armed race detector.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from openr_tpu_torch.decision.csr import CsrTopology
from openr_tpu_torch.decision.link_state import LinkState
from openr_tpu_torch.device import EngineSanitizer, SanitizerViolation
from openr_tpu_torch.device import sanitizer as san_mod
from openr_tpu_torch.device.engine import DeviceResidencyEngine
from openr_tpu_torch.utils.topo import grid_topology


def _build(dbs) -> LinkState:
    ls = LinkState()
    for db in dbs:
        ls.update_adjacency_database(db)
    return ls


@pytest.fixture()
def warm():
    """Engine warmed on the 1- and 8-source buckets of a 16-node grid,
    with one attribute flap pending so the sanitized query exercises the
    incremental indexed write (the dispatch path with the most
    host->device traffic)."""
    dbs = grid_topology(4)
    ls = _build(dbs)
    csr = CsrTopology.from_link_state(ls)
    engine = DeviceResidencyEngine("cpu")
    names = ls.node_names
    engine.spf_results(csr, names[:1])  # ladder key of bucket 1
    engine.spf_results(csr, names[:3])  # ladder key of bucket 8
    # pending attribute flap: the metric write lands at the next query
    dbs[0].adjacencies[0].metric = 37
    ls.update_adjacency_database(dbs[0])
    assert csr.refresh(ls) is True
    return engine, csr, ls, names


def _oracle_check(engine, csr, ls, sources):
    got = engine.spf_results(csr, sources)
    for src in sources:
        oracle = ls.run_spf(src)
        assert {k: v.metric for k, v in oracle.items()} == {
            k: v.metric for k, v in got[src].items()
        }, src


def ls_max_metric(csr) -> int:
    return int(csr.edge_metric[: csr.n_edges].max())


class TestTransferGuard:
    def test_real_dispatch_paths_are_clean(self, warm):
        """Incremental sync + warm queries under the guard, equal to the
        host Dijkstra's; the verdict and result reads are counted."""
        engine, csr, ls, names = warm
        san = EngineSanitizer(engine)
        with san.sanitized():
            _oracle_check(engine, csr, ls, names[:1])  # syncs the flap
            _oracle_check(engine, csr, ls, names[:3])
        c = engine.get_counters()
        assert c["device.engine.incremental_updates"] == 1
        assert san.last["ops"] > 0
        assert san.last["fetches"]["forward verdict"] >= 2
        assert san.last["fetches"]["forward result"] == 6

    def test_seeded_h2d_violation_is_caught(self, warm, monkeypatch):
        """Drop the explicit staging (the seeded bug: `_put` hands the
        host array over as it is): the same dispatch now feeds host data
        into the indexed write and the forward, and the guard must fail
        the block."""
        import openr_tpu_torch.device.engine as engine_mod

        engine, csr, ls, names = warm
        san = EngineSanitizer(engine)
        monkeypatch.setattr(
            engine_mod, "_put",
            lambda a, device: torch.from_numpy(np.ascontiguousarray(a)),
        )
        with pytest.raises(SanitizerViolation, match="implicit host->device"):
            with san.transfer_guard():
                engine.spf_results(csr, names[:1])

    def test_unrelated_errors_pass_through(self, warm):
        """Only guard trips translate; other failures keep their type."""
        engine, *_ = warm
        san = EngineSanitizer(engine)
        with pytest.raises(ValueError, match="unrelated"):
            with san.transfer_guard():
                raise ValueError("unrelated")

    def test_seeded_d2h_violation_is_caught(self, warm):
        """An `.item()` on a device value outside a fetch point fails the
        block, even when the caller swallows the exception."""
        engine, csr, ls, names = warm
        res = engine.sync(csr)
        san = EngineSanitizer(engine)
        with pytest.raises(SanitizerViolation, match="implicit device->host"):
            with san.transfer_guard():
                res.edge_metric.max().item()
        with pytest.raises(SanitizerViolation, match="implicit device->host"):
            with san.transfer_guard():
                try:
                    bool((res.edge_up == 0).any())
                except Exception:
                    pass

    def test_declared_fetch_point_passes(self, warm):
        engine, csr, ls, names = warm
        res = engine.sync(csr)
        san = EngineSanitizer(engine)
        with san.transfer_guard():
            top = san_mod.fetch(res.edge_metric.max(), "seeded read")
            with san_mod.fetch_point("seeded flag"):
                any_down = bool((res.edge_metric < 0).any())
        assert int(top) == ls_max_metric(csr) and any_down is False
        assert san.last["fetches"] == {"seeded read": 1, "seeded flag": 1}


class TestCompileBudget:
    def test_steady_state_is_hit_only(self, warm):
        engine, csr, ls, names = warm
        san = EngineSanitizer(engine)
        with san.compile_budget(0):
            engine.spf_results(csr, names[:1])
            engine.spf_results(csr, names[:2])  # same 8-bucket, still a hit

    def test_seeded_new_bucket_compile_is_caught(self, warm):
        """A steady-state block that silently crosses into a bucket not
        run before (here: 9 sources -> the 64 bucket) must fail the
        budget."""
        engine, csr, ls, names = warm
        san = EngineSanitizer(engine)
        with pytest.raises(SanitizerViolation, match="ran 1 new ladder key"):
            with san.compile_budget(0):
                engine.spf_results(csr, names[:9])

    def test_budget_allows_declared_compiles(self, warm):
        engine, csr, ls, names = warm
        san = EngineSanitizer(engine)
        with san.compile_budget(1):
            engine.spf_results(csr, names[:9])


class TestWiredIntoDispatch:
    def test_sanitized_composes_guard_and_budget(self, warm):
        engine, csr, ls, names = warm
        san = EngineSanitizer(engine)
        with pytest.raises(SanitizerViolation):
            with san.sanitized(allowed_compiles=0):
                engine.spf_results(csr, names[:9])
        # host reads of fetched results stay allowed: the query's own
        # fetch points already copied them to the host
        res = engine.spf_results(csr, names[:1])
        with san.transfer_guard():
            arr = np.asarray(
                [r.metric for r in res[names[0]].values()], dtype=np.int64
            )
        assert arr.size > 0


class TestThreads:
    def test_guard_sees_only_its_own_thread(self, warm):
        """A sync on another thread while this thread's guard is armed is
        that thread's business: the dispatch-mode stack is per thread."""
        engine, csr, ls, names = warm
        res = engine.sync(csr)
        san = EngineSanitizer(engine)
        out = []
        with san.transfer_guard():
            t = threading.Thread(target=lambda: out.append(res.edge_metric.max().item()))
            t.start()
            t.join()
        assert out == [ls_max_metric(csr)]

    def test_composes_with_the_armed_race_detector(self):
        """An armed OPENR_TSAN detector and a guarded block compose: the
        detector's patched threading and the guard's dispatch mode stay
        out of each other's way, and the queries stay clean."""
        from openr_tpu.analysis import race as j_race
        from openr_tpu_torch.analysis import race

        if j_race.TSAN is not None:
            pytest.skip("the suite runs under OPENR_TSAN=1 with the reference's detector armed")
        det = race.enable()
        try:
            dbs = grid_topology(4)
            ls = _build(dbs)
            csr = CsrTopology.from_link_state(ls)
            engine = DeviceResidencyEngine("cpu")
            names = ls.node_names
            engine.spf_results(csr, names[:3])
            dbs[5].adjacencies[0].metric = 41
            ls.update_adjacency_database(dbs[5])
            assert csr.refresh(ls) is True
            san = EngineSanitizer(engine)
            with san.sanitized():
                _oracle_check(engine, csr, ls, names[:3])
            det.drain()
            assert det.stats()["findings"] == 0
        finally:
            race.disable()
