"""The port's per-source SPF engine against openr_tpu's.

`ops.sssp.spf_forward_full` (distances, SP-DAG, bit-packed first hops,
verdict) equals the reference's at a fixed sweep count, and
`DeviceResidencyEngine.spf_results` returns the reference engine's
SpfResults (metrics, ordered path links, next hops) with the same
learned sweep hints and residency counters: across the S-bucket edges,
on grids, rings with chords, fat-trees, WANs and a hub whose out-slots
reach the int32 sign bit, through tests/test_device_engine.py's 25-flap
sequence and its rewire schedules, and with a pinned epoch.  Everything
is integer, so everything is compared bit for bit.
"""

from __future__ import annotations

import gc

import numpy as np
import pytest
import torch

from openr_tpu.decision.csr import CsrTopology as JCsr
from openr_tpu.device.engine import DeviceResidencyEngine as JEngine
from openr_tpu.device.engine import EpochMismatchError as JEpochMismatchError
from openr_tpu.ops import sssp as jops
from openr_tpu_torch.decision.csr import CsrTopology
from openr_tpu_torch.device.engine import (
    S_BUCKETS,
    DeviceResidencyEngine,
    EpochMismatchError,
    _s_bucket,
)
from openr_tpu_torch.ops import sssp as ops
from openr_tpu_torch.utils import topo

from test_torch_csr_refresh import ring_dbs, rewire_schedule
from torch_parity import LinkStatePair, spf_key

FAMILIES = {
    "grid6": lambda: topo.grid_topology(6),
    "ring_chords": lambda: ring_dbs({(0, 5), (2, 8), (3, 9), (4, 10)}),
    "fat_tree2": lambda: topo.fat_tree_topology(2),
    "wan96": lambda: topo.wan_topology(96, chords=2, seed=3),
    # seed 2: first hops through out-slot 31 (the sign bit) and slot 32
    "hub": lambda: topo.hub_topology(seed=2),
}
RESIDENCY_KEYS = (
    "device.engine.full_restages",
    "device.engine.incremental_updates",
    "device.engine.queries",
    "device.engine.rewires",
    "device.engine.rewire_dispatches",
    "device.engine.rewire_slots",
    "device.engine.rewire_rows",
    "device.engine.rewire_fallbacks",
    "device.engine.epoch_invalidations",
)


class Engines:
    """Both packages' mirror and engine over the same LinkState pair."""

    def __init__(self, dbs) -> None:
        self.pair = LinkStatePair(dbs)
        self.ls = self.pair.ls
        self.csr = CsrTopology.from_link_state(self.pair.ls)
        self.jcsr = JCsr.from_link_state(self.pair.jls)
        self.engine = DeviceResidencyEngine("cpu")
        self.jengine = JEngine()

    def refresh(self, *dbs) -> bool:
        self.pair.update(*dbs)
        kept = self.csr.refresh(self.pair.ls)
        assert self.jcsr.refresh(self.pair.jls) is kept
        return kept

    def query(self, sources, oracle: bool = True, **kwargs) -> dict:
        """Both engines' results of `sources`, held equal (and equal to
        the host Dijkstra's when `oracle`), with equal learned hints and
        residency counters."""
        got = self.engine.spf_results(self.csr, sources, **kwargs)
        want = self.jengine.spf_results(self.jcsr, sources, **kwargs)
        assert set(got) == set(want) == set(sources)
        for src in sources:
            assert spf_key(got[src]) == spf_key(want[src]), src
            if oracle:
                host = self.ls.run_spf(
                    src, kwargs.get("use_link_metric", True)
                )
                assert spf_key(got[src]) == spf_key(host), src
        assert self.hint() == (
            self.jengine._residents[id(self.jcsr)].sweep_hint
        )
        assert self.csr._sweep_hint == self.jcsr._sweep_hint
        self.assert_counters()
        return got

    def hint(self) -> int:
        return self.engine._residents[id(self.csr)].sweep_hint

    def assert_counters(self) -> None:
        mine, theirs = self.engine.get_counters(), self.jengine.get_counters()
        assert {k: mine[k] for k in RESIDENCY_KEYS} == {
            k: theirs[k] for k in RESIDENCY_KEYS
        }


def _forward_inputs(name):
    e = Engines(FAMILIES[name]())
    res = e.engine.sync(e.csr)
    n_words = max(1, -(-e.csr.max_out_slots // 32))
    return e, res, n_words


@pytest.mark.parametrize("n_sweeps", [2, 24])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_forward_full_equals_reference(name, n_sweeps):
    e, res, n_words = _forward_inputs(name)
    names = e.ls.node_names
    src_ids = np.asarray(
        [e.csr.node_id[n] for n in names[:: max(1, len(names) // 8)][:8]],
        dtype=np.int32,
    )
    dist, dag, nh, ok = ops.spf_forward_full(
        torch.from_numpy(src_ids), res.ell, res.edge_src, res.edge_dst,
        res.edge_metric, res.edge_up, res.node_overloaded, res.out_slot,
        n_words, n_sweeps,
    )
    j = e.jcsr
    jdist, jdag, jnh, jok = jops.spf_forward_full(
        src_ids, j.ell, j.edge_src, j.edge_dst, j.edge_metric, j.edge_up,
        j.node_overloaded, j.out_slot, n_words, n_sweeps=n_sweeps,
    )
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jdist))
    np.testing.assert_array_equal(dag.numpy(), np.asarray(jdag))
    np.testing.assert_array_equal(
        nh.contiguous().numpy().view(np.uint32), np.asarray(jnh)
    )
    assert ok.dim() == 0 and bool(ok) == bool(jok)


def test_forward_ell_hop_counts_equal_reference():
    """The fixed-point forward without link metrics (hop counts)."""
    e, res, _ = _forward_inputs("wan96")
    src_ids = np.arange(0, 96, 13, dtype=np.int32)
    dist, dag = ops.spf_forward_ell(
        torch.from_numpy(src_ids), res.ell, res.edge_src, res.edge_dst,
        res.edge_metric, res.edge_up, res.node_overloaded,
        use_link_metric=False,
    )
    j = e.jcsr
    jdist, jdag = jops.spf_forward_ell(
        src_ids, j.ell, j.edge_src, j.edge_dst, j.edge_metric, j.edge_up,
        j.node_overloaded, use_link_metric=False,
    )
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jdist))
    np.testing.assert_array_equal(dag.numpy(), np.asarray(jdag))


def test_bucket_ladder():
    assert S_BUCKETS == (1, 8, 64, 512)
    assert [_s_bucket(s) for s in (1, 2, 8, 9, 64, 65, 512, 513, 1500)] == [
        1, 8, 8, 64, 64, 512, 512, 1024, 2048
    ]


@pytest.mark.parametrize("s", [1, 7, 8, 9, 64, 65])
def test_spf_results_at_bucket_edges(s):
    e = Engines(FAMILIES["wan96"]())
    names = e.ls.node_names
    e.query(names[:s], oracle=s <= 9)
    e.query(names[-s:], oracle=False)  # resident, same bucket


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_spf_results_equal_reference(name):
    e = Engines(FAMILIES[name]())
    names = e.ls.node_names
    e.query(names[:: max(1, len(names) // 5)][:5])
    e.query(names[1:3], use_link_metric=False)


def test_sign_bit_out_slot_decodes():
    """The hub's 33 neighbours fill out-slots 0..32: slot 31's bit is the
    int32 sign bit and slot 32 opens a second word; both decode to the
    same next hops as the reference and the host Dijkstra."""
    e = Engines(FAMILIES["hub"]())
    hub = e.ls.node_names[0]
    res = e.engine.sync(e.csr)
    _, _, nh, ok = ops.spf_forward_full(
        torch.tensor([0], dtype=torch.int32), res.ell, res.edge_src,
        res.edge_dst, res.edge_metric, res.edge_up, res.node_overloaded,
        res.out_slot, 2, 32,
    )
    assert bool(ok) and bool((nh[0, :, 0] < 0).any()) and bool(nh[0, :, 1].any())
    got = e.query([hub])[hub]
    slots = e.csr.slot_neighbors(hub)
    assert len(slots) == 33
    assert any(slots[31] in r.next_hops for r in got.values())
    assert any(slots[32] in r.next_hops for r in got.values())


def _flap_script(dbs):
    """tests/test_device_engine.py's 25 attribute-only mutations."""
    muts = []
    for i in range(6):
        db = dbs[2 * i]
        lnk = db.adjacencies[0]
        muts.append((db, "metric", lnk, 40 + 10 * i))
        muts.append((db, "metric", lnk, 10))
    for i in range(4):
        db = dbs[3 * i + 1]
        muts.append((db, "node_overload", None, True))
        muts.append((db, "node_overload", None, False))
    for i in range(2):
        db = dbs[5 * i + 2]
        lnk = db.adjacencies[-1]
        muts.append((db, "link_overload", lnk, True))
        muts.append((db, "link_overload", lnk, False))
    muts.append((dbs[7], "metric", dbs[7].adjacencies[1], 33))
    assert len(muts) == 25
    return muts


def test_twenty_five_flap_sequence():
    dbs = topo.grid_topology(5)
    e = Engines(dbs)
    names = e.ls.node_names
    e.query([names[0]])
    for i, (db, kind, lnk, val) in enumerate(_flap_script(dbs)):
        if kind == "metric":
            lnk.metric = val
        elif kind == "node_overload":
            db.is_overloaded = val
        else:
            lnk.is_overloaded = val
        assert e.refresh(db) is True, (i, kind)
        size = (1, 5, 25)[i % 3]
        start = i % len(names)
        e.query((names + names)[start : start + size])
        assert e.engine.last_query_bytes < 1000
    c = e.engine.get_counters()
    assert c["device.engine.full_restages"] == 1
    assert c["device.engine.incremental_updates"] == 25
    assert c["device.engine.queries"] == 26


def test_twenty_bounded_rewires_single_restage():
    plan = rewire_schedule(seed=1107, steps=20)
    e = Engines(ring_dbs(plan[0]))
    names = e.ls.node_names
    e.query(names[:2])
    for step, chords in enumerate(plan[1:]):
        assert e.refresh(*ring_dbs(chords)) is True, step
        e.query([names[(step * 5 + k) % len(names)] for k in range(3)])
    c = e.engine.get_counters()
    assert c["device.engine.full_restages"] == 1
    assert c["device.engine.rewires"] == c["device.engine.rewire_dispatches"] == 20
    assert c["device.engine.rewire_fallbacks"] == 0
    assert c["device.engine.rewire_slots"] >= 40
    assert 0 < c["device.engine.rewire_bytes_staged"] / 20 < 4000


def test_capacity_overflow_restages():
    chords = {(0, 5), (2, 8), (3, 9), (4, 10)}
    e = Engines(ring_dbs(chords))
    e.query(e.ls.node_names[:2])
    chords |= {(1, 6), (5, 11), (2, 7), (6, 10)}
    assert e.refresh(*ring_dbs(chords)) is False
    e.query(e.ls.node_names[:2])
    c = e.engine.get_counters()
    assert c["device.engine.full_restages"] == 2
    assert c["device.engine.rewires"] == c["device.engine.rewire_fallbacks"] == 0


def test_rewire_log_gap_demotes_to_restage():
    plan = rewire_schedule(seed=22, steps=6)
    e = Engines(ring_dbs(plan[0]))
    e.csr.REWIRE_LOG_DEPTH = e.jcsr.REWIRE_LOG_DEPTH = 4
    e.query(e.ls.node_names[:2])
    for chords in plan[1:]:
        assert e.refresh(*ring_dbs(chords)) is True
    e.query(e.ls.node_names[:2])
    c = e.engine.get_counters()
    assert c["device.engine.rewire_fallbacks"] == 1
    assert c["device.engine.full_restages"] == 2
    assert c["device.engine.rewires"] == 0


def test_rewire_error_propagates(monkeypatch):
    """Only a log gap demotes to a restage: any other failure of the
    rewire rung raises out of the query (the reference demotes it)."""
    chords = {(0, 5), (2, 8), (3, 9)}
    e = Engines(ring_dbs(chords))
    e.query(e.ls.node_names[:2])
    chords = (chords - {(2, 8)}) | {(1, 7)}
    assert e.refresh(*ring_dbs(chords)) is True

    def fail(res, delta):
        raise RuntimeError("device write failed")

    monkeypatch.setattr(e.engine, "_apply_rewire", fail)
    with pytest.raises(RuntimeError, match="device write failed"):
        e.engine.spf_results(e.csr, e.ls.node_names[:2])
    c = e.engine.get_counters()
    assert c["device.engine.rewire_fallbacks"] == 0
    assert c["device.engine.full_restages"] == 1


def test_expect_epoch():
    chords = {(0, 5), (2, 8), (3, 9)}
    e = Engines(ring_dbs(chords))
    e.query(e.ls.node_names[:2])
    pinned, jpinned = int(e.csr.version), int(e.jcsr.version)
    assert e.refresh(*ring_dbs((chords - {(0, 5)}) | {(1, 7)})) is True
    with pytest.raises(EpochMismatchError):
        e.engine.spf_results(e.csr, e.ls.node_names[:2], expect_epoch=pinned)
    with pytest.raises(JEpochMismatchError):
        e.jengine.spf_results(e.jcsr, e.ls.node_names[:2], expect_epoch=jpinned)
    e.assert_counters()
    assert e.engine.get_counters()["device.engine.rewires"] == 0  # pre-sync
    got = e.engine.spf_results(
        e.csr, e.ls.node_names[:2], expect_epoch=int(e.csr.version)
    )
    want = e.jengine.spf_results(
        e.jcsr, e.ls.node_names[:2], expect_epoch=int(e.jcsr.version)
    )
    assert {s: spf_key(r) for s, r in got.items()} == {
        s: spf_key(r) for s, r in want.items()
    }
    e.assert_counters()
    assert e.engine.get_counters()["device.engine.rewires"] == 1


def test_node_set_change_restages_and_drop_forgets():
    e = Engines(topo.grid_topology(3))
    e.query(e.ls.node_names[:2])
    assert e.engine.is_warm(e.csr)
    more = topo.grid_topology(4)
    assert e.refresh(*more) is False
    assert e.engine.has_residency(e.csr) is False
    e.query(e.ls.node_names[:2])
    assert e.engine.get_counters()["device.engine.full_restages"] == 2
    e.engine.drop(e.csr)
    assert not e.engine.has_residency(e.csr)


def test_collected_mirror_frees_its_resident():
    """A mirror's resident goes when the mirror is collected; a restaged
    mirror that lives on keeps its own."""
    engine = DeviceResidencyEngine("cpu")
    keep = Engines(topo.grid_topology(3))
    engine.spf_results(keep.csr, keep.ls.node_names[:2])
    pair = LinkStatePair(topo.grid_topology(4))
    csr = CsrTopology.from_link_state(pair.ls)
    engine.spf_results(csr, pair.ls.node_names[:2])
    engine.drop(csr)
    engine.spf_results(csr, pair.ls.node_names[:2])  # restaged after a drop
    assert len(engine._residents) == 2
    del csr
    gc.collect()
    assert list(engine._residents) == [id(keep.csr)]
    assert engine.has_residency(keep.csr)


@pytest.mark.cuda
def test_spf_results_on_card_equal_cpu():
    """The engine on the card returns the CPU engine's results, hints and
    counters through flaps and a rewire (runs with `-m cuda` on a machine
    with a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    plan = rewire_schedule(seed=1107, steps=3)
    runs = {}
    for device in ("cpu", "cuda"):
        pair = LinkStatePair(ring_dbs(plan[0]))
        csr = CsrTopology.from_link_state(pair.ls)
        engine = DeviceResidencyEngine(device)
        names = pair.ls.node_names
        out = [spf_key(r) for r in engine.spf_results(csr, names).values()]
        for chords in plan[1:]:
            pair.update(*ring_dbs(chords))
            csr.refresh(pair.ls)
            out += [spf_key(r) for r in engine.spf_results(csr, names[:9]).values()]
        c = engine.get_counters()
        runs[device] = (out, csr._sweep_hint, {k: c[k] for k in RESIDENCY_KEYS})
    assert runs["cpu"] == runs["cuda"]
