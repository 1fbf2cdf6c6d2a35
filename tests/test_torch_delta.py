"""The incremental delta rung of the port against openr_tpu's.

Mirrors tests/test_delta.py on the port: a coalesced batch of LinkState
events folded into the previous fleet product through
`FleetViewCache(delta=True)` (decision.delta, ops.delta and the engine's
delta rung).  The same databases, built once, go to both packages; the
fixture is the reference's 64-node ring with +-1 / +-2 links, every
node labelled (so P = 64 reaches the rung's `min_p` and the reversed
graph has bands).  Tolerance: none.  Distances (of the reference's
dtype, uint16 where every metric is below 5000), ECMP bitmaps, the
`converged` and `done` verdicts, `warm_mode`, the frontier's affected
set and columns, and every `decision.delta.*` and
`device.engine.delta_*` counter (the `_us` timings aside) are equal
bit for bit, and every delta view also equals the port's own cold view.
The reference's `delta_relax` and its epilogue are lax code, so it runs
as its own tests run it on the CPU; the port's slab epilogue is K1's
plain version here (CPU tensors).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.decision import delta as jdelta
from openr_tpu.decision import fleet as jfleet
from openr_tpu.decision.csr import CsrTopology as JCsr
from openr_tpu.decision.prefix_state import PrefixState as JPrefixState
from openr_tpu.decision.spf_solver import DeviceSpfBackend
from openr_tpu.decision.spf_solver import SpfSolver as JSpfSolver
from openr_tpu.device import engine as jengine_mod
from openr_tpu.ops import allsources as jasrc
from openr_tpu.ops import delta as jdops
from openr_tpu_torch.decision import delta
from openr_tpu_torch.decision import fleet
from openr_tpu_torch.decision.csr import CsrTopology
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.decision.spf_solver import SpfSolver
from openr_tpu_torch.device.engine import (
    DELTA_P_BUCKETS,
    DeviceResidencyEngine,
    EpochMismatchError,
)
from openr_tpu_torch.ops import allsources as asrc
from openr_tpu_torch.ops import delta as dops
from openr_tpu_torch.ops import epilogue as ep
from openr_tpu_torch.types import AdjacencyDatabase, PrefixEntry

from torch_parity import (
    adj,
    link_states,
    normalized_routes,
    square_dbs,
    to_jax_dbs,
    to_jax_entry,
)

N = 64
PREFIXES = (("r063", "::1:0/112"), ("r000", "::2:0/112"))


def _name(i: int) -> str:
    return f"r{i % N:03d}"


def _flat(a, b) -> int:
    return 20


def _node_db(i, metric=_flat, drop=None, is_overloaded=False):
    """tests/test_delta.py's `set_node` database of node i."""
    return AdjacencyDatabase(
        this_node_name=_name(i),
        adjacencies=[
            adj(_name(i), _name(i + d), metric=metric(i, (i + d) % N))
            for d in (1, -1, 2, -2)
            if d != drop
        ],
        is_overloaded=is_overloaded,
        node_label=1000 + i,
        area="0",
    )


class Pair:
    """The same LinkState and prefixes in both packages, changed together."""

    def __init__(self, dbs=None, prefixes=PREFIXES) -> None:
        self.ls, self.jls = link_states(dbs if dbs is not None else [])
        self.ps, self.jps = PrefixState(), JPrefixState()
        for node, prefix in prefixes:
            entry = PrefixEntry(prefix=prefix)
            self.ps.update_prefix(node, "0", entry)
            self.jps.update_prefix(node, "0", to_jax_entry(entry))

    @classmethod
    def ring(cls, metric=_flat) -> "Pair":
        return cls([_node_db(i, metric) for i in range(N)])

    def set(self, db) -> None:
        self.ls.update_adjacency_database(db)
        self.jls.update_adjacency_database(to_jax_dbs([db])[0])

    def set_node(self, i, **kw) -> None:
        self.set(_node_db(i, **kw))

    def dests(self):
        dests = fleet.fleet_destinations(self.ls, self.ps)
        assert dests == jfleet.fleet_destinations(self.jls, self.jps)
        return dests


def _raise_0_1(a, b):
    return 90 if b == 1 else 20


def _lower_0_1(a, b):
    return 5 if b == 1 else 20


def _expensive_5(a, b):
    return 200 if 5 in (a, b) else 20


def _chord_0_2(w):
    return lambda a, b: w if (a, b) == (0, 2) else 20


def _square_change(pair):
    pair.set(
        AdjacencyDatabase(
            this_node_name="1",
            adjacencies=[adj("1", "2", metric=30), adj("1", "3")],
            node_label=101,
            area="0",
        )
    )


class Case(NamedTuple):
    """One tests/test_delta.py::TestDeltaPath case: the fixture, the
    rounds of changes (each round followed by one view), the cache's
    keywords, whether the views get an engine, the final `warm_mode`,
    and a check of the final bump dict and port engine counters."""

    make: Callable
    rounds: tuple
    mode: object
    check: Callable = lambda c, e: True
    cache_kw: dict = {}
    engine: bool = True


def _ring_round(**kw):
    return (lambda p: p.set_node(**kw),)


CASES = {
    "metric_increase": Case(
        Pair.ring,
        (_ring_round(i=0, metric=_raise_0_1),),
        "delta",
        lambda c, e: c["decision.delta.updates"] == 1
        and c["decision.delta.affected_cols"] > 0
        and e["device.engine.delta_dispatches"] >= 2,
    ),
    "metric_decrease": Case(
        Pair.ring,
        (_ring_round(i=0, metric=_lower_0_1),),
        "delta",
        lambda c, e: c["decision.delta.updates"] == 1,
    ),
    "link_down": Case(
        Pair.ring,
        (_ring_round(i=0, drop=1),),
        "delta",
        lambda c, e: c["decision.delta.updates"] == 1,
    ),
    # two rounds: down (delta), then back up (delta), the improvement
    # direction over a changed edge set
    "link_up": Case(
        Pair.ring,
        (_ring_round(i=0, drop=1), _ring_round(i=0)),
        "delta",
        lambda c, e: c["decision.delta.updates"] == 2,
    ),
    # draining a transit node flags more than half the columns: the
    # ladder refuses and the legacy worsen path serves
    "overload_dense_fallback": Case(
        Pair.ring,
        (_ring_round(i=5, is_overloaded=True),),
        "worsen",
        lambda c, e: c["decision.delta.fallbacks"] == 1
        and e["device.engine.delta_overflow_fallbacks"] == 1,
    ),
    "overload_non_transit": Case(
        lambda: Pair.ring(_expensive_5),
        (_ring_round(i=5, metric=_expensive_5, is_overloaded=True),),
        "delta",
        lambda c, e: c["decision.delta.updates"] == 1
        and c["decision.delta.affected_cols"] <= 4,
    ),
    "certified_noop": Case(
        lambda: Pair.ring(_chord_0_2(100)),
        (_ring_round(i=0, metric=_chord_0_2(150)),),
        "delta",
        lambda c, e: c["decision.delta.noop_updates"] == 1
        and "decision.delta.updates" not in c
        and e["device.engine.delta_dispatches"] == 1,
    ),
    "mixed_batch": Case(
        Pair.ring,
        (
            (
                lambda p: p.set_node(0, metric=_raise_0_1),
                lambda p: p.set_node(4, metric=lambda a, b: 5 if b == 5 else 20),
                lambda p: p.set_node(2, metric=lambda a, b: 70 if b == 3 else 20),
            ),
        ),
        "delta",
        lambda c, e: c["decision.delta.updates"] == 1
        and c["decision.delta.events_coalesced"] >= 3,
    ),
    "parity_gate": Case(
        Pair.ring,
        (_ring_round(i=0, drop=1),),
        "delta",
        lambda c, e: c["decision.delta.parity_checks"] == 1
        and c.get("decision.delta.parity_failures", 0) == 0,
        {"delta_parity": True},
    ),
    "min_p_gate": Case(
        Pair.ring,
        (_ring_round(i=0, drop=1),),
        "worsen",
        lambda c, e: "decision.delta.updates" not in c
        and e["device.engine.delta_dispatches"] == 0,
        {"delta_min_p": 1000},
    ),
    # no bands: eligible() is False, no delta dispatch
    "small_topology": Case(
        lambda: Pair(square_dbs(), prefixes=(("4", "::1:0/112"),)),
        ((_square_change,),),
        None,
        lambda c, e: e["device.engine.delta_dispatches"] == 0,
    ),
    # an engine-less cache stays on the legacy paths
    "no_engine": Case(
        Pair.ring,
        (_ring_round(i=0, drop=1),),
        "worsen",
        lambda c, e: not c and e["device.engine.delta_dispatches"] == 0,
        engine=False,
    ),
}


def _delta_keys(counters: dict) -> dict:
    return {
        k: v
        for k, v in counters.items()
        if k.startswith("device.engine.delta_") and not k.endswith("_us")
    }


def _assert_views_equal(view, jview):
    """A port view against a reference view: warm_mode and raw products."""
    assert view.warm_mode == jview.warm_mode
    jdist = np.asarray(jview._dist_dev)
    assert view._dist_dev.numpy().dtype == jdist.dtype
    np.testing.assert_array_equal(view._dist_dev.numpy(), jdist)
    np.testing.assert_array_equal(
        view._bitmap_dev.numpy().view(np.uint32), np.asarray(jview._bitmap_dev)
    )


def _assert_same(view, other):
    """Two port views: equal distances and bitmaps."""
    assert view._dist_dev.dtype == other._dist_dev.dtype
    assert torch.equal(view._dist_dev, other._dist_dev)
    assert torch.equal(view._bitmap_dev, other._bitmap_dev)


def _run_case(case: Case):
    """Both packages through the case: (port view, reference view, port
    bump dict, reference bump dict, port engine, reference engine)."""
    out = []
    for port in (True, False):
        pair = case.make()
        counters: dict[str, int] = {}

        def bump(name, n=1, counters=counters):
            counters[name] = counters.get(name, 0) + n

        mod = fleet if port else jfleet
        cache = mod.FleetViewCache(delta=True, bump=bump, **case.cache_kw)
        engine = DeviceResidencyEngine("cpu") if port else jengine_mod.DeviceResidencyEngine()
        ls = pair.ls if port else pair.jls

        def view(ls=ls, cache=cache, engine=engine, port=port):
            kw = {"engine": engine} if case.engine else {}
            if port and not case.engine:
                kw["device"] = "cpu"
            return cache.view(ls, pair.dests(), **kw)

        first = view()
        assert not first.warm
        for mutations in case.rounds:
            for m in mutations:
                m(pair)
            last = view()
        out.append((pair, last, counters, engine))
    (pair, view, counters, engine), (_, jview, jcounters, jengine) = out
    return SimpleNamespace(
        pair=pair, view=view, jview=jview, counters=counters,
        jcounters=jcounters, engine=engine, jengine=jengine,
    )


@pytest.mark.parametrize("name", sorted(CASES))
def test_delta_path_matches_reference(name):
    case = CASES[name]
    r = _run_case(case)
    _assert_views_equal(r.view, r.jview)
    assert r.view.warm_mode == case.mode
    assert r.counters == r.jcounters
    mine = r.engine.get_counters()
    assert _delta_keys(mine) == _delta_keys(r.jengine.counters)
    assert case.check(r.counters, mine)
    # the port's delta view equals the port's own cold view
    cold = fleet.FleetViewCache(delta=False).view(
        r.pair.ls, r.pair.dests(), device="cpu"
    )
    assert not cold.warm
    _assert_same(r.view, cold)


# -- the three programs, called directly ------------------------------------


def _int32_metric(a, b):
    """Flat 20 with one 6000 link: no uint16 mode (metrics >= 5000)."""
    return 6000 if (a, b) == (30, 31) else 20


def _mixed_changes(pair, metric):
    """A worsened link removed (an edge-set change: re-ranked out-rows),
    an improved metric and a raised one, in one batch."""
    pair.set_node(0, metric=metric, drop=1)
    pair.set_node(4, metric=lambda a, b: 5 if b == 5 else metric(a, b))
    pair.set_node(2, metric=lambda a, b: 70 if b == 3 else metric(a, b))


def _program_inputs(metric):
    """Each package's previous cold view, the new view's mirror, reverse
    runner, out-edge table and masks after `_mixed_changes`."""
    pair = Pair.ring(metric)
    dests = pair.dests()
    engine = DeviceResidencyEngine("cpu")
    prev = fleet.FleetViewCache().view(pair.ls, dests, engine=engine)
    jprev = jfleet.FleetViewCache(delta=False).view(pair.jls, dests)
    _mixed_changes(pair, metric)
    sides = []
    for port in (True, False):
        mod = fleet if port else jfleet
        csr = (CsrTopology if port else JCsr).from_link_state(
            pair.ls if port else pair.jls
        )
        view = (
            mod.FleetRouteView(csr, dests, engine)
            if port
            else mod.FleetRouteView(csr, dests)
        )
        runner = mod._reverse_runner(csr)
        if port:
            engine.stage(runner)
        p_prev = prev if port else jprev
        out = (asrc if port else jasrc).build_out_ell(
            csr.edge_src, csr.edge_dst, csr.n_edges, csr.n_nodes,
            out_slot=csr.out_slot,
        )
        worsened = mod._worsened_masks(
            p_prev, view._edge_keys, view._edge_met, view._overloaded
        )
        improved = (delta if port else jdelta)._improved_masks(p_prev, view, runner)
        sides.append(
            SimpleNamespace(
                prev=p_prev, view=view, csr=csr, runner=runner, out=out,
                worsened=worsened, improved=improved,
                dest_ids=np.asarray(
                    [view._node_id[d] for d in dests], dtype=np.int32
                ),
            )
        )
    return pair, engine, sides[0], sides[1]


def _frontier(s, js, max_iters=128):
    aff, col_mask, done, passes = dops.delta_frontier(
        s.prev._dist_dev,
        s.prev._runner.bg,
        s.prev._runner.call_arrays(),
        torch.from_numpy(s.worsened[0]),
        torch.from_numpy(s.worsened[1]),
        s.runner.bg,
        s.runner.call_arrays(),
        *s.improved,
        max_iters=max_iters,
    )
    _, _, o_met, o_up, o_ov = js.prev._runner.call_arrays()
    _, _, n_met, n_up, n_ov = js.runner.call_arrays()
    jaff, jcol, jdone = jdops.delta_frontier(
        js.prev._dist_dev,
        js.prev._runner.bg,
        o_up,
        o_met,
        o_ov,
        jnp.asarray(js.worsened[0]),
        jnp.asarray(js.worsened[1]),
        js.runner.bg,
        n_up,
        n_met,
        n_ov,
        jnp.asarray(js.improved[0]),
        jnp.asarray(js.improved[1]),
        small_dist=js.prev._dist_dev.dtype == jnp.uint16,
        max_iters=max_iters,
    )
    return (aff, col_mask, done, passes), (jaff, jcol, bool(jdone))


@pytest.mark.parametrize("mode", ["uint16", "int32"])
def test_programs_match_reference(mode):
    """delta_frontier, delta_relax and delta_rows_bitmap called directly
    on the same inputs in both packages: aff, col_mask, done, distances,
    bitmap, converged and blocks equal, and the result equal to the
    port's cold view of the new LinkState."""
    metric = _flat if mode == "uint16" else _int32_metric
    pair, engine, s, js = _program_inputs(metric)
    want_dtype = torch.uint16 if mode == "uint16" else torch.int32
    assert s.prev._dist_dev.dtype == want_dtype
    for a, b in zip(s.worsened + s.improved, js.worsened + js.improved):
        np.testing.assert_array_equal(a, b)

    (aff, col_mask, done, passes), (jaff, jcol, jdone) = _frontier(s, js)
    np.testing.assert_array_equal(aff.numpy(), np.asarray(jaff))
    np.testing.assert_array_equal(col_mask.numpy(), np.asarray(jcol))
    assert done and jdone and passes >= 1
    col_idx = np.flatnonzero(col_mask.numpy()).astype(np.int32)
    n_cols = len(col_idx)
    assert 0 < n_cols < len(s.dest_ids)

    pb = next(b for b in DELTA_P_BUCKETS if b >= n_cols)
    col_pad = np.full(pb, col_idx[0], dtype=np.int32)
    col_pad[:n_cols] = col_idx
    maps = asrc.build_epilogue_maps(s.runner.bg, s.out)
    dist, bitmap, conv, blocks = dops.delta_relax(
        s.prev._dist_dev.clone(), s.prev._bitmap_dev.clone(), aff, col_pad,
        n_cols, s.dest_ids, s.runner, maps, s.out.n_words, ep.fused_epilogue,
    )
    jmaps = jasrc.build_epilogue_maps(js.runner.bg, js.out)
    _, _, n_met, n_up, n_ov = js.runner.call_arrays()
    jdist, jbitmap, jconv, jblocks = jdops.delta_relax(
        jnp.asarray(np.asarray(js.prev._dist_dev)),
        jnp.asarray(np.asarray(js.prev._bitmap_dev)),
        jaff,
        jnp.asarray(col_pad),
        jnp.asarray(js.dest_ids),
        js.runner.bg,
        n_up,
        n_met,
        n_ov,
        jmaps.resid_slot,
        jmaps.band_slot,
        depth=js.runner.depth,
        resid_rounds=js.runner.resid_rounds,
        small_dist=mode == "uint16",
        chord_mode=js.runner.chord_mode,
        n_words=js.out.n_words,
    )
    assert conv and bool(jconv) and blocks == int(jblocks)
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jdist))
    np.testing.assert_array_equal(
        bitmap.numpy().view(np.uint32), np.asarray(jbitmap)
    )

    rows = delta._changed_out_rows(s.prev._out, s.out)
    np.testing.assert_array_equal(rows, jdelta._changed_out_rows(js.prev._out, js.out))
    assert len(rows) > 0
    rb = 1 << (len(rows) - 1).bit_length()
    row_pad = np.full(rb, rows[0], dtype=np.int32)
    row_pad[: len(rows)] = rows
    bitmap = dops.delta_rows_bitmap(
        bitmap, dist, row_pad, len(rows), s.out,
        torch.from_numpy(s.csr.edge_metric), torch.from_numpy(s.csr.edge_up),
        torch.from_numpy(s.csr.node_overloaded), s.out.n_words,
    )
    jbitmap = jdops.delta_rows_bitmap(
        jbitmap, jdist, jnp.asarray(row_pad), js.out.nbr, js.out.eid,
        js.out.slot, jnp.asarray(js.csr.edge_metric),
        jnp.asarray(js.csr.edge_up), jnp.asarray(js.csr.node_overloaded),
        n_words=js.out.n_words,
    )
    np.testing.assert_array_equal(
        bitmap.numpy().view(np.uint32), np.asarray(jbitmap)
    )
    cold = fleet.FleetViewCache().view(pair.ls, pair.dests(), engine=engine)
    assert torch.equal(dist, cold._dist_dev)
    assert torch.equal(bitmap, cold._bitmap_dev)


def test_frontier_pass_budget_matches_reference():
    """A budget of one pass cannot certify the support-loss fixpoint of
    the mixed batch: done is False on both sides, with equal sets."""
    _, _, s, js = _program_inputs(_flat)
    (aff, col_mask, done, passes), (jaff, jcol, jdone) = _frontier(s, js, 1)
    assert not done and not jdone and passes == 1
    np.testing.assert_array_equal(aff.numpy(), np.asarray(jaff))
    np.testing.assert_array_equal(col_mask.numpy(), np.asarray(jcol))


# -- the engine's delta rung ------------------------------------------------


def _bucket_ladder(e):
    return [e.delta_bucket(5, 1024), e.delta_bucket(9, 1024), e.delta_bucket(129, 1024)]


def _bucket_overflow(e):
    return [e.delta_bucket(600, 1024), e.delta_bucket(40, 64), e.delta_bucket(600, 4096)]


def _epoch_refusal(e):
    csr = SimpleNamespace(version=7)
    errors = (EpochMismatchError, jengine_mod.EpochMismatchError)
    with pytest.raises(errors):
        e.delta_dispatch("relax", lambda: None, csr=csr, expect_epoch=6)
    return None


def _dispatch_accounting(e):
    key = ("relax", (64, 256, 64), 16, 1, True, 0, True)
    return [e.delta_dispatch("relax", lambda: 1, bucket_key=key) for _ in range(2)]


def _register(e):
    e.delta_register(4096)
    return None


ENGINE_CASES = {
    "bucket_ladder": (_bucket_ladder, [8, 16, 256]),
    "bucket_overflow": (_bucket_overflow, [None, None, None]),
    "epoch_refusal": (_epoch_refusal, None),
    "dispatch_and_bucket_accounting": (_dispatch_accounting, [1, 1]),
    "register_accounts_the_initial_upload": (_register, None),
}

ENGINE_KEYS = (
    "device.engine.delta_dispatches",
    "device.engine.delta_bucket_hits",
    "device.engine.delta_bucket_misses",
    "device.engine.delta_overflow_fallbacks",
    "device.engine.epoch_invalidations",
    "device.engine.full_restages",
    "device.engine.bytes_staged",
)


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_engine_delta_rung_matches_reference(name):
    """tests/test_delta.py::TestEngineDeltaRung on both engines: the same
    results and the same counters."""
    fn, want = ENGINE_CASES[name]
    engine, jengine = DeviceResidencyEngine("cpu"), jengine_mod.DeviceResidencyEngine()
    assert fn(engine) == fn(jengine) == want
    mine, theirs = engine.get_counters(), jengine.get_counters()
    assert {k: mine[k] for k in ENGINE_KEYS} == {k: theirs[k] for k in ENGINE_KEYS}
    if name == "bucket_overflow":
        assert mine["device.engine.delta_overflow_fallbacks"] == 3
    if name == "epoch_refusal":
        assert mine["device.engine.epoch_invalidations"] == 1
        assert mine["device.engine.delta_dispatches"] == 0


# -- the entry point ----------------------------------------------------------


def test_delta_path_event_parity():
    """tests/test_decision_golden.py::TestDeltaPathEventParity: a port
    solver with the rung, one without, and the reference's solver with
    it consume one interleaved event stream; every fleet RIB is equal on
    all three, and the rung carried updates."""
    nodes = ["r000", "r001", "r004", "r016", "r031", "r032", "r047", "r063"]
    pair = Pair.ring()
    with_delta = SpfSolver("r000", device="cpu", fleet_delta=True)
    without = SpfSolver("r000", device="cpu", fleet_delta=False)
    ref = JSpfSolver(
        "r000",
        spf_backend=DeviceSpfBackend(min_device_nodes=1, min_device_sources=1),
        fleet_delta=True,
    )

    def step(*mutations):
        for m in mutations:
            m()
        got = with_delta.fleet_route_dbs({"0": pair.ls}, pair.ps, nodes=nodes)
        plain = without.fleet_route_dbs({"0": pair.ls}, pair.ps, nodes=nodes)
        want = ref.fleet_route_dbs({"0": pair.jls}, pair.jps, nodes=nodes)
        assert sorted(got) == sorted(plain) == sorted(want)
        for node in got:
            routes = normalized_routes(got[node])
            assert routes == normalized_routes(plain[node]), node
            assert routes == normalized_routes(want[node]), node

    step()
    step(lambda: pair.set_node(0, metric=_raise_0_1))
    step(lambda: pair.set_node(0))
    step(lambda: pair.set_node(0, drop=1))
    step(lambda: pair.set_node(0))
    step(lambda: pair.set_node(5, is_overloaded=True))
    step(lambda: pair.set_node(5))
    step(
        lambda: pair.set_node(4, metric=lambda a, b: 5 if b == 5 else 20),
        lambda: pair.set_node(2, metric=lambda a, b: 70 if b == 3 else 20),
    )
    keys = delta.DELTA_COUNTER_KEYS + (
        "decision.fleet_rebuild_warm",
        "decision.fleet_rebuild_cold",
        "decision.fleet_rebuild_warm_down",
    )
    assert {k: with_delta.counters.get(k, 0) for k in keys} == {
        k: ref.counters.get(k, 0) for k in keys
    }
    assert with_delta.counters["decision.delta.updates"] >= 4
    assert with_delta.counters["decision.delta.events_coalesced"] >= 5
    assert without.counters["decision.delta.updates"] == 0


# -- the deliberate differences ----------------------------------------------


def _primed_cache():
    pair = Pair.ring()
    counters: dict[str, int] = {}

    def bump(name, n=1):
        counters[name] = counters.get(name, 0) + n

    engine = DeviceResidencyEngine("cpu")
    cache = fleet.FleetViewCache(delta=True, bump=bump)
    cache.view(pair.ls, pair.dests(), engine=engine)
    pair.set_node(0, metric=_raise_0_1)
    return pair, engine, cache, counters


def test_dispatch_error_propagates_and_is_no_fallback():
    """A failing slab epilogue (K1's wrapper raising, as a failed launch
    would) propagates out of `view`; the reference would have counted a
    fallback and served the legacy path."""
    pair, engine, cache, counters = _primed_cache()

    def failing(*args, **kwargs):
        raise RuntimeError("fused_epilogue kernel launch failed")

    engine.epilogue = failing
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        cache.view(pair.ls, pair.dests(), engine=engine)
    assert counters.get("decision.delta.fallbacks", 0) == 0
    assert counters.get("decision.delta.updates", 0) == 0


def test_epoch_mismatch_counts_as_fallback():
    """A change landing between coalescing and the frontier's dispatch
    (the mirror's version moves) is refused before any device work,
    counted as a fallback, and the legacy path serves a correct view."""
    pair, engine, cache, counters = _primed_cache()
    dispatch = engine.delta_dispatch

    def moved(op, fn, *args, csr=None, **kwargs):
        csr.version += 1
        try:
            return dispatch(op, fn, *args, csr=csr, **kwargs)
        finally:
            csr.version -= 1

    engine.delta_dispatch = moved
    view = cache.view(pair.ls, pair.dests(), engine=engine)
    assert counters["decision.delta.fallbacks"] == 1
    assert engine.get_counters()["device.engine.epoch_invalidations"] == 1
    assert view.warm_mode == "worsen"
    cold = fleet.FleetViewCache().view(pair.ls, pair.dests(), device="cpu")
    _assert_same(view, cold)


@pytest.mark.cuda
def test_delta_rebuilds_on_card_equal_cpu():
    """A worsening and an improving delta rebuild on the card (K1 on the
    slab) equal the port's CPU views of the same sequence (runs with
    `-m cuda` on a machine with a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    views = {}
    for device in ("cpu", "cuda"):
        pair = Pair.ring()
        engine = DeviceResidencyEngine(device)
        cache = fleet.FleetViewCache(delta=True)
        cache.view(pair.ls, pair.dests(), engine=engine)
        got = []
        for change in ({"metric": _raise_0_1}, {}):
            pair.set_node(0, **change)
            view = cache.view(pair.ls, pair.dests(), engine=engine)
            # the next delta view updates this view's tensors in place:
            # copy them (`.cpu()` of a CPU tensor is the tensor itself)
            got.append(
                (
                    view.warm_mode,
                    view._dist_dev.view(torch.int16).to("cpu", copy=True),
                    view._bitmap_dev.to("cpu", copy=True),
                )
            )
        views[device] = got
    for (mode, dist, bitmap), (card_mode, card_dist, card_bitmap) in zip(
        views["cpu"], views["cuda"]
    ):
        assert mode == card_mode == "delta"
        assert torch.equal(dist, card_dist)
        assert torch.equal(bitmap, card_bitmap)
