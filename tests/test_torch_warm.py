"""Warm-started fleet rebuilds of the port against openr_tpu's.

Mirrors tests/test_fleet.py::TestWarmStart on the port: improvement-only
changes seed the banded relax with the previous product, worsening and
mixed changes seed it with the previous product minus the certified
affected set.  Every case builds, after the same change sequence, the
port's warm-capable view, the port's cold view (a fresh cache) and the
reference's warm-capable view: distances (of the reference's dtype,
uint16 here) and bitmaps equal bit for bit, and the same `warm_mode`.  `affected_mask` equals the reference's
(aff, done), a pass budget too small to certify included.  The fixtures
are 64-node rings with chords of length 2 (banded after reversal); the
ELL fallback never warms.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openr_tpu.ops.banded as jbanded
from openr_tpu.decision import fleet as jfleet
from openr_tpu.decision.csr import CsrTopology as JCsr
from openr_tpu.decision.prefix_state import PrefixState as JPrefixState
from openr_tpu.decision.spf_solver import DeviceSpfBackend
from openr_tpu.decision.spf_solver import SpfSolver as JSpfSolver
from openr_tpu_torch.decision import fleet
from openr_tpu_torch.decision.csr import CsrTopology
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.decision.spf_solver import SpfSolver
from openr_tpu_torch.ops.banded import affected_mask
from openr_tpu_torch.types import AdjacencyDatabase, PrefixEntry

from torch_parity import (
    adj,
    adj_dbs,
    link_states,
    normalized_routes,
    square_dbs,
    to_jax_dbs,
    to_jax_entry,
)

PFX = "::1:0/112"
N = 64


def _name(i: int) -> str:
    return f"r{i % N:03d}"


def _ring_adjs(i, metric=lambda a, b: 20, drop=None):
    return [
        adj(_name(i), _name(i + d), metric=metric(i, (i + d) % N))
        for d in (1, -1, 2, -2)
        if d != drop
    ]


def _node_db(i, metric=lambda a, b: 20, drop=None, is_overloaded=False):
    return AdjacencyDatabase(
        this_node_name=_name(i),
        adjacencies=_ring_adjs(i, metric, drop),
        is_overloaded=is_overloaded,
        node_label=1000 + i,
        area="0",
    )


class Pair:
    """The same LinkState and prefixes in both packages, changed together."""

    def __init__(self, dbs=None, prefixes=((_name(63), PFX),)) -> None:
        if dbs is None:
            dbs = [_node_db(i) for i in range(N)]
        self.ls, self.jls = link_states(dbs)
        self.ps, self.jps = PrefixState(), JPrefixState()
        for node, prefix in prefixes:
            entry = PrefixEntry(prefix=prefix)
            self.ps.update_prefix(node, "0", entry)
            self.jps.update_prefix(node, "0", to_jax_entry(entry))

    def set(self, db) -> None:
        self.ls.update_adjacency_database(db)
        self.jls.update_adjacency_database(to_jax_dbs([db])[0])

    def set_node(self, i, **kw) -> None:
        self.set(_node_db(i, **kw))

    def dests(self):
        dests = fleet.fleet_destinations(self.ls, self.ps)
        assert dests == jfleet.fleet_destinations(self.jls, self.jps)
        return dests


def _caches():
    return fleet.FleetViewCache(), jfleet.FleetViewCache(delta=False)


def _views(pair, cache, jcache, dests=None):
    dests = pair.dests() if dests is None else dests
    return (
        cache.view(pair.ls, dests, device="cpu"),
        jcache.view(pair.jls, dests),
    )


def _assert_same(view, other):
    """Two port views: equal distances and bitmaps."""
    assert torch.equal(view._dist_dev, other._dist_dev)
    assert torch.equal(view._bitmap_dev, other._bitmap_dev)


def _assert_matches_reference(view, jview):
    assert view.warm == jview.warm
    assert view.warm_mode == jview.warm_mode
    assert view.sweep_hint == jview.sweep_hint
    # the reference's dtype and raw values (uint16 in the small mode)
    jdist = np.asarray(jview._dist_dev)
    assert view._dist_dev.numpy().dtype == jdist.dtype
    np.testing.assert_array_equal(view._dist_dev.numpy(), jdist)
    np.testing.assert_array_equal(
        view._bitmap_dev.numpy().view(np.uint32), np.asarray(jview._bitmap_dev)
    )


def _rebuild(mutate, pair=None):
    """The port's warm-capable view after `mutate(pair)`, held bit for bit
    against the port's cold view and the reference's warm-capable view
    (both warm-capable caches first built a view of the unchanged
    topology)."""
    pair = Pair() if pair is None else pair
    cache, jcache = _caches()
    v1, jv1 = _views(pair, cache, jcache)
    assert not v1.warm and v1._runner.bg is not None
    mutate(pair)
    warm, jwarm = _views(pair, cache, jcache)
    cold = fleet.FleetViewCache().view(pair.ls, pair.dests(), device="cpu")
    assert not cold.warm and cold.warm_mode is None
    _assert_same(warm, cold)
    _assert_matches_reference(warm, jwarm)
    return warm


def _metric(node_metric, towards):
    return lambda a, b: node_metric if b == towards else 20


MUTATIONS = {
    "metric_decrease": (
        lambda p: p.set_node(0, metric=_metric(5, 1)), "improve"
    ),
    "metric_increase": (
        lambda p: p.set_node(0, metric=_metric(90, 1)), "worsen"
    ),
    "single_link_down": (lambda p: p.set_node(0, drop=1), "worsen"),
    "multi_link_down": (
        lambda p: (
            p.set_node(0, drop=1),
            p.set_node(20, drop=-1),
            p.set_node(40, drop=2),
        ),
        "worsen",
    ),
    # one link worsens while another improves in the same change: the
    # improved edge only loosens the affected-set upper bound
    "mixed": (
        lambda p: (
            p.set_node(0, metric=_metric(90, 1)),
            p.set_node(32, metric=_metric(5, 33)),
        ),
        "worsen",
    ),
    "drain": (lambda p: p.set_node(5, is_overloaded=True), "worsen"),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_warm_rebuild_equals_cold_and_reference(name):
    mutate, mode = MUTATIONS[name]
    warm = _rebuild(mutate)
    assert warm.warm and warm.warm_mode == mode and not warm.cold_fallback
    if mode == "worsen":
        assert warm.affected_passes > 0 and 0 < warm.affected_share < 1


def test_link_down_then_up_and_drain_set_then_clear():
    pair = Pair()
    cache, jcache = _caches()
    v1, _ = _views(pair, cache, jcache)
    for down, up in (
        (lambda: pair.set_node(0, drop=1), lambda: pair.set_node(0)),
        (
            lambda: pair.set_node(5, is_overloaded=True),
            lambda: pair.set_node(5),
        ),
    ):
        down()
        v2, jv2 = _views(pair, cache, jcache)
        assert v2.warm_mode == "worsen"
        _assert_matches_reference(v2, jv2)
        up()
        v3, jv3 = _views(pair, cache, jcache)
        assert v3.warm_mode == "improve"
        _assert_matches_reference(v3, jv3)
        # back at the first topology: the first product again
        _assert_same(v3, v1)


def test_warm_down_routes_match_reference_solver():
    """The worsening warm product answers route builds exactly like the
    reference solver's host Dijkstra, through one persistent solver."""
    pair = Pair()
    nodes = [_name(i) for i in (0, 1, 2, 31, 63)]
    solver = SpfSolver(_name(0), device="cpu")
    solver.fleet_route_dbs({"0": pair.ls}, pair.ps, nodes=nodes)
    pair.set_node(0, drop=1)
    got = solver.fleet_route_dbs({"0": pair.ls}, pair.ps, nodes=nodes)
    assert solver.fleet._views[pair.ls].warm_mode == "worsen"
    for node in nodes:
        want = JSpfSolver(node).build_route_db({"0": pair.jls}, pair.jps)
        assert normalized_routes(got[node]) == normalized_routes(want), node


def test_rebuild_counters_equal_reference_solver():
    pair = Pair()
    solver = SpfSolver(_name(0), device="cpu")
    jsolver = JSpfSolver(
        _name(0),
        spf_backend=DeviceSpfBackend(min_device_nodes=1, min_device_sources=1),
    )
    keys = (
        "decision.fleet_rebuild_cold",
        "decision.fleet_rebuild_warm",
        "decision.fleet_rebuild_warm_down",
    )
    steps = (
        lambda: None,
        lambda: pair.set_node(0, metric=_metric(5, 1)),
        lambda: None,  # a cached re-read bumps nothing
        lambda: pair.set_node(0, drop=1),
        lambda: pair.set_node(0),
    )
    for step in steps:
        step()
        solver.fleet_route_dbs({"0": pair.ls}, pair.ps, nodes=[_name(0)])
        jsolver.fleet_route_dbs({"0": pair.jls}, pair.jps, nodes=[_name(0)])
        assert {k: solver.counters.get(k) for k in keys} == {
            k: jsolver.counters.get(k) for k in keys
        }
    assert [solver.counters.get(k) for k in keys] == [1, 3, 1]
    assert "decision.fleet_warm_fallbacks" not in solver.counters
    assert solver.engine.counters["device.engine.affected_passes"] > 0


def test_dest_change_blocks_warm():
    pair = Pair()
    cache, jcache = _caches()
    dests = pair.dests()
    _views(pair, cache, jcache, dests)
    pair.set_node(0, metric=_metric(5, 1))
    v2, jv2 = _views(pair, cache, jcache, dests[:-1])
    assert not v2.warm and v2.warm_mode is None
    _assert_matches_reference(v2, jv2)


def test_ell_fallback_never_warms():
    """An improvement-only change on the (unbanded) square: the gate
    passes, but the ELL path cold-starts, and its sweep count lands in
    the cold hints, as in the reference."""
    pair = Pair(square_dbs(), prefixes=(("4", PFX),))
    cache, jcache = _caches()
    _views(pair, cache, jcache)
    pair.set(
        adj_dbs({"1": [adj("1", "2", metric=5), adj("1", "3")]},
                labels={"1": 101})[0]
    )
    v2, jv2 = _views(pair, cache, jcache)
    assert v2._runner.bg is None and not v2.warm
    _assert_matches_reference(v2, jv2)
    key = (v2.csr.n_nodes, v2.csr.n_edges)
    assert key not in cache._warm_hints
    assert cache._hints == jcache._hints and cache._hints[key] == v2.sweep_hint


def test_ell_fallback_link_down_stays_cold_and_correct():
    pair = Pair(square_dbs(), prefixes=(("4", PFX),))
    cache, jcache = _caches()
    _views(pair, cache, jcache)
    pair.set(adj_dbs({"1": [adj("1", "2")]}, labels={"1": 101})[0])
    v2, jv2 = _views(pair, cache, jcache)
    assert not v2.warm and v2.warm_mode is None and not v2.cold_fallback
    _assert_matches_reference(v2, jv2)


def _mask_inputs(pair, mutate):
    """Previous views of both packages and the worsened masks of
    `mutate`, computed by each package's own `_worsened_masks`."""
    cache, jcache = _caches()
    prev, jprev = _views(pair, cache, jcache)
    mutate(pair)
    new = fleet.FleetRouteView(
        CsrTopology.from_link_state(pair.ls), pair.dests(), prev._engine
    )
    jnew = jfleet.FleetRouteView(JCsr.from_link_state(pair.jls), pair.dests())
    masks = fleet._worsened_masks(
        prev, new._edge_keys, new._edge_met, new._overloaded
    )
    jmasks = jfleet._worsened_masks(
        jprev, jnew._edge_keys, jnew._edge_met, jnew._overloaded
    )
    for m, jm in zip(masks, jmasks):
        np.testing.assert_array_equal(m, jm)
    return prev, jprev, masks


@pytest.mark.parametrize("max_iters", [1, 3, 128])
def test_affected_mask_equals_reference(max_iters):
    prev, jprev, (wr, wb) = _mask_inputs(
        Pair(), lambda p: (p.set_node(0, drop=1), p.set_node(30, drop=2))
    )
    runner, jrunner = prev._runner, jprev._runner
    aff, done, passes = affected_mask(
        prev._dist_dev, runner.bg, runner.call_arrays(),
        torch.from_numpy(wr), torch.from_numpy(wb), max_iters=max_iters,
    )
    _, _, r_met, r_up, r_ov = jrunner.call_arrays()
    jaff, jdone = jbanded.affected_mask(
        jprev._dist_dev, jrunner.bg, r_up, r_met, r_ov,
        jnp.asarray(wr), jnp.asarray(wb),
        small_dist=jprev._dist_dev.dtype == jnp.uint16, max_iters=max_iters,
    )
    np.testing.assert_array_equal(aff.numpy(), np.asarray(jaff))
    assert done == bool(jdone)
    assert passes <= max_iters
    if max_iters == 1:
        assert not done and aff.any()
    if max_iters == 128:
        assert done


def test_uncertified_affected_set_goes_cold(monkeypatch):
    """A pass budget too small to certify: both packages cold-start; the
    port marks the view `cold_fallback` and its solver counts it."""
    monkeypatch.setattr(fleet, "AFFECTED_MAX_ITERS", 1)
    reference = jbanded.affected_mask

    def one_pass(*args, **kwargs):
        return reference(*args, **{**kwargs, "max_iters": 1})

    monkeypatch.setattr(jbanded, "affected_mask", one_pass)
    warm = _rebuild(lambda p: p.set_node(0, drop=1))
    assert not warm.warm and warm.warm_mode is None and warm.cold_fallback
    assert warm.affected_passes == 1

    pair = Pair()
    solver = SpfSolver(_name(0), device="cpu")
    solver.fleet_route_dbs({"0": pair.ls}, pair.ps, nodes=[_name(0)])
    pair.set_node(0, drop=1)
    solver.fleet_route_dbs({"0": pair.ls}, pair.ps, nodes=[_name(0)])
    assert solver.counters["decision.fleet_warm_fallbacks"] == 1
    assert solver.counters["decision.fleet_rebuild_cold"] == 2


def test_unconverged_warm_relax_reruns_cold(monkeypatch):
    """A warm relax that ends without its certificate (here: its verdict
    forced False) is not served: the view re-runs cold, equal to a cold
    view, and is marked `cold_fallback`."""
    product = fleet.asrc.reduced_all_sources

    def warm_fails(*args, init_dist=None, **kwargs):
        dist, bitmap, ok = product(*args, init_dist=init_dist, **kwargs)
        return dist, bitmap, ok and init_dist is None

    pair = Pair()
    cache = fleet.FleetViewCache()
    cache.view(pair.ls, pair.dests(), device="cpu")
    monkeypatch.setattr(fleet.asrc, "reduced_all_sources", warm_fails)
    pair.set_node(0, drop=1)
    view = cache.view(pair.ls, pair.dests(), device="cpu")
    assert view.cold_fallback and not view.warm and view.warm_mode is None
    cold = fleet.FleetViewCache().view(pair.ls, pair.dests(), device="cpu")
    _assert_same(view, cold)
    assert view.sweep_hint == cold.sweep_hint


@pytest.mark.cuda
def test_warm_rebuilds_on_card_equal_cpu():
    """A worsening and then an improving warm rebuild on the card equal
    the port's CPU views of the same sequence (runs with `-m cuda` on a
    machine with a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    views = {}
    for device in ("cpu", "cuda"):
        pair = Pair()
        cache = fleet.FleetViewCache()
        cache.view(pair.ls, pair.dests(), device=device)
        pair.set_node(0, drop=1)
        down = cache.view(pair.ls, pair.dests(), device=device)
        pair.set_node(0)
        up = cache.view(pair.ls, pair.dests(), device=device)
        views[device] = (down, up)
    for cpu_view, card_view, mode in zip(
        views["cpu"], views["cuda"], ("worsen", "improve")
    ):
        assert cpu_view.warm_mode == card_view.warm_mode == mode
        assert torch.equal(cpu_view._dist_dev, card_view._dist_dev.cpu())
        assert torch.equal(cpu_view._bitmap_dev, card_view._bitmap_dev.cpu())
