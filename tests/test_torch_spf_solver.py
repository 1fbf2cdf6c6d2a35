"""The port's per-source route build against openr_tpu's.

`SpfSolver.build_route_db` with no fleet views answers per source
through the SPF backend, as the reference does.  The port's
`DeviceSpfBackend` answers every source with links on its engine, so
its cases are held against the reference backend with the dispatch
policy forced to the device (`min_device_nodes=1, min_device_sources=1`):
tests/test_spf_solver.py::TestDispatchPolicy's questions, now all on the
device, TestDeviceBackendParity's seeds and
tests/test_csr_refresh.py::TestDeviceSpfBackendV2 (on the CPU), plus
drained nodes, parallel links and min-nexthop thresholds; route DBs are
compared bit for bit.  A fleet view
built on the backend's refreshed mirror (after an attribute change, a
rewire and a rebuild) equals a cold view on a fresh mirror.
"""

from __future__ import annotations

import gc
import weakref

import pytest
import torch

from openr_tpu.decision.spf_solver import DeviceSpfBackend as JDeviceSpfBackend
from openr_tpu.decision.spf_solver import SpfSolver as JSpfSolver
from openr_tpu.utils.topo import random_topology
from openr_tpu_torch.decision import csr as csr_module
from openr_tpu_torch.decision.fleet import FleetViewCache, fleet_destinations
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.decision.spf_solver import (
    DeviceSpfBackend,
    HostSpfBackend,
    SpfSolver,
)
from openr_tpu_torch.types import Adjacency, PrefixEntry
from openr_tpu_torch.utils import topo

from torch_parity import (
    LinkStatePair,
    normalized_routes,
    prefix_states,
    spf_key,
    to_jax_entry,
    to_port_dbs,
)


def _backend(**kwargs) -> DeviceSpfBackend:
    return DeviceSpfBackend("cpu", **kwargs)


def _metrics(res) -> dict:
    return {n: r.metric for n, r in res.items()}


# -- dispatch: every source with links goes to the engine -----------------


def _grid(n_side=16):
    dbs = topo.grid_topology(n_side)
    return dbs, LinkStatePair(dbs)


def _forced_reference():
    """The reference backend with its dispatch policy forced to the device,
    the only branch the port's backend has."""
    return JDeviceSpfBackend(min_device_nodes=1, min_device_sources=1)


def test_single_question_served_by_device():
    dbs, pair = _grid()
    be, jbe = _backend(), _forced_reference()
    src = dbs[0].this_node_name
    got = be.get_spf_result(pair.ls, src)
    assert spf_key(got) == spf_key(jbe.get_spf_result(pair.jls, src))
    assert spf_key(got) == spf_key(pair.ls.run_spf(src))
    assert len(be._mirrors) == 1
    assert be.engine.get_counters()["device.engine.queries"] == 1


def test_batch_prefetch_uses_device_and_serves_singles():
    dbs, pair = _grid()
    be = _backend()
    sources = [d.this_node_name for d in dbs[:64]]
    be.prefetch(pair.ls, sources)
    assert len(be._mirrors) == 1
    assert be.engine.get_counters()["device.engine.queries"] == 1
    res = be.get_spf_result(pair.ls, sources[3])
    assert spf_key(res) == spf_key(pair.ls.run_spf(sources[3]))
    assert be.engine.get_counters()["device.engine.queries"] == 1  # cached


def test_small_batch_prefetch_is_one_device_query():
    dbs, pair = _grid()
    be, jbe = _backend(), _forced_reference()
    sources = [d.this_node_name for d in dbs[:4]]
    be.prefetch(pair.ls, sources)
    jbe.prefetch(pair.jls, sources)
    assert be.engine.get_counters()["device.engine.queries"] == 1
    for src in sources:
        assert spf_key(be.get_spf_result(pair.ls, src)) == spf_key(
            jbe.get_spf_result(pair.jls, src)
        )
    assert be.engine.get_counters()["device.engine.queries"] == 1


def test_tiny_topology_on_device():
    dbs, pair = _grid(4)  # 16 nodes: the reference's policy sends these to the host
    be = _backend()
    names = [d.this_node_name for d in dbs]
    be.prefetch(pair.ls, names)
    assert len(be._mirrors) == 1
    for src in names:
        assert spf_key(be.get_spf_result(pair.ls, src)) == spf_key(pair.ls.run_spf(src))


def test_resident_graph_takes_single_questions():
    dbs, pair = _grid()
    be = _backend()
    be.prefetch(pair.ls, [d.this_node_name for d in dbs[:64]])
    src = dbs[100].this_node_name
    assert spf_key(be.get_spf_result(pair.ls, src)) == spf_key(pair.ls.run_spf(src))
    c = be.engine.get_counters()
    assert c["device.engine.queries"] == 2 and c["device.engine.full_restages"] == 1


def test_isolated_source_answered_without_the_engine():
    """A source with no links gets the host's self-only result, as in the
    reference; nothing is staged for it."""
    _, pair = _grid(4)
    be = _backend()
    got = be.get_spf_result(pair.ls, "nowhere")
    assert spf_key(got) == spf_key(_forced_reference().get_spf_result(pair.jls, "nowhere"))
    assert len(be._mirrors) == 0
    assert be.engine.get_counters()["device.engine.queries"] == 0


def test_host_backend_keeps_no_mirror():
    _, pair = _grid(4)
    host = HostSpfBackend()
    assert host.engine is None and host.csr_mirror(pair.ls) is None
    assert isinstance(_backend().csr_mirror(pair.ls), csr_module.CsrTopology)


def test_dropped_link_state_frees_mirror_and_resident():
    """The backend keys its mirrors weakly on the LinkState and the engine
    drops a resident with its mirror, so a retired area leaves nothing on
    the device."""
    dbs, pair = _grid(4)
    be = _backend()
    be.get_spf_result(pair.ls, dbs[0].this_node_name)
    assert len(be.engine._residents) == 1
    mirror = weakref.ref(be._mirrors[pair.ls])
    del pair
    gc.collect()
    assert mirror() is None
    assert not be.engine._residents and not be._mirrors


# -- TestDeviceSpfBackendV2 -------------------------------------------------


def _random(n, extra, seed):
    return LinkStatePair(to_port_dbs(random_topology(n, extra, seed=seed))).ls


def test_lazy_and_cached():
    ls = _random(24, 30, 1)
    be = _backend()
    r1 = be.get_spf_result(ls, "n0")
    assert be._results[ls][1].keys() == {"n0"}  # only the asked source
    assert be.get_spf_result(ls, "n0") is r1
    assert _metrics(r1) == _metrics(ls.run_spf("n0"))


def test_cache_invalidated_on_version_bump():
    dbs = to_port_dbs(random_topology(24, 30, seed=1))
    pair = LinkStatePair(dbs)
    be = _backend()
    be.get_spf_result(pair.ls, "n0")
    mirror = be._mirrors[pair.ls]
    db = next(d for d in dbs if d.this_node_name == "n0")
    for a in db.adjacencies:
        a.metric = 9
    pair.update(db)
    r2 = be.get_spf_result(pair.ls, "n0")
    assert spf_key(r2) == spf_key(pair.ls.run_spf("n0"))
    # the mirror was refreshed in place, not rebuilt
    assert be._mirrors[pair.ls] is mirror and mirror.version == pair.ls.version
    c = be.engine.get_counters()
    assert c["device.engine.full_restages"] == 1
    assert c["device.engine.incremental_updates"] == 1


def test_prefetch_batches():
    ls = _random(30, 40, 4)
    be = _backend()
    be.prefetch(ls, ls.node_names)
    assert set(be._results[ls][1]) == set(ls.node_names)
    assert be.engine.get_counters()["device.engine.queries"] == 1
    for src in ls.node_names[:5]:
        assert spf_key(be.get_spf_result(ls, src)) == spf_key(ls.run_spf(src))


def test_small_topology_uses_device():
    ls = _random(4, 2, 0)
    be = _backend()
    got = be.get_spf_result(ls, "n0")
    assert ls in be._mirrors
    assert spf_key(got) == spf_key(ls.run_spf("n0"))


# -- route builds per source against the reference solver -------------------


def _parallel(dbs, a, b, metric):
    """A second link a - b with its own interfaces."""
    by_name = {db.this_node_name: db for db in dbs}
    for me, other in ((a, b), (b, a)):
        by_name[me].adjacencies.append(
            Adjacency(
                other_node_name=other,
                if_name=f"par_{me}_{other}",
                other_if_name=f"par_{other}_{me}",
                metric=metric,
            )
        )


def _parity_case(seed, variant):
    dbs = to_port_dbs(random_topology(24, 30, seed=seed))
    by_name = {db.this_node_name: db for db in dbs}
    for db in dbs:
        db.node_label = 100 + int(db.this_node_name[1:])
    if variant == "drained":
        by_name["n5"].is_overloaded = True  # an advertiser
        by_name["n2"].is_overloaded = True  # a transit node
    elif variant == "parallel":
        a = by_name["n0"].adjacencies[0]
        _parallel(dbs, "n0", a.other_node_name, a.metric)
    entries = [
        (node, PrefixEntry(prefix=f"::{i + 1}:0/112"))
        for i, node in enumerate(["n3", "n7", "n11"])
    ]
    anycast = dict(min_nexthop=2) if variant == "min_nexthop" else {}
    entries += [
        (node, PrefixEntry(prefix="::a:0/112", **anycast)) for node in ("n5", "n9")
    ]
    ps, jps = _prefix_pair(entries)
    return LinkStatePair(dbs), ps, jps


def _prefix_pair(entries):
    from openr_tpu.decision.prefix_state import PrefixState as JPrefixState

    ps, jps = PrefixState(), JPrefixState()
    for node, entry in entries:
        ps.update_prefix(node, "0", entry)
        jps.update_prefix(node, "0", to_jax_entry(entry))
    return ps, jps


@pytest.mark.parametrize("variant", ["plain", "drained", "parallel", "min_nexthop"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_route_db_per_source_equals_reference(seed, variant):
    pair, ps, jps = _parity_case(seed, variant)
    solver = SpfSolver("n0", spf_backend=_backend())
    jsolver = JSpfSolver(
        "n0",
        spf_backend=_forced_reference(),
    )
    host = SpfSolver("n0", spf_backend=HostSpfBackend())
    for me in ("n0", "n3", "n13"):
        got = solver.build_route_db({"0": pair.ls}, ps, my_node_name=me)
        want = jsolver.build_route_db({"0": pair.jls}, jps, my_node_name=me)
        assert normalized_routes(got) == normalized_routes(want), me
        assert normalized_routes(got) == normalized_routes(
            host.build_route_db({"0": pair.ls}, ps, my_node_name=me)
        ), me
    c = solver.engine.get_counters()
    assert c["device.engine.queries"] == 3 and c["device.engine.full_restages"] == 1
    assert not solver.fleet._views  # no fleet view on the per-source path


def test_default_solver_is_the_device_backend(monkeypatch):
    solver = SpfSolver("r0", device="cpu")
    assert isinstance(solver.spf, DeviceSpfBackend)
    assert solver.engine is solver.spf.engine
    assert solver.engine.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SpfSolver("r0")
    host = SpfSolver("r0", spf_backend=HostSpfBackend())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        host.engine  # a host solver's fleet engine is the card's too


def test_device_error_raises_without_host_oracle(monkeypatch):
    pair, ps, _ = _parity_case(0, "plain")
    solver = SpfSolver("n0", spf_backend=_backend())

    def fail(*args, **kwargs):
        raise RuntimeError("device query failed")

    monkeypatch.setattr(solver.engine, "spf_results", fail)
    with pytest.raises(RuntimeError, match="device query failed"):
        solver.build_route_db({"0": pair.ls}, ps)
    assert not pair.ls._spf_results  # the host Dijkstra never ran


def test_any_node_route_db_equals_reference():
    """The device backend's any-node query answers from the fleet view on
    its mirror; a host backend's per source, computing no view."""
    from openr_tpu.decision.spf_solver import HostSpfBackend as JHostSpfBackend

    dbs = topo.wan_topology(96, chords=2, seed=3, labeled=range(0, 96, 2))
    pair = LinkStatePair(dbs)
    names = pair.ls.node_names
    ps, jps = prefix_states(names, every=3)
    for backend, jbackend, with_view in (
        (HostSpfBackend(), JHostSpfBackend(), False),
        (_backend(), _forced_reference(), True),
    ):
        solver = SpfSolver(names[0], spf_backend=backend, device="cpu")
        jsolver = JSpfSolver(names[0], spf_backend=jbackend)
        for node in (names[0], names[50]):
            got = solver.any_node_route_db({"0": pair.ls}, ps, node)
            want = jsolver.any_node_route_db({"0": pair.jls}, jps, node)
            assert normalized_routes(got) == normalized_routes(want), node
        assert bool(solver.fleet._views) is with_view


# -- fleet views on the refreshed mirror ------------------------------------


def _views_equal(view, cold) -> None:
    assert view.dest_names == cold.dest_names
    assert torch.equal(view._dist_dev, cold._dist_dev)
    assert torch.equal(view._bitmap_dev, cold._bitmap_dev)


@pytest.mark.parametrize("family", ["wan96", "fat_tree3"])
def test_fleet_view_on_refreshed_mirror_equals_cold(family, monkeypatch):
    if family == "wan96":
        dbs = topo.wan_topology(96, chords=2, seed=3, labeled=range(0, 96, 3))
    else:
        dbs = topo.fat_tree_topology(3)
    pair = LinkStatePair(dbs)
    names = pair.ls.node_names
    ps, _ = prefix_states(names, every=4)
    solver = SpfSolver(names[0], device="cpu")
    area = {"0": pair.ls}
    solver.fleet_route_dbs(area, ps, nodes=names[:2])
    mirror = solver.spf.csr_mirror(pair.ls)
    by_name = {db.this_node_name: db for db in dbs}
    db = by_name[names[7]]
    dropped = db.adjacencies[0]
    changes = {
        "metric": lambda: setattr(db.adjacencies[1], "metric", 17),
        "rewire": lambda: db.adjacencies.remove(dropped),
        "restore": lambda: db.adjacencies.insert(0, dropped),
    }
    builds = []
    real = csr_module.CsrTopology.from_link_state

    def counted(*args, **kwargs):
        builds.append(args)
        return real(*args, **kwargs)

    for name, change in changes.items():
        change()
        pair.update(db)
        monkeypatch.setattr(csr_module.CsrTopology, "from_link_state", counted)
        solver.fleet_route_dbs(area, ps, nodes=names[:2])
        monkeypatch.setattr(csr_module.CsrTopology, "from_link_state", real)
        assert not builds, name  # refreshed, never rebuilt
        view = solver.fleet._views[pair.ls]
        assert view.csr is mirror and mirror.version == pair.ls.version
        cold = FleetViewCache().view(
            pair.ls, fleet_destinations(pair.ls, ps), device="cpu"
        )
        _views_equal(view, cold)
    assert mirror.rewire_seq == 2
    # a node-set change rebuilds the mirror in place: still one object
    pair.update(*topo.ring_topology(4))
    solver.fleet_route_dbs(area, ps, nodes=names[:2])
    view = solver.fleet._views[pair.ls]
    assert view.csr is mirror and mirror.n_nodes == len(pair.ls.node_names)
    _views_equal(
        view,
        FleetViewCache().view(pair.ls, fleet_destinations(pair.ls, ps), device="cpu"),
    )


def test_view_snapshot_survives_mirror_refresh():
    """A view keeps answering its own version after the mirror it was
    built on refreshes in place: node ids, overload bits and the
    bitmap's slot map are the view's copies."""
    dbs = topo.wan_topology(96, chords=2, seed=3, labeled=range(0, 96, 3))
    pair = LinkStatePair(dbs)
    names = pair.ls.node_names
    ps, _ = prefix_states(names, every=4)
    solver = SpfSolver(names[0], device="cpu")
    solver.fleet_route_dbs({"0": pair.ls}, ps, nodes=names[:1])
    old = solver.fleet._views[pair.ls]
    dests = old.dest_names
    before = {(n, d): old.next_hop_neighbors(n, d) for n in names[:6] for d in dests[:4]}
    db = dbs[3]
    db.adjacencies.pop(0)
    db.is_overloaded = True
    pair.update(db)
    solver.spf.csr_mirror(pair.ls)  # the mirror moves on
    assert old.is_overloaded_id(names[3]) is False
    assert {
        (n, d): old.next_hop_neighbors(n, d) for n in names[:6] for d in dests[:4]
    } == before
