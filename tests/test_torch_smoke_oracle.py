"""`chip_smoke.ScipySpf`, the smoke's host oracle, against the port's
`LinkState.run_spf`, on the CPU.

The chip smoke checks its route builds, prefetches and served paths
against `ls.get_spf_result`; `prime_spf` fills that cache from
scipy's Dijkstra instead of the interpreter's heap Dijkstra.  The
results must be the same objects' worth: per node the metric, the
`path_links` list in order (the tail's pop order, then its sorted
links) and the `next_hops` set, with the nodes in pop order.  Seeded
topologies from `openr_tpu_torch.utils.topo` and hand-made ones cover
drained nodes (a drained source too), links down, parallel links,
asymmetric metrics, hop counts (`use_link_metric=False`), ignored
links (the TI-LFA check's `links_to_ignore`) and unreachable nodes.  Results are integers: no tolerance.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import chip_smoke
from openr_tpu_torch.decision.link_state import LinkState
from openr_tpu_torch.utils import topo
from torch_parity import adj, adj_dbs, overload


def linkstate(dbs) -> LinkState:
    ls = LinkState()
    for db in dbs:
        ls.update_adjacency_database(db)
    return ls


def wan_drained(n: int, seed: int, k: int):
    dbs = topo.wan_topology(n, chords=2, seed=seed)
    for i in np.random.default_rng(seed).choice(n, size=k, replace=False):
        overload(dbs, int(i))
    return dbs


def metric_mix(dbs, seed: int):
    """Each adjacency a seeded metric in 1..4 (asymmetric: each side
    draws its own), so equal-cost ties are many."""
    rng = np.random.default_rng(seed)
    for db in dbs:
        for a in db.adjacencies:
            a.metric = int(rng.integers(1, 5))
    return dbs


def parallel_and_down():
    """Two parallel links a-b (ifaces 1 and 2), a link down (c lists d,
    d does not list c), a drained transit node e and an island f-g."""
    def link(me, other, iface, metric):
        return dataclasses.replace(
            adj(me, other, metric), if_name=f"{me}/{iface}", other_if_name=f"{other}/{iface}"
        )

    return adj_dbs(
        {
            "a": [link("a", "b", 1, 2), link("a", "b", 2, 2), adj("a", "c", 1)],
            "b": [link("b", "a", 1, 2), link("b", "a", 2, 2), adj("b", "e", 1)],
            "c": [adj("c", "a", 1), adj("c", "d", 1), adj("c", "e", 3)],
            "d": [adj("d", "e", 1)],
            "e": [adj("e", "b", 1), adj("e", "c", 3), adj("e", "d", 1)],
            "f": [adj("f", "g", 1)],
            "g": [adj("g", "f", 1)],
        },
        overloaded={"e"},
    )


CASES = {
    "grid12": lambda: topo.grid_topology(12),
    "grid9_mixed": lambda: metric_mix(topo.grid_topology(9), 3),
    "ring65_drained": lambda: overload(topo.ring_topology(65), 7),
    "wan400": lambda: topo.wan_topology(400, chords=2, seed=0),
    "wan300_drained": lambda: wan_drained(300, 5, 6),
    "wan300_mixed_drained": lambda: metric_mix(wan_drained(300, 8, 4), 8),
    "hub": lambda: topo.hub_topology(labeled=[0, 5, 32]),
    "fat_tree": lambda: topo.fat_tree_topology(4),
    "parallel_and_down": parallel_and_down,
}


def as_lists(result) -> list:
    """A SpfResult as values, in its insertion (pop) order."""
    return [
        (node, r.metric, [(link, prev) for link, prev in r.path_links], sorted(r.next_hops))
        for node, r in result.items()
    ]


def sources_of(ls, n: int = 6) -> list[str]:
    names = ls.node_names
    picks = {names[0], names[-1]} | {names[i] for i in np.linspace(0, len(names) - 1, n).astype(int)}
    picks |= {v for v in names if ls.is_node_overloaded(v)}
    return sorted(picks)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("use_link_metric", [True, False])
def test_results_equal_run_spf(case, use_link_metric):
    ls = linkstate(CASES[case]())
    oracle = chip_smoke.ScipySpf(ls)
    for src in sources_of(ls):
        want = ls.run_spf(src, use_link_metric=use_link_metric)
        got = oracle.run_spf(src, use_link_metric=use_link_metric)
        assert as_lists(got) == as_lists(want), (case, src)


@pytest.mark.parametrize("case", ["wan300_drained", "parallel_and_down", "grid9_mixed"])
def test_results_with_links_ignored_equal_run_spf(case):
    """The TI-LFA check's form: one or two of the source's links ignored."""
    ls = linkstate(CASES[case]())
    oracle = chip_smoke.ScipySpf(ls)
    for src in sources_of(ls, 3):
        links = sorted(ls.links_from_node(src))
        for ignore in ({links[0]}, set(links[:2])) if links else ():
            want = ls.run_spf(src, links_to_ignore=ignore)
            got = oracle.run_spf(src, links_to_ignore=ignore)
            assert as_lists(got) == as_lists(want), (case, src, ignore)


def test_the_hand_made_case_has_what_it_claims():
    ls = linkstate(parallel_and_down())
    a = ls.run_spf("a")
    assert len(a["b"].path_links) == 2  # the parallel links
    assert "f" not in a  # the island
    # c - d is down (d does not list c), so d's one up path is through
    # the drained e, which carries no transit
    assert ls.is_node_overloaded("e") and "e" in a and "d" not in a
    e = ls.run_spf("e")
    assert e["d"].metric == 1  # a drained source relaxes


def test_prime_fills_the_cache_the_checks_read():
    ls = linkstate(wan_drained(300, 2, 3))
    names = ls.node_names
    cached = names[0]
    ls.get_spf_result(cached)
    primed = chip_smoke.prime_spf(ls, [cached, names[10], names[20]])
    assert primed == [names[10], names[20]]
    assert chip_smoke.prime_spf(ls, [cached, names[10]]) == []
    for s in (names[10], names[20]):
        assert as_lists(ls.get_spf_result(s)) == as_lists(ls.run_spf(s))
    # the smoke's expected routes read the primed results
    adv = names[::7]
    prefixes = [f"fc00::{i:x}/64" for i in range(len(adv))]
    labels = [16 + i for i in range(len(adv))]
    want = chip_smoke.expected_routes(linkstate(wan_drained(300, 2, 3)), names[10], adv,
                                      prefixes, labels)
    assert chip_smoke.expected_routes(ls, names[10], adv, prefixes, labels) == want


def test_a_moved_link_state_is_refused():
    dbs = topo.grid_topology(4)
    ls = linkstate(dbs)
    oracle = chip_smoke.ScipySpf(ls)
    dbs[0].adjacencies[0].metric = 9
    ls.update_adjacency_database(dbs[0])
    with pytest.raises(AssertionError, match="moved"):
        oracle.run_spf(ls.node_names[0])


@pytest.mark.parametrize("n,seed,rounds", [(48, 13, 3), (96, 5, 6)])
def test_router_hops_equal_run_spf_on_the_ocs_ring(n, seed, rounds):
    """`chip_smoke.router_hops`, the OCS phase's lighter oracle (one
    Dijkstra from a node and its neighbours, no DAG walk): every node's
    metric and next hops equal `run_spf`'s, on the controller's ring
    after a few rounds of seeded chord swaps, to every node and to a
    subset of destination ids."""
    import random

    from openr_tpu_torch.chaos import OcsController

    ctl = OcsController(seed=seed, n=n)
    chords = ctl._initial_chords()
    rng = random.Random(seed)
    for _ in range(rounds):
        chords.discard(rng.choice(sorted(chords)))
        chords.add(rng.choice(ctl._chord_candidates(chords)))
    ls = ctl._build_ls(chords, {5: 70})
    oracle = chip_smoke.ScipySpf(ls)
    names = oracle.names
    dest_ids = [3, 11, n // 2, n - 1]
    for src in names[:: max(1, n // 12)]:
        want = ls.run_spf(src)
        dist, hops = chip_smoke.router_hops(oracle, src)
        assert {names[v]: int(dist[v]) for v in range(n)} == {
            v: r.metric for v, r in want.items()}
        assert {names[v]: hops[v] for v in range(n)} == {
            v: r.next_hops for v, r in want.items()}
        d, h = chip_smoke.router_hops(oracle, src, dest_ids)
        assert d.tolist() == [want[names[t]].metric for t in dest_ids]
        assert h == [want[names[t]].next_hops for t in dest_ids]
