"""The port's in-place CSR mirror refresh against openr_tpu's.

Every case drives one port and one openr_tpu LinkState through the same
adjacency-database changes and refreshes both packages' CsrTopology
after each step: the return values must be equal, and so must the edge
arrays, the freelist (`edge_live`, `n_live`, `_free_slots`), `out_slot`,
`n_edges`, `max_out_slots`, `rewire_seq`, the link of every edge slot,
every ELL bucket and every logged RewireDelta — bit for bit.  The cases
are tests/test_csr_refresh.py::TestCsrRefresh's and the rewire schedule,
capacity overflow and log gap of tests/test_device_engine.py::
TestOcsRewireAcceptance; the host Dijkstra of the port checks the
mirror's SPF results after each step.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

from openr_tpu.decision.csr import CsrTopology as JCsr
from openr_tpu_torch.decision.csr import CsrTopology
from openr_tpu_torch.device.engine import DeviceResidencyEngine
from openr_tpu_torch.types import Adjacency, AdjacencyDatabase
from openr_tpu_torch.utils import topo

from torch_parity import LinkStatePair, spf_key

MIRROR_ARRAYS = (
    "edge_src",
    "edge_dst",
    "edge_metric",
    "edge_up",
    "edge_live",
    "node_overloaded",
    "out_slot",
)
MIRROR_SCALARS = (
    "node_names",
    "n_nodes",
    "node_capacity",
    "edge_capacity",
    "n_edges",
    "n_live",
    "max_out_slots",
    "rewire_seq",
    "_free_slots",
)
DELTA_ARRAYS = ("slots", "src", "dst", "metric", "up", "live", "out_idx", "out_val")
DELTA_SCALARS = ("seq", "n_edges", "max_out_slots", "links_added", "links_removed")


def adj(me, other, metric=1, overloaded=False):
    """tests/test_link_state.py's `adj` with the port's types."""
    return Adjacency(
        other_node_name=other,
        if_name=f"if_{me}_{other}",
        other_if_name=f"if_{other}_{me}",
        metric=metric,
        is_overloaded=overloaded,
    )


def adj_db(node, adjs, overloaded=False):
    return AdjacencyDatabase(
        this_node_name=node, adjacencies=adjs, is_overloaded=overloaded, area="0"
    )


def square():
    return [
        adj_db("a", [adj("a", "b"), adj("a", "c")]),
        adj_db("b", [adj("b", "a"), adj("b", "d")]),
        adj_db("c", [adj("c", "a"), adj("c", "d")]),
        adj_db("d", [adj("d", "b"), adj("d", "c")]),
    ]


def assert_mirrors_equal(csr, jcsr) -> None:
    for name in MIRROR_SCALARS:
        assert getattr(csr, name) == getattr(jcsr, name), name
    for name in MIRROR_ARRAYS:
        np.testing.assert_array_equal(
            getattr(csr, name), np.asarray(getattr(jcsr, name)), err_msg=name
        )
    assert [
        None if lp is None else (lp[0].ordered_names, lp[1])
        for lp in csr.edge_links
    ] == [
        None if lp is None else (lp[0].ordered_names, lp[1])
        for lp in jcsr.edge_links
    ]
    ell, jell = csr.ell, jcsr.ell
    np.testing.assert_array_equal(ell.new_of_old, np.asarray(jell.new_of_old))
    np.testing.assert_array_equal(ell.old_of_new, np.asarray(jell.old_of_new))
    assert len(ell.buckets) == len(jell.buckets)
    for bk, jbk in zip(ell.buckets, jell.buckets):
        for a, b in zip(bk, jbk):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert len(csr._rewire_log) == len(jcsr._rewire_log)
    for d, jd in zip(csr._rewire_log, jcsr._rewire_log):
        for name in DELTA_SCALARS:
            assert getattr(d, name) == getattr(jd, name), name
        for name in DELTA_ARRAYS:
            np.testing.assert_array_equal(
                getattr(d, name), getattr(jd, name), err_msg=name
            )
        assert len(d.ell_rows) == len(jd.ell_rows)
        for row, jrow in zip(d.ell_rows, jd.ell_rows):
            assert row[:2] == jrow[:2]
            for a, b in zip(row[2:], jrow[2:]):
                np.testing.assert_array_equal(a, b)


class Mirrors:
    """Both packages' LinkState and CSR mirror over the same databases."""

    def __init__(self, dbs) -> None:
        self.pair = LinkStatePair(dbs)
        self.ls = self.pair.ls
        self.csr = CsrTopology.from_link_state(self.pair.ls)
        self.jcsr = JCsr.from_link_state(self.pair.jls)
        assert_mirrors_equal(self.csr, self.jcsr)

    def step(self, *dbs) -> bool:
        """Apply `dbs` to both LinkStates, refresh both mirrors, hold
        them equal and return the (equal) refresh verdict."""
        self.pair.update(*dbs)
        kept = self.csr.refresh(self.pair.ls)
        assert self.jcsr.refresh(self.pair.jls) is kept
        assert self.csr.version == self.pair.ls.version
        assert_mirrors_equal(self.csr, self.jcsr)
        return kept

    def check_oracle(self) -> None:
        """The mirror's SPF results of every node equal the host
        Dijkstra's (through a CPU engine)."""
        names = self.ls.node_names
        got = DeviceResidencyEngine("cpu").spf_results(self.csr, names)
        for src in names:
            assert spf_key(got[src]) == spf_key(self.ls.run_spf(src)), src


# -- TestCsrRefresh's cases -------------------------------------------------


def test_metric_change_updates_in_place():
    dbs = square()
    m = Mirrors(dbs)
    ell = m.csr.ell
    dbs[0].adjacencies[0].metric = 7  # a -> b
    assert m.step(dbs[0]) is True
    assert m.csr.ell is ell  # tables untouched
    m.check_oracle()


def test_overload_and_link_down_in_place():
    dbs = topo.grid_topology(4)
    m = Mirrors(dbs)
    shapes = (m.csr.node_capacity, m.csr.edge_capacity)
    victim = next(d for d in dbs if d.this_node_name == "node-1-1")
    victim.is_overloaded = True
    victim.adjacencies[0].is_overloaded = True  # one link overloaded
    assert m.step(victim) is True
    assert (m.csr.node_capacity, m.csr.edge_capacity) == shapes
    m.check_oracle()


def test_edge_set_change_rewires_at_same_shapes():
    dbs = square()
    m = Mirrors(dbs)
    ell = m.csr.ell
    dbs[1].adjacencies = [a for a in dbs[1].adjacencies if a.other_node_name != "d"]
    assert m.step(dbs[1]) is True  # bounded rewire in place
    assert m.csr.ell is ell and m.csr.rewire_seq == 1
    assert len(m.csr._free_slots) == 2  # both directed slots retired
    m.check_oracle()


def test_node_set_change_rebuilds():
    m = Mirrors(square())
    assert m.step(
        adj_db("e", [adj("e", "a")]),
        adj_db("a", [adj("a", "b"), adj("a", "c"), adj("a", "e")]),
    ) is False
    assert m.csr.rewire_seq == 0
    m.check_oracle()


def test_rewire_reuses_retired_slots():
    dbs = square()
    m = Mirrors(dbs)
    e_before = m.csr.n_edges
    dbs[1].adjacencies = [a for a in dbs[1].adjacencies if a.other_node_name != "d"]
    assert m.step(dbs[1]) is True
    assert m.step(
        adj_db("a", [adj("a", "b"), adj("a", "c"), adj("a", "d")]),
        adj_db("b", [adj("b", "a")]),
        adj_db("c", [adj("c", "a"), adj("c", "d")]),
        adj_db("d", [adj("d", "c"), adj("d", "a")]),
    ) is True
    assert m.csr.n_edges == e_before and m.csr._free_slots == []
    assert m.csr.rewire_seq == 2
    m.check_oracle()


def test_node_growth_beyond_capacity():
    m = Mirrors(square())
    n_cap = m.csr.node_capacity
    extra = [adj_db(f"x{i}", [adj(f"x{i}", "a")]) for i in range(n_cap)]
    extra_a = adj_db(
        "a",
        [adj("a", "b"), adj("a", "c")] + [adj("a", f"x{i}") for i in range(n_cap)],
    )
    assert m.step(*extra, extra_a) is False
    assert m.csr.node_capacity > n_cap
    m.check_oracle()


def test_link_removed_and_readded_with_new_metric():
    dbs = square()
    m = Mirrors(dbs)
    dbs[0].adjacencies = [a for a in dbs[0].adjacencies if a.other_node_name != "b"]
    dbs[1].adjacencies = [a for a in dbs[1].adjacencies if a.other_node_name != "a"]
    m.step(dbs[0], dbs[1])
    dbs2 = square()
    dbs2[0].adjacencies[0].metric = 5  # a -> b
    dbs2[1].adjacencies[0].metric = 5  # b -> a
    m.step(dbs2[0], dbs2[1])
    m.check_oracle()
    got = DeviceResidencyEngine("cpu").spf_results(m.csr, ["a"])["a"]
    assert got["b"].metric == 3  # a-c-d-b beats the metric-5 direct link


def test_noop_refresh():
    m = Mirrors(square())
    v = m.csr.version
    assert m.step() is True and m.csr.version == v


# -- TestOcsRewireAcceptance's rewire schedules -----------------------------

RING_N = 12


def ring_dbs(chords):
    """tests/test_device_engine.py's `_ring_dbs`: a RING_N-node ring plus
    the chord set (pairs (i, j), i < j), chord metrics 1..5."""

    def nm(i):
        return f"r{i:02d}"

    adjs = {i: [] for i in range(RING_N)}
    for i in range(RING_N):
        j = (i + 1) % RING_N
        adjs[i].append(adj(nm(i), nm(j)))
        adjs[j].append(adj(nm(j), nm(i)))
    for i, j in sorted(chords):
        m = 1 + (i * 7 + j * 3) % 5
        adjs[i].append(adj(nm(i), nm(j), metric=m))
        adjs[j].append(adj(nm(j), nm(i), metric=m))
    return [adj_db(nm(i), adjs[i]) for i in range(RING_N)]


def chord_candidates(chords):
    deg = {}
    for i, j in chords:
        deg[i] = deg.get(i, 0) + 1
        deg[j] = deg.get(j, 0) + 1
    return [
        (i, j)
        for i in range(RING_N)
        for j in range(i + 2, RING_N)
        if not (i == 0 and j == RING_N - 1)
        and (i, j) not in chords
        and deg.get(i, 0) < 2
        and deg.get(j, 0) < 2
    ]


def rewire_schedule(seed, steps):
    """TestOcsRewireAcceptance._rewire_schedule: remove / add / swap in
    rotation from the 4-chord baseline."""
    rng = random.Random(seed)
    chords = {(0, 5), (2, 8), (3, 9), (4, 10)}
    plan = [set(chords)]
    for step in range(steps):
        op = ("remove", "add", "swap")[step % 3]
        if op == "remove":
            chords.discard(rng.choice(sorted(chords)))
        elif op == "add":
            chords.add(rng.choice(chord_candidates(chords)))
        else:
            chords.discard(rng.choice(sorted(chords)))
            chords.add(rng.choice(chord_candidates(chords)))
        plan.append(set(chords))
    return plan


def test_twenty_bounded_rewires_stay_in_place():
    plan = rewire_schedule(seed=1107, steps=20)
    m = Mirrors(ring_dbs(plan[0]))
    assert m.csr.edge_capacity == 32
    for step, chords in enumerate(plan[1:]):
        assert m.step(*ring_dbs(chords)) is True, (step, chords)
        if step % 5 == 4:
            m.check_oracle()
    assert m.csr.rewire_seq == 20


def test_capacity_overflow_rebuilds():
    chords = {(0, 5), (2, 8), (3, 9), (4, 10)}
    m = Mirrors(ring_dbs(chords))
    chords |= {(1, 6), (5, 11), (2, 7), (6, 10)}
    assert m.step(*ring_dbs(chords)) is False
    assert m.csr.edge_capacity > 32
    m.check_oracle()


@pytest.mark.parametrize("depth", [4, 32])
def test_rewire_log_keeps_its_window(depth):
    plan = rewire_schedule(seed=22, steps=6)
    m = Mirrors(ring_dbs(plan[0]))
    m.csr.REWIRE_LOG_DEPTH = m.jcsr.REWIRE_LOG_DEPTH = depth
    for chords in plan[1:]:
        assert m.step(*ring_dbs(chords)) is True
    assert len(m.csr._rewire_log) == min(depth, 6)
    assert [d.seq for d in m.csr._rewire_log][-1] == 6
