"""The port's traffic engineering (openr_tpu_torch.te) against
`openr_tpu.te`, on the CPU.

The same inputs (the topologies of tests/test_te.py, demand drawn from
a seeded numpy RandomState) go through both packages.  Tolerances:

- `push_loads`, `ExactEvaluator.distances` and `.evaluate` are integer
  products and host float64 pushes: equal bit for bit.
- `soft_sssp` (tau in 1.0, 0.5, 0.1, 0.02), `soft_objective_value` and
  one `te_descent_step` (objective, gradient, metric', m, v) agree at
  rtol=1e-4, atol=1e-4; the gradient is exactly 0 on padding edges.
  float32 sums run in another order (`index_add` against XLA's
  `segment_sum`), so bit equality is not expected.
- `TeOptimizer.optimize` on the diamond and the chain: equal TeResults
  (metrics, objectives, improved, accepted, rejected), publications and
  counters (`te.optimize_us`, a wall time, apart).
- On the 192-node WAN each anneal stage's rounded candidate is equal, or
  every edge where the two differ has a float metric within 1e-3 of
  k + 0.5 in both packages (a rounding tie that float noise decides);
  after such a tie the two runs start the next stage from different
  points, so the comparison stops there.

A difference beyond these tolerances is a fault of the port.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openr_tpu.te.optimizer as jopt
import openr_tpu_torch.te.optimizer as popt
from benchmarks import synthetic as syn
from openr_tpu.device.engine import EpochMismatchError as JEpochMismatchError
from openr_tpu.te import TE_COUNTER_KEYS as J_TE_COUNTER_KEYS
from openr_tpu.te import TeOptimizer as JTeOptimizer
from openr_tpu.te import TeProblem as JTeProblem
from openr_tpu.te import soft as jsoft
from openr_tpu.te.exact import ExactEvaluator as JExactEvaluator
from openr_tpu.te.exact import push_loads as j_push_loads
from openr_tpu_torch.device.engine import DeviceResidencyEngine, EpochMismatchError
from openr_tpu_torch.te import TE_COUNTER_KEYS, TeOptimizer, TeProblem, hill_climb
from openr_tpu_torch.te import soft
from openr_tpu_torch.te.exact import ExactEvaluator, push_loads

RTOL = ATOL = 1e-4
TIE = 1e-3
SWEEPS = 16


def _ring(n: int = 12):
    links = np.array([[i, (i + 1) % n] for i in range(n)])
    return syn.Topology.from_links("ring", n, links, np.tile([1, 1], (n, 1)))


def _diamond():
    links = np.array([[0, 1], [1, 3], [0, 2], [2, 3]])
    mets = np.array([[1, 1], [1, 1], [2, 2], [2, 2]])
    return syn.Topology.from_links("diamond", 4, links, mets)


def _chain():
    links = np.array([[0, 1], [1, 2]])
    return syn.Topology.from_links("chain", 3, links, np.array([[1, 1], [1, 1]]))


def _wan():
    return syn.wan(n_nodes=192, chords=2, seed=7)


# name -> (topology, destinations, {(source, column): volume} or None for
# a seeded uniform demand on every node)
CASES = {
    "ring": (_ring, [0, 6], {(1, 0): 1.0, (2, 1): 1.0}),
    "grid": (lambda: syn.grid(4), [0, 15], {(1, 0): 1.0, (2, 1): 1.0}),
    "fattree": (lambda: syn.fat_tree(2, 2, 2, 2), [0, 1], {(1, 0): 1.0, (2, 1): 1.0}),
    "diamond": (_diamond, [3], {(0, 0): 8.0}),
    "chain": (_chain, [2], {(0, 0): 5.0}),
    "wan192": (_wan, [3, 90], None),
    # node 4 (next to destination 3) drained: a relay no more, still a destination's endpoint
    "wan192_drained": (_wan, [3, 90], None),
}


def problems(name, hi=16):
    """(reference TeProblem, port TeProblem) over the same arrays."""
    make, dests, pairs = CASES[name]
    topo = make()
    if name.endswith("_drained"):
        topo.node_overloaded[4] = True
    dests = np.asarray(dests, dtype=np.int32)
    dm = np.zeros((topo.node_capacity, len(dests)), dtype=np.float32)
    if pairs is None:
        rng = np.random.RandomState(7)
        dm[: topo.n_nodes] = rng.uniform(
            0.0, 1.0, size=(topo.n_nodes, len(dests))
        ).astype(np.float32)
    else:
        for (s, j), v in pairs.items():
            dm[s, j] = v
    return (
        JTeProblem.from_topology(topo, dests, dm, metric_hi=hi),
        TeProblem.from_topology(topo, dests, dm, metric_hi=hi),
    )


def evaluators(jp, pp, engine=None):
    def args(p):
        return (
            p.edge_src, p.edge_dst, p.edge_up, p.node_overloaded, p.n_edges,
            p.n_nodes, p.dest_ids, p.demand, p.capacity,
        )

    return (
        JExactEvaluator(*args(jp)),
        ExactEvaluator(*args(pp), engine=engine, device="cpu"),
    )


def random_metrics(p, seed):
    """Integer metrics 1..16 on up edges, 1 on padding."""
    rng = np.random.RandomState(seed)
    m = rng.randint(1, 17, size=len(p.edge_src)).astype(np.int32)
    return np.where(p.edge_up, m, 1).astype(np.int32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_exact_distances_push_and_objective_bit_equal(name):
    jp, pp = problems(name)
    jev, pev = evaluators(jp, pp)
    if name.startswith("wan192"):
        # N >= 64 with ring-ordered ids: the reversed graph has bands,
        # so the product runs the banded relax and its K1 epilogue
        assert pev._rev_banded is not None
    for metric in (pp.edge_metric, random_metrics(pp, 3)):
        want = jev.distances(metric)
        got = pev.distances(metric)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            push_loads(
                got, pp.edge_src, pp.edge_dst, metric, pp.edge_up,
                pp.node_overloaded, pp.n_edges, pp.demand,
            ),
            j_push_loads(
                want, jp.edge_src, jp.edge_dst, metric, jp.edge_up,
                jp.node_overloaded, jp.n_edges, jp.demand,
            ),
        )
        assert pev.evaluate(metric) == jev.evaluate(metric)
        assert set(pev.last_ms) == {"tables", "product", "push"}


def _jax_args(p):
    return (
        jnp.asarray(p.edge_src), jnp.asarray(p.edge_dst),
        jnp.asarray(p.edge_up), jnp.asarray(p.node_overloaded),
        jnp.asarray(p.dest_ids),
        jnp.asarray(p.demand, dtype=jnp.float32),
        jnp.asarray(p.capacity, dtype=jnp.float32),
    )


def _torch_args(p):
    t = torch.from_numpy
    return (
        t(p.edge_src).long(), t(p.edge_dst).long(), t(p.edge_up),
        t(p.node_overloaded), t(p.dest_ids).long(),
        t(np.asarray(p.demand, dtype=np.float32)),
        t(np.asarray(p.capacity, dtype=np.float32)),
    )


@pytest.mark.parametrize("tau", [1.0, 0.5, 0.1, 0.02])
@pytest.mark.parametrize("name", ["ring", "grid", "fattree", "wan192", "wan192_drained"])
def test_soft_sssp_matches_reference(name, tau):
    jp, pp = problems(name)
    js, jd, ju, jo, jdest, *_ = _jax_args(jp)
    ts, td, tu, to, tdest, *_ = _torch_args(pp)
    want = np.asarray(
        jsoft.soft_sssp(
            js, jd, jnp.asarray(jp.edge_metric, dtype=jnp.float32), ju, jo,
            jdest, np.float32(tau), n_sweeps=SWEEPS,
        )
    )
    got = soft.soft_sssp(
        ts, td, torch.from_numpy(pp.edge_metric.astype(np.float32)), tu, to,
        tdest, np.float32(tau), n_sweeps=SWEEPS,
    )
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["diamond", "wan192", "wan192_drained"])
def test_soft_objective_value_matches_reference(name):
    jp, pp = problems(name)
    for metric in (pp.edge_metric, random_metrics(pp, 5)):
        want = jsoft.soft_objective_value(
            jnp.asarray(metric, dtype=jnp.float32), *_jax_args(jp),
            np.float32(0.1), np.float32(0.1),
            n_sweeps=SWEEPS, flow_sweeps=SWEEPS,
        )
        got = soft.soft_objective_value(
            torch.from_numpy(metric.astype(np.float32)), *_torch_args(pp),
            np.float32(0.1), np.float32(0.1),
            n_sweeps=SWEEPS, flow_sweeps=SWEEPS,
        )
        np.testing.assert_allclose(
            float(got), float(want), rtol=RTOL, atol=ATOL
        )


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("name", ["diamond", "wan192", "wan192_drained"])
def test_descent_step_matches_reference(name, t):
    """One projected-Adam step from seeded moments: objective, gradient
    (the reference's through jax.grad), metric', m and v."""
    jp, pp = problems(name, hi=64)
    rng = np.random.RandomState(11)
    e_cap = len(pp.edge_src)
    metric = (pp.edge_metric + rng.uniform(-0.4, 0.4, e_cap)).astype(np.float32)
    m0 = (rng.standard_normal(e_cap) * 0.1 * (t > 1)).astype(np.float32)
    v0 = (rng.uniform(0, 0.01, e_cap) * (t > 1)).astype(np.float32)
    scalars = tuple(np.float32(x) for x in (0.5, 0.1, 0.75, 1.0, 64.0))
    kw = dict(n_sweeps=SWEEPS, flow_sweeps=SWEEPS)
    jargs = _jax_args(jp)
    want = jsoft.te_descent_step(
        jnp.asarray(metric), jnp.asarray(m0), jnp.asarray(v0), np.float32(t),
        *jargs, *scalars, **kw,
    )
    want_grad = jax.grad(
        lambda x: jsoft.soft_objective_value(
            x, *jargs, scalars[0], scalars[1], **kw
        )
    )(jnp.asarray(metric))
    want_grad = np.where(pp.edge_up, np.asarray(want_grad), 0.0)
    got = soft.te_descent_step(
        torch.from_numpy(metric), torch.from_numpy(m0), torch.from_numpy(v0),
        np.float32(t), *_torch_args(pp), *scalars, return_grad=True, **kw,
    )
    for g, w in zip(got, (*want, want_grad)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL
        )
    grad = got[-1].numpy()
    assert np.isfinite(grad).all()
    assert (grad[~pp.edge_up] == 0.0).all()
    assert np.abs(grad[: pp.n_edges]).max() > 0.0


def _optimize(opt, problem, **kw):
    published = []
    res = opt.optimize(
        problem, publish=lambda m, o: published.append((m.tolist(), o)), **kw
    )
    counters = opt.get_counters()
    counters.pop("te.optimize_us")
    return (
        res.metrics.tolist(), res.objective_before, res.objective_after,
        res.improved, res.steps, res.round_trips, res.accepted,
        res.rejected, res.changed_edges, published, counters,
    )


@pytest.mark.parametrize(
    "name, kw",
    [
        ("diamond", dict(steps=36, round_trips=3)),
        ("chain", dict(steps=12, round_trips=2)),
    ],
)
def test_optimize_equals_reference(name, kw):
    jp, pp = problems(name, hi=8)
    kw = dict(kw, n_sweeps=8, flow_sweeps=8)
    want = _optimize(JTeOptimizer(), jp, **kw)
    got = _optimize(TeOptimizer(device="cpu"), pp, **kw)
    assert got == want
    if name == "diamond":
        assert got[3] and got[6] >= 1 and len(got[9]) == 1
    else:
        assert not got[3] and got[6] == 0 and got[9] == []


def _record_stages(monkeypatch, module):
    """Record (float metrics, rounded candidate) of every anneal stage."""
    stages = []
    clip_int = module._clip_int

    def recording(metric_f, problem):
        cand = clip_int(metric_f, problem)
        if isinstance(metric_f, torch.Tensor):
            metric_f = metric_f.cpu()
        f = np.asarray(metric_f)
        if f.dtype == np.float32:  # a stage (the baseline is float64)
            stages.append((f, cand))
        return cand

    monkeypatch.setattr(module, "_clip_int", recording)
    return stages


def test_wan192_stage_candidates_equal_or_tied(monkeypatch):
    jp, pp = problems("wan192", hi=64)
    kw = dict(steps=8, round_trips=2, n_sweeps=24, flow_sweeps=24)
    jstages = _record_stages(monkeypatch, jopt)
    pstages = _record_stages(monkeypatch, popt)
    want = JTeOptimizer().optimize(jp, **kw)
    got = TeOptimizer(device="cpu").optimize(pp, **kw)
    assert len(jstages) == len(pstages) == 2
    for (jf, jc), (pf, pc) in zip(jstages, pstages):
        np.testing.assert_allclose(pf, jf, rtol=RTOL, atol=ATOL)
        diff = np.flatnonzero(jc != pc)
        if not len(diff):
            continue
        for f in (jf, pf):
            frac = np.abs(f[diff] - np.floor(f[diff]) - 0.5)
            assert (frac <= TIE).all(), (diff, jf[diff], pf[diff])
        return  # a tie: the runs leave the same trajectory here
    assert got.metrics.tolist() == want.metrics.tolist()
    assert (got.objective_before, got.objective_after) == (
        want.objective_before, want.objective_after,
    )


def _flap_after(n):
    calls = {"n": 0}

    def epoch_fn():
        calls["n"] += 1
        return 5 if calls["n"] <= n else 6

    return epoch_fn


@pytest.mark.parametrize("package", ["port", "reference"])
def test_epoch_flip_aborts_without_publication(package):
    jp, pp = problems("diamond", hi=8)
    opt, problem, err = (
        (TeOptimizer(device="cpu"), pp, EpochMismatchError)
        if package == "port"
        else (JTeOptimizer(), jp, JEpochMismatchError)
    )
    published = []
    with pytest.raises(err) as ei:
        opt.optimize(
            problem, steps=12, round_trips=2, n_sweeps=8, flow_sweeps=8,
            epoch_fn=_flap_after(3), expect_epoch=5,
            publish=lambda m, o: published.append(m),
        )
    assert (ei.value.expected, ei.value.actual) == (5, 6)
    assert published == []
    counters = opt.get_counters()
    assert counters["te.aborted"] == 1
    # the baseline check and two steps ran before the flap
    assert counters["te.steps"] == 2


def test_counter_keys_equal_reference():
    assert TE_COUNTER_KEYS == J_TE_COUNTER_KEYS
    assert TeOptimizer(device="cpu").get_counters() == dict.fromkeys(
        TE_COUNTER_KEYS, 0
    )


def test_engine_dispatches_and_times_every_step_and_evaluation():
    """With an engine, each descent step is a `te_step` dispatch and each
    exact evaluation a `te_exact` dispatch, all timed into
    device.engine.dispatch_us; CPU tensors launch no kernel."""
    _, pp = problems("wan192", hi=16)
    engine = DeviceResidencyEngine("cpu")
    ops = []
    dispatch = engine.dispatch

    def recording(op, fn, *args, **kwargs):
        ops.append(op)
        return dispatch(op, fn, *args, **kwargs)

    engine.dispatch = recording
    res = TeOptimizer(engine=engine).optimize(
        pp, steps=4, round_trips=2, n_sweeps=8, flow_sweeps=8
    )
    assert ops.count("te_step") == res.steps == 4
    assert ops.count("te_exact") == res.round_trips == 3
    c = engine.get_counters()
    assert c["device.engine.dispatches"] == 7
    assert c["device.engine.dispatch_us"] > 0
    assert c["device.engine.kernel_launches"] == 0
    _, obj, evals = hill_climb(pp, rounds=3, seed=1, engine=engine)
    assert c["device.engine.dispatches"] + evals == engine.counters[
        "device.engine.dispatches"
    ]
    assert obj <= res.objective_before


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pp = problems("diamond")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TeOptimizer()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ExactEvaluator(
            pp.edge_src, pp.edge_dst, pp.edge_up, pp.node_overloaded,
            pp.n_edges, pp.n_nodes, pp.dest_ids, pp.demand, pp.capacity,
        )


@pytest.mark.cuda
def test_descent_step_and_exact_evaluation_on_card_equal_cpu():
    """One te_descent_step and one ExactEvaluator.evaluate on the card
    against the port's CPU run (runs with `-m cuda` on a CUDA machine):
    the step at the module's tolerance, the evaluation bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, pp = problems("wan192", hi=16)
    metric = pp.edge_metric.astype(np.float32)
    zeros = np.zeros_like(metric)
    scalars = tuple(np.float32(x) for x in (0.5, 0.1, 0.75, 1.0, 16.0))
    kw = dict(n_sweeps=SWEEPS, flow_sweeps=SWEEPS, return_grad=True)
    outs = {}
    for dev in ("cpu", "cuda"):
        args = [t.to(dev) for t in _torch_args(pp)]
        state = [torch.from_numpy(a).to(dev) for a in (metric, zeros, zeros)]
        outs[dev] = [
            t.cpu().numpy()
            for t in soft.te_descent_step(
                *state, np.float32(1), *args, *scalars, **kw
            )
        ]
    for g, w in zip(outs["cuda"], outs["cpu"]):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    engine = DeviceResidencyEngine("cuda")
    cpu_ev = evaluators(*problems("wan192", hi=16))[1]
    card_ev = ExactEvaluator(
        pp.edge_src, pp.edge_dst, pp.edge_up, pp.node_overloaded,
        pp.n_edges, pp.n_nodes, pp.dest_ids, pp.demand, pp.capacity,
        engine=engine,
    )
    metric = random_metrics(pp, 3)
    np.testing.assert_array_equal(
        card_ev.distances(metric), cpu_ev.distances(metric)
    )
    assert card_ev.evaluate(metric) == cpu_ev.evaluate(metric)
    assert engine.counters["device.engine.kernel_launches.fused_epilogue.uint16"] == 2
