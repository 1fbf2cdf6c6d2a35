#!/usr/bin/env python3
"""Chip smoke run of openr_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, holds each kernel
against its plain PyTorch version on the card, and drives the port's
paths of the fleet route build `SpfSolver.fleet_route_dbs`, each with
1024 prefix advertisers, its routes checked against the host Dijkstra
and its phases timed:

- the fused rung (kernel K1, the fused epilogue) over the 100k-node WAN
  of BASELINE config #3 (`benchmarks/synthetic.wan(100_000, chords=2,
  seed=0)`), pinned to that rung by raising the engine's
  `blocked.node_shard_threshold` to its node count; its metrics (1..10)
  put the product in the uint16 distance mode, so K1's uint16 variant
  runs, and the int32 variant on the widened product must give the same
  bitmap and verdict;
- warm rebuilds of that WAN after four changes (a metric raised, the
  link down, the link restored, a node drained), each bit for bit equal
  to a cold view and launching K1's uint16 variant once;
- the reference's flap storm on that WAN (`bench.py`
  bench_flap_storm_wan100k): 1000 seeded metric events on 4 backup ring
  links, in 4 chunks of 250, each chunk folded into the resident product
  by one view of `FleetViewCache(delta=True)` (the incremental delta
  rung: a certified frontier, a column-slab relax whose epilogue
  launches K1's uint16 variant, the out-row re-encode), bit for bit
  equal to a cold view, `full_restages` 1; then an adjacency down and
  up (the row re-encode and a mirror rewire) and one node's links
  raised (the frontier overflows, the designed fallback); K1 held
  against its plain version on every slab, in both variants;
- the saturation retry: a 65-ring (banded) and a 7-node chain (ELL) at
  metric 4000, whose uint16 runs saturate, latch the mode off and run
  again in int32 (the ring through K1's int32 variant), equal to the host
  Dijkstra;
- the ELL fallback over BASELINE config #2's own 10 080-node fat-tree
  (4 planes of 24 spines, 4 fabric and 100 rack switches per pod, 96
  pods) under the default policy, equal bit for bit to the blocked
  closure of the same fabric;
- the blocked APSP rung (kernel K2, the rank-B outer update) over the
  same fat-tree shape with 315 pods, 32 856 nodes: the smallest fabric
  of that shape that the rung takes under its default threshold;
- the per-source SPF path that Decision runs by default
  (`SpfSolver(router).build_route_db` through `DeviceSpfBackend`, its
  refreshed CSR mirror and the residency engine) on the WAN after the
  warm rebuilds: a cold build, a drain and an undrain (incremental
  syncs), a chord swap (a rewire), an 8-source prefetch, the fleet view
  on the refreshed mirror (K1 once, equal to a cold view on a fresh
  mirror) and the single-source crossover against the host Dijkstra,
  every route DB equal to the host backend's;
- Decision → Fib on the same WAN: one KvStore Publication of every
  adjacency and prefix database, serialized with the port's `dumps`,
  into `Decision(router)` on the card wired to `Fib` and a
  `MockFibAgent`, and into a second Decision on the host Dijkstra (the
  oracle) with its own Fib; then a metric raised, a prefix withdrawn and
  advertised again, a node expired, static routes and a RibPolicy set
  and cleared, both agents' tables equal after each, and the fleet dump
  `Decision.get_fleet_route_dbs` launching K1 once, twice; then the
  operator queries on the card Decision's mirror (BASELINE config #5):
  `Decision.get_ti_lfa()` of the router and `Decision.what_if` of three
  SRLG scenarios, each against a host oracle, and
  `ti_lfa_backups(runner=)` called directly; then the storm's backup
  links raised and restored in two publications, the card Decision
  (`fleet_delta=True`) serving each fleet dump on the delta rung; then
  `QueryScheduler(DecisionBatchBackend(decision),
  defer_hint=decision.pending_event_hint)` answering paths and KSP
  queries equal to the host-Dijkstra Decision's;
- traffic engineering on the WAN (the reference's `bench.py`
  bench_te_wan100k): `TeOptimizer(engine)`'s soft descent under
  torch.autograd, 512 sources toward 4 destinations, metrics 1..16, 12
  steps in 3 anneal stages, each stage's rounded candidate gated by the
  exact product (K1's uint16 variant, once per evaluation, every
  evaluation equal to scipy's Dijkstra), then `hill_climb` with as many
  evaluations; K1 held against its plain version on the first
  evaluation's inputs; the first descent step held against the CPU's;
- the query-serving layer on the WAN: `QueryScheduler(EngineBatchBackend
  ({"0": ls}))` answering one burst of 256 paths, 4 what-if, 4 KSP and
  2 coalesced optimize_metrics queries (K1 once per TE evaluation, and
  held against its plain version on the first), against the host
  Dijkstra and scipy, and one flap that invalidates a staged batch;
- BASELINE config #3's dual-metric KSP2 on that mirror's forward
  runner (`ops.ksp.FusedKsp2Runner`, an IGP and a TE plane, 8
  destinations) against scipy's Dijkstra over the oracle Decision's
  LinkState;
- BASELINE config #4's SRLG what-if: 10 000 single-link failure
  variants of a 1024-node grid in one masked `SpfRunner.forward`;
- the reference's reconvergence flow on the 10 080-node fabric: the
  first fabric switch's overload bit flapped, the first rack switch's
  route DB rebuilt per source, host and device, equal on every rep;
- KSP2, BGP and UCMP routes on the same fabric through a card Decision
  and a host-Dijkstra Decision → Fib (a publication, a metric raised, a
  link down), one masked k = 2 batch per rebuild on the card.

The masked batches (KSP2 re-runs, what-if, TI-LFA) are plain PyTorch,
as the reference leaves them to XLA; their phases print the masked
runs, the learned `hint_masked`, the per-sweep time against its byte
bound, the oracle's time and peak device memory, and launch no kernel.

Each phase prints one JSON line; the line before the last is the
`kernels` record, and the last line is {"ok": true, "device": {...}}.
Exits non-zero, printing no result, when CUDA is not available or any
check fails.  Imports nothing of JAX.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

N_NODES = 100_000
N_ADVERTISERS = 1024
N_ROUTERS = 32
N_CHECKED = 4
# the blocked rung's fabric: BASELINE config #2's shape with 315 pods
# (96 + 315 * 104 = 32 856 nodes > 2^15), and its own 96-pod, 10 080-node
# fabric for the kernel-against-plain closure and the ELL path
FABRIC = dict(n_planes=4, n_fsw_per_pod=4, n_rsw_per_pod=100, n_ssw_per_plane=24)
FABRIC_PODS = 315
CHECK_PODS = 96
# random tile cases of K2 (S, T, B): every B the rung and the tests use;
# with B = 8 and 16, Np is not a multiple of the kernel's 64-wide tile
OUTER_CASES = ((1, 13, 8), (2, 9, 16), (1, 3, 128), (2, 2, 128))
# random-table cases of K1 (N, P, W, residual groups, bands?): node
# counts that are no multiple of any node tile, P ragged against 4 (1001,
# 37: the kernel's scalar path) and against the slab (1020, 36), 1, 2, 3
# and 8 bitmap words, no groups at all, and N below the halo window (13)
EPILOGUE_CASES = (
    (4099, 1001, 1, 4, True),
    (4099, 1020, 1, 4, True),
    (4099, 37, 3, 4, True),
    (2053, 36, 2, 4, True),
    (777, 64, 8, 4, True),
    (4099, 128, 1, 0, False),
    (13, 8, 2, 2, True),
)
# H100 SXM (NVIDIA data sheet and architecture white paper): HBM bytes/s,
# and 64 int32 lanes per SM per clock (the integer pipe; the float32 rate
# of 67 TFLOP/s counts the FMA pipe's 128 lanes); the SM clock is read
# from nvidia-smi at run time
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
H100_SMS = 132
H100_MAX_SM_MHZ = 1980
# integer operations per (node, column, active group) of the epilogue's
# inner loop: a three-input add (x = du + w - d), the running min of x,
# the compare x == 0, and the predicated or of the bit.  The SASS of the built library
# (cuobjdump -sass) shows per element and group IADD3, VIMNMX, ISETP.NE
# and a predicated LOP3 in the unrolled W = 1 body.
EPILOGUE_OPS = 4
# K1's two variants, one CUDA source, counted apart by the wrapper
KERNEL = {
    "name": "fused_epilogue_int32",
    "route": "cuda",
    "source": "openr_tpu_torch/ops/csrc/fused_epilogue.cu",
    "replaces": "openr_tpu/ops/pallas_kernels.py:240",
}
KERNEL_U16 = {**KERNEL, "name": "fused_epilogue_uint16"}
VARIANT_KERNELS = {"int32": KERNEL, "uint16": KERNEL_U16}
OUTER_KERNEL = {
    "name": "blocked_outer",
    "route": "cuda",
    "source": "openr_tpu_torch/ops/csrc/blocked_outer.cu",
    "replaces": "openr_tpu/ops/pallas_kernels.py:401",
}
NO_LIBRARY = "no single PyTorch call computes this function"


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def same(a, b) -> bool:
    """torch.equal that also takes uint16 tensors (through int16 views)."""
    import torch

    if a.dtype != b.dtype:
        return False
    if a.dtype == torch.uint16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def zero_launch_counts() -> None:
    """Set every kernel wrapper's launch counts to 0."""
    from openr_tpu_torch.ops import blocked_outer as bo
    from openr_tpu_torch.ops import epilogue as ep

    ep.fused_epilogue.launches = 0
    for v in ep.fused_epilogue.variant_launches:
        ep.fused_epilogue.variant_launches[v] = 0
    bo.blocked_outer.launches = 0


def launch_counts() -> dict:
    """Launches by kernel record name since `zero_launch_counts`."""
    from openr_tpu_torch.ops import blocked_outer as bo
    from openr_tpu_torch.ops import epilogue as ep

    counts = {
        VARIANT_KERNELS[v]["name"]: n
        for v, n in ep.fused_epilogue.variant_launches.items()
    }
    counts[OUTER_KERNEL["name"]] = bo.blocked_outer.launches
    return counts


def int32_ops_per_s(cuda: bool) -> float:
    """The card's int32 rate: SMs x 64 lanes x the maximum SM clock that
    nvidia-smi reports (the data sheet's 1980 MHz in a CPU rehearsal)."""
    if not cuda:
        return H100_SMS * INT32_LANES_PER_SM * H100_MAX_SM_MHZ * 1e6
    import torch

    mhz = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=clocks.max.sm",
            "--format=csv,noheader,nounits",
        ],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * float(mhz) * 1e6


def card_line() -> str:
    return subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip().splitlines()[0]


def link_state_of(dbs):
    from openr_tpu_torch.decision.link_state import LinkState

    ls = LinkState()
    for db in dbs:
        ls.update_adjacency_database(db)
    return ls


def product_and_groups(csr, dest_ids, engine, epilogue, small=True):
    """The fleet product of `dest_ids` on the engine's device with the
    given epilogue, in the uint16 mode where the metrics allow it unless
    `small` is False: (dist, bitmap, ok, epilogue group tables, n_words,
    reverse runner, relax ops, epilogue maps), the tables and ops in the
    product's distance domain (`relax_groups`)."""
    from openr_tpu_torch.decision.fleet import _reverse_runner
    from openr_tpu_torch.ops import allsources as asrc

    runner = _reverse_runner(csr)
    runner.small_allowed = small
    out = asrc.build_out_ell(
        csr.edge_src, csr.edge_dst, csr.n_edges, csr.n_nodes, csr.out_slot
    )
    maps = asrc.build_epilogue_maps(runner.bg, out)
    engine.stage(runner)
    dist, bitmap, ok = asrc.reduced_all_sources(
        dest_ids, runner, out, csr.edge_metric, csr.edge_up,
        csr.node_overloaded, maps=maps, epilogue=epilogue,
    )
    import torch

    groups, ops = relax_groups(
        runner, maps, out.n_words, engine.device, dist.dtype == torch.uint16
    )
    return dist, bitmap, ok, groups, out.n_words, runner, ops, maps


def relax_groups(runner, maps, n_words, device, small: bool):
    """(K1's group tables, relax ops) of a staged banded runner in the
    uint16 (`small`) or the int32 distance domain."""
    import torch

    from openr_tpu_torch.ops.banded import _RelaxOps
    from openr_tpu_torch.ops.epilogue import build_epilogue_groups

    ops = _RelaxOps(
        runner.bg,
        runner.call_arrays(),
        0 if runner.chord_mode else runner.depth,
        runner.resid_rounds,
        runner.chord_mode,
        small,
    )
    groups = build_epilogue_groups(
        ops,
        torch.from_numpy(maps.resid_slot).to(device),
        torch.from_numpy(maps.band_slot).to(device),
        n_words,
    )
    return groups, ops


def host_ints(d) -> np.ndarray:
    """A product (int32, or uint16 through its int16 view) as int64 numpy."""
    import torch

    if d.dtype == torch.uint16:
        return d.view(torch.int16).cpu().numpy().view(np.uint16).astype(np.int64)
    return d.cpu().numpy().astype(np.int64)


def set_entry(d, row: int, col: int, value: int):
    """A copy of the product `d` with d[row, col] = value (uint16 through
    its int16 view)."""
    import torch

    out = d.clone()
    if d.dtype == torch.uint16:
        out.view(torch.int16)[row, col] = value - (1 << 16) if value >= 1 << 15 else value
    else:
        out[row, col] = value
    return out


def break_fixed_point(d, groups):
    """A copy of the converged product with one finite entry lowered by 1
    where another node's shortest path runs through it: the epilogue's
    verdict must turn False."""
    import torch

    from openr_tpu_torch.ops.sssp import domain

    inf, wbig = domain(d.dtype == torch.uint16)
    idx, w, ov, _ = (g.cpu().numpy() for g in groups)
    dn = host_ints(d)
    for g in range(idx.shape[0]):
        du = dn[idx[g]]
        wg = w[g][:, None]
        tight = (wg < wbig) & ((ov[g] == 0)[:, None] | (du == 0))
        tight &= (du > 0) & (du < inf) & (dn < inf) & (du + wg == dn)
        hits = np.argwhere(tight)
        if len(hits):
            v, p = hits[0]
            row = int(idx[g][v])
            return set_entry(d, row, int(p), int(dn[row, p]) - 1)
    raise AssertionError("no tight relax edge to break")


def compare(kernel, plain, d, groups, n_words, plan=None) -> dict:
    """Kernel (tiled by `plan` when given) and plain version on the same
    inputs: bit-exact bitmaps and equal verdicts required."""
    import torch

    kb, kok = kernel(d, *groups, n_words, **({"plan": plan} if plan else {}))
    pb, pok = plain(d, *groups, n_words)
    if d.is_cuda:
        torch.cuda.synchronize()
    diff = (kb.long() - pb.long()).abs()
    err = int(diff.max()) if diff.numel() else 0
    if not torch.equal(kb, pb) or bool(kok) != bool(pok):
        raise AssertionError(
            f"kernel and plain epilogue disagree: max_abs_err {err}, "
            f"verdicts {bool(kok)} / {bool(pok)}"
        )
    return {"max_abs_err": err, "verdict": bool(kok)}


def kernel_vs_plain_small(device, kernel, plain) -> list[dict]:
    """Phase 2: the epilogue kernel against its plain version on small
    banded graphs, each in both variants (the uint16 mode its metrics
    allow, and int32 with the mode off), converged and deliberately not
    converged."""
    from openr_tpu_torch.decision.csr import CsrTopology
    from openr_tpu_torch.device.engine import DeviceResidencyEngine
    from openr_tpu_torch.utils import topo

    engine = DeviceResidencyEngine(device)
    cases = {
        "ring65": (topo.ring_topology(65), [0, 7, 31, 64]),
        "wan256": (topo.wan_topology(256), [0, 5, 17, 48, 95, 200, 255]),
        "hub_w2": (topo.hub_topology(), [0, 9, 32, 40, 63]),
    }
    records = []
    for (name, (dbs, dests)), small in (
        (case, small) for case in cases.items() for small in (True, False)
    ):
        csr = CsrTopology.from_link_state(link_state_of(dbs))
        d, _, ok, groups, n_words, *_ = product_and_groups(
            csr, dests, engine, plain, small
        )
        if not ok or (str(d.dtype) == "torch.uint16") != small:
            raise AssertionError(f"{name}: product {d.dtype}, converged {ok}")
        converged = compare(kernel, plain, d, groups, n_words)
        broken = compare(
            kernel, plain, break_fixed_point(d, groups), groups, n_words
        )
        if not converged["verdict"] or broken["verdict"]:
            raise AssertionError(f"{name}: wrong verdicts {converged} {broken}")
        records.append(
            {
                "phase": "kernel_vs_plain",
                "rung": "fused",
                "graph": name,
                "variant": "uint16" if small else "int32",
                "shape": list(d.shape),
                "groups": int(groups[0].shape[0]),
                "n_words": n_words,
                "max_abs_err": max(converged["max_abs_err"], broken["max_abs_err"]),
                "converged_verdict": converged["verdict"],
                "broken_verdict": broken["verdict"],
            }
        )
    return records


def random_groups(n, p, n_words, n_resid, bands, device, seed, small=False):
    """Random epilogue tables [G, N] and a product [N, P] at their fixed
    point, made with numpy from `seed`: band groups at offsets inside and
    outside the halo (both wraps), `n_resid` residual groups with random
    rows, 15% empty slots (w >= WBIG), weights 0..49, 10% overloaded
    predecessors, 10% slot -1.  The product starts in [0, 2^20) with 10%
    INF32 entries, 2% zeros (so overloaded rows meet d = 0) and 10% of
    its columns INF32 throughout, and is relaxed to its fixed point with
    the relax's own rule.  With `small` it is a uint16 product of the
    16-bit domain: values from [0, 2^12), INF16, empty slots at WBIG16
    (and some at WBIG), relaxed with INF16 and WBIG16."""
    import torch

    from openr_tpu_torch.ops.epilogue import HALO, check_epilogue_groups
    from openr_tpu_torch.ops.sssp import INF32, WBIG, WBIG16, domain, to_u16

    inf, wbig = domain(small)

    rng = np.random.default_rng(seed)
    v = np.arange(n)
    offsets = sorted(
        {c % n for c in (1, 2, HALO, HALO + 1, n // 2, n - 1, n - 2, n - HALO,
                         n - HALO - 1)} - {0}
    ) if bands else []
    rows = [(v - c) % n for c in offsets]
    rows += [rng.integers(0, n, n) for _ in range(n_resid)]
    g = len(rows)
    idx = np.asarray(rows, dtype=np.int64).reshape(g, n)
    w = rng.integers(0, 50, (g, n))
    w[rng.random((g, n)) < 0.15] = WBIG16 if small else WBIG
    w[rng.random((g, n)) < 0.02] = WBIG if small else INF32
    ov = (rng.random((g, n)) < 0.1).astype(np.int64)
    slot = rng.integers(0, 32 * n_words, (g, n))
    slot[rng.random((g, n)) < 0.1] = -1
    d = rng.integers(0, 1 << (12 if small else 20), (n, p))
    d[rng.random((n, p)) < 0.1] = inf
    d[rng.random((n, p)) < 0.02] = 0
    d[:, rng.choice(p, max(1, p // 10), replace=False)] = inf

    def dev(a):
        return torch.as_tensor(a.astype(np.int32), device=device).contiguous()

    groups = tuple(dev(a) for a in (idx, w, ov, slot))
    check_epilogue_groups(groups, n, n_words)
    d = dev(d)
    for _ in range(4 * n + 8):
        vmin = d
        for gi in range(g):
            du = d.index_select(0, groups[0][gi])
            wg = groups[1][gi][:, None]
            allow = (wg < wbig) & ((groups[2][gi] == 0)[:, None] | (du == 0))
            vmin = torch.minimum(
                vmin, torch.where(allow & (du < inf), du + wg, inf)
            )
        if torch.equal(vmin, d):
            return (to_u16(d) if small else d), groups, offsets
        d = vmin
    raise AssertionError(f"random product {n}x{p} did not reach its fixed point")


def saturate(d, seed: int):
    """A copy of the uint16 product `d` with about 3% of its finite
    entries moved into [WBIG16, INF16): the saturation guard must fail."""
    import torch

    from openr_tpu_torch.ops.sssp import INF16, WBIG16, to_u16

    rng = np.random.default_rng(seed)
    dn = host_ints(d)
    hot = (dn < INF16) & (rng.random(dn.shape) < 0.03)
    dn[hot] = rng.integers(WBIG16, INF16, int(hot.sum()))
    return to_u16(torch.as_tensor(dn.astype(np.int32), device=d.device))


def kernel_vs_plain_random(device, kernel, plain) -> list[dict]:
    """Phase 2b: the epilogue kernel against its plain version on the
    random tables of EPILOGUE_CASES in both variants, converged and with
    one entry lowered (uint16: and with entries in [WBIG16, INF16)),
    under the plan the card's L2 gives and under the 64 x 64, 32 x 128
    and 128 x 32 (slab x tile) plans of the int32 and uint16 main path."""
    from openr_tpu_torch.ops.epilogue import HALO, EpiloguePlan
    from openr_tpu_torch.ops.sssp import INF16, INF32

    plans = (
        None,
        EpiloguePlan(64, 64, HALO, (), ()),
        EpiloguePlan(32, 128, HALO, (), ()),
        EpiloguePlan(128, 32, HALO, (), ()),
    )
    records = []
    for seed, ((n, p, n_words, n_resid, bands), small) in enumerate(
        (case, small) for case in EPILOGUE_CASES for small in (True, False)
    ):
        d, groups, offsets = random_groups(
            n, p, n_words, n_resid, bands, device, seed, small
        )
        err = 0
        failing = []
        if groups[0].shape[0]:
            failing.append(("broken", break_fixed_point(d, groups)))
        if small:
            failing.append(("saturated", saturate(d, seed)))
        verdicts = {}
        for plan in plans:
            converged = compare(kernel, plain, d, groups, n_words, plan)
            if not converged["verdict"]:
                raise AssertionError(f"random {n}x{p}: fixed point judged broken")
            err = max(err, converged["max_abs_err"])
            for what, bad in failing:
                out = compare(kernel, plain, bad, groups, n_words, plan)
                if out["verdict"]:
                    raise AssertionError(f"random {n}x{p}: {what} product judged converged")
                err = max(err, out["max_abs_err"])
                verdicts[what] = out["verdict"]
        records.append(
            {
                "phase": "kernel_vs_plain",
                "rung": "fused",
                "graph": "random",
                "variant": "uint16" if small else "int32",
                "shape": [n, p],
                "groups": int(groups[0].shape[0]),
                "band_offsets": offsets,
                "n_words": n_words,
                "inf_share": float((host_ints(d) >= (INF16 if small else INF32)).mean()),
                "plans": len(plans),
                "max_abs_err": err,
                "converged_verdict": True,
                **{f"{what}_verdict": v for what, v in verdicts.items()},
            }
        )
    return records


def saturating_dbs(n: int, ring: bool, metric: int = 4000):
    """`topo.ring_topology(n)` at `metric` on every adjacency, or, with
    `ring` False, the chain it holds without the r0 - r{n-1} link: every
    metric passes the uint16 gate while the far distances pass WBIG16."""
    from openr_tpu_torch.utils import topo

    dbs = topo.ring_topology(n)
    wrap = {"r0", f"r{n - 1}"}
    for db in dbs:
        db.adjacencies = [
            a for a in db.adjacencies
            if ring or {db.this_node_name, a.other_node_name} != wrap
        ]
        for a in db.adjacencies:
            a.metric = metric
    return dbs


def saturation_retry(device, timer):
    """Phase 2c: fleet views whose uint16 run saturates, on the banded
    path (a 65-ring) and on the ELL path (a 7-node chain, the reference's
    tests/test_sssp_ell.py fixture), each with every kernel's count set to
    0 just before the view and read just after.  Each must latch the
    runner's `small_allowed` off, run again in int32 (one
    `device.engine.small_dist_retries`), launch K1's uint16 and then its
    int32 variant once on the banded path and no kernel on the ELL path,
    and give every node's distances and next hops of the host Dijkstra.
    Returns (record, launches of K1's int32 variant)."""
    import torch

    from openr_tpu_torch.decision.fleet import FleetViewCache
    from openr_tpu_torch.device.engine import DeviceResidencyEngine

    fixtures = {
        "banded_ring65": (saturating_dbs(65, ring=True), ["r0", "r20", "r40"], True),
        "ell_chain7": (saturating_dbs(7, ring=False), ["r0", "r3", "r6"], False),
    }
    records = []
    int32_launches = 0
    for name, (dbs, dests, banded) in fixtures.items():
        ls = link_state_of(dbs)
        engine = DeviceResidencyEngine(device)
        zero_launch_counts()
        t0 = time.perf_counter()
        view = FleetViewCache().view(ls, dests, engine=engine)
        if timer.cuda:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = launch_counts()
        runner = view._runner
        want = {KERNEL["name"]: 1, KERNEL_U16["name"]: 1} if banded else {}
        if (
            (runner.bg is not None) != banded
            or runner.small_allowed
            or engine.counters["device.engine.small_dist_retries"] != 1
            or view._dist_dev.dtype != torch.int32
            or {k: v for k, v in launches.items() if v} != want
        ):
            raise AssertionError(
                f"{name}: banded {runner.bg is not None}, small_allowed "
                f"{runner.small_allowed}, {view._dist_dev.dtype}, launches "
                f"{launches}, engine {engine.counters}"
            )
        for node in ls.node_names:
            spf = ls.get_spf_result(node)
            for dest in dests:
                if view.dist(node, dest) != spf[dest].metric or (
                    view.next_hop_neighbors(node, dest) != spf[dest].next_hops
                ):
                    raise AssertionError(f"{name}: ({node}, {dest}) differs from Dijkstra")
        int32_launches += launches[KERNEL["name"]]
        records.append(
            {
                "fixture": name,
                "nodes": len(ls.node_names),
                "banded": banded,
                "max_distance": int(view._dist_dev[: len(ls.node_names)].max()),
                "small_allowed": runner.small_allowed,
                "small_dist_retries": engine.counters["device.engine.small_dist_retries"],
                "product_dtype": str(view._dist_dev.dtype),
                "sweep_hint": view.sweep_hint,
                "launches": launches,
                "equal_to_dijkstra": True,
                "view_ms": ms,
            }
        )
    return {"phase": "saturation_retry", "fixtures": records}, int32_launches


class Timer:
    """CUDA-event timing of a callable (host clock on the CPU)."""

    def __init__(self, device) -> None:
        import torch

        self.cuda = torch.device(device).type == "cuda"

    def ms(self, fn, reps: int = 1, warmup: int = 1) -> float:
        import torch

        for _ in range(warmup):
            fn()
        if not self.cuda:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t0) * 1e3 / reps
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def median_ms(self, fn, reps: int = 20) -> float:
        """Median of `reps` calls, each between its own pair of CUDA
        events, so the host's work in the call counts where it holds the
        device back."""
        import torch

        fn()
        if not self.cuda:
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
            return float(np.median(times))
        events = [
            (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            for _ in range(reps)
        ]
        torch.cuda.synchronize()
        for start, end in events:
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in events]))


def l2_bytes(device) -> int:
    """The card's L2 size (the H100's 50 MiB in a CPU rehearsal)."""
    import torch

    from openr_tpu_torch.ops import epilogue as ep

    if torch.device(device).type != "cuda":
        return 50 << 20
    return ep.l2_bytes(torch.device(device).index or 0)


def epilogue_variants(dist, groups, n_words, plan, timer) -> dict:
    """K1 at the main path's shape, each variant the median of 20 calls:
    as planned; with no groups at all (the stream alone: d read through
    the windows, bitmap written); with every slot empty (each group a
    neutral read of the node's own window row: the stream plus the group
    work, no gathers); with every gather row moved into the halo (v - 1:
    the same); with 256-column slabs, whose [N, 256] slab exceeds half
    the L2; and, as a yardstick, one PyTorch copy of d (the same bytes as
    the stream, read and written row by row)."""
    import torch

    from openr_tpu_torch.ops import epilogue as ep
    from openr_tpu_torch.ops.sssp import WBIG

    idx, w, ov, slot = groups
    n = dist.shape[0]
    near = torch.remainder(
        torch.arange(n, dtype=torch.int32, device=dist.device) - 1, n
    ).expand_as(idx).contiguous()
    cases = {
        "planned": (groups, plan),
        "no_groups": (tuple(t[:0] for t in groups), plan),
        "empty_slots": ((idx, torch.full_like(w, WBIG), ov, slot), plan),
        "halo_only": ((near, w, ov, slot), plan),
        "slab256": (groups, plan._replace(slab_cols=256, node_tile=16)),
    }
    times = {
        name: timer.median_ms(
            lambda g=g, pl=pl: ep.fused_epilogue(dist, *g, n_words, plan=pl)
        )
        for name, (g, pl) in cases.items()
    }
    # a uint16 product is copied through its int16 view
    src = dist.view(torch.int16) if dist.dtype == torch.uint16 else dist
    copy = torch.empty_like(src)
    times["copy_of_d"] = timer.median_ms(lambda: copy.copy_(src))
    return times


def expected_routes(ls, router, advertisers, prefixes, labels):
    """(unicast, mpls) next hops of `router` derived from the host
    Dijkstra: a link to neighbour u is an ECMP next hop toward t iff u is
    a first hop of a shortest path and metric(link) == dist(router, u)."""
    spf = ls.get_spf_result(router)

    def hops(t):
        first = spf[t].next_hops
        return {
            (link, link.other_node_name(router))
            for link in ls.links_from_node(router)
            if link.is_up()
            and link.other_node_name(router) in first
            and link.metric_from_node(router)
            == spf[link.other_node_name(router)].metric
        }

    unicast, mpls, dist = {}, {}, {}
    for t, prefix, label in zip(advertisers, prefixes, labels):
        if t not in spf:
            continue
        dist[t] = spf[t].metric
        if t == router:
            mpls[label] = {("::", None, 0, None, ("POP_AND_LOOKUP", None))}
            continue
        metric = int(spf[t].metric)
        nh = hops(t)
        unicast[prefix] = {
            (link.nh_v6_from_node(router), link.iface_from_node(router),
             metric, u, None)
            for link, u in nh
        }
        mpls[label] = {
            (link.nh_v6_from_node(router), link.iface_from_node(router),
             metric, u, ("PHP", None) if u == t else ("SWAP", label))
            for link, u in nh
        }
    return unicast, mpls, dist


def route_sets(db):
    def nh_key(nh, with_action):
        action = None
        if with_action:
            a = nh.mpls_action
            action = (a.action.name, a.swap_label)
        return (nh.address, nh.if_name, nh.metric, nh.neighbor_node_name, action)

    unicast = {
        p: {nh_key(nh, False) for nh in r.nexthops}
        for p, r in db.unicast_routes.items()
    }
    mpls = {
        label: {nh_key(nh, True) for nh in r.nexthops}
        for label, r in db.mpls_routes.items()
    }
    return unicast, mpls


def fleet_inputs(make_dbs, n_routers, device):
    """LinkState, solver, CSR mirror, prefixes and routers of a route
    build.  `make_dbs()` returns (AdjacencyDatabases in node-id order,
    advertiser ids); each advertiser gets one /64 and carries a node
    label.  The database and LinkState build is timed as one host phase;
    the mirror is the solver's (its SPF backend's), built and timed
    here."""
    from types import SimpleNamespace

    from openr_tpu_torch.decision.prefix_state import PrefixState
    from openr_tpu_torch.decision.spf_solver import SpfSolver
    from openr_tpu_torch.types import PrefixEntry

    t0 = time.perf_counter()
    dbs, adv_ids = make_dbs()
    ls = link_state_of(dbs)
    t_ls = time.perf_counter() - t0
    solver = SpfSolver(ls.node_names[0], device=device)
    t0 = time.perf_counter()
    csr = solver.spf.csr_mirror(ls)
    t_csr = time.perf_counter() - t0
    names = ls.node_names
    if names != [db.this_node_name for db in dbs]:
        raise AssertionError("databases are not in node-id order")
    advertisers = [names[i] for i in adv_ids]
    prefixes = [f"fc00:{i >> 16:x}:{i & 0xFFFF:x}::/64" for i in adv_ids]
    ps = PrefixState()
    for node, prefix in zip(advertisers, prefixes):
        ps.update_prefix(node, "0", PrefixEntry(prefix=prefix))
    n = len(names)
    return SimpleNamespace(
        ls=ls,
        solver=solver,
        csr=csr,
        names=names,
        advertisers=advertisers,
        prefixes=prefixes,
        labels=[16 + int(i) for i in adv_ids],
        ps=ps,
        area={"0": ls},
        routers=[names[i * n // n_routers] for i in range(n_routers)],
        t_ls=t_ls,
        t_csr=t_csr,
    )


def host_tables_ms(csr) -> float:
    """Host time of the tables a view builds before its device work: the
    reversed runner (bands, else ELL), the out-edge table, the epilogue
    maps (banded) and the usable-edge table of the warm-start gates."""
    from openr_tpu_torch.decision.fleet import (
        _reverse_runner,
        _usable_edge_table,
    )
    from openr_tpu_torch.ops import allsources as asrc

    t0 = time.perf_counter()
    runner = _reverse_runner(csr)
    out = asrc.build_out_ell(
        csr.edge_src, csr.edge_dst, csr.n_edges, csr.n_nodes, csr.out_slot
    )
    if runner.bg is not None:
        asrc.build_epilogue_maps(runner.bg, out)
    _usable_edge_table(csr)
    return (time.perf_counter() - t0) * 1e3


def counted_route_build(solver, inp, timer):
    """One route build of the path, with every kernel's launch count set
    to 0 just before it and read just after: (route DBs, seconds,
    launches by kernel record, engine counters, the view that served
    it)."""
    import torch

    from openr_tpu_torch.decision.fleet import fleet_destinations

    zero_launch_counts()
    t0 = time.perf_counter()
    dbs_out = solver.fleet_route_dbs(inp.area, inp.ps, nodes=inp.routers)
    if timer.cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    counters = dict(solver.engine.counters)
    view = solver.fleet.view(
        inp.ls, fleet_destinations(inp.ls, inp.ps), engine=solver.engine
    )
    if not view.converged or sorted(dbs_out) != sorted(inp.routers):
        raise AssertionError("route build: view not converged or routers missing")
    return dbs_out, seconds, launches, counters, view


def checked_routers(inp, n_routers, n_checked) -> list[str]:
    """`n_checked` of the route build's routers, the last one among them."""
    step = max(1, n_routers // n_checked)
    return inp.routers[::step][: n_checked - 1] + inp.routers[-1:]


def check_routes(inp, dbs_out, view, routers) -> list[str]:
    """Routes and distances of `routers` against the host Dijkstra."""
    checked = []
    for router in routers:
        want_u, want_m, want_d = expected_routes(
            inp.ls, router, inp.advertisers, inp.prefixes, inp.labels
        )
        got_u, got_m = route_sets(dbs_out[router])
        if got_u != want_u or got_m != want_m:
            raise AssertionError(f"routes of {router} differ from Dijkstra")
        for t, metric in want_d.items():
            if view.dist(router, t) != metric:
                raise AssertionError(f"dist({router}, {t}) differs")
        checked.append(router)
    return checked


def main_path(device, n_nodes, n_advertisers, n_routers, n_checked, timer):
    """Phase 3: the fleet route build at full width on the fused rung, with
    its kernel launches counted, its routes checked against the host
    Dijkstra, and its kernel held against the plain epilogue on the same
    product.  The WAN's metrics put the product in the uint16 mode: K1's
    uint16 variant must run on the path, and the int32 variant on the
    widened product with int32 tables must give the same bitmap and
    verdict.  Returns (record, K1 records by variant, state for the
    later phases)."""
    import torch

    from openr_tpu_torch.decision.fleet import FleetViewCache
    from openr_tpu_torch.ops import epilogue as ep
    from openr_tpu_torch.ops.banded import make_dist0_orig
    from openr_tpu_torch.ops.sssp import u16_dist_to_i32
    from openr_tpu_torch.utils import topo

    rng = np.random.default_rng(7)
    adv_ids = np.sort(
        rng.choice(n_nodes, size=n_advertisers, replace=False)
    ).astype(np.int32)
    inp = fleet_inputs(
        lambda: (
            topo.wan_topology(n_nodes, chords=2, seed=0, labeled=adv_ids),
            adv_ids,
        ),
        n_routers,
        device,
    )
    ls, csr, solver = inp.ls, inp.csr, inp.solver
    # this path is the fused rung's: at 100k nodes the default policy
    # would take the blocked rung (ROADMAP: the threshold on this card)
    solver.engine.blocked.node_shard_threshold = n_nodes

    # the counted run of the path
    dbs_out, t_main, launches, main_counters, view = counted_route_build(
        solver, inp, timer
    )
    if (
        launches[KERNEL_U16["name"]] < 1
        or main_counters["device.engine.kernel_launches.fused_epilogue.uint16"] < 1
        or view._dist_dev.dtype != torch.uint16
    ):
        raise AssertionError(
            f"main path: product {view._dist_dev.dtype}, K1 launches {launches}"
        )
    if view.node_sharded or launches[OUTER_KERNEL["name"]]:
        raise AssertionError("main path left the fused rung")

    # routes of a few routers against the host Dijkstra
    t0 = time.perf_counter()
    checked = check_routes(
        inp, dbs_out, view, checked_routers(inp, n_routers, n_checked)
    )
    t_oracle = time.perf_counter() - t0

    # the kernel against the plain epilogue on the main path's product
    dest_ids = np.asarray([csr.node_id[t] for t in view.dest_names], np.int32)
    dist, bitmap, ok, groups, n_words, runner, ops, maps = product_and_groups(
        csr, dest_ids, solver.engine, ep.fused_epilogue_reference
    )
    if not ok or not same(dist, view._dist_dev):
        raise AssertionError("plain product differs from the main path's")
    parity = compare(ep.fused_epilogue, ep.fused_epilogue_reference, dist, groups, n_words)
    if not same(bitmap, view._bitmap_dev):
        raise AssertionError("plain bitmap differs from the main path's kernel")
    # the int32 variant on the widened product, with the int32 binding's
    # tables: the same bitmap and verdict as the uint16 variant
    dist32 = u16_dist_to_i32(dist)
    groups32, _ = relax_groups(
        runner, maps, n_words, dist.device, False
    )
    parity32 = compare(
        ep.fused_epilogue, ep.fused_epilogue_reference, dist32, groups32, n_words
    )
    b16, ok16 = ep.fused_epilogue(dist, *groups, n_words)
    b32, ok32 = ep.fused_epilogue(dist32, *groups32, n_words)
    if not (same(b16, b32) and bool(ok16) and bool(ok32)):
        raise AssertionError("the int32 and uint16 variants disagree on the product")
    del b16, b32

    # phase times, each after one warm-up
    def view_compute():
        FleetViewCache().view(ls, view.dest_names, csr=csr, engine=solver.engine)

    def supersweep_blocks():
        d = make_dist0_orig(
            torch.as_tensor(dest_ids, device=dist.device), csr.n_nodes, True
        )
        for _ in range(runner.hint):
            d = ops.supersweep(d)
        return d

    times = {
        "host_link_state_s": inp.t_ls,
        "host_csr_s": inp.t_csr,
        "main_path_first_run_s": t_main,
        "view_compute_ms": timer.ms(view_compute, reps=1),
        "host_tables_ms": host_tables_ms(csr),
        "supersweeps": runner.hint,
        "supersweep_blocks_ms": timer.ms(supersweep_blocks, reps=1),
        "epilogue_kernel_ms": timer.median_ms(
            lambda: ep.fused_epilogue(dist, *groups, n_words), reps=20
        ),
        "epilogue_plain_ms": timer.ms(
            lambda: ep.fused_epilogue_reference(dist, *groups, n_words), reps=3
        ),
        "epilogue_int32_kernel_ms": timer.median_ms(
            lambda: ep.fused_epilogue(dist32, *groups32, n_words), reps=20
        ),
        "epilogue_int32_plain_ms": timer.ms(
            lambda: ep.fused_epilogue_reference(dist32, *groups32, n_words),
            reps=3,
        ),
        "route_builds_ms": timer.ms(
            lambda: solver.fleet_route_dbs(inp.area, inp.ps, nodes=inp.routers),
            reps=1,
            warmup=0,
        ),
        "oracle_check_s": t_oracle,
    }
    n, p = dist.shape
    g = int(groups[0].shape[0])
    kernel_records = {}
    for variant, d, tables, prefix, check in (
        ("uint16", dist, groups, "epilogue", parity),
        ("int32", dist32, groups32, "epilogue_int32", parity32),
    ):
        small = variant == "uint16"
        plan = ep.epilogue_plan(
            n, p, runner.bg.offsets, l2_bytes(d.device), g, d.element_size()
        )
        traffic = ep.epilogue_traffic(
            tables[0].cpu().numpy(), tables[1].cpu().numpy(), p, plan, small
        )
        bytes_moved = n * p * d.element_size() + n * p * n_words * 4 + 16 * g * n
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = (
            traffic["active_pairs"] * p * EPILOGUE_OPS
            / int32_ops_per_s(timer.cuda) * 1e3
        )
        kernel_records[variant] = {
            **VARIANT_KERNELS[variant],
            # the uint16 variant's launches are the main path's; the
            # int32 variant's come from the saturation retry's path
            "launches": launches[VARIANT_KERNELS[variant]["name"]],
            "launches_path": "main_path" if small else "saturation_retry",
            "parity": True,
            "max_abs_err": check["max_abs_err"],
            "ms": times[f"{prefix}_kernel_ms"],
            "plain_ms": times[f"{prefix}_plain_ms"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "library_note": NO_LIBRARY,
            "shape": {"N": n, "P": p, "W": n_words, "G": g, "dtype": variant},
            "slab_cols": plan.slab_cols,
            "node_tile": plan.node_tile,
            "halo": plan.halo,
            "halo_groups": len(plan.halo_bands),
            "far_band_groups": len(plan.far_bands),
            "l2_bytes": l2_bytes(d.device),
            "active_pairs": traffic["active_pairs"],
            "gather_bytes": traffic["gather_bytes"],
            "bytes_ms": bytes_ms,
            "ops_ms": ops_ms,
            "variants_ms": epilogue_variants(d, tables, n_words, plan, timer),
        }
    record = {
        "phase": "main_path",
        "rung": "fused",
        "node_sharded": view.node_sharded,
        "nodes": n_nodes,
        "directed_edges": csr.n_edges,
        "advertisers": n_advertisers,
        "destinations": len(view.dest_names),
        "routers": n_routers,
        "checked_routers": checked,
        "unicast_routes": sum(len(db.unicast_routes) for db in dbs_out.values()),
        "mpls_routes": sum(len(db.mpls_routes) for db in dbs_out.values()),
        "launches": launches,
        "product_dtype": str(view._dist_dev.dtype),
        "product_bytes": view._dist_dev.numel() * view._dist_dev.element_size(),
        "engine_counters": main_counters,
        "chord_mode": runner.chord_mode,
        "band_offsets": list(runner.bg.offsets),
        "residual_k": int(runner.bg.resid_nbr.shape[1]),
        "times": times,
    }
    if timer.cuda:
        record["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    return record, kernel_records, (inp, solver, checked)


def warm_rebuild(inp, solver, checked, timer) -> dict:
    """The main path's LinkState after four changes in turn, each applied
    through `update_adjacency_database`: (a) one link's metric raised,
    (b) the same link down, (c) the link restored at its first metric,
    (d) one transit node drained.  After each, the solver's mirror is
    refreshed in place ((b) and (c) are rewires), and the view is rebuilt
    on it through the solver's warm-capable cache and cold through a fresh
    FleetViewCache: distances and bitmaps bit for bit, K1 launched once
    per view (its count set to 0 just before each view), (c) warm-started
    as an improvement, the route build of `checked`, and the routes of
    the first of them against the host Dijkstra.  A worsening change
    whose affected set is not certified
    cold-starts by design; its record says so (`cold_fallback`)."""
    import dataclasses

    import torch

    from openr_tpu_torch.decision.fleet import (
        AFFECTED_MAX_ITERS,
        FleetViewCache,
        _worsened_masks,
        fleet_destinations,
    )
    from openr_tpu_torch.ops import epilogue as ep
    from openr_tpu_torch.ops.banded import affected_mask

    ls = inp.ls
    csr = inp.csr  # the solver's mirror, refreshed in place per change
    dests = fleet_destinations(ls, inp.ps)
    n = len(inp.names)
    x, y = inp.names[n // 3], inp.names[2 * n // 3]
    db_x = ls.get_adjacency_databases()[x]
    db_y = ls.get_adjacency_databases()[y]
    first = db_x.adjacencies[0]
    raised = dataclasses.replace(first, metric=4 * first.metric + 10)
    changes = (
        ("metric_raised", dataclasses.replace(
            db_x, adjacencies=[raised, *db_x.adjacencies[1:]])),
        ("link_down", dataclasses.replace(
            db_x, adjacencies=list(db_x.adjacencies[1:]))),
        ("link_restored", db_x),
        ("node_drained", dataclasses.replace(db_y, is_overloaded=True)),
    )

    def counted(fn):
        zero_launch_counts()
        t0 = time.perf_counter()
        view = fn()
        if timer.cuda:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if launch_counts()[KERNEL_U16["name"]] != ep.fused_epilogue.launches:
            raise AssertionError(f"a warm-rebuild view left the uint16 mode: {launch_counts()}")
        return view, ms, ep.fused_epilogue.launches

    if timer.cuda:
        torch.cuda.reset_peak_memory_stats()
    records = []
    for name, db in changes:
        prev = solver.fleet._views[ls]
        passes0 = solver.engine.counters["device.engine.affected_passes"]
        if not ls.update_adjacency_database(db).topology_changed:
            raise AssertionError(f"{name}: not reported as a topology change")
        t0 = time.perf_counter()
        kept = csr.refresh(ls)
        t_csr = time.perf_counter() - t0
        if not kept:
            raise AssertionError(f"{name}: the mirror was rebuilt, not refreshed")
        warm, warm_ms, k1_warm = counted(
            lambda: solver.fleet.view(ls, dests, csr=csr, engine=solver.engine)
        )
        cold, cold_ms, k1_cold = counted(
            lambda: FleetViewCache().view(
                ls, dests, csr=csr, engine=solver.engine
            )
        )
        if k1_warm != 1 or k1_cold != 1 or warm.node_sharded:
            raise AssertionError(
                f"{name}: K1 launched {k1_warm} / {k1_cold} times"
            )
        if not same(warm._dist_dev, cold._dist_dev) or not same(
            warm._bitmap_dev, cold._bitmap_dev
        ):
            raise AssertionError(f"{name}: warm view differs from cold view")
        improve = warm.warm_mode == "improve"
        if cold.warm or (name == "link_restored" and not improve):
            raise AssertionError(
                f"{name}: warm_mode {warm.warm_mode}, cold warm {cold.warm}"
            )
        t0 = time.perf_counter()
        dbs_out = solver.fleet_route_dbs(inp.area, inp.ps, nodes=checked)
        routes_s = time.perf_counter() - t0
        # one router against the host Dijkstra (about 5 s each at 100k
        # nodes; warm == cold above already holds every entry)
        t0 = time.perf_counter()
        check_routes(inp, dbs_out, warm, checked[:1])
        oracle_s = time.perf_counter() - t0
        record = {
            "change": name,
            "warm": warm.warm,
            "warm_mode": warm.warm_mode,
            "cold_fallback": warm.cold_fallback,
            "directed_edges": warm.csr.n_edges,
            "k1_launches": {"warm": k1_warm, "cold": k1_cold},
            "product_dtype": str(warm._dist_dev.dtype),
            "supersweeps": {
                "warm": warm._runner.sweeps, "cold": cold._runner.sweeps
            },
            "bit_equal": True,
            "host_csr_refresh_s": t_csr,
            "rewire_seq": csr.rewire_seq,
            "warm_view_ms": warm_ms,
            "cold_view_ms": cold_ms,
            "route_build_checked_s": routes_s,
            "oracle_checked_routers": checked[:1],
            "oracle_check_s": oracle_s,
        }
        if warm.affected_passes is not None:
            wr, wb = (
                torch.from_numpy(m).to(warm._dist_dev.device)
                for m in _worsened_masks(
                    prev, warm._edge_keys, warm._edge_met, warm._overloaded
                )
            )
            record["affected"] = {
                "passes": warm.affected_passes,
                "engine_passes": (
                    solver.engine.counters["device.engine.affected_passes"]
                    - passes0
                ),
                "share": warm.affected_share,
                "worsened_slots": int(wr.sum()) + int(wb.sum()),
                "ms": timer.ms(
                    lambda: affected_mask(
                        prev._dist_dev, prev._runner.bg,
                        prev._runner.call_arrays(), wr, wb, AFFECTED_MAX_ITERS,
                    ),
                    reps=1,
                    warmup=0,
                ),
            }
        records.append(record)
        del prev, cold
    result = {
        "phase": "warm_rebuild",
        "rung": "fused",
        "nodes": n,
        "link": [x, first.other_node_name],
        "drained": y,
        "checked_routers": checked,
        "changes": records,
    }
    if timer.cuda:
        result["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    return result


def backup_ring_links(n_nodes: int, count: int = 4, metric: int = 10,
                      chords: int = 2, seed: int = 0) -> list[tuple[int, int, int]]:
    """The reference storm's flappy links (bench.py
    bench_flap_storm_wan100k): of the WAN's directed +1 ring edges at
    `metric`, in the mirror's (dst, src) edge order, `count` spread
    evenly, as (src, dst, metric) node ids."""
    from openr_tpu_torch.utils import topo

    links, metrics = topo.wan_links(n_nodes, chords, seed)
    src = np.concatenate([links[:, 0], links[:, 1]])
    dst = np.concatenate([links[:, 1], links[:, 0]])
    met = np.concatenate([metrics[:, 0], metrics[:, 1]])
    order = np.lexsort((src, dst))
    src, dst, met = src[order], dst[order], met[order]
    ring = np.flatnonzero((dst == (src + 1) % n_nodes) & (met == metric))
    picks = [int(ring[i * len(ring) // count]) for i in range(count)]
    return [(int(src[e]), int(dst[e]), int(met[e])) for e in picks]


def symmetric_ring_link(n_nodes: int, metric: int, avoid=(),
                        chords: int = 2, seed: int = 0) -> tuple[int, int]:
    """A +1 ring link of the WAN with `metric` in both directions, both
    endpoints outside `avoid`, from the middle of the ring: (src, dst)."""
    from openr_tpu_torch.utils import topo

    links, metrics = topo.wan_links(n_nodes, chords, seed)
    ring = np.flatnonzero(
        (links[:, 1] == (links[:, 0] + 1) % n_nodes)
        & (metrics[:, 0] == metric)
        & (metrics[:, 1] == metric)
        & ~np.isin(links[:, 0], list(avoid))
        & ~np.isin(links[:, 1], list(avoid))
    )
    a, b = links[ring[len(ring) // 2]]
    return int(a), int(b)


def with_adjacency(db, other: str, metric=None, drop: bool = False):
    """A copy of AdjacencyDatabase `db` with its adjacency to `other` at
    `metric`, or without it (`drop`)."""
    import dataclasses

    adjs = []
    for a in db.adjacencies:
        if a.other_node_name != other:
            adjs.append(a)
        elif not drop:
            adjs.append(dataclasses.replace(a, metric=metric))
    return dataclasses.replace(db, adjacencies=adjs)


def slab_record(d, groups, n_words, runner, timer, variant: str, check) -> dict:
    """K1 on one delta slab [N, Pb] against its plain version: times (the
    kernel the median of 20 calls, the plain version of 3) and the bound
    of the slab's work."""
    from openr_tpu_torch.ops import epilogue as ep

    n, pb = d.shape
    g = int(groups[0].shape[0])
    small = variant == "uint16"
    plan = ep.epilogue_plan(
        n, pb, runner.bg.offsets, l2_bytes(d.device), g, d.element_size()
    )
    traffic = ep.epilogue_traffic(
        groups[0].cpu().numpy(), groups[1].cpu().numpy(), pb, plan, small
    )
    bytes_moved = n * pb * d.element_size() + n * pb * n_words * 4 + 16 * g * n
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = (
        traffic["active_pairs"] * pb * EPILOGUE_OPS
        / int32_ops_per_s(timer.cuda) * 1e3
    )
    return {
        "variant": variant,
        "shape": {"N": n, "Pb": pb, "W": n_words, "G": g},
        "parity": True,
        "max_abs_err": check["max_abs_err"],
        "ms": timer.median_ms(lambda: ep.fused_epilogue(d, *groups, n_words), reps=20),
        "plain_ms": timer.ms(
            lambda: ep.fused_epilogue_reference(d, *groups, n_words), reps=3
        ),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes_ms": bytes_ms,
        "ops_ms": ops_ms,
        "slab_cols": plan.slab_cols,
        "node_tile": plan.node_tile,
    }


def slab_pair_records(d, groups, n_words, runner, out, timer, what: str) -> dict:
    """K1 in both variants on one uint16 product `d` that a relax of
    `runner` handed it (group tables `groups`, out-edge table `out`):
    each variant bit for bit against its plain version and the two
    variants against each other, then `slab_record` of each, by
    variant."""
    from openr_tpu_torch.ops import allsources as asrc
    from openr_tpu_torch.ops import epilogue as ep
    from openr_tpu_torch.ops.sssp import u16_dist_to_i32

    check = compare(ep.fused_epilogue, ep.fused_epilogue_reference, d, groups, n_words)
    maps = asrc.build_epilogue_maps(runner.bg, out)
    groups32, _ = relax_groups(runner, maps, n_words, d.device, False)
    d32 = u16_dist_to_i32(d)
    check32 = compare(ep.fused_epilogue, ep.fused_epilogue_reference, d32, groups32, n_words)
    b16, ok16 = ep.fused_epilogue(d, *groups, n_words)
    b32, ok32 = ep.fused_epilogue(d32, *groups32, n_words)
    if not (same(b16, b32) and bool(ok16) == bool(ok32)):
        raise AssertionError(f"{what}: the int32 and uint16 variants disagree")
    return {
        "uint16": slab_record(d, groups, n_words, runner, timer, "uint16", check),
        "int32": slab_record(d32, groups32, n_words, runner, timer, "int32", check32),
    }


def flap_storm_wan100k(device, inp, timer, n_events: int = 1000,
                       n_chunks: int = 4, seed: int = 7):
    """The reference's flap storm (bench.py bench_flap_storm_wan100k) at
    full width through the port's entry points, on the main path's
    LinkState and mirror: the 4 backup +1 ring links at the metric
    ceiling (`backup_ring_links`) flap between their base metric and 90
    in `n_events` seeded events (`default_rng(seed + 1)`), coalesced into
    `n_chunks` chunks.  Each event is one `update_adjacency_database`;
    each chunk is folded by one `view` of `FleetViewCache(delta=True)` on
    one DeviceResidencyEngine (`delta_register` once, after the cold
    view): warm_mode "delta", and product and bitmap equal bit for bit
    to a cold view on a fresh `FleetViewCache(delta=False)`.  Then one
    chunk of each other kind, each against a cold view: an adjacency of
    a symmetric backup link down and up again (an edge-set change: the
    row re-encode runs and the mirror rewires), and the primary links of
    one node (the endpoint of a metric-1 ring link, its whole adjacency
    set) raised to 90, whose frontier overflows the ladder (the designed
    fallback).  K1's launches are counted over each delta view
    (counts set to 0 just before it), and K1 is held against its plain
    version on every slab the storm's relaxes gave it, in both variants.
    Every changed link is restored at the end.  Returns (record, slab
    records by variant, K1 uint16 launches over the storm's views)."""
    import dataclasses

    import torch

    from openr_tpu_torch.decision.fleet import FleetViewCache, fleet_destinations
    from openr_tpu_torch.device.engine import DeviceResidencyEngine

    ls, csr, names = inp.ls, inp.csr, inp.names
    n = len(names)
    dests = fleet_destinations(ls, inp.ps)
    p = len(dests)
    flappy = backup_ring_links(n)
    dbs_now = dict(ls.get_adjacency_databases())

    def set_metric(src: int, dst: int, metric: int) -> None:
        db = with_adjacency(dbs_now[names[src]], names[dst], metric)
        dbs_now[names[src]] = db
        ls.update_adjacency_database(db)

    counters: dict[str, int] = {}

    def bump(name, k=1):
        counters[name] = counters.get(name, 0) + k

    engine = DeviceResidencyEngine(device)
    engine.blocked.node_shard_threshold = n  # the fused rung, as main_path
    cache = FleetViewCache(delta=True, bump=bump)
    updater = cache._delta

    # per-op times of the delta programs, and the slabs K1 took
    op_ms: dict[str, float] = {}
    dispatch = engine.delta_dispatch

    def timed_dispatch(op, fn, *args, **kwargs):
        if timer.cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return dispatch(op, fn, *args, **kwargs)
        finally:
            if timer.cuda:
                torch.cuda.synchronize()
            op_ms[op] = op_ms.get(op, 0.0) + (time.perf_counter() - t0) * 1e3

    engine.delta_dispatch = timed_dispatch
    slabs = []
    epilogue = engine.epilogue

    def capturing_epilogue(d, *rest):
        out = epilogue(d, *rest)
        slabs.append((d, rest[:4], rest[4]))
        return out

    def delta_view(what):
        """One view of the delta cache, K1's counts set to 0 just before
        it and read just after: (view, record, the slab K1 took).  The
        mirror is refreshed to the LinkState's version first, timed apart:
        the cold view would share it."""
        t0 = time.perf_counter()
        csr.refresh(ls)
        refresh_ms = (time.perf_counter() - t0) * 1e3
        op_ms.clear()
        slabs.clear()
        c0 = dict(counters)
        e0 = engine.get_counters()
        zero_launch_counts()
        engine.epilogue = capturing_epilogue
        t0 = time.perf_counter()
        try:
            view = cache.view(ls, dests, csr=csr, engine=engine)
            if timer.cuda:
                torch.cuda.synchronize()
        finally:
            engine.epilogue = epilogue
        view_ms = (time.perf_counter() - t0) * 1e3
        launches = launch_counts()
        e1 = engine.get_counters()
        t0 = time.perf_counter()
        cold = FleetViewCache(delta=False).view(ls, dests, csr=csr, engine=engine)
        if timer.cuda:
            torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
        if not (same(view._dist_dev, cold._dist_dev) and same(view._bitmap_dev, cold._bitmap_dev)):
            raise AssertionError(f"{what}: the delta cache's view differs from a cold view")
        served = view.warm_mode == "delta"
        rec = {
            "warm_mode": view.warm_mode,
            "bit_equal": True,
            "version": ls.version,
            "affected_cols": updater.last_cols if served else None,
            "pb": updater.last_pb if served else None,
            "relax_blocks": updater.last_blocks if served else None,
            "frontier_passes": updater.last_passes,
            "op_ms": dict(op_ms),
            "host_csr_refresh_ms": refresh_ms,
            "view_ms": view_ms,
            "cold_view_ms": cold_ms,
            "k1_launches": launches,
            "delta_counters": {
                k: counters.get(k, 0) - c0.get(k, 0)
                for k in counters if counters.get(k, 0) != c0.get(k, 0)
            },
            "engine_delta": {
                k.removeprefix("device.engine."): e1[k] - e0.get(k, 0)
                for k in e1
                if e1[k] != e0.get(k, 0) and not k.endswith("_us")
            },
        }
        # a served view launches K1 once per relax; the fallback's legacy
        # view at least once
        k1 = launches[KERNEL_U16["name"]]
        if sum(launches.values()) != k1 or (
            k1 != int(bool(updater.last_cols)) if served else k1 < 1
        ):
            raise AssertionError(f"{what}: K1 launched {launches}")
        slab = None
        if served and updater.last_cols:
            d, groups, n_words = slabs[-1]
            slab = (d, groups, n_words, view._runner, view._out)
        return view, rec, slab

    if timer.cuda:
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    first = cache.view(ls, dests, csr=csr, engine=engine)
    if timer.cuda:
        torch.cuda.synchronize()
    cold_first_ms = (time.perf_counter() - t0) * 1e3
    if first.warm or first._dist_dev.dtype != torch.uint16 or first.node_sharded:
        raise AssertionError("flap storm: the first view is not a cold uint16 fused view")
    engine.delta_register(
        first._dist_dev.numel() * first._dist_dev.element_size()
        + first._bitmap_dev.numel() * first._bitmap_dev.element_size()
    )
    cold_sweeps = first.sweep_hint

    # the seeded event stream: (link, metric) per event, as bench.py
    ev_rng = np.random.default_rng(seed + 1)
    per_chunk = n_events // n_chunks
    chunk_events = []
    for _ in range(n_chunks):
        events = []
        for _ in range(per_chunk):
            src, dst, base = flappy[int(ev_rng.integers(len(flappy)))]
            events.append((src, dst, 90 if int(ev_rng.integers(2)) else base))
        chunk_events.append(events)

    version0 = ls.version
    chunks, storm_slabs = [], []
    k1_storm = 0
    for c, events in enumerate(chunk_events):
        v0 = ls.version
        t0 = time.perf_counter()
        for src, dst, metric in events:
            set_metric(src, dst, metric)
        t_events = time.perf_counter() - t0
        view, rec, slab = delta_view(f"storm chunk {c}")
        if view.warm_mode != "delta":
            raise AssertionError(f"storm chunk {c}: served by {view.warm_mode}")
        k1_storm += rec["k1_launches"][KERNEL_U16["name"]]
        chunks.append(
            {"chunk": c, "events": len(events), "version_advance": ls.version - v0,
             "host_events_s": t_events, **rec}
        )
        if slab is not None:
            storm_slabs.append((c, *slab))
    storm_counters = dict(counters)
    storm_engine = engine.get_counters()
    advance = ls.version - version0
    if storm_engine["device.engine.full_restages"] != 1:
        raise AssertionError(f"flap storm: full_restages {storm_engine['device.engine.full_restages']}")
    if storm_engine["device.engine.delta_overflow_fallbacks"] != 0:
        raise AssertionError("flap storm: a chunk overflowed the bucket ladder")
    if storm_counters.get("decision.delta.updates", 0) + storm_counters.get(
        "decision.delta.noop_updates", 0
    ) != n_chunks:
        raise AssertionError(f"flap storm: {storm_counters}")
    if storm_counters.get("decision.delta.events_coalesced", 0) != advance:
        raise AssertionError(
            f"flap storm: {storm_counters.get('decision.delta.events_coalesced')} "
            f"events coalesced, LinkState advanced {advance}"
        )
    sweep_cols = sum(ch["relax_blocks"] * 4 * ch["pb"] for ch in chunks)
    work_ratio = sweep_cols / (n_chunks * cold_sweeps * p)

    # an edge-set change: a symmetric backup link's adjacency down, then up
    avoid = {x for s, d, _ in flappy for x in (s, d)}
    a, b = symmetric_ring_link(n, 10, avoid)
    db_a = dbs_now[names[a]]
    extra = {}
    for what, db in (
        ("adjacency_down", with_adjacency(db_a, names[b], drop=True)),
        ("adjacency_up", db_a),
    ):
        seq0 = csr.rewire_seq
        ls.update_adjacency_database(db)
        dbs_now[names[a]] = db
        view, rec, slab = delta_view(what)
        if view.warm_mode != "delta" or "rows_bitmap" not in rec["op_ms"]:
            raise AssertionError(f"{what}: {rec['warm_mode']}, ops {sorted(rec['op_ms'])}")
        if csr.rewire_seq == seq0:
            raise AssertionError(f"{what}: the mirror did not rewire")
        extra[what] = {"link": [names[a], names[b]], "rewire_seq": csr.rewire_seq, **rec}
        if slab is not None:
            storm_slabs.append((what, *slab))

    # primary links worsened: every out-adjacency of the endpoint of a
    # metric-1 ring link raised to 90; its row loses every support in
    # every column, so the frontier overflows and the fallback serves
    pa, _ = symmetric_ring_link(n, 1, avoid | {a, b})
    db_p = dbs_now[names[pa]]
    raised = dataclasses.replace(
        db_p,
        adjacencies=[dataclasses.replace(x, metric=90) for x in db_p.adjacencies],
    )
    over0 = engine.get_counters()["device.engine.delta_overflow_fallbacks"]
    fall0 = counters.get("decision.delta.fallbacks", 0)
    ls.update_adjacency_database(raised)
    view, rec, _ = delta_view("primary links worsened")
    if (
        view.warm_mode == "delta"
        or counters.get("decision.delta.fallbacks", 0) != fall0 + 1
        or engine.get_counters()["device.engine.delta_overflow_fallbacks"] != over0 + 1
    ):
        raise AssertionError(f"primary links worsened: {rec}")
    extra["primary_worsened"] = {
        "node": names[pa], "adjacencies": len(db_p.adjacencies), **rec
    }
    del view

    # K1 against its plain version on the slabs the relaxes produced
    slab_records = {"uint16": [], "int32": []}
    for where, *slab in storm_slabs:
        for variant, rec in slab_pair_records(*slab, timer, f"slab of {where}").items():
            slab_records[variant].append({"chunk": where, **rec})
    del storm_slabs

    # restore every link the phase changed
    for src, dst, base in flappy:
        set_metric(src, dst, base)
    ls.update_adjacency_database(db_p)
    csr.refresh(ls)
    record = {
        "phase": "flap_storm_wan100k",
        "rung": "delta",
        "nodes": n,
        "destinations": p,
        "events": n_events,
        "chunks": chunks,
        "flappy_links": [[names[s], names[d], m] for s, d, m in flappy],
        "cold_view_first_ms": cold_first_ms,
        "cold_sweeps": cold_sweeps,
        "work_ratio": work_ratio,
        "version_advance": advance,
        "k1_uint16_launches": k1_storm,
        "decision_counters": storm_counters,
        "engine_counters": {
            k.removeprefix("device.engine."): v
            for k, v in storm_engine.items() if not k.endswith("_us")
        },
        "delta_dispatch_us": storm_engine["device.engine.delta_dispatch_us"],
        "other_chunks": extra,
        "k1_slabs": slab_records,
        "phase_s": time.perf_counter() - t_phase,
    }
    if timer.cuda:
        record["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    return record, slab_records, k1_storm


class DecodeTimer:
    """Wraps a mirror's `to_spf_results` (the host decode of a device
    query) and sums its wall time until `close()`."""

    def __init__(self, csr) -> None:
        self.ms = 0.0
        self.csr = csr
        decode = csr.to_spf_results

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = decode(*args, **kwargs)
            self.ms += (time.perf_counter() - t0) * 1e3
            return out

        csr.to_spf_results = timed

    def take(self) -> float:
        ms, self.ms = self.ms, 0.0
        return ms

    def close(self) -> None:
        del self.csr.to_spf_results


class GcClock:
    """Wall time of the cyclic garbage collector's runs (gc.callbacks)
    until `close()`: host phases allocate millions of objects, and a
    full collection walks the whole heap."""

    def __init__(self) -> None:
        self.ms = 0.0
        self._t0 = None
        gc.callbacks.append(self._tick)

    def _tick(self, phase, info) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms += (time.perf_counter() - self._t0) * 1e3

    def take(self) -> float:
        ms, self.ms = self.ms, 0.0
        return ms

    def close(self) -> None:
        gc.callbacks.remove(self._tick)


def same_route_db(got, want, what: str) -> None:
    if got.unicast_routes != want.unicast_routes or got.mpls_routes != want.mpls_routes:
        raise AssertionError(f"{what}: route DB differs from the host backend's")


def spf_view(result) -> dict:
    """Metric and sorted next hops per node of an SpfResult."""
    return {n: (r.metric, sorted(r.next_hops)) for n, r in result.items()}


def chord_swap_dbs(ls, csr, a: str):
    """Databases that swap one chord of `a` (a link to a node more than two
    ring steps away) for a link to a non-neighbour c whose ELL row has a
    free slot, with the chord's metrics: (a's, b's, c's), (b, c)."""
    import dataclasses

    from openr_tpu_torch.types import Adjacency

    n = csr.n_nodes
    i_a = csr.node_id[a]
    dbs = ls.get_adjacency_databases()
    db_a = dbs[a]

    def ring_steps(j):
        d = abs(j - i_a) % n
        return min(d, n - d)

    chord = next(
        adj for adj in db_a.adjacencies
        if ring_steps(csr.node_id[adj.other_node_name]) > 2
    )
    b = chord.other_node_name
    back = next(adj for adj in dbs[b].adjacencies if adj.other_node_name == a)
    live = csr.edge_live[: csr.n_edges]
    deg = np.bincount(csr.edge_dst[: csr.n_edges][live], minlength=csr.node_capacity)
    k_of = np.concatenate([np.full(bk.nbr.shape[0], bk.nbr.shape[1]) for bk in csr.ell.buckets])
    k_of = k_of[csr.ell.new_of_old]
    near = {adj.other_node_name for adj in db_a.adjacencies} | {a}
    c = next(
        csr.node_names[j] for j in range(n // 3, n)
        if deg[j] < k_of[j] and csr.node_names[j] not in near
    )
    i_c = csr.node_id[c]
    ac = Adjacency(c, f"if_{a}_{c}", metric=chord.metric,
                   other_if_name=f"if_{c}_{a}", next_hop_v6=f"fe80::{i_c:x}")
    ca = Adjacency(a, f"if_{c}_{a}", metric=back.metric,
                   other_if_name=f"if_{a}_{c}", next_hop_v6=f"fe80::{i_a:x}")
    new = (
        dataclasses.replace(
            db_a, adjacencies=[x for x in db_a.adjacencies if x is not chord] + [ac]
        ),
        dataclasses.replace(
            dbs[b], adjacencies=[x for x in dbs[b].adjacencies if x is not back]
        ),
        dataclasses.replace(dbs[c], adjacencies=[*dbs[c].adjacencies, ca]),
    )
    return new, (b, c)


def default_solver(router: str, device):
    """`SpfSolver(router)`, the entry point Decision calls: its default
    DeviceSpfBackend on the CUDA card.  A CPU rehearsal names its device."""
    from openr_tpu_torch.decision.spf_solver import SpfSolver

    return SpfSolver(router) if device == "cuda" else SpfSolver(router, device=device)


def spf_main_path(device, inp, timer, n_prefetch=8, n_checked=4,
                  n_sweep=64) -> dict:
    """The per-source route build Decision runs by default, through
    `SpfSolver(R)` with no arguments, for one router R of the main path's
    LinkState: (a) a cold build; (b) a transit neighbour of R drained,
    then undrained (each an in-place refresh and an incremental sync);
    (c) a chord of R swapped for a new link (a rewire); (d) a prefetch of
    `n_prefetch` sources in one query; (e) the fleet route build of the
    main path's routers on the same refreshed mirror, held against a cold
    view on a fresh mirror; (f) the single-source query against the host
    Dijkstra.  Every route DB equals the host backend's.  The per-sweep
    times are taken at S = 1 and S = `n_sweep`."""
    import dataclasses

    import torch

    from openr_tpu_torch.decision import csr as csr_module
    from openr_tpu_torch.decision.fleet import FleetViewCache, fleet_destinations
    from openr_tpu_torch.decision.spf_solver import HostSpfBackend, SpfSolver
    from openr_tpu_torch.device.engine import _s_bucket
    from openr_tpu_torch.ops import epilogue as ep
    from openr_tpu_torch.ops import sssp as ops

    ls, area, ps, names = inp.ls, inp.area, inp.ps, inp.names
    router = inp.routers[0]
    solver = default_solver(router, device)
    backend, engine = solver.spf, solver.engine
    # the fleet view of (e) is the main path's: the fused rung
    engine.blocked.node_shard_threshold = len(names)
    host = SpfSolver(router, spf_backend=HostSpfBackend())

    def synced():
        if timer.cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    def build(what):
        """One per-source build and the host backend's, held equal.  The
        engine's query time excludes the decode (`last_query_us`)."""
        c0 = engine.get_counters()
        decode.take()
        gc_clock.take()
        t0 = synced()
        got = solver.build_route_db(area, ps)
        t_dev = synced() - t0
        gc_dev = gc_clock.take()
        t0 = time.perf_counter()
        want = host.build_route_db(area, ps)
        t_host = time.perf_counter() - t0
        same_route_db(got, want, what)
        c1 = engine.get_counters()
        query_ms = engine.last_query_us / 1e3
        decode_ms = decode.take()
        return got, {
            "build_s": t_dev,
            "spf_results_ms": query_ms,
            "to_spf_results_ms": decode_ms,
            "route_build_ms": t_dev * 1e3 - query_ms - decode_ms,
            "gc_ms": gc_dev,
            "host_build_s": t_host,
            "host_gc_ms": gc_clock.take(),
            "counters_delta": {
                k.removeprefix("device.engine."): c1[k] - c0[k]
                for k in c1 if c1[k] != c0[k] and not k.endswith("_us")
            },
        }

    def counter(name):
        return engine.get_counters()[f"device.engine.{name}"]

    # (a) cold
    gc.collect()
    gc_clock = GcClock()
    t0 = time.perf_counter()
    csr = backend.csr_mirror(ls)
    t_mirror = time.perf_counter() - t0
    decode = DecodeTimer(csr)
    try:
        hint0 = csr._sweep_hint
        db_r, cold = build("cold")
        res = engine._residents[id(csr)]
        cold.update(
            mirror_build_s=t_mirror,
            restage_bytes=cold["counters_delta"].get("bytes_staged"),
            attempts=int(np.log2(res.sweep_hint // hint0)) + 1,
            sweep_hint=res.sweep_hint,
        )
        if counter("full_restages") != 1 or counter("queries") != 1:
            raise AssertionError(f"cold build: {engine.get_counters()}")

        # (b) drain and undrain a transit neighbour of R
        advertisers = set(inp.advertisers)
        transit = next(
            n for n in sorted(l.other_node_name(router) for l in ls.links_from_node(router))
            if n not in advertisers
        )
        db_t = ls.get_adjacency_databases()[transit]
        flaps = {}
        for name, db in (
            ("drain", dataclasses.replace(db_t, is_overloaded=True)),
            ("undrain", db_t),
        ):
            before = counter("incremental_updates")
            ls.update_adjacency_database(db)
            t0 = time.perf_counter()
            kept = csr.refresh(ls)
            refresh_ms = (time.perf_counter() - t0) * 1e3
            _, step = build(name)
            if not kept or counter("incremental_updates") != before + 1 or counter(
                "full_restages"
            ) != 1:
                raise AssertionError(f"{name}: kept {kept}, {engine.get_counters()}")
            flaps[name] = {"refresh_ms": refresh_ms, **step}

        # (c) a chord swap: one link removed, one added, three databases
        swap_dbs, (b, c) = chord_swap_dbs(ls, csr, router)
        rewires0 = counter("rewires")
        for db in swap_dbs:
            ls.update_adjacency_database(db)
        t0 = time.perf_counter()
        kept = csr.refresh(ls)
        refresh_ms = (time.perf_counter() - t0) * 1e3
        db_swap, swap = build("chord swap")
        if (
            not kept
            or counter("rewires") != rewires0 + 1
            or counter("rewire_dispatches") != 1
            or counter("rewire_fallbacks")
            or counter("full_restages") != 1
        ):
            raise AssertionError(f"chord swap: kept {kept}, {engine.get_counters()}")
        swap.update(
            refresh_ms=refresh_ms, link_removed=[router, b], link_added=[router, c],
            rewire_slots=counter("rewire_slots"), rewire_rows=counter("rewire_rows"),
        )

        # (d) one prefetch query of `n_prefetch` sources
        n = len(names)
        sources = [names[i * n // n_prefetch] for i in range(n_prefetch)]
        missing = [s for s in sources if s not in backend._result_cache(ls)]
        q0 = counter("queries")
        decode.take()
        gc_clock.take()
        t0 = synced()
        backend.prefetch(ls, sources)
        prefetch_s = synced() - t0
        prefetch_gc_ms = gc_clock.take()
        if counter("queries") != q0 + 1 or _s_bucket(len(missing)) != _s_bucket(
            n_prefetch
        ):
            raise AssertionError(f"prefetch: {len(missing)} missing, {engine.get_counters()}")
        checked = sources[:: n_prefetch // n_checked][:n_checked]
        t0 = time.perf_counter()
        for src in checked:
            if spf_view(backend.get_spf_result(ls, src)) != spf_view(ls.get_spf_result(src)):
                raise AssertionError(f"prefetch: SPF of {src} differs from Dijkstra")
        prefetch = {
            "sources": len(sources),
            "queried": len(missing),
            "bucket": _s_bucket(len(missing)),
            "prefetch_s": prefetch_s,
            "spf_results_ms": engine.last_query_us / 1e3,
            "to_spf_results_ms": decode.take(),
            "gc_ms": prefetch_gc_ms,
            "checked_sources": checked,
            "oracle_check_s": time.perf_counter() - t0,
        }

        # (e) the fleet route build on the refreshed mirror: no fresh build
        real = csr_module.CsrTopology.from_link_state
        builds = []

        def counted(*args, **kwargs):
            builds.append(args)
            return real(*args, **kwargs)

        csr_module.CsrTopology.from_link_state = counted
        try:
            ep.fused_epilogue.launches = 0
            k1_0 = engine.counters["device.engine.kernel_launches.fused_epilogue"]
            t0 = synced()
            fleet_dbs = solver.fleet_route_dbs(area, ps, nodes=inp.routers)
            fleet_s = synced() - t0
            k1 = ep.fused_epilogue.launches
        finally:
            csr_module.CsrTopology.from_link_state = real
        view = solver.fleet._views[ls]
        if builds or view.csr is not csr:
            raise AssertionError("the fleet view did not take the refreshed mirror")
        if k1 != 1 or engine.counters["device.engine.kernel_launches.fused_epilogue"] - k1_0 != 1:
            raise AssertionError(f"fleet view on the mirror launched K1 {k1} times")
        same_route_db(fleet_dbs[router], db_swap, "fleet view")
        t0 = time.perf_counter()
        fresh = real(ls)
        fresh_ms = (time.perf_counter() - t0) * 1e3
        cold_view = FleetViewCache().view(
            ls, fleet_destinations(ls, ps), csr=fresh, engine=engine
        )
        if not (
            same(view._dist_dev, cold_view._dist_dev)
            and same(view._bitmap_dev, cold_view._bitmap_dev)
        ):
            raise AssertionError("view on the refreshed mirror differs from a cold view")
        fleet = {
            "routers": len(inp.routers),
            "k1_launches": k1,
            "route_builds_s": fleet_s,
            "equal_to_cold_view_on_fresh_mirror": True,
            "fresh_mirror_build_ms": fresh_ms,
            "mirror_refresh_ms": {
                **{k: v["refresh_ms"] for k, v in flaps.items()},
                "chord_swap": swap["refresh_ms"],
            },
        }
        del cold_view, fresh

        # (f) one source against the host Dijkstra, median of 3 each
        src = names[n // 2]
        dev_ms, dev_query_ms, host_ms, dev_gc, host_gc = [], [], [], [], []
        for _ in range(3):
            gc_clock.take()
            t0 = synced()
            got = engine.spf_results(csr, [src])[src]
            dev_ms.append((synced() - t0) * 1e3)
            dev_gc.append(gc_clock.take())
            dev_query_ms.append(engine.last_query_us / 1e3)
        for _ in range(3):
            t0 = time.perf_counter()
            want = ls.run_spf(src)
            host_ms.append((time.perf_counter() - t0) * 1e3)
            host_gc.append(gc_clock.take())
        if spf_view(got) != spf_view(want):
            raise AssertionError(f"S = 1: SPF of {src} differs from Dijkstra")
        crossover = {
            "source": src,
            "device_ms": float(np.median(dev_ms)),
            "device_without_decode_ms": float(np.median(dev_query_ms)),
            "host_dijkstra_ms": float(np.median(host_ms)),
            "device_all_ms": dev_ms,
            "host_all_ms": host_ms,
            "device_gc_ms": dev_gc,
            "host_gc_ms": host_gc,
        }

        # the per-source relax and first-hop sweeps at the learned hint
        res = engine._residents[id(csr)]
        h = res.sweep_hint
        n_words = max(1, -(-csr.max_out_slots // 32))
        sweeps = {}
        sweep_sources = [names[i * n // n_sweep] for i in range(n_sweep)]
        for s in (1, n_sweep):
            ids = torch.as_tensor(
                [csr.node_id[x] for x in sweep_sources[:s]], dtype=torch.int32,
                device=res.edge_src.device,
            )
            d0 = ops.make_dist0_T(ids, res.ell.new_of_old, csr.node_capacity)
            _, dag, _, _ = ops.spf_forward_full(
                ids, res.ell, res.edge_src, res.edge_dst, res.edge_metric,
                res.edge_up, res.node_overloaded, res.out_slot, n_words, h,
            )
            dag_t = dag.T
            relax_ms = timer.ms(
                lambda: ops.batched_sssp_ell(
                    d0, res.ell, res.edge_up, res.node_overloaded,
                    res.edge_metric, n_sweeps=h,
                ),
                reps=3,
            )
            fh_ms = timer.ms(
                lambda: ops.first_hops_ell(
                    res.ell, dag_t, res.out_slot, ids, res.edge_src, n_words, h
                )[1].item(),
                reps=3,
            )
            # least bytes of one sweep: the [N_cap, S] state (times W for
            # the first hops) read once and written once, and each
            # loop-invariant table the sweep reads once: the relax's
            # (gather index, up, transit, weight) per slot, the first hops'
            # gather index and [R, K, S] DAG mask per slot and [R, S, W]
            # source bits per row
            state_bytes = csr.node_capacity * s * 4
            relax_tables = sum(
                t.nbytes
                for _, _, chunks in ops._slot_chunks(
                    res.ell, res.edge_up, res.node_overloaded, res.edge_metric, s
                )
                for chunk in chunks
                for t in chunk
            )
            fh_tables = sum(
                r * k * (4 + s) + r * s * n_words * 4
                for r, k in (tuple(bk.nbr.shape) for bk in res.ell.buckets)
            )
            relax_bytes = 2 * state_bytes + relax_tables
            fh_bytes = 2 * state_bytes * n_words + fh_tables
            sweeps[f"S{s}"] = {
                "relax_sweep_ms": relax_ms / (h + 1),
                "first_hops_sweep_ms": fh_ms / (h + 1),
                "relax_sweep_bytes": relax_bytes,
                "first_hops_sweep_bytes": fh_bytes,
                "relax_sweep_bound_ms": relax_bytes / HBM_BYTES_PER_S * 1e3,
                "first_hops_sweep_bound_ms": fh_bytes / HBM_BYTES_PER_S * 1e3,
            }
        record = {
            "phase": "spf_main_path",
            "router": router,
            "nodes": csr.n_nodes,
            "directed_edges": int(csr.n_live),
            "node_capacity": csr.node_capacity,
            "edge_capacity": csr.edge_capacity,
            "ell_buckets": [list(bk.nbr.shape) for bk in csr.ell.buckets],
            "n_words": n_words,
            "cold": cold,
            "flaps": flaps,
            "chord_swap": swap,
            "prefetch": prefetch,
            "fleet": fleet,
            "crossover_s1": crossover,
            "sweeps": sweeps,
            "sweep_hint": h,
            "engine_counters": {
                k.removeprefix("device.engine."): v
                for k, v in engine.get_counters().items()
            },
        }
        if timer.cuda:
            record["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        return record
    finally:
        decode.close()
        gc_clock.close()


class MethodClock:
    """Wraps methods of module instances and records each call's wall
    time under a label until `close()`; calls may come from any thread."""

    def __init__(self) -> None:
        self.calls: dict[str, list[float]] = {}
        self._wrapped = []

    def wrap(self, obj, method: str, label: str) -> None:
        real = getattr(obj, method)
        calls = self.calls.setdefault(label, [])

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                calls.append((time.perf_counter() - t0) * 1e3)

        setattr(obj, method, timed)
        self._wrapped.append((obj, method))

    def take(self) -> dict:
        out = {}
        for label, calls in self.calls.items():
            out[label] = list(calls)
            calls.clear()
        return out

    def close(self) -> None:
        for obj, method in self._wrapped:
            delattr(obj, method)


def agent_tables(agent) -> tuple[dict, dict]:
    """A MockFibAgent's programmed (unicast, MPLS) tables of the Open/R
    client, keyed by prefix and label."""
    from openr_tpu_torch.fib.fib import FIB_CLIENT_OPENR

    return (
        {r.dest: r for r in agent.get_route_table_by_client(FIB_CLIENT_OPENR)},
        {r.top_label: r for r in agent.get_mpls_route_table_by_client(FIB_CLIENT_OPENR)},
    )


def perf_trail(perf_events) -> dict:
    """Each perf event's time after the trail's first, in ms."""
    if perf_events is None or not perf_events.events:
        return {}
    t0 = perf_events.events[0].unix_ts_ms
    return {e.event_name: e.unix_ts_ms - t0 for e in perf_events.events}


def decision_main_path(device, timer, n_nodes, n_advertisers, n_routers,
                       n_checked, adj_label_base=200_000) -> dict:
    """Decision → Fib from a KvStore publication, on the main path's
    wan100k: every adjacency and prefix database serialized with the
    port's `dumps` into one Publication, pushed into
    `Decision(router, device=...)` (its default DeviceSpfBackend) wired
    through a ReplicateQueue to `Fib(..., MockFibAgent())`, and into a
    second Decision on `HostSpfBackend()` with its own Fib, the oracle.
    Router w000000's adjacencies carry adjacency labels, so its route DB
    holds adjacency-label routes.  Each step goes to the card's Decision
    first and to the oracle once the card's agent has programmed it.
    Then, one at a time: (a) one link's
    metric raised, (b) one prefix withdrawn by an expired key, (c) that
    prefix advertised again, (d) one node's adjacency key expired, (e) a
    static unicast and a static MPLS route, (f) a RibPolicy set, then
    cleared, (g) the operator queries, (h) the flap storm's four backup
    links raised to 90 in one publication of their source nodes'
    adjacency databases, then restored in another, (i) the serving layer
    over the card Decision (`decision_serving`).  After every step
    both agents' tables are equal element for element, the card's engine
    counters moved as the step requires, and neither Decision counted a
    rebuild failure.  The card Decision has the fleet views' delta rung
    on (`fleet_delta=True`, as the reference daemon builds a device
    Decision).  The fleet dump `get_fleet_route_dbs` of the main path's
    routers runs after the cold start and after (a), on the fused rung,
    and of the checked routers before (h) and after each of its
    publications, each of those two served by the delta rung
    (`decision.delta.updates` rises); each dump records its rung and
    launches K1's uint16 variant once (none on a delta update that
    re-relaxed no column), and four of its route DBs (only the router's
    own in the dump that re-bases the view before (h)) equal the
    oracle's `get_route_db(router)`."""
    import dataclasses

    import torch

    from openr_tpu_torch.decision.decision import Decision
    from openr_tpu_torch.decision.rib import (
        DecisionRouteUpdate,
        RibMplsEntry,
        RibUnicastEntry,
    )
    from openr_tpu_torch.decision.rib_policy import (
        RibPolicyConfig,
        RibPolicyStatementConfig,
        RibRouteActionWeight,
    )
    from openr_tpu_torch.decision.spf_solver import HostSpfBackend
    from openr_tpu_torch.fib import Fib, MockFibAgent
    from openr_tpu_torch.runtime.queue import ReplicateQueue
    from openr_tpu_torch.serializer import dumps
    from openr_tpu_torch.types import (
        MplsAction,
        MplsActionCode,
        NextHop,
        PerfEvents,
        PrefixDatabase,
        PrefixEntry,
        Publication,
        Value,
        adj_key,
        prefix_key,
    )
    from openr_tpu_torch.utils import topo

    t_phase = time.perf_counter()
    gc.collect()
    gc_clock = GcClock()
    clock = MethodClock()

    # the main path's topology and advertisers, w000000 with adj labels
    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    adv_ids = np.sort(rng.choice(n_nodes, size=n_advertisers, replace=False))
    dbs = topo.wan_topology(n_nodes, chords=2, seed=0, labeled=adv_ids)
    names = [db.this_node_name for db in dbs]
    router = names[0]
    for k, adj in enumerate(dbs[0].adjacencies):
        adj.adj_label = adj_label_base + k
    advertisers = [names[i] for i in adv_ids]
    prefixes = [f"fc00:{i >> 16:x}:{i & 0xFFFF:x}::/64" for i in adv_ids]
    t_topology = time.perf_counter() - t0

    def adj_value(db, version=1):
        return Value(version=version, originator_id=db.this_node_name, value=dumps(db))

    def prefix_value(node, prefix, version=1, delete=False):
        db = PrefixDatabase(node, [PrefixEntry(prefix=prefix)], delete_prefix=delete)
        return Value(version=version, originator_id=node, value=dumps(db))

    t0 = time.perf_counter()
    key_vals = {adj_key(db.this_node_name): adj_value(db) for db in dbs}
    for node, prefix in zip(advertisers, prefixes):
        key_vals[prefix_key(node, prefix, "0")] = prefix_value(node, prefix)
    publication = Publication(key_vals=key_vals, area="0")
    t_dumps = time.perf_counter() - t0
    publication_bytes = sum(len(v.value) for v in key_vals.values())
    publication_keys = len(key_vals)
    # what the steps need of the databases; the rest leaves the heap,
    # which every full collection walks
    n_adj_labels = len(dbs[0].adjacencies)
    nbr = dbs[0].adjacencies[0].other_node_name
    x, db_x = names[n_nodes // 3], dbs[n_nodes // 3]
    # step (h)'s backup links: the flap storm's, from their source nodes
    backups = [(names[s], names[d]) for s, d, _ in backup_ring_links(n_nodes)]
    backup_dbs = {s: dbs[names.index(s)] for s, _ in backups}
    del key_vals, dbs

    sides = {}
    for side, kwargs in (
        # the card Decision as the reference daemon builds a device-backed
        # one (openr_tpu/main.py): the fleet views' delta rung on
        ("card", {"device": device, "fleet_delta": True}),
        ("oracle", {"spf_backend": HostSpfBackend(), "device": device}),
    ):
        kvq, staticq, routeq, fibq = (ReplicateQueue() for _ in range(4))
        decision = Decision(
            router, kvq.get_reader(), staticq.get_reader(), routeq,
            enable_rib_policy=True, **kwargs,
        )
        agent = MockFibAgent()
        fib = Fib(router, routeq.get_reader(), agent, fib_updates_queue=fibq)
        clock.wrap(decision, "process_publication", f"{side}_parse_ms")
        clock.wrap(decision, "rebuild_routes", f"{side}_rebuild_ms")
        clock.wrap(fib, "process_route_updates", f"{side}_fib_ms")
        sides[side] = dict(
            kvq=kvq, staticq=staticq, routeq=routeq, fibq=fibq,
            programmed=fibq.get_reader(), decision=decision, agent=agent,
            fib=fib,
        )
    card, oracle = sides["card"], sides["oracle"]
    engine = card["decision"].spf_solver.engine
    # the fleet dumps are the main path's: the fused rung
    engine.blocked.node_shard_threshold = n_nodes
    for s in sides.values():
        s["fib"].run()
        s["decision"].run()

    def counters():
        return {
            k.removeprefix("device.engine."): v
            for k, v in engine.get_counters().items()
            if not k.endswith("_us")
        }

    def push(what, fn):
        """Push one step into the card's Decision and wait for its agent
        to program it, then the same into the oracle's (so neither shares
        the interpreter with the other while it works), and hold the two
        agents' tables equal."""
        c0 = counters()
        clock.take()
        wall_s, gc_ms, programmed = {}, {}, {}
        for side, s in sides.items():
            gc_clock.take()
            t0 = time.perf_counter()
            fn(s)
            programmed[side] = s["programmed"].get(timeout=900)
            wall_s[side] = time.perf_counter() - t0
            gc_ms[side] = gc_clock.take()
        got, want = agent_tables(card["agent"]), agent_tables(oracle["agent"])
        if got != want:
            raise AssertionError(f"{what}: the card's agent tables differ from the oracle's")
        for side, s in sides.items():
            n_fail = s["decision"].get_counters()["decision.route_rebuild_failures"]
            if n_fail:
                raise AssertionError(f"{what}: {side} counted {n_fail} rebuild failures")
        c1 = counters()
        return {
            "wall_s": wall_s,
            "unicast_routes": len(got[0]),
            "mpls_routes": len(got[1]),
            "perf_events_ms": perf_trail(programmed["card"].perf_events),
            "oracle_perf_events_ms": perf_trail(programmed["oracle"].perf_events),
            **clock.take(),
            "gc_ms": gc_ms,
            "engine_delta": {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]},
        }

    def expect(step, what, **deltas):
        moved = {
            k: v for k, v in step["engine_delta"].items()
            if k in ("queries", "incremental_updates", "rewires", "full_restages")
        }
        if moved != deltas:
            raise AssertionError(f"{what}: engine moved {moved}, expected {deltas}")

    routers = [names[i * n_nodes // n_routers] for i in range(n_routers)]
    checked = routers[:: max(1, n_routers // n_checked)][: n_checked - 1] + routers[-1:]

    card_solver = card["decision"].spf_solver

    def fleet_dump(what, nodes=routers, oracle_routers=checked):
        """The card Decision's fleet dump of `nodes`, K1's counts set to 0
        just before it and read just after; the rung that served its view
        (`warm_mode`: None cold, "improve" / "worsen" warm, "delta") is
        recorded.  K1 runs once, except on a delta update that re-relaxed
        no column (none)."""
        zero_launch_counts()
        d0 = dict(card_solver.counters)
        gc_clock.take()
        t0 = time.perf_counter()
        out = card["decision"].get_fleet_route_dbs(nodes=nodes)
        if timer.cuda:
            torch.cuda.synchronize()
        dump_s = time.perf_counter() - t0
        launches = launch_counts()
        view = card_solver.fleet._views[card["decision"].area_link_states["0"]]
        updater = card_solver.fleet._delta
        want = 0 if view.warm_mode == "delta" and not updater.last_cols else 1
        if launches[KERNEL_U16["name"]] != want or sum(launches.values()) != want:
            raise AssertionError(f"{what}: fleet dump launched {launches}")
        dump_gc = gc_clock.take()
        t0 = time.perf_counter()
        for r in oracle_routers:
            same_route_db(out[r], oracle["decision"].get_route_db(r), f"{what} {r}")
        delta = {
            k: card_solver.counters[k] - d0.get(k, 0)
            for k in card_solver.counters
            if k.startswith("decision.delta.")
            and card_solver.counters[k] != d0.get(k, 0)
        }
        return {
            "dump_s": dump_s,
            "gc_ms": dump_gc,
            "launches": launches,
            "rung": view.warm_mode,
            "affected_cols": updater.last_cols if view.warm_mode == "delta" else None,
            "delta_counters": delta,
            "routers": len(out),
            "checked_routers": oracle_routers,
            "oracle_check_s": time.perf_counter() - t0,
        }

    steps = {}
    dumps_rec = {}
    try:
        # cold start: one publication of every database
        step = push("cold start", lambda s: s["kvq"].push(publication))
        del publication
        expect(step, "cold start", queries=1, full_restages=1)
        if step["mpls_routes"] < n_advertisers + n_adj_labels:
            raise AssertionError("cold start: node or adjacency label routes missing")
        steps["cold"] = step
        dumps_rec["cold"] = fleet_dump("fleet dump after the cold start")

        # (a) one link's metric raised
        first = db_x.adjacencies[0]
        raised = dataclasses.replace(
            db_x,
            adjacencies=[
                dataclasses.replace(first, metric=4 * first.metric + 10),
                *db_x.adjacencies[1:],
            ],
        )

        def pub_a():
            # the trail starts where the database is published
            raised.perf_events = PerfEvents()
            raised.perf_events.add(x, "ADJ_DB_UPDATED")
            return Publication(key_vals={adj_key(x): adj_value(raised, 2)}, area="0")

        step = push("metric raised", lambda s: s["kvq"].push(pub_a()))
        expect(step, "metric raised", queries=1, incremental_updates=1)
        steps["a_metric_raised"] = {"link": [x, first.other_node_name], **step}
        dumps_rec["a_metric_raised"] = fleet_dump("fleet dump after (a)")

        # (b) one prefix withdrawn by an expired key, (c) advertised again
        node_p, prefix_p = advertisers[n_advertisers // 2], prefixes[n_advertisers // 2]
        key_p = prefix_key(node_p, prefix_p, "0")
        pub_b = Publication(expired_keys=[key_p], area="0")
        step = push("prefix withdrawn", lambda s: s["kvq"].push(pub_b))
        expect(step, "prefix withdrawn")
        if prefix_p in agent_tables(card["agent"])[0]:
            raise AssertionError("prefix withdrawn: still programmed")
        steps["b_prefix_withdrawn"] = {"prefix": prefix_p, **step}
        pub_c = Publication(key_vals={key_p: prefix_value(node_p, prefix_p, 2)}, area="0")
        step = push("prefix advertised", lambda s: s["kvq"].push(pub_c))
        expect(step, "prefix advertised")
        if prefix_p not in agent_tables(card["agent"])[0]:
            raise AssertionError("prefix advertised: not programmed")
        steps["c_prefix_advertised"] = {"prefix": prefix_p, **step}

        # (d) one node's adjacency key expired
        y = names[2 * n_nodes // 3]
        pub_d = Publication(expired_keys=[adj_key(y)], area="0")
        step = push("node expired", lambda s: s["kvq"].push(pub_d))
        expect(step, "node expired", queries=1, full_restages=1)
        steps["d_node_expired"] = {"node": y, **step}

        # (e) one static unicast and one static MPLS route
        static_nh = NextHop(address="fe80::5ea", if_name="static0")
        static = DecisionRouteUpdate()
        static.add_route_to_update(
            RibUnicastEntry(prefix="fd00:5ea::/64", nexthops=frozenset({static_nh}))
        )
        static.mpls_routes_to_update.append(
            RibMplsEntry(
                label=adj_label_base - 1,
                nexthops=frozenset(
                    {dataclasses.replace(
                        static_nh, mpls_action=MplsAction(MplsActionCode.PHP)
                    )}
                ),
            )
        )
        step = push("static routes", lambda s: s["staticq"].push(static))
        expect(step, "static routes")
        tables = agent_tables(card["agent"])
        if "fd00:5ea::/64" not in tables[0] or adj_label_base - 1 not in tables[1]:
            raise AssertionError("static routes: not programmed")
        steps["e_static_routes"] = step

        # (f) a RibPolicy with a neighbour weight, then cleared
        policy = RibPolicyConfig(
            statements=[
                RibPolicyStatementConfig(
                    name="weight",
                    prefixes=list(prefixes),
                    set_weight=RibRouteActionWeight(
                        default_weight=1, neighbor_to_weight={nbr: 3}
                    ),
                )
            ],
            ttl_secs=3600,
        )
        step = push("policy set", lambda s: s["decision"].set_rib_policy(policy))
        expect(step, "policy set")
        steps["f_policy_set"] = {"neighbor": nbr, **step}
        step = push("policy cleared", lambda s: s["decision"].clear_rib_policy())
        expect(step, "policy cleared")
        steps["f_policy_cleared"] = step

        # (g) the operator queries on the card Decision's mirror
        zero_launch_counts()
        wan_csr = card["decision"].run_in_event_base_thread(
            lambda: card["decision"].spf_solver.spf.csr_mirror(
                card["decision"].area_link_states["0"]
            )
        ).result()
        steps["g_protection"], graph = protection_queries(
            card["decision"], wan_csr, oracle["decision"].area_link_states["0"],
            router, timer,
        )
        steps["g_protection"]["kernel_launches"] = launch_counts()

        # (h) the backup links of the flap storm raised to 90 in one
        # publication of their source nodes' adjacency databases, then
        # restored; a fleet dump of the checked routers after each, on
        # the delta rung (a first dump re-bases the view after (d)'s
        # node expiry changed the universe; of its routes only the
        # router's own are held against the oracle, whose other routers
        # each cost a host Dijkstra)
        dumps_rec["h_before"] = fleet_dump("fleet dump before (h)", checked, [router])
        for what, metric, version in (("h_backups_raised", 90, 2), ("h_backups_restored", None, 3)):
            key_vals = {}
            for src, dst in backups:
                db = backup_dbs[src]
                if metric is not None:
                    db = with_adjacency(db, dst, metric)
                key_vals[adj_key(src)] = adj_value(db, version)
            pub_h = Publication(key_vals=key_vals, area="0")
            updates0 = card_solver.counters["decision.delta.updates"]
            step = push(what, lambda s: s["kvq"].push(pub_h))
            expect(step, what, queries=1, incremental_updates=1)
            steps[what] = {"links": backups, **step}
            dumps_rec[what] = fleet_dump(f"fleet dump after {what}", checked)
            if card_solver.counters["decision.delta.updates"] <= updates0:
                raise AssertionError(f"{what}: the delta rung did not serve the dump")

        # (i) the serving layer over the card Decision
        steps["i_serving"] = decision_serving(
            card["decision"], oracle["decision"], checked, router
        )
        decision_counters = card["decision"].get_counters()
        fib_counters = card["fib"].get_counters()
    finally:
        for s in sides.values():
            for q in ("kvq", "staticq", "routeq", "fibq"):
                s[q].close()
            s["decision"].stop()
            s["fib"].stop()
        clock.close()
        gc_clock.close()
    record = {
        "phase": "decision_main_path",
        "router": router,
        "nodes": n_nodes,
        "advertisers": n_advertisers,
        "adjacency_labels": n_adj_labels,
        "publication_keys": publication_keys,
        "publication_bytes": publication_bytes,
        "topology_s": t_topology,
        "dumps_s": t_dumps,
        "steps": steps,
        "fleet_dumps": dumps_rec,
        "decision_counters": decision_counters,
        "fib_counters": fib_counters,
        "engine_counters": counters(),
        "phase_s": time.perf_counter() - t_phase,
    }
    if timer.cuda:
        record["card"] = card_line()
        record["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    return record, (wan_csr, engine, graph)


def spf_reconverge_fabric96(device, pods, timer, n_prefixes=128,
                            host_reps=3, device_reps=8) -> dict:
    """The reference's reconvergence flow (bench.py
    bench_reconvergence_fattree10k) on BASELINE config #2's own fabric:
    the first rack switch's route DB (every node labelled, `n_prefixes`
    prefixes) rebuilt after each flap of the first fabric switch's
    overload bit, through the host Dijkstra and through `SpfSolver(own)`
    with no arguments (one warm-up build, then `device_reps` timed
    builds).  Every rep's route DB equals the host's for the same
    overload state; the device path restages once and syncs every timed
    rep incrementally."""
    import dataclasses

    import torch

    from openr_tpu_torch.decision.prefix_state import PrefixState
    from openr_tpu_torch.decision.spf_solver import HostSpfBackend, SpfSolver
    from openr_tpu_torch.types import PrefixEntry
    from openr_tpu_torch.utils import topo

    dbs = topo.fat_tree_topology(pods, **FABRIC)
    ls = link_state_of(dbs)
    own = next(d.this_node_name for d in dbs if d.this_node_name.startswith("rsw"))
    flap = next(d for d in dbs if d.this_node_name.startswith("fsw"))
    ps = PrefixState()
    step = max(1, len(dbs) // n_prefixes)
    advertised = 0
    for i in range(0, len(dbs), step):
        if dbs[i].this_node_name != own:
            ps.update_prefix(
                dbs[i].this_node_name, "0", PrefixEntry(prefix=f"::{i:x}:0/112")
            )
            advertised += 1
    host = SpfSolver(own, spf_backend=HostSpfBackend())
    dev = default_solver(own, device)
    backend = dev.spf
    state = {"overloaded": False}
    gc.collect()
    gc_clock = GcClock()

    def run(solver):
        state["overloaded"] = not state["overloaded"]
        ls.update_adjacency_database(
            dataclasses.replace(flap, is_overloaded=state["overloaded"])
        )
        gc_clock.take()
        t0 = time.perf_counter()
        db = solver.build_route_db({"0": ls}, ps)
        if timer.cuda:
            torch.cuda.synchronize()
        return db, (time.perf_counter() - t0) * 1e3, gc_clock.take()

    try:
        want, host_ms, host_gc = {}, [], []
        for _ in range(host_reps):
            db, ms, gc_ms = run(host)
            want[state["overloaded"]] = db
            host_ms.append(ms)
            host_gc.append(gc_ms)
        db, warmup_ms, _ = run(dev)
        same_route_db(db, want[state["overloaded"]], "fabric96 warm-up")
        c0 = backend.engine.get_counters()
        dev_ms, dev_gc = [], []
        for rep in range(device_reps):
            db, ms, gc_ms = run(dev)
            same_route_db(db, want[state["overloaded"]], f"fabric96 rep {rep}")
            dev_ms.append(ms)
            dev_gc.append(gc_ms)
    finally:
        gc_clock.close()
    c1 = backend.engine.get_counters()
    incremental = c1["device.engine.incremental_updates"] - c0["device.engine.incremental_updates"]
    if c1["device.engine.full_restages"] != 1 or incremental != device_reps:
        raise AssertionError(f"fabric96 residency: {c1}")
    csr = backend.csr_mirror(ls)
    return {
        "phase": "spf_reconverge_fabric96",
        "nodes": csr.n_nodes,
        "own_router": own,
        "flapped": flap.this_node_name,
        "advertised_prefixes": advertised,
        "mpls_routes": len(db.mpls_routes),
        "equal_every_rep": True,
        "host_ms_p50": float(np.median(host_ms)),
        "device_ms_p50": float(np.median(dev_ms)),
        "host_ms_all": host_ms,
        "device_ms_all": dev_ms,
        "host_gc_ms": host_gc,
        "device_gc_ms": dev_gc,
        "device_warmup_ms": warmup_ms,
        "sweep_hint": backend.engine._residents[id(csr)].sweep_hint,
        "n_words": max(1, -(-csr.max_out_slots // 32)),
        "engine_ms_per_rep": (
            (c1["device.engine.stage_us"] - c0["device.engine.stage_us"])
            + (c1["device.engine.dispatch_us"] - c0["device.engine.dispatch_us"])
        ) / 1e3 / device_reps,
        "bytes_staged_per_rep": (
            c1["device.engine.bytes_staged"] - c0["device.engine.bytes_staged"]
        ) // device_reps,
        "full_restages": c1["device.engine.full_restages"],
        "incremental_updates": incremental,
    }


def fabric_dbs(pods: int, n_advertisers: int):
    """The fat-tree of BASELINE config #2 with `pods` pods, and
    `n_advertisers` rack switches drawn with np.random.default_rng(7):
    (databases in node-id order, advertiser ids).  Advertisers carry the
    node label 16 + id, every other node none."""
    from openr_tpu_torch.utils import topo

    dbs = topo.fat_tree_topology(pods, **FABRIC)
    racks = [i for i, db in enumerate(dbs) if db.this_node_name.startswith("rsw-")]
    rng = np.random.default_rng(7)
    adv_ids = np.sort(
        rng.choice(racks, size=n_advertisers, replace=False)
    ).astype(np.int32)
    labeled = set(adv_ids.tolist())
    for i, db in enumerate(dbs):
        db.node_label = 16 + i if i in labeled else 0
    return dbs, adv_ids


def fabric_rounds(device, pods: int) -> tuple[int, int]:
    """(tile B, rounds T) of the blocked closure of a `pods`-pod fabric."""
    from openr_tpu_torch.parallel.blocked import BlockedApspEngine

    n = FABRIC["n_planes"] * FABRIC["n_ssw_per_plane"] + pods * (
        FABRIC["n_fsw_per_pod"] + FABRIC["n_rsw_per_pod"]
    )
    b = BlockedApspEngine(device=device).tile_for(n)
    return b, -(-n // b)


def outer_bound_ms(s: int, np_: int, b: int, drained: int,
                   ops_per_s: float) -> tuple[float, str]:
    """Least time of one K2 launch: each element of d read and written
    once plus the panels and drain flags read once, against the
    2 * (B - drained) add-and-min operations per element at the card's
    int32 rate."""
    bytes_ms = (2 * s * np_ * np_ * 4 + 2 * s * np_ * b * 4 + b) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * (b - drained) * s * np_ * np_ / ops_per_s * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def blocked_kernel_vs_plain(device, outer, t_main: int, b_main: int, timer):
    """K2 against `blocked_outer_reference`, bit for bit: random tile
    tensors (values below 2^20, 10% INF, 20% drained lanes) for every
    round k of OUTER_CASES, then three launches (k = 0, T/2, T-1) at the
    blocked main path's full [Np, Np] shape, which are also timed (the
    kernel's work does not depend on the values).  Returns (phase record,
    timing at the main path's shape)."""
    import torch

    from openr_tpu_torch.ops import blocked_outer as bo
    from openr_tpu_torch.ops.sssp import INF32

    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def tiles(s, t, b):
        def randint(*shape):
            return torch.randint(
                0, 1 << 20, shape, dtype=torch.int32, device=device, generator=gen
            )

        d = randint(s, t, b, t, b)
        d.masked_fill_(torch.rand(d.shape, device=device, generator=gen) < 0.1, INF32)
        ov = torch.rand(t * b, device=device, generator=gen) < 0.2
        return d, randint(s, b, t, b), randint(s, t, b, b), ov

    def same(d, row, col, ov, k) -> None:
        got = outer(d.clone(), row, col, ov, k)
        want = bo.blocked_outer_reference(d.clone(), row, col, ov, k)
        if timer.cuda:
            torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(
                f"K2 and its plain version disagree at {bad} elements "
                f"(S, T, B = {tuple(d.shape[:3])}, k = {k})"
            )

    cases = []
    for s, t, b in OUTER_CASES:
        d, row, col, ov = tiles(s, t, b)
        for k in range(t):
            same(d, row, col, ov, k)
        cases.append({"S": s, "T": t, "B": b, "Np": t * b, "rounds": t})
    d, row, col, ov = tiles(1, t_main, b_main)
    ks = sorted({0, t_main // 2, t_main - 1})
    for k in ks:
        same(d, row, col, ov, k)
    k = t_main // 2
    x = d.clone()
    del d
    ms = timer.ms(lambda: outer(x, row, col, ov, k), reps=20)
    plain_ms = timer.ms(
        lambda: bo.blocked_outer_reference(x, row, col, ov, k), reps=2
    )
    drained = int(ov[k * b_main : (k + 1) * b_main].sum())
    np_ = t_main * b_main
    bound_ms, bound_by = outer_bound_ms(
        1, np_, b_main, drained, int32_ops_per_s(timer.cuda)
    )
    del x
    record = {
        "phase": "blocked_kernel_vs_plain",
        "rung": "blocked",
        "tile_cases": cases,
        "full_shape": {"S": 1, "T": t_main, "B": b_main, "Np": np_, "k": ks},
        "max_abs_err": 0,
    }
    timing = {
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "shape": {"S": 1, "Np": np_, "B": b_main, "T": t_main, "drained_lanes": drained},
    }
    return record, timing


def blocked_closure_vs_plain(device, pods: int, n_advertisers: int, timer) -> dict:
    """The whole closure of a `pods`-pod fabric through the blocked rung
    (threshold pinned to 0 for this phase only), once with K2 and once
    with its plain version: distances and bitmap bit for bit."""
    import torch

    from openr_tpu_torch.decision.csr import CsrTopology
    from openr_tpu_torch.decision.fleet import FleetViewCache
    from openr_tpu_torch.device.engine import DeviceResidencyEngine
    from openr_tpu_torch.ops import allsources as asrc
    from openr_tpu_torch.ops import blocked_outer as bo

    dbs, adv_ids = fabric_dbs(pods, n_advertisers)
    ls = link_state_of(dbs)
    csr = CsrTopology.from_link_state(ls)
    engine = DeviceResidencyEngine(device)
    engine.blocked.node_shard_threshold = 0
    dests = [ls.node_names[i] for i in adv_ids]

    def synced(fn):
        t0 = time.perf_counter()
        out = fn()
        if timer.cuda:
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    view, t_kernel = synced(
        lambda: FleetViewCache().view(ls, dests, csr=csr, engine=engine)
    )
    if not view.node_sharded:
        raise AssertionError("the pinned threshold did not engage the rung")
    out = asrc.build_out_ell(
        csr.edge_src, csr.edge_dst, csr.n_edges, csr.n_nodes, csr.out_slot
    )
    (drev, bitmap, _), t_plain = synced(
        lambda: engine.blocked.fleet_product(
            csr, adv_ids, out, outer=bo.blocked_outer_reference
        )
    )
    if not torch.equal(drev, view._dist_dev) or not torch.equal(
        bitmap, view._bitmap_dev
    ):
        raise AssertionError("closure with K2 differs from the plain closure")
    if tuple(drev.shape) != (csr.n_nodes, len(dests)) or not bool(
        (drev < (1 << 30)).all()
    ):
        raise AssertionError("the fabric's closure is not finite everywhere")
    return view.dest_names, view._dist_dev, view._bitmap_dev, {
        "phase": "blocked_closure_vs_plain",
        "rung": "blocked",
        "nodes": csr.n_nodes,
        "destinations": len(dests),
        "n_words": out.n_words,
        "node_sharded": view.node_sharded,
        "all_reachable": True,
        "k2_launches": engine.counters["device.engine.kernel_launches.blocked_outer"],
        "max_abs_err": 0,
        "closure_with_kernel_s": t_kernel,
        "closure_with_plain_s": t_plain,
    }


def ell_main_path(device, pods, n_advertisers, n_routers, n_checked, timer,
                  closure):
    """The fleet route build over the `pods`-pod fabric under the default
    policy: below the blocked threshold a fat-tree has no bands, so the
    view must take the ELL fallback (no K1, no K2 launch).  Its routes
    must equal the host Dijkstra's, and its distances and bitmap the
    blocked closure's product of the same fabric (`closure`: dest names,
    dist, bitmap from `blocked_closure_vs_plain`), bit for bit."""
    import torch

    from openr_tpu_torch.decision.fleet import FleetViewCache
    from openr_tpu_torch.ops import allsources as asrc
    from openr_tpu_torch.ops.sssp import INF32, u16_dist_to_i32

    inp = fleet_inputs(lambda: fabric_dbs(pods, n_advertisers), n_routers, device)
    ls, csr, solver = inp.ls, inp.csr, inp.solver
    # the last router is a spine: the most out-slots, every bitmap word
    inp.routers[-1] = inp.names[-1]
    if timer.cuda:
        torch.cuda.reset_peak_memory_stats()
    dbs_out, t_main, launches, main_counters, view = counted_route_build(
        solver, inp, timer
    )
    peak = torch.cuda.max_memory_allocated() if timer.cuda else None
    runner = view._runner
    if view.node_sharded or runner is None or runner.bg is not None:
        raise AssertionError("the fabric's view did not take the ELL path")
    attempts = runner.runs
    if (
        main_counters["device.engine.ell_sweeps"] < 1
        or main_counters["device.engine.kernel_launches"]
        or any(launches.values())
    ):
        raise AssertionError(
            f"ELL path: launches {launches}, engine {main_counters}"
        )
    t0 = time.perf_counter()
    checked = check_routes(
        inp, dbs_out, view, checked_routers(inp, n_routers, n_checked)
    )
    t_oracle = time.perf_counter() - t0
    dests, drev, bitmap = closure
    n = csr.n_nodes
    # the fabric's metrics put the ELL product in the uint16 mode; the
    # blocked closure is int32, so the product is widened to compare
    if view._dist_dev.dtype != torch.uint16:
        raise AssertionError(f"ELL product is {view._dist_dev.dtype}, not uint16")
    dist32 = u16_dist_to_i32(view._dist_dev)
    if dests != view.dest_names or not (
        same(dist32[:n], drev) and same(view._bitmap_dev, bitmap)
    ):
        raise AssertionError("ELL product differs from the blocked closure's")
    if bool((dist32[n:] != INF32).any()):
        raise AssertionError("a padding row of the ELL product is finite")
    del dist32

    dest = torch.as_tensor(
        [csr.node_id[d] for d in view.dest_names], dtype=torch.int32,
        device=view._dist_dev.device,
    )
    out = asrc.build_out_ell(
        csr.edge_src, csr.edge_dst, csr.n_edges, n, csr.out_slot
    )
    hint = runner.hint
    relax_ms = timer.ms(lambda: runner.run_once(dest, hint), reps=3)
    times = {
        "host_link_state_s": inp.t_ls,
        "host_csr_s": inp.t_csr,
        "main_path_first_run_s": t_main,
        "view_compute_ms": timer.ms(
            lambda: FleetViewCache().view(
                ls, view.dest_names, csr=csr, engine=solver.engine
            ),
            reps=1,
        ),
        "host_tables_ms": host_tables_ms(csr),
        "ell_relax_ms": relax_ms,
        "ell_sweep_ms": relax_ms / (max(hint, 2) + 1),
        # least time of one sweep: the [N_cap, P] product read once and
        # written once at the card's memory rate, at its relax's int32
        # width (the plain relax computes in int32 in either mode)
        "ell_sweep_bound_ms": (
            2 * view._dist_dev.numel() * 4 / HBM_BYTES_PER_S * 1e3
        ),
        "bitmap_ms": timer.ms(
            lambda: asrc.ecmp_bitmap_from_reverse_dist(
                view._dist_dev, out, csr.edge_metric, csr.edge_up,
                csr.node_overloaded, out.n_words,
            ),
            reps=1,
        ),
        "route_builds_ms": timer.ms(
            lambda: solver.fleet_route_dbs(inp.area, inp.ps, nodes=inp.routers),
            reps=1,
            warmup=0,
        ),
        "oracle_check_s": t_oracle,
    }
    record = {
        "phase": "ell_main_path",
        "rung": "ell",
        "node_sharded": view.node_sharded,
        "nodes": n,
        "node_capacity": csr.node_capacity,
        "directed_edges": csr.n_edges,
        "ell_buckets": [list(bk.nbr.shape) for bk in runner.ell.buckets],
        "advertisers": n_advertisers,
        "destinations": len(view.dest_names),
        "dist_shape": list(view._dist_dev.shape),
        "product_dtype": str(view._dist_dev.dtype),
        "product_bytes": view._dist_dev.numel() * view._dist_dev.element_size(),
        "n_words": int(view._bitmap_dev.shape[2]),
        "routers": n_routers,
        "checked_routers": checked,
        "equal_to_blocked_closure": True,
        "unicast_routes": sum(len(db.unicast_routes) for db in dbs_out.values()),
        "mpls_routes": sum(len(db.mpls_routes) for db in dbs_out.values()),
        "launches": launches,
        "engine_counters": main_counters,
        "ell_attempts": attempts,
        "sweep_hint": view.sweep_hint,
        "times": times,
    }
    if peak is not None:
        record["peak_device_bytes"] = peak
    return record


def blocked_main_path(device, pods, n_advertisers, n_routers, n_checked,
                      timer, outer_timing, threshold=None):
    """The fleet route build over the `pods`-pod fabric under the default
    policy (a rehearsal may pin `threshold`): it must take the blocked
    rung with one K2 launch per round, and its routes must equal the host
    Dijkstra's.  Returns (phase record, K2's kernels record)."""
    import torch

    from openr_tpu_torch.decision.fleet import FleetViewCache
    from openr_tpu_torch.ops import allsources as asrc
    from openr_tpu_torch.parallel.blocked import (
        blocked_diag,
        blocked_extract,
        blocked_panels,
    )

    inp = fleet_inputs(lambda: fabric_dbs(pods, n_advertisers), n_routers, device)
    ls, csr, solver = inp.ls, inp.csr, inp.solver
    # the last router is a spine: the most out-slots, every bitmap word
    inp.routers[-1] = inp.names[-1]
    blocked = solver.engine.blocked
    if threshold is not None:
        blocked.node_shard_threshold = threshold
    if timer.cuda:
        torch.cuda.reset_peak_memory_stats()
    dbs_out, t_main, launches, main_counters, view = counted_route_build(
        solver, inp, timer
    )
    peak = torch.cuda.max_memory_allocated() if timer.cuda else None
    n = csr.n_nodes
    b = blocked.tile_for(n)
    t = -(-n // b)
    np_ = t * b
    k2 = OUTER_KERNEL["name"]
    if not view.node_sharded:
        raise AssertionError("the blocked main path did not take the rung")
    if (
        launches[k2] != t
        or main_counters[f"device.engine.kernel_launches.{k2}"] != t
        or launches[KERNEL["name"]]
        or launches[KERNEL_U16["name"]]
    ):
        raise AssertionError(
            f"blocked main path: launches {launches}, engine "
            f"{main_counters}, expected {t} K2 launches per closure"
        )
    blocked_counters = blocked.get_counters()
    t0 = time.perf_counter()
    checked = check_routes(
        inp, dbs_out, view, checked_routers(inp, n_routers, n_checked)
    )
    t_oracle = time.perf_counter() - t0

    # phase times at this path's shapes, each after one warm-up
    def stage():
        return blocked.dense_dist0(
            n, np_, csr.edge_src, csr.edge_dst, csr.edge_metric,
            csr.edge_up, csr.n_edges,
        )

    staging_ms = timer.ms(stage, reps=1)
    d5 = stage().view(1, t, b, t, b)
    ov = torch.zeros(np_, dtype=torch.bool, device=d5.device)
    ov[:n] = torch.from_numpy(csr.node_overloaded[:n].astype(bool))
    k = t // 2
    closed = blocked_diag(d5, ov, k)
    dest = torch.as_tensor(
        [csr.node_id[d] for d in view.dest_names], dtype=torch.int64,
        device=d5.device,
    )
    out = asrc.build_out_ell(
        csr.edge_src, csr.edge_dst, csr.n_edges, n, csr.out_slot
    )
    round_ms = {
        "diag": timer.ms(lambda: blocked_diag(d5, ov, k), reps=20),
        "panels": timer.ms(lambda: blocked_panels(d5, closed, ov, k), reps=20),
        "outer_kernel": outer_timing["ms"],
    }
    times = {
        "host_link_state_s": inp.t_ls,
        "host_csr_s": inp.t_csr,
        "main_path_first_run_s": t_main,
        "dense_staging_ms": staging_ms,
        "round_ms": round_ms,
        "rounds": t,
        "rounds_x_round_ms": {key: v * t for key, v in round_ms.items()},
        "extract_ms": timer.ms(lambda: blocked_extract(d5, dest, n), reps=5),
        "bitmap_ms": timer.ms(
            lambda: asrc.ecmp_bitmap_from_reverse_dist(
                view._dist_dev, out, csr.edge_metric, csr.edge_up,
                csr.node_overloaded, out.n_words,
            ),
            reps=1,
        ),
    }
    del d5, closed
    times["view_compute_ms"] = timer.ms(
        lambda: FleetViewCache().view(
            ls, view.dest_names, csr=csr, engine=solver.engine
        ),
        reps=1,
        warmup=0,
    )
    times["route_builds_ms"] = timer.ms(
        lambda: solver.fleet_route_dbs(inp.area, inp.ps, nodes=inp.routers),
        reps=1,
        warmup=0,
    )
    times["oracle_check_s"] = t_oracle
    record = {
        "phase": "blocked_main_path",
        "rung": "blocked",
        "node_sharded": view.node_sharded,
        "nodes": n,
        "directed_edges": csr.n_edges,
        "tile": b,
        "padded_nodes": np_,
        "advertisers": n_advertisers,
        "destinations": len(view.dest_names),
        "n_words": int(view._bitmap_dev.shape[2]),
        "routers": n_routers,
        "checked_routers": checked,
        "unicast_routes": sum(len(db.unicast_routes) for db in dbs_out.values()),
        "mpls_routes": sum(len(db.mpls_routes) for db in dbs_out.values()),
        "launches": launches,
        "engine_counters": main_counters,
        "blocked_counters": blocked_counters,
        "times": times,
    }
    if peak is not None:
        record["peak_device_bytes"] = peak
    kernel_record = {
        **OUTER_KERNEL,
        "launches": launches[k2],
        "parity": True,
        "max_abs_err": 0,
        "ms": outer_timing["ms"],
        "plain_ms": outer_timing["plain_ms"],
        "bound_ms": outer_timing["bound_ms"],
        "bound_by": outer_timing["bound_by"],
        "library_ms": None,
        "library_note": NO_LIBRARY + " (a min-plus product)",
        "shape": outer_timing["shape"],
    }
    return record, kernel_record


# -- masked batches: KSP2, what-if, TI-LFA -------------------------------------


def masked_sweep_bytes(runner, s: int) -> int:
    """Bytes one masked relax sweep of `runner` must move at S rows: the
    distances read once and written once ([N*, S] int32 each), the row
    exclusions of every relaxing slot read once ([slots, S] bool), and
    each slot's neighbour id and weight (int32 each)."""
    st = runner.call_arrays()
    if runner.bg is not None:
        n = runner.bg.n_nodes
        slots = n * (int(st.resid_nbr.shape[1]) + len(runner.bg.offsets))
    else:
        n = int(st.node_overloaded.shape[0])
        slots = sum(int(bk.nbr.numel()) for bk in st.ell.buckets)
    return 2 * n * s * 4 + slots * s + slots * 8


def masked_sweep_record(runner, sources, mask, timer, want_dag=False) -> dict:
    """One masked fixed-sweep run of `runner` at its learned hint_masked,
    timed (median of 3 runs, each between CUDA events), per sweep
    against the byte bound.  `mask` is [S, E_cap] numpy bool."""
    import torch

    st = runner.call_arrays()
    device = st.edge_up.device
    src = torch.as_tensor(np.asarray(sources, dtype=np.int32), device=device)
    mask_t = torch.as_tensor(mask, device=device)
    hint = runner.hint_masked
    sweeps = (hint if runner.bg is not None else max(hint, 2)) + 1
    small = runner.small_dist
    run_ms = timer.median_ms(
        lambda: runner.run_once(
            src, hint, extra_edge_mask=mask_t, want_dag=want_dag, small=small
        ),
        reps=3,
    )
    bound = masked_sweep_bytes(runner, len(src)) / HBM_BYTES_PER_S * 1e3
    return {
        "path": "banded" if runner.bg is not None else "ell",
        "chord_mode": runner.chord_mode,
        "rows": len(src),
        "hint_masked": hint,
        "sweeps_per_run": sweeps,
        "uint16": small,
        "run_ms": run_ms,
        "per_sweep_ms": run_ms / sweeps,
        "per_sweep_bound_ms": bound,
        "bound_by": "bytes",
    }


class OracleGraph(NamedTuple):
    """The scipy oracle's directed edges: endpoints, metric, and the
    mirror's id of each edge (what a metric plane and dropped edge ids
    index)."""

    src: np.ndarray
    dst: np.ndarray
    metric: np.ndarray
    eid: np.ndarray
    n: int


def oracle_graph(ls, csr) -> OracleGraph:
    """The scipy oracle's graph, read from the host oracle's LinkState:
    both directions of every up link, each with the metric it
    originates, and no drained node.  Each edge is matched to the id the
    card mirror gives it through the mirror's host link table (links
    compare by their (node, iface) pairs), so a TE plane and dropped edge
    ids index it; the mirror's endpoint, metric and up arrays, which the
    card's refresh writes, are not read."""
    names = ls.node_names
    if names != csr.node_names:
        raise AssertionError("the oracle and the mirror name other nodes")
    if any(ls.is_node_overloaded(v) for v in names):
        raise AssertionError("the scipy oracle takes no drained node")
    node_id = {v: i for i, v in enumerate(names)}
    eid_of = {lp: e for e, lp in enumerate(csr.edge_links) if lp is not None}
    rows = [
        (node_id[frm], node_id[link.other_node_name(frm)],
         link.metric_from_node(frm), eid_of[(link, frm)])
        for link in ls.all_links
        if link.is_up()
        for frm in (link.n1, link.n2)
    ]
    a = np.asarray(rows, dtype=np.int64).reshape(-1, 4)
    return OracleGraph(a[:, 0], a[:, 1], a[:, 2], a[:, 3], len(names))


def scipy_dist(g: OracleGraph, src: int, metric=None, drop=(), drop_pairs=()) -> np.ndarray:
    """The host oracle at scale: scipy's Dijkstra from `src` over
    `g`'s edges, with the metrics `metric[eid]` of a plane when given,
    less the edge ids `drop` and every edge between a node-id pair of
    `drop_pairs`; INF32 where unreachable.  Parallel edges keep their
    least metric."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    from openr_tpu_torch.ops.sssp import INF32

    w = g.metric if metric is None else np.asarray(metric, dtype=np.int64)[g.eid]
    pair = np.minimum(g.src, g.dst) * g.n + np.maximum(g.src, g.dst)
    cut = [min(a, b) * g.n + max(a, b) for a, b in drop_pairs]
    keep = ~np.isin(g.eid, np.asarray(drop, dtype=np.int64)) & ~np.isin(pair, cut)
    key, w = (g.src * g.n + g.dst)[keep], w[keep]
    order = np.lexsort((w, key))
    first = np.r_[True, key[order][1:] != key[order][:-1]]
    key, w = key[order][first], w[order][first]
    mat = csr_matrix((w.astype(np.float64), (key // g.n, key % g.n)), shape=(g.n, g.n))
    d = dijkstra(mat, indices=src)
    return np.where(np.isinf(d), INF32, d).astype(np.int64)


def protection_queries(decision, csr, oracle_ls, router: str, timer) -> dict:
    """Decision's operator queries on the card Decision's mirror: TI-LFA
    of `router` (every up adjacency failed in turn, one masked batch with
    the SP-DAG on the forward runner) and an SRLG what-if of three
    scenarios, then `ti_lfa_backups(runner=)` called directly as the
    reference's bench does.  Two TI-LFA adjacencies are held against the
    host Dijkstra with the link ignored (`LinkState.run_spf`: counts and
    every listed backup first-hop set), every scenario and two rows of
    the direct call against scipy's Dijkstra over the oracle's graph
    (oracle_graph, returned with the record)."""
    import torch

    from openr_tpu_torch.ops import protection as prot

    ls = oracle_ls
    t0 = time.perf_counter()
    report = decision.get_ti_lfa()
    ti_lfa_s = time.perf_counter() - t0
    runner = csr._runner
    adjs = report["adjacencies"]
    t0 = time.perf_counter()
    base = ls.get_spf_result(router)
    for adj in adjs[:2]:
        link = next(
            l for l in ls.links_from_node(router)
            if l.other_node_name(router) == adj["neighbor"]
        )
        res = ls.run_spf(router, links_to_ignore={link})
        kept = sum(1 for v in base if v != router and v in res)
        lost = sum(1 for v in base if v not in res)
        if (adj["protected_destinations"], adj["unprotected_count"]) != (kept, lost):
            raise AssertionError(f"TI-LFA {adj['neighbor']}: counts differ from the oracle's")
        for v, hops in adj["backup_first_hops"].items():
            if sorted(res[v].next_hops) != hops:
                raise AssertionError(f"TI-LFA {adj['neighbor']} -> {v}: backups differ")
    ti_oracle_s = time.perf_counter() - t0
    ti_record = {
        "router": router,
        "adjacencies": len(adjs),
        "masked_rows": len(adjs) + 1,
        "protected": [a["protected_destinations"] for a in adjs],
        "unprotected": [a["unprotected_count"] for a in adjs],
        "checked_adjacencies": [a["neighbor"] for a in adjs[:2]],
        "query_s": ti_lfa_s,
        "oracle_s": ti_oracle_s,
        "runner_masked_runs": runner.masked_runs,
        "hint_masked": runner.hint_masked,
    }

    # what-if: one link of the router, two, and a group of four far links
    nbrs = [a["neighbor"] for a in adjs]
    rng = np.random.default_rng(3)
    far = [csr.edge_links[int(e)][0] for e in rng.choice(csr.n_edges, 4, replace=False)]
    scenarios = [
        [(router, nbrs[0])],
        [(router, nbrs[0]), (router, nbrs[1])],
        [(link.n1, link.n2) for link in far],
    ]
    t0 = time.perf_counter()
    rows = decision.what_if(scenarios)
    what_if_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    src = csr.node_id[router]
    graph = oracle_graph(ls, csr)
    node_id = {v: i for i, v in enumerate(ls.node_names)}
    d0 = scipy_dist(graph, src)
    from openr_tpu_torch.ops.sssp import INF32

    for f, scen in enumerate(scenarios):
        d1 = scipy_dist(graph, src, drop_pairs=[(node_id[a], node_id[b]) for a, b in scen])
        lost = int(((d0 < INF32) & (d1 >= INF32)).sum())
        degraded = int(((d0 < INF32) & (d1 < INF32) & (d1 > d0)).sum())
        if (rows[f]["newly_unreachable_pairs"], rows[f]["degraded_pairs"]) != (lost, degraded):
            raise AssertionError(f"what-if scenario {f}: {rows[f]} against ({lost}, {degraded})")
    what_if_record = {
        "scenarios": [len(s) for s in scenarios],
        "newly_unreachable": [r["newly_unreachable_pairs"] for r in rows],
        "degraded": [r["degraded_pairs"] for r in rows],
        "query_s": what_if_s,
        "oracle_s": time.perf_counter() - t0,
    }

    # ti_lfa_backups(runner=) directly (bench.py bench_tilfa)
    e = csr.n_edges
    out_edges = np.flatnonzero(
        (csr.edge_src[:e] == src) & csr.edge_up[:e]
    ).astype(np.int32)
    rev = np.full(csr.edge_capacity, -1, dtype=np.int32)
    rev[:e] = prot.build_reverse_edge_ids(csr.edge_src[:e], csr.edge_dst[:e])
    args = (
        np.int32(src), out_edges, csr.edge_src, csr.edge_dst, csr.edge_metric,
        csr.edge_up, csr.node_overloaded, rev,
    )
    runs0 = runner.masked_runs
    t0 = time.perf_counter()
    dist, dag = prot.ti_lfa_backups(*args, max_degree=len(out_edges), runner=runner)
    call_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for d in range(2):
        e_failed = int(out_edges[d])
        want = scipy_dist(graph, src, drop=[e_failed, int(rev[e_failed])])
        if not np.array_equal(np.minimum(dist[d, : csr.n_nodes], INF32), want):
            raise AssertionError(f"ti_lfa_backups row {d} differs from scipy")
    survives = prot.build_edge_failure_masks(out_edges, rev, csr.edge_capacity)
    direct = {
        "rows": len(out_edges),
        "call_s": call_s,
        "runs": runner.masked_runs - runs0,
        "oracle_s": time.perf_counter() - t0,
        "dag_edges": int(dag.sum()),
        **masked_sweep_record(
            runner, np.full(len(out_edges), src), survives, timer, want_dag=True
        ),
    }
    if timer.cuda:
        torch.cuda.synchronize()
    return (
        {"ti_lfa": ti_record, "what_if": what_if_record, "ti_lfa_backups": direct},
        graph,
    )


def ksp_dual_metric_wan100k(csr, engine, graph, timer, n_dests: int = 8) -> dict:
    """BASELINE config #3: fused dual-metric KSP2 (ops.ksp) on wan100k's
    forward runner, set up as the reference's bench
    (bench_ksp_dual_metric_wan100k): a TE plane of integers 1..100 from
    np.random.default_rng(17), 8 destinations from the same generator,
    both planes in one call per question.  k1 equals scipy's Dijkstra
    over the oracle's `graph` (oracle_graph), every traced path sums to
    k1, and k2 equals scipy's Dijkstra with the traced links (both
    directions) removed, on 4 destinations per plane.  The timed calls
    repeat the checked question without adaptation; each must converge
    and answer as the checked call did."""
    import torch

    from openr_tpu_torch.ops import protection as prot
    from openr_tpu_torch.ops.ksp import FusedKsp2Runner

    if timer.cuda:
        torch.cuda.reset_peak_memory_stats()
    runner = csr.runner(engine)
    e = csr.n_edges
    rng = np.random.default_rng(17)
    te = csr.edge_metric.copy()
    te[:e] = rng.integers(1, 101, size=e).astype(np.int32)
    dests = rng.choice(np.arange(1, csr.n_nodes), size=n_dests, replace=False).astype(np.int32)
    rev = prot.build_reverse_edge_ids(csr.edge_src[:e], csr.edge_dst[:e])
    planes = [csr.edge_metric.copy(), te]
    runs0, masked0, sweeps0 = runner.runs, runner.masked_runs, runner.sweeps
    t0 = time.perf_counter()
    fk = FusedKsp2Runner(runner, csr.edge_dst, e, csr.n_nodes, rev, planes)
    res = fk.run(0, dests)
    warm_s = time.perf_counter() - t0
    warm_runs = runner.runs - runs0
    warm_masked = runner.masked_runs - masked0
    timed = []
    call_ms = timer.median_ms(lambda: timed.append(fk.run(0, dests, adaptive=False)), reps=3)
    for out in timed:
        for p, (r, want) in enumerate(zip(out, res)):
            if not (bool(r.ok_base) and bool(r.ok_masked) and bool(r.trace_ok)):
                raise AssertionError(f"plane {p}: a timed fused call did not converge")
            if not all(torch.equal(getattr(r, k), getattr(want, k)) for k in ("k1", "k2", "excl")):
                raise AssertionError(f"plane {p}: a timed fused call answered otherwise")
    t0 = time.perf_counter()
    checked = []
    for p, metric in enumerate(planes):
        r = res[p]
        k1, k2, excl = (t.cpu().numpy() for t in (r.k1, r.k2, r.excl))
        # plane 0's oracle metrics are the LinkState's own
        oracle_plane = None if p == 0 else metric
        cd = scipy_dist(graph, 0, metric=oracle_plane)
        if not np.array_equal(k1, cd[dests]):
            raise AssertionError(f"plane {p}: k1 differs from scipy")
        for i in range(n_dests):
            ee = excl[i][excl[i] < e]
            if int(metric[ee].sum()) != int(k1[i]):
                raise AssertionError(f"plane {p} dest {i}: trace is not a shortest path")
        for i in range(0, n_dests, 2):
            ee = excl[i][excl[i] < e]
            rv = rev[ee]
            cd2 = scipy_dist(graph, 0, metric=oracle_plane, drop=np.concatenate([ee, rv[rv >= 0]]))
            if int(k2[i]) != int(cd2[dests[i]]):
                raise AssertionError(f"plane {p} dest {i}: k2 differs from scipy")
        checked.append({"k1": k1.tolist(), "k2": k2.tolist()})
    oracle_s = time.perf_counter() - t0
    mask = fk._host_masks(res, n_dests)[1]
    record = {
        "phase": "ksp_dual_metric_wan100k",
        "nodes": csr.n_nodes,
        "edges": e,
        "destinations": dests.tolist(),
        "planes": checked,
        "max_hops": fk.learned_max_hops,
        "hint": runner.hint,
        "warmup_s": warm_s,
        "warmup_runs": warm_runs,
        "warmup_masked_runs": warm_masked,
        "fused_call_ms": call_ms,
        "oracle_s": oracle_s,
        "masked_sweep": masked_sweep_record(
            runner, np.zeros(n_dests, np.int32), mask, timer
        ),
    }
    if timer.cuda:
        record["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    return record


def srlg_whatif_grid1024(device, timer, n_variants: int = 10_000, n_checked: int = 64) -> dict:
    """BASELINE config #4: `n_variants` single-link failure scenarios x 1
    source on `grid_topology(32)` in one `runner.forward(...,
    want_dag=False)` call on the mirror's forward runner; the variants
    drawn as the reference's bench (bench_srlg_whatif: rng 42, each
    failed edge's reverse failed with it).  `n_checked` sampled rows are
    held against the host Dijkstra with the link ignored, and
    `srlg_reachability_loss` over them against the same oracle."""
    import torch

    from openr_tpu_torch.decision.csr import CsrTopology
    from openr_tpu_torch.device.engine import DeviceResidencyEngine
    from openr_tpu_torch.ops import protection as prot
    from openr_tpu_torch.ops.sssp import INF32
    from openr_tpu_torch.utils import topo

    if timer.cuda:
        torch.cuda.reset_peak_memory_stats()
    ls = link_state_of(topo.grid_topology(32))
    csr = CsrTopology.from_link_state(ls)
    engine = DeviceResidencyEngine(device)
    runner = csr.runner(engine)
    e = csr.n_edges
    rng = np.random.default_rng(42)
    rev = prot.build_reverse_edge_ids(csr.edge_src[:e], csr.edge_dst[:e])
    fail = rng.integers(0, e, size=n_variants)
    mask = np.ones((n_variants, csr.edge_capacity), dtype=bool)
    rows = np.arange(n_variants)
    mask[rows, fail] = False
    valid = rev[fail] >= 0
    mask[rows[valid], rev[fail][valid]] = False
    sources = np.zeros(n_variants, dtype=np.int32)
    t0 = time.perf_counter()
    dist, _ = runner.forward(sources, extra_edge_mask=mask, want_dag=False)
    forward_s = time.perf_counter() - t0
    runs, sweeps = runner.masked_runs, runner.sweeps
    baseline, _ = runner.forward(sources[:1], want_dag=False)
    t0 = time.perf_counter()
    src = csr.node_names[0]
    base = ls.get_spf_result(src)
    sample = np.sort(np.random.default_rng(5).choice(n_variants, n_checked, replace=False))
    want_lost = want_degraded = 0
    for i in sample:
        link = csr.edge_links[int(fail[i])][0]
        res = ls.run_spf(src, links_to_ignore={link})
        want = np.array(
            [res[v].metric if v in res else INF32 for v in csr.node_names], dtype=np.int64
        )
        if not np.array_equal(np.minimum(dist[i, : csr.n_nodes], INF32), want):
            raise AssertionError(f"what-if variant {i} differs from the host Dijkstra")
        want_lost += sum(1 for v in base if v not in res)
        want_degraded += sum(1 for v in base if v in res and res[v].metric > base[v].metric)
    lost, degraded = prot.srlg_reachability_loss(
        baseline[:, : csr.n_nodes], dist[sample][:, None, : csr.n_nodes]
    )
    if (int(lost.sum()), int(degraded.sum())) != (want_lost, want_degraded):
        raise AssertionError("srlg_reachability_loss differs from the oracle")
    oracle_s = time.perf_counter() - t0
    record = {
        "phase": "srlg_whatif_grid1024",
        "nodes": csr.n_nodes,
        "edges": e,
        "variants": n_variants,
        "checked_rows": n_checked,
        "forward_s": forward_s,
        "masked_runs": runs,
        "sweeps": sweeps,
        "newly_unreachable_sampled": int(lost.sum()),
        "degraded_sampled": int(degraded.sum()),
        "oracle_s": oracle_s,
        "masked_sweep": masked_sweep_record(runner, sources, mask, timer),
    }
    if timer.cuda:
        record["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    return record


def decision_pair(router: str, device):
    """A card Decision (the fleet views' delta rung on, as the reference
    daemon builds it) and a host-Dijkstra Decision (the oracle), each
    wired to its own Fib and MockFibAgent, running."""
    from openr_tpu_torch.decision.decision import Decision
    from openr_tpu_torch.decision.spf_solver import HostSpfBackend
    from openr_tpu_torch.fib import Fib, MockFibAgent
    from openr_tpu_torch.runtime.queue import ReplicateQueue

    sides = {}
    for side, kwargs in (
        ("card", {"device": device, "fleet_delta": True}),
        ("oracle", {"spf_backend": HostSpfBackend(), "device": device}),
    ):
        kvq, routeq, fibq = ReplicateQueue(), ReplicateQueue(), ReplicateQueue()
        decision = Decision(router, kvq.get_reader(), None, routeq, **kwargs)
        agent = MockFibAgent()
        fib = Fib(router, routeq.get_reader(), agent, fib_updates_queue=fibq)
        sides[side] = dict(
            kvq=kvq, routeq=routeq, fibq=fibq, programmed=fibq.get_reader(),
            decision=decision, agent=agent, fib=fib,
        )
        fib.run()
        decision.run()
    return sides


def close_pair(sides) -> None:
    for s in sides.values():
        for q in ("kvq", "routeq", "fibq"):
            s[q].close()
        s["decision"].stop()
        s["fib"].stop()


def push_pair(sides, what: str, pub) -> dict:
    """`pub` into the card's Decision, then, once its agent programmed
    it, into the oracle's; both agents' tables must be equal and neither
    Decision may count a rebuild failure.  Returns the wall times."""
    wall = {}
    for side, s in sides.items():
        t0 = time.perf_counter()
        s["kvq"].push(pub)
        s["programmed"].get(timeout=600)
        wall[side] = time.perf_counter() - t0
    if agent_tables(sides["card"]["agent"]) != agent_tables(sides["oracle"]["agent"]):
        raise AssertionError(f"{what}: the card's agent tables differ from the oracle's")
    for side, s in sides.items():
        if s["decision"].get_counters()["decision.route_rebuild_failures"]:
            raise AssertionError(f"{what}: {side} counted a rebuild failure")
    return wall


def ksp2_decision_fabric96(device, pods, timer) -> dict:
    """KSP2, BGP and UCMP routes through Decision → Fib on BASELINE config
    #2's 10 080-node fat-tree (the reference's bench_ksp2_fattree10k
    shape), the own router the first rack switch: one Publication with
    every adjacency database, 8 KSP2_ED_ECMP SR_MPLS prefixes (their
    advertisers carry node labels), 8 BGP prefixes with metric vectors
    (two advertisers each: six with a strict winner, one decided by a
    tie-breaker for the first advertiser, so the second joins as
    TIE_LOOSER, one for the second, a TIE_WINNER), and 4 prefixes of
    each UCMP algorithm; then one of the router's uplinks has its metric
    raised and another goes down.  After each step both agents' tables
    are equal, no rebuild failed, and the card ran the build's k = 2 runs
    as ONE masked batch (`device.engine.masked_batches`)."""
    import dataclasses

    import torch

    from openr_tpu_torch.serializer import dumps
    from openr_tpu_torch.types import (
        MetricEntity,
        MetricVector,
        PrefixDatabase,
        PrefixEntry,
        PrefixForwardingAlgorithm,
        PrefixForwardingType,
        PrefixType,
        Publication,
        Value,
        adj_key,
        prefix_key,
    )
    from openr_tpu_torch.utils import topo

    if timer.cuda:
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    dbs = topo.fat_tree_topology(pods, **FABRIC)
    by_name = {db.this_node_name: db for db in dbs}
    racks = sorted(n for n in by_name if n.startswith("rsw-"))
    own = racks[0]
    rng = np.random.default_rng(11)
    far = [r for r in racks if not r.startswith(own.rsplit("-", 1)[0] + "-")]
    picks = [far[i] for i in rng.choice(len(far), 40, replace=False)]
    for k, adj in enumerate(by_name[own].adjacencies):
        adj.weight = k + 1  # SP_UCMP_ADJ_WEIGHT_PROPAGATION reads these
    ksp2_nodes = picks[:8]
    for i, name in enumerate(ksp2_nodes):
        by_name[name].node_label = 50_000 + i

    def mv(pref, tie_break=0):
        metrics = [MetricEntity(type=0, priority=9000, metric=[pref])]
        if tie_break:
            metrics.append(
                MetricEntity(type=6, priority=3000, metric=[tie_break],
                             is_best_path_tie_breaker=True)
            )
        return MetricVector(version=1, metrics=metrics)

    entries = []  # (node, PrefixEntry)
    for i, node in enumerate(ksp2_nodes):
        entries.append((node, PrefixEntry(
            prefix=f"fc00:a:{i:x}::/64",
            forwarding_type=PrefixForwardingType.SR_MPLS,
            forwarding_algorithm=PrefixForwardingAlgorithm.KSP2_ED_ECMP,
        )))
    bgp_pairs = [sorted(picks[8 + 2 * i : 10 + 2 * i]) for i in range(8)]
    for i, (a, b) in enumerate(bgp_pairs):
        prefix = f"fc00:b:{i:x}::/64"
        if i < 6:
            va, vb = mv(100 + i), mv(200 + i)
        elif i == 6:
            va, vb = mv(150, 9), mv(150, 3)  # b: TIE_LOOSER
        else:
            va, vb = mv(150, 3), mv(150, 9)  # b: TIE_WINNER
        for node, v in ((a, va), (b, vb)):
            entries.append((node, PrefixEntry(prefix=prefix, type=PrefixType.BGP, mv=v)))
    ucmp = picks[24:40]
    for i in range(4):
        for j, node in enumerate(ucmp[2 * i : 2 * i + 2]):
            entries.append((node, PrefixEntry(
                prefix=f"fc00:c:{i:x}::/64",
                forwarding_algorithm=PrefixForwardingAlgorithm.SP_UCMP_PREFIX_WEIGHT_PROPAGATION,
                weight=100 * (j + 1),
            )))
        entries.append((ucmp[8 + i], PrefixEntry(
            prefix=f"fc00:d:{i:x}::/64",
            forwarding_algorithm=PrefixForwardingAlgorithm.SP_UCMP_ADJ_WEIGHT_PROPAGATION,
        )))
    key_vals = {
        adj_key(db.this_node_name): Value(1, db.this_node_name, dumps(db)) for db in dbs
    }
    for node, entry in entries:
        key_vals[prefix_key(node, entry.prefix, "0")] = Value(
            1, node, dumps(PrefixDatabase(node, [entry]))
        )
    t_build = time.perf_counter() - t_phase
    sides = decision_pair(own, device)
    card = sides["card"]["decision"]
    engine = card.spf_solver.engine
    own_db = by_name[own]
    steps = {}
    try:
        for step, pub in (
            ("cold", Publication(key_vals=key_vals, area="0")),
            ("metric_raised", None),
            ("link_down", None),
        ):
            if step == "metric_raised":
                own_db = dataclasses.replace(
                    own_db,
                    adjacencies=[
                        dataclasses.replace(own_db.adjacencies[0], metric=7),
                        *own_db.adjacencies[1:],
                    ],
                )
                pub = Publication(key_vals={adj_key(own): Value(2, own, dumps(own_db))}, area="0")
            elif step == "link_down":
                own_db = dataclasses.replace(own_db, adjacencies=own_db.adjacencies[:1] + own_db.adjacencies[2:])
                pub = Publication(key_vals={adj_key(own): Value(3, own, dumps(own_db))}, area="0")
            c0 = engine.get_counters()
            wall = push_pair(sides, step, pub)
            c1 = engine.get_counters()
            delta = {
                k.removeprefix("device.engine."): c1[k] - c0[k]
                for k in ("device.engine.masked_batches", "device.engine.masked_rows",
                          "device.engine.masked_runs", "device.engine.queries")
            }
            if delta["masked_batches"] != 1:
                raise AssertionError(f"{step}: {delta['masked_batches']} masked batches, not 1")
            csr = card.run_in_event_base_thread(
                lambda: card.spf_solver.spf.csr_mirror(card.area_link_states["0"])
            ).result()
            routes = agent_tables(sides["card"]["agent"])[0]
            steps[step] = {
                "wall_s": wall,
                "engine_delta": delta,
                "runner_runs": csr._runner.runs,
                "runner_masked_runs": csr._runner.masked_runs,
                "hint_masked": csr._runner.hint_masked,
                "runner_path": "banded" if csr._runner.bg is not None else "ell",
                "unicast_routes": len(routes),
                "ksp2_next_hops": sum(
                    len(routes[e.prefix].next_hops)
                    for _, e in entries[:8] if e.prefix in routes
                ),
                "weighted_next_hops": sum(
                    1 for r in routes.values() for nh in r.next_hops if nh.weight
                ),
            }
        sweep = masked_sweep_record(
            csr._runner,
            np.full(8, csr.node_id[own], np.int32),
            np.ones((8, csr.edge_capacity), dtype=bool),
            timer,
            want_dag=True,
        )
    finally:
        close_pair(sides)
    bgp = [p for p in agent_tables(sides["card"]["agent"])[0] if p.startswith("fc00:b:")]
    if len(bgp) != 8 or any(s["ksp2_next_hops"] < 8 for s in steps.values()):
        raise AssertionError("fabric96: BGP or KSP2 routes missing")
    record = {
        "phase": "ksp2_decision_fabric96",
        "nodes": len(dbs),
        "own_router": own,
        "prefixes": {"ksp2": 8, "bgp": 8, "ucmp_prefix": 4, "ucmp_adj": 4},
        "publication_keys": len(key_vals),
        "build_s": t_build,
        "steps": steps,
        "masked_sweep": sweep,
        "phase_s": time.perf_counter() - t_phase,
    }
    if timer.cuda:
        record["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    return record


# TE and serving on the card: traffic engineering's descent and exact
# gate (te_wan100k) and the query-serving layer (serving_wan100k)

# tolerance of a descent step on the card against the port's CPU run:
# tests/test_torch_te.py's, the reference against the port
TE_RTOL = TE_ATOL = 1e-4


def te_demand(n_nodes: int, node_capacity: int, n_sources: int = 512,
              n_dests: int = 4):
    """The reference's TE bench demand (bench.py bench_te_wan100k):
    RandomState(0), `n_sources` sources with volumes U(0.5, 2.0) toward
    `n_dests` destinations at linspace(0, n - 1), none on their own
    rows.  Returns (dest ids, demand [node_capacity, n_dests])."""
    rng = np.random.RandomState(0)
    dests = np.linspace(0, n_nodes - 1, n_dests).astype(np.int32)
    sources = rng.choice(n_nodes, size=n_sources, replace=False)
    demand = np.zeros((node_capacity, n_dests), dtype=np.float32)
    demand[sources] = rng.uniform(0.5, 2.0, size=(n_sources, n_dests)).astype(np.float32)
    demand[dests, np.arange(n_dests)] = 0.0
    return dests, demand


def reverse_dijkstra(problem, metric, dest: int) -> np.ndarray:
    """The exact distances v -> `dest` for integer `metric`: scipy's
    Dijkstra from `dest` on the reversed up edges (parallel edges keep
    their least metric), less every edge into a drained node other than
    `dest` (the drain rule); INF32 where unreachable, [node_capacity]."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    from openr_tpu_torch.ops.sssp import INF32

    e = problem.n_edges
    src = problem.edge_src[:e].astype(np.int64)
    dst = problem.edge_dst[:e].astype(np.int64)
    w = np.asarray(metric[:e], dtype=np.int64)
    over = problem.node_overloaded
    keep = problem.edge_up[:e] & ~(over[dst] & (dst != dest))
    n = len(over)
    key, w = (dst * n + src)[keep], w[keep]
    order = np.lexsort((w, key))
    first = np.r_[True, key[order][1:] != key[order][:-1]]
    key, w = key[order][first], w[order][first]
    mat = csr_matrix((w.astype(np.float64), (key // n, key % n)), shape=(n, n))
    d = dijkstra(mat, indices=dest)
    return np.where(np.isinf(d), INF32, d).astype(np.int64)


class ExactLog:
    """Records every ExactEvaluator evaluation until `close()`: the
    candidate metrics, the distances it computed and its ms split into
    host tables, product and load push."""

    def __init__(self) -> None:
        from openr_tpu_torch.te.exact import ExactEvaluator

        self.cls = ExactEvaluator
        self.evals: list[dict] = []
        self.real = real, real_dist = ExactEvaluator.evaluate, ExactEvaluator.distances
        evals = self.evals

        def distances(ev, metric):
            d = real_dist(ev, metric)
            evals.append({"metric": np.asarray(metric).copy(), "dist": d})
            return d

        def evaluate(ev, metric):
            obj = real(ev, metric)
            evals[-1]["ms"] = dict(ev.last_ms)
            evals[-1]["objective"] = obj
            return obj

        ExactEvaluator.distances = distances
        ExactEvaluator.evaluate = evaluate

    def take(self) -> list[dict]:
        out = list(self.evals)
        self.evals.clear()
        return out

    def close(self) -> None:
        self.cls.evaluate, self.cls.distances = self.real


class ExactK1Capture:
    """Keeps K1's inputs of the first exact evaluation on `engine` until
    `close()`: the product and group tables its counting epilogue took,
    with the evaluation's reversed runner and out-edge table, for
    `slab_pair_records` after the counted run."""

    def __init__(self, engine) -> None:
        from openr_tpu_torch.te.exact import ExactEvaluator

        self.cls, self.engine = ExactEvaluator, engine
        self.real_runner = real_runner = ExactEvaluator._runner
        self.slab = None
        staged = []

        def runner(ev, metric):
            r = real_runner(ev, metric)
            staged[:] = [r, ev._out]
            return r

        self.epilogue = epilogue = engine.epilogue

        def capturing(d, *rest):
            out = epilogue(d, *rest)
            if self.slab is None:
                self.slab = (d, rest[:4], rest[4], *staged)
            return out

        ExactEvaluator._runner = runner
        engine.epilogue = capturing

    def close(self) -> None:
        self.cls._runner = self.real_runner
        self.engine.epilogue = self.epilogue


def check_exact_evals(problem, evals, what: str) -> float:
    """Each evaluation's distances against reverse_dijkstra, bit for bit;
    returns the oracle's seconds."""
    t0 = time.perf_counter()
    for i, ev in enumerate(evals):
        for p, dest in enumerate(problem.dest_ids):
            want = reverse_dijkstra(problem, ev["metric"], int(dest))
            if not np.array_equal(ev["dist"][:, p], want):
                raise AssertionError(f"{what}: evaluation {i} column {p} differs from Dijkstra")
    return time.perf_counter() - t0


def descent_step_record(problem, device, timer) -> dict:
    """The first descent step of the optimizer's anneal (tau 1.0, the
    initial metrics, zero moments) on the card and on the CPU at full
    width: objective and gradient held at TE_RTOL / TE_ATOL, and one
    card step profiled for its kernel launches and device time."""
    import torch

    from openr_tpu_torch.te import soft

    def tensors(dev):
        def put(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)

        metric = put(problem.edge_metric, torch.float32)
        return (
            metric, torch.zeros_like(metric), torch.zeros_like(metric), np.float32(1),
            put(problem.edge_src, torch.int64), put(problem.edge_dst, torch.int64),
            put(problem.edge_up, torch.bool), put(problem.node_overloaded, torch.bool),
            put(problem.dest_ids, torch.int64), put(problem.demand, torch.float32),
            put(problem.capacity, torch.float32),
            *(np.float32(x) for x in (1.0, 0.1, 0.75, problem.metric_lo, problem.metric_hi)),
        )

    kw = dict(n_sweeps=64, flow_sweeps=48, return_grad=True)
    out = {}
    t0 = time.perf_counter()
    card = soft.te_descent_step(*tensors(device), **kw)
    out["card"] = [t.cpu().numpy() for t in card]
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["cpu"] = [t.numpy() for t in soft.te_descent_step(*tensors("cpu"), **kw)]
    cpu_s = time.perf_counter() - t0
    names = ("objective", "metric", "m", "v", "grad")
    err = {}
    for name, g, w in zip(names, out["card"], out["cpu"]):
        err[name] = float(np.max(np.abs(g.astype(np.float64) - w)))
        # metric' is not held: Adam's first step moves each metric by
        # about lr * sign(grad), so a gradient within float noise of 0
        # may step either way
        if name != "metric" and not np.allclose(g, w, rtol=TE_RTOL, atol=TE_ATOL):
            raise AssertionError(f"te descent step: {name} on the card differs from the CPU")
    grad, grad_cpu = out["card"][4], out["cpu"][4]
    if not np.isfinite(grad).all() or (grad[~problem.edge_up] != 0).any():
        raise AssertionError("te descent step: gradient not finite or leaking into padding")
    moved_apart = np.abs(out["card"][1] - out["cpu"][1]) > TE_ATOL
    record = {
        "max_abs_err_vs_cpu": err,
        "metric_steps_apart": {
            "edges": int(moved_apart.sum()),
            "max_abs_grad_there": float(np.abs(grad_cpu[moved_apart]).max())
            if moved_apart.any() else 0.0,
        },
        "max_abs_grad": float(np.abs(grad).max()),
        "objective": float(out["card"][0]),
        "grad_nonzero": int((grad != 0).sum()),
        "first_call_s": card_s,
        "cpu_s": cpu_s,
    }
    if timer.cuda:
        record["profiled_step"] = profiled_step(
            lambda: soft.te_descent_step(*tensors(device), **kw)
        )
    return record


def profiled_step(fn) -> dict:
    """One call of `fn` under torch.profiler: its wall time (with the
    profiler's overhead), the device kernels it launched, their summed
    device time and the device's idle share of the wall time.  A
    profiler that cannot trace the card is reported, not fatal: it is
    instrumentation, not the path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [
            e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
        ]
        by_name: dict = {}
        for e in kernels:
            n, ms = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, ms + (e.time_range.end - e.time_range.start) / 1e3)
        busy_ms = sum(ms for _, ms in by_name.values())
    except Exception as e:  # noqa: BLE001
        return {"error": repr(e)}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return {
        "wall_ms": wall_ms,
        "kernel_launches": len(kernels),
        "device_busy_ms": busy_ms,
        "idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
        "top_kernels": [
            {"name": name[:80], "launches": n, "ms": ms} for name, (n, ms) in top
        ],
    }


def te_wan100k(device, backend, ls, timer, steps: int = 12, round_trips: int = 3) -> dict:
    """The reference's TE bench at wan100k (bench.py bench_te_wan100k) on
    the port: `TeOptimizer(engine)` over the mirror of `ls` (the main
    path's WAN), metric box 1..16, 512 sources toward 4 destinations,
    `steps` descent steps in `round_trips` anneal stages, 64 softmin and
    48 flow sweeps; then `hill_climb` with the same number of exact
    evaluations.  Every exact evaluation equals scipy's Dijkstra on the
    reversed graph for the 4 destinations, bit for bit; re-evaluating
    the result gives its objective exactly; the metrics are integers in
    [1, 16]; K1's uint16 variant launches once per exact evaluation
    (counts set to 0 just before each search and read just after), and
    on the first evaluation's inputs K1 equals its plain version bit for
    bit in both variants (`slab_pair_records`, timed against its bound);
    the first descent step on the card equals the port's CPU run at
    TE_RTOL / TE_ATOL."""
    import torch

    from openr_tpu_torch.te import TeOptimizer, TeProblem, hill_climb
    from openr_tpu_torch.te import soft
    from openr_tpu_torch.te.exact import ExactEvaluator

    t_phase = time.perf_counter()
    csr = backend.csr_mirror(ls)
    engine = backend.engine
    dests, demand = te_demand(csr.n_nodes, csr.node_capacity)
    problem = TeProblem.from_topology(csr, dests, demand, metric_lo=1, metric_hi=16)
    step_ms = []
    real_step = soft.te_descent_step

    def timed_step(*args, **kwargs):
        if timer.cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_step(*args, **kwargs)
        if timer.cuda:
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    log = ExactLog()
    capture = ExactK1Capture(engine)
    soft.te_descent_step = timed_step
    try:
        if timer.cuda:
            torch.cuda.reset_peak_memory_stats()
        opt = TeOptimizer(engine)
        zero_launch_counts()
        t0 = time.perf_counter()
        res = opt.optimize(
            problem, steps=steps, round_trips=round_trips, n_sweeps=64, flow_sweeps=48,
        )
        te_wall_s = time.perf_counter() - t0
        te_launches = launch_counts()
        te_evals = log.take()
        peak = torch.cuda.max_memory_allocated() if timer.cuda else None
        zero_launch_counts()
        t0 = time.perf_counter()
        _hm, hill_obj, hill_evals = hill_climb(
            problem, rounds=res.round_trips, seed=1, engine=engine
        )
        hill_wall_s = time.perf_counter() - t0
        hill_launches = launch_counts()
        hill_log = log.take()
    finally:
        soft.te_descent_step = real_step
        log.close()
        capture.close()
    for what, evals, launches in (
        ("te", te_evals, te_launches), ("hill", hill_log, hill_launches),
    ):
        if launches[KERNEL_U16["name"]] != len(evals) or sum(launches.values()) != len(evals):
            raise AssertionError(f"{what}: {len(evals)} exact evaluations launched {launches}")
    if len(te_evals) != res.round_trips or len(hill_log) != hill_evals:
        raise AssertionError("te: evaluation count differs from the search's own")
    oracle_s = check_exact_evals(problem, te_evals + hill_log, "te_wan100k")
    live = res.metrics[: problem.n_edges][problem.edge_up[: problem.n_edges]]
    if res.metrics.dtype != np.int32 or live.min() < 1 or live.max() > 16:
        raise AssertionError("te: metrics not integers in [1, 16]")
    again = ExactEvaluator(
        problem.edge_src, problem.edge_dst, problem.edge_up, problem.node_overloaded,
        problem.n_edges, problem.n_nodes, problem.dest_ids, problem.demand,
        problem.capacity, engine=engine,
    ).evaluate(res.metrics)
    if again != res.objective_after:
        raise AssertionError(f"te: re-evaluation {again} != {res.objective_after}")
    # K1 against its plain version on the first exact evaluation's inputs
    k1_exact = slab_pair_records(*capture.slab, timer, "te exact evaluation")
    del capture
    step = descent_step_record(problem, device, timer)
    counters = opt.get_counters()
    record = {
        "phase": "te_wan100k",
        "nodes": csr.n_nodes,
        "edges": int(problem.n_edges),
        "sources": 512,
        "dests": dests.tolist(),
        "te_wall_s": te_wall_s,
        "te_steps": res.steps,
        "te_round_trips": res.round_trips,
        "te_accepted": res.accepted,
        "te_changed_edges": len(res.changed_edges),
        "exact_objective_before": res.objective_before,
        "exact_objective_after": res.objective_after,
        "hill_wall_s": hill_wall_s,
        "hill_evals": hill_evals,
        "hill_objective_after": hill_obj,
        "te_beats_or_matches_hill": bool(res.objective_after <= hill_obj + 1e-9),
        "descent_step_ms": step_ms,
        "exact_eval_ms": [e["ms"] for e in te_evals + hill_log],
        "k1_launches": {"te": te_launches, "hill": hill_launches},
        "k1_exact": k1_exact,
        "oracle_s": oracle_s,
        "first_step": step,
        "counters": {k: v for k, v in counters.items() if not k.endswith("_milli")},
        "phase_s": time.perf_counter() - t_phase,
    }
    if timer.cuda:
        record["card"] = card_line()
        record["peak_device_bytes"] = peak
    return record


def undrain(ls) -> list[str]:
    """Publish every drained node of `ls` undrained; returns them."""
    import dataclasses

    dbs = ls.get_adjacency_databases()
    drained = [v for v, db in dbs.items() if db.is_overloaded]
    for v in drained:
        ls.update_adjacency_database(dataclasses.replace(dbs[v], is_overloaded=False))
    return drained


def path_links_key(paths) -> list:
    return [[link.ordered_names for link in p] for p in paths]


def serving_wan100k(device, backend, ls, timer, n_routers: int = 64,
                    n_paths: int = 256, n_checked: int = 8) -> dict:
    """The query-serving layer at wan100k (no drained node: the scipy
    oracle takes none): `EngineBatchBackend({"0": ls})` on `backend`
    (the card's DeviceSpfBackend) before
    `QueryScheduler(max_pending=1024, max_coalesce=64)`, one burst of
    `n_paths` single-source paths queries drawn from `n_routers` routers
    (RandomState(5)), 4 what-if queries of 2 single-link scenarios each
    over the same 2 sources, 4 KSP queries (k = 2 from w000000, 8
    destinations each) and 2 identical optimize_metrics queries (64
    demand triples from RandomState(6), bounds 1..16, 12 steps), K1's
    counts set to 0 just before the burst and read just after; then one
    flap that lands in a staged paths batch (`trace_hook`), which the
    scheduler invalidates and recomputes.  Checks: `n_checked` routers'
    answers (first those whose host Dijkstra `ls` has cached) equal the
    host Dijkstra's SpfResults; what-if and KSP equal
    scipy's Dijkstra (the oracles of `protection_queries` and
    `ksp_dual_metric_wan100k`, on two destinations of each KSP query);
    the TE reply re-evaluates exactly, and on its first exact
    evaluation's inputs K1 equals its plain version in both variants
    (`slab_pair_records`); every
    future resolves, replies + errors + shed equal the submitted, no
    error and no host fallback; the flap's replies carry the new
    epoch."""
    import dataclasses

    import torch

    from openr_tpu_torch.ops.sssp import INF32
    from openr_tpu_torch.serving import EngineBatchBackend, QueryScheduler
    from openr_tpu_torch.serving.backend import _te_problem_from_csr
    from openr_tpu_torch.te.exact import ExactEvaluator

    t_phase = time.perf_counter()
    csr = backend.csr_mirror(ls)
    names = csr.node_names
    n = csr.n_nodes
    rng = np.random.RandomState(5)
    routers = [names[i * n // n_routers] for i in range(n_routers)]
    path_srcs = [routers[i] for i in rng.randint(n_routers, size=n_paths)]
    wi_sources = (routers[0], routers[n_routers // 2])
    link_ids = rng.choice(csr.n_edges, size=8, replace=False)
    wi_links = [csr.edge_links[int(e)][0] for e in link_ids]
    wi_scen = [
        [[(wi_links[2 * q + j].n1, wi_links[2 * q + j].n2)] for j in range(2)]
        for q in range(4)
    ]
    ksp_src = names[0]
    ksp_dests = [names[int(i)] for i in rng.choice(np.arange(1, n), size=32, replace=False)]
    drng = np.random.RandomState(6)
    te_dests = [names[int(i)] for i in np.linspace(0, n - 1, 4).astype(int)]
    demand = tuple(
        (names[int(drng.randint(n))], te_dests[int(drng.randint(4))], float(drng.uniform(0.5, 2.0)))
        for _ in range(64)
    )
    demand = tuple(t for t in demand if t[0] != t[1])
    # the checked routers: those asked whose host Dijkstra `ls` has
    # cached (spf_main_path checked them), then every
    # (n_routers // n_checked)-th one asked
    asked = [s for s in routers if s in set(path_srcs)]
    cached = [s for s in asked if (s, True) in ls._spf_results]
    checked = list(dict.fromkeys(cached + asked[:: n_routers // n_checked]))[:n_checked]

    sched = QueryScheduler(EngineBatchBackend({"0": ls}, spf_backend=backend),
                           max_pending=1024, max_coalesce=64)
    sched.run()
    capture = ExactK1Capture(backend.engine)
    try:
        zero_launch_counts()
        t_burst = time.perf_counter()
        futs = [("paths", sched.submit("paths", sources=(s,))) for s in path_srcs]
        futs += [
            ("what_if", sched.submit("what_if", sources=wi_sources, scenarios=sc))
            for sc in wi_scen
        ]
        futs += [
            ("ksp", sched.submit("ksp", sources=(ksp_src,), dests=ksp_dests[8 * q: 8 * q + 8], k=2))
            for q in range(4)
        ]
        futs += [
            ("optimize_metrics", sched.submit(
                "optimize_metrics", demand=demand, bounds=(1, 16), steps=12))
            for _ in range(2)
        ]
        # replies in submission order; a paths reply keeps only the
        # checked routers' answers, so the host holds a batch or two of
        # SpfResults at a time and not the whole burst's
        n_submitted = len(futs)
        by_op: dict = {}
        answers, errors = {}, []
        for i, (op, f) in enumerate(futs):
            futs[i] = None
            try:
                r = f.result(900)
            except Exception as e:  # noqa: BLE001
                errors.append(f"{op}: {e!r}")
                continue
            if op == "paths":
                answers.update((s, v) for s, v in r.value.items() if s in checked)
                r = dataclasses.replace(r, value=None)
            by_op.setdefault(op, []).append(r)
        del futs, f
        burst_s = time.perf_counter() - t_burst
        launches = launch_counts()
        counters = sched.get_counters()
        shed = counters["serving.shed"]
        if errors or shed or sum(map(len, by_op.values())) != n_submitted:
            raise AssertionError(f"serving burst: {len(errors)} errors, {shed} shed: {errors[:3]}")

        # paths: the checked routers against the host Dijkstra
        t0 = time.perf_counter()
        for s in checked:
            want = ls.get_spf_result(s)
            if spf_key(answers[s]) != spf_key(want):
                raise AssertionError(f"serving paths {s}: differs from the host Dijkstra")
        paths_oracle_s = time.perf_counter() - t0
        del answers

        # what-if and KSP against scipy's Dijkstra
        t0 = time.perf_counter()
        graph = oracle_graph(ls, csr)
        node_id = csr.node_id
        base = {s: scipy_dist(graph, node_id[s]) for s in wi_sources}
        for q, r in enumerate(by_op["what_if"]):
            for f, row in enumerate(r.value):
                lost = degraded = 0
                (a, b), = wi_scen[q][f]
                for s, d0 in base.items():
                    d1 = scipy_dist(graph, node_id[s], drop_pairs=[(node_id[a], node_id[b])])
                    lost += int(((d0 < INF32) & (d1 >= INF32)).sum())
                    degraded += int(((d0 < INF32) & (d1 < INF32) & (d1 > d0)).sum())
                if (row["newly_unreachable_pairs"], row["degraded_pairs"]) != (lost, degraded):
                    raise AssertionError(f"serving what-if {q}/{f}: {row} against ({lost}, {degraded})")
        d_src = scipy_dist(graph, node_id[ksp_src])
        ksp_rows = 0
        for q, r in enumerate(by_op["ksp"]):
            # two destinations of each query against scipy
            for dest, paths in list(r.value.items())[:: max(1, len(r.value) // 2)][:2]:
                first = backend.get_kth_paths(ls, ksp_src, dest, 1)
                pairs = {(node_id[l.n1], node_id[l.n2]) for p in first for l in p}
                cost1 = [path_cost(p, ksp_src) for p in first]
                if any(c != d_src[node_id[dest]] for c in cost1):
                    raise AssertionError(f"serving ksp {dest}: a first path is not shortest")
                d2 = scipy_dist(graph, node_id[ksp_src], drop_pairs=sorted(pairs))[node_id[dest]]
                cost2 = [path_cost(p, ksp_src) for p in paths]
                if (d2 >= INF32) != (not paths) or any(c != d2 for c in cost2):
                    raise AssertionError(f"serving ksp {dest}: second paths {cost2} against {d2}")
                used = [l for p in paths for l in p]
                if len(used) != len(set(used)) or set(used) & {l for p in first for l in p}:
                    raise AssertionError(f"serving ksp {dest}: paths not edge-disjoint")
                ksp_rows += 1
        protection_oracle_s = time.perf_counter() - t0

        # optimize_metrics: one descent run, re-evaluated exactly
        te_replies = [r.value for r in by_op["optimize_metrics"]]
        if te_replies[0] != te_replies[1] or by_op["optimize_metrics"][0].batch_size != 2:
            raise AssertionError("serving optimize_metrics: the identical queries did not coalesce")
        te_reply = te_replies[0]
        problem = _te_problem_from_csr(csr, demand, (1, 16))
        metric = np.where(problem.edge_up, problem.edge_metric, 1).astype(np.int32)
        e = problem.n_edges
        # the proposals name (src, dst) pairs: every up edge of a pair
        # takes its metric
        cap = np.int64(csr.node_capacity)
        key = problem.edge_src[:e].astype(np.int64) * cap + problem.edge_dst[:e]
        order = np.argsort(key, kind="stable")
        props = np.array(
            [(node_id[u], node_id[v], m) for u, v, m in te_reply["proposedMetrics"]],
            dtype=np.int64,
        ).reshape(-1, 3)
        pkey = props[:, 0] * cap + props[:, 1]
        lo = np.searchsorted(key[order], pkey, side="left")
        count = np.searchsorted(key[order], pkey, side="right") - lo
        starts = np.repeat(lo - np.cumsum(count) + count, count)
        hit = order[starts + np.arange(count.sum())]
        value = np.repeat(props[:, 2], count)
        live = problem.edge_up[hit]
        metric[hit[live]] = value[live]
        again = ExactEvaluator(
            problem.edge_src, problem.edge_dst, problem.edge_up, problem.node_overloaded,
            problem.n_edges, problem.n_nodes, problem.dest_ids, problem.demand,
            problem.capacity, engine=backend.engine,
        ).evaluate(metric)
        if again != te_reply["objectiveAfter"]:
            raise AssertionError(f"serving optimize_metrics: re-evaluation {again} != reply")
        te_evals = te_reply["roundTrips"]
        if launches[KERNEL_U16["name"]] != te_evals or sum(launches.values()) != te_evals:
            raise AssertionError(f"serving burst: {te_evals} exact evaluations launched {launches}")
        # K1 against its plain version on the reply's first exact evaluation
        k1_exact = slab_pair_records(*capture.slab, timer, "serving exact evaluation")

        # one flap landing in a staged paths batch
        flapped = {}
        flap_router = routers[1]

        def flap(event, batch):
            if event == "stage" and batch.op == "paths" and not flapped:
                db = ls.get_adjacency_databases()[flap_router]
                first_adj = db.adjacencies[0]
                raised = dataclasses.replace(
                    db, adjacencies=[dataclasses.replace(first_adj, metric=first_adj.metric + 7),
                                     *db.adjacencies[1:]],
                )
                flapped["epoch_pinned"] = batch.epoch
                ls.update_adjacency_database(raised)
                flapped["epoch_after"] = int(ls.version)

        inval0 = sched.get_counters()["serving.invalidations"]
        sched.trace_hook = flap
        t0 = time.perf_counter()
        after = [sched.submit("paths", sources=(s,)).result(900) for s in checked[:1]]
        flap_s = time.perf_counter() - t0
        sched.trace_hook = None
        final = sched.get_counters()
        if final["serving.invalidations"] <= inval0 or any(r.epoch != int(ls.version) for r in after):
            raise AssertionError(f"serving flap: {final}, epochs {[r.epoch for r in after]}")
        csr = backend.csr_mirror(ls)
        want = scipy_dist(oracle_graph(ls, csr), node_id[checked[0]])
        got = after[0].value[checked[0]]
        if any(got[names[j]].metric != want[j] for j in range(n) if want[j] < INF32):
            raise AssertionError("serving flap: the recomputed answer differs from scipy")
        submitted = n_submitted + len(after)
        if final["serving.replies"] + final["serving.errors"] + final["serving.shed"] != submitted:
            raise AssertionError(f"serving: {final} against {submitted} submitted")
        if final["serving.errors"] or final["serving.host_fallbacks"]:
            raise AssertionError(f"serving: errors or host fallbacks {final}")
    finally:
        sched.stop()
        capture.close()

    def lat(op):
        us = [r.latency_us for r in by_op[op]]
        return {"p50_ms": float(np.median(us)) / 1e3, "max_ms": max(us) / 1e3, "n": len(us)}

    record = {
        "phase": "serving_wan100k",
        "nodes": n,
        "submitted": submitted,
        "burst_s": burst_s,
        "latency": {op: lat(op) for op in by_op},
        "batch_sizes": {op: sorted({r.batch_size for r in by_op[op]}) for op in by_op},
        "counters": {k: v for k, v in final.items() if ".hist_us." not in k},
        "k1_launches": launches,
        "te_reply": {k: v for k, v in te_reply.items() if k != "proposedMetrics"},
        "te_proposed_metrics": len(te_reply["proposedMetrics"]),
        "checked_routers": checked,
        "checked_cached": len(cached),
        "ksp_rows_checked": ksp_rows,
        "k1_exact": k1_exact,
        "flap": {**flapped, "router": flap_router, "query_s": flap_s},
        "paths_oracle_s": paths_oracle_s,
        "protection_oracle_s": protection_oracle_s,
        "phase_s": time.perf_counter() - t_phase,
    }
    if timer.cuda:
        record["card"] = card_line()
        record["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    return record


def path_cost(path, src: str) -> int:
    """The metric of a path of links traced from `src`."""
    cost, at = 0, src
    for link in path:
        cost += link.metric_from_node(at)
        at = link.other_node_name(at)
    return cost


def spf_key(result) -> dict:
    """An SpfResult as plain values: per node the metric, the ordered
    path links ((node, iface) pairs, from node) and the sorted next
    hops."""
    return {
        node: (
            r.metric,
            [(link.ordered_names, prev) for link, prev in r.path_links],
            sorted(r.next_hops),
        )
        for node, r in result.items()
    }


def decision_serving(card, oracle, routers, router) -> dict:
    """Step (i) of decision_main_path: the serving layer as the daemon
    wires it, `QueryScheduler(DecisionBatchBackend(decision),
    defer_hint=decision.pending_event_hint)` over the card Decision: 8
    paths queries over `routers` (each asked more than once, so
    duplicates merge in a batch) and one KSP query (k = 2 from `router`
    to another of them), every answer equal to the host-Dijkstra
    Decision's (`oracle`, whose LinkState caches the Dijkstra of
    `routers` from the fleet dumps' checks)."""
    from openr_tpu_torch.serving import DecisionBatchBackend, QueryScheduler

    sched = QueryScheduler(
        DecisionBatchBackend(card), defer_hint=card.pending_event_hint
    )
    dests = [r for r in routers if r != router][:1]
    sched.run()
    try:
        t0 = time.perf_counter()
        paths = [sched.submit("paths", sources=(s,)) for s in (list(routers) * 8)[:8]]
        ksp = sched.submit("ksp", sources=(router,), dests=tuple(dests), k=2)
        got = [f.result(900) for f in paths]
        got_ksp = ksp.result(900)
        wall_s = time.perf_counter() - t0
        counters = sched.get_counters()
    finally:
        sched.stop()

    def answers():
        ls = oracle.area_link_states["0"]
        spf = oracle.spf_solver.spf
        return (
            {s: spf.get_spf_result(ls, s) for s in routers},
            {d: spf.get_kth_paths(ls, router, d, 2) for d in dests},
        )

    t0 = time.perf_counter()
    want, want_ksp = oracle.run_in_event_base_thread(answers).result()
    oracle_s = time.perf_counter() - t0
    for r in got:
        for s, res in r.value.items():
            if spf_key(res) != spf_key(want[s]):
                raise AssertionError(f"(i) paths {s}: differs from the host-Dijkstra Decision")
    for d in dests:
        if path_links_key(got_ksp.value[d]) != path_links_key(want_ksp[d]):
            raise AssertionError(f"(i) ksp {d}: differs from the host-Dijkstra Decision")
    if counters["serving.errors"] or counters["serving.replies"] != len(paths) + 1:
        raise AssertionError(f"(i) serving counters {counters}")
    return {
        "paths_queries": len(paths),
        "ksp_dests": dests,
        "ksp_second_paths": [len(got_ksp.value[d]) for d in dests],
        "batch_sizes": sorted({r.batch_size for r in got}),
        "wall_s": wall_s,
        "oracle_s": oracle_s,
        "counters": {k: v for k, v in counters.items() if ".hist_us." not in k},
    }


def run(device, n_nodes=N_NODES, n_advertisers=N_ADVERTISERS,
        n_routers=N_ROUTERS, n_checked=N_CHECKED, kernel=None,
        outer_kernel=None, fabric_pods=FABRIC_PODS, check_pods=CHECK_PODS,
        node_shard_threshold=None, emit=emit):
    """Every phase on `device`, each phase record passed to `emit` as it
    completes; returns the kernels record.  `kernel` and `outer_kernel`
    replace the two kernels' wrappers in the kernel-against-plain phases
    (a rehearsal on the CPU passes counting stand-ins); a rehearsal also
    shrinks the fabrics and pins the blocked main path's
    `node_shard_threshold`."""
    from openr_tpu_torch.ops import _build
    from openr_tpu_torch.ops import blocked_outer as bo
    from openr_tpu_torch.ops import epilogue as ep

    timer = Timer(device)
    if timer.cuda:
        names = ["fused_epilogue", "blocked_outer"]
        build_s = _build.build(names)
        emit(
            {
                "phase": "build",
                "seconds": build_s,
                "ptxas": {
                    name: [
                        line.strip()
                        for line in _build.library_path(name)
                        .with_suffix(".log")
                        .read_text()
                        .splitlines()
                        if "registers" in line or "spill" in line
                    ]
                    for name in names
                },
            }
        )
    for record in kernel_vs_plain_small(
        device, kernel or ep.fused_epilogue, ep.fused_epilogue_reference
    ):
        emit(record)
    for record in kernel_vs_plain_random(
        device, kernel or ep.fused_epilogue, ep.fused_epilogue_reference
    ):
        emit(record)
    record, int32_launches = saturation_retry(device, timer)
    emit(record)
    main, k1_records, (inp, solver, checked) = main_path(
        device, n_nodes, n_advertisers, n_routers, n_checked, timer
    )
    emit(main)
    # K1's int32 variant runs on the saturation retry's path
    k1_records["int32"]["launches"] = int32_launches
    emit(warm_rebuild(inp, solver, checked, timer))
    del solver
    record, storm_slabs, storm_k1 = flap_storm_wan100k(device, inp, timer)
    emit(record)
    # K1 on the delta rung's slabs: the storm's launches and slab times
    k1_records["uint16"]["launches_paths"] = {
        "main_path": k1_records["uint16"]["launches"],
        "flap_storm_wan100k": storm_k1,
    }
    for variant, slabs in storm_slabs.items():
        k1_records[variant]["delta_slabs"] = slabs
    # warm_rebuild's drained node restored before spf_main_path: the
    # serving phase's scipy oracle takes no drained node, and its host
    # Dijkstra check then reuses the LinkState's cached results of the
    # sources spf_main_path checked
    restored = undrain(inp.ls)
    record = spf_main_path(device, inp, timer)
    record["undrained_first"] = restored
    emit(record)
    # TE and serving on that LinkState and the main path's first
    # solver's DeviceSpfBackend (mirror and engine); K1 on each path's
    # first exact evaluation goes into its records as "te_exact"
    record = te_wan100k(device, inp.solver.spf, inp.ls, timer)
    emit(record)
    paths = k1_records["uint16"]["launches_paths"]
    paths["te_wan100k"] = record["k1_launches"]["te"][KERNEL_U16["name"]]
    te_exact = [("te_wan100k", record["k1_exact"])]
    record = serving_wan100k(device, inp.solver.spf, inp.ls, timer)
    emit(record)
    paths["serving_wan100k"] = record["k1_launches"][KERNEL_U16["name"]]
    te_exact.append(("serving_wan100k", record["k1_exact"]))
    for variant in k1_records:
        k1_records[variant]["te_exact"] = [
            {"path": path, **recs[variant]} for path, recs in te_exact
        ]
    del inp
    record, (wan_csr, wan_engine, wan_graph) = decision_main_path(
        device, timer, n_nodes, n_advertisers, n_routers, n_checked
    )
    emit(record)
    zero_launch_counts()
    record = ksp_dual_metric_wan100k(wan_csr, wan_engine, wan_graph, timer)
    record["kernel_launches"] = launch_counts()
    emit(record)
    del wan_csr, wan_engine, wan_graph
    zero_launch_counts()
    record = srlg_whatif_grid1024(device, timer)
    record["kernel_launches"] = launch_counts()
    emit(record)
    b_main, t_main = fabric_rounds(device, fabric_pods)
    record, outer_timing = blocked_kernel_vs_plain(
        device, outer_kernel or bo.blocked_outer, t_main, b_main, timer
    )
    emit(record)
    *closure, record = blocked_closure_vs_plain(
        device, check_pods, n_advertisers, timer
    )
    emit(record)
    emit(
        ell_main_path(
            device, check_pods, n_advertisers, n_routers, n_checked, timer,
            closure,
        )
    )
    del closure
    emit(spf_reconverge_fabric96(device, check_pods, timer))
    zero_launch_counts()
    record = ksp2_decision_fabric96(device, check_pods, timer)
    record["kernel_launches"] = launch_counts()
    emit(record)
    blocked, outer_record = blocked_main_path(
        device, fabric_pods, n_advertisers, n_routers, n_checked, timer,
        outer_timing, threshold=node_shard_threshold,
    )
    emit(blocked)
    return {"kernels": [k1_records["int32"], k1_records["uint16"], outer_record]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import openr_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = card_line()
    print(card, flush=True)
    emit(
        {
            "phase": "card",
            "nvidia_smi": card,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
        }
    )
    emit(run("cuda"))
    emit(
        {
            "ok": True,
            "device": {
                "platform": "gpu",
                "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count(),
            },
        }
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
