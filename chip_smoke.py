#!/usr/bin/env python3
"""Chip smoke run of openr_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, holds each kernel
against its plain PyTorch version on the card, drives the port's main
path — the fleet route build `SpfSolver.fleet_route_dbs` over the
100k-node WAN of BASELINE config #3 (`benchmarks/synthetic.wan(100_000,
chords=2, seed=0)`) with 1024 prefix advertisers — checks its routes
against the host Dijkstra, and times the phases.  Each phase prints one
JSON line; the line before the last is the `kernels` record, and the
last line is {"ok": true, "device": {...}}.  Exits non-zero, printing no
result, when CUDA is not available or any check fails.  Imports nothing
of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N_NODES = 100_000
N_ADVERTISERS = 1024
N_ROUTERS = 32
N_CHECKED = 4
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the float32 rate
# outside the tensor cores, taken as the scalar integer ALU rate
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# integer operations per (node, column, group) of the epilogue: add,
# three compares, select, min, compare-and-or
EPILOGUE_OPS = 7
KERNEL = {
    "name": "fused_epilogue",
    "route": "cuda",
    "source": "openr_tpu_torch/ops/csrc/fused_epilogue.cu",
    "replaces": "openr_tpu/ops/pallas_kernels.py:240",
}


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


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


def product_and_groups(csr, dest_ids, engine, epilogue):
    """The fleet product of `dest_ids` on the engine's device with the
    given epilogue: (dist, bitmap, ok, epilogue group tables, n_words,
    reverse runner, relax ops)."""
    import torch

    from openr_tpu_torch.decision.fleet import _reverse_runner
    from openr_tpu_torch.ops import allsources as asrc
    from openr_tpu_torch.ops.banded import _RelaxOps
    from openr_tpu_torch.ops.epilogue import build_epilogue_groups

    runner = _reverse_runner(csr)
    out = asrc.build_out_ell(
        csr.edge_src, csr.edge_dst, csr.n_edges, csr.n_nodes, csr.out_slot
    )
    maps = asrc.build_epilogue_maps(runner.bg, out)
    engine.stage(runner)
    dist, bitmap, ok = asrc.reduced_all_sources(
        dest_ids, runner, out, maps=maps, epilogue=epilogue
    )
    ops = _RelaxOps(
        runner.bg,
        runner.call_arrays(),
        0 if runner.chord_mode else runner.depth,
        runner.resid_rounds,
        runner.chord_mode,
    )
    groups = build_epilogue_groups(
        ops,
        torch.from_numpy(maps.resid_slot).to(engine.device),
        torch.from_numpy(maps.band_slot).to(engine.device),
    )
    return dist, bitmap, ok, groups, out.n_words, runner, ops


def break_fixed_point(d, groups):
    """A copy of the converged product with one finite entry lowered by 1
    where another node's shortest path runs through it: the epilogue's
    verdict must turn False."""
    from openr_tpu_torch.ops.sssp import INF32, WBIG

    idx, w, ov, _ = (g.cpu().numpy() for g in groups)
    dn = d.cpu().numpy()
    for g in range(idx.shape[0]):
        du = dn[idx[g]]
        wg = w[g][:, None]
        tight = (wg < WBIG) & ((ov[g] == 0)[:, None] | (du == 0))
        tight &= (du > 0) & (du < INF32) & (dn < INF32) & (du + wg == dn)
        hits = np.argwhere(tight)
        if len(hits):
            v, p = hits[0]
            broken = d.clone()
            broken[int(idx[g][v]), int(p)] -= 1
            return broken
    raise AssertionError("no tight relax edge to break")


def compare(kernel, plain, d, groups, n_words) -> dict:
    """Kernel and plain version on the same inputs: bit-exact bitmaps and
    equal verdicts required."""
    import torch

    kb, kok = kernel(d, *groups, n_words)
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
    banded graphs, converged and deliberately not converged."""
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
    for name, (dbs, dests) in cases.items():
        csr = CsrTopology.from_link_state(link_state_of(dbs))
        d, _, ok, groups, n_words, _, _ = product_and_groups(
            csr, dests, engine, plain
        )
        if not ok:
            raise AssertionError(f"{name}: product did not converge")
        converged = compare(kernel, plain, d, groups, n_words)
        broken = compare(
            kernel, plain, break_fixed_point(d, groups), groups, n_words
        )
        if not converged["verdict"] or broken["verdict"]:
            raise AssertionError(f"{name}: wrong verdicts {converged} {broken}")
        records.append(
            {
                "phase": "kernel_vs_plain",
                "graph": name,
                "shape": list(d.shape),
                "groups": int(groups[0].shape[0]),
                "n_words": n_words,
                "max_abs_err": max(converged["max_abs_err"], broken["max_abs_err"]),
                "converged_verdict": converged["verdict"],
                "broken_verdict": broken["verdict"],
            }
        )
    return records


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


def main_path(device, n_nodes, n_advertisers, n_routers, n_checked, timer):
    """Phase 3: the fleet route build at full width, with its kernel
    launches counted, its routes checked against the host Dijkstra, and
    its kernel held against the plain epilogue on the same product."""
    import torch

    from openr_tpu_torch.decision.csr import CsrTopology
    from openr_tpu_torch.decision.fleet import FleetViewCache, fleet_destinations
    from openr_tpu_torch.decision.prefix_state import PrefixState
    from openr_tpu_torch.decision.spf_solver import SpfSolver
    from openr_tpu_torch.ops import epilogue as ep
    from openr_tpu_torch.ops.banded import make_dist0_orig
    from openr_tpu_torch.types import PrefixEntry
    from openr_tpu_torch.utils import topo

    rng = np.random.default_rng(7)
    adv_ids = np.sort(
        rng.choice(n_nodes, size=n_advertisers, replace=False)
    ).astype(np.int32)
    t0 = time.perf_counter()
    dbs = topo.wan_topology(n_nodes, chords=2, seed=0, labeled=adv_ids)
    ls = link_state_of(dbs)
    t_ls = time.perf_counter() - t0
    t0 = time.perf_counter()
    csr = CsrTopology.from_link_state(ls)
    t_csr = time.perf_counter() - t0
    names = ls.node_names
    advertisers = [names[i] for i in adv_ids]
    prefixes = [f"fc00:{i >> 16:x}:{i & 0xFFFF:x}::/64" for i in adv_ids]
    labels = [16 + int(i) for i in adv_ids]
    ps = PrefixState()
    for node, prefix in zip(advertisers, prefixes):
        ps.update_prefix(node, "0", PrefixEntry(prefix=prefix))
    routers = [names[i * n_nodes // n_routers] for i in range(n_routers)]
    solver = SpfSolver(names[0], device=device)
    area = {"0": ls}

    # the counted run of the main path
    ep.fused_epilogue.launches = 0
    t0 = time.perf_counter()
    dbs_out = solver.fleet_route_dbs(area, ps, nodes=routers)
    if timer.cuda:
        torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    launches = ep.fused_epilogue.launches
    main_counters = dict(solver.engine.counters)
    view = solver.fleet.view(ls, fleet_destinations(ls, ps), engine=solver.engine)
    if launches < 1 or main_counters["device.engine.kernel_launches"] < 1:
        raise AssertionError(
            f"main path launched the epilogue kernel {launches} times"
        )
    if not view.converged or sorted(dbs_out) != sorted(routers):
        raise AssertionError("main path: view not converged or routers missing")

    # routes of a few routers against the host Dijkstra
    t0 = time.perf_counter()
    checked = []
    for router in routers[:: max(1, n_routers // n_checked)][:n_checked]:
        want_u, want_m, want_d = expected_routes(
            ls, router, advertisers, prefixes, labels
        )
        got_u, got_m = route_sets(dbs_out[router])
        if got_u != want_u or got_m != want_m:
            raise AssertionError(f"routes of {router} differ from Dijkstra")
        for t, metric in want_d.items():
            if view.dist(router, t) != metric:
                raise AssertionError(f"dist({router}, {t}) differs")
        checked.append(router)
    t_oracle = time.perf_counter() - t0

    # the kernel against the plain epilogue on the main path's product
    dest_ids = np.asarray([csr.node_id[t] for t in view.dest_names], np.int32)
    dist, bitmap, ok, groups, n_words, runner, ops = product_and_groups(
        csr, dest_ids, solver.engine, ep.fused_epilogue_reference
    )
    if not ok or not torch.equal(dist, view._dist_dev):
        raise AssertionError("plain product differs from the main path's")
    parity = compare(ep.fused_epilogue, ep.fused_epilogue_reference, dist, groups, n_words)
    if not torch.equal(bitmap, view._bitmap_dev):
        raise AssertionError("plain bitmap differs from the main path's kernel")

    # phase times, each after one warm-up
    def view_compute():
        FleetViewCache().view(ls, view.dest_names, csr=csr, engine=solver.engine)

    def supersweep_blocks():
        d = make_dist0_orig(torch.as_tensor(dest_ids, device=dist.device), csr.n_nodes)
        for _ in range(runner.hint):
            d = ops.supersweep(d)
        return d

    times = {
        "host_link_state_s": t_ls,
        "host_csr_s": t_csr,
        "main_path_first_run_s": t_main,
        "view_compute_ms": timer.ms(view_compute, reps=1),
        "supersweeps": runner.hint,
        "supersweep_blocks_ms": timer.ms(supersweep_blocks, reps=1),
        "epilogue_kernel_ms": timer.ms(
            lambda: ep.fused_epilogue(dist, *groups, n_words), reps=20
        ),
        "epilogue_plain_ms": timer.ms(
            lambda: ep.fused_epilogue_reference(dist, *groups, n_words), reps=3
        ),
        "route_builds_ms": timer.ms(
            lambda: solver.fleet_route_dbs(area, ps, nodes=routers),
            reps=1,
            warmup=0,
        ),
        "oracle_check_s": t_oracle,
    }
    n, p = dist.shape
    g = int(groups[0].shape[0])
    bytes_moved = n * p * 4 + n * p * n_words * 4 + 16 * g * n
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = n * p * g * EPILOGUE_OPS / SCALAR_OPS_PER_S * 1e3
    kernel_record = {
        **KERNEL,
        "launches": launches,
        "parity": True,
        "max_abs_err": parity["max_abs_err"],
        "ms": times["epilogue_kernel_ms"],
        "plain_ms": times["epilogue_plain_ms"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "shape": {"N": n, "P": p, "W": n_words, "G": g},
    }
    record = {
        "phase": "main_path",
        "nodes": n_nodes,
        "directed_edges": csr.n_edges,
        "advertisers": n_advertisers,
        "destinations": len(view.dest_names),
        "routers": n_routers,
        "checked_routers": checked,
        "unicast_routes": sum(len(db.unicast_routes) for db in dbs_out.values()),
        "mpls_routes": sum(len(db.mpls_routes) for db in dbs_out.values()),
        "engine_counters": main_counters,
        "chord_mode": runner.chord_mode,
        "band_offsets": list(runner.bg.offsets),
        "residual_k": int(runner.bg.resid_nbr.shape[1]),
        "times": times,
    }
    if timer.cuda:
        record["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    return record, kernel_record


def run(device, n_nodes=N_NODES, n_advertisers=N_ADVERTISERS,
        n_routers=N_ROUTERS, n_checked=N_CHECKED, kernel=None, emit=emit):
    """Every phase on `device`, each phase record passed to `emit` as it
    completes; returns the kernels record.  `kernel` replaces the
    epilogue kernel (a rehearsal on the CPU passes a counting
    stand-in)."""
    from openr_tpu_torch.ops import _build
    from openr_tpu_torch.ops import epilogue as ep

    timer = Timer(device)
    if timer.cuda:
        build_s = _build.build([KERNEL["name"]])
        log = _build.library_path(KERNEL["name"]).with_suffix(".log")
        emit(
            {
                "phase": "build",
                "seconds": build_s,
                "ptxas": [
                    line.strip()
                    for line in log.read_text().splitlines()
                    if "registers" in line or "spill" in line
                ],
            }
        )
    for record in kernel_vs_plain_small(
        device, kernel or ep.fused_epilogue, ep.fused_epilogue_reference
    ):
        emit(record)
    main, kernel_record = main_path(
        device, n_nodes, n_advertisers, n_routers, n_checked, timer
    )
    emit(main)
    return {"kernels": [kernel_record]}


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
