"""K1's uint16 variant at the smoke's shapes, timed for one source tree.

    python scripts/probe_epilogue_u16.py [--tree DIR] [--reps 20] [--ablate]

Imports `openr_tpu_torch` from DIR (default: this checkout), so that an
unpacked older tree can be timed against this one in the same call
(parent, change, change, parent).  Builds K1 and makes, from a seed, one
converged uint16 product with its group tables at each shape of the
smoke's uint16 launches (`SHAPES`: the main path's [100 000, 1024], the
flood slab, a mesh shard, the OCS view, the delta slabs and the exact
evaluation): distances d[v, p] = base[p] + level[v] below WBIG16, 2% of
the columns INF16, band groups at offsets 1, 2, N - 1, N - 2 and random
chord rows, weights level[v] - level[u] (at least 0) plus 0 (30%) or
1..10, 0.5% overloaded predecessors, 5% slot -1.  Each shape's kernel is
held against the plain version bit for bit (bitmap and verdict), then
timed as the median of --reps calls between CUDA events.  K1's int32
variant is timed too, on the main shape's product widened.

`--ablate` (a tree with the packed design) also times at the main shape
the stream alone (no groups), the group work without L2 gathers (every
gather row the node's own, served from L1), the wide path
with half and with twice its tile (2 and 8 passes of the block's
threads against 4) and at slabs of 64 and 256 columns, the narrow path on the first 64 columns, and a copy
of d.  Where `torch.profiler` sees the card, each time also has the
kernel's own device time beside it (`kernel_ms`: the events' median
includes the wrapper's host work, which dominates a narrow launch).  `--device cpu --nodes 2000` rehearses it on the CPU at a toy size
(plain versions, host clock).

Prints the card's line, then one JSON line.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# (name, P, band groups, chord groups) at N nodes
SHAPES = (
    ("main", 1024, 4, 4),
    ("flood_slab", 512, 4, 4),
    ("mesh_shard", 256, 4, 4),
    ("ocs_view", 64, 4, 2),
    ("delta_pb32", 32, 4, 4),
    ("delta_pb8", 8, 4, 4),
    ("te_exact", 4, 4, 4),
)
INF16 = 40000


def synthetic(n, p, n_bands, n_chords, seed, device):
    """(d [n, p] uint16 at its fixed point, (idx, w, ov, slot) [G, n])."""
    import torch

    rng = np.random.default_rng(seed)
    level = rng.integers(0, 4000, n)
    base = rng.integers(0, 15000, p)
    v = np.arange(n)
    rows = [(v - c) % n for c in (1, 2, n - 1, n - 2)[:n_bands]]
    rows += [rng.integers(0, n, n) for _ in range(n_chords)]
    idx = np.stack(rows)
    extra = np.where(rng.random(idx.shape) < 0.3, 0, rng.integers(1, 11, idx.shape))
    w = np.maximum(level[None, :] - level[idx], 0) + extra
    ov = (rng.random(idx.shape) < 0.005).astype(np.int64)
    slot = rng.integers(0, 32, idx.shape)
    slot[rng.random(idx.shape) < 0.05] = -1
    inf_cols = rng.random(p) < 0.02

    def dev(a):
        return torch.as_tensor(a.astype(np.int32), device=device).contiguous()

    d = dev(level)[:, None] + dev(base)[None, :]
    d[:, torch.as_tensor(inf_cols, device=device)] = INF16
    d = torch.where(d >= 1 << 15, d - (1 << 16), d).to(torch.int16).view(torch.uint16)
    return d.contiguous(), tuple(dev(a) for a in (idx, w, ov, slot))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=".")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=100_000)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    from openr_tpu_torch.ops import _build
    from openr_tpu_torch.ops import epilogue as ep
    from openr_tpu_torch.ops.sssp import u16_dist_to_i32

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("probe_epilogue_u16: no CUDA card")
    rec = {"tree": args.tree, "nodes": args.nodes, "reps": args.reps}
    if cuda:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        print(card, flush=True)
        rec["card"] = card
        rec["build_s"] = _build.build(["fused_epilogue"])

    def median_ms(fn):
        fn()
        if not cuda:
            times = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
            return float(np.median(times))
        events = [
            (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            for _ in range(args.reps)
        ]
        torch.cuda.synchronize()
        for start, end in events:
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in events]))

    def kernel_ms(fn):
        """Device time of one call's kernels named *epilogue*: each one's
        mean over the launches torch.profiler recorded in --reps calls,
        summed over the kernels; None where it records none."""
        if not cuda:
            return None
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        per_call = 0.0
        for e in prof.key_averages():
            if "epilogue" in e.key and e.count:
                t = getattr(e, "device_time_total", None)
                t = t if t is not None else getattr(e, "cuda_time_total", 0.0)
                per_call += t / e.count
        return per_call / 1e3 if per_call else None

    def check(d, groups, plan=None):
        kw = {"plan": plan} if plan is not None else {}
        kb, kok = ep.fused_epilogue(d, *groups, 1, **kw)
        pb, pok = ep.fused_epilogue_reference(d, *groups, 1)
        if not (torch.equal(kb, pb) and bool(kok) == bool(pok) and bool(pok)):
            raise AssertionError(f"kernel and plain version disagree at {tuple(d.shape)}")

    device = torch.device(args.device)
    n = args.nodes
    shapes = {}
    main_inputs = None
    for seed, (name, p, n_bands, n_chords) in enumerate(SHAPES):
        d, groups = synthetic(n, p, n_bands, n_chords, seed, device)
        check(d, groups)
        call = lambda d=d, g=groups: ep.fused_epilogue(d, *g, 1)  # noqa: E731
        shapes[name] = {
            "shape": [n, p, int(groups[0].shape[0])],
            "ms": median_ms(call),
            "kernel_ms": kernel_ms(call),
        }
        if name == "main":
            main_inputs = (d, groups)
        else:
            del d, groups
    rec["uint16"] = shapes
    d, groups = main_inputs
    d32 = u16_dist_to_i32(d)
    check(d32, groups)
    call = lambda: ep.fused_epilogue(d32, *groups, 1)  # noqa: E731
    rec["int32_main"] = {"ms": median_ms(call), "kernel_ms": kernel_ms(call)}
    del d32
    if args.ablate:
        l2 = ep.l2_bytes(0) if cuda else 50 << 20
        plan = ep.epilogue_plan(n, d.shape[1], (), l2, int(groups[0].shape[0]), 2)
        idx, w, ov, slot = groups
        # every gather row the node's own (d + w >= d keeps the fixed point)
        own = torch.arange(n, dtype=torch.int32, device=device).expand_as(idx).contiguous()
        d64 = d.view(torch.int16)[:, :64].contiguous().view(torch.uint16)
        cases = {
            "planned": (d, groups, plan),
            "stream_alone": (d, tuple(t[:0] for t in groups), plan),
            "no_gathers": (d, (own, w, ov, slot), plan),
            "half_tile": (d, groups, plan._replace(node_tile=plan.node_tile // 2)),
            "double_tile": (d, groups, plan._replace(node_tile=plan.node_tile * 2)),
            "slab64": (d, groups, plan._replace(slab_cols=64, node_tile=64)),
            "slab256": (d, groups, plan._replace(slab_cols=256, node_tile=16)),
            "narrow_p64": (d64, groups, None),
        }
        times = {}
        for case, (dd, gg, pl) in cases.items():
            check(dd, gg, pl)
            kw = {"plan": pl} if pl is not None else {}
            call = lambda dd=dd, gg=gg, kw=kw: ep.fused_epilogue(dd, *gg, 1, **kw)  # noqa: E731
            times[case] = {"ms": median_ms(call), "kernel_ms": kernel_ms(call)}
        src = d.view(torch.int16)
        copy = torch.empty_like(src)
        times["copy_of_d"] = median_ms(lambda: copy.copy_(src))
        rec["ablation"] = {"plan": plan._asdict(), "ms": times}
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
