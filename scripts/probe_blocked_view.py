"""The blocked rung's fleet view at fabric315, timed for one source tree.

    python scripts/probe_blocked_view.py [--tree DIR] [--modes auto,0] [--reps 3]

`--device cpu --pods 2 --threshold 64` rehearses it on the CPU at a toy
size (plain versions, no launches counted).

On the CUDA card: imports `chip_smoke` and `openr_tpu_torch` from DIR
(default: this checkout), so that an unpacked older tree can be timed
against this one in the same call.  Builds K2, the fabric315 inputs of
`chip_smoke.blocked_main_path` and times:

- the first route build (`chip_smoke.counted_route_build`), K2 launches;
- one round's diag and panels phases at k = T / 2 (20 reps each);
- for each pipeline mode in --modes, the fleet view on a fresh cache,
  --reps times, with K2's launches in the last.  Mode `auto` leaves
  `pipeline_mode` unset (a tree without the pipelined loop takes its
  only loop); `0` pins the bulk loop and needs a tree that has it.

Prints the card's line, then one JSON line (the pipelined loop's
lookahead count per mode where the tree has it).
"""

import argparse
import json
import os
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=".")
    ap.add_argument("--modes", default="auto")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pods", type=int, default=None)
    ap.add_argument("--threshold", type=int, default=None)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    import chip_smoke as cs
    from openr_tpu_torch.decision.fleet import FleetViewCache
    from openr_tpu_torch.ops import _build
    from openr_tpu_torch.parallel.blocked import blocked_diag, blocked_panels

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("probe_blocked_view: no CUDA card")
    rec = {"tree": args.tree}
    if cuda:
        print(cs.card_line(), flush=True)
        rec["build_s"] = _build.build(["blocked_outer"])

    def sync():
        if cuda:
            torch.cuda.synchronize()

    timer = cs.Timer(args.device)
    k2 = cs.OUTER_KERNEL["name"]
    pods = args.pods or cs.FABRIC_PODS
    inp = cs.fleet_inputs(
        lambda: cs.fabric_dbs(pods, min(cs.N_ADVERTISERS, pods * 8)),
        cs.N_ROUTERS,
        args.device,
    )
    ls, csr, engine = inp.ls, inp.csr, inp.solver.engine
    blocked = engine.blocked
    if args.threshold is not None:
        blocked.node_shard_threshold = args.threshold
    _, first_s, launches, _, view = cs.counted_route_build(inp.solver, inp, timer)
    if not view.node_sharded:
        raise AssertionError("the route build did not take the blocked rung")
    n = csr.n_nodes
    b = blocked.tile_for(n)
    t = -(-n // b)
    rec.update(nodes=n, tile=b, rounds=t, first_route_build_s=first_s,
               first_route_build_k2=launches[k2])

    d5 = blocked.dense_dist0(
        n, t * b, csr.edge_src, csr.edge_dst, csr.edge_metric, csr.edge_up,
        csr.n_edges,
    ).view(1, t, b, t, b)
    ov = torch.zeros(t * b, dtype=torch.bool, device=d5.device)
    ov[:n] = torch.from_numpy(csr.node_overloaded[:n].astype(bool))
    k = t // 2
    closed = blocked_diag(d5, ov, k)
    rec["round_ms"] = {
        "diag": timer.ms(lambda: blocked_diag(d5, ov, k), reps=20),
        "panels": timer.ms(lambda: blocked_panels(d5, closed, ov, k), reps=20),
    }
    del d5, closed

    counters = getattr(blocked, "get_counters", dict)
    rec["view_s"] = {}
    for mode in args.modes.split(","):
        if mode != "auto":
            if not hasattr(blocked, "pipeline_mode"):
                raise SystemExit(f"tree {args.tree} has no pipeline_mode")
            blocked.pipeline_mode = mode
        times = []
        key = "mesh.blocked.pipeline_prefetch_issues"
        before = counters().get(key, 0)
        for _ in range(args.reps):
            cs.zero_launch_counts()
            sync()
            t0 = time.perf_counter()
            FleetViewCache().view(ls, view.dest_names, csr=csr, engine=engine)
            sync()
            times.append(time.perf_counter() - t0)
        got = cs.launch_counts()[k2]
        if cuda and got != t:
            raise AssertionError(f"mode {mode}: {got} K2 launches, expected {t}")
        rec["view_s"][mode] = times
        rec.setdefault("lookaheads_per_view", {})[mode] = (
            counters().get(key, 0) - before
        ) / args.reps
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
