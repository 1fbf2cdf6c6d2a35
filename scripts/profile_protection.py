#!/usr/bin/env python3
"""Profile the port's operator queries (TI-LFA and SRLG what-if) on a WAN.

    python scripts/profile_protection.py [--nodes 20000] [--device cpu]

Runs on the CUDA card unless `--device` names another device.  Builds `openr_tpu_torch.utils.topo.wan_topology(nodes)`, runs
`protection_api.ti_lfa` of w000000 and `protection_api.what_if` of three
scenarios once to build and stage the forward runner and learn its
masked hint, then once more under cProfile, and prints each call's wall
time and its most expensive functions (cumulative).
"""

from __future__ import annotations

import argparse
import cProfile
import pstats
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    from openr_tpu_torch.decision import protection_api as papi
    from openr_tpu_torch.decision.csr import CsrTopology
    from openr_tpu_torch.decision.link_state import LinkState
    from openr_tpu_torch.device.engine import DeviceResidencyEngine
    from openr_tpu_torch.utils import topo

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=20_000)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args()

    ls = LinkState()
    for db in topo.wan_topology(args.nodes):
        ls.update_adjacency_database(db)
    csr = CsrTopology.from_link_state(ls)
    engine = DeviceResidencyEngine(args.device)
    scenarios = [
        [("w000000", "w000001")],
        [("w000000", "w000001"), ("w000000", "w000002")],
        [("w000100", "w000101")],
    ]
    calls = {
        "ti_lfa": lambda: papi.ti_lfa(ls, "w000000", csr=csr, engine=engine),
        "what_if": lambda: papi.what_if(
            ls, scenarios, ["w000000"], csr=csr, engine=engine
        ),
    }
    for name, call in calls.items():
        call()
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        call()
        prof.disable()
        print(f"{name}: {time.perf_counter() - t0:.3f} s at {args.nodes} nodes")
        pstats.Stats(prof).sort_stats("cumulative").print_stats(args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
