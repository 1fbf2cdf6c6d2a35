"""Cost of the fleet view on the OCS controller's 100k-node chorded ring.

    python scripts/probe_ocs_view.py [N_DESTS]

On the CUDA card: builds the kernels, runs `chip_smoke.ocs_rewire_wan100k`
with N_DESTS view destinations (default 64) and 8 checked routers, then
times one fleet view of 64, 256 and 1024 destinations on a fresh mirror
of the unrewired ring (every chord spanning half of it), each with its
sweep hint, product dtype and K1 launches.  Prints one JSON line each.
"""

import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from openr_tpu_torch.chaos.ocs import OcsController  # noqa: E402
from openr_tpu_torch.decision.csr import CsrTopology  # noqa: E402
from openr_tpu_torch.decision.fleet import FleetViewCache  # noqa: E402
from openr_tpu_torch.decision.link_state import LinkState  # noqa: E402
from openr_tpu_torch.device.engine import DeviceResidencyEngine  # noqa: E402
from openr_tpu_torch.ops import _build  # noqa: E402


class Ring(OcsController):
    def _name(self, i: int) -> str:
        return f"w{i % self.n:06d}"


def main() -> None:
    print(cs.card_line(), flush=True)
    print(json.dumps({"build_s": _build.build(["fused_epilogue", "blocked_outer"])}), flush=True)
    n_dests = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    rec, _, _ = cs.ocs_rewire_wan100k("cuda", cs.Timer("cuda"), n_dests=n_dests, n_checked=8)
    print(json.dumps(rec, default=str), flush=True)
    n = cs.OCS_NODES
    ctl = Ring(seed=13, n=n)
    by_node = [set() for _ in range(n)]
    for a, b in ctl._initial_chords():
        by_node[a].add((a, b))
        by_node[b].add((a, b))
    ls = LinkState("0")
    for i in range(n):
        ls.update_adjacency_database(ctl._node_db(i, by_node[i], {}))
    csr = CsrTopology.from_link_state(ls)
    engine = DeviceResidencyEngine("cuda")
    engine.blocked.node_shard_threshold = n
    for p in (64, 256, 1024):
        adv = np.sort(np.random.default_rng(7).choice(n, size=p, replace=False))
        cs.zero_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        view = FleetViewCache().view(
            ls, [ctl._name(int(i)) for i in adv], csr=csr, engine=engine
        )
        torch.cuda.synchronize()
        print(json.dumps({
            "p": p,
            "ms": (time.perf_counter() - t0) * 1e3,
            "sweep_hint": view.sweep_hint,
            "dtype": str(view._dist_dev.dtype),
            "launches": cs.launch_counts(),
            "small_dist_retries": engine.get_counters()["device.engine.small_dist_retries"],
        }), flush=True)


if __name__ == "__main__":
    main()
