"""Device-parallel rungs of the fleet product: the mesh, the mesh-sharded
SPF steps and the blocked APSP rung over a ("batch", "row", "col")
mesh.

Port of `openr_tpu.parallel`.  One controller places every shard: the
sources of a batched SSSP split over the "batch" mesh axis (independent
problems, no exchange), the node axis of its [S, N] state over "node"
(one all-gather of the state per sweep), and the blocked APSP's lane
dims over "row" and "col" (panel all-gathers per round).
"""

from .blocked import BlockedApspEngine, make_blocked_mesh
from .mesh import (
    make_mesh,
    sharded_spf_forward,
    spf_step_sharded,
)

__all__ = [
    "BlockedApspEngine",
    "make_blocked_mesh",
    "make_mesh",
    "sharded_spf_forward",
    "spf_step_sharded",
]
