"""Distance-domain constants shared by the relax ops and the epilogue.

The values of `openr_tpu.ops.sssp` (INF32, INF16, WBIG16) and
`openr_tpu.ops.banded` (WBIG) as plain ints.  The port computes in
int32: distances stay below INF32 = 2^30 and clamped weights at or below
WBIG = 2^28, so every relax sum is below 2^31 and never wraps.  INF16 and
WBIG16 belong to the reference's uint16 distance mode, which the port
does not run yet; they are kept so the tests can map that mode onto the
int32 domain.
"""

INF32 = 1 << 30
WBIG = 1 << 28
INF16 = 40000
WBIG16 = 20000
