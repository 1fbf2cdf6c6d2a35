"""Kernel K2 at the extents of one shard of a sharded tile tensor, on
the card: `ops.blocked_outer.blocked_outer` against its plain version
`blocked_outer_reference`, bit for bit, through both of the kernel's
paths.  Card-only (`-m cuda`); this file imports no JAX, so it runs on
the machine with the card as it is."""

from __future__ import annotations

import pytest
import torch

from openr_tpu_torch.ops import blocked_outer as bo


@pytest.mark.cuda
def test_kernel_at_shard_extents_on_card():
    """K2 against its plain version on the card at shard extents, both
    of the kernel's paths (mc = 2T at odd T takes the scalar one), every
    k (runs with `-m cuda` on a machine with an sm_90 card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    for s, t, b, nr, nc in ((1, 7, 16, 1, 8), (2, 6, 16, 2, 4), (1, 5, 12, 3, 2)):
        br, bc = b // nr, b // nc

        def randint(*shape):
            return torch.randint(
                0, 1 << 20, shape, dtype=torch.int32, device="cuda", generator=gen
            )

        d, row, col = randint(s, t, br, t, bc), randint(s, b, t, bc), randint(s, t, br, b)
        ov = torch.rand(t * b, device="cuda", generator=gen) < 0.2
        for r in range(nr):
            for c in range(nc):
                lanes = (r * br, c * bc)
                for k in range(t):
                    got = bo.blocked_outer(d.clone(), row, col, ov, k, lanes)
                    want = bo.blocked_outer_reference(d.clone(), row, col, ov, k, lanes)
                    torch.cuda.synchronize()
                    assert torch.equal(got, want), (s, t, b, nr, nc, r, c, k)
