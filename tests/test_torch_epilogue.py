"""The port's fused epilogue against openr_tpu's, bit for bit.

`fused_epilogue_reference` (plain PyTorch, int32) is held against the
Pallas kernel `fused_epilogue_pallas` in interpret mode and against the
lax epilogue of `_fused_progressive_banded`, on the same converged
reverse-distance product, in both of the reference's distance modes
(uint16 / INF16 and int32 / INF32), with two bitmap words on the hub,
and on a product that is not at its fixed point.  Integer min-plus:
tolerance 0.  The CUDA kernel itself runs only on the card
(`-m cuda`); here the wrapper must refuse a CUDA request rather than
compute on the CPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.decision.fleet import _reverse_runner as j_reverse_runner
from openr_tpu.decision.link_state import LinkState as JLinkState
from openr_tpu.decision.fleet import _row_i32
from openr_tpu.ops import allsources as jasrc
from openr_tpu.ops import pallas_kernels as pk
from openr_tpu.ops.banded import _RelaxOps as JRelaxOps
from openr_tpu_torch.decision.fleet import FleetViewCache, _reverse_runner
from openr_tpu_torch.decision.spf_solver import SpfSolver
from openr_tpu_torch.device.engine import DeviceResidencyEngine, resolve_device
from openr_tpu_torch.ops import allsources as asrc
from openr_tpu_torch.ops import epilogue as ep
from openr_tpu_torch.ops.banded import _RelaxOps
from openr_tpu_torch.ops.sssp import INF16, INF32, WBIG, WBIG16

from torch_parity import (
    FAMILIES,
    break_fixed_point,
    link_states,
    mirrors,
    to_jax_dbs,
)

CASES = {
    "ring65": [0, 7, 31, 64],
    "wan256": [0, 5, 17, 48, 95, 200, 255],
    "hub_w2": [0, 9, 32, 40, 63],
}
# the hub's 40 relax groups make the reference's progressive program
# slow to compile on the CPU, so its product comes from the reference's
# host Dijkstra instead and is held against the Pallas kernel only
LAX_CASES = {"ring65", "wan256"}


def _port_groups(runner, maps, device="cpu"):
    runner.stage(torch.device(device))
    ops = _RelaxOps(
        runner.bg,
        runner.call_arrays(),
        0 if runner.chord_mode else runner.depth,
        runner.resid_rounds,
        runner.chord_mode,
    )
    return ep.build_epilogue_groups(
        ops,
        torch.from_numpy(maps.resid_slot),
        torch.from_numpy(maps.band_slot),
    )


def _jax_epilogue_pallas(jp, d):
    """The reference Pallas epilogue kernel (interpret mode) over `d` in
    the reference runner's distance domain: (bitmap, converged)."""
    runner = jp["runner"]
    _, _, r_met, r_up, r_ov = runner.call_arrays()
    jd = jnp.asarray(d)
    ops = JRelaxOps(
        runner.bg,
        r_up,
        r_met,
        r_ov[: runner.bg.n_nodes],
        0 if runner.chord_mode else runner.depth,
        runner.resid_rounds,
        None,
        jd.dtype == jnp.uint16,
        runner.chord_mode,
        jd.dtype,
    )
    bitmap, ok = pk.fused_epilogue(
        ops,
        runner.bg,
        jd,
        jp["maps"].resid_slot,
        jp["maps"].band_slot,
        jp["out"].n_words,
        interpret=True,
    )
    return np.asarray(jax.device_get(bitmap)), bool(ok)


def _dijkstra_product(name, jcsr, dests, small: bool) -> np.ndarray:
    """dist(v -> dests[p]) [N, P] from the reference's host Dijkstra, in
    its uint16 (INF16) or int32 (INF32) distance domain."""
    ls = JLinkState()
    for db in to_jax_dbs(FAMILIES[name]()):
        ls.update_adjacency_database(db)
    inf = INF16 if small else INF32
    d = np.full((jcsr.n_nodes, len(dests)), inf, dtype=np.int64)
    for v, name in enumerate(jcsr.node_names):
        spf = ls.get_spf_result(name)
        for p, t in enumerate(dests):
            res = spf.get(jcsr.node_names[t])
            if res is not None:
                d[v, p] = res.metric
    return d.astype(np.uint16 if small else np.int32)


# (family, reference distance mode); the hub's two-word bitmap is
# checked in the int32 mode only, to keep its interpret-mode kernel to
# one compile
PRODUCTS = [
    pytest.param((name, small), id=f"{name}-{'uint16' if small else 'int32'}")
    for name in sorted(CASES)
    for small in (True, False)
    if not (name == "hub_w2" and small)
]


@pytest.fixture(scope="module", params=PRODUCTS)
def reference(request):
    """The reference fleet product in one distance mode with its lax
    epilogue, and the port's group tables of the same graph."""
    name, small = request.param
    csr, jcsr = mirrors(FAMILIES[name]())
    runner = j_reverse_runner(jcsr)
    runner.small_allowed = small
    out = jasrc.build_out_ell(
        jcsr.edge_src,
        jcsr.edge_dst,
        jcsr.n_edges,
        jcsr.n_nodes,
        out_slot=jcsr.out_slot,
    )
    maps = jasrc.build_epilogue_maps(runner.bg, out)
    dests = CASES[name]
    bitmap = None
    if name in LAX_CASES:
        counters: dict = {}
        d, bitmap, ok = jasrc.reduced_all_sources(
            np.asarray(dests, dtype=np.int32),
            runner,
            out,
            jcsr.edge_metric,
            jcsr.edge_up,
            jcsr.node_overloaded,
            maps=maps,
            pallas_run=lambda kind, pt, xt: pk.run_with_fallback(
                kind, pt, xt, counters=counters, mode="off"
            ),
        )
        assert ok and counters == {"device.engine.pallas_skips": 1}
        d = np.asarray(jax.device_get(d))
        bitmap = np.asarray(jax.device_get(bitmap))
    else:
        d = _dijkstra_product(name, jcsr, dests, small)
    assert d.dtype == (np.uint16 if small else np.int32)

    prunner = _reverse_runner(csr)
    pout = asrc.build_out_ell(
        csr.edge_src, csr.edge_dst, csr.n_edges, csr.n_nodes, csr.out_slot
    )
    groups = _port_groups(prunner, asrc.build_epilogue_maps(prunner.bg, pout))
    return {
        "name": name,
        "d": d,
        "d32": np.array(_row_i32(d)[: csr.n_nodes]),
        "bitmap_lax": bitmap,
        "runner": runner,
        "out": out,
        "maps": maps,
        "groups": groups,
        "n_words": pout.n_words,
    }


def test_reference_matches_pallas_interpret_and_lax(reference):
    jp = reference
    bitmap_pallas, ok_pallas = _jax_epilogue_pallas(jp, jp["d"])
    assert ok_pallas
    if jp["bitmap_lax"] is not None:
        assert np.array_equal(bitmap_pallas, jp["bitmap_lax"])

    d32 = torch.from_numpy(jp["d32"])
    bitmap, ok = ep.fused_epilogue_reference(d32, *jp["groups"], jp["n_words"])
    assert bool(ok)
    assert bitmap.dtype == torch.int32
    assert np.array_equal(bitmap.numpy().view(np.uint32), bitmap_pallas)
    if jp["name"] == "hub_w2":
        assert jp["n_words"] == 2 and bitmap_pallas[..., 1].any()
    # the public wrapper runs the same plain version for CPU tensors
    bitmap2, ok2 = ep.fused_epilogue(d32, *jp["groups"], jp["n_words"])
    assert bool(ok2) and torch.equal(bitmap, bitmap2)


def test_non_converged_product_fails_both_verdicts(reference):
    jp = reference
    groups = jp["groups"]
    idx, w, ov, _ = (g.numpy() for g in groups)
    broken = break_fixed_point(jp["d32"], idx, w, ov, INF32, WBIG)
    bitmap, ok = ep.fused_epilogue_reference(
        torch.from_numpy(broken), *groups, jp["n_words"]
    )
    assert not bool(ok)

    # the same entry lowered in the reference's own distance domain
    jd = jp["d"].copy()
    jd[tuple(np.argwhere(broken != jp["d32"])[0])] -= 1
    jbitmap, jok = _jax_epilogue_pallas(jp, jd)
    assert not jok
    assert np.array_equal(bitmap.numpy().view(np.uint32), jbitmap)


def test_distance_constants_match_reference():
    from openr_tpu.ops import banded as jbanded
    from openr_tpu.ops import sssp as jsssp

    assert INF32 == int(jsssp.INF32) == pk._INF32
    assert WBIG == int(jbanded.WBIG) == pk._WBIG32
    assert INF16 == int(jsssp.INF16) == pk._INF16
    assert WBIG16 == int(jsssp.WBIG16) == pk._WBIG16


def test_cuda_request_without_cuda_raises(monkeypatch):
    """On a host without CUDA every entry point refuses a CUDA request
    (explicit or by default) instead of computing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SpfSolver("r0")
    ls, _ = link_states(FAMILIES["ring65"]())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FleetViewCache().view(ls, ["r0"])
    assert DeviceResidencyEngine("cpu").device.type == "cpu"


def test_wrapper_refuses_non_cuda_accelerator_tensors():
    d = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    t = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ep.fused_epilogue(d, t, t, t, t, 1)


@pytest.mark.cuda
def test_kernel_matches_reference_on_card():
    """The CUDA kernel against the plain version on the card, bit for
    bit (runs with `-m cuda` on a machine with an sm_90 card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    csr, _ = mirrors(FAMILIES["hub_w2"]())
    runner = _reverse_runner(csr)
    out = asrc.build_out_ell(
        csr.edge_src, csr.edge_dst, csr.n_edges, csr.n_nodes, csr.out_slot
    )
    maps = asrc.build_epilogue_maps(runner.bg, out)
    runner.stage(torch.device("cuda"))
    dist, _, ok = asrc.reduced_all_sources(
        CASES["hub_w2"], runner, out, maps=maps,
        epilogue=ep.fused_epilogue_reference,
    )
    assert ok
    groups = tuple(g.cuda() for g in _port_groups(runner, maps, "cuda"))
    want = ep.fused_epilogue_reference(dist, *groups, out.n_words)
    got = ep.fused_epilogue(dist, *groups, out.n_words)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and bool(got[1]) and bool(want[1])
