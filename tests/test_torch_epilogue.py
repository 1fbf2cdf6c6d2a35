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
from openr_tpu.ops import sssp as jsssp
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


def _port_groups(runner, maps, n_words, device="cpu", small=False):
    runner.stage(torch.device(device))
    ops = _RelaxOps(
        runner.bg,
        runner.call_arrays(),
        0 if runner.chord_mode else runner.depth,
        runner.resid_rounds,
        runner.chord_mode,
        small,
    )
    return ep.build_epilogue_groups(
        ops,
        torch.from_numpy(maps.resid_slot).to(device),
        torch.from_numpy(maps.band_slot).to(device),
        n_words,
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
    groups = _port_groups(
        prunner, asrc.build_epilogue_maps(prunner.bg, pout), pout.n_words
    )
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


# the hub's product in both variants, and random uint16 tables at the P the
# kernel's paths split on (as RANDOM_CASES), each converged, with one
# tight entry lowered and with saturated entries
CARD_CASES = [
    pytest.param(small, None, 0, id="uint16" if small else "int32")
    for small in (True, False)
] + [
    pytest.param(True, p, n_words, id=f"uint16-p{p}-w{n_words}")
    for p in (1, 3, 4, 8, 33, 64, 65, 256)
    for n_words in (1, 2)
]


@pytest.mark.cuda
@pytest.mark.parametrize("small, p, n_words", CARD_CASES)
def test_kernel_matches_reference_on_card(small, p, n_words):
    """The CUDA kernel against the plain version on the card, bit for
    bit, in both variants (runs with `-m cuda` on a machine with an sm_90
    card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if p is not None:
        n = 1031
        d, idx, w, ov, slot = _random_tables(
            n, p, n_words, 4, (1, 2, 8, 9, 515, n - 1, n - 9), seed=p, small=True
        )
        d = _relaxed(d, idx, w, ov, small=True)
        products = [d, break_fixed_point(d, idx, w, ov, INF16, WBIG16), _saturated(d, p)]
        groups = tuple(torch.from_numpy(a).cuda() for a in (idx, w, ov, slot))
        for k, dd in enumerate(products):
            dist = torch.from_numpy(dd.astype(np.uint16)).cuda()
            want = ep.fused_epilogue_reference(dist, *groups, n_words)
            got = ep.fused_epilogue(dist, *groups, n_words)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0])
            assert bool(got[1]) == bool(want[1]) == (k == 0)
        return
    csr, _ = mirrors(FAMILIES["hub_w2"]())
    runner = _reverse_runner(csr)
    runner.small_allowed = small
    out = asrc.build_out_ell(
        csr.edge_src, csr.edge_dst, csr.n_edges, csr.n_nodes, csr.out_slot
    )
    maps = asrc.build_epilogue_maps(runner.bg, out)
    runner.stage(torch.device("cuda"))
    dist, _, ok = asrc.reduced_all_sources(
        CASES["hub_w2"], runner, out, csr.edge_metric, csr.edge_up,
        csr.node_overloaded, maps=maps,
        epilogue=ep.fused_epilogue_reference,
    )
    assert ok and (dist.dtype == torch.uint16) == small
    groups = tuple(
        g.cuda() for g in _port_groups(runner, maps, out.n_words, "cuda", small)
    )
    want = ep.fused_epilogue_reference(dist, *groups, out.n_words)
    got = ep.fused_epilogue(dist, *groups, out.n_words)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and bool(got[1]) and bool(want[1])


# -- the kernel's tiling plan and its table contract ---------------------------

MIB = 1 << 20
WAN_BANDS = (1, 2, 99_998, 99_999)
RANDOM_BANDS = (1, 2, 8, 9, 2049, 4090, 4091, 4097, 4098)


@pytest.mark.parametrize(
    "n, p, offsets, l2, groups, slab, tile, near",
    [
        # wan100k: a 64-column slab is 25.6 MB, half of a 50 MiB L2
        (100_000, 1024, WAN_BANDS, 50 * MIB, 8, 64, 64, WAN_BANDS),
        # a smaller L2 halves the slab and doubles the tile
        (100_000, 1024, WAN_BANDS, 40 * MIB, 8, 32, 128, WAN_BANDS),
        # no slab fits: the narrowest
        (10_000_000, 1024, (), 50 * MIB, 8, 32, 128, ()),
        # narrow products take the narrowest slab that covers P
        (256, 7, (1, 2, 254, 255), 50 * MIB, 8, 32, 128, (1, 2, 254, 255)),
        (1000, 300, (), 50 * MIB, 4, 256, 16, ()),
        # offsets c and N - c on both sides of the halo
        (4099, 1001, RANDOM_BANDS, 50 * MIB, 13, 256, 16, (1, 2, 8, 4091, 4097, 4098)),
        # N below the halo: every band is a halo band
        (5, 3, (1, 2, 3, 4), 50 * MIB, 4, 32, 128, (1, 2, 3, 4)),
        # the hub's 40 groups shrink the tile to the shared-memory budget
        (64, 5, tuple(range(1, 17)), 50 * MIB, 40, 32, 32, tuple(range(1, 9))),
        # 160 groups: the smallest tile does not fit a 256-column slab
        (1000, 300, (), 50 * MIB, 160, 64, 16, ()),
    ],
)
def test_epilogue_plan(n, p, offsets, l2, groups, slab, tile, near):
    plan = ep.epilogue_plan(n, p, offsets, l2, groups)
    assert (plan.slab_cols, plan.node_tile) == (slab, tile)
    assert plan.halo == ep.HALO
    assert plan.halo_bands == near
    assert plan.far_bands == tuple(c for c in offsets if c not in near)
    assert n * slab * 4 <= l2 // 2 or slab == 32
    smem = ep.plan_smem_bytes(plan.node_tile, slab, plan.halo, groups)
    assert smem <= ep.SMEM_BUDGET


# every uint16 launch of the smoke: (N, P, G) -> (path, slab, tile) under
# a 50 MiB L2
SMOKE_U16_SHAPES = [
    # wan100k: main path, the KvStore flood slab, a mesh shard
    ((100_000, 1024, 8), ("wide", 128, 64)),
    ((100_000, 512, 8), ("wide", 128, 64)),
    ((100_000, 256, 8), ("wide", 128, 64)),
    # the OCS view, the delta slabs, the exact evaluation
    ((100_000, 64, 6), ("narrow", 64, 32)),
    ((100_000, 32, 8), ("narrow", 32, 64)),
    ((100_000, 8, 8), ("narrow", 8, 256)),
    ((100_000, 4, 8), ("narrow", 8, 256)),
    # the small banded graphs, the saturating ring's first run, the hub
    ((65, 4, 4), ("narrow", 8, 256)),
    ((256, 7, 8), ("narrow", 8, 256)),
    ((65, 3, 4), ("narrow", 8, 256)),
    ((64, 5, 40), ("narrow", 8, 256)),
    # random tables: ragged wide products, both sides of NARROW_P
    ((4099, 1001, 13), ("wide", 256, 32)),
    ((4099, 1020, 13), ("wide", 256, 32)),
    ((1031, 65, 13), ("wide", 128, 64)),
    ((777, 64, 13), ("narrow", 64, 32)),
    ((4099, 37, 13), ("narrow", 64, 32)),
    ((4099, 1, 13), ("narrow", 8, 256)),
    # 100 groups: the tile halves to the shared-memory budget
    ((1000, 4, 100), ("narrow", 8, 64)),
]


@pytest.mark.parametrize("shape, want", SMOKE_U16_SHAPES)
def test_u16_plan_paths(shape, want):
    """The uint16 plan's path and tiling at every shape the smoke
    launches: narrow up to NARROW_P columns (one slab covering P), wide
    past it (L2-sized slabs), a power-of-two tile of whole passes whose
    table entries fit the shared-memory budget."""
    n, p, g = shape
    plan = ep.epilogue_plan(n, p, (1, 2, n - 1, n - 2), 50 * MIB, g, elem_bytes=2)
    assert (plan.path, plan.slab_cols, plan.node_tile) == want
    assert plan.halo == 0 and plan.halo_bands == ()
    lanes = plan.slab_cols // ep.U16_COLS
    assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 32
    assert plan.node_tile & (plan.node_tile - 1) == 0
    if plan.path == "narrow":
        assert p <= ep.NARROW_P and plan.slab_cols >= p
        assert plan.slab_cols < 2 * max(p, ep.U16_COLS)
    else:
        assert p > ep.NARROW_P
        assert n * plan.slab_cols * 2 <= 50 * MIB // 2 or plan.slab_cols == 32
    assert ep.u16_smem_bytes(plan.node_tile, g) <= ep.U16_SMEM_BUDGET
    # a block is whole passes of its threads unless the budget cut it
    if g * ep.THREADS // lanes * ep.U16_ENTRY_BYTES <= ep.U16_SMEM_BUDGET:
        assert plan.node_tile * lanes % ep.THREADS == 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_uint16_candidates_are_carry_free(name):
    """The packed kernel adds two columns in one 32-bit word: INF16 plus
    the largest weight a slot relaxes with (WBIG16 - 1) stays below 2^16,
    and the tables a uint16 relax binding builds hold weights in
    [0, WBIG16], an empty slot exactly at WBIG16."""
    assert INF16 + WBIG16 - 1 < 1 << 16
    csr, _ = mirrors(FAMILIES[name]())
    runner = _reverse_runner(csr)
    out = asrc.build_out_ell(
        csr.edge_src, csr.edge_dst, csr.n_edges, csr.n_nodes, csr.out_slot
    )
    maps = asrc.build_epilogue_maps(runner.bg, out)
    _, w, _, _ = _port_groups(runner, maps, out.n_words, small=True)
    w = w.numpy()
    active = w < WBIG16
    assert active.any() and (w >= 0).all() and (w <= WBIG16).all()
    assert int(w[active].max()) + INF16 < 1 << 16


def _random_tables(n, p, n_words, n_resid, offsets, seed, small=False):
    """Random [G, N] group tables (bands at `offsets`, `n_resid` random
    rows; empty slots, weight 0, overloaded rows, slot -1) and a random
    product in [0, INF] with INF entries, zeros and INF columns (which
    stay INF at the fixed point), numpy int32, in the int32 domain or,
    with `small`, the uint16 one (INF16, empty slots at WBIG16)."""
    inf, wbig = (INF16, WBIG16) if small else (INF32, WBIG)
    rng = np.random.default_rng(seed)
    v = np.arange(n)
    rows = [(v - c) % n for c in offsets]
    rows += [rng.integers(0, n, n) for _ in range(n_resid)]
    g = len(rows)
    idx = np.asarray(rows).reshape(g, n)
    w = rng.integers(0, 20, (g, n))
    w[rng.random((g, n)) < 0.15] = wbig
    ov = (rng.random((g, n)) < 0.15).astype(np.int64)
    slot = rng.integers(0, 32 * n_words, (g, n))
    slot[rng.random((g, n)) < 0.1] = -1
    d = rng.integers(0, 1 << 12, (n, p))
    d[rng.random((n, p)) < 0.1] = inf
    d[rng.random((n, p)) < 0.05] = 0
    d[:, rng.choice(p, p // 10, replace=False)] = inf
    return tuple(a.astype(np.int32) for a in (d, idx, w, ov, slot))


def _relaxed(d, idx, w, ov, small=False):
    """`d` relaxed to its fixed point under the epilogue's own candidate
    rule (plain numpy) in the int32 or the uint16 (`small`) domain."""
    inf, wbig = (INF16, WBIG16) if small else (INF32, WBIG)
    d = d.copy()
    while True:
        vmin = d
        for g in range(idx.shape[0]):
            du = d[idx[g]]
            wg = w[g][:, None]
            allow = (wg < wbig) & ((ov[g] == 0)[:, None] | (du == 0)) & (du < inf)
            vmin = np.minimum(vmin, np.where(allow, du + wg, inf))
        if np.array_equal(vmin, d):
            return d
        d = vmin


def _pallas_random(d, idx, w, ov, slot, n_words):
    """The reference Pallas kernel (interpret mode) over numpy tables,
    padded as openr_tpu.ops.pallas_kernels.fused_epilogue pads them, in
    the distance domain of d's dtype; a uint16 verdict also holds the
    reference's saturation guard, which it applies beside the kernel."""
    n, p = d.shape
    g = idx.shape[0]
    small = d.dtype == np.uint16
    inf = INF16 if small else INF32
    gp, np_pad, pp = -(-g // 8) * 8, -(-n // 128) * 128, -(-p // 128) * 128

    def pad(a, fill):
        return np.pad(
            a, ((0, gp - g), (0, np_pad - n)), constant_values=fill
        )

    dpad = np.pad(d, ((0, np_pad - n), (0, pp - p)), constant_values=inf)
    bitmap, vmin = pk.fused_epilogue_pallas(
        jnp.asarray(dpad),
        jnp.asarray(pad(idx, 0)),
        jnp.asarray(pad(w, WBIG16 if small else WBIG)),
        jnp.asarray(pad(ov, 0)),
        jnp.asarray(pad(slot, -1)),
        n_groups=g,
        n_words=n_words,
        interpret=True,
    )
    bitmap = np.asarray(bitmap)[:, :n, :p].transpose(1, 2, 0)
    ok = bool(np.all(np.asarray(vmin) == dpad))
    if small:
        ok = bool(jsssp.u16_saturation_verdict(jnp.asarray(d), jnp.bool_(ok)))
    return bitmap, ok


def _saturated(d, seed):
    """A copy of the uint16-domain product `d` with about 5% of its finite
    entries moved into [WBIG16, INF16): the saturation guard must fail."""
    rng = np.random.default_rng(seed)
    out = d.copy()
    hot = (d < INF16) & (rng.random(d.shape) < 0.05)
    hot.flat[np.flatnonzero(d < INF16)[0]] = True
    out[hot] = rng.integers(WBIG16, INF16, int(hot.sum()))
    return out


# (n_words, state) of the int32 variant at P = 37, and (P, n_words) of the
# uint16 variant at the P its kernel's paths split on: the narrow path's
# 1, 3 (ragged), 4, 8, 33 and its limit 64, the wide path's 65 (ragged)
# and 256
RANDOM_CASES = [
    pytest.param(False, 37, n_words, state, id=f"{state}-{n_words}")
    for state in ("converged", "random")
    for n_words in (1, 3)
] + [
    pytest.param(True, p, n_words, "uint16", id=f"uint16-p{p}-w{n_words}")
    for p in (1, 3, 4, 8, 33, 64, 65, 256)
    for n_words in (1, 2)
]


@pytest.mark.parametrize("small, p, n_words, state", RANDOM_CASES)
def test_random_tables_match_pallas_interpret(small, p, n_words, state):
    """Random tables whose edges the CUDA kernels' tilings meet (bands
    inside and outside the halo, both wraps, empty slots, weight 0,
    overloaded rows meeting d = 0, slot -1, INF entries): the plain
    version equals the reference kernel bit for bit, verdict included.
    The uint16 cases hold the converged product, the same product with
    one tight entry lowered (a broken fixed point) and with entries in
    [WBIG16, INF16) (saturated)."""
    n = 150
    d, idx, w, ov, slot = _random_tables(
        n, p, n_words, 4, (1, 2, 8, 9, 75, n - 1, n - 9), seed=n_words + p,
        small=small,
    )
    if state != "random":
        d = _relaxed(d, idx, w, ov, small)
    inf = INF16 if small else INF32
    # a product of fewer than 10 columns has no INF column
    assert (d == 0).any() and ((d == inf).any() or p < 10)
    products = {state: d}
    if small:
        products = {
            "converged": d,
            "broken": break_fixed_point(d, idx, w, ov, INF16, WBIG16),
            "saturated": _saturated(d, seed=p),
        }
    for what, dd in products.items():
        dd = dd.astype(np.uint16 if small else np.int32)
        want_bitmap, want_ok = _pallas_random(dd, idx, w, ov, slot, n_words)
        bitmap, ok = ep.fused_epilogue_reference(
            *(torch.from_numpy(a) for a in (dd, idx, w, ov, slot)), n_words
        )
        assert bool(ok) == want_ok == (what == "converged"), what
        assert np.array_equal(bitmap.numpy().view(np.uint32), want_bitmap), what
        assert want_bitmap.any()


def test_epilogue_traffic_counts_gathers_outside_the_window():
    n, tile = 1000, 64
    plan = ep.EpiloguePlan(64, tile, ep.HALO, (), ())
    v = np.arange(n)
    idx = np.stack([(v - 1) % n, (v + ep.HALO) % n, (v + 500) % n, (v + 500) % n])
    w = np.zeros_like(idx)
    w[3] = WBIG  # an empty slot gathers nothing
    traffic = ep.epilogue_traffic(idx, w, 16, plan)
    # v + 500 is inside a window only when it wraps into the tile's halo
    r = ((v + 500) - v // tile * tile + ep.HALO) % n
    far = int((r >= tile + 2 * ep.HALO).sum())
    assert traffic == {"active_pairs": 3 * n, "gather_bytes": far * 16 * 4}


@pytest.mark.parametrize(
    "field, value",
    [("idx", -1), ("idx", 40), ("slot", 64)],
)
def test_group_range_check_raises(field, value):
    """The range check moved from the launch to table build time: an
    out-of-range gather row or out-slot is refused there."""
    n, n_words = 40, 2
    _, idx, w, ov, slot = _random_tables(n, 4, n_words, 2, (1, 2), seed=0)
    groups = {"idx": idx, "w": w, "ov": ov, "slot": slot}
    ep.check_epilogue_groups(
        tuple(torch.from_numpy(a) for a in groups.values()), n, n_words
    )
    groups[field] = groups[field].copy()
    groups[field][1, 7] = value
    with pytest.raises(ValueError, match="outside"):
        ep.check_epilogue_groups(
            tuple(torch.from_numpy(a) for a in groups.values()), n, n_words
        )


def test_build_epilogue_groups_checks_words():
    """The hub's second-word slots do not fit one bitmap word: the
    `build_epilogue_groups` refuses them."""
    csr, _ = mirrors(FAMILIES["hub_w2"]())
    runner = _reverse_runner(csr)
    out = asrc.build_out_ell(
        csr.edge_src, csr.edge_dst, csr.n_edges, csr.n_nodes, csr.out_slot
    )
    maps = asrc.build_epilogue_maps(runner.bg, out)
    assert out.n_words == 2
    _port_groups(runner, maps, 2)
    with pytest.raises(ValueError, match="bitmap words"):
        _port_groups(runner, maps, 1)


def test_fused_epilogue_makes_no_host_sync(monkeypatch):
    """The launch path reads nothing back from the device: its source
    calls no .tolist(), .item(), .cpu() or .numpy() and converts no
    tensor with bool() or int(), and the host checks run with those
    methods made to raise."""
    import ast
    import inspect
    import textwrap

    for fn in (ep.fused_epilogue, ep._check_args):
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute):
                    assert f.attr not in {"tolist", "item", "cpu", "numpy", "synchronize"}
                if isinstance(f, ast.Name):
                    assert f.id not in {"bool", "int", "float"}, fn.__name__

    def refuse(*_):
        raise AssertionError("host sync in the launch path")

    _, idx, w, ov, slot = _random_tables(40, 4, 1, 2, (1, 2), seed=1)
    d = torch.zeros((40, 4), dtype=torch.int32)
    tables = tuple(torch.from_numpy(a) for a in (idx, w, ov, slot))
    for name in ("tolist", "item", "__bool__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    ep._check_args(d, tables, 1)
