"""Batched failure-protection runs: SRLG what-if and TI-LFA backups.

Port of `openr_tpu.ops.protection`.  Both are per-row masked SPF
batches, capabilities the reference's one-source-at-a-time solver has no
counterpart for (BASELINE.json configs #4 and #5):

- `srlg_what_if`: F failure scenarios (each an edge mask, e.g. every
  member of a shared-risk link group) x S sources in one batch:
  dist [F, S, N].  `srlg_reachability_loss` counts, per scenario, the
  pairs that became unreachable and those that degraded.
- `ti_lfa_backups`: for each out-edge of a protected source, the
  distances and SP-DAG with that edge and its reverse failed — the state
  TI-LFA picks loop-free backup next hops and repair segments from.

Three paths run them: `runner` (ops.banded.SpfRunner, the bands or the
ELL at an adaptive fixed sweep count, numpy results), `ell`
(ops.sssp.spf_forward_ell_masked to the fixed point, tensors on the
ELL's device) and otherwise the dense edge-list relax, for tiny graphs,
on `device`: the CUDA card unless the caller names another device or
passes tensors, which keep theirs.  The runner path answers from the arrays the runner captured, so a call
passing other arrays is refused (`_check_runner_arrays`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device.engine import resolve_device
from ..device.sanitizer import fetch_point, stage
from .sssp import (
    INF32,
    batched_sssp,
    make_dist0,
    make_relax_allowed,
    sp_dag_mask,
    spf_forward_ell_masked,
)


def _tensors(device, *arrays):
    """Each array (numpy or tensor) as a tensor on `device`."""
    return [stage(a, device) for a in arrays]


def _device_of(ell, first, device) -> torch.device:
    """The device of a run without a runner: the ELL's; else `device`
    when given; else that of `first` when it is a tensor; else the CUDA
    card (resolve_device raises when there is none)."""
    if ell is not None:
        return ell.new_of_old.device
    if device is None and isinstance(first, torch.Tensor):
        return first.device
    return resolve_device(device)


def srlg_what_if(
    sources,  # [S] int32
    edge_src,  # [E]
    edge_dst,  # [E]
    edge_metric,  # [E]
    edge_up,  # [E] bool
    node_overloaded,  # [N] bool
    scenario_masks,  # [F, E] bool — True = the edge SURVIVES
    ell=None,  # ops.sssp.EllGraph of tensors: the masked ELL relax
    runner=None,  # ops.banded.SpfRunner (staged): the fixed-sweep runner
    device=None,  # the dense path's device (see _device_of)
):
    """Distances under each failure scenario, [F, S, N*] int32
    (reference: ops/protection.py srlg_what_if).  The (scenario x
    source) cross product is flattened onto one batch: with `runner` it
    runs without an SP-DAG and comes back as numpy; with `ell` it runs
    the masked ELL relax on the ELL's device; otherwise the dense relax
    runs one scenario at a time on `device`, by default the device of
    `sources` when it is a tensor and else the CUDA card.  Without a
    runner the inputs are numpy arrays or tensors on that device."""
    f_dim = int(np.shape(scenario_masks)[0])
    s_dim = int(np.shape(sources)[0])
    if runner is not None:
        _check_runner_arrays(
            runner, edge_src, edge_dst, edge_metric, edge_up, node_overloaded
        )
        # the runner path takes host arrays: a tensor is read here
        with fetch_point("runner inputs"):
            flat_sources = np.tile(np.asarray(sources, dtype=np.int32), f_dim)
            flat_masks = np.repeat(
                np.asarray(scenario_masks, dtype=bool), s_dim, axis=0
            )
        dist, _ = runner.forward(
            flat_sources, extra_edge_mask=flat_masks, want_dag=False
        )
        return dist.reshape(f_dim, s_dim, -1)
    device = _device_of(ell, sources, device)
    src, e_src, e_dst, metric, up, ov, masks = _tensors(
        device, sources, edge_src, edge_dst, edge_metric, edge_up,
        node_overloaded, scenario_masks,
    )
    n_nodes = int(ov.shape[0])
    if ell is not None:
        dist, _ = spf_forward_ell_masked(
            src.repeat(f_dim),
            ell,
            e_src,
            e_dst,
            metric,
            up,
            ov,
            masks.repeat_interleave(s_dim, dim=0),
            want_dag=False,
        )
        return dist.view(f_dim, s_dim, n_nodes)
    base_allowed = make_relax_allowed(src, e_src, up, ov)  # [S, E]
    return torch.stack(
        [
            batched_sssp(
                make_dist0(src, n_nodes), e_src, e_dst, metric,
                base_allowed & mask[None, :],
            )
            for mask in masks
        ]
    )


def srlg_reachability_loss(baseline_dist, scenario_dist):
    """Per scenario (#newly unreachable pairs, #degraded pairs)
    (reference: ops/protection.py srlg_reachability_loss): baseline
    [S, N] and scenario [F, S, N] distances, numpy or tensors; returns
    two int64 tensors [F]."""
    base = baseline_dist
    if not isinstance(base, torch.Tensor):
        base = stage(base, torch.device("cpu"))
    scen = stage(scenario_dist, base.device)
    was_reachable = base < INF32
    now_unreachable = was_reachable[None] & (scen >= INF32)
    degraded = was_reachable[None] & (scen < INF32) & (scen > base[None])
    return now_unreachable.sum((1, 2)), degraded.sum((1, 2))


def ti_lfa_backups(
    source,  # scalar int32 — the protected source node
    out_edge_ids: np.ndarray,  # [D] int32 — the source's out-edge ids (-1 pad)
    edge_src,
    edge_dst,
    edge_metric,
    edge_up,
    node_overloaded,
    reverse_edge_ids: np.ndarray,  # [E] int32 — id of each edge's reverse, -1 none
    max_degree: int,
    ell=None,
    runner=None,
    device=None,
):
    """Post-convergence SPF per protected out-edge (reference:
    ops/protection.py ti_lfa_backups): (dist [D, N*], dag [D, E]), row d
    the distances and SP-DAG with out_edge_ids[d] and its reverse
    removed; a -1 entry removes nothing.  With `runner` numpy comes back
    (the masks run at the runner's adaptive sweep count); with `ell`,
    tensors on the ELL's device; on the dense path, tensors on `device`,
    by default the device of `source` when it is a tensor and else the
    CUDA card.  `max_degree` is D, kept for the reference's signature."""
    del max_degree  # D is out_edge_ids' length
    d_dim = int(np.shape(out_edge_ids)[0])
    with fetch_point("source id"):
        src_id = int(source)
    if runner is not None:
        _check_runner_arrays(
            runner, edge_src, edge_dst, edge_metric, edge_up, node_overloaded
        )
        survives = build_edge_failure_masks(
            out_edge_ids, reverse_edge_ids, int(np.shape(edge_src)[0])
        )
        sources = np.full(d_dim, src_id, dtype=np.int32)
        return runner.forward(sources, extra_edge_mask=survives)
    device = _device_of(ell, source, device)
    survives = stage(
        build_edge_failure_masks(
            np.asarray(out_edge_ids), np.asarray(reverse_edge_ids),
            int(np.shape(edge_src)[0]),
        ),
        device,
    )
    e_src, e_dst, metric, up, ov = _tensors(
        device, edge_src, edge_dst, edge_metric, edge_up, node_overloaded
    )
    sources = torch.full((d_dim,), src_id, dtype=torch.int32, device=device)
    if ell is not None:
        return spf_forward_ell_masked(
            sources, ell, e_src, e_dst, metric, up, ov, survives
        )
    allowed = make_relax_allowed(sources, e_src, up, ov, survives)
    dist = batched_sssp(
        make_dist0(sources, int(ov.shape[0])), e_src, e_dst, metric, allowed
    )
    return dist, sp_dag_mask(dist, e_src, e_dst, metric, allowed)


def _check_runner_arrays(
    runner, edge_src, edge_dst, edge_metric, edge_up, node_overloaded
) -> None:
    """The runner path answers from the arrays captured in the runner:
    refuse a call that passes different ones (a modified edge_up copy,
    say), which would otherwise be ignored in silence."""
    for mine, theirs, name in zip(
        (edge_src, edge_dst, edge_metric, edge_up, node_overloaded),
        runner.arrays,
        ("edge_src", "edge_dst", "edge_metric", "edge_up", "node_overloaded"),
    ):
        a, b = np.asarray(mine), np.asarray(theirs)
        if a is not b and not (np.shares_memory(a, b) or np.array_equal(a, b)):
            raise ValueError(
                f"runner path: {name} differs from the runner's captured "
                "array; mutate the runner's arrays (or drop runner=) "
                "instead of passing a modified copy"
            )


def build_edge_failure_masks(
    out_edge_ids: np.ndarray, reverse_edge_ids: np.ndarray, edge_capacity: int
) -> np.ndarray:
    """[D, E_cap] survives-mask of per-edge failure rows: row d excludes
    out_edge_ids[d] and its reverse; a -1 entry (padding) excludes
    nothing (reference: ops/protection.py build_edge_failure_masks)."""
    fail = np.asarray(out_edge_ids)
    rev = np.asarray(reverse_edge_ids)
    fail_rev = np.where(fail >= 0, rev[np.maximum(fail, 0)], -1)
    edge_ids = np.arange(edge_capacity, dtype=np.int64)
    # a -1 entry must exclude no edge: compare against -2 sentinels
    fail_cmp = np.where(fail >= 0, fail, -2)
    rev_cmp = np.where(fail_rev >= 0, fail_rev, -2)
    return (edge_ids[None, :] != fail_cmp[:, None]) & (
        edge_ids[None, :] != rev_cmp[:, None]
    )


def build_reverse_edge_ids(edge_src: np.ndarray, edge_dst: np.ndarray) -> np.ndarray:
    """For each directed edge (u, v), the id of (v, u), -1 if absent
    (reference: ops/protection.py build_reverse_edge_ids).  Parallel
    links pair one to one: the k-th (u, v) edge, in edge-id order,
    reverses to the k-th (v, u) edge, so a failed edge pairs with its
    own link's reverse.  Vectorized: one stable sort by (u, v)."""
    src = np.asarray(edge_src, dtype=np.int64)
    dst = np.asarray(edge_dst, dtype=np.int64)
    rev = np.full(len(src), -1, dtype=np.int32)
    if not len(src):
        return rev
    m = int(max(src.max(), dst.max())) + 1
    key = src * m + dst
    order = np.argsort(key, kind="stable")
    sorted_key = key[order]
    occurrence = np.empty(len(src), dtype=np.int64)
    occurrence[order] = np.arange(len(src)) - np.searchsorted(sorted_key, sorted_key)
    rkey = dst * m + src
    lo = np.searchsorted(sorted_key, rkey, side="left")
    hi = np.searchsorted(sorted_key, rkey, side="right")
    ok = occurrence < hi - lo
    rev[ok] = order[lo[ok] + occurrence[ok]]
    return rev
