"""Smoothed float32 fleet product and traffic load model (the TE forward
pass), with its gradient through torch.autograd.

Port of `openr_tpu.te.soft`: the reference's three jit roots become
plain functions on tensors, `lax.scan` a Python loop and
`jax.value_and_grad` `torch.autograd.grad`.  Nothing downstream of them
(candidate acceptance, publication) reads their output: that goes
through the exact solver in te.exact.

- `soft_sssp`: temperature-annealed softmin relaxation of the reverse
  all-sources product: dist[v, p] smoothly approximates the exact
  min-plus distance v -> dest p and converges to it as tau -> 0
  (softmin <= min <= softmin + tau * log(#paths)).  Same orientation
  and drain rule as ops.allsources: an overloaded node relays nothing
  but remains a valid endpoint (its own distance-0 row).
- `soft_objective_value`: the load model and objective, forward only.
- `te_descent_step`: one projected-Adam step: the objective and its
  gradient w.r.t. the metric vector, the moment updates, and the
  projection onto the [lo, hi] box.

Load model: demand[n, p] (traffic from node n to destination p) splits
at every hop over soft-ECMP gate weights
``w(e) = exp(-(metric(e) + dist(v,p) - dist(u,p)) / tau)`` (normalized
per source node), propagated a fixed number of hop sweeps; per-link
utilization is the dest-summed load over capacity, and the objective is
the log-sum-exp softmax of utilization over links.

Numerical discipline, as the reference's: every softmin is shifted by a
detached exact minimum (`scatter_reduce(..., "amin")` on a detached
input stands for the stop-gradient `segment_min`), so its log-sum-exp
argument always holds a term with exponent 0; the safe log is a double
`where`; clipping is `minimum(maximum(x, lo), hi)`, which splits the
gradient at a tie as `jnp.clip` does (`torch.clamp` would pass all of
it).  `segment_sum` is `index_add`, whose summation order differs from
XLA's on the CPU and which uses float atomics on CUDA.
"""

from __future__ import annotations

import functools

import torch

# float INF sentinel: far above any reachable distance (metrics are
# bounded by the integer box, paths by the sweep count) yet small enough
# that INF / tau never overflows exp's argument range in float32
INF_F = 1.0e7

# Adam moments (the reference's constants)
_ADAM_B1 = 0.9
_ADAM_B2 = 0.999
_ADAM_EPS = 1e-8
_TINY = 1e-20


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-dim tensor of `x` on `like`'s device."""
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


@functools.lru_cache(maxsize=None)
def _const(value: float, device: torch.device) -> torch.Tensor:
    """A float32 0-dim constant on `device`, made once (each sweep reads
    the clip bounds; a fresh tensor would be a host-to-device copy)."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def _clip(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """jnp.clip's value and gradient (0.5 to each side at a tie)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _segment_sum(values: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    return values.new_zeros((n,) + values.shape[1:]).index_add(0, ids, values)


def _set_dests_zero(dist: torch.Tensor, dest_ids: torch.Tensor) -> torch.Tensor:
    cols = torch.arange(dest_ids.shape[0], device=dist.device)
    return dist.index_put((dest_ids, cols), dist.new_zeros(()))


def _softmin_sweep(dist, edge_src, edge_dst, metric_f, edge_up,
                   node_overloaded, dest_ids, tau):
    """One softmin relaxation sweep of dist [N_cap, P] (float32)."""
    n_cap = dist.shape[0]
    dv = dist.index_select(0, edge_dst)  # [E, P]
    # drain rule: an overloaded node is excluded as a relay unless it is
    # the destination itself (its distance-0 row); metrics are >= 1 so
    # the 0.5 threshold is exact even under softmin erosion
    drained = node_overloaded[edge_dst][:, None] & (dv > 0.5)
    ok = edge_up[:, None] & ~drained
    cand = torch.where(ok, metric_f[:, None] + dv, INF_F)
    # pure Bellman relaxation over u's out-edges only (folding the
    # previous dist in would erode every distance by tau*log(2) a sweep);
    # the shift is a stop-gradient, and an empty segment keeps +inf as
    # jax.ops.segment_min's does
    idx = edge_src[:, None].expand_as(cand)
    shift = torch.full_like(dist, float("inf")).scatter_reduce(
        0, idx, cand.detach(), "amin", include_self=False
    )
    contrib = torch.exp((shift.index_select(0, edge_src) - cand) / tau)
    seg_sum = _segment_sum(contrib, edge_src, n_cap)
    # no usable out-edge -> stay unreachable; the safe-log double where
    # keeps NaN out of the backward pass
    reach = seg_sum > 0.0
    safe = torch.where(reach, seg_sum, 1.0)
    new = torch.where(reach, shift - tau * torch.log(safe), INF_F)
    new = _clip(new, _const(0.0, dist.device), _const(INF_F, dist.device))
    return _set_dests_zero(new, dest_ids)


def _soft_sssp(edge_src, edge_dst, metric_f, edge_up, node_overloaded,
               dest_ids, tau, n_sweeps, n_cap):
    p_dim = dest_ids.shape[0]
    dist = torch.full(
        (n_cap, p_dim), INF_F, dtype=torch.float32, device=metric_f.device
    )
    dist = _set_dests_zero(dist, dest_ids)
    for _ in range(n_sweeps):
        dist = _softmin_sweep(dist, edge_src, edge_dst, metric_f, edge_up,
                              node_overloaded, dest_ids, tau)
    return dist


def soft_sssp(edge_src, edge_dst, metric_f, edge_up, node_overloaded,
              dest_ids, tau, *, n_sweeps):
    """dist [N_cap, P] float32: softmin distances to each destination
    column at temperature `tau`.  Index tensors are int64 (or are
    widened here); every tensor lies on one device."""
    return _soft_sssp(
        edge_src.long(), edge_dst.long(), metric_f, edge_up,
        node_overloaded, dest_ids.long(), _f32(tau, metric_f), n_sweeps,
        node_overloaded.shape[0],
    )


def _soft_loads(dist, edge_src, edge_dst, metric_f, edge_up,
                node_overloaded, demand, tau, flow_sweeps):
    """Per-edge dest-summed load [E_cap] from soft-ECMP demand splits."""
    n_cap = dist.shape[0]
    du = dist.index_select(0, edge_src)  # [E, P]
    dv = dist.index_select(0, edge_dst)
    drained = node_overloaded[edge_dst][:, None] & (dv > 0.5)
    # a destination forwards nothing (du ~ 0) and an unreachable source
    # carries nothing; both gates keep the normalizer honest
    fwd = edge_up[:, None] & ~drained & (du > 0.5) & (du < INF_F * 0.5)
    gap = metric_f[:, None] + dv - du
    w = torch.where(fwd, torch.exp(-gap / tau), 0.0)
    z = _segment_sum(w, edge_src, n_cap)
    wn = w / (z.index_select(0, edge_src) + _TINY)
    f, load = demand, torch.zeros_like(w)
    for _ in range(flow_sweeps):
        fe = f.index_select(0, edge_src) * wn  # [E, P] flow over each edge
        f, load = _segment_sum(fe, edge_dst, n_cap), load + fe
    return torch.sum(load, dim=1)


def _objective(metric_f, edge_src, edge_dst, edge_up, node_overloaded,
               dest_ids, demand, capacity, tau, tau_obj, n_sweeps,
               flow_sweeps):
    """Soft max-utilization: log-sum-exp over per-link utilization."""
    dist = _soft_sssp(
        edge_src, edge_dst, metric_f, edge_up, node_overloaded, dest_ids,
        tau, n_sweeps, node_overloaded.shape[0],
    )
    load = _soft_loads(
        dist, edge_src, edge_dst, metric_f, edge_up, node_overloaded,
        demand, tau, flow_sweeps,
    )
    util = load / capacity
    masked = torch.where(edge_up, util, float("-inf"))
    return tau_obj * torch.logsumexp(masked / tau_obj, dim=0)


def soft_objective_value(metric_f, edge_src, edge_dst, edge_up,
                         node_overloaded, dest_ids, demand, capacity,
                         tau, tau_obj, *, n_sweeps, flow_sweeps):
    """Forward-only objective (temperature sweeps, diagnostics)."""
    with torch.no_grad():
        return _objective(
            metric_f, edge_src.long(), edge_dst.long(), edge_up,
            node_overloaded, dest_ids.long(), demand, capacity,
            _f32(tau, metric_f), _f32(tau_obj, metric_f), n_sweeps,
            flow_sweeps,
        )


def te_descent_step(metric_f, adam_m, adam_v, t, edge_src, edge_dst,
                    edge_up, node_overloaded, dest_ids, demand, capacity,
                    tau, tau_obj, lr, lo, hi, *, n_sweeps, flow_sweeps,
                    return_grad=False):
    """One projected-Adam step on the metric vector.

    Returns (objective, metric', m', v'), each a float32 tensor on
    `metric_f`'s device, and the masked gradient after them when
    `return_grad`.  `t` (1-based step index) drives the bias correction;
    `tau`, `tau_obj`, `lr`, `lo` and `hi` are float32 scalars."""
    with torch.enable_grad():
        x = metric_f.detach().requires_grad_(True)
        obj = _objective(
            x, edge_src.long(), edge_dst.long(), edge_up, node_overloaded,
            dest_ids.long(), demand, capacity, _f32(tau, x),
            _f32(tau_obj, x), n_sweeps, flow_sweeps,
        )
        (grad,) = torch.autograd.grad(obj, x)
    obj = obj.detach()
    with torch.no_grad():
        zero, one = _f32(0.0, x), _f32(1.0, x)
        b1, b2 = _f32(_ADAM_B1, x), _f32(_ADAM_B2, x)
        t = _f32(t, x)
        grad = torch.where(edge_up, grad, zero)  # padding metrics stay put
        m = b1 * adam_m + (one - b1) * grad
        v = b2 * adam_v + (one - b2) * grad * grad
        mh = m / (one - torch.pow(b1, t))
        vh = v / (one - torch.pow(b2, t))
        step = _f32(lr, x) * mh / (torch.sqrt(vh) + _f32(_ADAM_EPS, x))
        new = _clip(metric_f - step, _f32(lo, x), _f32(hi, x))
    if return_grad:
        return obj, new, m, v, grad
    return obj, new, m, v
