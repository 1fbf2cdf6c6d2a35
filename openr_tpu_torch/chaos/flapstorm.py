"""Seeded flap-storm scenario for the incremental delta SPF rung.

Port of `openr_tpu.chaos.flapstorm`, over the port's
`FleetViewCache(delta=True)` on a `DeviceResidencyEngine` of `device`
(the CUDA card when None).  The same seed replays the same 1k-event
sequence and the same scenario log as the reference's.

A FlapStormScenario replays a deterministic 1k-event link-flap sequence
(metric worsen/restore + adjacency down/up on a small set of flappy
links) against an engine-backed FleetViewCache(delta=True), coalescing
each chunk of pending events into ONE delta rebuild.  The storm proves
the tentpole's serving claims end to end:

- every event is recorded in the ChaosEventLog scenario stream, so two
  runs from the same seed replay bit-for-bit (ChaosEventLog.matches);
- the post-storm product must be bit-exact against a cold host-oracle
  rebuild of the final snapshot (a fresh, engine-less FleetViewCache);
- the engine's ``full_restages`` must stay at 1 — the initial upload —
  because every chunk lands through the donated delta programs.

The topology is WAN-shaped on purpose: a ring with +-1/+-2 local links
plus +-16 chord bands, under deterministic per-direction ASYMMETRIC
metrics (hashed, stable across rebuilds).  Heterogeneous metrics kill
the ECMP permutation ties of a uniform ring — with unique path costs
each link is tight toward a bounded set of destinations instead of
half of everything.  The labeled destinations form a CLUSTER on the
arc of the ring opposite the flappy links: traffic toward the cluster
funnels through the chord bands, so the flapped local links carry
almost none of it and the support-loss frontier of a whole chunk of
coalesced events stays far below the bucket-ladder overflow bound —
exactly the regime the delta rung is built for.  Storms that flap
links serving a large destination share (uniform metrics, or labels
spread across the whole ring) genuinely change a large fraction of the
columns; those overflow the frontier bound and take the bit-exact
full-product fallback instead — that path is covered by
tests/test_delta.py.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Optional

from ..decision.fleet import FleetViewCache, fleet_destinations
from ..decision.link_state import LinkState
from ..decision.prefix_state import PrefixState
from ..device.engine import DeviceResidencyEngine
from ..types import Adjacency, AdjacencyDatabase, PrefixEntry
from .chaos import SCENARIO_STREAM, ChaosEventLog

_WORSE_METRIC = 90
_KINDS = ("worsen", "restore", "down", "up")
_OFFSETS = (1, -1, 2, -2, 16, -16)


def _host(t) -> "np.ndarray":
    """A host array of a device tensor, compared through the int16 view
    when uint16 (no `.cpu()` of a CUDA uint16 tensor is relied on)."""
    import torch

    if t.dtype == torch.uint16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def _base_metric(i: int, j: int) -> int:
    """Deterministic per-direction metric in 1..10 — WAN-style
    heterogeneous weights, stable across scenario and oracle builds."""
    return 1 + (i * 2654435761 + j * 40503) % 10


def _adj(me: str, other: str, metric: int) -> Adjacency:
    return Adjacency(
        other_node_name=other,
        if_name=f"{me}/{other}",
        other_if_name=f"{other}/{me}",
        metric=metric,
        next_hop_v6=f"fe80::{other}",
        next_hop_v4=f"10.0.0.1",
    )


@dataclass
class FlapStormResult:
    events: int
    chunks: int
    delta_updates: int
    delta_noops: int
    delta_fallbacks: int
    delta_dispatches: int
    full_restages: int
    bit_exact: bool
    chunk_modes: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)


class FlapStormScenario:
    """Replayable flap storm over a labeled ring through the delta rung."""

    def __init__(
        self,
        seed: int = 0,
        n: int = 128,
        flappy_links: int = 4,
        events: int = 1000,
        chunks: int = 4,
        log_: Optional[ChaosEventLog] = None,
        device=None,
    ) -> None:
        assert events % chunks == 0
        self.device = device
        self.seed = seed
        self.n = n
        self.events = events
        self.chunks = chunks
        self.log = log_ if log_ is not None else ChaosEventLog()
        # fixed flappy set: the +1 out-edge of `flappy_links` adjacent
        # even nodes — clustered so the event frontiers overlap, and on
        # the arc opposite the labeled destination cluster so the
        # flapped links carry almost no destination-bound traffic
        self.flappy = tuple(2 * i for i in range(flappy_links))
        # labeled destination cluster: the far arc [n/2, n - n/8)
        self.label_lo = n // 2
        self.label_hi = n - n // 8

    # -- topology ------------------------------------------------------------

    def _name(self, i: int) -> str:
        return f"c{i % self.n:03d}"

    def _node_db(self, i: int, state: dict) -> AdjacencyDatabase:
        me = self._name(i)
        st = state.get(i, {"metric": None, "up": True})
        adjs = []
        for d in _OFFSETS:
            j = (i + d) % self.n
            metric = _base_metric(i, j)
            if d == 1 and i in state:
                if not st["up"]:
                    continue
                if st["metric"] is not None:
                    metric = st["metric"]
            adjs.append(_adj(me, self._name(i + d), metric))
        labeled = self.label_lo <= (i % self.n) < self.label_hi
        return AdjacencyDatabase(
            this_node_name=me,
            adjacencies=adjs,
            is_overloaded=False,
            node_label=1000 + i if labeled else 0,
            area="0",
        )

    def _build_ls(self, state: dict) -> LinkState:
        ls = LinkState("0")
        for i in range(self.n):
            ls.update_adjacency_database(self._node_db(i, state))
        return ls

    def _prefix_state(self) -> PrefixState:
        ps = PrefixState()
        ps.update_prefix(
            self._name(self.label_lo), "0", PrefixEntry(prefix="::1:0/112")
        )
        ps.update_prefix(
            self._name(self.label_hi - 1),
            "0",
            PrefixEntry(prefix="::2:0/112"),
        )
        return ps

    # -- storm ---------------------------------------------------------------

    def run(self) -> FlapStormResult:
        rng = random.Random(self.seed)
        counters: dict[str, int] = {}

        def bump(name: str, delta: int = 1) -> None:
            counters[name] = counters.get(name, 0) + delta

        state: dict[int, dict] = {}
        ls = self._build_ls(state)
        ps = self._prefix_state()
        dests = fleet_destinations(ls, ps)
        engine = DeviceResidencyEngine(self.device)
        cache = FleetViewCache(delta=True, bump=bump)

        self.log.append(SCENARIO_STREAM, f"storm:init:n={self.n}")
        view = cache.view(ls, dests, engine=engine)
        # account the one-and-only full upload of the resident product
        engine.delta_register(
            view._dist_dev.nbytes + view._bitmap_dev.nbytes
        )

        chunk_modes = []
        per_chunk = self.events // self.chunks
        for c in range(self.chunks):
            for _ in range(per_chunk):
                node = self.flappy[rng.randrange(len(self.flappy))]
                kind = _KINDS[rng.randrange(len(_KINDS))]
                st = state.setdefault(node, {"metric": None, "up": True})
                if kind == "worsen":
                    st["metric"] = _WORSE_METRIC
                elif kind == "restore":
                    st["metric"] = None
                elif kind == "down":
                    st["up"] = False
                else:
                    st["up"] = True
                ls.update_adjacency_database(self._node_db(node, state))
                self.log.append(SCENARIO_STREAM, f"flap:{node}:{kind}")
            # the chunk's k pending events coalesce into ONE rebuild
            view = cache.view(ls, dests, engine=engine)
            chunk_modes.append(view.warm_mode)
            self.log.append(
                SCENARIO_STREAM, f"chunk:{c}:{view.warm_mode}"
            )

        # post-storm convergence: bit-exact against a cold host-oracle
        # rebuild of the final snapshot on a fresh, engine-less cache
        import numpy as np

        oracle = FleetViewCache().view(
            self._build_ls(state), dests, device=engine.device
        )
        bit_exact = bool(
            np.array_equal(_host(view._dist_dev), _host(oracle._dist_dev))
            and np.array_equal(
                _host(view._bitmap_dev), _host(oracle._bitmap_dev)
            )
        )
        self.log.append(
            SCENARIO_STREAM,
            f"storm:settled:{'exact' if bit_exact else 'DIVERGED'}",
        )
        return FlapStormResult(
            events=self.events,
            chunks=self.chunks,
            delta_updates=counters.get("decision.delta.updates", 0),
            delta_noops=counters.get("decision.delta.noop_updates", 0),
            delta_fallbacks=counters.get("decision.delta.fallbacks", 0),
            # the port's engine keeps delta and residency keys lazily
            delta_dispatches=engine.get_counters()[
                "device.engine.delta_dispatches"
            ],
            full_restages=engine.get_counters()["device.engine.full_restages"],
            bit_exact=bit_exact,
            chunk_modes=chunk_modes,
            counters=counters,
        )
