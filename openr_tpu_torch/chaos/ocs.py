"""Seeded OCS reconfiguration chaos scenario for the rewire rung.

Port of `openr_tpu.chaos.ocs`, over the port's CsrTopology mirror and a
`DeviceResidencyEngine` of `device` (the CUDA card when None).  The same
seed replays the same swaps, flaps and scenario log as the reference's,
and the engine's counters read the same: the mid-rewire fault is the
hook's exception at `rewire`, the one fault the port's engine demotes
to a restage (`device.engine.rewire_fallbacks`).

An OcsController replays a deterministic schedule of rolling edge-set
swaps — the event stream an optical-circuit-switch fabric emits when it
reprograms its logical topology — against one persistent CsrTopology
mirror and DeviceResidencyEngine, interleaved with attribute metric
flaps and one armed mid-rewire device fault.  The scenario proves the
tentpole's robustness claims end to end:

- every action is recorded through ChaosScenario into the shared
  ChaosEventLog scenario stream, so two runs from the same seed replay
  bit-for-bit (ChaosEventLog.matches);
- every post-rewire SPF product is bit-exact against the host Dijkstra
  oracle (LinkState.run_spf), and the post-heal all-sources sweep is
  asserted the same way — the oracle cannot be perturbed by the chaos
  under test;
- bounded rewires ride the engine's masked-write rewire rung (one full
  restage for the initial upload), while the injected mid-rewire fault
  must demote cleanly to a second restage with `rewire_fallbacks`
  accounted — the degradation ladder, not an error.

The topology is WAN-shaped: a ring with +-1/+-2 local links under the
flap-storm's deterministic asymmetric metrics, plus a reprogrammable
chord matching (every node starts with exactly one chord, so every ELL
row is built with headroom for the chord churn that follows).  Chord
swaps are capacity-bounded by construction — per-node chord degree is
capped — so the schedule never trips the rebuild fallback except where
the scenario injects one on purpose.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Optional

from ..decision.csr import CsrTopology
from ..decision.link_state import LinkState
from ..device.engine import DeviceResidencyEngine
from ..types import AdjacencyDatabase
from .chaos import ChaosEventLog
from .flapstorm import _adj, _base_metric
from .scenario import ChaosScenario

_RING_OFFSETS = (1, -1, 2, -2)
_WORSE_METRIC = 70
# per-node chord-degree cap: ring in-degree 4 + 1 build-time chord puts
# every ELL row in the K=8 bucket, so up to 4 chords per node re-encode
# in place; the cap stays one under that for slack
_CHORD_DEG_CAP = 3


@dataclass
class OcsRewireResult:
    rounds: int
    rewires: int  # deltas applied on device
    rewire_dispatches: int
    rewire_fallbacks: int
    full_restages: int
    flaps: int
    links_swapped: int
    bit_exact: bool  # every round AND the post-heal sweep
    round_exact: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)


class OcsController:
    """Replayable rolling-rewire schedule over a chorded WAN ring."""

    def __init__(
        self,
        seed: int = 0,
        n: int = 32,
        rounds: int = 12,
        swaps_per_round: int = 2,
        flaps_per_round: int = 2,
        fault_round: Optional[int] = None,
        log_: Optional[ChaosEventLog] = None,
        device=None,
    ) -> None:
        self.seed = seed
        self.device = device
        self.n = n
        self.rounds = rounds
        self.swaps_per_round = swaps_per_round
        self.flaps_per_round = flaps_per_round
        # arm the mid-rewire device fault at this round (-1: never;
        # None: mid-schedule, so healthy rewires surround the demotion)
        self.fault_round = (
            fault_round if fault_round is not None else rounds // 2
        )
        self.log = log_ if log_ is not None else ChaosEventLog()
        self.scenario = ChaosScenario(self.log)

    # -- topology ------------------------------------------------------------

    def _name(self, i: int) -> str:
        return f"w{i % self.n:03d}"

    def _chord_metric(self, i: int, j: int) -> int:
        return 3 + (i * 40503 + j * 2654435761) % 7

    def _node_db(
        self, i: int, chords: set, flapped: dict
    ) -> AdjacencyDatabase:
        me = self._name(i)
        adjs = []
        for d in _RING_OFFSETS:
            j = (i + d) % self.n
            metric = _base_metric(i, j)
            if d == 1 and i in flapped:
                metric = flapped[i]
            adjs.append(_adj(me, self._name(j), metric))
        for a, b in sorted(chords):
            if i == a or i == b:
                j = b if i == a else a
                adjs.append(
                    _adj(me, self._name(j), self._chord_metric(a, b))
                )
        return AdjacencyDatabase(
            this_node_name=me,
            adjacencies=adjs,
            is_overloaded=False,
            node_label=0,
            area="0",
        )

    def _initial_chords(self) -> set:
        # perfect matching i <-> i + n/2: one chord per node
        return {(i, i + self.n // 2) for i in range(self.n // 2)}

    def _push(self, ls: LinkState, chords: set, flapped: dict) -> None:
        for i in range(self.n):
            ls.update_adjacency_database(self._node_db(i, chords, flapped))

    def _build_ls(self, chords: set, flapped: dict) -> LinkState:
        ls = LinkState("0")
        self._push(ls, chords, flapped)
        return ls

    def _chord_candidates(self, chords: set) -> list:
        deg: dict[int, int] = {}
        for a, b in chords:
            deg[a] = deg.get(a, 0) + 1
            deg[b] = deg.get(b, 0) + 1
        out = []
        for a in range(self.n):
            for b in range(a + 2, self.n):
                if (a, b) in chords or (a == 0 and b == self.n - 1):
                    continue  # existing chord / ring edge
                if b - a in (1, 2) or self.n - (b - a) in (1, 2):
                    continue  # ring +-1/+-2 edge
                if (
                    deg.get(a, 0) >= _CHORD_DEG_CAP
                    or deg.get(b, 0) >= _CHORD_DEG_CAP
                ):
                    continue
                out.append((a, b))
        return out

    # -- schedule ------------------------------------------------------------

    def run(self) -> OcsRewireResult:
        rng = random.Random(self.seed)
        sc = self.scenario
        chords = self._initial_chords()
        flapped: dict[int, int] = {}

        ls = self._build_ls(chords, flapped)
        sc.step(f"ocs:init:n={self.n}:chords={len(chords)}")
        csr = CsrTopology.from_link_state(ls)
        engine = DeviceResidencyEngine(self.device)
        names = ls.node_names

        fault = {"armed": False, "fired": 0}

        def fault_hook(op: str) -> None:
            if op == "rewire" and fault["armed"]:
                fault["armed"] = False
                fault["fired"] += 1
                raise RuntimeError("ocs: injected mid-rewire device fault")

        engine.fault_hook = fault_hook

        def query_exact(round_no: int) -> bool:
            sources = [
                names[(round_no * 7 + k) % self.n] for k in range(3)
            ]
            got = engine.spf_results(csr, sources)
            for s in sources:
                oracle = ls.run_spf(s)
                res = got[s]
                if {k: v.metric for k, v in oracle.items()} != {
                    k: v.metric for k, v in res.items()
                }:
                    return False
                for node in oracle:
                    if oracle[node].next_hops != res[node].next_hops:
                        return False
            return True

        # first contact: the one legitimate full staging
        round_exact = [query_exact(0)]
        links_swapped = flaps = 0

        for r in range(self.rounds):
            # rolling swaps: retire + program `swaps_per_round` circuits
            for _ in range(self.swaps_per_round):
                victim = rng.choice(sorted(chords))
                chords.discard(victim)
                fresh = rng.choice(self._chord_candidates(chords))
                chords.add(fresh)
                links_swapped += 1
                sc.step(
                    f"ocs:swap:{r}:{victim[0]}-{victim[1]}"
                    f"->{fresh[0]}-{fresh[1]}"
                )
            # interleaved attribute flaps on ring +1 links
            for _ in range(self.flaps_per_round):
                node = rng.randrange(self.n)
                if node in flapped:
                    del flapped[node]
                    sc.step(f"ocs:flap:{r}:{node}:restore")
                else:
                    flapped[node] = _WORSE_METRIC
                    sc.step(f"ocs:flap:{r}:{node}:worsen")
                flaps += 1
            if r == self.fault_round:
                fault["armed"] = True
                sc.step(f"ocs:fault:armed:{r}")
            self._push(ls, chords, flapped)
            rewired = csr.refresh(ls)
            sc.step(f"ocs:refresh:{r}:{'rewire' if rewired else 'rebuild'}")
            round_exact.append(query_exact(r + 1))
            if fault["fired"] and not fault["armed"]:
                # observable demotion: log once, the round after firing
                sc.step(f"ocs:fault:fired:{r}")
                fault["fired"] = 0

        # heal: restore every flapped metric, keep the final chord set
        sc.step(f"ocs:heal:restore_flaps:{len(flapped)}")
        flapped.clear()
        self._push(ls, chords, flapped)
        csr.refresh(ls)

        # post-heal convergence: every source bit-exact vs the oracle
        heal_exact = True
        got = engine.spf_results(csr, names)
        for s in names:
            oracle = ls.run_spf(s)
            res = got[s]
            if {k: v.metric for k, v in oracle.items()} != {
                k: v.metric for k, v in res.items()
            }:
                heal_exact = False
                break
            for node in oracle:
                if oracle[node].next_hops != res[node].next_hops:
                    heal_exact = False
                    break
        round_exact.append(heal_exact)
        bit_exact = all(round_exact)
        sc.step(
            f"ocs:settled:{'exact' if bit_exact else 'DIVERGED'}"
        )

        c = engine.get_counters()
        return OcsRewireResult(
            rounds=self.rounds,
            rewires=c["device.engine.rewires"],
            rewire_dispatches=c["device.engine.rewire_dispatches"],
            rewire_fallbacks=c["device.engine.rewire_fallbacks"],
            full_restages=c["device.engine.full_restages"],
            flaps=flaps,
            links_swapped=links_swapped,
            bit_exact=bit_exact,
            round_exact=round_exact,
            counters=c,
        )
