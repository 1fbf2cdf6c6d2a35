"""Coverage-guided chaos fuzzing: search the failure space, then shrink.

Port of `openr_tpu.chaos.fuzz`: the same corpus format (CORPUS_VERSION
2), event families, generators, oracles, fingerprint and shrinkers, over
the port's engine (on `device`, the CUDA card when None), serving layer,
KvStore and snapshots.  A timeline and a seed give the same events, the
same scenario log and the same fingerprint as in the reference, after
this mapping of the reference-only names:

- **The kernel fault.** An `engine:arm` of op `pallas` arms the port's
  `kernel` gate (the engine's `fault_hook("kernel")`, fired before a
  kernel wrapper is called); it is recorded as fired under `pallas`.
- **The `pallas_mode` event** sets a flag of the world, not of the
  engine.  While it is `off` (the world's default) the world's hook
  ignores `kernel`, as the reference never reaches its gate in `off`
  mode; while it is `interpret` the fault fires and propagates, and
  `_retry_injected` retries the call once (the reference demotes it to
  its XLA path instead and counts `pallas_fallbacks`).
- **The fingerprint whitelist** names the port's counters: the
  reference's `device.engine.pallas_*` keys become
  `device.engine.kernel_launches.*`, and `mesh.blocked.pipeline_fallbacks`
  has no counterpart (the port has no pipelined blocked loop).

Where the reference swallows an injected fault (its Pallas-to-XLA
demotion, its delta rung's full-product fallback), the port's engine
lets it propagate, so such a fault reaches `_retry_injected` here: the
run logs one more `fuzz:fault:fired:` step and retries.

The repo's five seeded chaos families (OCS rewires, delta-rung flap
chunks, KvStore TTL storms, replica-fleet kills/partitions, armed
`engine:*` faults) each script ONE timeline.  This module searches the
*composition space* instead: a corpus of JSON fault timelines is mutated
and crossed over across families, every run is scored by a coverage
fingerprint built from deterministic counter-state deltas and
dispatch-rung traversal (delta / fused-warm / blocked / pipelined /
pallas / rewire / restage), and an oracle bundle is evaluated after
every run.  Timelines that surface new coverage join the corpus;
timelines that violate an oracle are delta-debugged down to a minimal
reproducer and checked in under ``tests/chaos_corpus/`` as auto-collected
regression scenarios.

Determinism contract (what makes a corpus *replayable*):

- every event carries concrete parameters synthesized at mutation time
  — replay never draws from an RNG, so removing an event during
  shrinking cannot shift the interpretation of the events around it;
- events apply *tolerantly*: retiring an absent chord, healing an
  unpartitioned store, or restarting a live replica is a logged no-op,
  so any subsequence of a valid timeline is itself a valid timeline;
- the fingerprint only reads counters whose value is a pure function of
  the timeline (never wall-time `*_us` timers, never cross-run cache
  state like compiles or bucket hits, never load-dependent retry/hedge
  counts), so the same seed reproduces the identical corpus
  (`ChaosEventLog.matches` plus JSON equality, asserted in tier-1).

Oracle bundle (all crash-free failure detectors the repo already has):

- **bit_exact_spf** — engine SPF products vs the host Dijkstra oracle
  on sampled sources, mid-run and at settle;
- **view_exact** — the final fleet view vs a cold engine-less rebuild;
- **ledger_router** — the replica-router dispatch identity closes and
  submitted == replied + shed + errors (zero silent drops);
- **ledger_kv** — every TTL-storm key is accounted by the harness
  ledger and actually expires from every store;
- **restage_bound** — `full_restages` stays within the scripted budget
  (initial uploads + logged rebuilds + accounted rewire demotions);
- **races** — zero unsuppressed findings when `OPENR_TSAN=1` is armed.

CLI: ``python -m openr_tpu_torch.chaos.fuzz --fuzz-n 50 --seed 7
--budget-s 120`` to search, ``--shrink tests/chaos_corpus/entry.json`` to
reduce a failing entry, ``--device cpu`` to run on the CPU.
``OPENR_FUZZ_SEED`` seeds the run when --seed is absent.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

from ..obs import trace as _trace
from .chaos import ChaosEventLog, KvChaosInjector, wait_until
from .scenario import ChaosScenario

# v1 -> v2: the `snapshot` event family (engine snapshot take/restore +
# elastic fleet scale/kill) joined the generator; v1 entries replay
# unchanged semantically but are re-stamped so an old harness can never
# silently drop the new family's events
CORPUS_VERSION = 2
FAMILIES = ("ocs", "flap", "kv", "fleet", "engine", "snapshot")

FUZZ_COUNTER_KEYS = (
    "chaos.fuzz.runs",
    "chaos.fuzz.mutations",
    "chaos.fuzz.crossovers",
    "chaos.fuzz.novel_fingerprints",
    "chaos.fuzz.oracle_failures",
    "chaos.fuzz.shrink_steps",
)

# engine ops the `engine:arm` event may target; each armed fault fires
# exactly once at the next matching engine entry and then disarms, so a
# timeline's fault schedule is position-independent and shrink-safe
ARMABLE_OPS = (
    "sync",
    "spf",
    "rewire",
    "delta_frontier",
    "delta_relax",
    "pallas",
    "blocked_round",
    "blocked_product",
)

# world geometry: a chorded WAN ring (the OCS scenario's shape, scaled
# down for per-run cost) with a fixed far-arc destination cluster
_N = 16
_RING_OFFSETS = (1, -1, 2, -2)
_CHORD_DEG_CAP = 3
_WORSE_METRIC = 70
_DEST_IDS = tuple(range(8, 14))  # 6 labeled destinations, far arc
_FLEET_N = 10  # separate plain ring behind the replica router

# fingerprint whitelist: counters whose per-run delta is a pure function
# of the timeline.  Deliberately EXCLUDED: *_us timers (wall time),
# compiles / bucket_hits / bucket_misses / delta_bucket_* / evictions
# (cross-run cache state on the shared engine), bytes_staged (padding
# detail), and every serving.router retry/hedge count (load-dependent).
_FP_ENGINE_KEYS = (
    "device.engine.full_restages",
    "device.engine.incremental_updates",
    "device.engine.queries",
    "device.engine.rewires",
    "device.engine.rewire_dispatches",
    "device.engine.rewire_fallbacks",
    "device.engine.delta_dispatches",
    "device.engine.delta_overflow_fallbacks",
    "device.engine.epoch_invalidations",
    # the reference's device.engine.pallas_* keys: the kernel launches
    "device.engine.kernel_launches.fused_epilogue",
    "device.engine.kernel_launches.blocked_outer",
)
_FP_BLOCKED_KEYS = (
    "mesh.blocked.products",
    "mesh.blocked.rounds",
)
_FP_DELTA_KEYS = (
    "decision.delta.updates",
    "decision.delta.noop_updates",
    "decision.delta.fallbacks",
)
# snapshot family: deterministic-per-timeline counters only.  EXCLUDED:
# *_us timers, snapshot.bytes (capacity padding detail), and
# manifest_programs / prewarmed_programs (cross-run program-cache state
# on the shared engine)
_FP_SNAPSHOT_KEYS = (
    "snapshot.taken",
    "snapshot.restores",
    "snapshot.replayed_events",
    "snapshot.replay_fallbacks",
    "snapshot.scaleouts",
    "snapshot.scaleins",
)


class FuzzCounters:
    """Pre-seeded ``chaos.fuzz.*`` registry.  The module-level singleton
    below is wired as the ctrl handler's ``fuzz`` module, so the whole
    family answers one getCounters on both wire surfaces (native ctrl +
    fb303 shim) before any fuzz session ever runs."""

    def __init__(self) -> None:
        self.counters: dict[str, int] = {k: 0 for k in FUZZ_COUNTER_KEYS}

    def get_counters(self) -> dict[str, int]:
        return dict(self.counters)

    def _bump(self, name: str, delta: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + delta


FUZZ_COUNTERS = FuzzCounters()


class InjectedFault(RuntimeError):
    """Raised by the one-shot armed fault hook; the harness catches only
    this type (real failures must surface as oracle violations)."""


# -- corpus format -----------------------------------------------------------


@dataclass
class FuzzEvent:
    family: str
    kind: str
    params: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "family": self.family,
            "kind": self.kind,
            "params": dict(self.params),
        }

    @staticmethod
    def from_json(d: dict) -> "FuzzEvent":
        return FuzzEvent(
            family=str(d["family"]),
            kind=str(d["kind"]),
            params=dict(d.get("params", {})),
        )


@dataclass
class FuzzTimeline:
    """One corpus entry: a versioned, self-contained event list.  The
    seed only feeds the per-run KvChaosInjector value stream — event
    application itself never draws randomness."""

    seed: int
    events: list = field(default_factory=list)
    version: int = CORPUS_VERSION
    oracle: str = ""  # set on checked-in reproducers: the violated check
    note: str = ""

    def families(self) -> set:
        return {e.family for e in self.events}

    def to_json(self) -> dict:
        out = {
            "version": self.version,
            "seed": self.seed,
            "events": [e.to_json() for e in self.events],
        }
        if self.oracle:
            out["oracle"] = self.oracle
        if self.note:
            out["note"] = self.note
        return out

    def dumps(self) -> str:
        return json.dumps(self.to_json(), indent=2, sort_keys=True)

    @staticmethod
    def from_json(d: dict) -> "FuzzTimeline":
        version = int(d.get("version", 0))
        if version != CORPUS_VERSION:
            raise ValueError(
                f"corpus version {version} != {CORPUS_VERSION}; "
                "regenerate the entry with the current fuzzer"
            )
        return FuzzTimeline(
            seed=int(d["seed"]),
            events=[FuzzEvent.from_json(e) for e in d.get("events", [])],
            version=version,
            oracle=str(d.get("oracle", "")),
            note=str(d.get("note", "")),
        )

    @staticmethod
    def loads(text: str) -> "FuzzTimeline":
        return FuzzTimeline.from_json(json.loads(text))


# -- the shared engine -------------------------------------------------------

_ENGINES: dict = {}


def _shared_engine(device=None):
    """One DeviceResidencyEngine per device for every fuzz run in this
    process (the reference shares one for its program cache; the port
    keeps the sharing, so the counters are diffed the same way).
    Cross-run cache state (bucket hits, delta-bucket cells) is excluded
    from the fingerprint for exactly this reason."""
    from ..device.engine import DeviceResidencyEngine, resolve_device

    dev = resolve_device(device)
    engine = _ENGINES.get(dev)
    if engine is None:
        engine = _ENGINES[dev] = DeviceResidencyEngine(dev)
    return engine


# -- per-run world -----------------------------------------------------------


def _name(i: int) -> str:
    return f"z{i % _N:03d}"


def _chord_metric(i: int, j: int) -> int:
    return 3 + (i * 40503 + j * 2654435761) % 7


def _initial_chords() -> set:
    # perfect matching i <-> i + n/2: one chord per node, every ELL row
    # in the K=8 bucket with headroom for chord churn (the OCS layout)
    return {(i, i + _N // 2) for i in range(_N // 2)}


@dataclass
class FuzzRunResult:
    timeline: FuzzTimeline
    log: ChaosEventLog
    ok: bool
    failures: list = field(default_factory=list)  # violated oracle names
    fingerprint: frozenset = frozenset()
    counters: dict = field(default_factory=dict)  # per-run deltas
    applied: int = 0
    skipped: int = 0
    faults_fired: int = 0


class _FuzzWorld:
    """One timeline's blast radius: a chorded-ring LinkState truth, a
    CSR mirror on the shared residency engine, a delta-enabled fleet
    view cache, and lazily-built KvStore / replica-fleet satellites."""

    def __init__(
        self,
        timeline: FuzzTimeline,
        log_: Optional[ChaosEventLog] = None,
        plant: bool = False,
        device=None,
    ) -> None:
        from ..decision.csr import CsrTopology
        from ..decision.fleet import FleetViewCache
        from ..decision.link_state import LinkState
        from .flapstorm import _adj, _base_metric

        self._adj = _adj
        self._base_metric = _base_metric
        self.timeline = timeline
        self.plant = plant
        self.log = log_ if log_ is not None else ChaosEventLog()
        self.scenario = ChaosScenario(self.log)

        self.chords: set = _initial_chords()
        self.flapped: dict[int, int] = {}
        self.down: set = set()
        self.ls = LinkState("0")
        self._push_all()
        self.csr = CsrTopology.from_link_state(self.ls)
        self.engine = _shared_engine(device)
        self.local: dict[str, int] = {}
        self.cache = FleetViewCache(
            delta=True, bump=self._bump_local, delta_min_p=4
        )
        self.dests = [_name(i) for i in _DEST_IDS]

        # one-shot armed faults: op -> pending fire count
        self.armed: dict[str, int] = {}
        self.fired: list = []
        self.engine.fault_hook = self._fault_hook
        # the reference's Pallas policy as a flag of the world: while
        # "off", the hook ignores the engine's `kernel` gate (module doc)
        self.kernel_mode = "off"

        # scripted facts for oracles + fingerprint
        self.rebuilds = 0
        self.rewire_refreshes = 0
        self.delta_registered = 0
        self.view_modes: list = []
        self.spf_mismatches = 0
        self.blocked_failures = 0
        self.tokens: set = set()

        # snapshot satellite: the last taken engine snapshot plus the
        # scripted facts its oracles need (accounted cold demotions feed
        # the restage budget; roundtrip failures are an oracle of their
        # own)
        self.snap = None
        self.snapshot_demotes = 0
        self.snapshot_failures = 0

        # counter baselines (shared engine: everything is diffed)
        self._eng0 = self.engine.get_counters()
        self._blk0 = self.engine.blocked.get_counters()
        from ..snapshot import SNAPSHOT_COUNTERS as _snapc

        self._snapc = _snapc
        self._snap0 = _snapc.get_counters()

        # OPENR_TRACE: drain span-structure tokens accumulated by any
        # EARLIER run so this timeline's fingerprint only sees its own
        tr = _trace.TRACE
        if tr is not None:
            tr.drain_structure_tokens()

        # kv satellite (lazy)
        self.kv_fabric = None
        self.kv_stores: list = []
        self.kv_queues: list = []
        self.kv_injector: Optional[KvChaosInjector] = None
        self.kv_keys: set = set()
        self.kv_requested = 0
        self.kv_ledger = 0
        self.kv_partitioned = False

        # fleet satellite (lazy)
        self.fleet = None  # (truth, updates, handles, router, oracle)
        self.fleet_acct = {
            "submitted": 0,
            "replied": 0,
            "shed": 0,
            "errors": 0,
            "mismatches": 0,
            "unknown_epochs": 0,
        }
        self.fleet_seq = 0

    # -- plumbing -------------------------------------------------------------

    def _bump_local(self, name: str, delta: int = 1) -> None:
        self.local[name] = self.local.get(name, 0) + delta

    def _fault_hook(self, op: str) -> None:
        if op == "kernel":
            # the reference's `pallas` gate, reached only in interpret mode
            if self.kernel_mode == "off":
                return
            op = "pallas"
        pending = self.armed.get(op, 0)
        if pending > 0:
            self.armed[op] = pending - 1
            self.fired.append(op)
            gate = "kernel" if op == "pallas" else op
            raise InjectedFault(f"fuzz: injected fault at engine:{gate}")

    def _node_db(self, i: int):
        from ..types import AdjacencyDatabase

        me = _name(i)
        adjs = []
        for d in _RING_OFFSETS:
            j = (i + d) % _N
            if d == 1 and i in self.down:
                continue
            metric = self._base_metric(i, j)
            if d == 1 and i in self.flapped:
                metric = self.flapped[i]
            adjs.append(self._adj(me, _name(j), metric))
        for a, b in sorted(self.chords):
            if i == a or i == b:
                j = b if i == a else a
                adjs.append(self._adj(me, _name(j), _chord_metric(a, b)))
        return AdjacencyDatabase(
            this_node_name=me,
            adjacencies=adjs,
            is_overloaded=False,
            node_label=0,
            area="0",
        )

    def _push_all(self) -> None:
        for i in range(_N):
            self.ls.update_adjacency_database(self._node_db(i))

    def _refresh(self) -> None:
        """Push the current truth into the CSR mirror; a rebuild (new
        ELL object) is a scripted fact the restage-bound oracle budgets
        for, a rewire stays on the masked-write rung."""
        ell_before = self.csr.ell
        rewired = self.csr.refresh(self.ls)
        if self.csr.ell is not ell_before:
            self.rebuilds += 1
            self.scenario.step("fuzz:refresh:rebuild")
            self.tokens.add("refresh:rebuild")
        elif rewired:
            self.rewire_refreshes += 1
            self.scenario.step("fuzz:refresh:rewire")
            self.tokens.add("refresh:rewire")

    def _chord_ok(self, pair: tuple) -> bool:
        if len(pair) != 2:
            return False
        a, b = int(pair[0]) % _N, int(pair[1]) % _N
        if a == b:
            return False
        a, b = min(a, b), max(a, b)
        if (a, b) in self.chords:
            return False
        if (b - a) in (1, 2) or _N - (b - a) in (1, 2):
            return False  # ring edge
        deg: dict[int, int] = {}
        for x, y in self.chords:
            deg[x] = deg.get(x, 0) + 1
            deg[y] = deg.get(y, 0) + 1
        return (
            deg.get(a, 0) < _CHORD_DEG_CAP and deg.get(b, 0) < _CHORD_DEG_CAP
        )

    def _retry_injected(self, fn):
        """Run `fn`; when a one-shot armed fault escapes to here, log it
        and retry once (the fault is disarmed by firing).  Only our own
        InjectedFault is caught — real failures propagate into the run's
        failure list."""
        try:
            return fn()
        except InjectedFault as exc:
            self.scenario.step(f"fuzz:fault:fired:{exc}")
            return fn()

    def _view(self):
        self._refresh()  # one shared CSR mirror for every rung in the run
        view = self._retry_injected(
            lambda: self.cache.view(
                self.ls, self.dests, csr=self.csr, engine=self.engine
            )
        )
        if (
            view is not None
            and not self.delta_registered
            and view._dist_dev is not None
        ):
            # account the one full product upload a delta chain rides on
            self.engine.delta_register(
                view._dist_dev.nbytes + view._bitmap_dev.nbytes
            )
            self.delta_registered = 1
        if view is not None:
            self.view_modes.append(view.warm_mode)
            self.tokens.add(f"mode:{view.warm_mode}")
            if view.cold_fallback:
                self.tokens.add("mode:cold_fallback")
        return view

    def _spf_exact(self, offset: int) -> bool:
        self._refresh()
        names = self.ls.node_names
        sources = [names[(offset + 5 * k) % len(names)] for k in range(3)]

        def _q():
            return self.engine.spf_results(self.csr, sources)

        got = self._retry_injected(_q)
        for s in sources:
            oracle = self.ls.run_spf(s)
            res = got[s]
            if {k: v.metric for k, v in oracle.items()} != {
                k: v.metric for k, v in res.items()
            }:
                return False
            for node in oracle:
                if oracle[node].next_hops != res[node].next_hops:
                    return False
        return True

    # -- event appliers: ocs --------------------------------------------------

    def _ev_ocs_swap(self, p: dict) -> None:
        victim = tuple(int(x) for x in p.get("victim", ()))
        fresh = tuple(int(x) for x in p.get("fresh", ()))
        did = []
        if len(victim) == 2:
            victim = (min(victim) % _N, max(victim) % _N)
            if victim in self.chords:
                self.chords.discard(victim)
                did.append("retire")
        if len(fresh) == 2 and self._chord_ok(fresh):
            a, b = int(fresh[0]) % _N, int(fresh[1]) % _N
            self.chords.add((min(a, b), max(a, b)))
            did.append("program")
        self.scenario.step(
            f"fuzz:ocs:swap:{victim}->{fresh}:{'+'.join(did) or 'noop'}"
        )
        if did:
            self._push_all()
            self._refresh()
            self.tokens.add("ocs:swap")

    # -- event appliers: flap -------------------------------------------------

    def _flap(self, kind: str, node: int) -> None:
        node = int(node) % _N
        if kind == "worsen":
            self.flapped[node] = _WORSE_METRIC
        elif kind == "restore":
            self.flapped.pop(node, None)
        elif kind == "down":
            self.down.add(node)
        else:  # up
            self.down.discard(node)
        self.ls.update_adjacency_database(self._node_db(node))
        self.scenario.step(f"fuzz:flap:{node}:{kind}")
        self.tokens.add(f"flap:{kind}")

    def _ev_flap_worsen(self, p: dict) -> None:
        self._flap("worsen", p.get("node", 0))

    def _ev_flap_restore(self, p: dict) -> None:
        self._flap("restore", p.get("node", 0))

    def _ev_flap_down(self, p: dict) -> None:
        self._flap("down", p.get("node", 0))

    def _ev_flap_up(self, p: dict) -> None:
        self._flap("up", p.get("node", 0))

    def _ev_flap_chunk(self, p: dict) -> None:
        # the pending flap batch coalesces into ONE rebuild through the
        # cache — the delta rung when eligible, warm/cold otherwise
        view = self._view()
        mode = view.warm_mode if view is not None else None
        self.scenario.step(f"fuzz:flap:chunk:{mode}")

    # -- event appliers: kv ---------------------------------------------------

    def _ensure_kv(self) -> None:
        if self.kv_fabric is not None:
            return
        from ..kvstore import InProcessTransport, KvStore
        from ..runtime.queue import ReplicateQueue
        from ..types import PeerSpec

        self.kv_fabric = InProcessTransport()
        self.kv_injector = KvChaosInjector(
            seed=self.timeline.seed, log_=self.log
        )
        self.kv_fabric.set_chaos(self.kv_injector)
        for nm in ("fz-a", "fz-b"):
            updates: ReplicateQueue = ReplicateQueue()
            syncs: ReplicateQueue = ReplicateQueue()
            peerq: ReplicateQueue = ReplicateQueue()
            store = KvStore(
                nm,
                updates,
                syncs,
                peerq.get_reader(),
                transport=self.kv_fabric.bind(nm),
                areas=("0",),
            )
            self.kv_fabric.register(nm, store)
            store.run()
            self.kv_stores.append(store)
            self.kv_queues.append((updates, syncs, peerq))
        self.kv_stores[0].add_peers("0", {"fz-b": PeerSpec(peer_addr="fz-b")})
        self.kv_stores[1].add_peers("0", {"fz-a": PeerSpec(peer_addr="fz-a")})
        self.scenario.step("fuzz:kv:up")

    def _ev_kv_ttl_storm(self, p: dict) -> None:
        self._ensure_kv()
        n_keys = max(1, min(int(p.get("n_keys", 8)), 64))
        ttl_ms = max(60, min(int(p.get("ttl_ms", 150)), 1000))
        origin = int(p.get("origin", 0)) % len(self.kv_stores)
        keys = self.kv_injector.ttl_storm(
            self.kv_stores[origin], n_keys=n_keys, ttl_ms=ttl_ms
        )
        self.kv_requested += n_keys
        # harness expiry ledger: every planted key must be accounted.
        # `plant` is the shrinker's seeded bug — it drops one key from
        # the ledger per storm, so ledger_kv fails deterministically.
        self.kv_ledger += len(keys) - 1 if self.plant else len(keys)
        self.kv_keys.update(keys)
        self.scenario.step(f"fuzz:kv:ttl_storm:{origin}:{n_keys}:{ttl_ms}")
        self.tokens.add("kv:storm")

    def _ev_kv_partition(self, p: dict) -> None:
        self._ensure_kv()
        self.kv_fabric.set_partitioned("fz-a", "fz-b", True)
        self.kv_partitioned = True
        self.scenario.step("fuzz:kv:partition")
        self.tokens.add("kv:partition")

    def _ev_kv_heal(self, p: dict) -> None:
        if self.kv_fabric is None or not self.kv_partitioned:
            self.scenario.step("fuzz:kv:heal:noop")
            return
        self.kv_fabric.set_partitioned("fz-a", "fz-b", False)
        self.kv_partitioned = False
        self.scenario.step("fuzz:kv:heal")

    # -- event appliers: fleet ------------------------------------------------

    def _fleet_name(self, i: int) -> str:
        return f"q{i % _FLEET_N:03d}"

    def _fleet_db(self, i: int, flapped: dict):
        from ..types import AdjacencyDatabase

        me = self._fleet_name(i)
        adjs = []
        for d in _RING_OFFSETS:
            j = (i + d) % _FLEET_N
            metric = self._base_metric(i, j)
            if d == 1 and i in flapped:
                metric = flapped[i]
            adjs.append(self._adj(me, self._fleet_name(j), metric))
        return AdjacencyDatabase(
            this_node_name=me,
            adjacencies=adjs,
            is_overloaded=False,
            node_label=0,
            area="0",
        )

    def _ensure_fleet(self) -> None:
        if self.fleet is not None:
            return
        from ..decision.link_state import LinkState
        from ..decision.spf_solver import DeviceSpfBackend
        from ..serving import (
            EngineBatchBackend,
            QueryScheduler,
            ReplicaRouter,
        )
        from .replicafleet import ChaosReplicaHandle

        def build_ls() -> "LinkState":
            ls = LinkState("0")
            for i in range(_FLEET_N):
                ls.update_adjacency_database(self._fleet_db(i, {}))
            return ls

        truth = build_ls()
        handles = []
        for i in range(2):
            ls = build_ls()
            # ride the shared engine: replica SPF dispatches reuse the
            # session-wide program cache instead of recompiling per run
            backend = EngineBatchBackend(
                {"0": ls}, spf_backend=DeviceSpfBackend(engine=self.engine)
            )
            sched = QueryScheduler(backend)
            sched.run()
            handles.append(ChaosReplicaHandle(f"fz-replica-{i}", sched, ls))
        # hedging off: hedge counts are wall-time dependent and would
        # make reply routing (not correctness) vary run to run
        router = ReplicaRouter(handles, hedge_after_s=None)
        oracle: dict[int, dict] = {}
        self.fleet = {
            "truth": truth,
            "updates": [],
            "flapped": {},
            "handles": handles,
            "router": router,
            "oracle": oracle,
        }
        self._fleet_oracle()
        self.scenario.step("fuzz:fleet:up:replicas=2")

    def _fleet_oracle(self) -> None:
        f = self.fleet
        truth = f["truth"]
        epoch = int(truth.version)
        if epoch in f["oracle"]:
            return
        snap = {}
        for src in truth.node_names:
            res = truth.run_spf(src)
            snap[src] = {
                dest: (entry.metric, frozenset(entry.next_hops))
                for dest, entry in res.items()
            }
        f["oracle"][epoch] = snap

    def _fleet_catch_up(self, handle) -> None:
        f = self.fleet
        for db in f["updates"][handle.applied :]:
            handle.ls.update_adjacency_database(db)
        handle.applied = len(f["updates"])

    def _ev_fleet_kill(self, p: dict) -> None:
        self._ensure_fleet()
        h = self.fleet["handles"][int(p.get("idx", 0)) % 2]
        if h.killed:
            self.scenario.step(f"fuzz:fleet:kill:{h.name}:noop")
            return
        h.killed = True
        h.scheduler.stop()
        self.scenario.step(f"fuzz:fleet:kill:{h.name}")
        self.tokens.add("fleet:kill")

    def _ev_fleet_restart(self, p: dict) -> None:
        self._ensure_fleet()
        from ..serving import QueryScheduler

        h = self.fleet["handles"][int(p.get("idx", 0)) % 2]
        if not h.killed:
            self.scenario.step(f"fuzz:fleet:restart:{h.name}:noop")
            return
        h.scheduler = QueryScheduler(h.scheduler.backend)
        h.scheduler.run()
        self._fleet_catch_up(h)
        h.killed = False
        self.fleet["router"].probe_replicas()
        self.scenario.step(f"fuzz:fleet:restart:{h.name}")
        self.tokens.add("fleet:restart")

    def _ev_fleet_partition(self, p: dict) -> None:
        self._ensure_fleet()
        h = self.fleet["handles"][int(p.get("idx", 0)) % 2]
        if h.partitioned:
            self.scenario.step(f"fuzz:fleet:partition:{h.name}:noop")
            return
        h.partitioned = True
        self.scenario.step(f"fuzz:fleet:partition:{h.name}")
        self.tokens.add("fleet:partition")

    def _ev_fleet_heal(self, p: dict) -> None:
        self._ensure_fleet()
        h = self.fleet["handles"][int(p.get("idx", 0)) % 2]
        if not h.partitioned:
            self.scenario.step(f"fuzz:fleet:heal:{h.name}:noop")
            return
        h.partitioned = False
        self._fleet_catch_up(h)
        self.fleet["router"].probe_replicas()
        self.scenario.step(f"fuzz:fleet:heal:{h.name}")

    def _ev_fleet_flap(self, p: dict) -> None:
        self._ensure_fleet()
        f = self.fleet
        node = int(p.get("node", 0)) % _FLEET_N
        if node in f["flapped"]:
            del f["flapped"][node]
            kind = "restore"
        else:
            f["flapped"][node] = _WORSE_METRIC
            kind = "worsen"
        db = self._fleet_db(node, f["flapped"])
        f["truth"].update_adjacency_database(db)
        f["updates"].append(db)
        self._fleet_oracle()
        for h in f["handles"]:
            if not h.killed and not h.partitioned:
                self._fleet_catch_up(h)
        self.scenario.step(f"fuzz:fleet:flap:{node}:{kind}")
        self.tokens.add("fleet:flap")

    def _ev_fleet_burst(self, p: dict) -> None:
        self._ensure_fleet()
        import concurrent.futures

        from ..serving import QueryShedError

        f = self.fleet
        acct = self.fleet_acct
        q = max(1, min(int(p.get("q", 4)), 16))
        self.scenario.step(f"fuzz:fleet:burst:{q}")
        names = f["truth"].node_names
        for k in range(q):
            src = names[(self.fleet_seq + k) % len(names)]
            acct["submitted"] += 1
            fut = f["router"].submit("paths", sources=(src,))
            try:
                res = fut.result(timeout=30)
            except QueryShedError:
                acct["shed"] += 1
                continue
            except concurrent.futures.TimeoutError:
                # an unresolved future IS a silent drop: leave it
                # unaccounted so accounted == submitted fails loudly
                continue
            except Exception:  # noqa: BLE001
                acct["errors"] += 1
                continue
            acct["replied"] += 1
            snap = f["oracle"].get(int(res.epoch))
            if snap is None:
                acct["unknown_epochs"] += 1
                continue
            got = res.value.get(src)
            want = snap.get(src, {})
            got_view = (
                {}
                if got is None
                else {
                    dest: (entry.metric, frozenset(entry.next_hops))
                    for dest, entry in got.items()
                }
            )
            if got_view != want:
                acct["mismatches"] += 1
        self.fleet_seq += q
        self.tokens.add("fleet:burst")

    # -- event appliers: engine -----------------------------------------------

    def _ev_engine_arm(self, p: dict) -> None:
        op = str(p.get("op", "spf"))
        if op not in ARMABLE_OPS:
            self.scenario.step(f"fuzz:engine:arm:{op}:skip")
            return
        self.armed[op] = self.armed.get(op, 0) + 1
        self.scenario.step(f"fuzz:engine:arm:{op}")
        self.tokens.add(f"arm:{op}")

    def _ev_engine_pallas_mode(self, p: dict) -> None:
        mode = str(p.get("mode", "interpret"))
        if mode not in ("off", "interpret"):
            mode = "off"
        self.kernel_mode = mode
        self.scenario.step(f"fuzz:engine:pallas_mode:{mode}")
        self.tokens.add(f"pallas_mode:{mode}")

    def _ev_engine_spf(self, p: dict) -> None:
        exact = self._spf_exact(int(p.get("off", 0)))
        if not exact:
            self.spf_mismatches += 1
        self.scenario.step(
            f"fuzz:engine:spf:{'exact' if exact else 'DIVERGED'}"
        )
        self.tokens.add("engine:spf")

    def _ev_engine_blocked(self, p: dict) -> None:
        import numpy as np

        from ..ops import allsources as asrc

        self._refresh()
        out = asrc.build_out_ell(
            self.csr.edge_src,
            self.csr.edge_dst,
            int(self.csr.n_edges),
            int(self.csr.n_nodes),
            out_slot=getattr(self.csr, "out_slot", None),
        )
        dest_ids = np.arange(int(self.csr.n_nodes), dtype=np.int32)

        def _run():
            return self.engine.blocked.fleet_product(
                self.csr, dest_ids, out
            )

        _dist, _bitmap, ok = self._retry_injected(_run)
        if not ok:
            self.blocked_failures += 1
        self.scenario.step(
            f"fuzz:engine:blocked:{'ok' if ok else 'FAILED'}"
        )
        self.tokens.add("engine:blocked")

    # -- event appliers: snapshot ---------------------------------------------
    #
    # Engine snapshots over the world's own (engine, csr) pair plus
    # elastic membership on the fleet satellite.  Scripted step labels
    # carry only timeline-deterministic facts: the restore rung is one
    # (same world state -> same rung), but blob length and manifest size
    # depend on cross-run program-cache state and stay out of the log.

    def _ev_snapshot_take(self, p: dict) -> None:
        from ..snapshot import EngineSnapshot

        snap = self._retry_injected(
            lambda: EngineSnapshot.take(self.engine, self.csr)
        )
        blob = snap.to_bytes()
        # the wire format must roundtrip byte-identically through its
        # digest check; a planted corruption is caught by from_bytes
        try:
            if EngineSnapshot.from_bytes(blob).to_bytes() != blob:
                self.snapshot_failures += 1
        except Exception:  # noqa: BLE001 — any raise is the violation
            self.snapshot_failures += 1
        self.snap = snap
        self.scenario.step("fuzz:snapshot:take")
        self.tokens.add("snapshot:take")

    def _ev_snapshot_restore(self, p: dict) -> None:
        if self.snap is None:
            self.scenario.step("fuzz:snapshot:restore:noop")
            return
        eng0 = self.engine.get_counters()
        mode = self._retry_injected(
            lambda: self.snap.restore(self.engine, self.csr)
        )
        eng1 = self.engine.get_counters()
        # a cold demotion restages once; a rewire fallback inside the
        # replay sync is already budgeted by the rewire_falls term
        d_restage = (
            eng1["device.engine.full_restages"]
            - eng0["device.engine.full_restages"]
        )
        d_falls = (
            eng1["device.engine.rewire_fallbacks"]
            - eng0["device.engine.rewire_fallbacks"]
        )
        self.snapshot_demotes += max(0, d_restage - d_falls)
        self.scenario.step(f"fuzz:snapshot:restore:{mode}")
        self.tokens.add(f"snapshot:restore:{mode}")

    def _ev_snapshot_scale(self, p: dict) -> None:
        self._ensure_fleet()
        from ..decision.spf_solver import DeviceSpfBackend
        from ..serving import EngineBatchBackend, QueryScheduler
        from ..snapshot import EngineSnapshot
        from .replicafleet import ChaosReplicaHandle

        f = self.fleet
        handles = f["handles"]
        # bound the satellite: at most two joiners per run (a fuzzer
        # that minted a replica per event would own the wall clock)
        if len(handles) >= 4:
            self.scenario.step("fuzz:snapshot:scale:noop")
            return
        i = len(handles)
        from ..decision.link_state import LinkState

        ls = LinkState("0")
        for node in range(_FLEET_N):
            ls.update_adjacency_database(self._fleet_db(node, {}))
        backend = EngineBatchBackend(
            {"0": ls}, spf_backend=DeviceSpfBackend(engine=self.engine)
        )
        sched = QueryScheduler(backend)
        sched.run()
        handle = ChaosReplicaHandle(f"fz-replica-{i}", sched, ls)
        self._fleet_catch_up(handle)
        donor = handles[0]
        mode = "skipped"
        try:
            d_spf = donor.scheduler.backend.spf
            snap = self._retry_injected(
                lambda: EngineSnapshot.take(
                    self.engine, d_spf.csr_mirror(donor.ls)
                )
            )
            eng0 = self.engine.get_counters()
            mode = self._retry_injected(
                lambda: snap.restore(
                    self.engine, backend.spf.csr_mirror(ls)
                )
            )
            eng1 = self.engine.get_counters()
            d_restage = (
                eng1["device.engine.full_restages"]
                - eng0["device.engine.full_restages"]
            )
            d_falls = (
                eng1["device.engine.rewire_fallbacks"]
                - eng0["device.engine.rewire_fallbacks"]
            )
            self.snapshot_demotes += max(0, d_restage - d_falls)
        except Exception:  # noqa: BLE001 — warm start is best-effort
            mode = "skipped"
        handles.append(handle)
        f["router"].add_replica(handle)
        self._snapc._bump("snapshot.scaleouts")
        self.scenario.step(f"fuzz:snapshot:scale:{handle.name}:{mode}")
        self.tokens.add("snapshot:scale")

    def _ev_snapshot_kill(self, p: dict) -> None:
        f = self.fleet
        joined = (
            []
            if f is None
            else [
                h
                for h in f["handles"]
                if not h.killed and h.name >= "fz-replica-2"
            ]
        )
        if not joined:
            self.scenario.step("fuzz:snapshot:kill:noop")
            return
        handle = joined[-1]
        # leave the handle in the list (killed): the restage budget
        # counts replicas ever minted, and settle skips dead schedulers
        f["router"].remove_replica(handle.name)
        handle.killed = True
        handle.scheduler.stop()
        self._snapc._bump("snapshot.scaleins")
        self.scenario.step(f"fuzz:snapshot:kill:{handle.name}")
        self.tokens.add("snapshot:kill")

    # -- run ------------------------------------------------------------------

    def apply(self, ev: FuzzEvent) -> bool:
        fn = getattr(self, f"_ev_{ev.family}_{ev.kind}", None)
        if fn is None:
            self.scenario.step(f"fuzz:skip:{ev.family}:{ev.kind}")
            return False
        self.tokens.add(f"family:{ev.family}")
        fn(ev.params)
        return True

    def settle_and_check(self) -> list:
        """Heal, quiesce, and evaluate the oracle bundle.  Returns the
        violated oracle names (empty == the run is clean)."""
        failures = []
        sc = self.scenario

        # final SPF sweep: engine vs host Dijkstra on sampled sources
        sc.step("fuzz:settle")
        if not self._spf_exact(0) or self.spf_mismatches:
            failures.append("bit_exact_spf")

        # final view vs a cold engine-less rebuild of the same snapshot
        if self.view_modes:
            import numpy as np

            from ..decision.fleet import FleetViewCache

            from .flapstorm import _host

            view = self._view()
            cold = FleetViewCache().view(
                self.ls, self.dests, device=self.engine.device
            )
            exact = (
                view is not None
                and cold is not None
                and np.array_equal(
                    _host(view._dist_dev), _host(cold._dist_dev)
                )
                and np.array_equal(
                    _host(view._bitmap_dev), _host(cold._bitmap_dev)
                )
            )
            if not exact:
                failures.append("view_exact")

        if self.blocked_failures:
            failures.append("blocked_ok")

        # snapshot: the wire format must have roundtripped through its
        # digest check every time a take event fired
        if self.snapshot_failures:
            failures.append("snapshot_roundtrip")

        # kv: heal, then every storm key must expire from every store
        # and the harness ledger must account every planted key
        if self.kv_fabric is not None:
            if self.kv_partitioned:
                self._ev_kv_heal({})
            if self.kv_keys:
                keys = sorted(self.kv_keys)

                def _expired() -> bool:
                    for store in self.kv_stores:
                        kvs = store.get_key_vals("0", keys).key_vals
                        if kvs:
                            return False
                    return True

                if not wait_until(_expired, timeout_s=10.0):
                    failures.append("ledger_kv")
                elif self.kv_ledger != self.kv_requested:
                    failures.append("ledger_kv")
            sc.step("fuzz:kv:settled")

        # fleet: stop BEFORE reading the ledger (scheduler stop joins
        # the executors, so every router callback has finished), then
        # the dispatch identity must close with zero silent drops
        if self.fleet is not None:
            from ..serving.router import dispatch_ledger_closes

            f = self.fleet
            f["router"].stop()
            for h in f["handles"]:
                if not h.killed:
                    h.scheduler.stop()
            acct = self.fleet_acct
            counters = f["router"].get_counters()
            accounted = acct["replied"] + acct["shed"] + acct["errors"]
            if accounted != acct["submitted"]:
                failures.append("silent_drops")
            if not dispatch_ledger_closes(counters, acct["submitted"]):
                failures.append("ledger_router")
            if acct["mismatches"] or acct["unknown_epochs"]:
                failures.append("bit_exact_fleet")
            sc.step("fuzz:fleet:settled")

        # restage bound: the initial csr upload + the delta baseline +
        # every logged rebuild + every accounted rewire demotion — and
        # nothing else.  Runaway restaging is the regression this guards.
        eng = self.engine.get_counters()
        restages = (
            eng["device.engine.full_restages"]
            - self._eng0["device.engine.full_restages"]
        )
        rewire_falls = (
            eng["device.engine.rewire_fallbacks"]
            - self._eng0["device.engine.rewire_fallbacks"]
        )
        budget = (
            1
            + self.delta_registered
            + self.rebuilds
            + rewire_falls
            # every accounted snapshot demotion is a scripted cold build
            + self.snapshot_demotes
        )
        # the cache's internal CSR mirror restages independently of the
        # engine-query mirror: one more allowed first contact per run
        if self.view_modes:
            budget += 1 + self.rebuilds
        # each fleet replica's LinkState mirror is fresh per run: first
        # query through it uploads once (attribute flaps after that are
        # incremental)
        if self.fleet is not None:
            budget += len(self.fleet["handles"])
        if restages > budget:
            failures.append("restage_bound")

        # races: zero unsuppressed findings when OPENR_TSAN is armed
        from ..analysis import race

        if race.TSAN is not None:
            findings = race.TSAN.drain()
            if findings:
                failures.append("races")
                sc.step(f"fuzz:races:{len(findings)}")

        sc.step(
            f"fuzz:settled:{'clean' if not failures else ','.join(failures)}"
        )
        return failures

    def fingerprint(self) -> frozenset:
        """Coverage tokens: log2-bucketed deltas of the deterministic
        counter whitelist plus the scripted rung/fault facts collected
        while the timeline ran."""
        tokens = set(self.tokens)
        eng = self.engine.get_counters()
        blk = self.engine.blocked.get_counters()
        for key in _FP_ENGINE_KEYS:
            d = eng.get(key, 0) - self._eng0.get(key, 0)
            if d > 0:
                tokens.add(f"{key}:{d.bit_length()}")
        for key in _FP_BLOCKED_KEYS:
            d = blk.get(key, 0) - self._blk0.get(key, 0)
            if d > 0:
                tokens.add(f"{key}:{d.bit_length()}")
        for key in _FP_DELTA_KEYS:
            d = self.local.get(key, 0)
            if d > 0:
                tokens.add(f"{key}:{d.bit_length()}")
        snapc = self._snapc.get_counters()
        for key in _FP_SNAPSHOT_KEYS:
            d = snapc.get(key, 0) - self._snap0.get(key, 0)
            if d > 0:
                tokens.add(f"{key}:{d.bit_length()}")
        for op in self.fired:
            tokens.add(f"fault:{op}")
        # span-tree structure as a novelty signal: a new retry/hedge edge
        # or rung attribution shape counts as coverage even when every
        # counter bucket is already known (determinism contract makes
        # these byte-stable across same-seed replays)
        tr = _trace.TRACE
        if tr is not None:
            for t in tr.drain_structure_tokens():
                tokens.add("span:" + t)
        return frozenset(tokens)

    def counter_deltas(self) -> dict:
        eng = self.engine.get_counters()
        out = {
            k: eng.get(k, 0) - self._eng0.get(k, 0) for k in _FP_ENGINE_KEYS
        }
        blk = self.engine.blocked.get_counters()
        out.update(
            {k: blk.get(k, 0) - self._blk0.get(k, 0) for k in _FP_BLOCKED_KEYS}
        )
        out.update({k: self.local.get(k, 0) for k in _FP_DELTA_KEYS})
        snapc = self._snapc.get_counters()
        out.update(
            {
                k: snapc.get(k, 0) - self._snap0.get(k, 0)
                for k in _FP_SNAPSHOT_KEYS
            }
        )
        return out

    def close(self) -> None:
        self.engine.fault_hook = None
        # release the run's device residency: csr mirrors are per-run
        # objects, keeping them resident would leak across the session
        self.engine.drop(self.csr)
        if self.fleet is not None:
            f = self.fleet
            try:
                f["router"].stop()
            except Exception:  # noqa: BLE001 — already stopped at settle
                pass
            for h in f["handles"]:
                try:
                    if not h.killed:
                        h.scheduler.stop()
                except Exception:  # noqa: BLE001
                    pass
        for store in self.kv_stores:
            store.stop()
        for updates, syncs, peerq in self.kv_queues:
            updates.close()
            syncs.close()
            peerq.close()
        for store in self.kv_stores:
            store.wait_until_stopped(5)


def run_timeline(
    timeline: FuzzTimeline,
    log_: Optional[ChaosEventLog] = None,
    plant: bool = False,
    device=None,
) -> FuzzRunResult:
    """Replay one corpus entry against a fresh world on `device` (the
    CUDA card when None); deterministic for a fixed (timeline, plant)
    pair — asserted by the tier-1 smoke."""
    world = _FuzzWorld(timeline, log_=log_, plant=plant, device=device)
    applied = skipped = 0
    try:
        world.scenario.step(
            f"fuzz:run:v{timeline.version}:seed={timeline.seed}"
            f":events={len(timeline.events)}"
        )
        for ev in timeline.events:
            if world.apply(ev):
                applied += 1
            else:
                skipped += 1
        failures = world.settle_and_check()
        fingerprint = world.fingerprint()
        counters = world.counter_deltas()
    finally:
        world.close()
    FUZZ_COUNTERS._bump("chaos.fuzz.runs")
    return FuzzRunResult(
        timeline=timeline,
        log=world.log,
        ok=not failures,
        failures=failures,
        fingerprint=fingerprint,
        counters=counters,
        applied=applied,
        skipped=skipped,
        faults_fired=len(world.fired),
    )


# -- generation: seeds, mutation, crossover ----------------------------------


def _rand_event(rng: random.Random, family: str) -> FuzzEvent:
    """One concrete event; all parameters are synthesized HERE so replay
    and shrinking never consult an RNG."""
    if family == "ocs":
        a = rng.randrange(_N)
        return FuzzEvent(
            "ocs",
            "swap",
            {
                "victim": [a, (a + _N // 2) % _N],
                "fresh": sorted(
                    (rng.randrange(_N), (rng.randrange(3, _N - 3)))
                ),
            },
        )
    if family == "flap":
        kind = rng.choice(("worsen", "restore", "down", "up", "chunk"))
        if kind == "chunk":
            return FuzzEvent("flap", "chunk", {})
        return FuzzEvent("flap", kind, {"node": rng.randrange(_N)})
    if family == "kv":
        kind = rng.choice(("ttl_storm", "ttl_storm", "partition", "heal"))
        if kind == "ttl_storm":
            return FuzzEvent(
                "kv",
                "ttl_storm",
                {
                    "n_keys": rng.randrange(4, 25),
                    "ttl_ms": rng.randrange(80, 260),
                    "origin": rng.randrange(2),
                },
            )
        return FuzzEvent("kv", kind, {})
    if family == "fleet":
        kind = rng.choice(
            ("burst", "burst", "kill", "restart", "partition", "heal", "flap")
        )
        if kind == "burst":
            return FuzzEvent("fleet", "burst", {"q": rng.randrange(2, 7)})
        if kind == "flap":
            return FuzzEvent(
                "fleet", "flap", {"node": rng.randrange(_FLEET_N)}
            )
        return FuzzEvent("fleet", kind, {"idx": rng.randrange(2)})
    if family == "snapshot":
        # take/restore on the world mirror; scale/kill on the fleet
        # satellite.  All kinds are tolerant no-ops when their target
        # state is absent (restore before take, kill before scale), so
        # shrinking can delete any prefix
        kind = rng.choice(
            ("take", "restore", "restore", "scale", "kill")
        )
        return FuzzEvent("snapshot", kind, {})
    # engine
    kind = rng.choice(("arm", "spf", "spf", "pallas_mode", "blocked"))
    if kind == "arm":
        return FuzzEvent("engine", "arm", {"op": rng.choice(ARMABLE_OPS)})
    if kind == "pallas_mode":
        return FuzzEvent(
            "engine",
            "pallas_mode",
            {"mode": rng.choice(("interpret", "off"))},
        )
    if kind == "blocked":
        return FuzzEvent("engine", "blocked", {})
    return FuzzEvent("engine", "spf", {"off": rng.randrange(_N)})


def ensure_min_families(
    t: FuzzTimeline, rng: random.Random, min_families: int = 3
) -> FuzzTimeline:
    """Mutation/crossover fixup: a searched timeline must keep composing
    at least `min_families` chaos families (the tier-1 smoke asserts 3).
    Checked-in reproducers are exempt — shrinking goes below on purpose."""
    missing = [f for f in FAMILIES if f not in t.families()]
    rng.shuffle(missing)
    while len(t.families()) < min_families and missing:
        t.events.append(_rand_event(rng, missing.pop()))
    return t


def seed_timeline(seed: int, n_events: int = 12) -> FuzzTimeline:
    """A baseline corpus entry: a deterministic event mix spanning at
    least three families, with flap batches closed by chunk events."""
    rng = random.Random(f"fuzz-seed:{seed}")
    fams = list(FAMILIES)
    rng.shuffle(fams)
    events: list[FuzzEvent] = []
    for k in range(n_events):
        fam = fams[k % len(fams)] if k < len(fams) else rng.choice(FAMILIES)
        events.append(_rand_event(rng, fam))
    # every flap batch coalesces at least once; one closing SPF check
    if any(e.family == "flap" for e in events):
        events.append(FuzzEvent("flap", "chunk", {}))
    events.append(FuzzEvent("engine", "spf", {"off": rng.randrange(_N)}))
    t = FuzzTimeline(seed=seed, events=events)
    return ensure_min_families(t, rng)


def mutate(t: FuzzTimeline, rng: random.Random) -> FuzzTimeline:
    """One mutation step: insert / delete / duplicate / retarget an
    event.  Returns a new timeline; the parent is never modified."""
    events = [FuzzEvent.from_json(e.to_json()) for e in t.events]
    op = rng.choice(("insert", "delete", "dup", "tweak"))
    if op == "insert" or not events:
        i = rng.randrange(len(events) + 1)
        events.insert(i, _rand_event(rng, rng.choice(FAMILIES)))
    elif op == "delete" and len(events) > 1:
        events.pop(rng.randrange(len(events)))
    elif op == "dup":
        i = rng.randrange(len(events))
        events.insert(i, FuzzEvent.from_json(events[i].to_json()))
    else:  # tweak: re-synthesize one event within its family
        i = rng.randrange(len(events))
        events[i] = _rand_event(rng, events[i].family)
    out = FuzzTimeline(seed=rng.randrange(1 << 30), events=events)
    FUZZ_COUNTERS._bump("chaos.fuzz.mutations")
    return ensure_min_families(out, rng)


def crossover(
    a: FuzzTimeline, b: FuzzTimeline, rng: random.Random
) -> FuzzTimeline:
    """One-point crossover: a prefix of `a` spliced onto a suffix of
    `b` — the operator that composes fault families that never met in
    either parent."""
    i = rng.randrange(len(a.events) + 1)
    j = rng.randrange(len(b.events) + 1)
    events = [
        FuzzEvent.from_json(e.to_json())
        for e in (a.events[:i] + b.events[j:])
    ]
    if not events:
        events = [_rand_event(rng, rng.choice(FAMILIES))]
    out = FuzzTimeline(seed=rng.randrange(1 << 30), events=events)
    FUZZ_COUNTERS._bump("chaos.fuzz.crossovers")
    return ensure_min_families(out, rng)


# -- the fuzz loop -----------------------------------------------------------


@dataclass
class FuzzSessionResult:
    seed: int
    requested: int
    results: list = field(default_factory=list)  # FuzzRunResult, run order
    corpus: list = field(default_factory=list)  # timelines that added coverage
    coverage_history: list = field(default_factory=list)  # cumulative |tokens|
    failures: list = field(default_factory=list)  # oracle-violating results
    shed: int = 0  # runs dropped by the wall budget
    sched_tokens: int = 0  # explorer tokens merged into the coverage map

    @property
    def coverage(self) -> int:
        return self.coverage_history[-1] if self.coverage_history else 0


def fuzz(
    n: int,
    seed: int = 0,
    budget_s: float = 0.0,
    plant: bool = False,
    crossover_p: float = 0.33,
    n_seeds: int = 3,
    stop_on_failure: bool = False,
    sched_n: int = 0,
    device=None,
) -> FuzzSessionResult:
    """Run `n` timelines: the seed corpus first, then mutants and
    crossovers of whatever earned corpus membership by novel coverage.

    `budget_s` > 0 bounds wall time: remaining runs are SHED LOUDLY
    (`result.shed`, stderr note) instead of letting a slow box time the
    whole suite out — the bench.py budget discipline.

    `sched_n` > 0 additionally samples that many schedules from the
    OPENR_SCHED explorer (analysis/sched.py) and merges their
    ``sched:<scenario>:<choice-fingerprint>`` tokens into this session's
    coverage map, so timeline search and schedule search share one
    novelty frontier: a timeline is only "novel" if it reaches state no
    explored schedule already witnessed, and vice versa.  Every run
    computes on `device` (the CUDA card when None)."""
    rng = random.Random(seed)
    corpus = [seed_timeline(seed * 1000003 + i) for i in range(n_seeds)]
    session = FuzzSessionResult(seed=seed, requested=n)
    seen: set = set()
    if sched_n > 0:
        from ..analysis import sched as _sched

        sched_tokens = _sched.sample_tokens(seed, n_schedules=sched_n)
        if sched_tokens - seen:
            seen |= sched_tokens
            FUZZ_COUNTERS._bump("chaos.fuzz.novel_fingerprints")
        session.sched_tokens = len(sched_tokens)
    deadline = time.monotonic() + budget_s if budget_s > 0 else None
    for i in range(n):
        if deadline is not None and time.monotonic() > deadline:
            session.shed = n - i
            print(
                f"chaos.fuzz: wall budget {budget_s:.0f}s exhausted after "
                f"{i}/{n} runs; shedding {session.shed} "
                "(raise --budget-s or OPENR_FUZZ_BUDGET_S)",
                file=sys.stderr,
            )
            break
        if i < len(corpus):
            t = corpus[i]
        elif len(corpus) >= 2 and rng.random() < crossover_p:
            a, b = rng.sample(range(len(corpus)), 2)
            t = crossover(corpus[a], corpus[b], rng)
        else:
            t = mutate(corpus[rng.randrange(len(corpus))], rng)
        res = run_timeline(t, plant=plant, device=device)
        session.results.append(res)
        novel = res.fingerprint - seen
        if novel:
            seen |= novel
            FUZZ_COUNTERS._bump("chaos.fuzz.novel_fingerprints")
            if i >= len(corpus):
                corpus.append(t)
        session.coverage_history.append(len(seen))
        if not res.ok:
            FUZZ_COUNTERS._bump("chaos.fuzz.oracle_failures")
            session.failures.append(res)
            if stop_on_failure:
                break
    session.corpus = corpus
    return session


# -- the shrinker ------------------------------------------------------------


def shrink(
    timeline: FuzzTimeline,
    plant: bool = False,
    oracle: Optional[str] = None,
    device=None,
) -> FuzzTimeline:
    """Delta-debug an oracle-violating timeline down to a minimal
    reproducer: ddmin chunk removal (halving granularity) followed by a
    parameter-shrink pass.  Every candidate evaluation is one full
    deterministic replay (`chaos.fuzz.shrink_steps`)."""

    def violates(t: FuzzTimeline) -> Optional[str]:
        FUZZ_COUNTERS._bump("chaos.fuzz.shrink_steps")
        res = run_timeline(t, plant=plant, device=device)
        if not res.failures:
            return None
        if oracle is not None and oracle not in res.failures:
            return None
        return res.failures[0]

    first = violates(timeline)
    if first is None:
        raise ValueError(
            "shrink: the input timeline does not violate "
            f"{oracle or 'any oracle'} — nothing to reduce"
        )
    target = oracle or first

    events = list(timeline.events)
    gran = 2
    while len(events) > 1:
        chunk = -(-len(events) // gran)
        reduced = False
        for start in range(0, len(events), chunk):
            cand = events[:start] + events[start + chunk :]
            if not cand:
                continue
            t2 = FuzzTimeline(seed=timeline.seed, events=cand)
            if violates(t2) == target:
                events = cand
                gran = max(2, gran - 1)
                reduced = True
                break
        if not reduced:
            if gran >= len(events):
                break
            gran = min(len(events), 2 * gran)

    # parameter shrink: smaller storms / bursts when they still fail
    for i, ev in enumerate(events):
        for key, floor in (("n_keys", 1), ("q", 1)):
            v = ev.params.get(key)
            if isinstance(v, int) and v > floor:
                cand = [
                    FuzzEvent.from_json(e.to_json()) for e in events
                ]
                cand[i].params[key] = floor
                t2 = FuzzTimeline(seed=timeline.seed, events=cand)
                if violates(t2) == target:
                    events = cand
    return FuzzTimeline(
        seed=timeline.seed,
        events=events,
        oracle=target,
        note=f"shrunk from {len(timeline.events)} events",
    )


def shrink_preserving_coverage(
    timeline: FuzzTimeline, tokens: frozenset, device=None
) -> FuzzTimeline:
    """Same ddmin chunk-removal skeleton as `shrink`, but the predicate
    is coverage retention instead of oracle violation: a candidate
    survives iff it still replays clean AND its fingerprint covers
    `tokens`.  This is how clean-but-novel session timelines are
    minimized before being checked into tests/chaos_corpus/ — the entry
    keeps witnessing the exact coverage that earned it corpus
    membership, at a fraction of the replay cost."""

    def keeps(t: FuzzTimeline) -> bool:
        FUZZ_COUNTERS._bump("chaos.fuzz.shrink_steps")
        res = run_timeline(t, device=device)
        return res.ok and tokens <= res.fingerprint

    if not keeps(timeline):
        raise ValueError(
            "shrink_preserving_coverage: the input timeline does not "
            "cover the requested tokens cleanly — nothing to preserve"
        )
    events = list(timeline.events)
    gran = 2
    while len(events) > 1:
        chunk = -(-len(events) // gran)
        reduced = False
        for start in range(0, len(events), chunk):
            cand = events[:start] + events[start + chunk :]
            if not cand:
                continue
            if keeps(FuzzTimeline(seed=timeline.seed, events=cand)):
                events = cand
                gran = max(2, gran - 1)
                reduced = True
                break
        if not reduced:
            if gran >= len(events):
                break
            gran = min(len(events), 2 * gran)
    return FuzzTimeline(seed=timeline.seed, events=events)


# -- CLI ---------------------------------------------------------------------


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m openr_tpu_torch.chaos.fuzz",
        description=__doc__.splitlines()[0],
    )
    parser.add_argument(
        "--fuzz-n", type=int, default=50, help="timelines to run"
    )
    parser.add_argument(
        "--seed",
        type=int,
        default=int(os.environ.get("OPENR_FUZZ_SEED", "0")),
        help="session seed (default: OPENR_FUZZ_SEED or 0)",
    )
    parser.add_argument(
        "--budget-s",
        type=float,
        default=float(os.environ.get("OPENR_FUZZ_BUDGET_S", "0")),
        help="wall budget; remaining runs shed loudly (0 = uncapped)",
    )
    parser.add_argument(
        "--shrink",
        metavar="ENTRY",
        help="shrink a failing corpus entry (JSON path) instead of fuzzing",
    )
    parser.add_argument(
        "--plant",
        action="store_true",
        default=os.environ.get("OPENR_FUZZ_PLANT", "0") == "1",
        help="arm the seeded ledger-misaccounting bug (shrinker self-test)",
    )
    parser.add_argument(
        "--out",
        default="chaos_corpus",
        help="directory for shrunk reproducers",
    )
    parser.add_argument(
        "--sched-n",
        type=int,
        default=0,
        help=(
            "sample this many OPENR_SCHED schedules and merge their "
            "coverage tokens into the session's novelty frontier"
        ),
    )
    parser.add_argument(
        "--device",
        default=None,
        help="device to compute on (default: the CUDA card; 'cpu' asks "
        "for the CPU)",
    )
    args = parser.parse_args(argv)

    if args.shrink:
        with open(args.shrink) as fh:
            t = FuzzTimeline.loads(fh.read())
        minimal = shrink(
            t, plant=args.plant, oracle=t.oracle or None, device=args.device
        )
        out_path = args.shrink.rsplit(".json", 1)[0] + ".min.json"
        with open(out_path, "w") as fh:
            fh.write(minimal.dumps() + "\n")
        print(
            f"shrunk {len(t.events)} -> {len(minimal.events)} events "
            f"(oracle: {minimal.oracle}) -> {out_path}"
        )
        return 0

    session = fuzz(
        args.fuzz_n,
        seed=args.seed,
        budget_s=args.budget_s,
        plant=args.plant,
        sched_n=args.sched_n,
        device=args.device,
    )
    ran = len(session.results)
    print(
        f"chaos.fuzz: {ran}/{session.requested} runs "
        f"(seed={args.seed}, shed={session.shed}), "
        f"coverage={session.coverage} tokens "
        f"({session.sched_tokens} from sched), "
        f"corpus={len(session.corpus)}, "
        f"failures={len(session.failures)}"
    )
    if not session.failures:
        return 0
    os.makedirs(args.out, exist_ok=True)
    for k, res in enumerate(session.failures):
        minimal = shrink(
            res.timeline,
            plant=args.plant,
            oracle=res.failures[0],
            device=args.device,
        )
        path = os.path.join(
            args.out, f"fuzz_{args.seed}_{k}_{minimal.oracle}.json"
        )
        with open(path, "w") as fh:
            fh.write(minimal.dumps() + "\n")
        print(
            f"  failure {k}: {res.failures} -> {len(minimal.events)}-event "
            f"reproducer at {path}"
        )
    return 1


if __name__ == "__main__":
    sys.exit(main())
