"""Seeded replica-fleet chaos: kill, restart, and partition replicas
behind a ReplicaRouter under open-loop load.

Port of `openr_tpu.chaos.replicafleet`, over the port's serving layer
and `EngineSnapshot`.  Each replica's `EngineBatchBackend` computes on
`device` (the CUDA card when None) unless a shared `spf_backend` is
given; the same seed replays the same scripted log as the reference's.

A ReplicaFleetController builds K scheduler replicas (each an
`EngineBatchBackend` over its own LinkState mirror, fed the identical
update stream — the in-process stand-in for KvStore full-mesh
replication) behind one `serving.ReplicaRouter`, then replays a
deterministic fault schedule against them while `OpenLoopLoadGen`
drives session-pinned queries through the front door:

- **kill/restart** — a replica's handle starts refusing traffic
  (`ReplicaUnavailableError`) and its scheduler stops mid-burst, so
  in-flight queries shed there and re-route; restart brings a fresh
  scheduler up over the same mirror and the router's liveness probe
  revives it.
- **partition** — the handle is unreachable AND stops receiving
  topology updates, so on heal it is both revived and behind (the
  epoch-lag case, not just the dead case).
- **scripted lag** — one replica is held a round behind on purpose,
  then a pinned session is marched across the fleet: round-robin is
  guaranteed to land it on the lagged replica, whose stale answer the
  router must re-route (`serving.router.epoch_reroutes`), never
  deliver.

Every scripted action is logged through ChaosScenario into the shared
ChaosEventLog scenario stream, so two runs from the same seed replay
bit-for-bit (`ChaosEventLog.matches`) — reply counts and retry counts
are timing-dependent on a loaded box and are deliberately NOT logged.
Correctness is judged per reply against a host Dijkstra oracle cached
at every epoch the truth topology ever occupied: an answer is only
right if it is bit-exact *at the epoch it claims* (`QueryResult.epoch`),
which is what makes cross-replica consistency checkable rather than
hoped-for.
"""

from __future__ import annotations

import concurrent.futures
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from ..decision.link_state import LinkState
from ..serving import (
    EngineBatchBackend,
    QueryScheduler,
    QueryShedError,
    ReplicaRouter,
    ReplicaUnavailableError,
)
from ..types import AdjacencyDatabase
from .chaos import ChaosEventLog
from .flapstorm import _adj, _base_metric
from .overload import LoadReport, OpenLoopLoadGen
from .scenario import ChaosScenario

_RING_OFFSETS = (1, -1, 2, -2)
_WORSE_METRIC = 70


class ChaosReplicaHandle:
    """Router-facing replica handle with kill/partition fault flags.

    `killed`/`partitioned` make `submit` resolve to
    `ReplicaUnavailableError` (the async shape a dead connection has)
    and make the `epoch` liveness probe raise, so the router sees the
    same failure surface a real dead/unreachable daemon would present.
    `get_counters` stays readable — the post-mortem ledger survives the
    fault, like a metrics store would.
    """

    def __init__(self, name: str, scheduler, ls: LinkState) -> None:
        self.name = name
        self.scheduler = scheduler
        self.ls = ls
        self.killed = False
        self.partitioned = False
        self.applied = 0  # index into the fleet's update stream

    def submit(self, op: str, **kw) -> "concurrent.futures.Future":
        if self.killed or self.partitioned:
            fut: "concurrent.futures.Future" = concurrent.futures.Future()
            fut.set_exception(
                ReplicaUnavailableError(f"{self.name} unreachable")
            )
            return fut
        return self.scheduler.submit(op, **kw)

    def epoch(self, area: str = "0") -> int:
        if self.killed or self.partitioned:
            raise ReplicaUnavailableError(f"{self.name} unreachable")
        return int(self.ls.version)

    def get_counters(self) -> dict:
        return self.scheduler.get_counters()


@dataclass
class ReplicaFleetResult:
    rounds: int
    submitted: int  # open-loop + scripted pin-segment queries
    replied: int
    shed: int
    errors: int
    bit_exact: bool  # every reply exact vs the oracle AT ITS EPOCH
    mismatches: int
    unknown_epochs: int  # replies claiming an epoch the truth never had
    pin_violations: int  # per-session epoch regressions (must be 0)
    ledger_ok: bool  # router counters reconcile with the load report
    epochs_served: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)

    @property
    def accounted(self) -> int:
        return self.replied + self.shed + self.errors


class ReplicaFleetController:
    """Replayable kill/restart/partition schedule over a replica fleet."""

    def __init__(
        self,
        seed: int = 0,
        n: int = 16,
        replicas: int = 3,
        rounds: int = 8,
        clients: int = 8,
        per_client: int = 7,
        kill_round: int = 2,
        restart_round: int = 4,
        partition_round: int = 5,
        heal_round: int = 6,
        lag_rounds: tuple = (3, 6),
        scaleout_round: Optional[int] = None,
        scalein_round: Optional[int] = None,
        hedge_after_s: Optional[float] = 0.02,
        spf_backend=None,
        log_: Optional[ChaosEventLog] = None,
        device=None,
    ) -> None:
        self.seed = int(seed)
        self.device = device
        self.n = int(n)
        self.replicas = int(replicas)
        self.rounds = int(rounds)
        self.clients = int(clients)
        self.per_client = int(per_client)
        self.kill_round = kill_round
        self.restart_round = restart_round
        self.partition_round = partition_round
        self.heal_round = heal_round
        self.lag_rounds = tuple(lag_rounds)
        # elastic membership schedule (None keeps legacy timelines
        # byte-identical): scale-out joins a snapshot-warm-started
        # replica mid-burst; scale-in removes and kills the youngest
        # JOINED replica (never a scripted fault target)
        self.scaleout_round = scaleout_round
        self.scalein_round = scalein_round
        self.hedge_after_s = hedge_after_s
        self.spf_backend = spf_backend
        self.log = log_ if log_ is not None else ChaosEventLog()
        self.scenario = ChaosScenario(self.log)
        # fault targets (deterministic): kill replica 1, partition the
        # last, lag replica 0 — disjoint for K >= 3, clamped below it
        self.kill_idx = 1 % self.replicas
        self.partition_idx = (self.replicas - 1) % self.replicas
        self.lag_idx = 0
        self._minted = self.replicas  # next replica name index
        self._joined: list[ChaosReplicaHandle] = []

    # -- topology --------------------------------------------------------------

    def _name(self, i: int) -> str:
        return f"f{i % self.n:03d}"

    def _node_db(self, i: int, flapped: dict) -> AdjacencyDatabase:
        me = self._name(i)
        adjs = []
        for d in _RING_OFFSETS:
            j = (i + d) % self.n
            metric = _base_metric(i, j)
            if d == 1 and i in flapped:
                metric = flapped[i]
            adjs.append(_adj(me, self._name(j), metric))
        return AdjacencyDatabase(
            this_node_name=me,
            adjacencies=adjs,
            is_overloaded=False,
            node_label=0,
            area="0",
        )

    def _build_ls(self) -> LinkState:
        ls = LinkState("0")
        for i in range(self.n):
            ls.update_adjacency_database(self._node_db(i, {}))
        return ls

    # -- oracle ----------------------------------------------------------------

    def _cache_oracle(self, truth: LinkState, oracle: dict) -> None:
        """Snapshot {src: {dest: (metric, next_hops)}} for every source
        at the truth's CURRENT epoch.  Replies are later judged against
        the snapshot matching their claimed epoch."""
        epoch = int(truth.version)
        if epoch in oracle:
            return
        snap = {}
        for src in truth.node_names:
            res = truth.run_spf(src)
            snap[src] = {
                dest: (entry.metric, frozenset(entry.next_hops))
                for dest, entry in res.items()
            }
        oracle[epoch] = snap

    # -- fleet plumbing ----------------------------------------------------------

    def _catch_up(self, handle: ChaosReplicaHandle, updates: list) -> None:
        for db in updates[handle.applied :]:
            handle.ls.update_adjacency_database(db)
        handle.applied = len(updates)

    def _kill(self, handle: ChaosReplicaHandle) -> None:
        handle.killed = True
        # the dying process takes its in-flight work down loudly: the
        # scheduler's stop() resolves every inflight future (shed), and
        # the router re-routes each one
        handle.scheduler.stop()

    def _restart(self, handle: ChaosReplicaHandle, updates: list) -> None:
        backend = handle.scheduler.backend
        handle.scheduler = QueryScheduler(backend)
        handle.scheduler.run()
        self._catch_up(handle, updates)
        handle.killed = False

    def _scale_out_prepare(self, handles: list, updates: list):
        """Build and warm-start the joining replica while the fleet is
        quiescent (between bursts): built like the initial fleet, caught
        up on the update stream, snapshot-warm-started from replica 0's
        device engine (install or accounted cold — see
        openr_tpu_torch/snapshot).  Quiescence is load-bearing for the replay contract:
        the donor engine is not mid-dispatch, so the restore mode is a
        pure function of the seed's update stream (same stream -> same
        mirror content -> same rung).  Returns (handle, mode); the
        router join itself happens mid-burst in _scale_out_join."""
        i = self._minted
        self._minted += 1
        ls = self._build_ls()
        backend = EngineBatchBackend(
            {"0": ls}, spf_backend=self.spf_backend, device=self.device
        )
        sched = QueryScheduler(backend)
        sched.run()
        handle = ChaosReplicaHandle(f"replica-{i}", sched, ls)
        self._catch_up(handle, updates)
        mode = "skipped"
        donor = handles[0].scheduler.backend
        d_spf = getattr(donor, "spf", None)
        j_spf = backend.spf
        # a shared spf_backend means one engine and one mirror cache —
        # nothing to warm-start across
        if (
            hasattr(d_spf, "csr_mirror")
            and hasattr(j_spf, "csr_mirror")
            and d_spf is not j_spf
        ):
            try:
                from ..snapshot import EngineSnapshot

                snap = EngineSnapshot.take(
                    d_spf.engine, d_spf.csr_mirror(handles[0].ls)
                )
                mode = snap.restore(j_spf.engine, j_spf.csr_mirror(ls))
            except Exception:  # noqa: BLE001 — warm start is best-effort
                mode = "skipped"
        return handle, mode

    def _scale_out_join(self, handles: list, router, handle) -> None:
        """Add the prepared replica to the live router mid-burst: the
        membership swap and the dispatch-ledger extension are what the
        join exercises under load."""
        handles.append(handle)
        self._joined.append(handle)
        router.add_replica(handle)

    def _scale_in(self, handles: list, router) -> Optional[str]:
        """Remove and kill the youngest joined replica under load: the
        router stops picking it immediately and folds its final counters,
        then its scheduler dies loudly (in-flight work sheds and
        re-routes).  Scripted fault targets are never scale-in victims,
        so the kill/partition/lag schedule stays index-stable."""
        if not self._joined:
            return None
        handle = self._joined.pop()
        handles.remove(handle)
        router.remove_replica(handle.name)
        handle.killed = True
        handle.scheduler.stop()
        return handle.name

    # -- run ---------------------------------------------------------------------

    def run(self) -> ReplicaFleetResult:
        rng = random.Random(self.seed)
        sc = self.scenario

        truth = self._build_ls()
        updates: list[AdjacencyDatabase] = []
        flapped: dict[int, int] = {}
        handles: list[ChaosReplicaHandle] = []
        for i in range(self.replicas):
            ls = self._build_ls()
            backend = EngineBatchBackend(
                {"0": ls}, spf_backend=self.spf_backend, device=self.device
            )
            sched = QueryScheduler(backend)
            sched.run()
            handles.append(ChaosReplicaHandle(f"replica-{i}", sched, ls))
        assert all(h.ls.version == truth.version for h in handles)

        router = ReplicaRouter(handles, hedge_after_s=self.hedge_after_s)
        # the router's pin-trace seam, armed before its first query
        router.pin_trace = []  # openr: disable=thread-cross-module-write

        oracle: dict[int, dict] = {}
        self._cache_oracle(truth, oracle)

        # reply-side accounting shared by the open-loop generator and
        # the scripted pin segment
        check_lock = threading.Lock()
        acct = {
            "mismatches": 0,
            "unknown_epochs": 0,
            "epochs": set(),
            "manual_submitted": 0,
            "manual_replied": 0,
            "manual_shed": 0,
            "manual_errors": 0,
        }

        def check_reply(meta, res) -> None:
            op, src, _session = meta
            if op != "paths":
                return
            with check_lock:
                acct["epochs"].add(int(res.epoch))
                snap = oracle.get(int(res.epoch))
                if snap is None:
                    acct["unknown_epochs"] += 1
                    return
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

        sc.step(
            f"fleet:init:n={self.n}:replicas={self.replicas}"
            f":epoch={truth.version}"
        )
        loadgen = OpenLoopLoadGen(
            router,
            truth.node_names,
            seed=self.seed,
            clients=self.clients,
            sessions=True,
            on_reply=check_reply,
        )
        reports: list[LoadReport] = []

        def run_burst(r: int, concurrent_fault=None) -> None:
            """One open-loop burst; `concurrent_fault` (if any) runs
            mid-burst on the controller thread, so its scripted step
            keeps a deterministic position in the event log."""
            sc.step(f"fleet:burst:{r}:clients={self.clients}"
                    f":per_client={self.per_client}")
            if concurrent_fault is None:
                reports.append(loadgen.run_burst(self.per_client))
            else:
                box: dict = {}

                def _bg() -> None:
                    box["report"] = loadgen.run_burst(self.per_client)

                t = threading.Thread(target=_bg, name=f"fleet-burst-{r}")
                t.start()
                concurrent_fault()
                t.join()
                reports.append(box["report"])
            sc.step(f"fleet:burst:{r}:done")

        def manual_query(src: str, session: str):
            acct["manual_submitted"] += 1
            fut = router.submit("paths", sources=(src,), session=session)
            try:
                res = fut.result(timeout=30)
            except QueryShedError:
                acct["manual_shed"] += 1
                return None
            except concurrent.futures.TimeoutError:
                # an unresolved future IS a silent drop: leave it
                # unaccounted so accounted == submitted fails loudly
                return None
            except Exception:  # noqa: BLE001
                acct["manual_errors"] += 1
                return None
            acct["manual_replied"] += 1
            check_reply(("paths", src, session), res)
            return res

        pin_seq = 0

        def pin_segment() -> None:
            """Deterministic epoch-reroute forcing: pin a session at the
            fleet-head epoch, then march it around the round-robin until
            it lands on the lagged replica — whose stale answer must be
            re-routed, never delivered."""
            nonlocal pin_seq
            head = int(truth.version)
            session = f"pin-{pin_seq}"
            pin_seq += 1
            src = truth.node_names[0]
            sc.step(f"fleet:pin:{session}:epoch={head}")
            k = len(handles)
            for _ in range(4 * k):
                res = manual_query(src, session)
                if res is not None and int(res.epoch) >= head:
                    break
            for _ in range(3 * k):
                manual_query(src, session)
            sc.step(f"fleet:pin:{session}:done")

        for r in range(self.rounds):
            # scripted faults first, in a deterministic order
            if r == self.restart_round:
                sc.step(f"fleet:restart:replica-{self.kill_idx}:{r}")
                self._restart(handles[self.kill_idx], updates)
                router.probe_replicas()
            if r == self.heal_round:
                sc.step(f"fleet:heal:replica-{self.partition_idx}:{r}")
                h = handles[self.partition_idx]
                h.partitioned = False
                self._catch_up(h, updates)
                router.probe_replicas()
            if r == self.partition_round:
                sc.step(f"fleet:partition:replica-{self.partition_idx}:{r}")
                handles[self.partition_idx].partitioned = True
            if r == self.scalein_round:
                gone = self._scale_in(handles, router)
                sc.step(f"fleet:scalein:{gone or 'noop'}:{r}")

            # one topology flap per round: exactly one epoch bump, so
            # every epoch the fleet can answer at has an oracle snapshot
            node = rng.randrange(self.n)
            if node in flapped:
                del flapped[node]
                sc.step(f"fleet:flap:{r}:{node}:restore")
            else:
                flapped[node] = _WORSE_METRIC
                sc.step(f"fleet:flap:{r}:{node}:worsen")
            db = self._node_db(node, flapped)
            truth.update_adjacency_database(db)
            updates.append(db)
            self._cache_oracle(truth, oracle)

            # replicate, holding back the lagged / unreachable replicas
            lagging = r in self.lag_rounds
            for i, h in enumerate(handles):
                if h.killed or h.partitioned:
                    continue
                if lagging and i == self.lag_idx:
                    continue
                self._catch_up(h, updates)
            if lagging:
                sc.step(f"fleet:lag:replica-{self.lag_idx}:{r}")

            if r == self.kill_round:

                def kill_mid_burst(r=r) -> None:
                    # let some of the burst land in the victim's queue
                    # first, so in-flight shed-and-re-route is exercised
                    # alongside the fail-fast path for later submissions
                    time.sleep(0.05)
                    sc.step(
                        f"fleet:kill:replica-{self.kill_idx}:{r}",
                        lambda: self._kill(handles[self.kill_idx]),
                    )

                run_burst(r, concurrent_fault=kill_mid_burst)
            elif r == self.scaleout_round:
                # warm-start on a quiescent fleet: the donor engine is
                # not mid-dispatch, so the restore mode is a pure
                # function of the seed's update stream — which makes it
                # part of the replay contract
                joiner, mode = self._scale_out_prepare(handles, updates)
                sc.step(f"fleet:scaleout:{r}:{mode}")

                def scaleout_mid_burst(r=r, joiner=joiner) -> None:
                    # let the burst saturate the old fleet first, so the
                    # router join really happens under load
                    time.sleep(0.05)
                    sc.step(
                        f"fleet:scaleout:join:{r}",
                        lambda: self._scale_out_join(handles, router, joiner),
                    )

                run_burst(r, concurrent_fault=scaleout_mid_burst)
            else:
                run_burst(r)

            if lagging:
                pin_segment()
                self._catch_up(handles[self.lag_idx], updates)
                sc.step(f"fleet:lag:replica-{self.lag_idx}:{r}:caught_up")

        # settle: everyone reachable catches up; final burst on a
        # healthy fleet
        sc.step("fleet:settle")
        router.probe_replicas()
        for h in handles:
            if not h.killed and not h.partitioned:
                self._catch_up(h, updates)
        run_burst(self.rounds)

        # stop the fleet BEFORE reading the ledger: scheduler stop()
        # joins the executor threads, so every router callback (and its
        # counter bumps) has finished when the counters are read
        router.stop()
        for h in handles:
            if not h.killed:
                h.scheduler.stop()
        counters = router.get_counters()

        submitted = sum(rep.submitted for rep in reports) + acct[
            "manual_submitted"
        ]
        replied = sum(rep.replied for rep in reports) + acct["manual_replied"]
        shed = sum(rep.shed for rep in reports) + acct["manual_shed"]
        errors = sum(rep.errors for rep in reports) + acct["manual_errors"]

        # per-session monotonicity, in acceptance order (the router's
        # pin_trace is appended under its lock at each accepted reply)
        pin_violations = 0
        last: dict = {}
        for session, epoch in router.pin_trace:
            if epoch < last.get(session, -1):
                pin_violations += 1
            last[session] = epoch

        # dispatch ledger: first dispatches are the non-shed submissions,
        # and every re-dispatch is in exactly one named bucket
        from ..serving.router import dispatch_ledger_closes

        ledger_ok = dispatch_ledger_closes(counters, submitted)

        bit_exact = (
            acct["mismatches"] == 0 and acct["unknown_epochs"] == 0
        )
        sc.step(f"fleet:settled:{'exact' if bit_exact else 'DIVERGED'}")
        return ReplicaFleetResult(
            rounds=self.rounds,
            submitted=submitted,
            replied=replied,
            shed=shed,
            errors=errors,
            bit_exact=bit_exact,
            mismatches=acct["mismatches"],
            unknown_epochs=acct["unknown_epochs"],
            pin_violations=pin_violations,
            ledger_ok=ledger_ok,
            epochs_served=sorted(acct["epochs"]),
            counters=counters,
        )
