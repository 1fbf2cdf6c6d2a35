"""Open-loop overload generator for the query-serving layer.

Port of `openr_tpu.chaos.overload`, over the port's `QueryScheduler` or
`ReplicaRouter` (anything with their `submit`).  The same seed offers
the same query sequence as the reference's.

Closed-loop load (wait for each reply before sending the next query)
can never overrun admission: the scheduler's own latency throttles the
clients.  Real overload is open-loop — N independent clients each
submit at their own cadence regardless of whether earlier replies have
arrived — so that is what this generator models.  Each client owns a
`random.Random(seed * 1000 + i)` stream, making the offered load (which
sources, which ops, in which order) a pure function of the seed: two
runs offer bit-identical query sequences, so shed/reply accounting is
comparable across runs.

Two modes:

- `run_burst(per_client)` — every client submits its whole budget as
  fast as the GIL allows, then the generator gathers every future.
  Deterministic enough for tier-1: offered load is exact, and the
  zero-silent-drop invariant (submitted == replied + shed + errors)
  must hold regardless of scheduling.
- `run_paced(duration_s, qps_per_client)` — wall-clock-paced open loop
  for the `-m slow` soak and the bench row: sustained qps with latency
  percentiles.

The report never inspects scheduler internals: it counts what the
*caller* observed (future resolved with a result, a QueryShedError, or
another error), which is exactly the surface the zero-silent-drop
acceptance criterion is stated over.
"""

from __future__ import annotations

import concurrent.futures
import random
import threading
import time
from dataclasses import dataclass, field

from ..serving import QueryShedError


@dataclass
class LoadReport:
    """What the clients observed, summed over all of them."""

    submitted: int = 0
    replied: int = 0
    shed: int = 0
    errors: int = 0
    wall_s: float = 0.0
    latencies_us: list = field(default_factory=list)
    batch_sizes: list = field(default_factory=list)

    @property
    def accounted(self) -> int:
        """Futures that resolved, one way or another.  Zero silent
        drops means accounted == submitted."""
        return self.replied + self.shed + self.errors

    @property
    def qps(self) -> float:
        return self.replied / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def mean_batch_occupancy(self) -> float:
        if not self.batch_sizes:
            return 0.0
        return sum(self.batch_sizes) / len(self.batch_sizes)

    def pctl_us(self, p: int) -> int:
        if not self.latencies_us:
            return 0
        lats = sorted(self.latencies_us)
        return int(lats[min(len(lats) - 1, (len(lats) * p) // 100)])


class OpenLoopLoadGen:
    """Seeded many-client open-loop generator over a QueryScheduler.

    `ops` weights which query kinds each client issues; the default is
    all-paths (single-source queries, the shape the coalescer merges
    into one bucketed program).  `nodes` is the source population.
    """

    def __init__(
        self,
        scheduler,
        nodes: list,
        seed: int = 0,
        clients: int = 8,
        ops: tuple = ("paths",),
        sessions: bool = False,
        on_reply=None,
    ) -> None:
        self.scheduler = scheduler
        self.nodes = list(nodes)
        self.seed = int(seed)
        self.clients = int(clients)
        self.ops = tuple(ops)
        # sessions=True tags every client's queries with a per-client
        # session id for the router's epoch pinning — only valid when
        # `scheduler` accepts a `session` kwarg (serving.ReplicaRouter)
        self.sessions = bool(sessions)
        # on_reply((op, src, session), QueryResult) runs during gather for
        # every successful reply — the chaos families hang their per-epoch
        # bit-exactness oracle checks here
        self.on_reply = on_reply

    def _submit_one(self, rng: random.Random, client_i: int):
        op = rng.choice(self.ops)
        src = rng.choice(self.nodes)
        kw: dict = {}
        session = f"client-{client_i}" if self.sessions else None
        if session is not None:
            kw["session"] = session
        if op == "paths":
            fut = self.scheduler.submit("paths", sources=(src,), **kw)
        elif op == "what_if":
            a, b = rng.sample(self.nodes, 2)
            fut = self.scheduler.submit(
                "what_if", sources=(src,), scenarios=(((a, b),),), **kw
            )
        else:
            dest = rng.choice([n for n in self.nodes if n != src])
            fut = self.scheduler.submit(
                "ksp", sources=(src,), dests=(dest,), **kw
            )
        return fut, (op, src, session)

    def _gather(
        self, futures: list, report: LoadReport, timeout_s: float
    ) -> None:
        deadline = time.monotonic() + timeout_s
        for fut, meta in futures:
            budget = max(0.0, deadline - time.monotonic())
            try:
                res = fut.result(timeout=budget)
            except QueryShedError:
                report.shed += 1
            except concurrent.futures.TimeoutError:
                # an unresolved future IS a silent drop: leave it
                # unaccounted so the invariant check fails loudly
                continue
            except Exception:  # noqa: BLE001
                report.errors += 1
            else:
                report.replied += 1
                report.latencies_us.append(res.latency_us)
                report.batch_sizes.append(res.batch_size)
                if self.on_reply is not None:
                    self.on_reply(meta, res)

    def run_burst(
        self, per_client: int, gather_timeout_s: float = 60.0
    ) -> LoadReport:
        """Every client fires its whole budget open-loop, then the
        report gathers every future."""
        report = LoadReport()
        lock = threading.Lock()
        all_futures: list = []

        def client(i: int) -> None:
            rng = random.Random(self.seed * 1000 + i)
            futures = [self._submit_one(rng, i) for _ in range(per_client)]
            with lock:
                all_futures.extend(futures)

        t0 = time.perf_counter()
        threads = [
            threading.Thread(target=client, args=(i,), name=f"loadgen-{i}")
            for i in range(self.clients)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        report.submitted = len(all_futures)
        self._gather(all_futures, report, gather_timeout_s)
        report.wall_s = time.perf_counter() - t0
        return report

    def run_paced(
        self,
        duration_s: float,
        qps_per_client: float,
        gather_timeout_s: float = 60.0,
    ) -> LoadReport:
        """Wall-clock-paced open loop: each client submits on its own
        fixed cadence for `duration_s`, never waiting for replies."""
        report = LoadReport()
        lock = threading.Lock()
        all_futures: list = []
        period = 1.0 / qps_per_client if qps_per_client > 0 else 0.0

        def client(i: int) -> None:
            rng = random.Random(self.seed * 1000 + i)
            futures = []
            t_next = time.monotonic()
            t_end = t_next + duration_s
            while time.monotonic() < t_end:
                futures.append(self._submit_one(rng, i))
                t_next += period
                delay = t_next - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
            with lock:
                all_futures.extend(futures)

        t0 = time.perf_counter()
        threads = [
            threading.Thread(target=client, args=(i,), name=f"loadgen-{i}")
            for i in range(self.clients)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        report.submitted = len(all_futures)
        self._gather(all_futures, report, gather_timeout_s)
        report.wall_s = time.perf_counter() - t0
        return report
