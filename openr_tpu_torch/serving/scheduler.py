"""QueryScheduler: admission -> coalesce -> double-buffered dispatch.

Port of `openr_tpu.serving.scheduler`.  One event-base thread and one
single-worker executor:

1. **Admission**: client threads call `submit()`, which enqueues a
   `_Pending` into a bounded `RWQueue`.  Overflow drops the oldest
   query, and the queue's `on_shed` handler completes its caller's
   future with an explicit `QueryShedError`: overload sheds loudly,
   never silently.
2. **Coalescing**: a fiber drains the admission queue and groups
   compatible queries (same op, area, topology epoch and mode) into one
   `_Batch`, answered by one backend call.  A non-zero `defer_hint`
   (Decision.pending_event_hint: topology events not yet folded into
   routes) holds the round for a bounded beat, so the batch pins the
   post-storm epoch.
3. **Double-buffered dispatch**: batches move through a one-slot staging
   queue into a one-worker executor; while batch i runs, the coalescer
   stages batch i+1.
4. **Invalidation**: each batch pins the epoch it coalesced against; the
   backend refuses a moved topology (`EpochMismatchError`) and the batch
   is recomputed against the fresh epoch, at most `_MAX_EPOCH_RETRIES`
   times, except `optimize_metrics`, which is never retried.  Any other
   exception fails every future of the batch (`serving.errors`).

Accounting lives under `serving.*` (SERVING_COUNTER_KEYS).  The
reference's trace spans and schedule-explorer regions (its `obs.trace`
and `analysis.sched` tooling) are not ported.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..device.engine import EpochMismatchError
from ..obs.histogram import Histogram, export_histogram
from ..runtime.eventbase import OpenrEventBase
from ..runtime.queue import QueueClosedError, RWQueue

log = logging.getLogger(__name__)

SERVING_COUNTER_KEYS = (
    "serving.admitted",
    "serving.coalesced",
    "serving.shed",
    "serving.batches",
    "serving.invalidations",
    "serving.host_fallbacks",
    "serving.replies",
    "serving.errors",
    "serving.batch_occupancy",
    "serving.p50_us",
    "serving.p99_us",
    "serving.p999_us",
    "serving.deferrals",
)

# batch-formation hold while topology events are pending (defer_hint):
# the per-wait sleep and the bounded total hold per round
_DEFER_TICK_S = 0.002
_DEFER_MAX_S = 0.05

# bounded retry against a topology that moves between coalescing and
# dispatch; each retry re-reads the epoch and recomputes fresh
_MAX_EPOCH_RETRIES = 3

_OPS = ("paths", "what_if", "ksp", "optimize_metrics")


class QueryShedError(RuntimeError):
    """The query was shed by admission control (queue overflow, closed
    admission, or scheduler shutdown): an explicit error reply."""


@dataclass(frozen=True)
class Query:
    """One client question.  `sources`/`dests`/`scenarios` are tuples so
    queries are hashable and batch keys stay value-typed."""

    op: str  # "paths" | "what_if" | "ksp" | "optimize_metrics"
    area: str = "0"
    sources: tuple = ()
    scenarios: tuple = ()  # what_if: tuple of scenario link tuples
    dests: tuple = ()  # ksp
    k: int = 2  # ksp
    use_link_metric: bool = True  # paths
    demand: tuple = ()  # optimize_metrics: ((src, dest, volume), ...)
    bounds: tuple = (1, 64)  # optimize_metrics: (metric_lo, metric_hi)
    steps: int = 32  # optimize_metrics: descent steps


@dataclass
class QueryResult:
    """Per-query reply with latency attribution."""

    value: Any
    latency_us: int
    batch_size: int
    epoch: int


@dataclass(eq=False)  # identity semantics: lives in the _inflight set
class _Pending:
    query: Query
    future: "concurrent.futures.Future[QueryResult]"
    t_submit: float


@dataclass
class _Batch:
    key: tuple
    op: str
    area: str
    epoch: int
    pendings: list = field(default_factory=list)


class QueryScheduler(OpenrEventBase):
    """Serving front end before a batch backend (serving.backend):
    admission queue, epoch-keyed coalescer, double-buffered dispatch."""

    def __init__(
        self,
        backend,
        max_pending: int = 1024,
        max_coalesce: int = 64,
        defer_hint: Optional[Callable[[], int]] = None,
    ) -> None:
        super().__init__(name="serving")
        self.backend = backend
        self.defer_hint = defer_hint
        self.max_coalesce = max_coalesce
        self.admission: RWQueue[_Pending] = RWQueue(
            maxlen=max_pending, on_shed=self._on_admission_shed
        )
        self._accepting = True
        # one-slot staging queue + one-worker executor = the double
        # buffer: the coalescer fills the slot while the worker runs
        self._staged: Optional[asyncio.Queue] = None
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serving-exec"
        )
        self._lock = threading.Lock()
        self.counters: dict[str, int] = {k: 0 for k in SERVING_COUNTER_KEYS}
        self._hist = Histogram()
        self._occupancy_sum = 0
        self._occupancy_batches = 0
        # every admitted-but-unanswered query; whatever is left at
        # shutdown is failed explicitly
        self._inflight: set = set()
        # seam called with (event, batch) at "stage", "execute_begin" and
        # "execute_end" (tests hold the pipeline here)
        self.trace_hook: Optional[Callable[[str, Any], None]] = None

    # -- counters ------------------------------------------------------------

    def _bump(self, name: str, delta: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + delta

    def get_counters(self) -> dict[str, int]:
        with self._lock:
            counters = dict(self.counters)
            occ_sum = self._occupancy_sum
            occ_n = self._occupancy_batches
        # mean batch occupancy in milli-queries per batch, and the
        # latency percentiles of the histogram
        counters["serving.batch_occupancy"] = (
            (occ_sum * 1000) // occ_n if occ_n else 0
        )
        export_histogram(counters, "serving", self._hist)
        return counters

    # -- admission (any thread) ----------------------------------------------

    def submit(
        self,
        op: str,
        *,
        area: str = "0",
        sources=(),
        scenarios=(),
        dests=(),
        k: int = 2,
        use_link_metric: bool = True,
        demand=(),
        bounds=(1, 64),
        steps: int = 32,
    ) -> "concurrent.futures.Future[QueryResult]":
        """Enqueue one query; returns a future resolving to a QueryResult
        or raising QueryShedError or the compute error.  Never blocks:
        over capacity, admission sheds (explicitly)."""
        if op not in _OPS:
            raise ValueError(f"unknown op {op!r} (expected one of {_OPS})")
        query = Query(
            op=op,
            area=area,
            sources=tuple(sources),
            scenarios=tuple(tuple(tuple(l) for l in sc) for sc in scenarios),
            dests=tuple(dests),
            k=int(k),
            use_link_metric=bool(use_link_metric),
            demand=tuple(
                (str(s), str(d), float(v)) for (s, d, v) in demand
            ),
            bounds=(int(bounds[0]), int(bounds[1])),
            steps=int(steps),
        )
        fut: "concurrent.futures.Future[QueryResult]" = (
            concurrent.futures.Future()
        )
        pending = _Pending(query, fut, time.perf_counter())
        if not self._accepting or not self.admission.push(pending):
            self._fail(pending, QueryShedError("admission closed"))
            return fut
        with self._lock:
            self._inflight.add(pending)
        self._bump("serving.admitted")
        return fut

    def _on_admission_shed(self, pending: _Pending) -> None:
        # runs on the pushing thread, outside the queue lock
        self._fail(pending, QueryShedError("admission queue overflow"))

    def _fail(self, pending: _Pending, exc: Exception) -> None:
        with self._lock:
            self._inflight.discard(pending)
        if pending.future.done():
            return
        if isinstance(exc, QueryShedError):
            self._bump("serving.shed")
        else:
            self._bump("serving.errors")
        pending.future.set_exception(exc)

    # -- coalescing (event-base fiber) ---------------------------------------

    @staticmethod
    def _batch_key(query: Query, epoch: int) -> tuple:
        if query.op == "paths":
            return ("paths", query.area, epoch, query.use_link_metric)
        if query.op == "what_if":
            # impact counting is relative to the source set, so only
            # identical views coalesce (scenarios concatenate)
            return ("what_if", query.area, epoch, query.sources)
        if query.op == "optimize_metrics":
            # only identical optimization requests coalesce: they share
            # one descent run and one answer
            return (
                "optimize_metrics", query.area, epoch, query.demand,
                query.bounds, query.steps,
            )
        return ("ksp", query.area, epoch, query.sources, query.k)

    async def prepare(self) -> None:
        self._staged = asyncio.Queue(maxsize=1)
        loop = asyncio.get_running_loop()
        self._track(
            loop.create_task(self._coalesce_loop(), name="serving-coalesce")
        )
        self._track(
            loop.create_task(self._dispatch_loop(), name="serving-dispatch")
        )

    async def _coalesce_loop(self) -> None:
        try:
            while True:
                first = await self.admission.aget()
                drained = [first]
                while len(drained) < self.max_coalesce:
                    try:
                        nxt = self.admission.try_get()
                    except QueueClosedError:
                        break
                    if nxt is None:
                        break
                    drained.append(nxt)
                # hold the round (bounded) while the decision layer still
                # has unfolded topology events, so the epoch pinned below
                # is the post-storm one
                if self.defer_hint is not None:
                    deadline = time.perf_counter() + _DEFER_MAX_S
                    deferred = False
                    while (
                        self.defer_hint() > 0
                        and time.perf_counter() < deadline
                    ):
                        deferred = True
                        await asyncio.sleep(_DEFER_TICK_S)
                    if deferred:
                        self._bump("serving.deferrals")
                # one epoch read per area per round: every query grouped
                # here pins the same topology version
                epochs: dict[str, int] = {}
                batches: dict[tuple, _Batch] = {}
                for pending in drained:
                    q = pending.query
                    epoch = epochs.get(q.area)
                    if epoch is None:
                        epoch = int(self.backend.epoch(q.area))
                        epochs[q.area] = epoch
                    key = self._batch_key(q, epoch)
                    batch = batches.get(key)
                    if batch is None:
                        batch = _Batch(key, q.op, q.area, epoch)
                        batches[key] = batch
                    batch.pendings.append(pending)
                for batch in batches.values():
                    if self.trace_hook is not None:
                        self.trace_hook("stage", batch)
                    await self._staged.put(batch)
        except (QueueClosedError, asyncio.CancelledError):
            pass

    # -- dispatch (double buffer) --------------------------------------------

    async def _dispatch_loop(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                batch = await self._staged.get()
                # the staging slot is free again: the coalescer overlaps
                # batch i+1 with this execution
                await loop.run_in_executor(self._pool, self._execute, batch)
        except asyncio.CancelledError:
            pass

    def _execute(self, batch: _Batch) -> None:
        if self.trace_hook is not None:
            self.trace_hook("execute_begin", batch)
        try:
            per_query: Optional[list] = None
            error: Optional[Exception] = None
            # optimize_metrics never retries an epoch mismatch: a flap
            # mid-descent means the run optimized a topology that no
            # longer exists, so it aborts (the caller sees the error)
            attempts = (
                1 if batch.op == "optimize_metrics" else _MAX_EPOCH_RETRIES
            )
            for _attempt in range(attempts):
                try:
                    per_query = self._run_batch(batch)
                    error = None
                    break
                except EpochMismatchError as e:
                    # a flap landed between coalescing and dispatch:
                    # re-pin the fresh epoch and recompute
                    self._bump("serving.invalidations")
                    batch.epoch = int(self.backend.epoch(batch.area))
                    error = e
                except Exception as e:  # noqa: BLE001
                    log.debug(
                        "serving: batch %s failed", batch.op, exc_info=True
                    )
                    error = e
                    break
            n = len(batch.pendings)
            with self._lock:
                self.counters["serving.batches"] += 1
                self._occupancy_sum += n
                self._occupancy_batches += 1
            if n > 1:
                self._bump("serving.coalesced", n - 1)
            if error is not None or per_query is None:
                exc = error or RuntimeError("serving: batch produced nothing")
                for pending in batch.pendings:
                    self._fail(pending, exc)
                return
            t_done = time.perf_counter()
            for pending, value in zip(batch.pendings, per_query):
                latency_us = int((t_done - pending.t_submit) * 1e6)
                with self._lock:
                    self._inflight.discard(pending)
                self._hist.record_us(latency_us)
                if pending.future.done():
                    continue
                self._bump("serving.replies")
                pending.future.set_result(
                    QueryResult(
                        value=value,
                        latency_us=latency_us,
                        batch_size=n,
                        epoch=batch.epoch,
                    )
                )
        finally:
            if self.trace_hook is not None:
                self.trace_hook("execute_end", batch)

    def _run_batch(self, batch: _Batch) -> list:
        """One backend call for the whole batch; per-query values aligned
        with batch.pendings."""
        queries = [p.query for p in batch.pendings]
        if batch.op == "optimize_metrics":
            # the batch key made every member identical: one descent run
            # answers them all
            q = queries[0]
            result = self.backend.run_optimize_metrics(
                batch.area,
                q.demand,
                q.bounds,
                steps=q.steps,
                expect_epoch=batch.epoch,
            )
            return [result for _ in queries]
        if batch.op == "paths":
            # stable-order union of every query's sources
            merged = list(
                dict.fromkeys(s for q in queries for s in q.sources)
            )
            results = self.backend.run_paths(
                batch.area,
                merged,
                use_link_metric=queries[0].use_link_metric,
                expect_epoch=batch.epoch,
            )
            return [
                {s: results[s] for s in q.sources if s in results}
                for q in queries
            ]
        if batch.op == "what_if":
            merged_sc: list = []
            offsets: list[tuple[int, int]] = []
            for q in queries:
                offsets.append(
                    (len(merged_sc), len(merged_sc) + len(q.scenarios))
                )
                merged_sc.extend(list(map(list, sc)) for sc in q.scenarios)
            rows = self.backend.run_what_if(
                batch.area,
                list(queries[0].sources),
                merged_sc,
                expect_epoch=batch.epoch,
            )
            out = []
            for lo, hi in offsets:
                mine = []
                for i, row in enumerate(rows[lo:hi]):
                    row = dict(row)
                    row["scenario"] = i  # renumbered to the query's view
                    mine.append(row)
                out.append(mine)
            return out
        # ksp: one source, union of destination sets
        merged_d = list(dict.fromkeys(d for q in queries for d in q.dests))
        source = queries[0].sources[0] if queries[0].sources else ""
        results = self.backend.run_ksp(
            batch.area,
            source,
            merged_d,
            k=queries[0].k,
            expect_epoch=batch.epoch,
        )
        return [{d: results.get(d, []) for d in q.dests} for q in queries]

    # -- shutdown ------------------------------------------------------------

    async def stopping(self) -> None:
        self._accepting = False
        self.admission.close()
        # fail everything still waiting in admission
        while True:
            try:
                pending = self.admission.try_get()
            except QueueClosedError:
                break
            if pending is None:
                break
            self._fail(pending, QueryShedError("scheduler stopping"))
        # and a staged-but-undispatched batch
        if self._staged is not None:
            while not self._staged.empty():
                batch = self._staged.get_nowait()
                for pending in batch.pendings:
                    self._fail(pending, QueryShedError("scheduler stopping"))

    def stop(self) -> None:
        self._accepting = False
        super().stop()
        # let an in-flight batch answer its callers, then fail any
        # stragglers: every admitted query resolves
        self._pool.shutdown(wait=True)
        with self._lock:
            leftovers = [p for p in self._inflight if not p.future.done()]
        for pending in leftovers:
            self._fail(pending, QueryShedError("scheduler stopped"))
