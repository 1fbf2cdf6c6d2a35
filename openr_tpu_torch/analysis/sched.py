"""OPENR_SCHED — deterministic schedule exploration (a DPOR model checker).

Port of `openr_tpu.analysis.sched`: the same controller, policies,
scenarios and schedule IDs over the port's runtime, whose queue and
event-base seams declare the same yield points, so a seed explores the
same schedules in both packages.

The OPENR_TSAN detector (race.py) reports a race only when the OS scheduler
happens to produce the buggy interleaving, and a chaos fuzzer searches
*fault timelines*, not *thread schedules*.  This module closes the
gap loom/shuttle-style: small concurrency scenarios run on real threads, but
every thread is serialized onto a single controlled scheduler whose yield
points are exactly the seams race.py already hooks —

    =====================  ==========================================
    yield point            TSAN HB-edge it mirrors
    =====================  ==========================================
    thread.start / join    fork / join token
    lock.acquire/release   TsanLock release -> acquire edge
    queue.push/get/close   RWQueue per-item put -> get token
    eventbase.submit       run_in_event_base_thread handoff wrap
    future.set / get       Future resolve -> result token
    mem (scenario cp)      tracked-attribute access vocabulary
    =====================  ==========================================

At each yield point the running task *declares* its pending operation
(kind, resource, read/write) and parks; the controller therefore always
knows every enabled task's next op, which makes op independence computable
and sleep-set DPOR (Godefroid) sound: a schedule prefix is pruned exactly
when every enabled candidate is asleep, i.e. provably leads only to
interleavings equivalent to ones already explored.

Every explored schedule is a replayable ID (`scenario[+plant]:s<seed>:c0.c1...`,
the choice string normalized to indices into the sorted enabled-candidate
list).  Choices are interpreted tolerantly (`c mod len(candidates)`, first
candidate once exhausted), so *any* subsequence of a failing choice string is
itself a valid schedule — which is what lets the choice-prefix ddmin shrinker
minimize failures by chunk removal.

Zero-overhead-off discipline matches OPENR_TSAN: the runtime seams read the
module constant ``SCHED`` (None unless a controller is mid-run) and branch on
``is not None``; no scheduler objects exist otherwise.  Arm exploration with
``OPENR_SCHED=1`` or ``python -m openr_tpu_torch.analysis --sched``.

This module imports the runtime lazily inside scenario builders to avoid
import cycles with runtime/queue.py, which imports it for its seams.
"""

from __future__ import annotations

import _thread
import concurrent.futures
import hashlib
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from . import race as _race

# ---------------------------------------------------------------------------
# arming (zero-overhead-off: seams read this one module constant)
# ---------------------------------------------------------------------------

# The active controller while a single schedule executes; None otherwise.
# Runtime seams (queue.py, eventbase.py, serving/) do a late-bound
# ``_sched.SCHED`` read and branch on ``is not None`` — one module-attribute
# load per seam when disarmed, exactly the TSAN standard.
SCHED: Optional["SchedController"] = None

_ENV_ARMED = os.environ.get("OPENR_SCHED", "") == "1"


def env_armed() -> bool:
    """True when OPENR_SCHED=1 was set at import (CLI implies --sched)."""
    return _ENV_ARMED


def budget_s(default: float = 20.0) -> float:
    """Session wall budget: OPENR_SCHED_BUDGET_S, else `default` seconds."""
    raw = os.environ.get("OPENR_SCHED_BUDGET_S", "")
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


# ---------------------------------------------------------------------------
# counters (sched.* family; pre-seeded zeros, wired as the ctrl handler's
# `sched` module so the family answers getCounters on both wire surfaces
# before any exploration ever runs)
# ---------------------------------------------------------------------------

SCHED_COUNTER_KEYS = (
    "sched.schedules_explored",
    "sched.dpor_prunes",
    "sched.replays",
    "sched.shrinks",
    "sched.planted_finds",
)


class SchedCounters:
    """Pre-seeded ``sched.*`` registry (module-level singleton below)."""

    def __init__(self) -> None:
        self.counters: dict[str, int] = {k: 0 for k in SCHED_COUNTER_KEYS}

    def get_counters(self) -> dict[str, int]:
        return dict(self.counters)

    def _bump(self, name: str, delta: int = 1) -> None:
        # underscore spelling: the counter-unbumped static rule recognizes
        # `*._bump("literal")` call sites
        self.counters[name] = self.counters.get(name, 0) + delta

    # public alias, the reference's API
    bump = _bump


SCHED_COUNTERS = SchedCounters()


class SchedInfraError(RuntimeError):
    """Checker-infrastructure failure (leaked thread, internal protocol
    violation) — maps to CLI exit 2, never to a finding."""


class _SchedAbort(BaseException):
    """Raised inside parked tasks to unwind them at run teardown; never a
    finding.  BaseException so scenario `except Exception` can't eat it."""


# ---------------------------------------------------------------------------
# pending-op vocabulary + independence (the DPOR side of the HB-edge table)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PendingOp:
    kind: str  # "queue.push" | "queue.get" | "queue.close" | "lock.acquire"
    #            | "lock.release" | "future.set" | "future.get" | "mem"
    #            | "eventbase.submit" | "thread.start" | "thread.join" | "begin"
    resource: str  # stable per-run label, e.g. "q:1", "lock:ledger", "fut:2"
    write: bool = True

    def sig(self) -> str:
        return f"{self.kind}({self.resource}{',w' if self.write else ',r'})"


def ops_dependent(a: PendingOp, b: PendingOp) -> bool:
    """Two ops commute unless they touch the same resource and at least one
    writes — the same vocabulary the TSAN detector derives HB edges from."""
    if a.kind == "begin" or b.kind == "begin":
        return False
    if a.resource != b.resource:
        return False
    return a.write or b.write


# ---------------------------------------------------------------------------
# controller: real threads, one token
# ---------------------------------------------------------------------------


class _Task:
    __slots__ = (
        "idx",
        "name",
        "fn",
        "thread",
        "go",
        "pending",
        "enabled_fn",
        "parked",
        "done",
        "error",
        "abort",
    )

    def __init__(self, idx: int, name: str, fn: Callable[[], Any]) -> None:
        self.idx = idx
        self.name = name
        self.fn = fn
        self.thread: Optional[threading.Thread] = None
        self.go = threading.Event()
        self.pending: Optional[PendingOp] = None
        self.enabled_fn: Optional[Callable[[], bool]] = None
        self.parked = False
        self.done = False
        self.error: Optional[BaseException] = None
        self.abort = False


class SchedController:
    """Serializes registered tasks onto one grant token.

    Tasks park at yield points after declaring their pending op; the run
    loop (driver thread) picks one enabled parked task per step via the
    policy, grants it, and waits for quiescence.  Threads the controller
    did not register (pytest's main thread, module daemons) pass through
    every seam untouched.
    """

    MAX_STEPS = 2000

    def __init__(self, decide: Callable[[list[tuple[int, PendingOp]]], int],
                 note_step: Optional[Callable[[list[tuple[int, PendingOp]], int], None]] = None,
                 max_steps: Optional[int] = None) -> None:
        self._decide = decide
        self._note_step = note_step
        self._tasks: list[_Task] = []
        self._tls = threading.local()
        self._mon = threading.Condition()
        self._labels: dict[int, str] = {}
        self._label_counts: dict[str, int] = {}
        self._keep: list[Any] = []  # pin labelled objects for the run
        self.max_steps = max_steps or self.MAX_STEPS
        self.steps = 0
        self.choices: list[int] = []  # normalized (only multi-candidate points)
        self.trace: list[tuple[str, str, str]] = []  # (task, kind, resource)
        self.failures: list[str] = []
        self.pruned = False
        self._aborting = False

    # -- registration (driver thread, before run) ---------------------------

    def add_task(self, name: str, fn: Callable[[], Any]) -> None:
        self._tasks.append(_Task(len(self._tasks), name, fn))

    def _label(self, obj: Any, prefix: str) -> str:
        lab = self._labels.get(id(obj))
        if lab is None:
            n = self._label_counts.get(prefix, 0) + 1
            self._label_counts[prefix] = n
            lab = f"{prefix}:{n}"
            self._labels[id(obj)] = lab
            self._keep.append(obj)
        return lab

    # -- task-side protocol -------------------------------------------------

    def _cur(self) -> Optional[_Task]:
        return getattr(self._tls, "task", None)

    def _yield(self, t: _Task, op: PendingOp,
               enabled: Optional[Callable[[], bool]] = None) -> None:
        t.pending = op
        t.enabled_fn = enabled
        t.go.clear()
        # abort handshake: _abort_parked sets t.abort BEFORE t.go.set(), so
        # either the clear above erased a set we can still observe via
        # t.abort here, or the set lands after and go.wait() sees it sticky
        if self._aborting or t.abort:
            raise _SchedAbort()
        with self._mon:
            t.parked = True
            self._mon.notify_all()
        t.go.wait()
        if self._aborting or t.abort:
            raise _SchedAbort()
        t.pending = None
        t.enabled_fn = None

    def _task_body(self, t: _Task) -> None:
        self._tls.task = t
        try:
            # initial park: "begin" is independent of everything, so DPOR
            # never wastes schedules permuting pure task starts
            self._yield(t, PendingOp("begin", f"task:{t.idx}", False))
            t.fn()
        except _SchedAbort:
            pass
        except BaseException as e:  # noqa: BLE001 — any escape is a finding
            t.error = e
        finally:
            with self._mon:
                t.done = True
                t.parked = False
                self._mon.notify_all()

    # -- seam API (called from runtime modules through the SCHED constant) --

    def controls_current_thread(self) -> bool:
        return self._cur() is not None

    def queue_op(self, q: Any, kind: str) -> None:
        """Non-blocking queue op (push / try_get / close): one yield point."""
        t = self._cur()
        if t is None:
            return
        self._yield(t, PendingOp(kind, self._label(q, "q"), True))

    def queue_get_gate(self, q: Any, ready: Callable[[], bool]) -> bool:
        """Blocking-get gate: park until an item is available or the queue
        is closed.  Returns True iff the calling thread is controlled —
        the caller must then take its non-blocking pop path (the real
        cond.wait would block the whole serialized world)."""
        t = self._cur()
        if t is None:
            return False
        self._yield(t, PendingOp("queue.get", self._label(q, "q"), True),
                    enabled=ready)
        return True

    def handoff(self, eb: Any) -> None:
        """Eventbase cross-thread submit (run_in_event_base_thread /
        add_fiber_task / schedule_timeout marshalling)."""
        t = self._cur()
        if t is None:
            return
        self._yield(t, PendingOp("eventbase.submit", self._label(eb, "eb"), True))

    def region(self, point: str) -> None:
        """Named interleaving-sensitive region in product code (serving
        admission, ledger close): a plain mem-write yield point."""
        t = self._cur()
        if t is None:
            return
        self._yield(t, PendingOp("mem", f"mem:{point}", True))

    def mem(self, resource: str, write: bool = True) -> None:
        """Scenario checkpoint: declare the next shared-memory access."""
        t = self._cur()
        if t is None:
            return
        self._yield(t, PendingOp("mem", f"mem:{resource}", write))

    def future_set(self, fut: Any) -> None:
        t = self._cur()
        if t is None:
            return
        self._yield(t, PendingOp("future.set", self._label(fut, "fut"), True))

    def future_get_gate(self, fut: Any) -> bool:
        t = self._cur()
        if t is None:
            return False
        self._yield(t, PendingOp("future.get", self._label(fut, "fut"), False),
                    enabled=fut.done)
        return True

    def thread_start(self, th: Any) -> None:
        t = self._cur()
        if t is None:
            return
        self._yield(t, PendingOp("thread.start", self._label(th, "th"), True))

    def thread_join_gate(self, th: Any) -> bool:
        t = self._cur()
        if t is None:
            return False
        self._yield(t, PendingOp("thread.join", self._label(th, "th"), False),
                    enabled=lambda: not th.is_alive())
        return True

    # -- driver-side run loop ----------------------------------------------

    def _wait_quiescent(self) -> None:
        deadline = time.monotonic() + 30.0
        with self._mon:
            while not all(t.parked or t.done for t in self._tasks):
                if not self._mon.wait(timeout=1.0) and time.monotonic() > deadline:
                    raise SchedInfraError(
                        "controller hang: a task neither parked nor exited "
                        "(blocking call outside the seam vocabulary?)"
                    )

    def _enabled(self, t: _Task) -> bool:
        if t.enabled_fn is None:
            return True
        try:
            return bool(t.enabled_fn())
        except Exception:  # noqa: BLE001 — let the op itself raise on grant
            return True

    def _abort_parked(self) -> None:
        self._aborting = True
        for t in self._tasks:
            if not t.done:
                t.abort = True
                t.go.set()
        for t in self._tasks:
            if t.thread is not None:
                t.thread.join(timeout=5.0)
                if t.thread.is_alive():
                    raise SchedInfraError(f"leaked task thread: {t.name}")

    def run(self) -> None:
        global SCHED
        if SCHED is not None:
            raise SchedInfraError("nested schedule execution")
        SCHED = self
        error: Optional[BaseException] = None
        try:
            for t in self._tasks:
                t.thread = threading.Thread(
                    target=self._task_body, args=(t,),
                    name=f"sched-{t.name}", daemon=True,
                )
                t.thread.start()
            self._wait_quiescent()
            while True:
                live = [t for t in self._tasks if not t.done]
                if not live:
                    break
                enabled = [t for t in live if t.parked and self._enabled(t)]
                if not enabled:
                    waiting = ", ".join(
                        f"{t.name}@{t.pending.sig() if t.pending else '?'}"
                        for t in live
                    )
                    self.failures.append(f"deadlock: all tasks blocked [{waiting}]")
                    break
                self.steps += 1
                if self.steps > self.max_steps:
                    self.failures.append(
                        f"livelock: step budget ({self.max_steps}) exceeded"
                    )
                    break
                ops = [(t.idx, t.pending) for t in enabled]
                k = self._decide(ops)
                if k < 0:  # policy pruned this branch (sleep-set redundant)
                    self.pruned = True
                    break
                if len(ops) >= 2:
                    self.choices.append(k)
                chosen = enabled[k]
                op = chosen.pending
                self.trace.append((chosen.name, op.kind, op.resource))
                if self._note_step is not None:
                    self._note_step(ops, k)
                with self._mon:
                    chosen.parked = False
                chosen.go.set()
                self._wait_quiescent()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            error = e
        SCHED = None
        try:
            self._abort_parked()
        except SchedInfraError as e:
            if error is None:
                error = e
        if error is not None:
            raise error
        for t in self._tasks:
            if t.error is not None:
                self.failures.append(f"exception: {t.name}: {t.error!r}")
        det = _race.TSAN
        if det is not None:
            for finding in det.drain():
                self.failures.append(f"race: {finding}")


class SchedLock:
    """Scenario lock with the TsanLock seam vocabulary: acquire parks until
    the lock is free (enabledness, never a real block), release is its own
    yield point, so a task can park *while holding* the lock and the
    explorer sees every critical-section interleaving."""

    def __init__(self, controller: SchedController, name: str) -> None:
        self._c = controller
        self._labelname = f"lock:{name}"
        self._owner: Optional[_Task] = None

    def acquire(self) -> None:
        t = self._c._cur()
        if t is None:  # driver-side (build/check): serialized, just take it
            self._owner = None
            return
        self._c._yield(t, PendingOp("lock.acquire", self._labelname, True),
                       enabled=lambda: self._owner is None)
        self._owner = t

    def release(self) -> None:
        t = self._c._cur()
        if t is None:
            self._owner = None
            return
        self._c._yield(t, PendingOp("lock.release", self._labelname, True))
        self._owner = None

    def __enter__(self) -> "SchedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()


# ---------------------------------------------------------------------------
# runtime patches (Future resolve/await, Thread start/join) — installed only
# while a session runs, refcounted, restored on exit; race.py discipline
# ---------------------------------------------------------------------------

_SAVED: dict[str, Any] = {}
_PATCH_DEPTH = 0
# from _thread: a threading.Lock taken while a race detector is armed
# would be its proxy
_PATCH_LOCK = _thread.allocate_lock()


def _patched_set_result(self, value):  # type: ignore[no-untyped-def]
    sc = SCHED
    if sc is not None:
        sc.future_set(self)
    return _SAVED["future.set_result"](self, value)


def _patched_set_exception(self, exc):  # type: ignore[no-untyped-def]
    sc = SCHED
    if sc is not None:
        sc.future_set(self)
    return _SAVED["future.set_exception"](self, exc)


def _patched_result(self, timeout=None):  # type: ignore[no-untyped-def]
    sc = SCHED
    if sc is not None and sc.future_get_gate(self):
        return _SAVED["future.result"](self, 0)
    return _SAVED["future.result"](self, timeout)


def _patched_exception(self, timeout=None):  # type: ignore[no-untyped-def]
    sc = SCHED
    if sc is not None and sc.future_get_gate(self):
        return _SAVED["future.exception"](self, 0)
    return _SAVED["future.exception"](self, timeout)


def _patched_thread_start(self):  # type: ignore[no-untyped-def]
    sc = SCHED
    if sc is not None:
        sc.thread_start(self)
    return _SAVED["thread.start"](self)


def _patched_thread_join(self, timeout=None):  # type: ignore[no-untyped-def]
    sc = SCHED
    if sc is not None and sc.thread_join_gate(self):
        return _SAVED["thread.join"](self, 0)
    return _SAVED["thread.join"](self, timeout)


def _install_patches() -> None:
    global _PATCH_DEPTH
    with _PATCH_LOCK:
        _PATCH_DEPTH += 1
        if _PATCH_DEPTH > 1:
            return
        fut = concurrent.futures.Future
        _SAVED["future.set_result"] = fut.set_result
        _SAVED["future.set_exception"] = fut.set_exception
        _SAVED["future.result"] = fut.result
        _SAVED["future.exception"] = fut.exception
        _SAVED["thread.start"] = threading.Thread.start
        _SAVED["thread.join"] = threading.Thread.join
        fut.set_result = _patched_set_result  # type: ignore[method-assign]
        fut.set_exception = _patched_set_exception  # type: ignore[method-assign]
        fut.result = _patched_result  # type: ignore[method-assign]
        fut.exception = _patched_exception  # type: ignore[method-assign]
        threading.Thread.start = _patched_thread_start  # type: ignore[method-assign]
        threading.Thread.join = _patched_thread_join  # type: ignore[method-assign]


def _remove_patches() -> None:
    global _PATCH_DEPTH
    with _PATCH_LOCK:
        _PATCH_DEPTH -= 1
        if _PATCH_DEPTH > 0:
            return
        fut = concurrent.futures.Future
        fut.set_result = _SAVED.pop("future.set_result")  # type: ignore[method-assign]
        fut.set_exception = _SAVED.pop("future.set_exception")  # type: ignore[method-assign]
        fut.result = _SAVED.pop("future.result")  # type: ignore[method-assign]
        fut.exception = _SAVED.pop("future.exception")  # type: ignore[method-assign]
        threading.Thread.start = _SAVED.pop("thread.start")  # type: ignore[method-assign]
        threading.Thread.join = _SAVED.pop("thread.join")  # type: ignore[method-assign]


def patches_installed() -> bool:
    return _PATCH_DEPTH > 0


# ---------------------------------------------------------------------------
# scheduling policies
# ---------------------------------------------------------------------------


class _ReplayPolicy:
    """Tolerant choice-string interpretation: the i-th *multi-candidate*
    decision point consumes choices[i] mod len(candidates); exhausted
    choices fall back to the first candidate.  Any subsequence of a valid
    choice string is therefore itself a valid schedule (ddmin fuel)."""

    def __init__(self, choices: list[int]) -> None:
        self._choices = choices
        self._ci = 0

    def decide(self, ops: list[tuple[int, PendingOp]]) -> int:
        if len(ops) < 2:
            return 0
        if self._ci < len(self._choices):
            k = self._choices[self._ci] % len(ops)
            self._ci += 1
            return k
        return 0


class _RandomPolicy:
    """Uniform random walk over enabled candidates (seeded)."""

    def __init__(self, rng: random.Random) -> None:
        self._rng = rng

    def decide(self, ops: list[tuple[int, PendingOp]]) -> int:
        return 0 if len(ops) < 2 else self._rng.randrange(len(ops))


class _POSPolicy:
    """Partial-order sampling: random task priorities; after each executed
    op, every candidate whose pending op is dependent with it gets a fresh
    priority.  Covers racy pairs far better than the uniform walk."""

    def __init__(self, rng: random.Random) -> None:
        self._rng = rng
        self._prio: dict[int, float] = {}

    def _p(self, idx: int) -> float:
        if idx not in self._prio:
            self._prio[idx] = self._rng.random()
        return self._prio[idx]

    def decide(self, ops: list[tuple[int, PendingOp]]) -> int:
        if len(ops) < 2:
            return 0
        best = max(range(len(ops)), key=lambda j: self._p(ops[j][0]))
        return best

    def note_step(self, ops: list[tuple[int, PendingOp]], k: int) -> None:
        executed = ops[k][1]
        for idx, op in ops:
            if idx != ops[k][0] and ops_dependent(op, executed):
                self._prio[idx] = self._rng.random()


class _ExplorerPolicy:
    """Sleep-set DPOR node executor.

    Replays a forced choice prefix (the node address), then continues
    first-awake, generating one backtrack point per awake sibling at every
    multi-candidate step, each with the sleep set the sleep-set algorithm
    prescribes: Z(child_d) = {u in sleep ∪ done-siblings | op(u) indep op(d)}.
    If every enabled candidate is asleep the whole branch is provably
    redundant and the run aborts (decide -> -1)."""

    def __init__(self, forced: list[int], entry_sleep: dict[int, PendingOp],
                 indep: Callable[[PendingOp, PendingOp], bool]) -> None:
        self._forced = forced
        self._entry_sleep = entry_sleep
        self._indep = indep
        self._ci = 0
        self._choices: list[int] = []  # normalized, mirrors controller
        self._sleep: Optional[dict[int, PendingOp]] = (
            dict(entry_sleep) if not forced else None
        )
        self.branch_points: list[tuple[list[int], dict[int, PendingOp]]] = []
        self.sleep_skips = 0  # enabled-but-sleeping candidates skipped

    def decide(self, ops: list[tuple[int, PendingOp]]) -> int:
        multi = len(ops) >= 2
        if self._sleep is None:  # still replaying the forced prefix
            if not multi:
                return 0
            k = self._forced[self._ci] % len(ops)
            self._ci += 1
            if self._ci == len(self._forced):
                pass  # sleep activates in note_step after this op executes
            self._choices.append(k)
            return k
        awake = [j for j, (idx, _op) in enumerate(ops) if idx not in self._sleep]
        if not awake:
            return -1  # sleep-set prune: subtree redundant
        k = awake[0]
        if multi:
            self.sleep_skips += len(ops) - len(awake)
            done: list[tuple[int, PendingOp]] = [ops[k]]
            for j in awake[1:]:
                idx_j, op_j = ops[j]
                base = dict(self._sleep)
                for didx, dop in done:
                    base[didx] = dop
                child_sleep = {
                    u: uop for u, uop in base.items() if self._indep(uop, op_j)
                }
                self.branch_points.append((self._choices + [j], child_sleep))
                done.append(ops[j])
            self._choices.append(k)
        return k

    def note_step(self, ops: list[tuple[int, PendingOp]], k: int) -> None:
        executed = ops[k][1]
        if self._sleep is None:
            if self._ci == len(self._forced):
                # the last forced choice just executed: enter explore mode
                # with the sleep set the parent computed for this node
                self._sleep = dict(self._entry_sleep)
            return
        # wake every sleeper whose op is dependent with the executed op
        self._sleep = {
            u: uop for u, uop in self._sleep.items()
            if self._indep(uop, executed)
        }


# ---------------------------------------------------------------------------
# scenario library
# ---------------------------------------------------------------------------


class SchedWorld:
    """Scenario construction surface: tasks, seam-aware primitives, and the
    `cp()` checkpoint that declares a shared-memory access as a yield point
    (the tracked-attribute analog of race.py's __setattr__ hook)."""

    def __init__(self, controller: SchedController) -> None:
        self._c = controller
        self.state: dict[str, Any] = {}

    def task(self, name: str, fn: Callable[[], Any]) -> None:
        self._c.add_task(name, fn)

    def lock(self, name: str = "L") -> SchedLock:
        return SchedLock(self._c, name)

    def queue(self, maxlen: Optional[int] = None,
              on_shed: Optional[Callable[[Any], None]] = None) -> Any:
        from ..runtime.queue import RWQueue  # lazy: queue.py imports us

        return RWQueue(maxlen=maxlen, on_shed=on_shed)

    def future(self) -> "concurrent.futures.Future[Any]":
        return concurrent.futures.Future()

    def cp(self, resource: str, write: bool = True) -> None:
        self._c.mem(resource, write)


@dataclass
class Scenario:
    name: str
    build: Callable[[SchedWorld, bool], Callable[[], list[str]]]
    plantable: bool = False


SCENARIOS: dict[str, Scenario] = {}

# The two structurally smallest scenarios: explored exhaustively (with an
# exhaustiveness certificate) at tier-1 budget; the rest are sampled.
EXHAUSTIVE_SCENARIOS = ("router_hedge_vs_death", "queue_shed_vs_carry")


def _scenario(name: str, plantable: bool = False):
    def deco(build: Callable[[SchedWorld, bool], Callable[[], list[str]]]):
        SCENARIOS[name] = Scenario(name, build, plantable)
        return build

    return deco


@_scenario("coalescer_fanin")
def _sc_coalescer_fanin(world: SchedWorld, plant: bool):
    """Coalescer fan-in vs flap invalidation: two flapping producers write
    truth then notify; the coalescer must re-read truth per notification
    (apply-latest), never the stale value captured at notify time."""
    q = world.queue()
    truth: dict[str, int] = {}
    applied: dict[str, int] = {}
    consumed: list[str] = []

    def flapper(val: int) -> Callable[[], None]:
        def run() -> None:
            world.cp("truth", write=True)
            truth["a"] = val
            q.push("a")

        return run

    def coalescer() -> None:
        for _ in range(2):
            key = q.get()
            world.cp("truth", write=False)
            applied[key] = truth[key]
            consumed.append(key)

    world.task("flap1", flapper(1))
    world.task("flap2", flapper(2))
    world.task("coalescer", coalescer)

    def check() -> list[str]:
        fails = []
        if len(consumed) != 2:
            fails.append(f"lost-notification: consumed {len(consumed)}/2")
        if applied.get("a") != truth.get("a"):
            fails.append(
                f"stale-apply: applied={applied.get('a')} truth={truth.get('a')}"
            )
        return fails

    return check


@_scenario("queue_shed_vs_carry")
def _sc_queue_shed_vs_carry(world: SchedWorld, plant: bool):
    """Bounded-queue shed vs per-item carry: drop-oldest overflow must
    conserve items (received + shed == pushed) and preserve order."""
    from ..runtime.queue import QueueClosedError  # lazy

    shed: list[int] = []
    received: list[int] = []
    q = world.queue(maxlen=1, on_shed=shed.append)

    def producer() -> None:
        for i in range(3):
            q.push(i)
        q.close()

    def consumer() -> None:
        while True:
            try:
                received.append(q.get())
            except QueueClosedError:
                return

    world.task("producer", producer)
    world.task("consumer", consumer)

    def check() -> list[str]:
        fails = []
        if sorted(received + shed) != [0, 1, 2]:
            fails.append(f"silent-drop: received={received} shed={shed}")
        if received != sorted(received):
            fails.append(f"reorder: received={received}")
        return fails

    return check


@_scenario("router_hedge_vs_death", plantable=True)
def _sc_router_hedge_vs_death(world: SchedWorld, plant: bool):
    """Router hedge vs replica death: two completion paths (primary reply,
    hedged replica dying) both close the dispatch ledger.  The planted
    variant drops the ledger lock, exposing the classic read-modify-write
    lost update the explorer must find, shrink, and replay."""
    ledger = {"submitted": 2, "replied": 0}
    lock = world.lock("ledger")
    fut_primary = world.future()
    fut_hedge = world.future()

    def completion(fut: Any, ok: bool) -> Callable[[], None]:
        def close_ledger() -> None:
            world.cp("ledger", write=False)
            r = ledger["replied"]
            world.cp("ledger", write=True)
            ledger["replied"] = r + 1

        def run() -> None:
            if plant:
                close_ledger()  # planted: unlocked read-modify-write
            else:
                with lock:
                    close_ledger()
            if ok:
                fut.set_result("reply")
            else:
                fut.set_exception(RuntimeError("replica died"))

        return run

    world.task("primary", completion(fut_primary, True))
    world.task("death", completion(fut_hedge, False))

    def check() -> list[str]:
        fails = []
        if ledger["replied"] != ledger["submitted"]:
            fails.append(
                "ledger-lost-update: replied="
                f"{ledger['replied']} submitted={ledger['submitted']}"
            )
        if not (fut_primary.done() and fut_hedge.done()):
            fails.append("unresolved-future")
        return fails

    return check


@_scenario("delta_order_vs_demotion")
def _sc_delta_order_vs_demotion(world: SchedWorld, plant: bool):
    """Delta-coalescer ordering vs full-rebuild demotion: incremental
    deltas apply monotonically; a full rebuild snapshots truth.  FIFO
    consumption must leave the view at truth no matter how the demotion
    interleaves with in-flight deltas."""
    q = world.queue()
    truth = {"ver": 0}
    view = {"ver": 0}

    def producer() -> None:
        for v in (1, 2):
            world.cp("truth", write=True)
            truth["ver"] = v
            q.push(("delta", v))

    def demoter() -> None:
        q.push(("full", None))

    def consumer() -> None:
        for _ in range(3):
            kind, v = q.get()
            if kind == "delta":
                world.cp("view", write=True)
                if v > view["ver"]:
                    view["ver"] = v
            else:
                world.cp("truth", write=False)
                world.cp("view", write=True)
                view["ver"] = truth["ver"]

    world.task("producer", producer)
    world.task("demoter", demoter)
    world.task("consumer", consumer)

    def check() -> list[str]:
        if view["ver"] != truth["ver"]:
            return [f"demotion-regressed-view: view={view['ver']} truth={truth['ver']}"]
        return []

    return check


@_scenario("eventbase_stop_vs_timeout")
def _sc_eventbase_stop_vs_timeout(world: SchedWorld, plant: bool):
    """Eventbase stop vs pending timeout: the loop drains its callback
    queue on close (queue close-drains), and a submit that loses the race
    with stop must account the callback cancelled — never silently drop."""
    from ..runtime.queue import QueueClosedError  # lazy

    cbq = world.queue()
    ran: list[str] = []
    cancelled: list[str] = []
    fired = world.future()

    def loop() -> None:
        while True:
            try:
                fn = cbq.get()
            except QueueClosedError:
                return
            fn()

    def submitter() -> None:
        def timeout_cb() -> None:
            ran.append("timeout")
            fired.set_result(True)

        if not cbq.push(timeout_cb):
            cancelled.append("timeout")
            fired.set_exception(RuntimeError("eventbase stopped"))

    def stopper() -> None:
        cbq.close()

    world.task("loop", loop)
    world.task("submitter", submitter)
    world.task("stopper", stopper)

    def check() -> list[str]:
        fails = []
        if not fired.done():
            fails.append("silent-drop: timeout neither fired nor cancelled")
        if len(ran) + len(cancelled) != 1:
            fails.append(f"double-account: ran={ran} cancelled={cancelled}")
        return fails

    return check


@_scenario("kvstore_merge_vs_ttl")
def _sc_kvstore_merge_vs_ttl(world: SchedWorld, plant: bool):
    """KvStore merge vs TTL expiry, driving the real CRDT merge: expiry
    captures a generation, re-validates under the lock before deleting —
    a newer merged value must never be killed by a stale expiry."""
    from ..kvstore.kvstore import merge_key_values  # lazy
    from ..types import Value  # lazy

    store = {"k": Value(version=1, originator_id="n1", value=b"v1")}
    lock = world.lock("store")
    accepted: dict[str, Value] = {}
    expiry = {"captured": None, "deleted": False}

    def merger() -> None:
        with lock:
            world.cp("store", write=True)
            delta = merge_key_values(
                store, {"k": Value(version=2, originator_id="n1", value=b"v2")}
            )
            accepted.update(delta)

    def expirer() -> None:
        with lock:
            world.cp("store", write=False)
            snap = store.get("k")
            gen = (snap.version, snap.ttl_version) if snap else None
        expiry["captured"] = gen
        # the expiry decision and the delete are separate critical
        # sections: the merge may land in between (the race under test)
        with lock:
            world.cp("store", write=True)
            cur = store.get("k")
            if cur is not None and gen == (cur.version, cur.ttl_version):
                del store["k"]
                expiry["deleted"] = True

    world.task("merger", merger)
    world.task("expirer", expirer)

    def check() -> list[str]:
        fails = []
        if accepted.get("k") is None or accepted["k"].version != 2:
            fails.append(f"merge-rejected: accepted={accepted}")
        if "k" not in store and expiry["captured"] == (1, 0):
            fails.append("stale-expiry-killed-newer: v2 deleted by v1 expiry")
        return fails

    return check


@_scenario("engine_rewire_vs_sync")
def _sc_engine_rewire_vs_sync(world: SchedWorld, plant: bool):
    """Engine rewire-chain replay vs concurrent sync: sync validates its
    snapshot with an epoch re-read (seqlock discipline); a torn snapshot
    (chain length disagreeing with the epoch) is the finding."""
    chain: list[tuple[str, int]] = []
    epoch = {"n": 0}
    lock = world.lock("engine")
    snaps: list[tuple[int, int]] = []

    def rewire() -> None:
        for i in range(2):
            with lock:
                world.cp("engine", write=True)
                chain.append(("rewire", i))
                epoch["n"] += 1

    def sync() -> None:
        for _ in range(3):
            with lock:
                world.cp("engine", write=False)
                e1 = epoch["n"]
                replayed = len(chain)
            with lock:
                world.cp("engine", write=False)
                e2 = epoch["n"]
            if e1 == e2:
                snaps.append((e1, replayed))
                return
        with lock:
            world.cp("engine", write=False)
            snaps.append((epoch["n"], len(chain)))

    world.task("rewire", rewire)
    world.task("sync", sync)

    def check() -> list[str]:
        fails = []
        if not snaps:
            fails.append("sync-never-completed")
        elif snaps[-1][0] != snaps[-1][1]:
            fails.append(f"torn-snapshot: epoch={snaps[-1][0]} replayed={snaps[-1][1]}")
        if epoch["n"] != 2 or len(chain) != 2:
            fails.append(f"lost-rewire: epoch={epoch['n']} chain={len(chain)}")
        return fails

    return check


@_scenario("sched_shutdown_vs_future")
def _sc_sched_shutdown_vs_future(world: SchedWorld, plant: bool):
    """Scheduler shutdown vs in-flight future: the admission check and the
    enqueue race with the stop latch; whichever way it lands, the caller's
    future must resolve exactly once (reply or shed) — never hang."""
    from ..runtime.queue import QueueClosedError  # lazy

    q = world.queue()
    flags = {"accepting": True}
    fut = world.future()

    def worker() -> None:
        while True:
            try:
                f = q.get()
            except QueueClosedError:
                return
            f.set_result("ok")

    def submitter() -> None:
        world.cp("accepting", write=False)
        if flags["accepting"]:
            if not q.push(fut):
                fut.set_exception(RuntimeError("shed: queue closed"))
        else:
            fut.set_exception(RuntimeError("shed: draining"))

    def stopper() -> None:
        world.cp("accepting", write=True)
        flags["accepting"] = False
        q.close()

    world.task("worker", worker)
    world.task("submitter", submitter)
    world.task("stopper", stopper)

    def check() -> list[str]:
        if not fut.done():
            return ["hung-future: submit neither replied nor shed"]
        return []

    return check


# ---------------------------------------------------------------------------
# execution, replay IDs, exploration, shrinking
# ---------------------------------------------------------------------------


@dataclass
class RunResult:
    scenario: str
    plant: bool
    choices: list[int]
    trace: tuple[tuple[str, str, str], ...]
    failures: list[str]
    pruned: bool
    steps: int

    def trace_fingerprint(self) -> str:
        h = hashlib.sha1(repr(self.trace).encode()).hexdigest()
        return h[:12]


def choice_fingerprint(scenario: str, choices: list[int]) -> str:
    raw = f"{scenario}:{'.'.join(map(str, choices))}"
    return hashlib.sha1(raw.encode()).hexdigest()[:10]


def format_schedule_id(scenario: str, seed: int, choices: list[int],
                       plant: bool = False) -> str:
    name = f"{scenario}+plant" if plant else scenario
    body = ".".join(map(str, choices)) if choices else "-"
    return f"{name}:s{seed}:{body}"


def parse_schedule_id(sid: str) -> tuple[str, bool, int, list[int]]:
    try:
        name, seed_s, body = sid.split(":", 2)
        plant = name.endswith("+plant")
        if plant:
            name = name[: -len("+plant")]
        seed = int(seed_s.lstrip("s"))
        choices = [] if body == "-" else [int(c) for c in body.split(".")]
    except (ValueError, AttributeError) as e:
        raise ValueError(f"malformed schedule id {sid!r}") from e
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario in schedule id: {name!r}")
    return name, plant, seed, choices


def _execute(scenario: str, plant: bool, policy: Any,
             max_steps: Optional[int] = None) -> RunResult:
    sc = SCENARIOS[scenario]
    _install_patches()
    try:
        controller = SchedController(
            policy.decide, getattr(policy, "note_step", None), max_steps
        )
        world = SchedWorld(controller)
        check = sc.build(world, plant)
        if not controller._tasks:
            raise SchedInfraError(f"scenario {scenario} registered no tasks")
        controller.run()
        failures = list(controller.failures)
        if not controller.pruned:
            failures.extend(check())
        return RunResult(
            scenario=scenario,
            plant=plant,
            choices=list(controller.choices),
            trace=tuple(controller.trace),
            failures=failures,
            pruned=controller.pruned,
            steps=controller.steps,
        )
    finally:
        _remove_patches()


def run_schedule(scenario: str, choices: list[int],
                 plant: bool = False) -> RunResult:
    """Execute one schedule from its normalized choice string."""
    return _execute(scenario, plant, _ReplayPolicy(list(choices)))


def replay_schedule(sid: str) -> RunResult:
    """Replay a schedule ID bit-identically (same choices -> same trace)."""
    scenario, plant, _seed, choices = parse_schedule_id(sid)
    SCHED_COUNTERS._bump("sched.replays")
    return run_schedule(scenario, choices, plant)


@dataclass
class ScheduleFailure:
    schedule_id: str
    choices: list[int]
    failures: list[str]
    trace_fingerprint: str


@dataclass
class ExploreResult:
    scenario: str
    plant: bool
    seed: int
    mode: str  # "dpor" | "naive" | "random" | "pos"
    schedules: int = 0
    prunes: int = 0
    complete: bool = False
    failures: list[ScheduleFailure] = field(default_factory=list)
    coverage_tokens: set[str] = field(default_factory=set)
    elapsed_s: float = 0.0


def explore(scenario: str, *, plant: bool = False, seed: int = 0,
            mode: str = "dpor", max_schedules: int = 5000,
            wall_budget_s: float = 30.0, max_failures: int = 10) -> ExploreResult:
    """Systematically (dpor/naive) or stochastically (random/pos) explore a
    scenario's interleavings.  `complete=True` is the exhaustiveness
    certificate: the DPOR (or naive) frontier drained within budget."""
    if scenario not in SCENARIOS:
        raise SchedInfraError(f"unknown scenario: {scenario}")
    res = ExploreResult(scenario=scenario, plant=plant, seed=seed, mode=mode)
    t0 = time.monotonic()

    def out_of_budget() -> bool:
        return (
            res.schedules >= max_schedules
            or time.monotonic() - t0 > wall_budget_s
        )

    def record(run: RunResult) -> None:
        res.schedules += 1
        SCHED_COUNTERS._bump("sched.schedules_explored")
        res.coverage_tokens.add(
            f"sched:{scenario}:{choice_fingerprint(scenario, run.choices)}"
        )
        if run.failures and len(res.failures) < max_failures:
            res.failures.append(
                ScheduleFailure(
                    schedule_id=format_schedule_id(scenario, seed, run.choices, plant),
                    choices=list(run.choices),
                    failures=list(run.failures),
                    trace_fingerprint=run.trace_fingerprint(),
                )
            )
            if plant:
                SCHED_COUNTERS._bump("sched.planted_finds")

    if mode in ("dpor", "naive"):
        indep = (
            (lambda a, b: not ops_dependent(a, b))
            if mode == "dpor"
            else (lambda a, b: False)
        )
        stack: list[tuple[list[int], dict[int, PendingOp]]] = [([], {})]
        while stack:
            if out_of_budget():
                res.complete = False
                break
            forced, entry_sleep = stack.pop()
            policy = _ExplorerPolicy(forced, entry_sleep, indep)
            run = _execute(scenario, plant, policy)
            if run.pruned:
                res.prunes += 1
                SCHED_COUNTERS._bump("sched.dpor_prunes")
            else:
                res.prunes += policy.sleep_skips
                SCHED_COUNTERS._bump("sched.dpor_prunes", policy.sleep_skips)
                record(run)
            # LIFO: depth-first over the reduced tree; sibling sleep sets
            # were precomputed at push time so pop order is irrelevant
            stack.extend(reversed(policy.branch_points))
        else:
            res.complete = True
    elif mode in ("random", "pos"):
        rng = random.Random(seed)
        while not out_of_budget():
            policy = (
                _RandomPolicy(random.Random(rng.randrange(2**31)))
                if mode == "random"
                else _POSPolicy(random.Random(rng.randrange(2**31)))
            )
            record(_execute(scenario, plant, policy))
        res.complete = False
    else:
        raise SchedInfraError(f"unknown exploration mode: {mode}")
    res.elapsed_s = time.monotonic() - t0
    return res


def _failure_signature(failures: list[str]) -> frozenset:
    """Failure identity for shrinking: the set of failure kinds (text up to
    the first ':'), so a shrunk schedule counts iff it fails the same way."""
    return frozenset(f.split(":", 1)[0] for f in failures)


def shrink_schedule(scenario: str, choices: list[int], plant: bool = False,
                    max_steps: int = 400) -> tuple[list[int], RunResult]:
    """Choice-prefix ddmin over choice lists: remove chunks at halving granularity, then zero surviving choices.
    Tolerant interpretation makes every candidate subsequence executable."""
    base = run_schedule(scenario, list(choices), plant)
    if not base.failures:
        raise SchedInfraError("shrink_schedule: schedule does not fail")
    want = _failure_signature(base.failures)
    budget = [max_steps]

    def violates(cand: list[int]) -> Optional[RunResult]:
        if budget[0] <= 0:
            return None
        budget[0] -= 1
        SCHED_COUNTERS._bump("sched.shrinks")
        run = run_schedule(scenario, cand, plant)
        return run if _failure_signature(run.failures) & want else None

    cur = list(choices)
    best = base
    # pass 1: ddmin chunk removal
    gran = max(1, len(cur) // 2)
    while gran >= 1 and budget[0] > 0:
        i = 0
        reduced = False
        while i < len(cur) and budget[0] > 0:
            cand = cur[:i] + cur[i + gran:]
            run = violates(cand)
            if run is not None:
                cur, best, reduced = cand, run, True
            else:
                i += gran
        if not reduced:
            if gran == 1:
                break
            gran = max(1, gran // 2)
    # pass 2: zero each surviving choice (smaller ids replay first-enabled)
    for i in range(len(cur)):
        if cur[i] == 0 or budget[0] <= 0:
            continue
        cand = cur[:i] + [0] + cur[i + 1:]
        run = violates(cand)
        if run is not None:
            cur, best = cand, run
    return cur, best


# ---------------------------------------------------------------------------
# tier-1 smoke, fuzz coverage feed, CLI
# ---------------------------------------------------------------------------


def tier1_smoke(total_budget_s: Optional[float] = None,
                seed: int = 0) -> dict[str, Any]:
    """The budgeted library sweep tier-1 runs: exhaustive DPOR (with
    certificate) on the two smallest scenarios, POS sampling on the rest.
    Honors OPENR_SCHED_BUDGET_S; sheds loudly, never silently."""
    total = budget_s(20.0) if total_budget_s is None else total_budget_s
    t0 = time.monotonic()
    names = list(SCENARIOS)
    out: dict[str, Any] = {
        "scenarios": {},
        "failures": [],
        "shed": [],
        "budget_s": total,
    }
    for name in names:
        left = total - (time.monotonic() - t0)
        if left <= 0:
            out["shed"].append(name)
            continue
        if name in EXHAUSTIVE_SCENARIOS:
            r = explore(name, seed=seed, mode="dpor",
                        wall_budget_s=min(left, total / 2))
        else:
            r = explore(name, seed=seed, mode="pos", max_schedules=40,
                        wall_budget_s=min(left, total / 6))
        out["scenarios"][name] = {
            "mode": r.mode,
            "schedules": r.schedules,
            "prunes": r.prunes,
            "complete": r.complete,
            "elapsed_s": round(r.elapsed_s, 3),
        }
        for f in r.failures:
            out["failures"].append(
                {"schedule_id": f.schedule_id, "failures": f.failures}
            )
    return out


def sample_tokens(seed: int, n_schedules: int = 8,
                  scenarios: Optional[list[str]] = None) -> set[str]:
    """Cheap random-walk batch for a chaos fuzzer's coverage map: returns
    `sched:<scenario>:<choice-fingerprint>` tokens so timeline search and
    schedule search compose in one frontier."""
    rng = random.Random(seed)
    names = scenarios or list(SCENARIOS)
    tokens: set[str] = set()
    per = max(1, n_schedules // len(names))
    for name in names:
        r = explore(name, seed=rng.randrange(2**31), mode="random",
                    max_schedules=per, wall_budget_s=5.0)
        tokens |= r.coverage_tokens
    return tokens


def run_cli(args: Any) -> int:
    """`--sched` entry for analysis/cli.py: 0 clean, 1 findings, 2 infra."""
    try:
        if getattr(args, "sched_replay", None):
            run = replay_schedule(args.sched_replay)
            print(f"replayed {args.sched_replay}: trace={run.trace_fingerprint()} "
                  f"steps={run.steps}")
            for f in run.failures:
                print(f"  FAIL {f}")
            return 1 if run.failures else 0
        if getattr(args, "sched_shrink", None):
            scenario, plant, seed, choices = parse_schedule_id(args.sched_shrink)
            shrunk, run = shrink_schedule(scenario, choices, plant)
            sid = format_schedule_id(scenario, seed, shrunk, plant)
            print(f"shrunk {len(choices)} -> {len(shrunk)} choices: {sid}")
            for f in run.failures:
                print(f"  FAIL {f}")
            return 1 if run.failures else 0
        summary = tier1_smoke(seed=getattr(args, "sched_seed", 0) or 0)
        for name, row in summary["scenarios"].items():
            cert = "exhaustive" if row["complete"] else "sampled"
            print(
                f"sched {name}: {row['schedules']} schedules "
                f"({row['mode']}, {cert}), {row['prunes']} pruned, "
                f"{row['elapsed_s']}s"
            )
        for name in summary["shed"]:
            print(f"sched {name}: SHED (budget exhausted)")
        for f in summary["failures"]:
            print(f"sched FAIL {f['schedule_id']}: {f['failures']}")
        return 1 if summary["failures"] else 0
    except (SchedInfraError, ValueError) as e:
        # ValueError = malformed/unknown schedule id: the EXPLORER was
        # misused, not "findings" — same contract as AnalysisError
        print(f"sched infra error: {e}")
        return 2
