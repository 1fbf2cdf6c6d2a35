"""Dynamic happens-before race detector (``OPENR_TSAN=1``).

Port of `openr_tpu.analysis.race`.  The static rules in
:mod:`openr_tpu_torch.analysis.threads` prove the *shape* of
the module discipline; this module certifies the *executions*: a
TSan-style vector-clock detector over the daemon's real synchronization
vocabulary.  While armed it builds the happens-before (HB) relation from:

==========================================  ================================
edge                                        established by
==========================================  ================================
lock release -> later acquire               ``threading.Lock``/``RLock``
                                            proxies (Condition/Event ride
                                            their internal locks)
thread fork / join                          ``Thread.start`` (parent clock
                                            snapshot) / ``Thread.join``
queue put -> matching get                   per-item tokens in
                                            ``RWQueue.push``/``get``/
                                            ``try_get``/``aget``
future resolve -> observe                   ``concurrent.futures.Future.
                                            set_result/set_exception`` ->
                                            ``result/exception``
executor submit -> task run                 ``ThreadPoolExecutor.submit``
                                            handoff token
cross-thread marshalling                    ``run_in_event_base_thread``,
                                            ``add_fiber_task``,
                                            ``schedule_timeout``,
                                            ``stop``, ``run_coroutine``
                                            (eventbase handoff wraps)
==========================================  ================================

State on *tracked classes* (``tsan_tracked_paths`` in the package's
``analysis.toml``; default: the port's ``OpenrEventBase`` and therefore
every module, ``ReplicaRouter``, ``SchedulerReplica``) is recorded through
class-level ``__setattr__``/``__getattribute__`` hooks.  Any write that
races a prior access with no HB path is reported with both thread names,
both stacks, and the attribute — deduped by site pair.

Soundness posture is pure happens-before: no false positives (every
report is a real unordered pair on the schedules observed), but
schedule-dependent false negatives, and over-synchronization through
shared internal locks (a queue's mutex orders *all* critical sections,
not just the matching put/get) hides some true races.  That trade is
deliberate — the armed tier-1 gate must never cry wolf.

Zero cost when off: ``TSAN`` is a module-level constant (``None``) and
every instrumentation seam is a single ``if race.TSAN is not None``
attribute load.  ``OpenrDaemon.__init__`` arms it through
:func:`maybe_enable` when ``OPENR_TSAN=1`` was set at import; ``python -m
openr_tpu_torch.analysis --races`` arms it through its pytest plugin
(``pytest_tsan``).  ``OPENR_TSAN_READS=0`` keeps write tracking but drops
read tracking (cheaper; still catches write-write).

The detector's own primitives come from ``_thread``, never from
``threading``: imported while another detector has ``threading.Lock``
patched, this module still holds real locks (a proxy inside the detector
would recurse).  Arming saves whatever ``threading`` holds and disarming
puts exactly that back.  Only one detector may hold the patches: while
another (the reference's, armed by the test suite's conftest under the
same ``OPENR_TSAN=1``) has ``threading`` patched, :func:`enable` raises
and :func:`maybe_enable` logs an error and leaves this one off, because
locks made under this detector's proxies are invisible to the other,
whose edges would then go missing.  Tracked classes are resolved lazily
inside :func:`enable`; this file imports neither the runtime nor torch.
"""

from __future__ import annotations

import _thread
import concurrent.futures
import functools
import importlib
import logging
import os
import sys
import threading
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Optional

log = logging.getLogger(__name__)

#: THE zero-overhead guard.  ``None`` disarms every seam; :func:`enable`
#: swaps in a :class:`RaceDetector`.  Seams must read it late-bound
#: (``race.TSAN``), never ``from ... import TSAN``.
TSAN: Optional["RaceDetector"] = None

_ENV_ARMED = os.environ.get("OPENR_TSAN", "") == "1"

# Real primitives, taken from _thread so that no patch of threading (this
# detector's or another's) can be captured; proxies and the detector
# itself must only ever use these (the detector's own lock being a proxy
# would recurse).
_REAL_LOCK = _thread.allocate_lock
_REAL_RLOCK = _thread.RLock
_RAW_LOCK = _thread.allocate_lock

#: dotted class paths instrumented by default (the config's
#: ``tsan_tracked_paths`` overrides).  OpenrEventBase covers every module
#: subclass — KvStore, Decision, Fib, QueryScheduler, ... — via the MRO.
DEFAULT_TRACKED_PATHS = [
    "openr_tpu_torch.runtime.eventbase.OpenrEventBase",
    "openr_tpu_torch.serving.router.ReplicaRouter",
    "openr_tpu_torch.serving.router.SchedulerReplica",
]

#: Built-in runtime suppressions: (class name anywhere in the object's
#: MRO, attribute) -> rationale, the reference's entries.  Every
#: entry must say WHY the unordered access is benign; the armed gate
#: treats anything not listed here (or added via
#: ``RaceDetector.suppress``) as a failure.
DEFAULT_RUNTIME_SUPPRESSIONS: dict[tuple[str, str], str] = {
    ("OpenrEventBase", "_timestamp"): (
        "heartbeat gauge: one monotonic float written by the module loop "
        "every 100ms and sampled by the Watchdog thread; readers tolerate "
        "arbitrary staleness (stall threshold 300s >> one beat) and a "
        "torn read of one machine word is impossible under the GIL"
    ),
    ("QueryScheduler", "_accepting"): (
        "monotonic shutdown latch: flips True->False exactly once in "
        "stop()/stopping(); submit() reading it early/late only changes "
        "WHICH loud shed path fires (flag vs closed admission queue) — "
        "a query is never silently accepted after close"
    ),
    ("ReplicaRouter", "_stopped"): (
        "monotonic shutdown latch: set once in stop(); submit()/"
        "_hedge_loop reading stale False costs one extra dispatch whose "
        "reply path re-checks under _lock — never a lost or double "
        "resolution"
    ),
    ("OpenrEventBase", "_thread"): (
        "lifecycle reference: written by run() before start() and read "
        "by in_event_base_thread() from any thread; during a chaos "
        "respawn a peer's in-process call can read it mid-transition, "
        "but the value is one reference word under the GIL and a stale "
        "read only marshals the call instead of inlining it — the "
        "subsequent loop submit either lands or raises into the "
        "caller's sync-failure recovery (kvstore _flood_to_peer)"
    ),
    ("OpenrEventBase", "_loop"): (
        "lifecycle reference: written once by _thread_main at loop "
        "birth; cross-thread users (stop, add_fiber_task, "
        "run_in_event_base_thread) read one reference word under the "
        "GIL.  A stale/None read during a chaos respawn hits the "
        "guarded paths — stop() returns for never-started, "
        "call_soon_threadsafe on a closed loop raises RuntimeError "
        "into callers that treat it as a peer sync failure and "
        "full-sync on reconnect"
    ),
    ("OpenrEventBase", "_started"): (
        "lifecycle Event reference: assigned in __init__ and only read "
        "afterwards (is_running / wait_until_running).  Cross-thread "
        "readers reach a fresh module through the chaos fabric's "
        "addr->store dict; CPython dict publication makes the fully "
        "constructed object visible under the GIL, the detector just "
        "does not model container-mediated handoff (by design)"
    ),
    ("OpenrEventBase", "_stopped"): (
        "lifecycle Event reference: same dict-published pattern as "
        "_started — assigned once in __init__, read via is_running/"
        "wait_until_stopped; the Event object itself synchronizes "
        "internally"
    ),
    ("Decision", "_pending_events"): (
        "deliberately lock-free defer hint (pending_event_hint): the "
        "serving coalesce loop samples an int gauge the decision thread "
        "maintains; the defer wait is bounded by _DEFER_MAX_S whatever "
        "value is read, so staleness only shifts a bounded hold, and a "
        "torn read of one int is impossible under the GIL"
    ),
}

_MAX_FRAMES = 8
_SELF_FILE = os.path.abspath(__file__)
# co_filename -> whether it is this module: os.path.abspath per frame
# was most of an armed run's own cost (benign lost updates under the
# GIL: the value is idempotent)
_IS_SELF: dict[str, bool] = {}


def _capture_stack() -> tuple:
    """Cheap stack sample: up to _MAX_FRAMES (file, line, func) frames,
    skipping this module's own hook frames.  sys._getframe is ~100x
    cheaper than traceback.extract_stack and races never need more than
    the top few user frames to localize."""
    try:
        f = sys._getframe(1)
    except ValueError:  # pragma: no cover
        return ()
    out = []
    is_self = _IS_SELF
    while f is not None and len(out) < _MAX_FRAMES:
        code = f.f_code
        fn = code.co_filename
        own = is_self.get(fn)
        if own is None:
            own = is_self[fn] = os.path.abspath(fn) == _SELF_FILE
        if not own:
            out.append((fn, f.f_lineno, code.co_name))
        f = f.f_back
    return tuple(out)


def _leq(a: dict, b: dict) -> bool:
    """Vector-clock partial order: a <= b."""
    get = b.get
    for t, v in a.items():
        if v > get(t, 0):
            return False
    return True


# Thread ids are GLOBAL (not per-detector): _ThreadState objects live on
# Thread objects and survive enable/disable cycles, so a fresh detector
# reusing tid numbers would collide with stale states.
_NEXT_TID = [0]
_TID_LOCK = _RAW_LOCK()

# Per-OS-thread detector state: .depth (reentrancy guard, set BEFORE any
# work that could recurse into a proxy lock) and .state (_ThreadState
# cache).  A C-level threading.local — attribute access takes no lock and
# cannot recurse.  TLS dies with its OS thread, so ident reuse can never
# resurrect a dead thread's clock through this cache.
_TLS = threading.local()


class _ThreadState:
    """Per-thread vector clock.  The clock dict is mutated only by its
    owning thread; published snapshots are copies and immutable by
    convention."""

    __slots__ = ("tid", "name", "clock", "_snap")

    def __init__(self, tid: int, name: str) -> None:
        self.tid = tid
        self.name = name
        self.clock: dict[int, int] = {tid: 1}
        self._snap: Optional[dict[int, int]] = None

    def snapshot(self) -> dict[int, int]:
        s = self._snap
        if s is None:
            s = self._snap = dict(self.clock)
        return s

    def bump(self) -> None:
        self.clock[self.tid] = self.clock.get(self.tid, 0) + 1
        self._snap = None

    def join(self, other: dict[int, int]) -> None:
        c = self.clock
        for t, v in other.items():
            if c.get(t, 0) < v:
                c[t] = v
                self._snap = None


class _Access:
    """One recorded access: who, at what clock, from where."""

    __slots__ = ("tid", "clock", "thread_name", "stack")

    def __init__(self, tid: int, clock: dict, thread_name: str, stack: tuple):
        self.tid = tid
        self.clock = clock  # immutable snapshot
        self.thread_name = thread_name
        self.stack = stack

    @property
    def site(self) -> tuple:
        return self.stack[0][:2] if self.stack else ("<unknown>", 0)


class _VarState:
    """Race metadata for one (object, attribute): the last write plus the
    latest read per thread (per-thread clocks are monotone, so the latest
    read dominates earlier ones for race purposes)."""

    __slots__ = ("last_write", "reads")

    def __init__(self) -> None:
        self.last_write: Optional[_Access] = None
        self.reads: dict[int, _Access] = {}


def _fmt_stack(stack: tuple, indent: str = "      ") -> str:
    if not stack:
        return indent + "<no frames>"
    return "\n".join(
        f"{indent}{fn}:{line} in {func}" for (fn, line, func) in stack
    )


@dataclass(frozen=True)
class RaceFinding:
    """One unordered access pair on tracked state."""

    kind: str  # "write-write" | "read-write" | "write-read"
    cls_name: str
    attr: str
    prior_thread: str
    prior_stack: tuple
    thread: str
    stack: tuple

    def format(self) -> str:
        prior_kind, cur_kind = {
            "write-write": ("write", "write"),
            "read-write": ("read", "write"),
            "write-read": ("write", "read"),
        }[self.kind]
        return (
            f"{self.kind} race on {self.cls_name}.{self.attr}\n"
            f"  {cur_kind} by thread {self.thread!r} at:\n"
            f"{_fmt_stack(self.stack)}\n"
            f"  unordered against prior {prior_kind} by thread "
            f"{self.prior_thread!r} at:\n"
            f"{_fmt_stack(self.prior_stack)}"
        )


def format_findings(findings: Iterable[RaceFinding]) -> str:
    items = list(findings)
    body = "\n\n".join(f.format() for f in items)
    return (
        f"OPENR_TSAN: {len(items)} unsuppressed race finding"
        f"{'s' if len(items) != 1 else ''}\n\n{body}"
    )


class RaceDetector:
    """Vector-clock happens-before engine.

    All shared structures are guarded by a RAW ``_thread`` lock (never a
    proxy — the detector must not instrument itself).  Per-thread clocks
    are lock-free: mutated only by their owner; cross-thread visibility
    rides immutable snapshots."""

    def __init__(
        self, suppressions: Optional[dict[tuple[str, str], str]] = None
    ) -> None:
        self._lock = _RAW_LOCK()
        self._vars: dict[tuple[int, str], _VarState] = {}
        self._by_obj: dict[int, set[str]] = {}
        self._live: dict[int, Any] = {}
        # weakref callbacks may fire mid-GC while OUR lock is held, so
        # they only append (GIL-atomic) here; drained under the lock
        self._dead: list[int] = []
        self._seen: set = set()
        self.findings: list[RaceFinding] = []
        self.suppressed: list[tuple[RaceFinding, str]] = []
        self.suppressions = dict(DEFAULT_RUNTIME_SUPPRESSIONS)
        if suppressions:
            self.suppressions.update(suppressions)
        self._mro_names: dict[type, tuple[str, ...]] = {}
        self.track_reads = os.environ.get("OPENR_TSAN_READS", "1") != "0"
        #: accesses recorded, objects watched and HB tokens published
        #: since arming (under _lock): what an armed run paid for
        self.accesses = 0
        self.watched = 0
        self.tokens = 0

    def stats(self) -> dict[str, int]:
        """The detector's counts and its findings so far."""
        with self._lock:
            return {
                "accesses": self.accesses,
                "watched_objects": self.watched,
                "tokens": self.tokens,
                "findings": len(self.findings),
                "suppressed": len(self.suppressed),
            }

    # -- thread state --------------------------------------------------------

    @staticmethod
    def _make_state(tls: Any) -> Optional[_ThreadState]:
        """First hook on this OS thread: allocate a vector clock and join
        the fork token Thread.start stashed.  NEVER calls
        threading.current_thread() — during thread bootstrap (before
        _active registration) it would manufacture a _DummyThread whose
        __init__ re-enters our lock proxies, recursing forever.  An
        unregistered thread is simply not instrumented yet: only
        Thread-internal bootstrap locks run in that window."""
        t = threading._active.get(_thread.get_ident())
        if t is None:
            return None
        with _TID_LOCK:
            _NEXT_TID[0] += 1
            tid = _NEXT_TID[0]
        st = _ThreadState(tid, t.name)
        parent = t.__dict__.get("_tsan_parent")
        if parent is not None:
            st.join(parent)
        tls.state = st
        # also visible to joiners (the Thread.join patch reads it)
        t._tsan_state = st
        return st

    def _enter(self) -> Optional[_ThreadState]:
        tls = _TLS
        if getattr(tls, "depth", 0):
            return None
        tls.depth = 1  # before ANY work: arms the recursion guard
        st = getattr(tls, "state", None)
        if st is None:
            try:
                st = self._make_state(tls)
            except BaseException:  # pragma: no cover
                tls.depth = 0
                raise
            if st is None:
                tls.depth = 0
                return None
        return st

    @staticmethod
    def _exit(st: _ThreadState) -> None:
        _TLS.depth = 0

    # -- HB edge primitives --------------------------------------------------

    def publish_token(self) -> Optional[dict]:
        """Snapshot the calling thread's clock (an HB source) and advance
        past it; pair with :meth:`acquire_token` on the receiving side."""
        st = self._enter()
        if st is None:
            return None
        try:
            snap = st.snapshot()
            st.bump()
            with self._lock:
                self.tokens += 1
            return snap
        finally:
            self._exit(st)

    def acquire_token(self, token: Optional[dict]) -> None:
        if token is None:
            return
        st = self._enter()
        if st is None:
            return
        try:
            st.join(token)
        finally:
            self._exit(st)

    # fork/join spellings for readability at the Thread patch sites
    fork_token = publish_token

    def wrap_handoff(self, fn: Callable) -> Callable:
        """Publish now; the returned callable joins before running `fn`.
        The edge for every cross-thread closure handoff
        (call_soon_threadsafe, executor submit)."""
        token = self.publish_token()

        @functools.wraps(fn)
        def _handoff(*args: Any, **kwargs: Any) -> Any:
            self.acquire_token(token)
            return fn(*args, **kwargs)

        return _handoff

    def wrap_coro(self, coro):
        """Handoff edge for a coroutine about to be scheduled on another
        loop (run_coroutine_threadsafe)."""
        token = self.publish_token()

        async def _joined():
            self.acquire_token(token)
            return await coro

        return _joined()

    def on_acquire(self, lock: Any) -> None:
        c = lock._tsan_clock
        if c is None:
            return
        st = self._enter()
        if st is None:
            return
        try:
            st.join(c)
        finally:
            self._exit(st)

    def on_release(self, lock: Any) -> None:
        st = self._enter()
        if st is None:
            return
        try:
            lock._tsan_clock = st.snapshot()
            st.bump()
        finally:
            self._exit(st)

    # -- access recording ----------------------------------------------------

    def record_read(self, obj: Any, name: str) -> None:
        """__getattribute__ hook body: record only instance-dict reads
        (skips methods, class attrs, descriptors)."""
        if name.startswith(("_tsan", "__")):
            return
        try:
            d = object.__getattribute__(obj, "__dict__")
        except AttributeError:
            return
        if name in d:
            self.record_access(obj, name, False)

    def record_access(self, obj: Any, attr: str, is_write: bool) -> None:
        if attr.startswith("_tsan"):
            return
        st = self._enter()
        if st is None:
            return
        try:
            snap = st.snapshot()
            clock = st.clock
            tp = type(obj)
            mro = self._mro_names.get(tp)
            if mro is None:
                # benign lost-update under the GIL: idempotent value
                mro = self._mro_names[tp] = tuple(
                    c.__name__ for c in tp.__mro__
                )
            oid = id(obj)
            with self._lock:
                self.accesses += 1
                if self._dead:
                    self._drain_dead()
                key = (oid, attr)
                var = self._vars.get(key)
                if var is None:
                    var = self._vars[key] = _VarState()
                    self._by_obj.setdefault(oid, set()).add(attr)
                    self._watch(obj, oid)
                if not is_write:
                    prev = var.reads.get(st.tid)
                    if prev is not None and prev.clock is snap:
                        return  # same epoch: already checked + recorded
                    acc = _Access(st.tid, snap, st.name, _capture_stack())
                    lw = var.last_write
                    if (
                        lw is not None
                        and lw.tid != st.tid
                        and not _leq(lw.clock, clock)
                    ):
                        self._report("write-read", mro, attr, lw, acc)
                    var.reads[st.tid] = acc
                    return
                acc = _Access(st.tid, snap, st.name, _capture_stack())
                lw = var.last_write
                if (
                    lw is not None
                    and lw.tid != st.tid
                    and not _leq(lw.clock, clock)
                ):
                    self._report("write-write", mro, attr, lw, acc)
                for rd in var.reads.values():
                    if rd.tid != st.tid and not _leq(rd.clock, clock):
                        self._report("read-write", mro, attr, rd, acc)
                var.reads.clear()
                var.last_write = acc
        finally:
            self._exit(st)

    def _watch(self, obj: Any, oid: int) -> None:
        # under self._lock; drop var state when the object dies so a
        # recycled id() can never pair a new object against stale accesses
        if oid in self._live:
            return
        self.watched += 1
        dead = self._dead
        try:
            self._live[oid] = weakref.ref(
                obj, lambda _r, oid=oid, dead=dead: dead.append(oid)
            )
        except TypeError:
            self._live[oid] = None

    def _drain_dead(self) -> None:
        # under self._lock; callbacks may append concurrently (no lock),
        # so pop one-at-a-time instead of swapping the list out
        d = self._dead
        while d:
            try:
                oid = d.pop()
            except IndexError:  # pragma: no cover
                break
            self._live.pop(oid, None)
            for attr in self._by_obj.pop(oid, ()):
                self._vars.pop((oid, attr), None)

    # -- reporting -----------------------------------------------------------

    def _report(
        self,
        kind: str,
        mro: tuple[str, ...],
        attr: str,
        prior: _Access,
        cur: _Access,
    ) -> None:
        # deduped by site pair: the same two code locations racing on the
        # same attribute report once, however many objects/iterations hit.
        # The pair is unordered (which access is "prior" depends on the
        # schedule), so the key must not depend on processing order —
        # annotate each site with its access kind and take the frozenset
        prior_kind, cur_kind = {
            "write-write": ("w", "w"),
            "read-write": ("r", "w"),
            "write-read": ("w", "r"),
        }[kind]
        key = (
            mro[0],
            attr,
            frozenset(((prior_kind, prior.site), (cur_kind, cur.site))),
        )
        if key in self._seen:
            return
        self._seen.add(key)
        f = RaceFinding(
            kind=kind,
            cls_name=mro[0],
            attr=attr,
            prior_thread=prior.thread_name,
            prior_stack=prior.stack,
            thread=cur.thread_name,
            stack=cur.stack,
        )
        for name in mro:
            why = self.suppressions.get((name, attr))
            if why is not None:
                self.suppressed.append((f, why))
                return
        self.findings.append(f)

    def suppress(self, cls_name: str, attr: str, rationale: str) -> None:
        """Register a runtime suppression.  `rationale` is mandatory —
        every entry must argue why the unordered pair is benign."""
        if not rationale or not rationale.strip():
            raise ValueError("race suppressions require a written rationale")
        self.suppressions[(cls_name, attr)] = rationale

    def drain(self) -> list[RaceFinding]:
        """Return-and-clear unsuppressed findings (the armed gate)."""
        with self._lock:
            out, self.findings = self.findings, []
        return out


# ---------------------------------------------------------------------------
# Lock proxies (installed as threading.Lock / threading.RLock while armed)
# ---------------------------------------------------------------------------


class TsanLock:
    """threading.Lock stand-in adding release->acquire HB edges.  Null-safe:
    objects outliving disable() degrade to passthrough."""

    __slots__ = ("_tsan_inner", "_tsan_clock")

    def __init__(self) -> None:
        self._tsan_inner = _REAL_LOCK()
        self._tsan_clock: Optional[dict] = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._tsan_inner.acquire(blocking, timeout)
        if ok:
            det = TSAN
            if det is not None:
                det.on_acquire(self)
        return ok

    __enter__ = acquire

    def release(self) -> None:
        det = TSAN
        if det is not None:
            det.on_release(self)
        self._tsan_inner.release()

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def locked(self) -> bool:
        return self._tsan_inner.locked()

    def _at_fork_reinit(self) -> None:  # pragma: no cover
        self._tsan_inner._at_fork_reinit()

    def __repr__(self) -> str:  # pragma: no cover
        return f"<TsanLock {self._tsan_inner!r}>"


class TsanRLock:
    """threading.RLock stand-in: HB edges only on the outermost
    acquire/release; implements the Condition protocol
    (_is_owned/_release_save/_acquire_restore)."""

    __slots__ = ("_tsan_inner", "_tsan_clock", "_tsan_count")

    def __init__(self) -> None:
        self._tsan_inner = _REAL_RLOCK()
        self._tsan_clock: Optional[dict] = None
        # recursion depth; only touched while the inner lock is held
        self._tsan_count = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._tsan_inner.acquire(blocking, timeout)
        if ok:
            self._tsan_count += 1
            if self._tsan_count == 1:
                det = TSAN
                if det is not None:
                    det.on_acquire(self)
        return ok

    __enter__ = acquire

    def release(self) -> None:
        if self._tsan_count == 1:
            det = TSAN
            if det is not None:
                det.on_release(self)
        self._tsan_inner.release()  # raises first if not owned
        self._tsan_count -= 1

    def __exit__(self, *exc: Any) -> None:
        self.release()

    # -- Condition protocol --------------------------------------------------

    def _is_owned(self) -> bool:
        return self._tsan_inner._is_owned()

    def _recursion_count(self) -> int:
        # read by multiprocessing's resource tracker at shutdown
        return self._tsan_inner._recursion_count()

    def _release_save(self):
        det = TSAN
        if det is not None:
            det.on_release(self)
        count, self._tsan_count = self._tsan_count, 0
        return (count, self._tsan_inner._release_save())

    def _acquire_restore(self, saved) -> None:
        count, state = saved
        self._tsan_inner._acquire_restore(state)
        self._tsan_count = count
        det = TSAN
        if det is not None:
            det.on_acquire(self)

    def _at_fork_reinit(self) -> None:  # pragma: no cover
        self._tsan_inner._at_fork_reinit()
        self._tsan_count = 0

    def __repr__(self) -> str:  # pragma: no cover
        return f"<TsanRLock {self._tsan_inner!r}>"


# ---------------------------------------------------------------------------
# Interpreter-level patches (Thread fork/join, Future resolve/observe,
# executor submit)
# ---------------------------------------------------------------------------

_SAVED: dict[str, Any] = {}


def _tsan_thread_start(self: threading.Thread) -> None:
    det = TSAN
    if det is not None:
        # parent-side fork edge; the child joins it lazily on its first
        # detector hook (see RaceDetector._state)
        self._tsan_parent = det.fork_token()
    return _SAVED["thread_start"](self)


def _tsan_thread_join(
    self: threading.Thread, timeout: Optional[float] = None
) -> None:
    r = _SAVED["thread_join"](self, timeout)
    det = TSAN
    if det is not None and not self.is_alive():
        st = self.__dict__.get("_tsan_state")
        if st is not None:
            # the dead child's clock dominates all its accesses
            det.acquire_token(st.clock)
    return r


def _tsan_future_set_result(self, result: Any) -> None:
    det = TSAN
    if det is not None:
        self._tsan_token = det.publish_token()
    return _SAVED["future_set_result"](self, result)


def _tsan_future_set_exception(self, exception: Any) -> None:
    det = TSAN
    if det is not None:
        self._tsan_token = det.publish_token()
    return _SAVED["future_set_exception"](self, exception)


def _tsan_future_result(self, timeout: Optional[float] = None) -> Any:
    try:
        return _SAVED["future_result"](self, timeout)
    finally:
        det = TSAN
        if det is not None:
            tok = getattr(self, "_tsan_token", None)
            if tok is not None:
                det.acquire_token(tok)


def _tsan_future_exception(self, timeout: Optional[float] = None) -> Any:
    try:
        return _SAVED["future_exception"](self, timeout)
    finally:
        det = TSAN
        if det is not None:
            tok = getattr(self, "_tsan_token", None)
            if tok is not None:
                det.acquire_token(tok)


def _tsan_executor_submit(self, fn, /, *args: Any, **kwargs: Any):
    det = TSAN
    if det is not None:
        fn = det.wrap_handoff(fn)
    return _SAVED["executor_submit"](self, fn, *args, **kwargs)


def _install_patches() -> None:
    _SAVED["lock"] = threading.Lock
    _SAVED["rlock"] = threading.RLock
    threading.Lock = TsanLock
    threading.RLock = TsanRLock
    _SAVED["thread_start"] = threading.Thread.start
    _SAVED["thread_join"] = threading.Thread.join
    threading.Thread.start = _tsan_thread_start
    threading.Thread.join = _tsan_thread_join
    fut = concurrent.futures.Future
    _SAVED["future_set_result"] = fut.set_result
    _SAVED["future_set_exception"] = fut.set_exception
    _SAVED["future_result"] = fut.result
    _SAVED["future_exception"] = fut.exception
    fut.set_result = _tsan_future_set_result
    fut.set_exception = _tsan_future_set_exception
    fut.result = _tsan_future_result
    fut.exception = _tsan_future_exception
    _SAVED["executor_submit"] = concurrent.futures.ThreadPoolExecutor.submit
    concurrent.futures.ThreadPoolExecutor.submit = _tsan_executor_submit


def _remove_patches() -> None:
    if not _SAVED:
        return
    threading.Lock = _SAVED["lock"]
    threading.RLock = _SAVED["rlock"]
    threading.Thread.start = _SAVED["thread_start"]
    threading.Thread.join = _SAVED["thread_join"]
    fut = concurrent.futures.Future
    fut.set_result = _SAVED["future_set_result"]
    fut.set_exception = _SAVED["future_set_exception"]
    fut.result = _SAVED["future_result"]
    fut.exception = _SAVED["future_exception"]
    concurrent.futures.ThreadPoolExecutor.submit = _SAVED["executor_submit"]
    _SAVED.clear()


# ---------------------------------------------------------------------------
# Tracked classes
# ---------------------------------------------------------------------------

# cls -> (had own __setattr__, saved, had own __getattribute__, saved)
_TRACKED: dict[type, tuple[bool, Any, bool, Any]] = {}


def track_class(cls: type) -> None:
    """Install access-recording hooks on `cls` (and, via the MRO, every
    subclass that does not define its own).  Idempotent."""
    if cls in _TRACKED:
        return
    had_set = "__setattr__" in cls.__dict__
    saved_set = cls.__dict__.get("__setattr__")
    had_get = "__getattribute__" in cls.__dict__
    saved_get = cls.__dict__.get("__getattribute__")
    base_set = cls.__setattr__
    base_get = cls.__getattribute__

    def __setattr__(self, name, value, _orig=base_set):
        det = TSAN
        if det is not None:
            det.record_access(self, name, True)
        _orig(self, name, value)

    def __getattribute__(self, name, _orig=base_get):
        det = TSAN
        if det is not None and det.track_reads:
            det.record_read(self, name)
        return _orig(self, name)

    cls.__setattr__ = __setattr__
    cls.__getattribute__ = __getattribute__
    _TRACKED[cls] = (had_set, saved_set, had_get, saved_get)


def _untrack_all() -> None:
    for cls, (had_set, saved_set, had_get, saved_get) in _TRACKED.items():
        if had_set:
            cls.__setattr__ = saved_set
        else:
            try:
                del cls.__setattr__
            except AttributeError:  # pragma: no cover
                pass
        if had_get:
            cls.__getattribute__ = saved_get
        else:
            try:
                del cls.__getattribute__
            except AttributeError:  # pragma: no cover
                pass
    _TRACKED.clear()


def _resolve_tracked(paths: Iterable[str]) -> list[type]:
    out: list[type] = []
    for path in paths:
        mod_name, _, cls_name = path.rpartition(".")
        if not mod_name:
            continue
        try:
            mod = importlib.import_module(mod_name)
            cls = getattr(mod, cls_name)
        except Exception:  # noqa: BLE001 — optional deps may be absent
            continue
        if isinstance(cls, type):
            out.append(cls)
    return out


def _config_tracked_paths() -> list[str]:
    """The package config's tsan_tracked_paths, falling back to the
    defaults.  Config failures fall back silently — arming must never
    crash the daemon it is auditing."""
    try:
        from .core import read_config

        cfg = read_config()
        if cfg.tsan_tracked_paths:
            return list(cfg.tsan_tracked_paths)
    except Exception:  # noqa: BLE001
        pass
    return list(DEFAULT_TRACKED_PATHS)


# ---------------------------------------------------------------------------
# Arming
# ---------------------------------------------------------------------------


def foreign_patches() -> list[str]:
    """What of ``threading`` another detector holds patched: ``Lock``,
    ``RLock`` or ``Thread.start`` not Python's own.  Empty when
    ``threading`` is as Python made it (or patched by this detector)."""
    if TSAN is not None:
        return []
    held = []
    if threading.Lock not in (_thread.allocate_lock, _thread.LockType):
        held.append(f"threading.Lock is {threading.Lock!r}")
    for owner, name in ((threading, "RLock"), (threading.Thread, "start")):
        fn = getattr(owner, name)
        if getattr(fn, "__module__", None) != "threading":
            held.append(f"{owner.__name__}.{name} is {fn!r}")
    return held


def enable(
    tracked_paths: Optional[Iterable[str]] = None,
    suppressions: Optional[dict[tuple[str, str], str]] = None,
) -> RaceDetector:
    """Arm the detector: install lock/thread/future patches and tracked-
    class hooks, then publish the detector through the TSAN guard.
    Idempotent; returns the active detector.  Raises RuntimeError, and
    patches nothing, while another detector holds ``threading``."""
    global TSAN
    if TSAN is not None:
        return TSAN
    held = foreign_patches()
    if held:
        raise RuntimeError(
            "another race detector holds threading's patches ("
            + "; ".join(held)
            + "): arm one detector at a time"
        )
    det = RaceDetector(suppressions=suppressions)
    _install_patches()
    paths = (
        list(tracked_paths)
        if tracked_paths is not None
        else _config_tracked_paths()
    )
    for cls in _resolve_tracked(paths):
        track_class(cls)
    TSAN = det
    return det


def disable() -> None:
    """Disarm: restore every patch and hook.  Proxy locks and wrapped
    closures created while armed keep working as passthroughs."""
    global TSAN
    if TSAN is None:
        return
    TSAN = None
    _untrack_all()
    _remove_patches()


def maybe_enable() -> Optional[RaceDetector]:
    """Env-gated arming seam: called from OpenrDaemon.__init__; a no-op
    unless OPENR_TSAN=1 was set at import time.  Beside another armed
    detector it logs an error and leaves this one off: a daemon must
    start either way, and the other detector keeps its edges."""
    if _ENV_ARMED and TSAN is None:
        held = foreign_patches()
        if held:
            log.error(
                "OPENR_TSAN=1 but another race detector holds threading's "
                "patches (%s): the port's detector stays off",
                "; ".join(held),
            )
            return None
        enable()
    return TSAN
