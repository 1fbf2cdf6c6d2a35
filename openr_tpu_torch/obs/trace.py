"""End-to-end span tracing across queues, modules and engine rungs.

Port of `openr_tpu.obs.trace`, the same names, counters and wire shapes.

Arming discipline:

- ``TRACE`` is a module-level constant, ``None`` unless armed.  Every
  seam of the port reads it LATE-BOUND (``_trace.TRACE``, never
  ``from ... import TRACE``) and guards with one ``if tr is not None``:
  unarmed, a seam costs one attribute load, installs no wrapper and
  allocates no token.
- ``OPENR_TRACE=1`` arms at import; ``OPENR_TRACE_SAMPLE=N`` keeps one
  in N roots (a deterministic modulo counter, not random: the structure
  contract below depends on it); ``OPENR_TRACE_RING=N`` bounds the
  finished-trace ring.
- Tests arm and disarm explicitly with :func:`enable` / :func:`disable`.

Span model: a trace is born at an entry point (a serving query's
submit, a KvStore publication, a Spark neighbor event) as a *root* span
and follows the concurrency seams: an RWQueue push carries the active
scope next to the item and the pop hands it to the consumer, an
OpenrEventBase hand-off re-activates the captured scope on the loop
thread, and a coalesced batch activates every query's span at once, so
one engine annotation lands on each (fan-in scope).

Structure contract: :meth:`Span.structure` serializes only stage names,
structural tags (engine rung, dispatch kind, outcome) and the child set
(children sorted, timers and ``note`` metadata left out), so runs of
the same inputs give equal structures.

Imports the standard library only.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import Any, Callable, Iterator, Optional, Sequence

# the obs.* family, pre-seeded on every counters surface
OBS_COUNTER_KEYS = (
    "obs.traces_started",
    "obs.traces_sampled_out",
    "obs.traces_finished",
    "obs.spans_total",
    "obs.trace_ring_evictions",
)


def _now_us() -> int:
    return time.perf_counter_ns() // 1_000


class Span:
    """One stage of one traced request.

    ``tags`` are structural (stages, rungs, retry and hedge edges);
    ``notes`` are informational (sizes, epochs, timings) and left out of
    :meth:`structure`.  Mutations go through the tracer's lock: spans
    cross threads (submit thread → event base → executor → reply
    thread), and a hedged call can have two replicas annotating one
    span at once."""

    __slots__ = (
        "name",
        "parent",
        "children",
        "tags",
        "notes",
        "t_start_us",
        "t_end_us",
    )

    def __init__(self, name: str, parent: Optional["Span"] = None) -> None:
        self.name = name
        self.parent = parent
        self.children: list[Span] = []
        self.tags: dict[str, Any] = {}
        self.notes: dict[str, Any] = {}
        self.t_start_us = _now_us()
        self.t_end_us: Optional[int] = None

    def root(self) -> "Span":
        sp = self
        while sp.parent is not None:
            sp = sp.parent
        return sp

    def finish(self) -> None:
        if self.t_end_us is None:
            self.t_end_us = _now_us()

    def structure(self) -> str:
        """The canonical structure: name, sorted tags, sorted children."""
        tags = ",".join(f"{k}={v}" for k, v in sorted(self.tags.items()))
        kids = ",".join(sorted(c.structure() for c in self.children))
        return f"{self.name}({tags})[{kids}]"

    def to_dict(self, t0_us: Optional[int] = None) -> dict:
        """JSON-able tree, times relative to the root's start."""
        base = self.t_start_us if t0_us is None else t0_us
        end = self.t_end_us
        return {
            "name": self.name,
            "t_offset_us": self.t_start_us - base,
            "duration_us": None if end is None else end - self.t_start_us,
            "tags": dict(self.tags),
            "notes": dict(self.notes),
            "children": [c.to_dict(base) for c in self.children],
        }


class Tracer:
    """Span factory, thread-local scope and bounded ring of traces."""

    def __init__(self, sample_every: int = 1, ring: int = 256) -> None:
        self.sample_every = max(1, int(sample_every))
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._ring: deque[Span] = deque(maxlen=max(1, int(ring)))
        self._structure_tokens: set[str] = set()
        self._n_roots = 0
        self._counters: dict[str, int] = {k: 0 for k in OBS_COUNTER_KEYS}

    # -- scope (thread-local) -----------------------------------------------

    def scope(self) -> tuple:
        return getattr(self._tls, "scope", ())

    @contextmanager
    def activate(self, spans: Sequence[Span]) -> Iterator[None]:
        """Make `spans` this thread's scope; it replaces the scope, as a
        queue hop or a batch activation is the new attribution set."""
        prev = getattr(self._tls, "scope", ())
        self._tls.scope = tuple(spans)
        try:
            yield
        finally:
            self._tls.scope = prev

    def bind_scope(self, fn: Callable[..., Any]) -> Callable[..., Any]:
        """`fn` wrapped to run under the current scope on whatever thread
        calls it (event-base hand-offs); `fn` itself when there is no
        scope to carry."""
        scope = self.scope()
        if not scope:
            return fn

        def _with_scope(*args: Any, **kwargs: Any) -> Any:
            with self.activate(scope):
                return fn(*args, **kwargs)

        return _with_scope

    # -- span creation ------------------------------------------------------

    def root(self, name: str, **tags: Any) -> Optional[Span]:
        """A trace born at an entry point.  Under an active scope (the
        router submitting to a scheduler on its thread) the trace
        extends instead: the span is a child of the scope's first span.
        True roots are sampled 1 in `sample_every` by a modulo counter;
        a sampled-out root is None."""
        scope = self.scope()
        if scope:
            return self.child_open(scope[0], name, **tags)
        with self._lock:
            self._n_roots += 1
            if (self._n_roots - 1) % self.sample_every:
                self._counters["obs.traces_sampled_out"] += 1
                return None
            self._counters["obs.traces_started"] += 1
            self._counters["obs.spans_total"] += 1
        sp = Span(name)
        sp.tags.update(tags)
        return sp

    def child_open(self, parent: Span, name: str, **tags: Any) -> Span:
        """An open child span; the caller finishes it."""
        sp = Span(name, parent=parent)
        sp.tags.update(tags)
        with self._lock:
            parent.children.append(sp)
            self._counters["obs.spans_total"] += 1
        return sp

    @contextmanager
    def child(self, name: str, **tags: Any) -> Iterator[None]:
        """A child under every span of the current scope, finished on
        exit; the children are the scope meanwhile, so nested seams
        attribute under the stage, not beside it."""
        scope = self.scope()
        if not scope:
            yield
            return
        kids = [self.child_open(sp, name, **tags) for sp in scope]
        try:
            with self.activate(kids):
                yield
        finally:
            now = _now_us()
            for k in kids:
                if k.t_end_us is None:
                    k.t_end_us = now

    def stage(
        self, span: Span, name: str, t0_us: int, t1_us: int, **tags: Any
    ) -> Span:
        """A finished child with explicit bounds (a stage whose start
        was only timestamped, such as admission → drain)."""
        sp = Span(name, parent=span)
        sp.tags.update(tags)
        sp.t_start_us = t0_us
        sp.t_end_us = t1_us
        with self._lock:
            span.children.append(sp)
            self._counters["obs.spans_total"] += 1
        return sp

    def event(self, name: str, **tags: Any) -> None:
        """A zero-length structural edge (retry, hedge, failover) under
        every span of the current scope."""
        now = _now_us()
        for sp in self.scope():
            ev = Span(name, parent=sp)
            ev.tags.update(tags)
            ev.t_start_us = ev.t_end_us = now
            with self._lock:
                sp.children.append(ev)
                self._counters["obs.spans_total"] += 1

    def annotate(self, key: str, value: Any) -> None:
        """A structural tag on every span of the current scope (the
        engine rung rides this)."""
        for sp in self.scope():
            with self._lock:
                sp.tags[key] = value

    def note(self, key: str, value: Any) -> None:
        """Metadata on every span of the current scope, left out of
        :meth:`Span.structure`."""
        for sp in self.scope():
            with self._lock:
                sp.notes[key] = value

    # -- queue carry --------------------------------------------------------

    def carry(self) -> Optional[tuple]:
        """The token a queue stores next to an item at push."""
        scope = self.scope()
        return scope or None

    def set_carried(self, token: Optional[tuple]) -> None:
        """The pop side: stash the popped item's token on this thread; the
        consumer adopts it with :meth:`take_carried` right after get()
        returns, on the same thread."""
        self._tls.carried = token

    def take_carried(self) -> tuple:
        tok = getattr(self._tls, "carried", None)
        self._tls.carried = None
        return tok or ()

    # -- completion ---------------------------------------------------------

    def finish(self, span: Span) -> None:
        """Finish a span; a root lands in the ring and its structure joins
        the structure-token set."""
        span.finish()
        if span.parent is not None:
            return
        with self._lock:
            self._counters["obs.traces_finished"] += 1
            if len(self._ring) == self._ring.maxlen:
                self._counters["obs.trace_ring_evictions"] += 1
            self._ring.append(span)
            self._structure_tokens.add(span.structure())

    def finish_root(self, span: Span) -> None:
        """Finish the root of a carried span once (the terminal seams:
        a reply delivered, routes programmed)."""
        root = span.root()
        if root.t_end_us is None:
            self.finish(root)

    # -- export -------------------------------------------------------------

    def dump(self, n: int = 16) -> list[dict]:
        with self._lock:
            recent = list(self._ring)[-max(0, int(n)):]
        return [sp.to_dict() for sp in recent]

    def span_samples(self, n: int = 32) -> list[dict]:
        """The ring's traces grouped by structure, with a count and the
        longest duration of each shape, most frequent first."""
        with self._lock:
            recent = list(self._ring)
        groups: dict[str, dict] = {}
        for sp in recent:
            key = sp.structure()
            g = groups.get(key)
            dur = (sp.t_end_us or sp.t_start_us) - sp.t_start_us
            if g is None:
                groups[key] = {"structure": key, "count": 1, "max_us": dur}
            else:
                g["count"] += 1
                g["max_us"] = max(g["max_us"], dur)
        out = sorted(groups.values(), key=lambda g: -g["count"])
        return out[: max(0, int(n))]

    def drain_structure_tokens(self) -> frozenset:
        """Take the structures of the traces finished since the last
        drain."""
        with self._lock:
            toks, self._structure_tokens = frozenset(self._structure_tokens), set()
        return toks

    def get_counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counters)


class ObsStats:
    """The ctrl handler's ``obs`` surface.  Reads ``TRACE`` late-bound, so
    an unarmed daemon answers zeroed ``obs.*`` counters and empty trace
    lists: the wire shape does not depend on arming."""

    def get_counters(self) -> dict[str, int]:
        tr = TRACE
        if tr is None:
            return {k: 0 for k in OBS_COUNTER_KEYS}
        return tr.get_counters()

    def dump_traces(self, n: int = 16) -> list[dict]:
        tr = TRACE
        return [] if tr is None else tr.dump(n)

    def span_samples(self, n: int = 32) -> list[dict]:
        tr = TRACE
        return [] if tr is None else tr.span_samples(n)


# -- arming ------------------------------------------------------------------

TRACE: Optional[Tracer] = None

_NULL = nullcontext()


def maybe_child(name: str, **tags: Any):
    """Seam helper for cold paths: a finished child under the current
    scope when armed, one shared no-op context when not (hot paths guard
    with ``if tr is not None`` instead)."""
    tr = TRACE
    return _NULL if tr is None else tr.child(name, **tags)


def enable(sample_every: int = 1, ring: int = 256) -> Tracer:
    """Arm tracing; returns the installed tracer."""
    global TRACE
    TRACE = Tracer(sample_every=sample_every, ring=ring)
    return TRACE


def disable() -> None:
    global TRACE
    TRACE = None


def maybe_enable() -> Optional[Tracer]:
    """Arm from the environment (OPENR_TRACE=1); a no-op when armed
    already or not asked for."""
    if TRACE is not None:
        return TRACE
    if os.environ.get("OPENR_TRACE", "") != "1":
        return None
    return enable(
        sample_every=int(os.environ.get("OPENR_TRACE_SAMPLE", "1")),
        ring=int(os.environ.get("OPENR_TRACE_RING", "256")),
    )


maybe_enable()
