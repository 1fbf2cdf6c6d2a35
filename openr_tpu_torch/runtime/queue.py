"""Inter-module message queues.

Port of `openr_tpu.runtime.queue` (reference: openr/messaging/Queue.h:36-129,
openr/messaging/ReplicateQueue.h:23):

- RWQueue — unbounded (or drop-oldest bounded) MPMC queue; `get()` blocks
  the calling thread, `aget()` suspends the calling asyncio task.
- RQueue — the read-only view handed to consumers.
- ReplicateQueue — one writer fanned out to per-reader queues; a reader
  sees every message pushed after it was created.

push/get may be called from any thread and aget() from any event loop;
async waiters are woken with call_soon_threadsafe and retry the pop, so
no item is reserved for a waiter that was cancelled.  A bounded queue
hands each item it sheds to its `on_shed` callback, outside the lock
(the serving layer turns a shed query into an explicit error reply).
The reference's race-detector, schedule-explorer and trace hooks (its
`analysis` and `obs` tooling) are not ported.
"""

from __future__ import annotations

import asyncio
import threading
from collections import deque
from typing import Callable, Generic, Iterable, Optional, TypeVar

T = TypeVar("T")


class QueueClosedError(RuntimeError):
    pass


class RQueue(Generic[T]):
    """Read interface (reference: RQueue, openr/messaging/Queue.h:36)."""

    def __init__(self, impl: "RWQueue[T]") -> None:
        self._impl = impl

    def get(self, timeout: Optional[float] = None) -> T:
        return self._impl.get(timeout)

    async def aget(self) -> T:
        return await self._impl.aget()

    def try_get(self) -> Optional[T]:
        return self._impl.try_get()

    def size(self) -> int:
        return self._impl.size()

    def is_closed(self) -> bool:
        return self._impl.is_closed()

    def close(self) -> None:
        """Reader-side close: pending get()s raise QueueClosedError and a
        ReplicateQueue prunes the reader on its next push."""
        self._impl.close()


class RWQueue(Generic[T]):
    def __init__(
        self,
        maxlen: Optional[int] = None,
        on_shed: Optional[Callable[[T], None]] = None,
    ) -> None:
        self._items: deque[T] = deque()
        self._maxlen = maxlen
        # called with each item the bounded queue sheds
        self._on_shed = on_shed
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False
        self._async_waiters: list[tuple[asyncio.AbstractEventLoop, asyncio.Future]] = []
        self._num_pushed = 0
        self._num_read = 0
        self._num_overflows = 0

    def push(self, item: T) -> bool:
        shed: Optional[T] = None
        with self._lock:
            if self._closed:
                return False
            if self._maxlen is not None and len(self._items) >= self._maxlen:
                # bounded: shed the OLDEST item (later state supersedes it)
                shed = self._items.popleft()
                self._num_overflows += 1
            self._items.append(item)
            self._num_pushed += 1
            self._cond.notify()
            waiters, self._async_waiters = self._async_waiters, []
        self._wake(waiters)
        if shed is not None and self._on_shed is not None:
            # outside the lock: the handler may complete futures whose
            # callbacks must not run under it
            self._on_shed(shed)
        return True

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
            waiters, self._async_waiters = self._async_waiters, []
        self._wake(waiters)

    @staticmethod
    def _wake(waiters: Iterable[tuple[asyncio.AbstractEventLoop, asyncio.Future]]) -> None:
        for loop, fut in waiters:
            try:
                loop.call_soon_threadsafe(lambda f=fut: f.done() or f.set_result(None))
            except RuntimeError:
                pass  # loop already closed

    def _pop(self) -> T:
        self._num_read += 1
        return self._items.popleft()

    def get(self, timeout: Optional[float] = None) -> T:
        with self._cond:
            if not self._cond.wait_for(
                lambda: self._items or self._closed, timeout=timeout
            ):
                raise TimeoutError("queue get timed out")
            if self._items:
                return self._pop()
            raise QueueClosedError("queue closed")

    def try_get(self) -> Optional[T]:
        with self._lock:
            if self._items:
                return self._pop()
            if self._closed:
                raise QueueClosedError("queue closed")
            return None

    async def aget(self) -> T:
        while True:
            loop = asyncio.get_running_loop()
            with self._lock:
                if self._items:
                    return self._pop()
                if self._closed:
                    raise QueueClosedError("queue closed")
                fut: asyncio.Future = loop.create_future()
                self._async_waiters.append((loop, fut))
            try:
                await fut
            except asyncio.CancelledError:
                with self._lock:
                    self._async_waiters = [
                        (l, f) for (l, f) in self._async_waiters if f is not fut
                    ]
                raise

    def size(self) -> int:
        with self._lock:
            return len(self._items)

    def is_closed(self) -> bool:
        with self._lock:
            return self._closed

    def get_reader(self) -> RQueue[T]:
        return RQueue(self)

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "size": len(self._items),
                "num_pushed": self._num_pushed,
                "num_read": self._num_read,
                "overflows": self._num_overflows,
            }


class ReplicateQueue(Generic[T]):
    """One writer, N reader queues (reference:
    openr/messaging/ReplicateQueue.h:23)."""

    def __init__(self, maxlen: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._readers: list[RWQueue[T]] = []
        self._closed = False
        self._num_writes = 0
        self._maxlen = maxlen  # of each per-reader queue

    def push(self, item: T) -> bool:
        with self._lock:
            if self._closed:
                return False
            # prune readers closed on their own side
            self._readers = [q for q in self._readers if not q.is_closed()]
            readers = list(self._readers)
            self._num_writes += 1
        for q in readers:
            q.push(item)
        return True

    def get_reader(self) -> RQueue[T]:
        with self._lock:
            if self._closed:
                raise QueueClosedError("replicate queue closed")
            q: RWQueue[T] = RWQueue(maxlen=self._maxlen)
            self._readers.append(q)
            return RQueue(q)

    def close_reader(self, reader: RQueue[T]) -> None:
        """Detach one consumer: its queue is closed and dropped."""
        with self._lock:
            impl = reader._impl
            self._readers = [q for q in self._readers if q is not impl]
        impl.close()

    def get_num_readers(self) -> int:
        with self._lock:
            return len(self._readers)

    def get_num_writes(self) -> int:
        with self._lock:
            return self._num_writes

    def stats(self) -> dict[str, int]:
        """Reader stats folded: depth is the deepest reader's backlog."""
        with self._lock:
            readers = [q for q in self._readers if not q.is_closed()]
            writes = self._num_writes
        depth = overflows = 0
        for q in readers:
            st = q.stats()
            depth = max(depth, st["size"])
            overflows += st["overflows"]
        return {
            "depth": depth,
            "writes": writes,
            "overflows": overflows,
            "readers": len(readers),
        }

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            readers = list(self._readers)
        for q in readers:
            q.close()


def queue_counters(queues: dict[str, "ReplicateQueue"]) -> dict[str, int]:
    """Counters of a named set of replicate queues:
    queue.<name>.{depth,writes,overflows,readers}."""
    out: dict[str, int] = {}
    for name, queue in queues.items():
        for key, val in queue.stats().items():
            out[f"queue.{name}.{key}"] = val
    return out
