"""Module runtime: one thread and one asyncio event loop per module.

Port of `openr_tpu.runtime.eventbase` (reference: OpenrEventBase,
openr/common/OpenrEventBase.h:28): every module runs in its own thread
(startEventBase, openr/Main.cpp:132-163), fibers are asyncio tasks,
timers are loop timers, and the heartbeat timestamp is the watchdog's
getTimestamp() (OpenrEventBase.h:74).  A module may define the async
hooks `prepare()`, started as a task on its loop when the loop starts,
and `stopping()`, awaited on its loop before the loop stops.  The
reference's race-detector, schedule-explorer and trace hand-off
wrappers (its `analysis` and `obs` tooling) and its cross-loop
coroutine calls (`run_async`, `run_coroutine`) are not ported: no
ported module uses them.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import threading
import time
from typing import Any, Callable, Coroutine, Optional

log = logging.getLogger(__name__)


class Timeout:
    """Cancellable cross-thread timer token of
    OpenrEventBase.schedule_timeout."""

    def __init__(self) -> None:
        self._handle: Optional[asyncio.TimerHandle] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._cancelled = False
        self._lock = threading.Lock()

    def _arm(
        self, loop: asyncio.AbstractEventLoop, delay_s: float, fn: Callable[[], Any]
    ) -> None:
        with self._lock:
            if self._cancelled:
                return
            self._loop = loop
            self._handle = loop.call_later(delay_s, fn)

    def cancel(self) -> None:
        """Cancel from any thread; a timer that already fired is not
        recalled (callbacks must tolerate one late firing)."""
        with self._lock:
            self._cancelled = True
            handle, loop = self._handle, self._loop
            self._handle = None
        if handle is not None and loop is not None:
            try:
                loop.call_soon_threadsafe(handle.cancel)
            except RuntimeError:
                pass  # loop closed


class OpenrEventBase:
    def __init__(self, name: str = "") -> None:
        self.name = name or type(self).__name__
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._stopped = threading.Event()
        self._stop_once = threading.Lock()
        self._stop_called = False
        self._tasks: set[asyncio.Task] = set()
        self._timestamp = time.monotonic()

    # -- lifecycle ----------------------------------------------------------

    def run(self) -> None:
        """Start the module thread and its loop; returns once running."""
        if self._thread is not None:
            raise RuntimeError(f"{self.name} already started")
        self._thread = threading.Thread(target=self._thread_main, name=self.name)
        self._thread.daemon = True
        self._thread.start()
        self._started.wait()

    def _thread_main(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        try:
            try:
                self._track(
                    loop.create_task(self._heartbeat(), name=f"{self.name}-heartbeat")
                )
                prepare = getattr(self, "prepare", None)
                if prepare is not None:
                    self._track(
                        loop.create_task(prepare(), name=f"{self.name}-prepare")
                    )
            finally:
                # never leave run() waiting if startup raised
                self._started.set()
            loop.run_forever()
            for task in list(self._tasks):
                task.cancel()
            pending = [t for t in self._tasks if not t.done()]
            if pending:
                loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True)
                )
        finally:
            loop.close()
            self._stopped.set()

    async def _heartbeat(self) -> None:
        while True:
            self._timestamp = time.monotonic()
            await asyncio.sleep(0.1)

    def stop(self) -> None:
        """Stop the loop and join the thread, from any thread; later
        callers wait for the first stop to finish."""
        if self._loop is None:
            return
        with self._stop_once:
            first = not self._stop_called
            self._stop_called = True
        if not first:
            if threading.current_thread() is not self._thread:
                self.wait_until_stopped()
            return
        stopping = getattr(self, "stopping", None)

        async def _graceful() -> None:
            if stopping is not None:
                try:
                    await stopping()
                except Exception:
                    log.exception("%s: stopping() hook failed", self.name)
            self._loop.stop()

        try:
            self._loop.call_soon_threadsafe(
                lambda: self._track(self._loop.create_task(_graceful()))
            )
        except RuntimeError:
            return
        # joining from the module's own thread would deadlock its loop
        if threading.current_thread() is not self._thread:
            self.wait_until_stopped()

    def wait_until_running(self, timeout: Optional[float] = None) -> bool:
        return self._started.wait(timeout)

    def wait_until_stopped(self, timeout: Optional[float] = None) -> bool:
        if self._thread is None:
            return True
        ok = self._stopped.wait(timeout)
        if ok:
            self._thread.join()
        return ok

    @property
    def is_running(self) -> bool:
        return self._started.is_set() and not self._stopped.is_set()

    # -- tasks and timers (reference: addFiberTask :47, scheduleTimeout) ----

    def _track(self, task: asyncio.Task) -> None:
        self._tasks.add(task)

        def _done(t: asyncio.Task) -> None:
            self._tasks.discard(t)
            if not t.cancelled():
                exc = t.exception()
                if exc is not None and not isinstance(exc, asyncio.CancelledError):
                    log.exception(
                        "%s: task %s crashed", self.name, t.get_name(), exc_info=exc
                    )

        task.add_done_callback(_done)

    def add_fiber_task(self, coro: Coroutine[Any, Any, Any], name: str = "") -> None:
        """Schedule a long-running coroutine on this module's loop, from
        any thread (reference: addFiberTask, OpenrEventBase.h:47)."""
        assert self._loop is not None, f"{self.name} not started"

        def _create() -> None:
            self._track(self._loop.create_task(coro, name=name or "fiber"))

        self._loop.call_soon_threadsafe(_create)

    def in_event_base_thread(self) -> bool:
        return threading.current_thread() is self._thread

    def run_in_event_base_thread(
        self, fn: Callable[[], Any]
    ) -> "concurrent.futures.Future[Any]":
        """Run `fn` on this module's thread and return a future of its
        result (reference: runInEventBaseThread + SemiFuture,
        openr/decision/Decision.cpp:1513).  From the owning thread the
        call runs inline (waiting on the future there would deadlock)."""
        assert self._loop is not None, f"{self.name} not started"
        fut: concurrent.futures.Future = concurrent.futures.Future()
        if self.in_event_base_thread():
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)
            return fut

        def _call() -> None:
            if not fut.set_running_or_notify_cancel():
                return
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        self._loop.call_soon_threadsafe(_call)
        return fut

    def schedule_timeout(self, delay_s: float, fn: Callable[[], Any]) -> Timeout:
        """Run `fn` after `delay_s` on this module's loop; returns a
        cancellable token."""
        assert self._loop is not None
        token = Timeout()
        self._loop.call_soon_threadsafe(token._arm, self._loop, delay_s, fn)
        return token

    # -- watchdog interface (reference: getTimestamp, OpenrEventBase.h:74) --

    def get_timestamp(self) -> float:
        return self._timestamp
