"""The port's runtime (queues, event base, debounce, throttle, backoff)
against `openr_tpu`'s: every scenario of tests/test_queue.py and
tests/test_runtime.py (less the step detector, which the port does not
carry) runs on both packages and must give the same outcome."""

from __future__ import annotations

import asyncio
import threading
import time
from types import SimpleNamespace

import pytest

import openr_tpu.runtime.async_util as jasync
import openr_tpu.runtime.eventbase as jevb
import openr_tpu.runtime.queue as jqueue
import openr_tpu.utils.backoff as jbackoff
import openr_tpu_torch.runtime.async_util as pasync
import openr_tpu_torch.runtime.eventbase as pevb
import openr_tpu_torch.runtime.queue as pqueue
import openr_tpu_torch.utils.backoff as pbackoff

NAMES = {
    "queue": ("RWQueue", "ReplicateQueue", "QueueClosedError", "queue_counters"),
    "evb": ("OpenrEventBase",),
    "async": ("AsyncDebounce", "AsyncThrottle"),
    "backoff": ("ExponentialBackoff", "MaxBackoffAbortError"),
}


def _runtime(**modules) -> SimpleNamespace:
    return SimpleNamespace(
        **{
            name: getattr(modules[kind], name)
            for kind, names in NAMES.items()
            for name in names
        }
    )


PACKAGES = {
    "port": _runtime(queue=pqueue, evb=pevb, backoff=pbackoff, **{"async": pasync}),
    "reference": _runtime(
        queue=jqueue, evb=jevb, backoff=jbackoff, **{"async": jasync}
    ),
}


def both(scenario):
    """The scenario's outcome on each package, held equal."""
    outcomes = {name: scenario(rt) for name, rt in PACKAGES.items()}
    assert outcomes["port"] == outcomes["reference"], outcomes
    return outcomes["port"]


# -- tests/test_queue.py ----------------------------------------------------


def fifo_order(rt):
    q = rt.RWQueue()
    pushed = [q.push(i) for i in range(100)]
    return all(pushed), q.size(), [q.get() for _ in range(100)]


def try_get(rt):
    q = rt.RWQueue()
    out = [q.try_get()]
    q.push("x")
    out.append(q.try_get())
    q.close()
    with pytest.raises(rt.QueueClosedError):
        q.try_get()
    return out


def blocking_get_across_threads(rt):
    q = rt.RWQueue()
    out = []
    t = threading.Thread(target=lambda: out.append(q.get(timeout=5)))
    t.start()
    time.sleep(0.02)
    q.push(42)
    t.join(timeout=5)
    return out


def get_timeout(rt):
    with pytest.raises(TimeoutError):
        rt.RWQueue().get(timeout=0.01)
    return True


def close_unblocks_getters(rt):
    q = rt.RWQueue()
    errs = []

    def reader():
        try:
            q.get(timeout=5)
        except rt.QueueClosedError as e:
            errs.append(type(e).__name__)

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.02)
    q.close()
    for t in threads:
        t.join(timeout=5)
    return errs, q.push(1)


def async_get(rt):
    q = rt.RWQueue()

    async def main():
        task = asyncio.create_task(q.aget())
        await asyncio.sleep(0.01)
        threading.Thread(target=lambda: q.push("hello")).start()
        return await asyncio.wait_for(task, timeout=5)

    return asyncio.run(main())


def async_get_closed(rt):
    q = rt.RWQueue()

    async def main():
        task = asyncio.create_task(q.aget())
        await asyncio.sleep(0.01)
        q.close()
        try:
            await asyncio.wait_for(task, timeout=5)
        except rt.QueueClosedError:
            return "closed"
        return "not closed"

    return asyncio.run(main())


def mpmc_stress(rt):
    q = rt.RWQueue()
    n_producers, n_consumers, per_producer = 4, 4, 500
    consumed = []
    lock = threading.Lock()

    def producer(pid):
        for i in range(per_producer):
            q.push((pid, i))

    def consumer():
        while True:
            try:
                item = q.get(timeout=5)
            except rt.QueueClosedError:
                return
            with lock:
                consumed.append(item)

    cons = [threading.Thread(target=consumer) for _ in range(n_consumers)]
    prods = [threading.Thread(target=producer, args=(i,)) for i in range(n_producers)]
    for t in cons + prods:
        t.start()
    for t in prods:
        t.join()
    while q.size() > 0:
        time.sleep(0.01)
    q.close()
    for t in cons:
        t.join(timeout=5)
    in_order = all(
        [i for (p, i) in consumed if p == pid] == list(range(per_producer))
        for pid in range(n_producers)
    )
    return len(consumed), in_order


def replicate_queue_fanout(rt):
    rq = rt.ReplicateQueue()
    r1 = rq.get_reader()
    rq.push(1)  # only r1 sees this
    r2 = rq.get_reader()
    rq.push(2)
    out = [rq.get_num_readers(), rq.get_num_writes()]
    out += [r1.get(timeout=1), r1.get(timeout=1), r2.get(timeout=1)]
    out.append(rq.stats())
    rq.close()
    with pytest.raises(rt.QueueClosedError):
        r1.get(timeout=1)
    with pytest.raises(rt.QueueClosedError):
        rq.get_reader()
    return out


def bounded_queue_sheds_oldest(rt):
    q = rt.RWQueue(maxlen=2)
    for i in range(4):
        q.push(i)
    return [q.get(), q.get()], q.stats()


def bounded_queue_on_shed(rt):
    q = None
    shed = []

    def on_shed(item):
        # called outside the queue lock, once per dropped item
        shed.append((item, q._lock.locked()))

    q = rt.RWQueue(maxlen=2, on_shed=on_shed)
    pushed = [q.push(i) for i in range(5)]
    return pushed, shed, [q.get(), q.get()], q.stats()


def on_shed_only_on_overflow(rt):
    shed = []
    q = rt.RWQueue(maxlen=3, on_shed=shed.append)
    for i in range(3):
        q.push(i)
    q.get()
    q.push(3)
    q.close()
    return shed, q.push(4), shed, q.stats()["overflows"]


QUEUE_SCENARIOS = {
    "fifo_order": (fifo_order, (True, 100, list(range(100)))),
    "try_get": (try_get, [None, "x"]),
    "blocking_get_across_threads": (blocking_get_across_threads, [42]),
    "get_timeout": (get_timeout, True),
    "close_unblocks_getters": (
        close_unblocks_getters,
        (["QueueClosedError"] * 4, False),
    ),
    "async_get": (async_get, "hello"),
    "async_get_closed": (async_get_closed, "closed"),
    "mpmc_stress": (mpmc_stress, (2000, True)),
    "replicate_queue_fanout": (
        replicate_queue_fanout,
        [2, 2, 1, 2, 2, {"depth": 0, "writes": 2, "overflows": 0, "readers": 2}],
    ),
    "bounded_queue_sheds_oldest": (
        bounded_queue_sheds_oldest,
        ([2, 3], {"size": 0, "num_pushed": 4, "num_read": 2, "overflows": 2}),
    ),
    "bounded_queue_on_shed": (
        bounded_queue_on_shed,
        (
            [True] * 5,
            [(0, False), (1, False), (2, False)],
            [3, 4],
            {"size": 0, "num_pushed": 5, "num_read": 2, "overflows": 3},
        ),
    ),
    "on_shed_only_on_overflow": (on_shed_only_on_overflow, ([], False, [], 0)),
}


@pytest.mark.parametrize("name", sorted(QUEUE_SCENARIOS))
def test_queue_scenario_equals_reference(name):
    scenario, expected = QUEUE_SCENARIOS[name]
    assert both(scenario) == expected


# -- tests/test_runtime.py --------------------------------------------------


def eventbase_lifecycle(rt):
    evb = rt.OpenrEventBase("test")
    evb.run()
    out = [evb.wait_until_running(2), evb.is_running]
    out.append(
        evb.run_in_event_base_thread(lambda: threading.current_thread().name).result(
            timeout=2
        )
    )
    evb.stop()
    out += [evb.wait_until_stopped(2), evb.is_running]
    return out


def eventbase_fiber_task_queue_read(rt):
    evb = rt.OpenrEventBase("reader")
    q = rt.RWQueue()
    seen = []
    done = threading.Event()

    async def reader():
        while True:
            seen.append(await q.aget())
            if len(seen) == 3:
                done.set()

    evb.run()
    evb.add_fiber_task(reader())
    for i in range(3):
        q.push(i)
    ok = done.wait(5)
    evb.stop()
    return ok, seen


def eventbase_timestamp_advances(rt):
    evb = rt.OpenrEventBase("hb")
    evb.run()
    t0 = evb.get_timestamp()
    time.sleep(0.25)
    advanced = evb.get_timestamp() > t0
    evb.stop()
    return advanced


def eventbase_timeout_and_cancel(rt):
    evb = rt.OpenrEventBase("timer")
    evb.run()
    fired = []
    evb.schedule_timeout(0.01, lambda: fired.append("kept"))
    evb.schedule_timeout(0.05, lambda: fired.append("cancelled")).cancel()
    time.sleep(0.15)
    evb.stop()
    return fired


def eventbase_stop_from_own_loop(rt):
    evb = rt.OpenrEventBase("selfstop")
    evb.run()

    async def self_stop():
        evb.stop()

    evb.add_fiber_task(self_stop())
    return evb.wait_until_stopped(5)


def debounce_coalesces(rt):
    fires = []

    async def main():
        deb = rt.AsyncDebounce(0.02, 0.1, lambda: fires.append(time.monotonic()))
        t0 = time.monotonic()
        for _ in range(5):
            deb()
            await asyncio.sleep(0.005)
        await asyncio.sleep(0.2)
        return t0

    t0 = asyncio.run(main())
    return len(fires), 0.015 <= fires[0] - t0 <= 0.2


def debounce_max_bound(rt):
    fires = []

    async def main():
        deb = rt.AsyncDebounce(0.01, 0.05, lambda: fires.append(1))
        t0 = time.monotonic()
        while time.monotonic() - t0 < 0.2:
            deb()
            await asyncio.sleep(0.002)
        await asyncio.sleep(0.1)

    asyncio.run(main())
    return len(fires) >= 2


def throttle(rt):
    fires = []

    async def main():
        thr = rt.AsyncThrottle(0.02, lambda: fires.append(1))
        for _ in range(10):
            thr()
        await asyncio.sleep(0.05)
        thr()
        await asyncio.sleep(0.05)

    asyncio.run(main())
    return len(fires)


def exponential_backoff(rt):
    now = [0.0]
    bo = rt.ExponentialBackoff(1.0, 8.0, clock=lambda: now[0])
    out = [bo.can_try_now()]
    bo.report_error()
    out += [bo.can_try_now(), bo.get_current_backoff()]
    bo.report_error()
    out.append(bo.get_current_backoff())
    for _ in range(5):
        bo.report_error()
    out += [bo.get_current_backoff(), bo.at_max_backoff()]
    now[0] += 8.0
    out.append(bo.can_try_now())
    bo.report_success()
    out += [bo.get_current_backoff(), bo.can_try_now()]
    bo.report_error()
    out.append(bo.get_current_backoff())
    return out


def exponential_backoff_abort_at_max(rt):
    bo = rt.ExponentialBackoff(1.0, 2.0, is_abort_at_max=True, clock=lambda: 0.0)
    bo.report_error()
    bo.report_error()
    at_max = bo.at_max_backoff()
    with pytest.raises(rt.MaxBackoffAbortError):
        bo.report_error()
    with pytest.raises(ValueError):
        rt.ExponentialBackoff(2.0, 1.0)
    return at_max


RUNTIME_SCENARIOS = {
    "eventbase_lifecycle": (eventbase_lifecycle, [True, True, "test", True, False]),
    "eventbase_fiber_task_queue_read": (
        eventbase_fiber_task_queue_read,
        (True, [0, 1, 2]),
    ),
    "eventbase_timestamp_advances": (eventbase_timestamp_advances, True),
    "eventbase_timeout_and_cancel": (eventbase_timeout_and_cancel, ["kept"]),
    "eventbase_stop_from_own_loop": (eventbase_stop_from_own_loop, True),
    "debounce_coalesces": (debounce_coalesces, (1, True)),
    "debounce_max_bound": (debounce_max_bound, True),
    "throttle": (throttle, 2),
    "exponential_backoff": (
        exponential_backoff,
        [True, False, 1.0, 2.0, 8.0, True, True, 0.0, True, 1.0],
    ),
    "exponential_backoff_abort_at_max": (exponential_backoff_abort_at_max, True),
}


@pytest.mark.parametrize("name", sorted(RUNTIME_SCENARIOS))
def test_runtime_scenario_equals_reference(name):
    scenario, expected = RUNTIME_SCENARIOS[name]
    assert both(scenario) == expected


def queue_counters(rt):
    qs = {"routes": rt.ReplicateQueue(maxlen=1), "kv": rt.ReplicateQueue()}
    qs["routes"].get_reader()
    for i in range(3):
        qs["routes"].push(i)
    qs["kv"].push("x")
    return rt.queue_counters(qs)


def test_queue_counters_equal_reference():
    assert both(queue_counters) == {
        "queue.routes.depth": 1,
        "queue.routes.writes": 3,
        "queue.routes.overflows": 2,
        "queue.routes.readers": 1,
        "queue.kv.depth": 0,
        "queue.kv.writes": 1,
        "queue.kv.overflows": 0,
        "queue.kv.readers": 0,
    }
