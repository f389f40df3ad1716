"""Background worker runtime.

Equivalent of reference src/util/background/: the `Worker` trait with
work/wait_for_work phases (background/worker.rs:41-59), the processor loop
with exponential error backoff 1.5^n capped at ~1h and a worker-info registry
(worker.rs:61-232), `BackgroundRunner` (background/mod.rs:16-60), and the
runtime-tunable `BgVars` (background/vars.rs:8-45).

TPU-native difference: the reference runs workers on a tokio runtime; here
workers are asyncio tasks.  Batch-producing workers (scrub/resync) additionally
talk to the codec's device executor, which runs JAX dispatch on a dedicated
thread so the event loop never blocks on TPU work.
"""

from __future__ import annotations

import asyncio
import enum
import logging
import time
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger("garage_tpu_torch.background")


class WorkerState(enum.Enum):
    # ref util/background/worker.rs:19-39
    BUSY = "busy"
    THROTTLED = "throttled"
    IDLE = "idle"
    DONE = "done"


class WorkerStatus:
    """Operator-visible worker state (ref worker.rs WorkerStatus/WorkerInfo)."""

    def __init__(self) -> None:
        self.state = WorkerState.IDLE
        self.iterations = 0
        self.errors = 0
        self.consecutive_errors = 0
        self.last_error: Optional[str] = None
        self.last_error_time: float = 0.0
        self.tranquility: Optional[int] = None
        self.progress: Optional[str] = None
        self.queue_length: Optional[int] = None
        self.persistent_errors: Optional[int] = None
        self.freeform: List[str] = []

    def to_dict(self) -> Dict[str, Any]:
        return {
            "state": self.state.value,
            "iterations": self.iterations,
            "errors": self.errors,
            "consecutive_errors": self.consecutive_errors,
            "last_error": self.last_error,
            "tranquility": self.tranquility,
            "progress": self.progress,
            "queue_length": self.queue_length,
            "persistent_errors": self.persistent_errors,
            "freeform": self.freeform,
        }


class LoopSafeEvent:
    """asyncio.Event whose set() is safe from ANY thread.

    asyncio.Event.set() from a foreign thread flips the flag but wakes
    nothing — a worker parked in wait_for_work() sleeps through the
    notification until something else stirs the loop.  That is exactly
    the idle gap the batched table paths expose: a Merkle/insert-queue
    refill committed from a worker thread (batched passes run under
    asyncio.to_thread) must wake the drainer NOW.  The waiting side
    captures its loop; set() routes through call_soon_threadsafe when
    called off-loop.  A set() before the first wait() only flips the
    flag, which wait() observes before sleeping — no wakeup is lost."""

    def __init__(self) -> None:
        self._ev = asyncio.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None

    def clear(self) -> None:
        self._ev.clear()

    def is_set(self) -> bool:
        return self._ev.is_set()

    async def wait(self) -> bool:
        self._loop = asyncio.get_running_loop()
        return await self._ev.wait()

    def set(self) -> None:
        loop = self._loop
        if loop is not None and not loop.is_closed():
            try:
                running = asyncio.get_running_loop()
            except RuntimeError:
                running = None
            if running is not loop:
                try:
                    loop.call_soon_threadsafe(self._ev.set)
                    return
                except RuntimeError:
                    pass  # loop shut down between checks: flag-only set
        self._ev.set()


class Worker:
    """Subclass and implement `work` (one step, returns a WorkerState) and
    optionally `wait_for_work` (ref background/worker.rs:41-59)."""

    def name(self) -> str:
        return type(self).__name__

    def status(self) -> WorkerStatus:
        st = getattr(self, "_status", None)
        if st is None:
            st = self._status = WorkerStatus()
        return st

    async def work(self) -> WorkerState:
        raise NotImplementedError

    async def wait_for_work(self) -> None:
        """Called when work() returned IDLE; return when there may be work."""
        await asyncio.sleep(1.0)

    def throttled(self, since_ns: int) -> None:
        """Called after the load governor paused this worker from
        ``since_ns`` (``time.monotonic_ns``) until now; a worker that
        keeps a timeline records the pause there."""


# ref background/worker.rs:28-33: backoff base 1.5^n, 10 errors before warn
_ERROR_RETRY_BASE = 1.0
# 120 s, not the reference's ~1 h scale: a worker stuck at an hour-long
# retry cap cannot participate in self-healing after a transient outage
# (a dead peer during one queue sweep is enough to saturate the cap)
_ERROR_RETRY_MAX = 120.0


class BackgroundRunner:
    """Spawns and tracks workers (ref background/mod.rs:16-60 +
    worker.rs:61-175 WorkerProcessor)."""

    def __init__(self) -> None:
        self.workers: Dict[int, Worker] = {}
        self.tasks: Dict[int, asyncio.Task] = {}
        self._next_id = 0
        self.stopping = asyncio.Event()
        # load governor (utils/overload.py), set by the model layer:
        # when foreground pressure is high, BUSY workers are duty-cycled
        # (sleep proportional to their last slice) so resync/scrub/GC/
        # sync sweeps cede CPU and wire to client traffic, and resume
        # full rate when pressure clears.  None = never throttle.
        self.governor = None

    def spawn(self, worker: Worker) -> int:
        wid = self._next_id
        self._next_id += 1
        self.workers[wid] = worker
        self.tasks[wid] = asyncio.get_running_loop().create_task(
            self._run_worker(wid, worker), name=f"worker-{wid}-{worker.name()}"
        )
        return wid

    def reap(self, wid: int) -> bool:
        """Drop a COMPLETED worker's registry entries.  Recurring one-shot
        spawns (the automatic layout sweep respawns on every ring change)
        would otherwise accumulate dead workers/tasks for the daemon's
        lifetime.  Refuses while the task is still running."""
        t = self.tasks.get(wid)
        if t is not None and not t.done():
            return False
        self.tasks.pop(wid, None)
        self.workers.pop(wid, None)
        return True

    async def _run_worker(self, wid: int, worker: Worker) -> None:
        status = worker.status()
        while not self.stopping.is_set():
            try:
                t0 = time.monotonic()
                state = await worker.work()
                status.iterations += 1
                status.consecutive_errors = 0
                status.state = state
                if state == WorkerState.BUSY and self.governor is not None:
                    # dynamic background yielding: at throttle ratio r the
                    # worker runs r of the wall clock (sleep after each
                    # slice), so foreground overload visibly pushes
                    # background bytes/s down — and full rate resumes as
                    # soon as the governor's pressure clears
                    pause = self.governor.bg_pause(time.monotonic() - t0)
                    if pause > 0:
                        status.state = WorkerState.THROTTLED
                        t_pause = time.monotonic_ns()
                        await self._sleep_or_stop(pause)
                        worker.throttled(t_pause)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                status.errors += 1
                status.consecutive_errors += 1
                status.last_error = f"{type(e).__name__}: {e}"
                status.last_error_time = time.time()
                log = logger.warning if status.consecutive_errors >= 10 else logger.debug
                log("worker %s (%d) error: %s", worker.name(), wid, e, exc_info=True)
                # ref worker.rs:161-167: exponential backoff 1.5^n
                delay = min(
                    _ERROR_RETRY_BASE * (1.5 ** min(status.consecutive_errors, 20)),
                    _ERROR_RETRY_MAX,
                )
                await self._sleep_or_stop(delay)
                continue
            if state == WorkerState.DONE:
                logger.info("worker %s (%d) done", worker.name(), wid)
                return
            if state == WorkerState.IDLE:
                wait = asyncio.ensure_future(worker.wait_for_work())
                stop = asyncio.ensure_future(self.stopping.wait())
                done, pending = await asyncio.wait(
                    {wait, stop}, return_when=asyncio.FIRST_COMPLETED
                )
                for p in pending:
                    p.cancel()
                    await asyncio.gather(p, return_exceptions=True)
                for d in done:
                    # a raising wait_for_work must not hot-spin the loop
                    if d is wait and d.exception() is not None:
                        logger.warning(
                            "worker %s (%d) wait_for_work error: %s",
                            worker.name(), wid, d.exception(),
                        )
                        await self._sleep_or_stop(1.0)

    async def _sleep_or_stop(self, delay: float) -> None:
        try:
            await asyncio.wait_for(self.stopping.wait(), timeout=delay)
        except asyncio.TimeoutError:
            pass

    def worker_info(self) -> Dict[int, Dict[str, Any]]:
        """Registry for `garage worker list` (ref worker.rs:189-232)."""
        return {
            wid: {"name": w.name(), **w.status().to_dict()}
            for wid, w in self.workers.items()
        }

    def observe_gauges(self, registry) -> None:
        """Mirror every worker's status into labelled Prometheus gauges —
        called at scrape time by the admin /metrics handler (the same
        pattern as Table.observe_gauges).  Clear-then-set: a reaped
        worker's series must disappear, not freeze.

        One series per (id, name) pair; state is a 0/1 family over the
        four WorkerState values so `worker_state{state="busy"} == 1`
        selects busy workers without string-valued metrics."""
        g_state = registry.gauge(
            "worker_state", "1 for the worker's current state, 0 otherwise")
        g_iter = registry.gauge(
            "worker_iterations", "Completed work() iterations")
        g_err = registry.gauge("worker_errors", "Total worker errors")
        g_cerr = registry.gauge(
            "worker_consecutive_errors",
            "Consecutive errors (drives the retry backoff)")
        g_queue = registry.gauge(
            "worker_queue_length",
            "Backlog the worker is draining (todo/queue/backlog depth)")
        g_perr = registry.gauge(
            "worker_persistent_errors",
            "Entries parked in the worker's error/backoff set")
        for g in (g_state, g_iter, g_err, g_cerr, g_queue, g_perr):
            g.clear()
        for wid, w in self.workers.items():
            st = w.status()
            lbl = {"id": str(wid), "name": w.name()}
            for s in WorkerState:
                g_state.set(
                    1.0 if st.state == s else 0.0, state=s.value, **lbl)
            g_iter.set(float(st.iterations), **lbl)
            g_err.set(float(st.errors), **lbl)
            g_cerr.set(float(st.consecutive_errors), **lbl)
            if st.queue_length is not None:
                g_queue.set(float(st.queue_length), **lbl)
            if st.persistent_errors is not None:
                g_perr.set(float(st.persistent_errors), **lbl)

    async def shutdown(self, timeout: float = 8.0) -> None:
        """Signal stop; hard-cancel after deadline (ref worker.rs:100-113
        8s exit deadline)."""
        self.stopping.set()
        tasks = [t for t in self.tasks.values() if not t.done()]
        if tasks:
            done, pending = await asyncio.wait(tasks, timeout=timeout)
            for t in pending:
                t.cancel()
            await asyncio.gather(*pending, return_exceptions=True)


class BgVars:
    """Runtime-tunable named variables, settable from the CLI
    (ref util/background/vars.rs:8-45)."""

    def __init__(self) -> None:
        self._vars: Dict[str, tuple] = {}  # name -> (getter, setter|None)

    def register_rw(self, name: str, getter: Callable[[], Any], setter: Callable[[Any], None]) -> None:
        self._vars[name] = (getter, setter)

    def register_ro(self, name: str, getter: Callable[[], Any]) -> None:
        self._vars[name] = (getter, None)

    def get(self, name: str) -> Any:
        return self._vars[name][0]()

    def set(self, name: str, value: Any) -> None:
        g, s = self._vars[name]
        if s is None:
            raise KeyError(f"variable {name} is read-only")
        s(value)

    def all(self) -> Dict[str, Any]:
        return {k: g() for k, (g, _) in sorted(self._vars.items())}
