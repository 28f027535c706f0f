"""Task supervision: one-for-one restart of crashed asyncio loops.

Background loops spawned with a bare ``loop.create_task(...)`` die
silently on the first uncaught exception — the reactor keeps running
but its gossip/sync/dial loop is simply gone.  The reference codebase
leans on Go's panic-crashes-the-process discipline; here the analog is
an Erlang-style one-for-one supervisor: every reactor/switch loop is
spawned through a Supervisor, an uncaught exception restarts that loop
with exponential backoff + jitter, and a bounded restart budget turns
a hot crash loop into a loud, metered give-up instead of a silent
spin.  Crash/restart/give-up counts are exported on the node's
metrics registry.

The clock, sleep, and jitter RNG are injectable so tests can assert
the exact backoff schedule deterministically.

The port's copy of cometbft_tpu/libs/supervisor.py adds one rule, the
port's no-fallback rule: ``spawn(..., fatal=pred)``.  A crash whose
exception ``pred`` calls fatal is never restarted: supervision ends at
once (a give-up, metered, logged and dumped to a flight record),
``on_giveup`` runs, and the exception propagates to whoever awaits the
handle.  The consensus machine calls every error fatal but its own
protocol errors, so a kernel, its build or the BLS library failing
stops consensus loudly instead of being restarted away.
"""
from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass
from typing import Callable, Optional

from . import metrics as libmetrics
from .log import Logger, new_logger


@dataclass(frozen=True)
class RestartPolicy:
    """One-for-one restart policy for a supervised loop.

    ``max_restarts`` crashes inside a sliding ``window_s`` exhaust the
    budget: the loop is abandoned (loudly — log + give-up metric +
    callback).  A loop that stays healthy longer than the window earns
    its budget back, and the backoff exponent resets with it.
    """
    max_restarts: int = 5
    window_s: float = 60.0
    backoff_base_s: float = 0.1
    backoff_max_s: float = 10.0
    jitter: float = 0.1            # fraction of the delay, uniform
    restart_on_success: bool = False   # normal return ends supervision


DEFAULT_POLICY = RestartPolicy()


class Metrics:
    """Supervisor metric family (reference idiom: per-package
    metrics.go fed from one shared registry)."""

    def __init__(self, registry: Optional[libmetrics.Registry] = None):
        m = registry if registry is not None else libmetrics.Registry()
        # labeled by the loop KIND (e.g. "consensus_gossip_votes"),
        # never by peer id: peer-derived label values are
        # peer-controlled and would grow the family without bound
        self.crashes = m.counter(
            "supervisor", "crashes_total",
            "Uncaught exceptions in supervised loops.",
            labels=("supervisor", "task"))
        self.restarts = m.counter(
            "supervisor", "restarts_total",
            "Restarts of supervised loops after a crash.",
            labels=("supervisor", "task"))
        self.giveups = m.counter(
            "supervisor", "giveups_total",
            "Supervised loops abandoned after exhausting their "
            "restart budget.",
            labels=("supervisor", "task"))
        self.live = m.gauge(
            "supervisor", "live_tasks",
            "Currently supervised loops.", labels=("supervisor",))


class SupervisedTask:
    """Handle for one supervised loop.

    Quacks enough like an asyncio.Task for the call sites that used to
    hold one: ``cancel()`` stops the loop for good (no restart), and
    ``await handle`` joins the runner.
    """

    def __init__(self, name: str, kind: str):
        self.name = name
        self.kind = kind
        self.restarts = 0
        self.gave_up = False
        self.last_error: Optional[BaseException] = None
        self.crash_times: list[float] = []
        self._runner: Optional[asyncio.Task] = None

    @property
    def runner(self) -> Optional[asyncio.Task]:
        return self._runner

    def cancel(self) -> None:
        if self._runner is not None:
            self._runner.cancel()

    def done(self) -> bool:
        return self._runner is None or self._runner.done()

    async def wait(self) -> None:
        if self._runner is not None:
            try:
                await self._runner
            except asyncio.CancelledError:
                pass

    def __await__(self):
        if self._runner is None:
            async def _done():
                return None
            return _done().__await__()
        return self._runner.__await__()

    def __repr__(self) -> str:
        return f"SupervisedTask({self.name}, restarts={self.restarts})"


class Supervisor:
    """One-for-one supervisor owning a set of loops.

    ``monotonic``/``sleep``/``rng`` are injectable for deterministic
    tests (fake clock, recorded backoff schedule, seeded jitter).
    """

    def __init__(self, name: str, logger: Optional[Logger] = None,
                 metrics: Optional[Metrics] = None, *,
                 monotonic: Optional[Callable[[], float]] = None,
                 sleep: Optional[Callable] = None,
                 rng: Optional[random.Random] = None):
        self.name = name
        self.logger = logger if logger is not None else \
            new_logger(f"supervisor.{name}")
        self.metrics = metrics if metrics is not None else Metrics()
        self._monotonic = monotonic
        self._sleep = sleep if sleep is not None else asyncio.sleep
        self._rng = rng if rng is not None else random.Random()
        self._tasks: list[SupervisedTask] = []

    # ------------------------------------------------------------------
    def _now(self) -> float:
        if self._monotonic is not None:
            return self._monotonic()
        return asyncio.get_event_loop().time()

    def backoff(self, n_crashes_in_window: int,
                policy: RestartPolicy) -> float:
        """Delay before the restart following the n-th windowed crash
        (1-based): capped exponential plus uniform jitter."""
        d = min(policy.backoff_base_s * (2 ** (n_crashes_in_window - 1)),
                policy.backoff_max_s)
        return d * (1.0 + policy.jitter * self._rng.random())

    def note_crash(self, kind: str, exc: BaseException) -> None:
        """Meter a crash in a loop the supervisor does not own (e.g.
        the asyncio.Server-driven accept path) so it is never silent."""
        self.metrics.crashes.with_labels(self.name, kind).inc()
        self.logger.error("unsupervised loop crashed", task=kind,
                          err=repr(exc))

    # ------------------------------------------------------------------
    def spawn(self, factory: Callable, name: str = "",
              kind: str = "",
              policy: Optional[RestartPolicy] = None,
              on_crash: Optional[Callable] = None,
              on_giveup: Optional[Callable] = None,
              fatal: Optional[Callable[[BaseException], bool]] = None
              ) -> SupervisedTask:
        """Supervise ``factory`` — a zero-arg callable returning a
        fresh coroutine per (re)start.  ``kind`` labels metrics (keep
        it low-cardinality); ``name`` is the per-instance log/display
        name.  A crash for which ``fatal(exc)`` is true is not
        restarted: it gives up and re-raises to the handle's awaiter."""
        st = SupervisedTask(
            name or getattr(factory, "__name__", "task"),
            kind or name or "task")
        st._runner = asyncio.get_running_loop().create_task(
            self._run(st, factory, policy or DEFAULT_POLICY,
                      on_crash, on_giveup, fatal),
            name=f"{self.name}/{st.name}")
        self._tasks.append(st)
        self.metrics.live.with_labels(self.name).add(1)
        return st

    async def stop(self) -> None:
        tasks, self._tasks = self._tasks, []
        for st in tasks:
            st.cancel()
        for st in tasks:
            await st.wait()

    def live_count(self) -> int:
        return sum(1 for st in self._tasks if not st.done())

    # ------------------------------------------------------------------
    async def _run(self, st: SupervisedTask, factory: Callable,
                   policy: RestartPolicy,
                   on_crash: Optional[Callable],
                   on_giveup: Optional[Callable],
                   fatal: Optional[Callable] = None) -> None:
        try:
            while True:
                try:
                    await factory()
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 — that's the job
                    st.last_error = e
                    self.metrics.crashes.with_labels(
                        self.name, st.kind).inc()
                    self.logger.error("supervised loop crashed",
                                      task=st.name, err=repr(e))
                    self._notify(on_crash, st, e)
                    if fatal is not None and fatal(e):
                        st.gave_up = True
                        self.metrics.giveups.with_labels(
                            self.name, st.kind).inc()
                        self.logger.error(
                            "supervised loop stopped: fatal error, not "
                            "restarted", task=st.name, err=repr(e))
                        self._dump_flight_record(st, e)
                        self._notify(on_giveup, st, e)
                        raise
                    now = self._now()
                    st.crash_times = [
                        t for t in st.crash_times
                        if now - t <= policy.window_s]
                    st.crash_times.append(now)
                    if len(st.crash_times) > policy.max_restarts:
                        st.gave_up = True
                        self.metrics.giveups.with_labels(
                            self.name, st.kind).inc()
                        self.logger.error(
                            "supervised loop abandoned: restart "
                            "budget exhausted", task=st.name,
                            restarts=st.restarts, err=repr(e))
                        self._dump_flight_record(st, e)
                        self._notify(on_giveup, st, e)
                        return
                    st.restarts += 1
                    self.metrics.restarts.with_labels(
                        self.name, st.kind).inc()
                    delay = self.backoff(len(st.crash_times), policy)
                    self.logger.info("restarting supervised loop",
                                     task=st.name, attempt=st.restarts,
                                     delay_s=round(delay, 4))
                    await self._sleep(delay)
                else:
                    if not policy.restart_on_success:
                        return
                    await self._sleep(policy.backoff_base_s)
        finally:
            self.metrics.live.with_labels(self.name).sub(1)
            # drop our handle so peer-churn supervisors don't
            # accumulate dead SupervisedTasks (and their last_error
            # tracebacks) forever; stop() snapshots first, so this is
            # a no-op there
            try:
                self._tasks.remove(st)
            except ValueError:
                pass

    def _dump_flight_record(self, st: SupervisedTask,
                            exc: BaseException) -> None:
        """A give-up is the node's 'black box moment': dump the flight
        recorder (libs/tracing.py) so the timeline leading into the
        crash loop survives.  Never lets a dump failure mask the
        give-up itself."""
        try:
            from . import tracing
            tracing.instant(tracing.SUPERVISOR, "giveup",
                            supervisor=self.name, task=st.name,
                            err=repr(exc)[:200])
            path = tracing.dump(
                reason=f"supervisor_giveup_{self.name}_{st.kind}",
                extra={"supervisor": self.name, "task": st.name,
                       "kind": st.kind, "restarts": st.restarts,
                       "error": repr(exc)})
            if path:
                self.logger.error("flight record dumped", path=path)
        except Exception:  # noqa: BLE001 — best-effort black box
            pass

    def _notify(self, cb: Optional[Callable], st: SupervisedTask,
                exc: BaseException) -> None:
        if cb is None:
            return
        try:
            cb(st, exc)
        except Exception as e:  # noqa: BLE001 — callbacks must not kill us
            self.logger.error("supervisor callback failed",
                              task=st.name, err=repr(e))
