"""Service lifecycle discipline: start/stop/quit, idempotent, resettable.

Reference: libs/service/service.go — BaseService with OnStart/OnStop hooks,
atomic started/stopped flags, Quit channel. Here the quit channel is an
asyncio.Event and services may own asyncio tasks.  A copy of
cometbft_tpu/libs/service.py: the same lifecycle and error texts.
"""
from __future__ import annotations

import asyncio
from typing import Optional

from .log import Logger, nop_logger


class AlreadyStartedError(RuntimeError):
    pass


class AlreadyStoppedError(RuntimeError):
    pass


class Service:
    """Base service. Subclasses override on_start / on_stop.

    Mirrors the invariants of the reference BaseService: Start is one-shot
    (error if started or stopped), Stop flips the quit event exactly once.
    """

    def __init__(self, name: str = "", logger: Optional[Logger] = None):
        self.name = name or type(self).__name__
        self.logger = logger or nop_logger()
        self._started = False
        self._stopped = False
        self._quit = asyncio.Event()
        self._tasks: list[asyncio.Task] = []

    # -- lifecycle ---------------------------------------------------------
    @property
    def is_running(self) -> bool:
        return self._started and not self._stopped

    def set_logger(self, logger: Logger) -> None:
        self.logger = logger

    async def start(self) -> None:
        if self._started:
            raise AlreadyStartedError(self.name)
        if self._stopped:
            raise AlreadyStoppedError(self.name)
        # flip the flag before awaiting so a concurrent start() cannot pass
        # the guard (reference BaseService uses an atomic CAS)
        self._started = True
        self.logger.debug("service start", service=self.name)
        try:
            await self.on_start()
        except BaseException:
            self._started = False
            raise

    async def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        self.logger.debug("service stop", service=self.name)
        self._quit.set()
        await self.on_stop()
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass
            except Exception as e:
                self.logger.error("background task died", service=self.name,
                                  task=t.get_name(), err=repr(e))
        self._tasks.clear()

    async def wait(self) -> None:
        """Block until the service is stopped."""
        await self._quit.wait()

    def spawn(self, coro, name: str = "") -> asyncio.Task:
        """Track a background task; cancelled on stop (goroutine analog)."""
        t = asyncio.create_task(coro, name=f"{self.name}/{name}")
        self._tasks.append(t)
        return t

    # -- hooks -------------------------------------------------------------
    async def on_start(self) -> None:  # pragma: no cover - default
        pass

    async def on_stop(self) -> None:  # pragma: no cover - default
        pass
