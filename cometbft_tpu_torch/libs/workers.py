"""A supervised single-thread worker for verification off the event loop.

Reference: cometbft_tpu/libs/workers.py (:46-145).  ``SupervisedWorker``
owns exactly one thread, so verification runs one batch at a time
whoever submits it.  Every task is timed from submit to start (the
``verify_queue_wait_seconds`` histogram) and the pending depth is a
gauge.  A task's exception is captured into its future and logged, and
the thread survives it.  The verify path holds the GIL only between its
native calls (the C prep and the CUDA launches release it), so an event
loop that awaits the future keeps running meanwhile.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Callable, Optional

from . import metrics as libmetrics

_log = logging.getLogger(__name__)

_QUEUE_WAIT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                       0.05, 0.1, 0.25, 0.5, 1.0, 2.5)


class SupervisedWorker:
    """One named worker thread with task-queue metrics and crash
    logging.  ``submit(fn, *args)`` returns a concurrent Future; tasks
    run in submission order on the single thread."""

    def __init__(self, worker_name: str, subsystem: str = "crypto",
                 registry: Optional[libmetrics.Registry] = None):
        self._name = worker_name
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._depth = 0
        self._depth_lock = threading.Lock()
        self._stopped = False
        reg = registry or libmetrics.DEFAULT
        wait_hist = reg.histogram(
            subsystem, "verify_queue_wait_seconds",
            "Time a task submitted to a verification worker waited "
            "in its queue before starting, by worker.",
            labels=("worker",), buckets=_QUEUE_WAIT_BUCKETS)
        depth_gauge = reg.gauge(
            subsystem, "verify_executor_depth",
            "Tasks queued or running on a verification worker, by "
            "worker.", labels=("worker",))
        self._wait_hist = wait_hist.with_labels(worker_name)
        self._depth_gauge = depth_gauge.with_labels(worker_name)
        self._thread = threading.Thread(
            target=self._run, name=f"worker-{worker_name}", daemon=True)
        self._thread.start()

    def submit(self, fn: Callable, *args) -> Future:
        """Queue ``fn(*args)``; the future resolves with its result or
        exception.  Raises RuntimeError after ``stop()``."""
        if self._stopped:
            raise RuntimeError(f"worker {self._name} is stopped")
        fut: Future = Future()
        with self._depth_lock:
            self._depth += 1
            self._depth_gauge.set(self._depth)
        self._q.put((fut, fn, args, time.perf_counter()))
        return fut

    def depth(self) -> int:
        return self._depth

    def stop(self, wait: bool = True) -> None:
        """Drain and join: tasks already queued still run, then the
        thread exits."""
        if self._stopped:
            return
        self._stopped = True
        self._q.put(None)
        if wait:
            self._thread.join(timeout=30)

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                # a submit() racing stop() can enqueue behind the
                # sentinel; its future must still resolve
                while True:
                    try:
                        item = self._q.get_nowait()
                    except queue.Empty:
                        return
                    if item is not None:
                        self._run_task(item)
            self._run_task(item)

    def _run_task(self, item) -> None:
        fut, fn, args, t_submit = item
        self._wait_hist.observe(time.perf_counter() - t_submit)
        if fut.set_running_or_notify_cancel():
            try:
                fut.set_result(fn(*args))
            except BaseException as e:  # noqa: BLE001 — supervised: the
                # future carries it and the log shows it (callers of
                # advisory work drop futures)
                _log.error("verify worker %s: task failed", self._name,
                           exc_info=True)
                try:
                    fut.set_exception(e)
                except InvalidStateError:
                    pass        # future cancelled while running
        with self._depth_lock:
            self._depth -= 1
            self._depth_gauge.set(self._depth)
