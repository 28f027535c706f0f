"""Fail points: env-indexed crash injection for crash-consistency tests.

Reference: internal/fail/fail.go:28, through cometbft_tpu/libs/fail.py —
`fail.fail()` calls sit on the commit path; when the environment
variable FAIL_TEST_INDEX equals the running call index, the process
exits at once (no cleanup, no flushing — a real crash), so a replay test
can crash a node at each boundary and check that it recovers.
"""
from __future__ import annotations

import os

ENV_VAR = "FAIL_TEST_INDEX"

_target = int(os.environ.get(ENV_VAR, "-1") or "-1")
_counter = 0


def fail() -> None:
    """Crash the process if this is the FAIL_TEST_INDEX-th call."""
    global _counter
    if _target < 0:
        return
    if _counter == _target:
        os._exit(99)                      # hard exit: no atexit, no flush
    _counter += 1


def call_count() -> int:
    return _counter


def reset(target: int = -1) -> None:
    """Test hook: re-arm in-process."""
    global _target, _counter
    _target = target
    _counter = 0
