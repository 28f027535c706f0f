"""Structured key-value logging, trimmed to what the light client takes.

The port's copy of cometbft_tpu/libs/log.py (reference:
libs/log/logger.go): a Logger with bound context and debug / info /
warn / error, on the standard library's logging under the root logger
``cometbft_torch``.
"""
from __future__ import annotations

import logging
import sys
from typing import Any

_ROOT = "cometbft_torch"


class Logger:
    __slots__ = ("_logger", "_ctx")

    def __init__(self, logger: logging.Logger,
                 ctx: dict[str, Any] | None = None):
        self._logger = logger
        self._ctx = ctx or {}

    def _log(self, level: int, msg: str, kv: dict[str, Any]) -> None:
        if not self._logger.isEnabledFor(level):
            return
        # exc_info is a directive for the underlying logger, not a field
        exc_info = kv.pop("exc_info", None)
        items = {**self._ctx, **kv}
        if items:
            msg = f"{msg} " + " ".join(f"{k}={_render(v)}"
                                       for k, v in items.items())
        self._logger.log(level, msg, exc_info=exc_info)

    def debug(self, msg: str, **kv: Any) -> None:
        self._log(logging.DEBUG, msg, kv)

    def info(self, msg: str, **kv: Any) -> None:
        self._log(logging.INFO, msg, kv)

    def warn(self, msg: str, **kv: Any) -> None:
        self._log(logging.WARNING, msg, kv)

    def error(self, msg: str, **kv: Any) -> None:
        self._log(logging.ERROR, msg, kv)


def _render(v: Any) -> str:
    if isinstance(v, bytes):
        return v.hex().upper()[:16] or "''"
    s = str(v)
    return repr(s) if " " in s else s


def _configure_root() -> None:
    root = logging.getLogger(_ROOT)
    if root.handlers:
        return
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname).1s %(name)s: %(message)s"))
    root.addHandler(h)
    root.setLevel(logging.INFO)
    root.propagate = False


def new_logger(module: str = "main", level: str | int | None = None,
               **ctx: Any) -> Logger:
    """A logger for a module; ``level`` None inherits the root's."""
    _configure_root()
    lg = logging.getLogger(f"{_ROOT}.{module}")
    if level is not None:
        lg.setLevel(getattr(logging, level.upper())
                    if isinstance(level, str) else level)
    return Logger(lg, ctx)
