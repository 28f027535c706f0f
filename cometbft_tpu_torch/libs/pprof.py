"""Live profiling endpoint (reference: the pprof HTTP server gated by
`instrumentation.pprof_laddr`, config/config.go:488-490, started in
node/node.go pprofSrv).

The Go runtime's pprof surface maps onto the asyncio runtime:

    /debug/pprof/            index
    /debug/pprof/tasks       every asyncio task + current stack
                             (goroutine dump analog)
    /debug/pprof/threads     OS thread stacks
    /debug/pprof/heap        tracemalloc top allocations (?start=1
                             begins recording, ?stop=1 stops), plus
                             gc counters
    /debug/pprof/profile     cProfile for ?seconds=N (default 5),
                             pstats text sorted by cumulative time
    /debug/pprof/trace       the flight recorder's span timeline
                             (?dump=1 also writes a flight record)

Serves on its own listener like the reference — profiling must stay
reachable when the RPC listener is saturated.  A copy of
cometbft_tpu/libs/pprof.py: the same routes and texts.
"""
from __future__ import annotations

import asyncio
import gc
import io
import sys
import traceback
from typing import Optional

from .log import new_logger

logger = new_logger("pprof")


def _tasks_dump() -> str:
    out = [f"asyncio tasks: {len(asyncio.all_tasks())}\n"]
    for t in sorted(asyncio.all_tasks(), key=lambda t: t.get_name()):
        out.append(f"\n--- task {t.get_name()!r} "
                   f"{'(done)' if t.done() else ''}\n")
        buf = io.StringIO()
        t.print_stack(file=buf)
        out.append(buf.getvalue())
    return "".join(out)


def _threads_dump() -> str:
    out = []
    frames = sys._current_frames()
    import threading
    names = {t.ident: t.name for t in threading.enumerate()}
    for ident, frame in frames.items():
        out.append(f"\n--- thread {names.get(ident, '?')} "
                   f"({ident})\n")
        out.append("".join(traceback.format_stack(frame)))
    return "".join(out)


def _heap_dump(start: bool, stop: bool) -> str:
    import tracemalloc
    out = [f"gc counts: {gc.get_count()}  objects: "
           f"{len(gc.get_objects())}\n"]
    if stop:
        if tracemalloc.is_tracing():
            tracemalloc.stop()
        out.append("tracemalloc stopped\n")
        return "".join(out)
    if not tracemalloc.is_tracing():
        # tracing adds real per-allocation overhead on a validator:
        # it must be an explicit operator decision, never a side
        # effect of a monitoring probe touching the endpoint
        if start:
            tracemalloc.start()
            out.append("tracemalloc started — allocations recorded "
                       "from now on; request again for a snapshot\n")
        else:
            out.append("tracemalloc not running; pass ?start=1 to "
                       "begin recording allocations\n")
        return "".join(out)
    snap = tracemalloc.take_snapshot()
    out.append("top allocations by line:\n")
    for stat in snap.statistics("lineno")[:40]:
        out.append(f"  {stat}\n")
    return "".join(out)


async def _profile_dump(seconds: float) -> str:
    import cProfile
    import pstats
    prof = cProfile.Profile()
    try:
        prof.enable()
    except ValueError:
        # another profiler (e.g. a concurrent /profile request) owns
        # the hook — report it instead of dropping the connection
        return ("profiler busy: another profiling session is "
                "active; retry when it completes\n")
    try:
        await asyncio.sleep(min(seconds, 120.0))
    finally:
        prof.disable()
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("cumulative") \
        .print_stats(60)
    return buf.getvalue()


def _trace_dump(write_file: bool) -> str:
    """Flight-recorder dump hook (libs/tracing.py): the whole span
    timeline as JSON; ?dump=1 also writes a flight-record file to the
    configured dump dir and reports its path."""
    import json as _json

    from . import tracing
    out = {"enabled": tracing.enabled(),
           "events": tracing.snapshot()}
    if write_file:
        out["dump_path"] = tracing.dump(reason="pprof_request")
    return _json.dumps(out, indent=1) + "\n"


_INDEX = """pprof endpoints (asyncio runtime):
/debug/pprof/tasks     asyncio task dump (goroutine analog)
/debug/pprof/threads   OS thread stacks
/debug/pprof/heap      tracemalloc allocations (?start=1 begins
                         recording, ?stop=1 stops)
/debug/pprof/profile   CPU profile, ?seconds=N (default 5)
/debug/pprof/trace     flight-recorder timeline (?dump=1 writes a
                         flight-record file too)
"""


class PprofServer:
    """Reference: node/node.go pprofSrv."""

    def __init__(self, listen_addr: str):
        # "host:port" or ":port"
        addr = listen_addr.replace("tcp://", "")
        host, _, port = addr.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self.listen_addr = ""
        self._server: Optional[asyncio.base_events.Server] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        sock = self._server.sockets[0].getsockname()
        self.listen_addr = f"{sock[0]}:{sock[1]}"
        logger.info("pprof listening", addr=self.listen_addr)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            request_line = await reader.readline()
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
            parts = request_line.decode().split(" ")
            target = parts[1] if len(parts) > 1 else "/"
            path, _, query = target.partition("?")
            params = dict(
                kv.split("=", 1) for kv in query.split("&")
                if "=" in kv)
            if path in ("/debug/pprof", "/debug/pprof/"):
                body = _INDEX
            elif path == "/debug/pprof/tasks":
                body = _tasks_dump()
            elif path == "/debug/pprof/threads":
                body = _threads_dump()
            elif path == "/debug/pprof/heap":
                body = _heap_dump(params.get("start") == "1",
                                  params.get("stop") == "1")
            elif path == "/debug/pprof/trace":
                body = _trace_dump(params.get("dump") == "1")
            elif path == "/debug/pprof/profile":
                try:
                    seconds = float(params.get("seconds", "5"))
                except ValueError:
                    seconds = 5.0
                body = await _profile_dump(seconds)
            else:
                writer.write(b"HTTP/1.1 404 Not Found\r\n"
                             b"Content-Length: 0\r\n\r\n")
                await writer.drain()
                return
            payload = body.encode()
            writer.write(
                b"HTTP/1.1 200 OK\r\n"
                b"Content-Type: text/plain; charset=utf-8\r\n"
                b"Content-Length: " + str(len(payload)).encode() +
                b"\r\nConnection: close\r\n\r\n" + payload)
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError,
                ValueError):
            pass
        finally:
            try:
                writer.close()
            except OSError:
                pass
