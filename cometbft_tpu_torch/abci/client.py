"""ABCI clients.

Reference: abci/client/ — local_client (in-process, mutexed),
unsync_local_client, socket_client (pipelined,
abci/client/socket_client.go) and proxy/multi_app_conn.go (the four
named connections), through cometbft_tpu/abci/client.py: the same
frames, matching, deadlines, retries and texts.  The deadline and
tracing wrappers sit over any transport; ``ClientCreator`` imports the
gRPC transport (abci/grpc.py, the one module here that needs ``grpc``)
only when it is asked for.
"""
from __future__ import annotations

import asyncio
from typing import Optional

from . import types as abci


class ABCIClientError(Exception):
    pass


class ABCITimeoutError(ABCIClientError):
    """A remote ABCI call exceeded its deadline."""


# ---------------------------------------------------------------------
# Deadline propagation for remote (socket/gRPC) transports: a wedged
# app process must not hang consensus forever.  Consensus-path methods
# may legitimately run long (a big FinalizeBlock), so they get a wider
# budget than queries.

_SLOW_METHODS = frozenset({
    "init_chain", "prepare_proposal", "process_proposal",
    "finalize_block", "commit", "extend_vote", "offer_snapshot",
    "apply_snapshot_chunk"})

# read-only / idempotent methods safe to retry after a transient
# transport error (a state-mutating call may have executed before the
# transport died, so it gets exactly one attempt)
_RETRIABLE_METHODS = frozenset({
    "echo", "info", "query", "flush", "list_snapshots",
    "load_snapshot_chunk"})


def _is_transient_transport_error(e: BaseException) -> bool:
    if isinstance(e, (ConnectionError, asyncio.IncompleteReadError,
                      OSError)):
        return True
    # grpc.aio.AioRpcError without importing grpc here (the socket
    # transport must not require the grpc package)
    code = getattr(e, "code", None)
    if callable(code):
        try:
            return getattr(code(), "name", "") in (
                "UNAVAILABLE", "DEADLINE_EXCEEDED")
        except Exception:
            return False
    return False


class DeadlineClient:
    """Transparent per-call deadline + bounded-retry wrapper over any
    ABCI client (socket or gRPC).

    Every coroutine method gets asyncio.wait_for with a per-method
    timeout (the slow/default split); read-only methods
    are retried up to ``retries`` times on transient transport errors
    with exponential backoff.  A deadline miss surfaces as
    ABCITimeoutError so callers can distinguish a wedged app from an
    app-level failure."""

    def __init__(self, inner, default_timeout_s: float = 20.0,
                 slow_timeout_s: float = 0.0, retries: int = 2,
                 retry_backoff_s: float = 0.1, logger=None):
        object.__setattr__(self, "_inner", inner)
        self._default_timeout_s = default_timeout_s
        # consensus-path calls default to 6x the query budget
        self._slow_timeout_s = slow_timeout_s or 6 * default_timeout_s
        self._retries = max(0, retries)
        self._retry_backoff_s = retry_backoff_s
        if logger is None:
            from ..libs.log import new_logger
            logger = new_logger("abci-deadline")
        self._logger = logger

    def timeout_for(self, method: str) -> float:
        return self._slow_timeout_s if method in _SLOW_METHODS \
            else self._default_timeout_s

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name.startswith("_") or not callable(attr) or \
                not asyncio.iscoroutinefunction(attr):
            return attr
        timeout = self.timeout_for(name)
        attempts = 1 + (self._retries
                        if name in _RETRIABLE_METHODS else 0)
        logger = self._logger
        backoff = self._retry_backoff_s

        async def bounded(*a, **kw):
            for i in range(attempts):
                try:
                    return await asyncio.wait_for(
                        attr(*a, **kw),
                        timeout if timeout > 0 else None)
                except asyncio.TimeoutError:
                    raise ABCITimeoutError(
                        f"ABCI {name} exceeded its {timeout}s "
                        f"deadline") from None
                except Exception as e:  # noqa: BLE001 — classify below
                    if i + 1 < attempts and \
                            _is_transient_transport_error(e):
                        logger.info("retrying ABCI call after "
                                    "transient transport error",
                                    method=name, attempt=i + 1,
                                    err=repr(e))
                        await asyncio.sleep(backoff * (2 ** i))
                        continue
                    raise

        # cache so the hot path (every CheckTx) never re-enters
        # __getattr__ for this method again
        object.__setattr__(self, name, bounded)
        return bounded


class TracingClient:
    """Flight-recorder span per ABCI call (libs/tracing.py category
    "abci", name "<conn>/<method>") — the execute slice of the
    per-height trace timeline.  Transparent like DeadlineClient;
    near-zero overhead when tracing is disabled."""

    def __init__(self, inner, conn_name: str):
        object.__setattr__(self, "_inner", inner)
        object.__setattr__(self, "_conn_name", conn_name)

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name.startswith("_") or not callable(attr) or \
                not asyncio.iscoroutinefunction(attr):
            return attr
        from ..libs import tracing
        label = f"{self._conn_name}/{name}"

        async def traced(*a, **kw):
            with tracing.span(tracing.ABCI, label):
                return await attr(*a, **kw)

        # cache so the hot path (every CheckTx) never re-enters
        # __getattr__ for this method again
        object.__setattr__(self, name, traced)
        return traced


def apply_tracing(app_conns) -> None:
    """Wrap the four named connections with flight-recorder spans
    (all transports — a builtin app's FinalizeBlock time is exactly
    what the per-height breakdown needs to attribute)."""
    for conn in ("consensus", "mempool", "query", "snapshot"):
        inner = getattr(app_conns, conn, None)
        if inner is not None and not isinstance(inner, TracingClient):
            setattr(app_conns, conn, TracingClient(inner, conn))
    return app_conns


def apply_deadlines(app_conns, default_timeout_s: float,
                    retries: int = 2) -> None:
    """Wrap the four named connections with per-call deadlines
    (remote transports only — a builtin app shares our event loop, so
    a deadline there would fire on our own backpressure)."""
    for conn in ("consensus", "mempool", "query", "snapshot"):
        inner = getattr(app_conns, conn, None)
        if inner is not None and not isinstance(inner, DeadlineClient):
            setattr(app_conns, conn, DeadlineClient(
                inner, default_timeout_s=default_timeout_s,
                retries=retries))
    return app_conns


class LocalClient:
    """In-process client serializing calls with one lock.

    Reference: abci/client/local_client.go — a global mutex makes the app
    see at most one concurrent call, which is the ABCI concurrency
    contract for a single connection.
    """

    def __init__(self, app: abci.Application,
                 lock: Optional[asyncio.Lock] = None):
        self._app = app
        self._lock = lock if lock is not None else asyncio.Lock()

    @property
    def app(self) -> abci.Application:
        return self._app

    async def echo(self, message: str) -> abci.EchoResponse:
        async with self._lock:
            return await self._app.echo(abci.EchoRequest(message=message))

    async def flush(self) -> None:
        return None

    async def info(self, req: abci.InfoRequest) -> abci.InfoResponse:
        async with self._lock:
            return await self._app.info(req)

    async def query(self, req: abci.QueryRequest) -> abci.QueryResponse:
        async with self._lock:
            return await self._app.query(req)

    async def check_tx(self, req: abci.CheckTxRequest
                       ) -> abci.CheckTxResponse:
        async with self._lock:
            return await self._app.check_tx(req)

    async def init_chain(self, req: abci.InitChainRequest
                         ) -> abci.InitChainResponse:
        async with self._lock:
            return await self._app.init_chain(req)

    async def prepare_proposal(self, req: abci.PrepareProposalRequest
                               ) -> abci.PrepareProposalResponse:
        async with self._lock:
            return await self._app.prepare_proposal(req)

    async def process_proposal(self, req: abci.ProcessProposalRequest
                               ) -> abci.ProcessProposalResponse:
        async with self._lock:
            return await self._app.process_proposal(req)

    async def finalize_block(self, req: abci.FinalizeBlockRequest
                             ) -> abci.FinalizeBlockResponse:
        async with self._lock:
            return await self._app.finalize_block(req)

    async def extend_vote(self, req: abci.ExtendVoteRequest
                          ) -> abci.ExtendVoteResponse:
        async with self._lock:
            return await self._app.extend_vote(req)

    async def verify_vote_extension(
            self, req: abci.VerifyVoteExtensionRequest
    ) -> abci.VerifyVoteExtensionResponse:
        async with self._lock:
            return await self._app.verify_vote_extension(req)

    async def commit(self) -> abci.CommitResponse:
        async with self._lock:
            return await self._app.commit(abci.CommitRequest())

    async def list_snapshots(self, req: abci.ListSnapshotsRequest
                             ) -> abci.ListSnapshotsResponse:
        async with self._lock:
            return await self._app.list_snapshots(req)

    async def offer_snapshot(self, req: abci.OfferSnapshotRequest
                             ) -> abci.OfferSnapshotResponse:
        async with self._lock:
            return await self._app.offer_snapshot(req)

    async def load_snapshot_chunk(self, req: abci.LoadSnapshotChunkRequest
                                  ) -> abci.LoadSnapshotChunkResponse:
        async with self._lock:
            return await self._app.load_snapshot_chunk(req)

    async def apply_snapshot_chunk(
            self, req: abci.ApplySnapshotChunkRequest
    ) -> abci.ApplySnapshotChunkResponse:
        async with self._lock:
            return await self._app.apply_snapshot_chunk(req)


class _NoopLock:
    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        return False


class UnsyncLocalClient(LocalClient):
    """Local client without any lock: the app handles its own
    synchronization (reference: unsync_local_client.go has no mutex)."""

    def __init__(self, app: abci.Application):
        super().__init__(app, lock=_NoopLock())


class AppConns:
    """The four named ABCI connections sharing one client.

    Reference: proxy/multi_app_conn.go — consensus/mempool/query/snapshot.
    With a local client they share one mutex (the reference's
    NewConnSyncLocalClientCreator semantics).
    """

    async def start(self) -> None:
        """No-op: local conns have no transport (lifecycle parity with
        SocketAppConns)."""

    async def stop(self) -> None:
        """No-op."""

    def __init__(self, app: abci.Application, sync: bool = True):
        if sync:
            lock = asyncio.Lock()
            self.consensus = LocalClient(app, lock)
            self.mempool = LocalClient(app, lock)
            self.query = LocalClient(app, lock)
            self.snapshot = LocalClient(app, lock)
        else:
            self.consensus = UnsyncLocalClient(app)
            self.mempool = UnsyncLocalClient(app)
            self.query = UnsyncLocalClient(app)
            self.snapshot = UnsyncLocalClient(app)


class ClientCreator:
    """Reference: proxy/client.go ClientCreator — local vs remote."""

    def __init__(self, app: Optional[abci.Application] = None,
                 addr: str = "", transport: str = "local"):
        self._app = app
        self._addr = addr
        self._transport = transport

    def new_app_conns(self):
        if self._transport in ("local", "builtin", "builtin_unsync"):
            if self._app is None:
                raise ABCIClientError("local client requires an app")
            return AppConns(self._app,
                            sync=self._transport != "builtin_unsync")
        if self._transport in ("socket", "unix", "tcp"):
            return SocketAppConns(self._addr)
        if self._transport == "grpc":
            from .grpc import GRPCAppConns
            return GRPCAppConns(self._addr)
        raise ABCIClientError(
            f"transport {self._transport!r} not supported")


class SocketClient:
    """Pipelined async client over a unix/tcp socket.

    Reference: abci/client/socket_client.go:515 — requests are written
    immediately and matched FIFO against the response stream, so many
    calls (e.g. mempool CheckTx under load) can be in flight at once; the
    server processes them in order, which preserves the per-connection
    ABCI ordering contract.  An ExceptionResponse or transport error fails
    every pending call (reference StopForError semantics).
    """

    def __init__(self, address: str, logger=None):
        from ..libs.log import new_logger
        self.address = address
        self.logger = logger or new_logger("abci-client")
        self._reader = None
        self._writer = None
        self._pending: "asyncio.Queue[tuple[str, asyncio.Future]]" = None  # type: ignore[assignment]
        self._recv_task = None
        self._err: Optional[Exception] = None

    async def connect(self, retries: int = 80,
                      retry_delay: float = 0.25) -> None:
        from .server import parse_address
        scheme, host, port = parse_address(self.address)
        last: Optional[Exception] = None
        for _ in range(retries):
            try:
                if scheme == "unix":
                    self._reader, self._writer = \
                        await asyncio.open_unix_connection(host)
                else:
                    self._reader, self._writer = \
                        await asyncio.open_connection(host, port)
                break
            except OSError as e:
                last = e
                await asyncio.sleep(retry_delay)
        else:
            raise ABCIClientError(
                f"cannot connect to ABCI app at {self.address}: {last}")
        self._pending = asyncio.Queue()
        self._recv_task = asyncio.create_task(self._recv_loop())

    async def close(self) -> None:
        if self._err is None:
            self._err = ABCIClientError("client closed")
        self._fail_pending(self._err)
        if self._recv_task is not None:
            self._recv_task.cancel()
            try:
                await self._recv_task
            except (asyncio.CancelledError, Exception):
                pass
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass

    async def _recv_loop(self) -> None:
        from . import pb
        from .server import read_frame
        fut = None
        try:
            while True:
                payload = await read_frame(self._reader)
                if payload is None:
                    raise ABCIClientError("ABCI connection closed by app")
                resp = pb.decode_response(payload)
                if self._pending.empty():
                    raise ABCIClientError(
                        f"unsolicited {type(resp).__name__}")
                want, fut = self._pending.get_nowait()
                if isinstance(resp, abci.ExceptionResponse):
                    # reference StopForError semantics: an app exception
                    # is fatal — the app's state is unknown, so fail this
                    # call, every pending call, and the client itself
                    raise ABCIClientError(f"app exception: {resp.error}")
                got = type(resp).__name__.replace("Response", "")
                if got != want:
                    raise ABCIClientError(
                        f"response out of order: want {want}, got {got}")
                if not fut.done():
                    fut.set_result(resp)
                fut = None
        except asyncio.CancelledError:
            if fut is not None and not fut.done():
                fut.set_exception(ABCIClientError("client stopped"))
            self._fail_pending(ABCIClientError("client stopped"))
            raise
        except Exception as e:  # noqa: BLE001 — fail every in-flight call
            self._err = e
            if fut is not None and not fut.done():
                fut.set_exception(e)
            self._fail_pending(e)

    def _fail_pending(self, err: Exception) -> None:
        while self._pending is not None and not self._pending.empty():
            _, fut = self._pending.get_nowait()
            if not fut.done():
                fut.set_exception(err)

    async def _call(self, req, want: str):
        from . import pb
        if self._err is not None:
            raise ABCIClientError(f"ABCI client dead: {self._err}")
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._pending.put_nowait((want, fut))
        data = pb.encode_request_frame(req)
        if want != "Flush":
            # reference socket_client.go follows every queued request
            # with a Flush so a buffered-writer server (the Go one)
            # actually sends the response; the flush response resolves a
            # throwaway future to keep FIFO matching aligned
            self._pending.put_nowait(("Flush", loop.create_future()))
            data += pb.encode_request_frame(abci.FlushRequest())
        self._writer.write(data)
        await self._writer.drain()
        return await fut

    # -- the 15-method surface + echo/flush ------------------------------
    async def echo(self, message: str) -> abci.EchoResponse:
        return await self._call(abci.EchoRequest(message=message), "Echo")

    async def flush(self) -> None:
        await self._call(abci.FlushRequest(), "Flush")

    async def info(self, req: abci.InfoRequest) -> abci.InfoResponse:
        return await self._call(req, "Info")

    async def query(self, req: abci.QueryRequest) -> abci.QueryResponse:
        return await self._call(req, "Query")

    async def check_tx(self, req: abci.CheckTxRequest
                       ) -> abci.CheckTxResponse:
        return await self._call(req, "CheckTx")

    async def init_chain(self, req: abci.InitChainRequest
                         ) -> abci.InitChainResponse:
        return await self._call(req, "InitChain")

    async def prepare_proposal(self, req: abci.PrepareProposalRequest
                               ) -> abci.PrepareProposalResponse:
        return await self._call(req, "PrepareProposal")

    async def process_proposal(self, req: abci.ProcessProposalRequest
                               ) -> abci.ProcessProposalResponse:
        return await self._call(req, "ProcessProposal")

    async def finalize_block(self, req: abci.FinalizeBlockRequest
                             ) -> abci.FinalizeBlockResponse:
        return await self._call(req, "FinalizeBlock")

    async def extend_vote(self, req: abci.ExtendVoteRequest
                          ) -> abci.ExtendVoteResponse:
        return await self._call(req, "ExtendVote")

    async def verify_vote_extension(
            self, req: abci.VerifyVoteExtensionRequest
    ) -> abci.VerifyVoteExtensionResponse:
        return await self._call(req, "VerifyVoteExtension")

    async def commit(self) -> abci.CommitResponse:
        return await self._call(abci.CommitRequest(), "Commit")

    async def list_snapshots(self, req: abci.ListSnapshotsRequest
                             ) -> abci.ListSnapshotsResponse:
        return await self._call(req, "ListSnapshots")

    async def offer_snapshot(self, req: abci.OfferSnapshotRequest
                             ) -> abci.OfferSnapshotResponse:
        return await self._call(req, "OfferSnapshot")

    async def load_snapshot_chunk(self, req: abci.LoadSnapshotChunkRequest
                                  ) -> abci.LoadSnapshotChunkResponse:
        return await self._call(req, "LoadSnapshotChunk")

    async def apply_snapshot_chunk(
            self, req: abci.ApplySnapshotChunkRequest
    ) -> abci.ApplySnapshotChunkResponse:
        return await self._call(req, "ApplySnapshotChunk")


class SocketAppConns:
    """proxy.AppConns over four socket connections to one app process
    (reference: multi_app_conn.go creates one client per named conn)."""

    def __init__(self, address: str):
        self.consensus = SocketClient(address)
        self.mempool = SocketClient(address)
        self.query = SocketClient(address)
        self.snapshot = SocketClient(address)

    async def start(self) -> None:
        for c in (self.consensus, self.mempool, self.query, self.snapshot):
            await c.connect()

    async def stop(self) -> None:
        for c in (self.consensus, self.mempool, self.query, self.snapshot):
            await c.close()
