"""ABCI over gRPC (abci/grpc.py) against the JAX package's: the same
method table and descriptors, so every request and response of
tests/test_abci_socket.py rides the wire as the same bytes; the port's
GRPCClient against the JAX GRPCServer and the JAX client against the
port's server, echo, info, 100 concurrent CheckTx, FinalizeBlock and
Commit with equal app hashes; an app that raises aborts the call with the
same status and text; GRPCAppConns shares one channel; ClientCreator
reaches it only for the ``grpc`` transport; and ``DeadlineClient`` reads
a real ``AioRpcError`` as the JAX one does.  Skipped where ``grpc``
cannot be imported.  Equality is exact.
"""
import asyncio

import pytest

grpc = pytest.importorskip("grpc")

from cometbft_tpu.abci import client as r_client  # noqa: E402
from cometbft_tpu.abci import grpc as r_agrpc  # noqa: E402
from cometbft_tpu.abci import pb as r_pb  # noqa: E402
from cometbft_tpu.abci import types as r_abci  # noqa: E402
from cometbft_tpu.abci.kvstore import KVStoreApplication as RKVStore  # noqa: E402,E501
from cometbft_tpu.types.timestamp import Timestamp as RTimestamp  # noqa: E402
from cometbft_tpu.wire import encode as r_encode  # noqa: E402
from cometbft_tpu_torch.abci import client  # noqa: E402
from cometbft_tpu_torch.abci import grpc as agrpc  # noqa: E402
from cometbft_tpu_torch.abci import pb  # noqa: E402
from cometbft_tpu_torch.abci import types as abci  # noqa: E402
from cometbft_tpu_torch.abci.kvstore import KVStoreApplication  # noqa: E402
from cometbft_tpu_torch.types.timestamp import Timestamp  # noqa: E402
from cometbft_tpu_torch.wire import encode  # noqa: E402
from test_torch_abci import _requests, _responses  # noqa: E402
from torch_helpers import one_torch_thread  # noqa: E402,F401  (autouse)

PORT = {"abci": abci, "grpc": agrpc, "KVStore": KVStoreApplication,
        "Timestamp": Timestamp, "pb": pb, "encode": encode}
JAX = {"abci": r_abci, "grpc": r_agrpc, "KVStore": RKVStore,
       "Timestamp": RTimestamp, "pb": r_pb, "encode": r_encode}
PAIRS = [(PORT, PORT), (PORT, JAX), (JAX, PORT), (JAX, JAX)]
PAIR_IDS = ["port-port", "port_client-jax_server", "jax_client-port_server",
            "jax-jax"]


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def test_method_tables_equal_the_jax_ones():
    assert agrpc.SERVICE == r_agrpc.SERVICE
    assert list(agrpc._METHODS) == list(r_agrpc._METHODS)
    for name, (key, req, resp) in agrpc._METHODS.items():
        r_key, r_req, r_resp = r_agrpc._METHODS[name]
        assert (key, req.name, resp.name) == (r_key, r_req.name, r_resp.name)
    assert agrpc.GRPC_OPTIONS == r_agrpc.GRPC_OPTIONS
    for addr in ("grpc://h:1", "tcp://h:2", "h:3"):
        assert agrpc._grpc_addr(addr) == r_agrpc._grpc_addr(addr)


def _bare(side, env):
    """The bare per-method message of an envelope dict, as GRPCClient
    sends it, with its method's descriptor."""
    (key, body), = env.items()
    for method, (k, req, resp) in side["grpc"]._METHODS.items():
        if k == key:
            return method, body, req, resp
    return None


@pytest.mark.parametrize("i", range(16))
def test_request_bodies_on_the_wire_equal_the_jax_ones(i):
    mine = _bare(PORT, pb.request_to_proto(_requests(PORT)[i]))
    theirs = _bare(JAX, r_pb.request_to_proto(_requests(JAX)[i]))
    assert mine[0] == theirs[0]
    assert encode(mine[2], mine[1]) == r_encode(theirs[2], theirs[1])


@pytest.mark.parametrize("i", range(1, 17))
def test_response_bodies_on_the_wire_equal_the_jax_ones(i):
    mine = _bare(PORT, pb.response_to_proto(_responses(PORT)[i]))
    theirs = _bare(JAX, r_pb.response_to_proto(_responses(JAX)[i]))
    assert mine[0] == theirs[0]
    assert encode(mine[3], mine[1]) == r_encode(theirs[3], theirs[1])


async def _session(cli_side, srv_side, app, body):
    srv = srv_side["grpc"].GRPCServer("127.0.0.1:0", app)
    await srv.start()
    cli = cli_side["grpc"].GRPCClient(f"127.0.0.1:{srv.port}")
    await cli.connect(timeout_s=20)
    try:
        return await body(cli, cli_side["abci"])
    finally:
        await cli.close()
        await srv.stop()


async def _exercise(cli, a):
    out = [(await cli.echo("hello")).message]
    info = await cli.info(a.InfoRequest())
    out.append((info.data, info.last_block_height,
                sorted(info.lane_priorities.items()), info.default_lane))
    res = await asyncio.gather(*(
        cli.check_tx(a.CheckTxRequest(tx=f"k{i}=v{i}".encode(),
                                      type=a.CHECK_TX_TYPE_CHECK))
        for i in range(100)))
    out.append([(r.code, r.lane_id) for r in res])
    bad = await cli.check_tx(a.CheckTxRequest(tx=b"notatx"))
    out.append((bad.code, bad.log))
    fb = await cli.finalize_block(a.FinalizeBlockRequest(
        txs=[f"k{i}=v{i}".encode() for i in range(10)], height=1))
    out.append(([r.code for r in fb.tx_results], fb.app_hash))
    out.append((await cli.commit()).retain_height)
    q = await cli.query(a.QueryRequest(path="/store", data=b"k3"))
    out.append((q.code, q.value))
    info = await cli.info(a.InfoRequest())
    out.append((info.last_block_height, info.last_block_app_hash))
    await cli.flush()
    return out


@pytest.mark.parametrize("cli_side, srv_side", PAIRS, ids=PAIR_IDS)
def test_grpc_sessions_answer_alike_across_packages(cli_side, srv_side):
    got = run(_session(cli_side, srv_side, srv_side["KVStore"](), _exercise))
    want = run(_session(JAX, JAX, RKVStore(), _exercise))
    assert got == want
    assert {c for c, _ in got[2]} == {0} and got[-1][1] == got[4][1]


@pytest.mark.parametrize("cli_side, srv_side", PAIRS, ids=PAIR_IDS)
def test_an_app_error_aborts_with_the_jax_status(cli_side, srv_side):
    class Boom(srv_side["abci"].BaseApplication):
        async def query(self, req):
            raise RuntimeError("boom")

    async def body(cli, a):
        try:
            await cli.query(a.QueryRequest(path="x"))
        except grpc.aio.AioRpcError as e:
            err = (e.code().name, e.details())
        return err, (await cli.echo("still up")).message
    assert run(_session(cli_side, srv_side, Boom(), body)) == \
        (("INTERNAL", "boom"), "still up")


def test_grpc_app_conns_share_one_channel():
    async def go(side):
        srv = side["grpc"].GRPCServer("127.0.0.1:0", side["KVStore"]())
        await srv.start()
        conns = side["grpc"].GRPCAppConns(f"127.0.0.1:{srv.port}")
        await conns.start()
        try:
            same = conns.consensus is conns.mempool is conns.query is \
                conns.snapshot
            got = (await conns.query.echo("x")).message
        finally:
            await conns.stop()
            await srv.stop()
        return same, got
    assert run(go(PORT)) == run(go(JAX)) == (True, "x")
    creator = client.ClientCreator(addr="127.0.0.1:1", transport="grpc")
    assert type(creator.new_app_conns()) is agrpc.GRPCAppConns


def test_deadline_client_reads_a_real_rpc_error_as_the_jax_one():
    """A call to a port nothing listens on fails UNAVAILABLE (or its
    deadline): a transient transport error to both packages, so a
    read-only method is retried and a state-changing one is not."""
    async def go(mod):
        channel = grpc.aio.insecure_channel("127.0.0.1:1")
        call = channel.unary_unary(f"/{agrpc.SERVICE}/Echo",
                                   request_serializer=lambda m: b"",
                                   response_deserializer=lambda b: b)
        attempts = {}

        class Inner:
            def __getattr__(self, name):
                async def method(*a, **kw):
                    attempts[name] = attempts.get(name, 0) + 1
                    return await call({}, timeout=2.0)
                return method
        dc = mod.DeadlineClient(Inner(), retries=2, retry_backoff_s=0.001)
        out = []
        for name in ("info", "commit"):
            try:
                await getattr(dc, name)()
            except grpc.aio.AioRpcError as e:
                out.append((name, e.code().name in (
                    "UNAVAILABLE", "DEADLINE_EXCEEDED"),
                    mod._is_transient_transport_error(e), attempts[name]))
        await channel.close()
        return out
    assert run(go(client)) == run(go(r_client)) == [
        ("info", True, True, 3), ("commit", True, True, 1)]
