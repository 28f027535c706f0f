"""The port's ABCI socket protocol, clients and tools against the JAX
package's:

  * every request and response of tests/test_abci_socket.py encodes to
    the JAX frame bytes (abci/pb.py, the full wire/abci_pb.py), and each
    package decodes the other's frames to equal objects;
  * the socket client and server interoperate both ways over a unix
    socket: echo, info, 100 pipelined CheckTx, FinalizeBlock and Commit
    give the same answers and app hashes for every pairing; an app that
    raises answers an ExceptionResponse that kills the client with the
    JAX texts; oversized frames are refused with the JAX text;
  * ``DeadlineClient``'s deadlines, texts and retries per method,
    ``_is_transient_transport_error``, ``TracingClient``,
    ``apply_tracing`` / ``apply_deadlines``, ``ClientCreator`` and the
    proxy metrics equal the JAX ones;
  * ``GrammarChecker`` gives the verdicts and texts of
    tests/test_confix_grammar.py, and ``RecordingClient`` records the
    same traces;
  * ``abci.cli`` prints what the JAX CLI prints, against a builtin app
    and against an app process; the server process prints the JAX ready
    line and loads no torch;
  * the slice as a whole: a port ConsensusState over SocketAppConns to a
    ``python -m cometbft_tpu_torch.abci.server`` process commits 3
    heights of config 1's txs with the stores of the in-process twin (B1's
    plain version, ``device="cpu"``);
  * chip_smoke.py's phase 18, rehearsed at 12 validators.

Equality is exact.
"""
import asyncio
import contextlib
import io
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

from cometbft_tpu.abci import cli as r_cli
from cometbft_tpu.abci import client as r_client
from cometbft_tpu.abci import grammar as r_grammar
from cometbft_tpu.abci import metrics as r_abci_metrics
from cometbft_tpu.abci import pb as r_pb
from cometbft_tpu.abci import server as r_server
from cometbft_tpu.abci import types as r_abci
from cometbft_tpu.abci.kvstore import KVStoreApplication as RKVStore
from cometbft_tpu.crypto import batch as r_batch
from cometbft_tpu.libs import metrics as r_metrics
from cometbft_tpu.types import vote as r_vote_mod
from cometbft_tpu.types.timestamp import Timestamp as RTimestamp
from cometbft_tpu.wire.proto import decode_uvarint as r_decode_uvarint
from cometbft_tpu_torch.abci import cli
from cometbft_tpu_torch.abci import client
from cometbft_tpu_torch.abci import grammar
from cometbft_tpu_torch.abci import metrics as abci_metrics
from cometbft_tpu_torch.abci import pb
from cometbft_tpu_torch.abci import server
from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.libs import metrics
from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import ed25519_kernel8 as ek8
from cometbft_tpu_torch.types import vote as vote_mod
from cometbft_tpu_torch.types.timestamp import Timestamp
from cometbft_tpu_torch.wire.proto import decode_uvarint, encode_uvarint
from torch_chain import cs, port_chain, seeds
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
PORT = {"abci": abci, "client": client, "server": server, "pb": pb,
        "KVStore": KVStoreApplication, "Timestamp": Timestamp,
        "grammar": grammar, "cli": cli}
JAX = {"abci": r_abci, "client": r_client, "server": r_server, "pb": r_pb,
       "KVStore": RKVStore, "Timestamp": RTimestamp, "grammar": r_grammar,
       "cli": r_cli}


@pytest.fixture(autouse=True)
def _fresh():
    yield
    pipeline.reset_workers()
    oe.reset_bucket_tuning()


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


# -- frames ----------------------------------------------------------------------

def _requests(s):
    a, ts = s["abci"], s["Timestamp"](1700000001, 500)
    val = a.ABCIValidator(address=b"\x01" * 20, power=10)
    return [
        a.EchoRequest(message="hi"),
        a.FlushRequest(),
        a.InfoRequest(version="1.0", block_version=11, p2p_version=9,
                      abci_version="2.0"),
        a.InitChainRequest(
            time=ts, chain_id="c", validators=[
                a.ValidatorUpdate(power=5, pub_key_bytes=b"\x02" * 32,
                                  pub_key_type="ed25519")],
            app_state_bytes=b"{}", initial_height=1),
        a.QueryRequest(data=b"k", path="/store", height=3, prove=True),
        a.CheckTxRequest(tx=b"a=1", type=a.CHECK_TX_TYPE_CHECK),
        a.CommitRequest(),
        a.ListSnapshotsRequest(),
        a.OfferSnapshotRequest(
            snapshot=a.Snapshot(height=5, format=1, chunks=2,
                                hash=b"h" * 32, metadata=b"m"),
            app_hash=b"a" * 32),
        a.LoadSnapshotChunkRequest(height=5, format=1, chunk=1),
        a.ApplySnapshotChunkRequest(index=1, chunk=b"c", sender="n0"),
        a.PrepareProposalRequest(
            max_tx_bytes=1000, txs=[b"t1", b"t2"],
            local_last_commit=a.ExtendedCommitInfo(
                round=1, votes=[a.ExtendedVoteInfo(
                    validator=val, vote_extension=b"e",
                    extension_signature=b"s" * 64, block_id_flag=2,
                    non_rp_vote_extension=b"n",
                    non_rp_extension_signature=b"t" * 64)]),
            misbehavior=[a.Misbehavior(
                type=a.MISBEHAVIOR_TYPE_DUPLICATE_VOTE, validator=val,
                height=2, time=ts, total_voting_power=10)],
            height=7, time=ts, next_validators_hash=b"v" * 32,
            proposer_address=b"\x03" * 20),
        a.ProcessProposalRequest(
            txs=[b"t"], proposed_last_commit=a.CommitInfo(
                round=0, votes=[a.VoteInfo(validator=val,
                                           block_id_flag=2)]),
            hash=b"H" * 32, height=7, time=ts,
            next_validators_hash=b"v" * 32, proposer_address=b"\x03" * 20),
        a.ExtendVoteRequest(hash=b"H" * 32, height=7, time=ts, txs=[b"t"]),
        a.VerifyVoteExtensionRequest(
            hash=b"H" * 32, validator_address=b"\x01" * 20, height=7,
            vote_extension=b"e", non_rp_vote_extension=b"n"),
        a.FinalizeBlockRequest(
            txs=[b"t1"], hash=b"H" * 32, height=7, time=ts,
            next_validators_hash=b"v" * 32, proposer_address=b"\x03" * 20,
            syncing_to_height=7),
    ]


def _responses(s):
    a = s["abci"]
    return [
        a.ExceptionResponse(error="boom"),
        a.EchoResponse(message="hi"),
        a.FlushResponse(),
        a.InfoResponse(data="kv", version="1", app_version=1,
                       last_block_height=5, last_block_app_hash=b"h" * 32,
                       lane_priorities={"a": 1, "b": 3}, default_lane="a"),
        a.InitChainResponse(validators=[
            a.ValidatorUpdate(power=3, pub_key_bytes=b"\x02" * 32,
                              pub_key_type="ed25519")], app_hash=b"x" * 32),
        a.QueryResponse(code=0, value=b"v", height=3, index=1, key=b"k",
                        proof_ops={"ops": [{"type": "ics23:iavl",
                                            "key": b"k", "data": b"p"}]}),
        a.CheckTxResponse(code=0, gas_wanted=1, lane_id="fast",
                          events=[a.Event(type="tx", attributes=[
                              a.EventAttribute(key="k", value="v",
                                               index=True)])],
                          recheck_keys=[b"k"]),
        a.CommitResponse(retain_height=2),
        a.ListSnapshotsResponse(snapshots=[
            a.Snapshot(height=1, format=1, chunks=1, hash=b"h" * 32)]),
        a.OfferSnapshotResponse(result=a.OFFER_SNAPSHOT_RESULT_ACCEPT),
        a.LoadSnapshotChunkResponse(chunk=b"c"),
        a.ApplySnapshotChunkResponse(
            result=a.APPLY_SNAPSHOT_CHUNK_RESULT_ACCEPT,
            refetch_chunks=[1, 2], reject_senders=["bad"]),
        a.PrepareProposalResponse(txs=[b"t"]),
        a.ProcessProposalResponse(status=a.PROCESS_PROPOSAL_STATUS_ACCEPT),
        a.ExtendVoteResponse(vote_extension=b"e", non_rp_extension=b"n"),
        a.VerifyVoteExtensionResponse(
            status=a.VERIFY_VOTE_EXTENSION_STATUS_ACCEPT),
        a.FinalizeBlockResponse(
            tx_results=[a.ExecTxResult(code=0, gas_used=1)],
            app_hash=b"a" * 32),
    ]


def _payload(frame, decode):
    size, pos = decode(frame, 0)
    assert size == len(frame) - pos
    return frame[pos:]


@pytest.mark.parametrize("i", range(16))
def test_request_frames_equal_the_jax_ones(i):
    mine, theirs = _requests(PORT)[i], _requests(JAX)[i]
    frame = pb.encode_request_frame(mine)
    assert frame == r_pb.encode_request_frame(theirs)
    assert pb.decode_request(_payload(frame, decode_uvarint)) == mine
    back = r_pb.decode_request(_payload(frame, r_decode_uvarint))
    assert back == theirs
    assert pb.request_to_proto(mine) == r_pb.request_to_proto(theirs)


@pytest.mark.parametrize("i", range(17))
def test_response_frames_equal_the_jax_ones(i):
    mine, theirs = _responses(PORT)[i], _responses(JAX)[i]
    frame = pb.encode_response_frame(mine)
    assert frame == r_pb.encode_response_frame(theirs)
    assert pb.decode_response(_payload(frame, decode_uvarint)) == mine
    assert r_pb.decode_response(_payload(frame, r_decode_uvarint)) == theirs


def test_unknown_envelopes_raise_the_jax_texts():
    for mod in (pb, r_pb):
        with pytest.raises(mod.ABCIProtoError,
                           match="^unknown request type object$"):
            mod.request_to_proto(object())
        with pytest.raises(mod.ABCIProtoError,
                           match=r"^unknown response oneof: \['x'\]$"):
            mod.response_from_proto({"x": {}})
    assert pb.MAX_MSG_SIZE == r_pb.MAX_MSG_SIZE


# -- the socket client and server, across packages -------------------------------

PAIRS = [(PORT, PORT), (PORT, JAX), (JAX, PORT), (JAX, JAX)]
PAIR_IDS = ["port-port", "port_client-jax_server", "jax_client-port_server",
            "jax-jax"]


@contextlib.contextmanager
def _sock_dir():
    with tempfile.TemporaryDirectory(prefix="abci") as d:
        yield d


async def _session(cli_side, srv_side, app, d, body):
    addr = f"unix://{os.path.join(d, 'app.sock')}"
    srv = srv_side["server"].SocketServer(addr, app)
    await srv.start()
    cli = cli_side["client"].SocketClient(addr)
    await cli.connect()
    try:
        return await body(cli, cli_side["abci"])
    finally:
        await cli.close()
        await srv.stop()


async def _exercise(cli, a):
    out = [(await cli.echo("hello")).message]
    info = await cli.info(a.InfoRequest())
    out.append((info.data, info.version, info.last_block_height,
                sorted(info.lane_priorities.items()), info.default_lane))
    res = await asyncio.gather(*(
        cli.check_tx(a.CheckTxRequest(tx=f"k{i}=v{i}".encode(),
                                      type=a.CHECK_TX_TYPE_CHECK))
        for i in range(100)))
    out.append([(r.code, r.lane_id, r.recheck_keys) for r in res])
    bad = await cli.check_tx(a.CheckTxRequest(tx=b"notatx"))
    out.append((bad.code, bad.log))
    fb = await cli.finalize_block(a.FinalizeBlockRequest(
        txs=[f"k{i}=v{i}".encode() for i in range(10)], height=1))
    out.append(([(r.code, len(r.events)) for r in fb.tx_results],
                fb.app_hash))
    out.append((await cli.commit()).retain_height)
    q = await cli.query(a.QueryRequest(path="/store", data=b"k3"))
    out.append((q.code, q.value, q.height))
    info = await cli.info(a.InfoRequest())
    out.append((info.last_block_height, info.last_block_app_hash))
    await cli.flush()
    return out


@pytest.mark.parametrize("cli_side, srv_side", PAIRS, ids=PAIR_IDS)
def test_socket_sessions_answer_alike_across_packages(cli_side, srv_side):
    with _sock_dir() as d:
        got = run(_session(cli_side, srv_side, srv_side["KVStore"](), d,
                           _exercise))
    with _sock_dir() as d:
        want = run(_session(JAX, JAX, RKVStore(), d, _exercise))
    assert got == want
    assert len(got[2]) == 100 and {c for c, _, _ in got[2]} == {0}
    assert got[-1][1] == got[4][1] != b""


def _boom_app(side):
    class Boom(side["abci"].BaseApplication):
        async def query(self, req):
            raise RuntimeError("boom")
    return Boom()


@pytest.mark.parametrize("cli_side, srv_side", PAIRS, ids=PAIR_IDS)
def test_exception_response_kills_the_client_with_the_jax_texts(
        cli_side, srv_side):
    async def body(cli, a):
        texts = []
        for call in (lambda: cli.query(a.QueryRequest(path="x")),
                     lambda: cli.echo("should be dead")):
            try:
                await call()
            except Exception as e:  # noqa: BLE001 — the texts compared
                texts.append((type(e).__name__, str(e)))
        return texts
    with _sock_dir() as d:
        got = run(_session(cli_side, srv_side, _boom_app(srv_side), d, body))
    assert got == [("ABCIClientError", "app exception: boom"),
                   ("ABCIClientError",
                    "ABCI client dead: app exception: boom")]


def test_exception_response_fails_every_pending_call():
    """Pipelined calls behind the one that raised fail with its error."""
    async def body(cli, a):
        calls = [cli.echo("a"), cli.query(a.QueryRequest(path="x")),
                 cli.echo("b"), cli.info(a.InfoRequest())]
        return [str(r) if isinstance(r, Exception) else r.message
                for r in await asyncio.gather(*calls,
                                              return_exceptions=True)]
    for side in (PORT, JAX):
        with _sock_dir() as d:
            got = run(_session(side, side, _boom_app(side), d, body))
        assert got == ["a"] + ["app exception: boom"] * 3


@pytest.mark.parametrize("side", [PORT, JAX], ids=["port", "jax"])
def test_oversized_frames_are_refused_with_the_jax_text(side):
    """A request frame over MAX_MSG_SIZE makes the server drop the
    connection; a response frame over it fails the client."""
    big = encode_uvarint(pb.MAX_MSG_SIZE + 1)

    async def go(d):
        addr = os.path.join(d, "app.sock")
        srv = PORT["server"].SocketServer(f"unix://{addr}",
                                          KVStoreApplication())
        await srv.start()
        reader, writer = await asyncio.open_unix_connection(addr)
        writer.write(big)
        await writer.drain()
        closed = await asyncio.wait_for(reader.read(), 5) == b""
        writer.close()
        await srv.stop()

        async def oversized(r, w):
            await r.read(1)
            w.write(big)
            await w.drain()
        fake = await asyncio.start_unix_server(
            oversized, path=os.path.join(d, "big.sock"))
        cli = side["client"].SocketClient(
            f"unix://{os.path.join(d, 'big.sock')}")
        await cli.connect()
        try:
            await cli.echo("x")
        except side["server"].ABCIServerError as e:
            refused = str(e)
        await cli.close()
        fake.close()
        return closed, refused
    with _sock_dir() as d:
        assert run(go(d)) == (True, f"message too large: "
                                    f"{pb.MAX_MSG_SIZE + 1}")


@pytest.mark.parametrize("addr", [
    "unix:///tmp/x.sock", "tcp://10.0.0.1:9", "tcp://host", "1.2.3.4:26658",
    "localhost:7", "grpc://h:1"])
def test_parse_address_equals_the_jax_one(addr):
    def parse(mod):
        try:
            return mod.parse_address(addr)
        except mod.ABCIServerError as e:
            return str(e)
    assert parse(server) == parse(r_server)


def test_build_app_equals_the_jax_one():
    assert type(server._build_app("kvstore")).__name__ == \
        type(r_server._build_app("kvstore")).__name__
    assert type(server._build_app("noop")) is abci.BaseApplication
    texts = []
    for mod in (server, r_server):
        with pytest.raises(mod.ABCIServerError) as e:
            mod._build_app("nope")
        texts.append(str(e.value))
    assert texts[0] == texts[1] == "unknown app 'nope' (kvstore|noop)"


def test_connect_failure_text_equals_the_jax_one():
    async def go(mod, d):
        c = mod.SocketClient(f"unix://{os.path.join(d, 'none.sock')}")
        with pytest.raises(mod.ABCIClientError) as e:
            await c.connect(retries=2, retry_delay=0.01)
        return str(e.value).replace(d, "D")
    with _sock_dir() as d:
        assert run(go(client, d)) == run(go(r_client, d))


# -- deadlines, retries, tracing, metrics ----------------------------------------

METHODS = ["echo", "flush", "info", "query", "check_tx", "init_chain",
           "prepare_proposal", "process_proposal", "finalize_block",
           "extend_vote", "verify_vote_extension", "commit",
           "list_snapshots", "offer_snapshot", "load_snapshot_chunk",
           "apply_snapshot_chunk"]


class _Inner:
    """Every ABCI method fails with ``exc`` (or sleeps ``sleep_s``),
    counting attempts."""

    def __init__(self, exc=None, sleep_s=0.0):
        self.exc, self.sleep_s = exc, sleep_s
        self.attempts = {}
        for m in METHODS:
            setattr(self, m, self._make(m))

    def _make(self, name):
        async def method(*a, **kw):
            self.attempts[name] = self.attempts.get(name, 0) + 1
            if self.sleep_s:
                await asyncio.sleep(self.sleep_s)
            if self.exc is not None:
                raise self.exc
            return name
        return method


def test_deadline_method_sets_equal_the_jax_ones():
    assert client._SLOW_METHODS == r_client._SLOW_METHODS
    assert client._RETRIABLE_METHODS == r_client._RETRIABLE_METHODS


@pytest.mark.parametrize("method", METHODS)
def test_retries_and_deadline_texts_per_method_equal_the_jax_ones(method):
    def outcome(mod, inner, **kw):
        dc = mod.DeadlineClient(inner, retry_backoff_s=0.0005, **kw)
        try:
            return run(getattr(dc, method)()), inner.attempts[method], \
                dc.timeout_for(method)
        except Exception as e:  # noqa: BLE001 — compared below
            return (type(e).__name__, str(e)), inner.attempts[method], \
                dc.timeout_for(method)
    for exc in (ConnectionResetError("reset"), ValueError("app said no"),
                asyncio.IncompleteReadError(b"", 4)):
        mine = outcome(client, _Inner(exc), retries=2)
        assert mine == outcome(r_client, _Inner(exc), retries=2)
    mine = outcome(client, _Inner(sleep_s=1.0), default_timeout_s=0.01,
                   slow_timeout_s=0.02)
    assert mine == outcome(r_client, _Inner(sleep_s=1.0),
                           default_timeout_s=0.01, slow_timeout_s=0.02)
    assert mine[0][0] == "ABCITimeoutError" and mine[1] == 1
    assert mine[0][1] == f"ABCI {method} exceeded its {mine[2]}s deadline"
    reset = outcome(client, _Inner(ConnectionResetError("x")), retries=2)
    assert reset[1] == (3 if method in client._RETRIABLE_METHODS else 1)


class _RpcError(Exception):
    def __init__(self, name=None):
        self.name = name

    def code(self):
        if self.name is None:
            raise RuntimeError("no code")
        return type("Code", (), {"name": self.name})()


@pytest.mark.parametrize("exc", [
    ConnectionRefusedError(), OSError("x"), asyncio.IncompleteReadError(b"", 1),
    ValueError("v"), _RpcError("UNAVAILABLE"), _RpcError("DEADLINE_EXCEEDED"),
    _RpcError("INTERNAL"), _RpcError(None), client.ABCIClientError("dead")],
    ids=lambda e: type(e).__name__ + str(getattr(e, "name", "")))
def test_transient_transport_errors_equal_the_jax_ones(exc):
    assert client._is_transient_transport_error(exc) == \
        r_client._is_transient_transport_error(exc)


def test_timeouts_and_pass_through_attributes():
    inner = _Inner()
    inner.address = "unix:///x"
    for mod in (client, r_client):
        dc = mod.DeadlineClient(inner, default_timeout_s=2.0)
        assert (dc.timeout_for("query"), dc.timeout_for("commit"),
                dc.timeout_for("echo")) == (2.0, 12.0, 2.0)
        assert dc.address == "unix:///x"
        assert dc.echo is dc.echo           # cached after the first lookup


def _wrapped_conns(side, apply):
    conns = side["client"].AppConns(side["KVStore"]())
    apply(side, conns)
    apply(side, conns)                      # idempotent
    return conns


def test_apply_wrappers_wrap_each_connection_once_as_the_jax_ones():
    def deadlines(side, conns):
        side["client"].apply_deadlines(conns, 3.0, retries=1)

    def traced(side, conns):
        side["client"].apply_tracing(conns)

    for apply, cls in ((deadlines, "DeadlineClient"),
                       (traced, "TracingClient")):
        for side in (PORT, JAX):
            conns = _wrapped_conns(side, apply)
            for name in ("consensus", "mempool", "query", "snapshot"):
                c = getattr(conns, name)
                assert type(c).__name__ == cls
                assert type(c._inner).__name__ == "LocalClient"


def test_tracing_client_records_an_abci_span_a_call():
    tracing.configure(enabled=True)
    tracing.clear()
    try:
        conns = _wrapped_conns(PORT, lambda s, c: s["client"].apply_tracing(c))
        run(conns.consensus.info(abci.InfoRequest()))
        run(conns.mempool.check_tx(abci.CheckTxRequest(tx=b"a=b")))
        names = [e["name"] for e in tracing.snapshot(category=tracing.ABCI)]
        assert names == ["consensus/info", "mempool/check_tx"]
    finally:
        tracing.clear()


def test_proxy_metrics_render_as_the_jax_ones():
    out = []
    for side, mod, lib in ((PORT, abci_metrics, metrics),
                           (JAX, r_abci_metrics, r_metrics)):
        reg = lib.Registry()
        m = mod.Metrics(reg)
        conns = side["client"].AppConns(side["KVStore"]())
        mod.instrument_app_conns(conns, m)
        mod.instrument_app_conns(conns, m)
        run(conns.query.info(side["abci"].InfoRequest()))
        run(conns.mempool.echo("x"))
        hist = m.method_timing_seconds
        out.append(sorted(hist._children))
        for v in (0.00005, 0.003, 1.0):
            hist.with_labels("commit", "consensus").observe(v)
        out.append(hist.with_labels("commit", "consensus")._count)
        out.append((hist.name, hist.help, hist.buckets, hist.label_names))
    assert out[:3] == out[3:]
    assert out[0] == [("echo", "mempool"), ("info", "query")]


def test_client_creator_equals_the_jax_one():
    for side in (PORT, JAX):
        mod = side["client"]
        app = side["KVStore"]()
        assert type(mod.ClientCreator(app).new_app_conns()).__name__ == \
            "AppConns"
        unsync = mod.ClientCreator(app, transport="builtin_unsync")
        assert type(unsync.new_app_conns().consensus).__name__ == \
            "UnsyncLocalClient"
        sock = mod.ClientCreator(addr="unix:///x", transport="socket")
        assert type(sock.new_app_conns()).__name__ == "SocketAppConns"
    texts = []
    for mod in (client, r_client):
        for creator in (mod.ClientCreator(), mod.ClientCreator(
                addr="x", transport="carrier-pigeon")):
            with pytest.raises(mod.ABCIClientError) as e:
                creator.new_app_conns()
            texts.append(str(e.value))
    assert texts[:2] == texts[2:] == [
        "local client requires an app",
        "transport 'carrier-pigeon' not supported"]


def test_socket_transport_needs_no_grpc():
    """ClientCreator imports abci/grpc only for the grpc transport."""
    code = ("import sys\nsys.modules['grpc'] = None\n"
            "from cometbft_tpu_torch.abci.client import ClientCreator\n"
            "c = ClientCreator(addr='unix:///x', transport='socket')\n"
            "print(type(c.new_app_conns()).__name__)\n"
            "try:\n"
            "    ClientCreator(addr='x', transport='grpc').new_app_conns()\n"
            "except ImportError as e:\n"
            "    print('ImportError')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.stdout.split() == ["SocketAppConns", "ImportError"], \
        out.stderr


# -- the grammar checker ---------------------------------------------------------

VALID = [
    (["init_chain", "prepare_proposal", "process_proposal",
      "finalize_block", "commit", "process_proposal", "extend_vote",
      "verify_vote_extension", "finalize_block", "commit"], True),
    (["offer_snapshot", "offer_snapshot", "apply_snapshot_chunk",
      "apply_snapshot_chunk", "finalize_block", "commit"], True),
    (["finalize_block", "commit"], False),
    (["info", "init_chain", "check_tx", "finalize_block", "echo",
      "commit"], True),
]
VIOLATIONS = [
    ["finalize_block", "commit"],
    ["init_chain", "commit"],
    ["init_chain", "finalize_block", "prepare_proposal", "commit"],
    ["init_chain", "finalize_block", "commit", "init_chain"],
    ["init_chain", "finalize_block", "commit", "offer_snapshot"],
    ["offer_snapshot", "finalize_block", "commit"],
    ["init_chain", "apply_snapshot_chunk"],
    ["init_chain", "finalize_block"],
    ["init_chain"],
    ["offer_snapshot", "apply_snapshot_chunk"],
]


@pytest.mark.parametrize("i", range(len(VALID)))
def test_grammar_accepts_what_the_jax_checker_accepts(i):
    trace, clean = VALID[i]
    assert grammar.GrammarChecker().verify(trace, clean_start=clean) is \
        r_grammar.GrammarChecker().verify(trace, clean_start=clean) is True


@pytest.mark.parametrize("i", range(len(VIOLATIONS)))
def test_grammar_violations_equal_the_jax_ones(i):
    trace = VIOLATIONS[i]
    with pytest.raises(grammar.GrammarError) as mine:
        grammar.GrammarChecker().verify(trace)
    with pytest.raises(r_grammar.GrammarError) as theirs:
        r_grammar.GrammarChecker().verify(trace)
    assert (str(mine.value), mine.value.index, mine.value.call) == \
        (str(theirs.value), theirs.value.index, theirs.value.call)


def test_recording_client_records_the_same_traces():
    traces = []
    for side in (PORT, JAX):
        conns = side["client"].AppConns(side["KVStore"]())
        calls = []
        rec = {n: side["grammar"].RecordingClient(getattr(conns, n), calls)
               for n in ("consensus", "mempool", "query")}
        a = side["abci"]

        async def go():
            await rec["query"].info(a.InfoRequest())
            await rec["consensus"].init_chain(a.InitChainRequest(
                chain_id="c"))
            await rec["mempool"].check_tx(a.CheckTxRequest(tx=b"a=b"))
            await rec["mempool"].echo("not recorded")
            await rec["consensus"].finalize_block(
                a.FinalizeBlockRequest(height=1))
            await rec["consensus"].commit()
        run(go())
        side["grammar"].GrammarChecker().verify(calls)
        traces.append(calls)
    assert traces[0] == traces[1] == ["info", "init_chain", "check_tx",
                                      "finalize_block", "commit"]


# -- abci-cli and the server process ---------------------------------------------

CLI_CASES = [["echo", "hello", "world"], ["info"], ["check_tx", "k=v"],
             ["check_tx", "0x6b3d76"], ["check_tx"],
             ["finalize_block", "a=1", "b=2", "b64:Yz0z"], ["commit"],
             ["query", "/store", "k"], ["bogus"]]


def _cli_output(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("argv", CLI_CASES, ids=lambda a: "_".join(a)[:24])
def test_cli_one_shot_output_equals_the_jax_one(argv):
    assert _cli_output(cli, argv) == _cli_output(r_cli, argv)


def test_cli_console_equals_the_jax_one(monkeypatch):
    lines = ["echo hi", "check_tx a=b", "finalize_block a=b", "commit",
             "query /store a", "", "info", "quit"]
    outs = []
    for mod in (cli, r_cli):
        it = iter(lines)
        monkeypatch.setattr(mod, "_read_line", lambda it=it: next(it, None))
        outs.append(_cli_output(mod, ["console"]))
    assert outs[0] == outs[1]
    assert "-> value: b" in outs[0]


def _server_proc(address, module="cometbft_tpu_torch.abci.server"):
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "--address", address, "--app",
         "kvstore"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    line = proc.stdout.readline().strip()
    return proc, line


def test_cli_against_an_app_process_equals_the_jax_cli():
    with _sock_dir() as d:
        addr = f"unix://{os.path.join(d, 'app.sock')}"
        proc, line = _server_proc(addr)
        try:
            assert line == f"abci-server listening {addr}"
            for argv in (["echo", "over", "the", "socket"],
                         ["check_tx", "x=y"], ["info"]):
                assert _cli_output(cli, ["--address", addr] + argv) == \
                    _cli_output(r_cli, ["--address", addr] + argv)
        finally:
            proc.terminate()
            proc.wait(10)


def test_app_process_prints_the_jax_ready_line_and_loads_no_torch():
    # the app's side of every call of a height, FinalizeBlock's response
    # codec included, loads none of them either
    code = ("import asyncio, sys\n"
            "from cometbft_tpu_torch.abci import pb, server, types as t\n"
            "app = server._build_app('kvstore')\n"
            "async def height():\n"
            "    for req in (t.InfoRequest(), t.CheckTxRequest(tx=b'a=b'),\n"
            "                t.FinalizeBlockRequest(txs=[b'a=b'], height=1),\n"
            "                t.CommitRequest(), t.QueryRequest(data=b'a')):\n"
            "        frame = pb.encode_request_frame(req)\n"
            "        req = pb.decode_request(frame[1:])\n"
            "        srv = server.SocketServer('unix:///x', app)\n"
            "        pb.encode_response_frame(await srv._dispatch(req))\n"
            "asyncio.run(height())\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'cometbft_tpu', 'grpc')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.stdout.strip() == "[]", out.stderr
    with _sock_dir() as d:
        lines = []
        for module in ("cometbft_tpu_torch.abci.server",
                       "cometbft_tpu.abci.server"):
            addr = f"unix://{os.path.join(d, module.split('.')[0])}.sock"
            proc, line = _server_proc(addr, module)
            lines.append(line.replace(addr, "ADDR"))
            proc.terminate()
            proc.wait(10)
    assert lines[0] == lines[1] == "abci-server listening ADDR"


# -- the slice as a whole --------------------------------------------------------

SLICE_HEIGHTS = 3


def test_consensus_over_a_socket_app_process_commits_as_the_twin(
        monkeypatch):
    """Config 1's four validators: a twin chain built in process (the
    kvstore on AppConns) to height 4, its first three heights fed as
    wire bytes to a port ConsensusState whose app is a ``python -m
    cometbft_tpu_torch.abci.server`` process behind SocketAppConns with
    the JAX node's deadlines, tracing and proxy metrics.  The blocks,
    FinalizeBlock responses (app hashes) and state equal the twin's at
    every height; B1 runs its plain version on the CPU."""
    from cometbft_tpu_torch.consensus.messages import decode_p2p, encode_p2p
    from cometbft_tpu_torch.types.events import EVENT_QUERY_NEW_BLOCK
    from cometbft_tpu_torch.wire import encode
    from cometbft_tpu_torch.wire import pb as wpb
    chain = port_chain("sockapp-slice", seeds(4, 417))
    for h in range(1, SLICE_HEIGHTS + 2):
        chain.step([cs._keyed_tx(417, h, j) for j in range(5)])
    feed = cs._cs_feed(chain, range(1, SLICE_HEIGHTS + 1), chain.signer)
    b1_calls, real = [], ek.verify_cols

    def counted(*a):
        b1_calls.append(a[0].shape[1])
        return real(*a)
    monkeypatch.setattr(ek, "verify_cols", counted)

    async def go(addr):
        conns = await cs._socket_conns(addr, metrics.Registry(), calls)
        node = await cs._CsNode.make(chain.doc, "cpu", conns=conns)
        sub = node.bus.subscribe("slice", EVENT_QUERY_NEW_BLOCK,
                                 out_capacity=100)
        await node.cs.start()
        try:
            for h in range(1, SLICE_HEIGHTS + 1):
                for msg in feed[h]:
                    node.cs.send_peer(decode_p2p(encode_p2p(msg)), "twin")
                await cs._cs_new_block(node, sub, h, timeout_s=120.0)
        finally:
            await node.cs.stop()
            await conns.stop()
        return node

    calls = []
    with _sock_dir() as d:
        app = cs._AppProc(d, "slice").start()
        try:
            node = run(go(app.address))
        finally:
            app.stop()
    for h in range(1, SLICE_HEIGHTS + 1):
        assert encode(wpb.BLOCK, node.block_store.load_block(h).to_proto()) \
            == encode(wpb.BLOCK, chain.block_store.load_block(h).to_proto())
        assert node.state_store.load_finalize_block_response(h) == \
            chain.state_store.load_finalize_block_response(h)
    state = node.state_store.load()
    assert state.last_block_height == SLICE_HEIGHTS
    assert state.app_hash == chain.block_store.load_block(
        SLICE_HEIGHTS + 1).header.app_hash
    # the bursts and the LastCommit checks ran B1 (its plain version here)
    assert len(b1_calls) >= SLICE_HEIGHTS
    grammar.GrammarChecker().verify(calls)


# -- chip_smoke.py's phase 18, rehearsed on the CPU ------------------------------

def _stand_in(mod):
    """A kernel that accepts every lane and counts a launch."""
    def verify_cols(a, r, s, k):
        mod.launches += 1
        return torch.ones(a.shape[1], dtype=torch.bool)
    return verify_cols


def test_phase_18_rehearsed_at_12_validators(monkeypatch):
    """Phases 12 and 13 as on the card (12a's feed and figures, 13a's
    figures), then phase 18: config 1 with four app processes for 5
    heights, 12a's chain replayed to an app process for 5 heights and one
    under cuda8, the companion servicers and the rejects.  The kernels are
    the stand-in that accepts every lane and counts a launch."""
    class SerialPool:
        def map(self, fn, items, chunksize=None):
            return [fn(x) for x in items]

    r_batch.set_backend("cpu")
    monkeypatch.setattr(ek, "verify_cols", _stand_in(ek))
    monkeypatch.setattr(ek8, "verify_cols", _stand_in(ek8))
    for mod in (vote_mod, r_vote_mod):
        mod._VERIFIED.clear()
        mod._REJECTED.clear()
    monkeypatch.setattr(cs, "_device_busy",
                        lambda fn: (fn(), (1.0, None, None, 0))[1])
    monkeypatch.setattr(cs, "_edge_items",
                        lambda seed, pool: [(bytes(32), b"m", bytes(64))])
    for name, value in (("EXEC_VALIDATORS", 12), ("CS_HEIGHTS", 6),
                        ("EXEC_UPDATES", (2, 3, 4)), ("CS_TRACED", 2),
                        ("NET_HEIGHTS", 3), ("HOST_INPUTS", 10),
                        ("HOST_TIMED", 3), ("SOCK_HEIGHTS", 5),
                        ("CATCHUP_HEIGHTS", 6), ("AEAD_INPUTS", 30),
                        ("SOCKAPP_HEIGHTS", 5), ("SOCKAPP_CS_HEIGHTS", 5),
                        ("COMPANION_RETAIN", {"app": 4, "block": 3,
                                              "results": 5, "tx_indexer": 2,
                                              "block_indexer": 3})):
        monkeypatch.setattr(cs, name, value)
    keep = {}
    try:
        cs._cs_phases(0, "CPU", SerialPool(), device="cpu", keep=keep)
        cs._p2p_phases(0, "CPU", keep, device="cpu")
        launches, launches8 = cs._sockapp_phases(0, "CPU", keep,
                                                 device="cpu")
    finally:
        r_batch.set_backend("auto")
    assert set(launches) == {"sockapp_4x5", "sockapp_cs_12x5",
                             "sockapp_reject"}
    # 18a: each node's LastCommit check a height after the first, and the
    # bursts; 18b: 12a's launches over heights 1-5; cuda8 at height 6
    assert launches["sockapp_4x5"] >= 4 * 4
    assert launches["sockapp_cs_12x5"] == sum(
        keep["chain"].live["launches"][h] for h in range(1, 6))
    assert launches8 == {"sockapp_cs_12_cuda8":
                         keep["chain"].live["launches"][6]}
