"""Remote signer: socket privval protocol.

Reference: privval/ —
  * the NODE listens on priv_validator_laddr and the signer process dials
    in (signer_listener_endpoint.go on the node side, signer_server.go +
    signer_dialer_endpoint.go on the signer side);
  * messages are uvarint-length-delimited privval.v2 Message frames
    (msgs.go), request/response in lockstep over one connection;
  * SignerClient implements the PrivValidator interface over the wire
    (signer_client.go); RetrySignerClient wraps it with bounded retries
    (retry_signer_client.go);
  * the double-sign state machine (FilePV's last-sign HRS rules) lives in
    the SIGNER process, so a compromised node cannot make the key
    equivocate.

A copy of cometbft_tpu/privval/signer.py: the same frames, byte for
byte, so a signer of either package serves a node of the other, and the
same texts.  The frame IO is libs/protoio's and the address parser the
ABCI socket server's, as in the reference.

Runnable signer:  python -m cometbft_tpu_torch.privval.signer \
    --address tcp://127.0.0.1:26659 --chain-id my-chain \
    --key-file priv_validator_key.json \
    --state-file priv_validator_state.json
"""
from __future__ import annotations

import argparse
import asyncio
from typing import Optional

from ..abci.server import parse_address
from ..libs.log import Logger, new_logger
from ..libs.protoio import read_delimited, write_delimited
from ..types.priv_validator import PrivValidator
from ..types.proposal import Proposal
from ..types.vote import Vote
from ..wire import decode, encode, privval_pb
from .file import DoubleSignError, FilePV, PrivValidatorError


class RemoteSignerError(PrivValidatorError):
    pass


def _frame(msg: dict) -> bytes:
    return write_delimited(encode(privval_pb.MESSAGE, msg))


async def _read_frame(reader: asyncio.StreamReader) -> Optional[dict]:
    payload = await read_delimited(reader, 1 << 20, RemoteSignerError)
    if payload is None:
        return None
    return decode(privval_pb.MESSAGE, payload)


# --- node side --------------------------------------------------------------

class SignerListenerEndpoint:
    """The node's end: listen, accept ONE signer connection, serialize
    request/response exchanges (reference: signer_listener_endpoint.go)."""

    def __init__(self, laddr: str, timeout_s: float = 5.0,
                 logger: Optional[Logger] = None):
        self.laddr = laddr
        self.timeout_s = timeout_s
        self.logger = logger or new_logger("privval-listener")
        self._server: Optional[asyncio.AbstractServer] = None
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._connected = asyncio.Event()
        self._lock = asyncio.Lock()

    async def start(self) -> None:
        scheme, host, port = parse_address(self.laddr)
        if scheme == "unix":
            self._server = await asyncio.start_unix_server(
                self._on_connect, path=host)
        else:
            self._server = await asyncio.start_server(
                self._on_connect, host=host, port=port)
        self.logger.info("privval listening for remote signer",
                         addr=self.laddr)

    @property
    def listen_addr(self) -> str:
        socks = self._server.sockets if self._server else []
        if socks:
            name = socks[0].getsockname()
            if isinstance(name, tuple):
                return f"tcp://{name[0]}:{name[1]}"
            return f"unix://{name}"
        return self.laddr

    async def _on_connect(self, reader, writer) -> None:
        if self._writer is not None:
            writer.close()                  # one signer at a time
            return
        self._reader, self._writer = reader, writer
        self._connected.set()
        self.logger.info("remote signer connected")

    async def wait_for_signer(self, timeout_s: float = 30.0) -> None:
        await asyncio.wait_for(self._connected.wait(), timeout_s)

    async def request(self, msg: dict) -> dict:
        async with self._lock:
            if self._writer is None:
                raise RemoteSignerError("no signer connected")
            try:
                self._writer.write(_frame(msg))
                await self._writer.drain()
                resp = await asyncio.wait_for(
                    _read_frame(self._reader), self.timeout_s)
            except (ConnectionError, asyncio.IncompleteReadError,
                    asyncio.TimeoutError) as e:
                self._drop_conn()
                raise RemoteSignerError(
                    f"remote signer request failed: {e!r}") from None
            if resp is None:
                self._drop_conn()
                raise RemoteSignerError("remote signer closed")
            return resp

    def _drop_conn(self) -> None:
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass
        self._reader = self._writer = None
        self._connected.clear()

    async def stop(self) -> None:
        self._drop_conn()
        if self._server is not None:
            self._server.close()


_ERR_CODE_DOUBLE_SIGN = 3


def _raise_on_error(resp_body: dict) -> None:
    err = resp_body.get("error")
    if err:
        desc = err.get("description", "")
        if err.get("code") == _ERR_CODE_DOUBLE_SIGN:
            raise DoubleSignError(desc)
        raise RemoteSignerError(desc or f"code {err.get('code')}")


class SignerClient(PrivValidator):
    """PrivValidator over the socket (reference: signer_client.go)."""

    def __init__(self, endpoint: SignerListenerEndpoint, chain_id: str):
        self.endpoint = endpoint
        self.chain_id = chain_id
        self._pub_key = None

    async def ping(self) -> None:
        resp = await self.endpoint.request({"ping_request": {}})
        if "ping_response" not in resp:
            raise RemoteSignerError(f"unexpected reply {sorted(resp)}")

    async def fetch_pub_key(self):
        from ..crypto import encoding as crypto_encoding
        resp = await self.endpoint.request(
            {"pub_key_request": {"chain_id": self.chain_id}})
        body = resp.get("pub_key_response")
        if body is None:
            raise RemoteSignerError(f"unexpected reply {sorted(resp)}")
        _raise_on_error(body)
        self._pub_key = crypto_encoding.pub_key_from_type_and_bytes(
            body.get("pub_key_type", "ed25519"),
            body.get("pub_key_bytes", b""))
        return self._pub_key

    def get_pub_key(self):
        if self._pub_key is None:
            raise RemoteSignerError(
                "pub key not fetched yet (call fetch_pub_key)")
        return self._pub_key

    # async signing surface; ConsensusState dispatches through its
    # _pv_sign_vote/_pv_sign_proposal helpers, which await these when
    # present and fall back to the sync PrivValidator methods otherwise
    async def sign_vote_async(self, chain_id: str, vote: Vote,
                              sign_extension: bool) -> None:
        resp = await self.endpoint.request({"sign_vote_request": {
            "vote": vote.to_proto(), "chain_id": chain_id,
            "skip_extension_signing": not sign_extension,
        }})
        body = resp.get("signed_vote_response")
        if body is None:
            raise RemoteSignerError(f"unexpected reply {sorted(resp)}")
        _raise_on_error(body)
        signed = Vote.from_proto(body.get("vote") or {})
        vote.signature = signed.signature
        vote.timestamp = signed.timestamp
        vote.extension_signature = signed.extension_signature
        vote.non_rp_extension_signature = \
            signed.non_rp_extension_signature

    async def sign_proposal_async(self, chain_id: str,
                                  proposal: Proposal) -> None:
        resp = await self.endpoint.request({"sign_proposal_request": {
            "proposal": proposal.to_proto(), "chain_id": chain_id,
        }})
        body = resp.get("signed_proposal_response")
        if body is None:
            raise RemoteSignerError(f"unexpected reply {sorted(resp)}")
        _raise_on_error(body)
        signed = Proposal.from_proto(body.get("proposal") or {})
        proposal.signature = signed.signature
        proposal.timestamp = signed.timestamp

    # sync PrivValidator interface (used by code paths that don't await):
    def sign_vote(self, chain_id: str, vote: Vote,
                  sign_extension: bool) -> None:
        raise RemoteSignerError(
            "SignerClient is async; use sign_vote_async")

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        raise RemoteSignerError(
            "SignerClient is async; use sign_proposal_async")


class RetrySignerClient(PrivValidator):
    """Bounded retry wrapper (reference: retry_signer_client.go).
    Double-sign refusals are NEVER retried — they are final."""

    def __init__(self, client: SignerClient, retries: int = 5,
                 delay_s: float = 0.2):
        self.client = client
        self.retries = retries
        self.delay_s = delay_s

    def get_pub_key(self):
        return self.client.get_pub_key()

    async def _retry(self, coro_fn, *args):
        last: Exception = RemoteSignerError("no attempts")
        for _ in range(self.retries):
            try:
                return await coro_fn(*args)
            except DoubleSignError:
                raise
            except (RemoteSignerError, PrivValidatorError) as e:
                last = e
                await asyncio.sleep(self.delay_s)
        raise last

    async def fetch_pub_key(self):
        return await self._retry(self.client.fetch_pub_key)

    async def sign_vote_async(self, chain_id, vote, sign_extension):
        return await self._retry(self.client.sign_vote_async, chain_id,
                                 vote, sign_extension)

    async def sign_proposal_async(self, chain_id, proposal):
        return await self._retry(self.client.sign_proposal_async,
                                 chain_id, proposal)

    def sign_vote(self, chain_id, vote, sign_extension):
        raise RemoteSignerError(
            "SignerClient is async; use sign_vote_async")

    def sign_proposal(self, chain_id, proposal):
        raise RemoteSignerError(
            "SignerClient is async; use sign_proposal_async")


# --- signer side ------------------------------------------------------------

class SignerServer:
    """The external signer process: dial the node, serve signing requests
    from a FilePV (reference: signer_server.go + signer_dialer_endpoint).
    The FilePV's HRS state machine enforces double-sign protection here,
    across restarts, regardless of what the node asks for."""

    def __init__(self, address: str, chain_id: str, pv: FilePV,
                 logger: Optional[Logger] = None,
                 retries: int = 40, retry_delay_s: float = 0.25):
        self.address = address
        self.chain_id = chain_id
        self.pv = pv
        self.logger = logger or new_logger("signer-server")
        self.retries = retries
        self.retry_delay_s = retry_delay_s
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def _connect(self):
        scheme, host, port = parse_address(self.address)
        last = None
        for _ in range(self.retries):
            try:
                if scheme == "unix":
                    return await asyncio.open_unix_connection(host)
                return await asyncio.open_connection(host, port)
            except OSError as e:
                last = e
                await asyncio.sleep(self.retry_delay_s)
        raise RemoteSignerError(f"cannot reach node: {last}")

    async def _run(self) -> None:
        while True:
            try:
                reader, writer = await self._connect()
                self.logger.info("connected to node",
                                 addr=self.address)
                await self.serve_conn(reader, writer)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — reconnect loop
                self.logger.error("signer connection lost",
                                  err=str(e))
                await asyncio.sleep(self.retry_delay_s)

    async def serve_conn(self, reader, writer) -> None:
        while True:
            req = await _read_frame(reader)
            if req is None:
                raise RemoteSignerError("node closed connection")
            writer.write(_frame(self._handle(req)))
            await writer.drain()

    def _handle(self, req: dict) -> dict:
        if "ping_request" in req:
            return {"ping_response": {}}
        if "pub_key_request" in req:
            pub = self.pv.get_pub_key()
            return {"pub_key_response": {
                "pub_key_bytes": pub.bytes(),
                "pub_key_type": pub.type()}}
        if "sign_vote_request" in req:
            body = req["sign_vote_request"]
            vote = Vote.from_proto(body.get("vote") or {})
            try:
                self.pv.sign_vote(
                    body.get("chain_id", self.chain_id), vote,
                    sign_extension=not body.get(
                        "skip_extension_signing", False))
            except DoubleSignError as e:
                return {"signed_vote_response": {
                    "vote": {}, "error": {
                        "code": _ERR_CODE_DOUBLE_SIGN,
                        "description": str(e)}}}
            except PrivValidatorError as e:
                return {"signed_vote_response": {
                    "vote": {}, "error": {"code": 2,
                                          "description": str(e)}}}
            return {"signed_vote_response": {"vote": vote.to_proto()}}
        if "sign_proposal_request" in req:
            body = req["sign_proposal_request"]
            proposal = Proposal.from_proto(body.get("proposal") or {})
            try:
                self.pv.sign_proposal(
                    body.get("chain_id", self.chain_id), proposal)
            except DoubleSignError as e:
                return {"signed_proposal_response": {
                    "proposal": {}, "error": {
                        "code": _ERR_CODE_DOUBLE_SIGN,
                        "description": str(e)}}}
            except PrivValidatorError as e:
                return {"signed_proposal_response": {
                    "proposal": {}, "error": {"code": 2,
                                              "description": str(e)}}}
            return {"signed_proposal_response": {
                "proposal": proposal.to_proto()}}
        if "sign_bytes_request" in req:
            try:
                sig = self.pv.sign_bytes(
                    req["sign_bytes_request"].get("value", b""))
            except PrivValidatorError as e:
                return {"sign_bytes_response": {
                    "error": {"code": 2, "description": str(e)}}}
            return {"sign_bytes_response": {"signature": sig}}
        return {"ping_response": {}}        # unknown: benign reply


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="remote signer process "
                    "(reference: cmd/priv_val_server)")
    ap.add_argument("--address", required=True,
                    help="node's priv_validator_laddr to dial")
    ap.add_argument("--chain-id", default="")
    ap.add_argument("--key-file", required=True)
    ap.add_argument("--state-file", required=True)
    args = ap.parse_args(argv)
    pv = FilePV.load(args.key_file, args.state_file)

    async def run():
        srv = SignerServer(args.address, args.chain_id, pv)
        await srv.start()
        await srv._task

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
