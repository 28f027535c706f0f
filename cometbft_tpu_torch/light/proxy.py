"""Light verifying RPC proxy: serve RPC from a full node, but verify
everything verifiable against headers the light client checked.

Reference: light/rpc/client.go (the verifying wrapper) and light/proxy
(the stand-alone ``cometbft light`` daemon), through
cometbft_tpu/light/proxy.py, whose routes, answers and error texts this
copy keeps.  Header-derived answers (commit, validators, block) are
returned only after the light client has verified the enclosing header,
on B1: ``LightProxy(..., device=None)`` resolves its device at
construction (the card; it raises where CUDA is absent) and hands it to
the light ``Client``.  Mempool broadcasts, status and ``abci_query`` pass
through unverified, as in the JAX proxy.
"""
from __future__ import annotations

import base64
from typing import Optional

from ..db.db import MemDB
from ..device import resolve
from ..libs.log import Logger, new_logger
from ..rpc.client import HTTPClient
from .client import Client as LightClient, TrustOptions
from .provider import HttpProvider
from .store import TrustedStore


class LightProxyError(Exception):
    pass


class VerifyingClient:
    """RPC client surface whose header-derived answers are verified
    (reference: light/rpc/client.go)."""

    def __init__(self, light_client: LightClient, node: HTTPClient):
        self.light = light_client
        self.node = node

    async def latest_height(self) -> int:
        st = await self.node.status()
        return int(st["sync_info"]["latest_block_height"])

    async def commit(self, height: int = 0):
        h = height or await self.latest_height()
        lb = await self.light.verify_light_block_at_height(h)
        return lb.signed_header

    async def validators(self, height: int):
        lb = await self.light.verify_light_block_at_height(height)
        return lb.validator_set

    async def block(self, height: int) -> dict:
        """Raw block JSON: header checked against the verified light
        block AND body checked against the header's data/commit hashes
        (reference: light/rpc runs Block.ValidateBasic + hash checks, so
        a malicious primary can't attach forged txs to a real header)."""
        res = await self.node.block(height)
        from ..rpc.client import commit_from_json, header_from_json
        from ..types.block import Data
        hdr = header_from_json(res["block"]["header"])
        lb = await self.light.verify_light_block_at_height(hdr.height)
        if lb.signed_header.header.hash() != hdr.hash():
            raise LightProxyError(
                f"block {hdr.height} from node does not match the "
                f"verified header")
        txs = [base64.b64decode(t) for t in
               (res["block"].get("data") or {}).get("txs", [])]
        if Data(txs=txs).hash() != hdr.data_hash:
            raise LightProxyError(
                f"block {hdr.height} data does not hash to the "
                f"verified data_hash")
        lc_json = res["block"].get("last_commit")
        if hdr.height > 1:
            # a nil last_commit above height 1 is itself invalid
            # (reference Block.ValidateBasic) — a stripped field must
            # not bypass the hash check
            if lc_json is None:
                raise LightProxyError(
                    f"block {hdr.height} is missing last_commit")
            if commit_from_json(lc_json).hash() != \
                    hdr.last_commit_hash:
                raise LightProxyError(
                    f"block {hdr.height} last_commit does not hash to "
                    f"the verified last_commit_hash")
        return res

    async def abci_query(self, path: str, data: bytes) -> dict:
        # the reference verifies merkle proofs against app_hash; the
        # kvstore answers this query without one, so it passes through
        # unverified
        return await self.node.abci_query(path, data)


class LightProxy:
    """The `cometbft light` daemon: verifying proxy over RPC
    (reference: light/proxy/proxy.go)."""

    def __init__(self, chain_id: str, primary: str,
                 witnesses: list[str], trust_height: int,
                 trust_hash: bytes, listen_addr: str,
                 trust_period_ns: int = 168 * 3600 * 10**9,
                 logger: Optional[Logger] = None, device=None):
        self.chain_id = chain_id
        self.primary_addr = primary
        self.witness_addrs = witnesses
        self.trust_height = trust_height
        self.trust_hash = trust_hash
        self.listen_addr = listen_addr
        self.trust_period_ns = trust_period_ns
        self.logger = logger or new_logger("light-proxy")
        self.device = resolve(device)
        self.client: Optional[VerifyingClient] = None
        self._server = None

    async def start(self) -> None:
        providers = [HttpProvider(a, self.chain_id)
                     for a in [self.primary_addr] + self.witness_addrs]
        light = LightClient(
            self.chain_id,
            TrustOptions(period_ns=self.trust_period_ns,
                         height=self.trust_height,
                         header_hash=self.trust_hash),
            providers[0], providers[1:], TrustedStore(MemDB()),
            device=self.device)
        await light.initialize()
        node = HTTPClient(self.primary_addr)
        self.client = VerifyingClient(light, node)

        from ..config import RPCConfig
        from ..rpc.server import RPCServer
        cfg = RPCConfig()
        cfg.laddr = self.listen_addr
        self._server = RPCServer(None, cfg, routes=self._routes())
        await self._server.start()
        self.logger.info("light proxy serving verified RPC",
                         addr=self._server.listen_addr,
                         primary=self.primary_addr)

    async def stop(self) -> None:
        if self._server is not None:
            await self._server.stop()

    @property
    def rpc_listen_addr(self) -> str:
        return self._server.listen_addr if self._server else ""

    def _routes(self) -> dict:
        from ..rpc import core as rpc_core
        c = self.client
        node = c.node

        async def _health():
            return {}

        async def _status():
            st = await node.status()
            st["node_info"] = st.get("node_info", {})
            st["node_info"]["moniker"] = "light-proxy"
            return st

        async def _commit(height="0"):
            lb = await c.light.verify_light_block_at_height(
                int(height) or await _latest_height())
            return {"signed_header": {
                "header": rpc_core._header_json(
                    lb.signed_header.header),
                "commit": rpc_core._commit_json(
                    lb.signed_header.commit)},
                "canonical": True}

        async def _latest_height():
            st = await node.status()
            return int(st["sync_info"]["latest_block_height"])

        async def _validators(height="0", page="1", per_page="100"):
            h = int(height) or await _latest_height()
            vals = await c.validators(h)
            from ..types import genesis as genesis_types
            page_i = max(1, int(page))
            per = min(100, max(1, int(per_page)))
            sel = vals.validators[(page_i - 1) * per:page_i * per]
            return {"block_height": str(h), "validators": [
                {"address": v.address.hex().upper(),
                 "pub_key": genesis_types.pub_key_to_json(v.pub_key),
                 "voting_power": str(v.voting_power),
                 "proposer_priority": str(v.proposer_priority)}
                for v in sel],
                "count": str(len(sel)), "total": str(vals.size())}

        async def _block(height="0"):
            return await c.block(int(height) or await _latest_height())

        async def _abci_query(path="", data="", height="0",
                              prove=False):
            return await node.call("abci_query", path=path, data=data,
                                   height=height, prove=prove)

        async def _broadcast(method, tx):
            return await node.call(method, tx=tx)

        return {
            "health": _health,
            "status": _status,
            "commit": lambda height="0": _commit(height),
            "validators": _validators,
            "block": lambda height="0": _block(height),
            "abci_query": _abci_query,
            "broadcast_tx_sync": lambda tx="":
                _broadcast("broadcast_tx_sync", tx),
            "broadcast_tx_async": lambda tx="":
                _broadcast("broadcast_tx_async", tx),
            "broadcast_tx_commit": lambda tx="":
                _broadcast("broadcast_tx_commit", tx),
        }
