"""Light-client providers: the sources of light blocks.

Reference: light/provider/provider.go (the interface) and
provider/http, through cometbft_tpu/light/provider.py: the interface,
the node provider, which serves light blocks from a node's block and
state stores (:38-67), and the HTTP provider over a node's JSON-RPC
(:70-123), which tries the one-trip ``light_block`` route first and
falls back for good to ``/commit`` plus paged ``/validators`` on
method-not-found.  A provider only fetches: the light ``Client`` that
holds it verifies what it brings, on its own device.
"""
from __future__ import annotations

import abc
import asyncio

from ..types.block import LightBlock, SignedHeader


class ProviderError(Exception):
    pass


class LightBlockNotFoundError(ProviderError):
    pass


class Provider(abc.ABC):
    @abc.abstractmethod
    async def light_block(self, height: int) -> LightBlock:
        """The light block at ``height`` (0 = the latest).  Raises
        LightBlockNotFoundError."""

    @abc.abstractmethod
    async def report_evidence(self, ev) -> None: ...

    def id(self) -> str:
        return self.__class__.__name__


class NodeProvider(Provider):
    """Serves light blocks from a node's stores."""

    def __init__(self, block_store, state_store, chain_id: str):
        self.block_store = block_store
        self.state_store = state_store
        self.chain_id = chain_id
        self.evidence: list = []

    async def light_block(self, height: int) -> LightBlock:
        if height == 0:
            height = self.block_store.height
        meta = self.block_store.load_block_meta(height)
        commit = self.block_store.load_block_commit(height)
        if commit is None:
            commit = self.block_store.load_seen_commit(height)
        if meta is None or commit is None:
            raise LightBlockNotFoundError(
                f"no light block at height {height}")
        vals = self.state_store.load_validators(height)
        return LightBlock(
            signed_header=SignedHeader(header=meta.header, commit=commit),
            validator_set=vals)

    async def report_evidence(self, ev) -> None:
        self.evidence.append(ev)

    def id(self) -> str:
        return f"node-provider:{self.chain_id}"


class HttpProvider(Provider):
    """Light blocks over a node's RPC (reference:
    light/provider/http/http.go — /commit + paged /validators)."""

    def __init__(self, address: str, chain_id: str = ""):
        from ..rpc.client import HTTPClient
        self.client = HTTPClient(address)
        self.chain_id = chain_id
        self.address = address
        self._has_light_block = True   # downgraded on first -32601

    async def light_block(self, height: int) -> LightBlock:
        from ..rpc.client import RPCClientError
        try:
            if self._has_light_block:
                # one round trip via the lightserve route; servers
                # predating it answer method-not-found and we fall
                # back to /commit + paged /validators for good
                try:
                    lb = await self.client.light_block(height)
                except RPCClientError as e:
                    if "-32601" not in str(e):   # method not found
                        raise
                    self._has_light_block = False
                    lb = None
            else:
                lb = None
            if lb is None:
                signed_header, _ = await self.client.commit(height)
                h = signed_header.header.height
                vals = await self.client.validators(h)
                lb = LightBlock(signed_header=signed_header,
                                validator_set=vals)
        except RPCClientError as e:
            raise LightBlockNotFoundError(str(e)) from None
        except (OSError, asyncio.TimeoutError) as e:
            raise ProviderError(
                f"provider {self.address} unreachable: {e}") from None
        if self.chain_id:
            lb.validate_basic(self.chain_id)
        return lb

    async def report_evidence(self, ev) -> None:
        """POST wire-encoded evidence to the node's broadcast_evidence
        RPC (reference: http provider ReportEvidence ->
        rpc/core/evidence.go)."""
        import base64
        from ..wire import pb as _pb, encode as _encode
        raw = _encode(_pb.EVIDENCE, ev.to_proto_wrapped())
        await self.client.call(
            "broadcast_evidence", evidence=base64.b64encode(raw).decode())

    def id(self) -> str:
        return f"http{{{self.address}}}"
