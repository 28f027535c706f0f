"""Light-client providers: the sources of light blocks.

Reference: light/provider/provider.go (the interface), through
cometbft_tpu/light/provider.py: the interface and the node provider,
which serves light blocks from a node's block and state stores
(:38-67).  The RPC provider waits for the RPC client (ROADMAP A.7e-5).
"""
from __future__ import annotations

import abc

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
