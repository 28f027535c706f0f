"""Light-client providers: the sources of light blocks.

Reference: light/provider/provider.go (the interface), through
cometbft_tpu/light/provider.py.  The node provider (over a node's block
and state stores) and the RPC provider wait for those stores and the
RPC client (ROADMAP A.7e); a caller brings its own ``Provider``.
"""
from __future__ import annotations

import abc

from ..types.block import LightBlock


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
