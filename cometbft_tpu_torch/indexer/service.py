"""IndexerService: subscribes to the event bus and feeds the indexers.

Reference: state/txindex/indexer_service.go; a copy of
cometbft_tpu/indexer/service.py subscribed to the port's EventBus.
"""
from __future__ import annotations

import asyncio
from typing import Optional

from ..abci import types as abci
from ..libs.log import Logger, new_logger
from ..types import events as ev_types
from .kv import BlockIndexer, TxIndexer

_SUBSCRIBER = "indexer-service"


class IndexerService:
    def __init__(self, tx_indexer: TxIndexer,
                 block_indexer: BlockIndexer, event_bus,
                 logger: Optional[Logger] = None):
        self.tx_indexer = tx_indexer
        self.block_indexer = block_indexer
        self.event_bus = event_bus
        self.logger = logger if logger is not None else \
            new_logger("txindex")
        self._tasks: list[asyncio.Task] = []

    async def start(self) -> None:
        tx_sub = self.event_bus.subscribe(
            _SUBSCRIBER, ev_types.EVENT_QUERY_TX, out_capacity=1000)
        block_sub = self.event_bus.subscribe(
            _SUBSCRIBER, ev_types.EVENT_QUERY_NEW_BLOCK_EVENTS,
            out_capacity=100)
        loop = asyncio.get_running_loop()
        self._tasks = [loop.create_task(self._tx_routine(tx_sub)),
                       loop.create_task(self._block_routine(block_sub))]

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        try:
            self.event_bus.unsubscribe_all(_SUBSCRIBER)
        except Exception:
            pass

    async def _tx_routine(self, sub) -> None:
        try:
            while True:
                msg = await sub.next()
                p = msg.data.payload
                self.tx_indexer.index(abci.TxResult(
                    height=p["height"], index=p["index"],
                    tx=p["tx"], result=p["result"]))
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self.logger.error("tx indexing stopped", err=str(e))

    async def _block_routine(self, sub) -> None:
        try:
            while True:
                msg = await sub.next()
                p = msg.data.payload
                self.block_indexer.index(p["height"],
                                         p.get("events", []))
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self.logger.error("block indexing stopped", err=str(e))
