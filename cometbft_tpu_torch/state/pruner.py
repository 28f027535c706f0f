"""Pruner: background service driving block and state pruning.

Reference: state/pruner.go — two retain-height knobs, the application's
(set via the Commit response's retain_height) and the data companion's
(set over the pruning RPC routes, which also switch the companion on);
the service prunes up to the MINIMUM of the enabled knobs on an
interval.  Retain heights are persisted so they survive restarts.  A
copy of cometbft_tpu/state/pruner.py: the same db rows and texts.  The
ABCI-results, tx- and block-indexer retain heights are set only by the
gRPC pruning service, and come with it (ROADMAP A.7e-5b).  The pruner
touches no kernel, so its loop keeps the reference's log-and-retry.
"""
from __future__ import annotations

import asyncio
from typing import Optional

from ..libs.log import Logger, new_logger

_APP_RETAIN_KEY = b"prune/app_retain_height"
_COMPANION_RETAIN_KEY = b"prune/companion_retain_height"


class Pruner:
    """Reference: state/pruner.go Pruner."""

    def __init__(self, state_store, block_store, db,
                 interval_s: float = 10.0,
                 logger: Optional[Logger] = None,
                 metrics=None):
        from .metrics import Metrics
        self.metrics = metrics if metrics is not None else Metrics()
        self.state_store = state_store
        self.block_store = block_store
        self._db = db                       # persistence for retain heights
        self.interval_s = interval_s
        # switched on by the pruning RPC routes (rpc/core.py)
        self.companion_enabled = False
        self.logger = logger or new_logger("pruner")
        self._task: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()

    # -- retain heights ----------------------------------------------------
    def _get(self, key: bytes) -> int:
        raw = self._db.get(key)
        return int(raw.decode()) if raw else 0

    def _set(self, key: bytes, h: int) -> None:
        self._db.set_sync(key, str(h).encode())

    def set_application_retain_height(self, height: int) -> None:
        """Called after every Commit with the app's retain_height
        (reference: SetApplicationBlockRetainHeight)."""
        if height <= 0:
            return
        if height <= self._get(_APP_RETAIN_KEY):
            return      # unchanged or backwards: skip the sync write —
                        # this runs on the per-block commit path
        self._set(_APP_RETAIN_KEY, height)
        self.metrics.application_block_retain_height.set(height)
        self._wake.set()

    def set_companion_retain_height(self, height: int) -> None:
        """Reference: SetCompanionBlockRetainHeight (pruning RPC)."""
        if height <= 0:
            raise ValueError("retain height must be positive")
        if height > self.block_store.height:
            raise ValueError("retain height beyond store height")
        if height < self._get(_COMPANION_RETAIN_KEY):
            raise ValueError("retain height cannot move backwards")
        self._set(_COMPANION_RETAIN_KEY, height)
        self._wake.set()
        self.metrics.pruning_service_block_retain_height.set(height)

    def get_application_retain_height(self) -> int:
        return self._get(_APP_RETAIN_KEY)

    def get_companion_retain_height(self) -> int:
        return self._get(_COMPANION_RETAIN_KEY)

    def effective_retain_height(self) -> int:
        """min of the enabled knobs (reference: findMinRetainHeight).
        With the companion enabled, nothing is pruned until BOTH knobs
        have been set — the companion must explicitly release data."""
        app = self._get(_APP_RETAIN_KEY)
        if not self.companion_enabled:
            return app
        comp = self._get(_COMPANION_RETAIN_KEY)
        if app == 0 or comp == 0:
            return 0
        return min(app, comp)

    # -- service -----------------------------------------------------------
    async def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def _run(self) -> None:
        while True:
            try:
                self._wake.clear()
                self.prune_once()
                try:
                    await asyncio.wait_for(self._wake.wait(),
                                           self.interval_s)
                except asyncio.TimeoutError:
                    pass
            except asyncio.CancelledError:
                raise
            except Exception:
                self.logger.error("pruning failed", exc_info=True)
                await asyncio.sleep(self.interval_s)

    def prune_once(self) -> tuple[int, int]:
        """One pruning pass; returns (blocks_pruned, new_base)."""
        retain = self.effective_retain_height()
        # a buggy app can return a retain height beyond the chain tip;
        # clamp instead of erroring forever (prune_blocks would raise)
        retain = min(retain, self.block_store.height)
        if retain <= self.block_store.base or retain <= 0:
            return 0, self.block_store.base
        pruned, new_base = self.block_store.prune_blocks(retain)
        self.metrics.block_store_base_height.set(new_base)
        if pruned:
            # state + ABCI results follow the block base
            self.state_store.prune_states(self.block_store.base - pruned,
                                          retain, retain)
            self.logger.info("pruned blocks", pruned=pruned,
                             new_base=new_base)
        return pruned, new_base
