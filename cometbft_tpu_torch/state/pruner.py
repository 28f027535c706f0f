"""Pruner: background service driving block/state/ABCI-results pruning.

Reference: state/pruner.go — two retain-height knobs, the application's
(set via the Commit response's retain_height) and the data companion's
(set over the pruning gRPC service or the pruning RPC routes, which
also switch the companion on); the service prunes up to the MINIMUM of
the enabled knobs on an interval.  The companion also sets a retain
height for each of its three artifact classes, ABCI results and the tx
and block indexes, and each pass prunes them up to those heights from a
per-class watermark.  Retain heights are persisted so they survive
restarts.  A copy of cometbft_tpu/state/pruner.py: the same db rows and
texts.  The pruner touches no kernel, so its loop keeps the reference's
log-and-retry.
"""
from __future__ import annotations

import asyncio
from typing import Optional

from ..libs.log import Logger, new_logger

_APP_RETAIN_KEY = b"prune/app_retain_height"
_COMPANION_RETAIN_KEY = b"prune/companion_retain_height"
_ABCI_RESULTS_RETAIN_KEY = b"prune/abci_results_retain_height"
_TX_INDEXER_RETAIN_KEY = b"prune/tx_indexer_retain_height"
_BLOCK_INDEXER_RETAIN_KEY = b"prune/block_indexer_retain_height"
# per-pass bound on companion-artifact heights (event-loop latency cap;
# the watermark carries progress across passes)
MAX_HEIGHTS_PER_PASS = 10_000


class Pruner:
    """Reference: state/pruner.go Pruner."""

    def __init__(self, state_store, block_store, db,
                 interval_s: float = 10.0,
                 companion_enabled: bool = False,
                 logger: Optional[Logger] = None,
                 tx_indexer=None, block_indexer=None,
                 metrics=None):
        from .metrics import Metrics
        self.metrics = metrics if metrics is not None else Metrics()
        self.state_store = state_store
        self.block_store = block_store
        self._db = db                       # persistence for retain heights
        self.interval_s = interval_s
        self.companion_enabled = companion_enabled
        self.logger = logger or new_logger("pruner")
        self.tx_indexer = tx_indexer
        self.block_indexer = block_indexer
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
        self._set_companion_only(_COMPANION_RETAIN_KEY, height)
        self.metrics.pruning_service_block_retain_height.set(height)

    def get_application_retain_height(self) -> int:
        return self._get(_APP_RETAIN_KEY)

    def get_companion_retain_height(self) -> int:
        return self._get(_COMPANION_RETAIN_KEY)

    # companion-only retain heights for the three data-companion
    # artifact classes (reference: state/pruner.go
    # SetABCIResRetainHeight / SetTxIndexerRetainHeight /
    # SetBlockIndexerRetainHeight, driven by the pruning gRPC service)
    def set_abci_results_retain_height(self, height: int) -> None:
        self._set_companion_only(_ABCI_RESULTS_RETAIN_KEY, height)

    def get_abci_results_retain_height(self) -> int:
        return self._get(_ABCI_RESULTS_RETAIN_KEY)

    def set_tx_indexer_retain_height(self, height: int) -> None:
        self._set_companion_only(_TX_INDEXER_RETAIN_KEY, height)

    def get_tx_indexer_retain_height(self) -> int:
        return self._get(_TX_INDEXER_RETAIN_KEY)

    def set_block_indexer_retain_height(self, height: int) -> None:
        self._set_companion_only(_BLOCK_INDEXER_RETAIN_KEY, height)

    def get_block_indexer_retain_height(self) -> int:
        return self._get(_BLOCK_INDEXER_RETAIN_KEY)

    def _set_companion_only(self, key: bytes, height: int) -> None:
        if height <= 0:
            raise ValueError("retain height must be positive")
        if height > self.block_store.height:
            raise ValueError("retain height beyond store height")
        if height < self._get(key):
            raise ValueError("retain height cannot move backwards")
        self._set(key, height)
        self._wake.set()

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
        self._prune_companion_artifacts()
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

    def _prune_companion_artifacts(self) -> None:
        """Prune ABCI results and tx/block indices up to their
        companion-set retain heights (reference: pruner.go
        pruneABCIResToRetainHeight / pruneIndexesToRetainHeight).
        Each class tracks its own last-pruned watermark so a pass only
        touches new heights."""
        tip = self.block_store.height
        # a target that isn't wired (yet) returns None: the watermark
        # must NOT advance, or its heights would be skipped forever
        targets = [
            (_ABCI_RESULTS_RETAIN_KEY, b"prune/abci_results_last",
             lambda lo, hi: self.state_store.prune_abci_responses(lo, hi)
             if hasattr(self.state_store, "prune_abci_responses")
             else None),
            (_TX_INDEXER_RETAIN_KEY, b"prune/tx_indexer_last",
             lambda lo, hi: self.tx_indexer.prune(lo, hi)
             if self.tx_indexer is not None else None),
            (_BLOCK_INDEXER_RETAIN_KEY, b"prune/block_indexer_last",
             lambda lo, hi: self.block_indexer.prune(lo, hi)
             if self.block_indexer is not None else None),
        ]
        for retain_key, last_key, do_prune in targets:
            # always keep the latest height (reference keeps the tip for
            # crash recovery)
            retain = min(self._get(retain_key), tip)
            last = self._get(last_key)
            if retain <= last or retain <= 0:
                continue
            # bound the synchronous work per pass: prune_once runs on
            # the event loop, and a companion jumping the retain height
            # by millions must not stall consensus for the whole scan
            lo = max(last, 1)
            hi = min(retain, lo + MAX_HEIGHTS_PER_PASS)
            try:
                n = do_prune(lo, hi)
            except Exception:
                self.logger.error("companion prune failed",
                                  exc_info=True)
                continue
            if n is None:
                continue
            self._set(last_key, hi)
            if hi < retain:
                self._wake.set()    # continue promptly next pass
            if n:
                self.logger.info("pruned companion artifacts",
                                 kind=retain_key.decode(), pruned=n)
