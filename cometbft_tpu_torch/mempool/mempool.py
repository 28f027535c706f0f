"""CListMempool: the concurrent pool with app-defined priority lanes.

Reference: mempool/clist_mempool.go:34 — per-lane lists, CheckTx through
the mempool ABCI connection, LRU dedup cache (cache.go), recheck after
commit, interleaved-weighted-round-robin reaping (iterators.go IWRR),
TxsAvailable notification; mempool/mempool.go:27 (interface);
nop_mempool.go (disabled variant).

Tx validity (signatures included) is the APP's job via CheckTx — the
pool itself never inspects tx contents.

The port's copy of cometbft_tpu/mempool/mempool.py: the same cache, lanes,
reap order, incremental recheck, error types and texts.  The pool touches
no device.
"""
from __future__ import annotations

import abc
import asyncio
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from ..abci import types as abci
from ..config import MempoolConfig
from ..libs import tracing
from ..libs.log import Logger, new_logger
from ..types.tx import compute_proto_size_overhead, tx_key


class MempoolError(Exception):
    pass


class TxInCacheError(MempoolError):
    pass


class MempoolFullError(MempoolError):
    pass


class InvalidTxError(MempoolError):
    def __init__(self, code: int, log: str = ""):
        super().__init__(f"tx rejected by CheckTx: code {code} {log}")
        self.code = code


class TxCache:
    """LRU of recently seen tx keys (reference: mempool/cache.go)."""

    def __init__(self, size: int):
        self._size = size
        self._m: OrderedDict[bytes, None] = OrderedDict()

    def push(self, key: bytes) -> bool:
        """Returns False if already present."""
        if key in self._m:
            self._m.move_to_end(key)
            return False
        self._m[key] = None
        if len(self._m) > self._size:
            self._m.popitem(last=False)
        return True

    def remove(self, key: bytes) -> None:
        self._m.pop(key, None)

    def has(self, key: bytes) -> bool:
        return key in self._m

    def keys(self) -> list:
        return list(self._m.keys())

    def __len__(self) -> int:
        return len(self._m)

    def reset(self) -> None:
        self._m.clear()


@dataclass
class MempoolTx:
    tx: bytes
    key: bytes
    height: int          # height at which the tx was last validated
    gas_wanted: int
    lane: str
    senders: set = field(default_factory=set)
    seq: int = 0         # global FIFO sequence for cross-lane ordering
    # app-reported state keys the tx's validity depends on
    # (CheckTxResponse.recheck_keys); empty = unattributed, so the
    # bounded-age watermark alone schedules its rechecks
    recheck_keys: frozenset = frozenset()


class Mempool(abc.ABC):
    """Reference: mempool/mempool.go Mempool interface (:27-100)."""

    @abc.abstractmethod
    async def check_tx(self, tx: bytes, sender: str = ""
                       ) -> abci.CheckTxResponse: ...

    @abc.abstractmethod
    def reap_max_bytes_max_gas(self, max_bytes: int,
                               max_gas: int) -> list[bytes]: ...

    @abc.abstractmethod
    async def update(self, height: int, txs: Sequence[bytes],
                     tx_results: Sequence[abci.ExecTxResult],
                     pre_check=None, post_check=None) -> None: ...

    def lock(self) -> None: ...

    def unlock(self) -> None: ...

    def pre_update(self) -> None: ...

    async def flush_app_conn(self) -> None: ...

    def size(self) -> int:
        return 0

    def size_bytes(self) -> int:
        return 0


class CListMempool(Mempool):
    def __init__(self, config: MempoolConfig, proxy_app,
                 lanes: Optional[dict[str, int]] = None,
                 default_lane: str = "",
                 height: int = 0,
                 logger: Optional[Logger] = None,
                 metrics=None):
        """proxy_app: the mempool ABCI connection.  lanes: lane id →
        priority from the app's InfoResponse; empty → single implicit
        lane (priority 0)."""
        if lanes and not default_lane:
            raise MempoolError("lanes set but no default lane")
        if lanes and default_lane not in lanes:
            raise MempoolError("default lane not in lane list")
        from .metrics import Metrics
        self.metrics = metrics if metrics is not None else Metrics()
        self.config = config
        self.proxy_app = proxy_app
        self.logger = logger if logger is not None else \
            new_logger("mempool")
        self.lanes = dict(lanes or {"": 0})
        self.default_lane = default_lane if lanes else ""
        # per-lane insertion-ordered maps: key -> MempoolTx
        self._lane_txs: dict[str, OrderedDict[bytes, MempoolTx]] = {
            lane: OrderedDict() for lane in self.lanes}
        # per-lane byte totals, maintained incrementally: lane_sizes
        # feeds the metrics updater on EVERY add/evict, where a rescan
        # would cost O(pool) per added tx
        self._lane_bytes: dict[str, int] = {
            lane: 0 for lane in self.lanes}
        self.cache = TxCache(config.cache_size)
        self.height = height
        self._seq = 0
        self._size_bytes = 0
        self._size_count = 0
        # commit-time exclusion: while locked, check_tx waits so no tx
        # can slip in unvalidated between FinalizeBlock and recheck
        self._unlocked = asyncio.Event()
        self._unlocked.set()
        self._txs_available: Optional[asyncio.Event] = None
        self._notified_txs_available = False
        # tx keys admitted while a commit cycle raced their in-flight
        # CheckTx: revalidated unconditionally by the next update()
        # (the FinalizeBlock↔recheck admission-gap fix)
        self._pending_recheck: set[bytes] = set()
        # broadcast wakeup for per-peer gossip routines: replaced on
        # every append so any number of waiters can block on it (the
        # clist-wait analog, reference internal/clist/clist.go:95-104)
        self._gossip_wake = asyncio.Event()
        # bounded (seq, key) append log: per-peer gossip cursors and
        # the per-salt short-id maps read "what arrived since seq S"
        # from here in O(new) instead of rescanning every lane per
        # wire message
        self._append_log: list = []
        # highest seq the log has DROPPED (trim/flush); a cursor at
        # or above it can still be served from the log.  -1 = nothing
        # ever dropped, so even the from-the-beginning cursor works
        self._log_start_seq = -1

    # ------------------------------------------------------------------
    def enable_txs_available(self) -> None:
        self._txs_available = asyncio.Event()

    def txs_available(self) -> asyncio.Event:
        if self._txs_available is None:
            raise MempoolError("txs_available not enabled")
        return self._txs_available

    def _notify_txs_available(self) -> None:
        if self.size() == 0:
            return
        if self._txs_available is not None and \
                not self._notified_txs_available:
            self._notified_txs_available = True
            self._txs_available.set()

    def _wake_gossip(self) -> None:
        ev = self._gossip_wake
        self._gossip_wake = asyncio.Event()
        ev.set()

    async def wait_for_change(self, last_seq: int,
                              timeout: float = 1.0) -> None:
        """Block until the append sequence advances past last_seq or
        the fallback timeout elapses — gossip routines park here
        instead of polling (no busy-poll under zero load)."""
        ev = self._gossip_wake            # capture BEFORE the seq check
        if self._seq != last_seq:
            return
        try:
            await asyncio.wait_for(ev.wait(), timeout)
        except asyncio.TimeoutError:
            pass

    # ------------------------------------------------------------------
    def lock(self) -> None:
        """Block new check_tx admissions (reference: Mempool.Lock held
        across app Commit + Update)."""
        self._unlocked.clear()

    def unlock(self) -> None:
        self._unlocked.set()

    def pre_update(self) -> None:
        pass

    async def flush_app_conn(self) -> None:
        await self.proxy_app.flush()

    def size(self) -> int:
        # O(1): called on every CheckTx (_check_full), every metrics
        # update, and every gossip bound
        return self._size_count

    def size_bytes(self) -> int:
        return self._size_bytes

    def lane_sizes(self, lane: str) -> tuple[int, int]:
        d = self._lane_txs.get(lane, {})
        return len(d), self._lane_bytes.get(lane, 0)

    def contains(self, key: bytes) -> bool:
        return any(key in d for d in self._lane_txs.values())

    def get_tx_by_hash(self, h: bytes) -> Optional[bytes]:
        for d in self._lane_txs.values():
            e = d.get(h)
            if e is not None:
                return e.tx
        return None

    _APPEND_LOG_MAX = 65536

    def keys_appended_after(self, cursor: int) -> Optional[list]:
        """Tx keys appended with seq > cursor, in append order — the
        O(new) feed for gossip cursors and short-id maps.  Returns
        None when the bounded log no longer reaches back to cursor
        (caller falls back to a full pool scan).  Keys whose txs have
        since committed/evicted still appear; callers resolve through
        the live pool (gossip) or tolerate stale entries (short-id
        maps, where a stale hit only suppresses a useless re-pull)."""
        if cursor < self._log_start_seq:
            return None
        log = self._append_log
        # cursors trail the tip by a handful of appends in steady
        # state: walk back from the right
        i = len(log)
        while i > 0 and log[i - 1][0] > cursor:
            i -= 1
        return [k for _, k in log[i:]]

    def get_entry(self, key: bytes) -> Optional[MempoolTx]:
        for d in self._lane_txs.values():
            e = d.get(key)
            if e is not None:
                return e
        return None

    def add_sender(self, key: bytes, sender: str) -> None:
        """Record that a peer holds this tx (it advertised or sent
        it) so gossip never echoes the tx back at it."""
        if not sender:
            return
        for d in self._lane_txs.values():
            e = d.get(key)
            if e is not None:
                e.senders.add(sender)
                return

    def flush(self) -> None:
        """Remove everything (reference: Flush)."""
        for d in self._lane_txs.values():
            d.clear()
        for lane in self._lane_bytes:
            self._lane_bytes[lane] = 0
        self._size_bytes = 0
        self._size_count = 0
        self._pending_recheck.clear()
        self._append_log.clear()
        self._log_start_seq = self._seq
        self.cache.reset()

    # ------------------------------------------------------------------
    async def check_tx(self, tx: bytes, sender: str = ""
                       ) -> abci.CheckTxResponse:
        """Validate a tx via the app and add it to the pool.

        Reference: CheckTx (:347) + handleCheckTxResponse (:407)."""
        if len(tx) > self.config.max_tx_bytes:
            raise MempoolError(
                f"tx too large: {len(tx)} > {self.config.max_tx_bytes}")
        # wait out any in-progress commit/update cycle
        while not self._unlocked.is_set():
            await self._unlocked.wait()
        # dedup BEFORE the capacity math: under gossip most
        # deliveries are duplicates (every peer forwards the same
        # txs), which should not pay the admission bookkeeping
        key = tx_key(tx)
        if not self.cache.push(key):
            # record the extra sender for dedup/gossip routing
            for d in self._lane_txs.values():
                e = d.get(key)
                if e is not None and sender:
                    e.senders.add(sender)
            self.metrics.already_received_txs.add()
            raise TxInCacheError("tx already exists in cache")
        try:
            self._check_full(len(tx))
        except MempoolError:
            self.cache.remove(key)
            raise
        checked_at = self.height
        try:
            t0 = time.perf_counter()
            with tracing.span(tracing.MEMPOOL, "checktx",
                              height=self.height, bytes=len(tx)):
                res = await self.proxy_app.check_tx(
                    abci.CheckTxRequest(
                        tx=tx, type=abci.CHECK_TX_TYPE_CHECK))
            self.metrics.checktx_duration_seconds.observe(
                time.perf_counter() - t0)
        except Exception:
            self.cache.remove(key)
            raise
        if res.code != abci.CODE_TYPE_OK:
            if not self.config.keep_invalid_txs_in_cache:
                self.cache.remove(key)
            self.metrics.failed_txs.add()
            raise InvalidTxError(res.code, res.log)
        try:
            lane = self._resolve_lane(res.lane_id)
            self._add_tx(tx, key, res.gas_wanted, lane, sender,
                         getattr(res, "recheck_keys", None))
        except MempoolError:
            # a tx never admitted to the pool must not stay cached, or
            # it becomes unsubmittable until LRU eviction
            self.cache.remove(key)
            raise
        # the FinalizeBlock↔recheck gap (the old :150 note): the gate
        # above ran BEFORE the CheckTx await, so a commit cycle that
        # started during the call validated this tx against pre-block
        # state AND already ran its recheck pass without us.  Mark the
        # entry so the NEXT update()'s recheck slice revalidates it
        # unconditionally — key overlap and the watermark may both
        # miss it.  No retry loop here: under sub-second block
        # intervals a validate-retry could chase the tip forever.
        if not self._unlocked.is_set() or self.height != checked_at:
            # pointless (and unbounded) when recheck is disabled —
            # nothing would ever drain the set
            if self.config.recheck and self.contains(key):
                self._pending_recheck.add(key)
                self.metrics.checktx_revalidations.add()
        return res

    def _resolve_lane(self, lane_id: str) -> str:
        if not lane_id:
            return self.default_lane
        if lane_id not in self.lanes:
            raise MempoolError(f"app assigned unknown lane {lane_id!r}")
        return lane_id

    def _check_full(self, tx_size: int) -> None:
        if self.size() >= self.config.size or \
                self._size_bytes + tx_size > self.config.max_txs_bytes:
            self.metrics.rejected_txs.add()
            raise MempoolFullError(
                f"mempool is full: {self.size()} txs, "
                f"{self._size_bytes} bytes")

    def _add_tx(self, tx: bytes, key: bytes, gas_wanted: int,
                lane: str, sender: str,
                recheck_keys=None) -> None:
        if self.contains(key):
            return
        # capacity may have changed across the CheckTx await
        # (reference: isFull re-check in handleCheckTxResponse)
        self._check_full(len(tx))
        self._seq += 1
        entry = MempoolTx(tx=tx, key=key, height=self.height,
                          gas_wanted=gas_wanted, lane=lane,
                          senders={sender} if sender else set(),
                          seq=self._seq,
                          recheck_keys=frozenset(recheck_keys or ()))
        self._lane_txs[lane][key] = entry
        self._append_log.append((self._seq, key))
        if len(self._append_log) > self._APPEND_LOG_MAX:
            drop = len(self._append_log) // 4
            self._log_start_seq = self._append_log[drop - 1][0]
            del self._append_log[:drop]
        self._size_count += 1
        self._size_bytes += len(tx)
        self._lane_bytes[lane] = \
            self._lane_bytes.get(lane, 0) + len(tx)
        self.metrics.tx_size_bytes.observe(len(tx))
        self.metrics.update_sizes(self)
        self.logger.debug("Added tx", lane=lane,
                          tx=key.hex().upper()[:12])
        self._notify_txs_available()
        self._wake_gossip()

    def remove_tx_by_key(self, key: bytes) -> None:
        for d in self._lane_txs.values():
            e = d.pop(key, None)
            if e is not None:
                self._size_count -= 1
                self._size_bytes -= len(e.tx)
                self._lane_bytes[e.lane] = \
                    self._lane_bytes.get(e.lane, 0) - len(e.tx)
                return
        raise MempoolError("transaction not found in mempool")

    # ------------------------------------------------------------------
    def _iwrr_order(self) -> list[MempoolTx]:
        """Interleaved weighted round-robin across lanes by priority
        (reference: iterators.go IWRRIterator)."""
        queues = {lane: list(d.values())
                  for lane, d in self._lane_txs.items() if d}
        if not queues:
            return []
        out: list[MempoolTx] = []
        # each full round grants each lane `priority` slots, interleaved
        while queues:
            for lane in sorted(queues,
                               key=lambda ln: -self.lanes.get(ln, 0)):
                weight = max(1, self.lanes.get(lane, 0))
                q = queues.get(lane)
                if q is None:
                    continue
                take = min(weight, len(q))
                out.extend(q[:take])
                del q[:take]
                if not q:
                    del queues[lane]
        return out

    def reap_max_bytes_max_gas(self, max_bytes: int,
                               max_gas: int) -> list[bytes]:
        """Reference: ReapMaxBytesMaxGas (:690)."""
        txs: list[bytes] = []
        total_bytes = 0
        total_gas = 0
        for e in self._iwrr_order():
            # budget the proto-encoded size (per-tx tag + length varint),
            # not the raw bytes — reference ReapMaxBytesMaxGas uses
            # ComputeProtoSizeForTxs so the encoded block stays under
            # the consensus max_bytes peers enforce
            nb = total_bytes + len(e.tx) + \
                compute_proto_size_overhead(len(e.tx))
            if max_bytes > -1 and nb > max_bytes:
                break
            ng = total_gas + e.gas_wanted
            if max_gas > -1 and ng > max_gas:
                break
            txs.append(e.tx)
            total_bytes, total_gas = nb, ng
        return txs

    def reap_max_txs(self, n: int) -> list[bytes]:
        order = self._iwrr_order()
        if n < 0:
            n = len(order)
        return [e.tx for e in order[:n]]

    # ------------------------------------------------------------------
    async def update(self, height: int, txs: Sequence[bytes],
                     tx_results: Sequence[abci.ExecTxResult],
                     pre_check: Optional[Callable] = None,
                     post_check: Optional[Callable] = None) -> None:
        """Remove committed txs, then recheck the invalidated slice.

        Reference: Update (:767) — caller must hold the mempool lock
        (BlockExecutor.commit does).  Incremental recheck
        (docs/pipeline.md): the committed block's app-reported
        ``recheck_keys`` select which pooled txs could have been
        invalidated; everything else is revalidated on the bounded-age
        watermark instead of after every block."""
        self.height = height
        self._notified_txs_available = False
        if self._txs_available is not None:
            self._txs_available.clear()
        touched: set[bytes] = set()
        unattributed_commit = False
        for tx, res in zip(txs, tx_results):
            key = tx_key(tx)
            if res.code == abci.CODE_TYPE_OK:
                self.cache.push(key)   # committed: keep in cache forever
                rk = getattr(res, "recheck_keys", None)
                if rk:
                    touched.update(rk)
                else:
                    # a state-changing tx the app didn't attribute:
                    # key targeting is unsound for this block, fall
                    # back to rechecking every attributed entry too
                    unattributed_commit = True
            elif not self.config.keep_invalid_txs_in_cache:
                self.cache.remove(key)
            try:
                self.remove_tx_by_key(key)
            except MempoolError:
                pass
        if self.config.recheck and self.size() > 0:
            t0 = time.perf_counter()
            if self.config.recheck_incremental:
                due = self._recheck_slice(height, touched,
                                          unattributed_commit)
                if self._pending_recheck:
                    seen = {e.key for e in due}
                    for d in self._lane_txs.values():
                        for e in d.values():
                            if e.key in self._pending_recheck and \
                                    e.key not in seen:
                                due.append(e)
            else:
                due = [e for d in self._lane_txs.values()
                       for e in d.values()]
            skipped = self.size() - len(due)
            if skipped:
                self.metrics.recheck_skipped_txs.add(skipped)
            if due:
                with tracing.span(tracing.MEMPOOL, "recheck",
                                  height=height, txs=len(due),
                                  skipped=skipped):
                    await self._recheck_entries(due)
            dt = time.perf_counter() - t0
            self.metrics.recheck_duration_seconds.set(dt)
            self.metrics.recheck_pass_duration_seconds.observe(dt)
        # every commit settles the raced-admission flags — the due
        # slice above consumed them; with recheck disabled or an
        # empty pool there is nothing left they could select
        self._pending_recheck.clear()
        self.metrics.update_sizes(self)
        self._notify_txs_available()

    def _recheck_slice(self, height: int, touched: set,
                       unattributed_commit: bool) -> list[MempoolTx]:
        """The pooled txs the committed block could have invalidated:
        key overlap where the app attributes state keys, plus every
        entry whose last validation is recheck_max_age_blocks old (the
        watermark bounds staleness for unattributed txs and apps, and
        for validity that depends on non-key state like height)."""
        max_age = self.config.recheck_max_age_blocks
        due: list[MempoolTx] = []
        for d in self._lane_txs.values():
            for e in d.values():
                if height - e.height >= max_age:
                    due.append(e)
                elif e.recheck_keys and (
                        unattributed_commit or
                        not touched.isdisjoint(e.recheck_keys)):
                    due.append(e)
        return due

    async def _recheck_entries(self, entries: list[MempoolTx]) -> None:
        """Re-validate the given entries at the new height (reference:
        recheckTxs + handleRecheckTxResponse :618), batching CheckTx
        through the async client — the socket transport pipelines the
        whole chunk in flight instead of paying a round trip per tx."""
        batch = max(1, self.config.recheck_batch_size)
        for i in range(0, len(entries), batch):
            chunk = entries[i:i + batch]
            results = await asyncio.gather(
                *(self.proxy_app.check_tx(abci.CheckTxRequest(
                    tx=e.tx, type=abci.CHECK_TX_TYPE_RECHECK))
                  for e in chunk),
                return_exceptions=True)
            for e, res in zip(chunk, results):
                if isinstance(res, BaseException):
                    raise res
                self.metrics.recheck_times.add()
                if res.code != abci.CODE_TYPE_OK:
                    removed = self._lane_txs.get(e.lane, {}) \
                        .pop(e.key, None)
                    if removed is not None:
                        self._size_count -= 1
                        self._size_bytes -= len(e.tx)
                        self._lane_bytes[e.lane] = \
                            self._lane_bytes.get(e.lane, 0) - len(e.tx)
                        self.metrics.evicted_txs.add()
                    if not self.config.keep_invalid_txs_in_cache:
                        self.cache.remove(e.key)
                else:
                    # revalidated: reset the watermark clock
                    e.height = self.height


class NopMempool(Mempool):
    """Disabled mempool (reference: nop_mempool.go)."""

    async def check_tx(self, tx: bytes, sender: str = ""):
        raise MempoolError("mempool is disabled")

    def reap_max_bytes_max_gas(self, max_bytes: int,
                               max_gas: int) -> list[bytes]:
        return []

    async def update(self, height, txs, tx_results, pre_check=None,
                     post_check=None) -> None:
        pass
