"""Mempool reactor: transaction gossip.

Reference: mempool/reactor.go — one per-peer goroutine walking the lane
iterators, Receive → TryAddTx; senders tracked so a tx never bounces
straight back to where it came from.  Wire: cometbft.mempool.v2
Message (mempool/messages.py).

Two gossip planes (docs/gossip.md):

  * flood (reference behavior) — push every tx the peer hasn't seen,
    batched.  Used for peers that did not negotiate ``txrecon/1``.
  * have/want reconciliation — advertise short salted tx-hash
    summaries (TxHave); the peer diffs them against its pool + dedup
    cache and pulls only what it misses (TxWant → Txs).  Brand-new
    LOCAL txs are still pushed in full to ~recon_push_peers peers so
    first-hop latency doesn't pay an advertise/pull round trip.
    Bytes on the wire stop scaling with peer count: N-1 peers send a
    tx's 8-byte id instead of its body, and duplicate CheckTx
    deliveries collapse into id lookups.

Want tracking is single-writer: the reactor's receive path and the
supervised sweep routine both run on the event loop and every
mutation of the in-flight table goes through ``_WantTracker``'s
methods (the same owner discipline PeerState keeps in
consensus/reactor.py).

The port's copy of cometbft_tpu/mempool/reactor.py: the same channel,
messages, feature, want tracker, sweep, salt epochs and batching.  The
gossip loops keep the JAX restart policy: they touch no device.
"""
from __future__ import annotations

import asyncio
import hashlib
from collections import OrderedDict
from typing import Optional

from ..config import MempoolConfig
from ..libs import tracing
from ..libs.log import Logger
from ..libs.supervisor import RestartPolicy
from ..p2p.conn import ChannelDescriptor
from ..p2p.switch import Peer, Reactor
from ..types.tx import hash_each
from .mempool import CListMempool, MempoolError, TxInCacheError
from .messages import (
    FEATURE_TXRECON, TxHaveMessage, TxWantMessage,
    TxsMessage, decode_mempool, encode_mempool, short_ids,
)

MEMPOOL_CHANNEL = 0x30


class _ShortMap:
    """My pool's keys under one advertiser salt: short id -> tx key.

    Extended incrementally via the pool's append sequence; entries
    are never removed when a tx commits (the dedup cache still knows
    the tx, and a stale hit only suppresses a useless re-pull), but
    the map is rebuilt from the live pool when it outgrows it."""

    __slots__ = ("cursor", "m")

    def __init__(self):
        self.cursor = -1
        self.m: dict[bytes, bytes] = {}


class _WantEntry:
    __slots__ = ("salt", "sid", "asked", "ts", "tries", "advertisers")

    def __init__(self, salt: bytes, sid: bytes, asked: str, ts: float):
        self.salt = salt
        self.sid = sid
        self.asked = asked          # peer currently pulled from
        self.ts = ts                # when the current want was sent
        self.tries = 1
        self.advertisers = [asked]  # every peer that announced the id


class _WantTracker:
    """In-flight pulls keyed by (salt, short id) with per-peer
    attribution.  Single writer: the reactor's event-loop callbacks.
    All mutation goes through these methods so the invariants (bounded
    size, advertiser dedup, monotone tries) live in one place."""

    MAX_WANTS = 32_768

    def __init__(self):
        self._m: dict[tuple, _WantEntry] = {}
        # live salt -> entry count, so active_salts() is O(#salts)
        # per call instead of an O(table) scan per received Txs
        # message (the table bound is 32k)
        self._salt_counts: dict[bytes, int] = {}

    def __len__(self) -> int:
        return len(self._m)

    def get(self, salt: bytes, sid: bytes) -> Optional[_WantEntry]:
        return self._m.get((salt, sid))

    def active_salts(self) -> list:
        return list(self._salt_counts)

    def _salt_dec(self, salt: bytes) -> None:
        n = self._salt_counts.get(salt, 0) - 1
        if n <= 0:
            self._salt_counts.pop(salt, None)
        else:
            self._salt_counts[salt] = n

    def open(self, salt: bytes, sid: bytes, peer_id: str,
             now: float) -> Optional[_WantEntry]:
        """Record a new in-flight want; None when the table is full
        (the tx still arrives via flood peers / compact blocks)."""
        if len(self._m) >= self.MAX_WANTS:
            return None
        w = _WantEntry(salt, sid, peer_id, now)
        self._m[(salt, sid)] = w
        self._salt_counts[salt] = self._salt_counts.get(salt, 0) + 1
        return w

    def note_advertiser(self, w: _WantEntry, peer_id: str) -> None:
        if peer_id not in w.advertisers:
            w.advertisers.append(peer_id)

    def resolve(self, salt: bytes, sid: bytes) -> bool:
        if self._m.pop((salt, sid), None) is None:
            return False
        self._salt_dec(salt)
        return True

    def drop(self, w: _WantEntry) -> None:
        if self._m.pop((w.salt, w.sid), None) is not None:
            self._salt_dec(w.salt)

    def reissue(self, w: _WantEntry, peer_id: str, now: float) -> None:
        w.asked = peer_id
        w.ts = now
        w.tries += 1

    def expired(self, now: float, timeout_s: float) -> list:
        return [w for w in self._m.values()
                if now - w.ts >= timeout_s]


class MempoolReactor(Reactor):
    def __init__(self, mempool: CListMempool, config: MempoolConfig,
                 logger: Optional[Logger] = None):
        super().__init__("MEMPOOL")
        self.mempool = mempool
        self.config = config
        if logger is not None:
            self.logger = logger
        self._gossip_tasks: dict[str, object] = {}  # SupervisedTask
        # --- reconciliation state (owner: the event loop via the
        # methods below; docs/gossip.md) ----------------------------
        self._recon_peers: dict[str, Peer] = {}
        self._wants = _WantTracker()
        self._short_maps: "OrderedDict[bytes, _ShortMap]" = \
            OrderedDict()
        self._salt_bump = 0          # bumped on summary self-collision
        self._salt_cache: tuple = (None, b"")
        self._sweep_task = None
        # token bucket for NEW-salt map builds: each unseen salt costs
        # a full-pool rehash, so a peer spamming random salts could
        # burn CPU; beyond the budget its adverts are dropped (the
        # tx still arrives via other advertisers / the push path)
        self._salt_build_tokens = 16.0
        self._salt_build_last = 0.0

    def get_channels(self) -> list[ChannelDescriptor]:
        return [ChannelDescriptor(id=MEMPOOL_CHANNEL, priority=5,
                                  send_queue_capacity=1000)]

    def get_features(self) -> list[str]:
        return [FEATURE_TXRECON] \
            if getattr(self.config, "gossip_reconciliation", False) \
            else []

    def _peer_recon(self, peer: Peer) -> bool:
        """Both sides negotiated have/want gossip on this link."""
        if not getattr(self.config, "gossip_reconciliation", False):
            return False
        has = getattr(peer, "has_feature", None)
        return bool(has and has(FEATURE_TXRECON))

    async def add_peer(self, peer: Peer) -> None:
        if not self.config.broadcast:
            return

        def _stop_peer_on_giveup(st, exc):
            # supervised one-shot teardown (AST-checked invariant)
            if self.switch is not None:
                self.supervisor.spawn(
                    lambda: self.switch.stop_peer(peer, repr(exc)),
                    name=f"stop_peer:{peer.id[:12]}",
                    kind="stop_peer")

        if self._peer_recon(peer):
            self._recon_peers[peer.id] = peer
            self._ensure_sweeper()
        self._gossip_tasks[peer.id] = self.supervisor.spawn(
            lambda: self._gossip_routine(peer),
            name=f"mempool_gossip:{peer.id[:12]}",
            kind="mempool_gossip",
            policy=RestartPolicy(max_restarts=3, window_s=30.0,
                                 backoff_base_s=0.05,
                                 backoff_max_s=1.0),
            on_giveup=_stop_peer_on_giveup)

    async def remove_peer(self, peer: Peer, reason: str) -> None:
        self._recon_peers.pop(peer.id, None)
        t = self._gossip_tasks.pop(peer.id, None)
        if t is not None:
            t.cancel()

    # ------------------------------------------------------------------
    # receive path

    async def receive(self, chan_id: int, peer: Peer,
                      msg_bytes: bytes) -> None:
        """Reference: reactor.go Receive → TryAddTx, extended with the
        TxHave/TxWant reconciliation arms."""
        try:
            msg = decode_mempool(msg_bytes)
        except Exception as e:
            self.logger.error("bad mempool message", err=str(e))
            return
        # one peer-attributed instant per wire message (not per tx):
        # bounded by the p2p recv rate, and what lets fleet_report
        # attribute reconciliation chatter to links
        if isinstance(msg, TxsMessage):
            tracing.instant(tracing.MEMPOOL, "txs_recv",
                            txs=len(msg.txs), peer=peer.id[:12],
                            chan=chan_id)
            await self._receive_txs(msg, peer)
        elif isinstance(msg, TxHaveMessage):
            tracing.instant(tracing.MEMPOOL, "have_recv",
                            ids=len(msg.ids), peer=peer.id[:12],
                            chan=chan_id)
            self._receive_have(msg, peer)
        elif isinstance(msg, TxWantMessage):
            tracing.instant(tracing.MEMPOOL, "want_recv",
                            ids=len(msg.ids), peer=peer.id[:12],
                            chan=chan_id)
            self._receive_want(msg, peer)

    async def _receive_txs(self, msg: TxsMessage, peer: Peer) -> None:
        m = self.mempool.metrics
        useful = 0
        for tx in msg.txs:
            m.gossip_txs_received.add()
            try:
                await self.mempool.check_tx(tx, sender=peer.id)
                useful += len(tx)
            except TxInCacheError:
                m.gossip_txs_duplicate.add()
            except MempoolError:
                pass   # invalid/full are not peer faults
        recv = m.gossip_txs_received.value
        if recv:
            m.duplicate_delivery_ratio.set(
                m.gossip_txs_duplicate.value / recv)
        if useful and self.switch is not None:
            # the single claimed mempool channel — bounded like
            # touch_channel's ch_id
            ch_id = f"{MEMPOOL_CHANNEL:#x}"
            self.switch.metrics.message_useful_bytes_total \
                .with_labels(ch_id).add(useful)
        if msg.txs and len(self._wants):
            self._settle_wants(msg.txs)

    def _settle_wants(self, txs: list) -> None:
        """Arrived txs clear their in-flight want entries under every
        active salt (the salts present in the tracker are a handful —
        neighboring epochs plus rotation bumps)."""
        salts = self._wants.active_salts()
        if not salts:
            return
        keys = hash_each(txs)
        for salt in salts:
            for sid in short_ids(salt, keys):
                self._wants.resolve(salt, sid)

    def _allow_salt_build(self, salt: bytes) -> bool:
        """Rate-limit full-pool rehashes for salts we have no map for
        (~1.6 builds/s sustained, burst 16): honest peers converge on
        the epoch salt, so only a salt-spamming peer ever hits this."""
        if salt in self._short_maps:
            return True
        now = asyncio.get_running_loop().time()
        self._salt_build_tokens = min(
            16.0, self._salt_build_tokens +
            (now - self._salt_build_last) * 1.6)
        self._salt_build_last = now
        if self._salt_build_tokens < 1.0:
            return False
        self._salt_build_tokens -= 1.0
        return True

    def _receive_have(self, msg: TxHaveMessage, peer: Peer) -> None:
        """Diff the advertised ids against pool + dedup cache; pull
        what's missing, dedup pulls through the in-flight tracker."""
        if not self._peer_recon(peer):
            return
        if not self._allow_salt_build(msg.salt):
            return
        sm = self._short_map(msg.salt)
        m = self.mempool.metrics
        now = asyncio.get_running_loop().time()
        wants: list[bytes] = []
        for sid in msg.ids:
            key = sm.m.get(sid)
            if key is not None:
                # we hold (or held) it: remember the peer as a sender
                # so neither plane ever echoes the tx back at it
                self.mempool.add_sender(key, peer.id)
                continue
            w = self._wants.get(msg.salt, sid)
            if w is not None:
                self._wants.note_advertiser(w, peer.id)
                continue
            if self._wants.open(msg.salt, sid, peer.id, now) is None:
                continue            # tracker full; fall back to flood
            wants.append(sid)
        if wants:
            m.recon_wants_sent.add(len(wants))
            cap = self.config.recon_advert_max_ids
            for i in range(0, len(wants), cap):
                peer.send(MEMPOOL_CHANNEL, encode_mempool(
                    TxWantMessage(salt=msg.salt,
                                  ids=wants[i:i + cap])))

    def _receive_want(self, msg: TxWantMessage, peer: Peer) -> None:
        """Serve a pull: resolve the short ids under the salt WE
        advertised with and push the full txs back, batched."""
        if not self._peer_recon(peer):
            # same gate as _receive_have: an unnegotiated peer must
            # not reach the salt-map machinery at all — its wants
            # would drain the shared new-salt token bucket and starve
            # honest adverts
            return
        if not self._allow_salt_build(msg.salt):
            return
        sm = self._short_map(msg.salt)
        self.mempool.metrics.recon_wants_received.add(len(msg.ids))
        batch: list[bytes] = []
        batch_bytes = 0
        for sid in msg.ids:
            key = sm.m.get(sid)
            tx = self.mempool.get_tx_by_hash(key) \
                if key is not None else None
            if tx is None:
                continue            # committed/evicted since advertised
            batch.append(tx)
            batch_bytes += len(tx)
            if len(batch) >= self._BATCH_TXS or \
                    batch_bytes >= self._BATCH_BYTES:
                peer.send(MEMPOOL_CHANNEL,
                          encode_mempool(TxsMessage(batch)))
                batch, batch_bytes = [], 0
        if batch:
            peer.send(MEMPOOL_CHANNEL,
                      encode_mempool(TxsMessage(batch)))

    # ------------------------------------------------------------------
    # reconciliation: salts and short-id maps

    _SHORT_MAPS_MAX = 4

    def _current_salt(self) -> bytes:
        """Epoch salt shared by nodes near the same height (see
        mempool/messages.py), plus this node's rotation bump."""
        epoch = self.mempool.height // max(
            1, self.config.recon_salt_epoch_blocks)
        tag = (epoch, self._salt_bump)
        if self._salt_cache[0] != tag:
            self._salt_cache = (tag, hashlib.sha256(
                b"cometbft/txrecon/1" +
                epoch.to_bytes(8, "big") +
                self._salt_bump.to_bytes(4, "big")).digest()[:8])
        return self._salt_cache[1]

    def _rotate_salt(self) -> None:
        self._salt_bump += 1
        self.mempool.metrics.recon_salt_rotations.add()

    def _short_map(self, salt: bytes) -> _ShortMap:
        sm = self._short_maps.get(salt)
        if sm is None:
            sm = _ShortMap()
            self._short_maps[salt] = sm
            while len(self._short_maps) > self._SHORT_MAPS_MAX:
                self._short_maps.popitem(last=False)
            # seed from the dedup cache: a fresh map (new salt epoch)
            # built from the live pool alone would not know committed
            # txs, so every advertiser of a just-committed tx would
            # trigger a full-body re-pull that check_tx then rejects
            # — one wasted round trip per advertiser, straight into
            # the gated duplicate ratio.  One batched hash pass over
            # the (bounded) cache, already rate-limited by the
            # new-salt token bucket.
            cached = self.mempool.cache.keys()
            if cached:
                for sid, key in zip(short_ids(salt, cached), cached):
                    sm.m[sid] = key
        else:
            self._short_maps.move_to_end(salt)
        if sm.cursor != self.mempool._seq:
            # O(new) via the append log; full-pool walk only when the
            # cursor predates the bounded log (fresh map, long idle)
            fresh = self.mempool.keys_appended_after(sm.cursor)
            if fresh is None:
                fresh = [e.key
                         for d in self.mempool._lane_txs.values()
                         for e in d.values() if e.seq > sm.cursor]
            if fresh:
                for sid, key in zip(short_ids(salt, fresh), fresh):
                    sm.m[sid] = key
            sm.cursor = self.mempool._seq
        # bound: stale (committed) entries are useful — they answer
        # adverts for txs the dedup cache still knows — until the
        # map dwarfs live pool + cache combined; the rebuild keeps
        # both sources
        bound = max(8192, 2 * (max(1, self.mempool.size()) +
                               len(self.mempool.cache)))
        if len(sm.m) > bound:
            keep = [e.key for d in self.mempool._lane_txs.values()
                    for e in d.values()]
            keep += self.mempool.cache.keys()
            sm.m = dict(zip(short_ids(salt, keep), keep))
        return sm

    # ------------------------------------------------------------------
    # want-timeout sweep: refetch from another advertiser

    def _ensure_sweeper(self) -> None:
        if self._sweep_task is not None and \
                not self._sweep_task.done():
            return
        self._sweep_task = self.supervisor.spawn(
            lambda: self._want_sweep_routine(),
            name="mempool_want_sweep", kind="mempool_want_sweep",
            policy=RestartPolicy(max_restarts=10, window_s=60.0,
                                 backoff_base_s=0.1,
                                 backoff_max_s=2.0))

    async def _want_sweep_routine(self) -> None:
        timeout_s = self.config.recon_want_timeout_ns / 1e9
        try:
            while True:
                await asyncio.sleep(max(0.05, timeout_s / 2))
                self.sweep_wants(
                    asyncio.get_running_loop().time(), timeout_s)
        except asyncio.CancelledError:
            raise

    def sweep_wants(self, now: float, timeout_s: float) -> None:
        """Expire stale pulls: re-ask the next live advertiser, drop
        the entry once every advertiser has been tried (the tx still
        arrives via compact-block fallback or a later advert)."""
        m = self.mempool.metrics
        regroup: dict[str, dict[bytes, list]] = {}
        for w in self._wants.expired(now, timeout_s):
            candidates = [p for p in w.advertisers
                          if p in self._recon_peers]
            if not candidates or w.tries > len(w.advertisers) + 1:
                self._wants.drop(w)
                m.recon_want_expired.add()
                continue
            nxt = None
            for off in range(len(candidates)):
                c = candidates[(w.tries + off) % len(candidates)]
                if c != w.asked or len(candidates) == 1:
                    nxt = c
                    break
            if nxt is None:
                nxt = candidates[0]
            self._wants.reissue(w, nxt, now)
            m.recon_want_refetches.add()
            regroup.setdefault(nxt, {}).setdefault(
                w.salt, []).append(w.sid)
        cap = self.config.recon_advert_max_ids
        for peer_id, by_salt in regroup.items():
            peer = self._recon_peers.get(peer_id)
            if peer is None:
                continue
            for salt, sids in by_salt.items():
                # same message-size bound as the first-pull path: a
                # mass expiry (peer death with thousands in flight)
                # must not land as one table-sized TxWant
                for i in range(0, len(sids), cap):
                    peer.send(MEMPOOL_CHANNEL, encode_mempool(
                        TxWantMessage(salt=salt,
                                      ids=sids[i:i + cap])))

    # ------------------------------------------------------------------
    # gossip routines

    # gossip batching: many small txs per wire message instead of one
    # — at 256 B txs the per-message overhead (proto envelope,
    # MConnection framing, a latency-relay hop, a recv wakeup) was the
    # dominant cost, and the 16-node QA rig's ingestion was gossip-
    # bound once the pipelined engine stopped being commit-bound
    _BATCH_TXS = 64
    _BATCH_BYTES = 32 * 1024

    async def _gossip_routine(self, peer: Peer) -> None:
        if self._peer_recon(peer):
            await self._recon_gossip_routine(peer)
        else:
            await self._flood_gossip_routine(peer)

    def _fresh_entries(self, cursor: int, peer_id: str,
                       handled: set) -> list:
        """Pool entries appended after ``cursor`` that this peer may
        still need.  The per-peer cursor is the backpressure resume
        point: a send-queue stall retries its own unsent remainder
        and scans forward from here — the old ``last_seq = -1`` reset
        re-walked (and re-batched) the entire pool on every stall.
        Steady state reads the mempool's bounded append log (O(new));
        a cursor older than the log falls back to the full scan."""
        keys = self.mempool.keys_appended_after(cursor)
        if keys is None:
            return [e for d in self.mempool._lane_txs.values()
                    for e in list(d.values())
                    if e.seq > cursor and e.key not in handled and
                    peer_id not in e.senders]
        out = []
        seen: set[bytes] = set()
        for k in keys:
            if k in seen or k in handled:
                continue
            seen.add(k)
            e = self.mempool.get_entry(k)
            if e is not None and e.seq > cursor and \
                    peer_id not in e.senders:
                out.append(e)
        return out

    def _push_fast_path(self, key: bytes, peer_id: str) -> bool:
        """Deterministic per-(tx, peer) lottery choosing ~K of the
        recon peers a brand-new local tx is pushed to in full."""
        k = self.config.recon_push_peers
        if k <= 0:
            return False
        n = len(self._recon_peers)
        if n <= k:
            return True
        h = int.from_bytes(hashlib.sha256(
            key + peer_id.encode()).digest()[:2], "big")
        return h < (65536 * k) // n

    async def _recon_gossip_routine(self, peer: Peer) -> None:
        """Advertise short-id summaries of pool entries the peer
        hasn't seen; push brand-new local txs in full to ~K peers
        (the first-hop fast path).  Same cursor/parking/backpressure
        shape as the flood routine."""
        advertised: set[bytes] = set()
        pending: list = []      # unsent remainder of a stalled pass
        cursor = -1             # highest pool seq already scanned
        m = self.mempool.metrics
        try:
            while True:
                if not pending and self.mempool._seq == cursor:
                    await self.mempool.wait_for_change(cursor)
                    continue
                scan_seq = self.mempool._seq
                todo = pending
                pending = []
                if scan_seq != cursor:
                    todo = todo + self._fresh_entries(
                        cursor, peer.id, advertised)
                    cursor = scan_seq
                push: list = []
                push_bytes = 0
                have: list = []

                def flush_push() -> bool:
                    nonlocal push, push_bytes
                    if not push:
                        return True
                    ok = peer.send(MEMPOOL_CHANNEL, encode_mempool(
                        TxsMessage([e.tx for e in push])))
                    if ok:
                        advertised.update(e.key for e in push)
                        m.recon_pushed_txs.add(len(push))
                        push, push_bytes = [], 0
                    return ok

                def flush_have() -> bool:
                    nonlocal have
                    if not have:
                        return True
                    # self-collision check: two distinct pool keys
                    # colliding under the current salt would make the
                    # summary ambiguous — rotate and re-derive
                    # (satellite test: short-hash collision)
                    keys = [e.key for e in have]
                    for _ in range(4):
                        salt = self._current_salt()
                        sids = short_ids(salt, keys)
                        if len(set(sids)) == len(keys):
                            break
                        self._rotate_salt()
                    ok = peer.send(MEMPOOL_CHANNEL, encode_mempool(
                        TxHaveMessage(salt=salt, ids=sids)))
                    if ok:
                        advertised.update(keys)
                        have = []
                    return ok

                fail_idx = -1
                for i, e in enumerate(todo):
                    if e.key in advertised or \
                            peer.id in e.senders or \
                            not self.mempool.contains(e.key):
                        continue    # sent meanwhile / committed
                    if not e.senders and \
                            self._push_fast_path(e.key, peer.id):
                        push.append(e)
                        push_bytes += len(e.tx)
                        if len(push) >= self._BATCH_TXS or \
                                push_bytes >= self._BATCH_BYTES:
                            if not flush_push():
                                fail_idx = i + 1
                                break
                    else:
                        have.append(e)
                        if len(have) >= \
                                self.config.recon_advert_max_ids:
                            if not flush_have():
                                fail_idx = i + 1
                                break
                if fail_idx < 0 and not flush_push():
                    fail_idx = len(todo)
                if fail_idx < 0 and not flush_have():
                    fail_idx = len(todo)
                if fail_idx >= 0:
                    # peer send-queue backpressure: keep the unsent
                    # batches + unvisited tail and retry on a timer —
                    # the cursor already covers this pass, so the
                    # retry never re-walks the pool
                    pending = push + have + todo[fail_idx:]
                    await asyncio.sleep(0.05)
                    continue
                # bound the dedup set by live pool content
                if len(advertised) > 4 * max(1, self.mempool.size()):
                    live = {e.key for d in
                            self.mempool._lane_txs.values()
                            for e in d.values()}
                    advertised &= live
                await self.mempool.wait_for_change(cursor)
        except asyncio.CancelledError:
            raise
        # crashes propagate to the supervisor (bounded restart — the
        # fresh routine's cursor=-1 rescan re-covers anything the
        # lost pending list held — then drop the peer on give-up)

    async def _flood_gossip_routine(self, peer: Peer) -> None:
        """Send txs the peer hasn't seen, batched, advancing a
        sequence cursor so an unchanged pool costs nothing per tick
        (reference: per-peer broadcastTxRoutine over persistent lane
        iterators).  The fallback plane for peers that did not
        negotiate ``txrecon/1``."""
        sent: set[bytes] = set()
        pending: list = []      # unsent remainder of a stalled pass
        cursor = -1             # highest pool seq already scanned
        try:
            while True:
                if not pending and self.mempool._seq == cursor:
                    # fallback-timeout wakeup with no append since the
                    # last scan: don't re-walk a large quiet pool
                    await self.mempool.wait_for_change(cursor)
                    continue
                scan_seq = self.mempool._seq
                todo = pending
                pending = []
                if scan_seq != cursor:
                    todo = todo + self._fresh_entries(
                        cursor, peer.id, sent)
                    cursor = scan_seq
                batch: list = []
                batch_bytes = 0

                def flush_batch() -> bool:
                    nonlocal batch, batch_bytes
                    if not batch:
                        return True
                    ok = peer.send(MEMPOOL_CHANNEL, encode_mempool(
                        TxsMessage([e.tx for e in batch])))
                    if ok:
                        sent.update(e.key for e in batch)
                        batch, batch_bytes = [], 0
                    return ok

                fail_idx = -1
                for i, e in enumerate(todo):
                    if e.key in sent or peer.id in e.senders or \
                            not self.mempool.contains(e.key):
                        continue    # sent meanwhile / committed
                    batch.append(e)
                    batch_bytes += len(e.tx)
                    if len(batch) >= self._BATCH_TXS or \
                            batch_bytes >= self._BATCH_BYTES:
                        if not flush_batch():
                            fail_idx = i + 1
                            break
                if fail_idx < 0 and not flush_batch():
                    fail_idx = len(todo)
                if fail_idx >= 0:
                    # peer send-queue backpressure: keep the unsent
                    # batch + unvisited tail and retry on a timer —
                    # the cursor already covers this pass, so the
                    # retry never re-walks the pool (the old
                    # ``last_seq = -1`` reset rescanned and rebatched
                    # the whole pool per stall)
                    pending = batch + todo[fail_idx:]
                    await asyncio.sleep(0.05)
                    continue
                # bound the dedup set by live pool content
                if len(sent) > 4 * max(1, self.mempool.size()):
                    live = {e.key for d in
                            self.mempool._lane_txs.values()
                            for e in d.values()}
                    sent &= live
                # park until the pool appends (clist-wait analog);
                # the call returns immediately if _seq already moved
                # during the scan above
                await self.mempool.wait_for_change(cursor)
        except asyncio.CancelledError:
            raise
        # crashes propagate to the supervisor (bounded restart — the
        # fresh routine's cursor=-1 rescan re-covers anything the
        # lost pending list held — then drop the peer on give-up)
