"""PEX: peer exchange + address book.

Reference: p2p/pex/ — pex_reactor.go (:756, PexChannel 0x00, address
requests/responses, seed crawl mode) and addrbook.go (:921, bucketed
address book with persistence).  The book here keeps the same contract
(routable addresses, last-seen tracking, JSON persistence, random
selection) with a flat table in place of the old/new bucket machinery.

The port's copy of cometbft_tpu/p2p/pex.py: the same keyed bucket
indices, the same selection (shuffled with the ``random`` module), the
same JSON file and the same wire messages.  ``PexReactor`` reads its
seed mode and outbound peer limit from ``config.P2PConfig``.
"""
from __future__ import annotations

import asyncio
import json
import os
import random
import time
from dataclasses import dataclass, field
from typing import Optional

from ..config import P2PConfig
from ..libs.log import Logger
from ..wire.proto import F, Msg, decode, encode
from .conn import ChannelDescriptor
from .switch import Peer, Reactor

PEX_CHANNEL = 0x00
_REQUEST_INTERVAL_S = 30.0
_MAX_ADDRS_PER_MSG = 100

PEX_ADDR = Msg("cometbft.p2p.v1.PexAddress",
               F(1, "id", "string"), F(2, "ip", "string"),
               F(3, "port", "uint32"))
PEX_REQUEST = Msg("cometbft.p2p.v1.PexRequest")
PEX_ADDRS = Msg("cometbft.p2p.v1.PexAddrs",
                F(1, "addrs", "msg", msg=PEX_ADDR, repeated=True))
PEX_MESSAGE = Msg("cometbft.p2p.v1.Message",
                  F(1, "pex_request", "msg", msg=PEX_REQUEST),
                  F(2, "pex_addrs", "msg", msg=PEX_ADDRS))


@dataclass
class KnownAddress:
    node_id: str
    ip: str
    port: int
    # monotonic: last_seen feeds interval arithmetic (freshness
    # ordering, eviction), which a wall-clock step would corrupt; the
    # JSON book converts to/from wall time at the save/load boundary
    last_seen: float = field(default_factory=time.monotonic)
    attempts: int = 0
    is_old: bool = False        # promoted after a successful connection
    bucket: int = 0

    @property
    def dial_addr(self) -> str:
        return f"{self.ip}:{self.port}"


# bucket geometry (reference: p2p/pex/params.go — 256 new buckets, 64
# old buckets, 64 addresses each)
_NEW_BUCKETS = 256
_OLD_BUCKETS = 64
_BUCKET_CAP = 64
_MAX_ATTEMPTS_NEW = 16      # failed-dial cap before a NEW address is dropped


class AddrBook:
    """Bucketed address book (reference: p2p/pex/addrbook.go:921).

    Addresses start in one of 256 NEW buckets (indexed by a keyed hash of
    the node id, so an attacker cannot target a victim's buckets without
    the local key); a successful connection promotes to one of 64 OLD
    buckets.  Full buckets evict: NEW buckets drop their worst entry
    (most failed attempts, then oldest), OLD buckets demote their oldest
    entry back to NEW.  Repeated dial failures remove NEW addresses."""

    def __init__(self, path: str = "", strict: bool = True,
                 key: str = ""):
        import secrets as _secrets
        self.path = path
        self.strict = strict
        self.key = key or _secrets.token_hex(12)
        self._addrs: dict[str, KnownAddress] = {}
        if path and os.path.exists(path):
            self._load()

    # -- bucket mechanics --------------------------------------------------
    def _bucket_index(self, node_id: str, old: bool) -> int:
        import hashlib as _hashlib
        h = _hashlib.sha256(
            (self.key + ("o" if old else "n") + node_id).encode()
        ).digest()
        n = _OLD_BUCKETS if old else _NEW_BUCKETS
        return int.from_bytes(h[:4], "big") % n

    def _bucket_members(self, old: bool, idx: int) -> list[KnownAddress]:
        return [a for a in self._addrs.values()
                if a.is_old == old and a.bucket == idx]

    def _worst_of(self, members: list[KnownAddress]) -> KnownAddress:
        return max(members, key=lambda a: (a.attempts, -a.last_seen))

    # -- public surface ----------------------------------------------------
    def add_address(self, node_id: str, ip: str, port: int) -> bool:
        if not node_id or port <= 0:
            return False
        if self.strict and not _routable(ip):
            return False
        ka = self._addrs.get(node_id)
        if ka is not None:
            ka.ip, ka.port = ip, port
            ka.last_seen = time.monotonic()
            return False
        idx = self._bucket_index(node_id, old=False)
        members = self._bucket_members(False, idx)
        if len(members) >= _BUCKET_CAP:
            # evict the worst NEW entry of this bucket (reference:
            # addrbook.go addToNewBucket -> expireNew)
            self._addrs.pop(self._worst_of(members).node_id, None)
        self._addrs[node_id] = KnownAddress(node_id, ip, port,
                                            bucket=idx)
        return True

    def mark_good(self, node_id: str) -> None:
        """Successful connection: promote NEW -> OLD (reference:
        MarkGood -> moveToOld)."""
        ka = self._addrs.get(node_id)
        if ka is None:
            return
        ka.attempts = 0
        ka.last_seen = time.monotonic()
        if ka.is_old:
            return
        idx = self._bucket_index(node_id, old=True)
        members = self._bucket_members(True, idx)
        if len(members) >= _BUCKET_CAP:
            # demote the oldest OLD entry back to a NEW bucket
            demoted = min(members, key=lambda a: a.last_seen)
            demoted.is_old = False
            demoted.bucket = self._bucket_index(demoted.node_id,
                                                old=False)
        ka.is_old = True
        ka.bucket = idx

    def mark_attempt(self, node_id: str) -> None:
        ka = self._addrs.get(node_id)
        if ka is None:
            return
        ka.attempts += 1
        if not ka.is_old and ka.attempts > _MAX_ATTEMPTS_NEW:
            # unreachable NEW addresses age out (reference: removeBad)
            self._addrs.pop(node_id, None)

    def remove(self, node_id: str) -> None:
        self._addrs.pop(node_id, None)

    def pick_addresses(self, n: int,
                       exclude: Optional[set] = None,
                       old_bias_pct: int = 30) -> list[KnownAddress]:
        """Random selection biased between OLD (proven) and NEW
        addresses (reference: addrbook.go GetSelectionWithBias)."""
        pool_old = [a for a in self._addrs.values()
                    if a.is_old and (not exclude or
                                     a.node_id not in exclude)]
        pool_new = [a for a in self._addrs.values()
                    if not a.is_old and (not exclude or
                                         a.node_id not in exclude)]
        random.shuffle(pool_old)
        random.shuffle(pool_new)
        n_old = min(len(pool_old), max(0, n * old_bias_pct // 100))
        out = pool_old[:n_old] + pool_new[:n - n_old]
        if len(out) < n:        # top up from whichever side has more
            leftovers = pool_old[n_old:] + pool_new[n - n_old:]
            out.extend(leftovers[:n - len(out)])
        random.shuffle(out)
        return out[:n]

    def size(self) -> int:
        return len(self._addrs)

    def save(self) -> None:
        if not self.path:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        # persist wall time (meaningful across reboots); in-memory
        # last_seen is monotonic, so convert via the current offset
        now_m, now_w = time.monotonic(), time.time()
        with open(self.path, "w") as f:
            json.dump({"key": self.key, "addrs": [
                {"id": a.node_id, "ip": a.ip, "port": a.port,
                 "last_seen": now_w - max(0.0, now_m - a.last_seen),
                 "attempts": a.attempts,
                 "is_old": a.is_old, "bucket": a.bucket}
                for a in self._addrs.values()]}, f, indent=2)

    def _load(self) -> None:
        try:
            with open(self.path) as f:
                raw = json.load(f)
            if isinstance(raw, dict):
                self.key = raw.get("key", self.key)
                entries = raw.get("addrs", [])
            else:                      # legacy flat format
                entries = raw
            now_m, now_w = time.monotonic(), time.time()
            for d in entries:
                # wall -> monotonic: age the entry by its wall-clock
                # staleness (clamped — a future wall stamp is "now")
                age = max(0.0, now_w - d.get("last_seen", 0.0))
                self._addrs[d["id"]] = KnownAddress(
                    d["id"], d["ip"], int(d["port"]),
                    now_m - age,
                    attempts=d.get("attempts", 0),
                    is_old=d.get("is_old", False),
                    bucket=d.get("bucket", 0))
        except (json.JSONDecodeError, KeyError, OSError):
            pass


def _routable(ip: str) -> bool:
    # local addresses are fine for testnets when strict=False; strict
    # mode refuses the obvious non-routables except RFC1918 (validators
    # commonly peer over private networks)
    return not ip.startswith(("0.", "255."))


class PexReactor(Reactor):
    def __init__(self, book: AddrBook, config: Optional[P2PConfig] = None,
                 logger: Optional[Logger] = None):
        super().__init__("PEX")
        if logger is not None:
            self.logger = logger
        cfg = config if config is not None else P2PConfig()
        self.book = book
        self.seed_mode = cfg.seed_mode
        self.max_outbound = cfg.max_num_outbound_peers
        self._task = None   # SupervisedTask

    def get_channels(self) -> list[ChannelDescriptor]:
        return [ChannelDescriptor(id=PEX_CHANNEL, priority=1,
                                  send_queue_capacity=10)]

    async def start(self) -> None:
        self._task = self.supervisor.spawn(
            lambda: self._ensure_peers_routine(),
            name="pex_ensure_peers", kind="pex_ensure_peers")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
        self.book.save()

    # ------------------------------------------------------------------
    async def add_peer(self, peer: Peer) -> None:
        # record the peer's self-reported listen address
        la = peer.node_info.listen_addr
        if la and ":" in la:
            ip, port = la.rsplit(":", 1)
            self.book.add_address(peer.id, ip, int(port))
            self.book.mark_good(peer.id)
        # ask it for more peers
        peer.send(PEX_CHANNEL,
                  encode(PEX_MESSAGE, {"pex_request": {}}))

    async def receive(self, chan_id: int, peer: Peer,
                      msg_bytes: bytes) -> None:
        d = decode(PEX_MESSAGE, msg_bytes)
        if "pex_request" in d:
            private = (self.switch.private_ids
                       if self.switch is not None else set())
            addrs = self.book.pick_addresses(
                _MAX_ADDRS_PER_MSG, exclude={peer.id} | private)
            peer.send(PEX_CHANNEL, encode(PEX_MESSAGE, {"pex_addrs": {
                "addrs": [{"id": a.node_id, "ip": a.ip,
                           "port": a.port} for a in addrs]}}))
            # seed nodes hang up after serving addresses
            if self.seed_mode and self.switch is not None:
                await self.switch.stop_peer(peer, "seed served addrs")
        elif "pex_addrs" in d:
            for a in d["pex_addrs"].get("addrs", []):
                self.book.add_address(a.get("id", ""),
                                      a.get("ip", ""),
                                      a.get("port", 0))

    # ------------------------------------------------------------------
    async def _ensure_peers_routine(self) -> None:
        """Dial book addresses while below the outbound target
        (reference: ensurePeersRoutine)."""
        try:
            while True:
                await asyncio.sleep(1.0)
                sw = self.switch
                if sw is None:
                    continue
                out = sum(1 for p in sw.peers.values() if p.outbound)
                if out >= self.max_outbound:
                    continue
                connected = set(sw.peers)
                connected.add(sw.node_key.id)
                for ka in self.book.pick_addresses(
                        self.max_outbound - out, exclude=connected):
                    self.book.mark_attempt(ka.node_id)
                    try:
                        await sw.dial_peer(ka.dial_addr)
                        self.book.mark_good(ka.node_id)
                    except Exception as e:
                        self.logger.debug(
                            "pex dial failed", addr=ka.dial_addr,
                            attempts=ka.attempts, err=str(e))
                        if ka.attempts > 10:
                            self.book.remove(ka.node_id)
        except asyncio.CancelledError:
            raise
