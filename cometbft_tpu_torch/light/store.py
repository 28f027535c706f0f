"""Trusted light-block store.

Reference: light/store/db/db.go — a DB-backed store of verified light
blocks, first and last heights, pruning to a size cap; through
cometbft_tpu/light/store.py, with the same keys (``lb/`` + big-endian
int64 height) and the same proto encoding, so either package reads the
other's store.
"""
from __future__ import annotations

import struct
from typing import Optional

from ..db import DB
from ..types.block import LightBlock
from ..wire import decode, encode, pb

_LB = b"lb/"
_END = _LB + b"\xff" * 9
_SIZE_CAP_DEFAULT = 1000


def _key(height: int) -> bytes:
    return _LB + struct.pack(">q", height)


def _light_block(raw: bytes) -> LightBlock:
    return LightBlock.from_proto(decode(pb.LIGHT_BLOCK, raw))


class TrustedStore:
    def __init__(self, db: DB):
        self._db = db

    def save_light_block(self, lb: LightBlock) -> None:
        self._db.set(_key(lb.height),
                     encode(pb.LIGHT_BLOCK, lb.to_proto()))

    def light_block(self, height: int) -> Optional[LightBlock]:
        raw = self._db.get(_key(height))
        return None if raw is None else _light_block(raw)

    def latest(self) -> Optional[LightBlock]:
        for _, raw in self._db.reverse_iterator(_LB, _END):
            return _light_block(raw)
        return None

    def first(self) -> Optional[LightBlock]:
        for _, raw in self._db.iterator(_LB, _END):
            return _light_block(raw)
        return None

    def heights(self) -> list[int]:
        return [struct.unpack(">q", k[len(_LB):])[0]
                for k, _ in self._db.iterator(_LB, _END)]

    def prune(self, size: int = _SIZE_CAP_DEFAULT) -> int:
        hs = self.heights()
        pruned = 0
        while len(hs) - pruned > size:
            self._db.delete(_key(hs[pruned]))
            pruned += 1
        return pruned

    def delete(self, height: int) -> None:
        self._db.delete(_key(height))
