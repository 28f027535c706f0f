"""BlockStore: blocks by parts, metas, commits, seen and extended
commits, the block-hash index, pruning and rollback.

Reference: store/store.go:46 (BlockStore struct + methods) and
store/db_key_layout.go, through cometbft_tpu/store/store.py, whose rows
this copy writes byte for byte.  Key layout is the v2-style ordered
layout: a prefix byte followed by fixed-width big-endian integers, so
height ranges scan in order on any ordered-KV backend.
"""
from __future__ import annotations

import struct
import threading
from typing import Optional

from ..db import DB, Batch
from ..types.block import Block, BlockMeta
from ..types.block_id import BlockID
from ..types.commit import AggregateCommit, Commit, ExtendedCommit
from ..types.part_set import Part, PartSet
from ..wire import pb, encode, decode

_META = b"\x00"        # height -> BlockMeta
_PART = b"\x01"        # height,part -> Part
_COMMIT = b"\x02"      # height -> Commit (the +2/3 canonical commit)
_SEEN_COMMIT = b"\x03"  # height -> locally seen commit
_EXT_COMMIT = b"\x04"  # height -> ExtendedCommit
_HASH = b"\x05"        # block hash -> height
_STATE = b"\x06"       # base/height bookkeeping


def _h(height: int) -> bytes:
    return struct.pack(">q", height)


# Commit rows hold either kind: per-signature Commit proto bytes, or
# an AggregateCommit proto behind a marker prefix (0xff is an invalid
# proto tag byte — field 31 / wire type 7 — so the two encodings can
# never collide).  Local storage only; the wire forms live in
# pb.BLOCK / pb.SIGNED_HEADER optional fields.
_AGG_COMMIT_PREFIX = b"\xff\x01"


def _encode_commit_row(commit) -> bytes:
    if isinstance(commit, AggregateCommit):
        return _AGG_COMMIT_PREFIX + encode(pb.AGGREGATE_COMMIT,
                                           commit.to_proto())
    return encode(pb.COMMIT, commit.to_proto())


def _decode_commit_row(raw: bytes):
    if raw.startswith(_AGG_COMMIT_PREFIX):
        return AggregateCommit.from_proto(
            decode(pb.AGGREGATE_COMMIT,
                   raw[len(_AGG_COMMIT_PREFIX):]))
    return Commit.from_proto(decode(pb.COMMIT, raw))


def _meta_key(height: int) -> bytes:
    return _META + _h(height)


def _part_key(height: int, index: int) -> bytes:
    return _PART + _h(height) + struct.pack(">I", index)


def _commit_key(height: int) -> bytes:
    return _COMMIT + _h(height)


def _seen_commit_key(height: int) -> bytes:
    return _SEEN_COMMIT + _h(height)


def _ext_commit_key(height: int) -> bytes:
    return _EXT_COMMIT + _h(height)


def _hash_key(h: bytes) -> bytes:
    return _HASH + h


class BlockStoreError(Exception):
    pass


class BlockStore:
    """Stores the block parts, metas and commits for each height in
    [base, height]."""

    def __init__(self, db: DB):
        self._db = db
        self._lock = threading.RLock()
        raw = db.get(_STATE)
        if raw:
            self._base, self._height = struct.unpack(">qq", raw)
        else:
            self._base, self._height = 0, 0

    @property
    def base(self) -> int:
        with self._lock:
            return self._base

    @property
    def height(self) -> int:
        with self._lock:
            return self._height

    def size(self) -> int:
        with self._lock:
            return self._height - self._base + 1 if self._height else 0

    def _save_store_state(self, batch: Optional[Batch] = None) -> None:
        raw = struct.pack(">qq", self._base, self._height)
        if batch is not None:
            batch.set(_STATE, raw)
        else:
            self._db.set(_STATE, raw)

    # ------------------------------------------------------------------
    def save_block(self, block: Block, parts: PartSet,
                   seen_commit: Commit) -> None:
        """Persist block parts, meta, commits (reference: SaveBlock)."""
        self._save_block(block, parts, seen_commit, ext_commit=None)

    def save_block_with_extended_commit(
            self, block: Block, parts: PartSet,
            seen_ext_commit: ExtendedCommit) -> None:
        """Reference: SaveBlockWithExtendedCommit (store.go:625) — keeps
        extensions for height-H PrepareProposal; refuses to persist a
        commit with missing extension signatures (poison prevention)."""
        seen_ext_commit.ensure_extensions(True)
        self._save_block(block, parts, seen_ext_commit.to_commit(),
                         ext_commit=seen_ext_commit)

    def _save_block(self, block: Block, parts: PartSet,
                    seen_commit: Commit,
                    ext_commit: Optional[ExtendedCommit]) -> None:
        if block is None:
            raise BlockStoreError("cannot save nil block")
        height = block.header.height
        with self._lock:
            expected = self._height + 1 if self._height else height
            if height != expected:
                raise BlockStoreError(
                    f"cannot save block at height {height}, "
                    f"expected {expected}")
            if not parts.is_complete():
                raise BlockStoreError(
                    "cannot save block with incomplete part set")
            batch = self._db.new_batch()
            block_meta = BlockMeta(
                block_id=BlockID(hash=block.hash(),
                                 part_set_header=parts.header()),
                block_size=parts.byte_size,
                header=block.header,
                num_txs=len(block.data.txs),
            )
            batch.set(_meta_key(height),
                      encode(pb.BLOCK_META, block_meta.to_proto()))
            for i in range(parts.total):
                part = parts.get_part(i)
                batch.set(_part_key(height, i),
                          encode(pb.PART, part.to_proto()))
            if block.last_commit is not None:
                batch.set(_commit_key(height - 1),
                          _encode_commit_row(block.last_commit))
            batch.set(_seen_commit_key(height),
                      _encode_commit_row(seen_commit))
            if ext_commit is not None:
                batch.set(_ext_commit_key(height),
                          encode(pb.EXTENDED_COMMIT,
                                 ext_commit.to_proto()))
            batch.set(_hash_key(block.hash()), _h(height))
            if self._base == 0:
                self._base = height
            self._height = height
            self._save_store_state(batch)
            batch.write_sync()

    def save_seen_commit_standalone(self, commit: Commit) -> None:
        """Persist only a seen commit, without a block — the state-sync
        bootstrap artifact block sync needs to start verifying from the
        snapshot height (reference: store.go SaveSeenCommit, used by the
        statesync reactor's Bootstrap)."""
        with self._lock:
            batch = self._db.new_batch()
            batch.set(_seen_commit_key(commit.height),
                      _encode_commit_row(commit))
            # advance height so block sync resumes AFTER the snapshot;
            # base points at the FIRST block we will actually store
            # (H+1) — advertising base=H would promise a block we can
            # never serve
            if self._height < commit.height:
                self._height = commit.height
            if self._base <= commit.height:
                self._base = commit.height + 1
            self._save_store_state(batch)
            batch.write_sync()

    # ------------------------------------------------------------------
    def load_block_meta(self, height: int) -> Optional[BlockMeta]:
        raw = self._db.get(_meta_key(height))
        if raw is None:
            return None
        return BlockMeta.from_proto(decode(pb.BLOCK_META, raw))

    def load_block_meta_by_hash(self, block_hash: bytes
                                ) -> Optional[BlockMeta]:
        raw = self._db.get(_hash_key(block_hash))
        if raw is None:
            return None
        return self.load_block_meta(struct.unpack(">q", raw)[0])

    def load_block(self, height: int) -> Optional[Block]:
        meta = self.load_block_meta(height)
        if meta is None:
            return None
        data = bytearray()
        for i in range(meta.block_id.part_set_header.total):
            part = self.load_block_part(height, i)
            if part is None:
                return None
            data += part.bytes_
        return Block.from_proto(decode(pb.BLOCK, bytes(data)))

    def load_block_by_hash(self, block_hash: bytes) -> Optional[Block]:
        raw = self._db.get(_hash_key(block_hash))
        if raw is None:
            return None
        return self.load_block(struct.unpack(">q", raw)[0])

    def load_block_part(self, height: int, index: int) -> Optional[Part]:
        raw = self._db.get(_part_key(height, index))
        if raw is None:
            return None
        return Part.from_proto(decode(pb.PART, raw))

    def load_block_commit(self, height: int
                          ) -> Commit | AggregateCommit | None:
        raw = self._db.get(_commit_key(height))
        if raw is None:
            return None
        return _decode_commit_row(raw)

    def load_seen_commit(self, height: int
                         ) -> Commit | AggregateCommit | None:
        raw = self._db.get(_seen_commit_key(height))
        if raw is None:
            return None
        return _decode_commit_row(raw)

    def load_block_ext_commit(self, height: int
                              ) -> Optional[ExtendedCommit]:
        raw = self._db.get(_ext_commit_key(height))
        if raw is None:
            return None
        return ExtendedCommit.from_proto(
            decode(pb.EXTENDED_COMMIT, raw))

    # ------------------------------------------------------------------
    def prune_blocks(self, retain_height: int) -> tuple[int, int]:
        """Remove blocks below retain_height; returns (pruned,
        new_base_of_evidence) (reference: PruneBlocks)."""
        with self._lock:
            if retain_height <= self._base:
                return 0, self._base
            if retain_height > self._height:
                raise BlockStoreError(
                    "cannot prune beyond the latest height "
                    f"{self._height}")
            pruned = 0
            batch = self._db.new_batch()
            for h in range(self._base, retain_height):
                meta = self.load_block_meta(h)
                if meta is not None:
                    batch.delete(_meta_key(h))
                    batch.delete(_hash_key(meta.block_id.hash))
                    for i in range(meta.block_id.part_set_header.total):
                        batch.delete(_part_key(h, i))
                    pruned += 1
                # _commit_key(h) holds the canonical commit FOR block h
                batch.delete(_commit_key(h))
                batch.delete(_seen_commit_key(h))
                batch.delete(_ext_commit_key(h))
            self._base = retain_height
            self._save_store_state(batch)
            batch.write()
            return pruned, self._base

    def delete_latest_block(self) -> None:
        """Rollback support: remove the highest block (reference:
        DeleteLatestBlock)."""
        with self._lock:
            h = self._height
            if h == 0:
                raise BlockStoreError("no blocks to delete")
            meta = self.load_block_meta(h)
            batch = self._db.new_batch()
            if meta is not None:
                batch.delete(_hash_key(meta.block_id.hash))
                for i in range(meta.block_id.part_set_header.total):
                    batch.delete(_part_key(h, i))
            batch.delete(_meta_key(h))
            # the canonical commit FOR h (stored when h+1 was saved, so
            # normally absent for the head; deleted defensively)
            batch.delete(_commit_key(h))
            batch.delete(_seen_commit_key(h))
            batch.delete(_ext_commit_key(h))
            self._height = h - 1
            if self._base > self._height:
                self._base = self._height
            self._save_store_state(batch)
            batch.write_sync()
