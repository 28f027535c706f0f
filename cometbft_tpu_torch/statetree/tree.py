"""Versioned sorted-kv merkle commitment over the db/ layer.

The port's copy of cometbft_tpu/statetree/tree.py.  Leaves hash with
``merkle.leaf_hash`` (hashlib) only, so the roots are byte-equal to the
reference package's on any machine.  ``prove`` builds the proof
envelopes of statetree/proof.py; the views of past versions it proves
against are memoised (``memo_versions``, LRU), as in the reference.

Design: a sorted-kv commitment with versioned nodes.  The committed state
at version V is the set of live (key, value) pairs; its root is the
RFC-6962 merkle root (crypto/merkle.py hashing) over the
``value_op_leaf(key, value)`` bindings of the pairs in sorted-key
order.  Sorted order is what makes absence provable: a key K is absent
iff two ADJACENT leaves straddle it.

Storage layout (inside the caller's DB, typically a PrefixDB
namespace of the app db):

  n/ <uvarint key-len> <key> <be64 version>  ->  0x01 <value>   (set)
                                             ->  0x00           (tombstone)
  v/ <be64 version>  ->  JSON {"root", "total", "app_hash"?}
  m/latest           ->  be64 version
  m/base             ->  be64 oldest retained version

Per-key records are append-only per version (IAVL-style versioned
nodes without the tree shape — the shape is recomputed from sorted
order, which the merkle root pins).  A point read at version V is a
reverse scan for the newest record <= V; a full materialization at V
is one ordered scan keeping the newest record <= V per key.  Commits
write one atomic batch, so a crash between ABCI Commit and the state
store's own write recovers the exact pre- or post-commit root and
handshake replay (consensus/replay.py) reconverges.

Versions are app heights: version H is the state after finalizing
block H, and its root lands in block H+1's header.app_hash.
"""
from __future__ import annotations

import bisect
import json
import struct
import threading
from collections import OrderedDict
from typing import Iterable, Optional

from ..crypto import merkle
from ..db.db import DB, _prefix_end
from ..wire.proto import decode_uvarint, encode_uvarint

_NODE = b"n/"
_VERSION = b"v/"
_META_LATEST = b"m/latest"
_META_BASE = b"m/base"
_SET = b"\x01"
_TOMBSTONE = b"\x00"


def _be64(v: int) -> bytes:
    return struct.pack(">Q", v)


def _node_prefix(key: bytes) -> bytes:
    return _NODE + encode_uvarint(len(key)) + key


def _node_key(key: bytes, version: int) -> bytes:
    return _node_prefix(key) + _be64(version)


def _split_node_key(raw: bytes) -> tuple[bytes, int]:
    """``n/``-relative record key -> (user key, version)."""
    klen, pos = decode_uvarint(raw, 0)
    key = raw[pos:pos + klen]
    (version,) = struct.unpack(">Q", raw[pos + klen:pos + klen + 8])
    return key, version


def _leaf_hashes(items: list[bytes]) -> list[bytes]:
    return [merkle.leaf_hash(it) for it in items]


class StateTree:
    """Versioned merkle-committed KV store.

    Writes stage into a working set; ``working_root(v)`` computes the
    root the next ``commit(v)`` will produce (FinalizeBlock returns
    the app_hash before Commit persists, so the two are split);
    ``commit(v)`` persists one atomic batch and promotes the working
    view.  Reads (``get``/``pairs``/``prove``) always serve committed
    versions, never the working set.
    """

    def __init__(self, db: DB, memo_versions: int = 4):
        self._db = db
        self._lock = threading.RLock()
        self._memo_versions = max(1, memo_versions)
        # committed latest view
        self._map: dict[bytes, bytes] = {}
        self._sorted: list[bytes] = []
        self._leafh: dict[bytes, bytes] = {}
        # staged writes: key -> value | None (delete)
        self._working: dict[bytes, Optional[bytes]] = {}
        # working_root result awaiting commit:
        # (version, sorted_keys, map, leafh, root)
        self._pending = None
        # version -> (keys, values, leaf_hashes, index_of), LRU
        self._memo: OrderedDict[int, tuple] = OrderedDict()
        self.latest_version: Optional[int] = None
        self.base_version: int = 0
        self._roots: dict[int, bytes] = {}
        self._load()

    # -- open / recover -----------------------------------------------------

    def _load(self) -> None:
        raw = self._db.get(_META_LATEST)
        if raw is None:
            return
        (self.latest_version,) = struct.unpack(">Q", raw)
        base = self._db.get(_META_BASE)
        if base is not None:
            (self.base_version,) = struct.unpack(">Q", base)
        self._map = self._materialize(self.latest_version)
        self._sorted = sorted(self._map)
        leaves = [merkle.value_op_leaf(k, self._map[k])
                  for k in self._sorted]
        self._leafh = dict(zip(self._sorted, _leaf_hashes(leaves)))

    def _materialize(self, version: int) -> dict[bytes, bytes]:
        """Newest record <= version per key, tombstones dropped.  One
        ordered scan: records for one key are contiguous and
        version-ascending, so the last matching record wins."""
        out: dict[bytes, bytes] = {}
        for raw, rec in self._db.iterator(_NODE, _VERSION):
            key, ver = _split_node_key(raw[len(_NODE):])
            if ver > version:
                continue
            if rec[:1] == _TOMBSTONE:
                out.pop(key, None)
            else:
                out[key] = rec[1:]
        return out

    # -- reads (committed state only) ----------------------------------------

    def get(self, key: bytes, version: Optional[int] = None
            ) -> Optional[bytes]:
        with self._lock:
            if version is None or version == self.latest_version:
                return self._map.get(key)
            if self.latest_version is None or \
                    version > self.latest_version or \
                    version < self.base_version:
                return None
            prefix = _node_prefix(key)
            for _, rec in self._db.reverse_iterator(
                    prefix + _be64(0), prefix + _be64(version + 1)):
                return None if rec[:1] == _TOMBSTONE else rec[1:]
            return None

    def has(self, key: bytes, version: Optional[int] = None) -> bool:
        return self.get(key, version) is not None

    def pairs(self, version: Optional[int] = None
              ) -> list[tuple[bytes, bytes]]:
        """Sorted live (key, value) pairs at ``version`` (default
        latest)."""
        with self._lock:
            keys, values, _, _ = self._view(version)
            return list(zip(keys, values))

    def total(self, version: Optional[int] = None) -> int:
        with self._lock:
            if version is None or version == self.latest_version:
                return len(self._map)
            return len(self._view(version)[0])

    def root(self, version: Optional[int] = None) -> bytes:
        """Committed root at ``version`` (default latest); the empty
        tree root for a tree that never committed."""
        with self._lock:
            if self.latest_version is None:
                return merkle.empty_hash()
            v = self.latest_version if version is None else version
            r = self._roots.get(v)
            if r is not None:
                return r
            meta = self._version_meta(v)
            r = bytes.fromhex(meta["root"])
            self._roots[v] = r
            return r

    def reported_hash(self, version: Optional[int] = None) -> bytes:
        """The app_hash to report for ``version``: the migration
        override when one was recorded (pre-tree chains import under
        their legacy hash so handshake replay still matches), else
        the tree root."""
        with self._lock:
            if self.latest_version is None:
                return merkle.empty_hash()
            v = self.latest_version if version is None else version
            meta = self._version_meta(v)
            if "app_hash" in meta:
                return bytes.fromhex(meta["app_hash"])
            return bytes.fromhex(meta["root"])

    def version_extra(self, version: Optional[int] = None) -> dict:
        """App metadata stored with ``commit(..., extra=...)``."""
        with self._lock:
            if self.latest_version is None:
                return {}
            v = self.latest_version if version is None else version
            return self._version_meta(v).get("extra", {})

    def versions(self) -> list[int]:
        with self._lock:
            return [struct.unpack(">Q", raw[len(_VERSION):])[0]
                    for raw, _ in self._db.iterator(
                        _VERSION, _prefix_end(_VERSION))]

    def _version_meta(self, version: int) -> dict:
        raw = self._db.get(_VERSION + _be64(version))
        if raw is None:
            raise KeyError(f"state tree has no version {version}")
        return json.loads(raw)

    # -- writes ---------------------------------------------------------------

    def set(self, key: bytes, value: bytes) -> None:
        if not key:
            raise ValueError("state tree key cannot be empty")
        with self._lock:
            self._working[bytes(key)] = bytes(value)
            self._pending = None

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._working[bytes(key)] = None
            self._pending = None

    def reset_working(self) -> None:
        """Drop staged writes (a FinalizeBlock whose Commit never
        came — crash replay re-executes the block from scratch)."""
        with self._lock:
            self._working.clear()
            self._pending = None

    def working_root(self, version: int) -> bytes:
        """Root the next ``commit(version)`` will produce.  Computed
        incrementally from the latest committed view + the working
        set; cached so commit() reuses it."""
        with self._lock:
            if self._pending is not None and \
                    self._pending[0] == version:
                return self._pending[4]
            new_map = dict(self._map)
            new_leafh = dict(self._leafh)
            new_sorted = list(self._sorted)
            changed: list[bytes] = []
            for k, v in self._working.items():
                if v is None:
                    if k in new_map:
                        del new_map[k]
                        del new_leafh[k]
                        i = bisect.bisect_left(new_sorted, k)
                        new_sorted.pop(i)
                elif new_map.get(k) != v:
                    if k not in new_map:
                        bisect.insort(new_sorted, k)
                    new_map[k] = v
                    changed.append(k)
            if changed:
                hashes = _leaf_hashes(
                    [merkle.value_op_leaf(k, new_map[k])
                     for k in changed])
                new_leafh.update(zip(changed, hashes))
            root = merkle.root_from_leaf_hashes(
                [new_leafh[k] for k in new_sorted])
            self._pending = (version, new_sorted, new_map,
                             new_leafh, root)
            return root

    def commit(self, version: int,
               app_hash_override: Optional[bytes] = None,
               extra: Optional[dict] = None) -> bytes:
        """Persist the working set as ``version`` in one atomic batch
        and promote it to the committed view.  Re-committing the
        current latest version with an identical root is a no-op
        (InitChain replay after a crash before height 1); anything
        else non-monotonic is an error.  ``extra`` is app metadata
        stored in the version record — riding the same batch as the
        nodes, so app state and metadata can never diverge across a
        crash."""
        with self._lock:
            root = self.working_root(version)
            if self.latest_version is not None:
                if version == self.latest_version:
                    if root == self.root(version):
                        self._working.clear()
                        self._pending = None
                        return root
                    raise ValueError(
                        f"conflicting re-commit of version {version}")
                if version <= self.latest_version:
                    raise ValueError(
                        f"commit version {version} <= latest "
                        f"{self.latest_version}")
            _, new_sorted, new_map, new_leafh, _ = self._pending
            batch = self._db.new_batch()
            for k, v in self._working.items():
                if v is None:
                    if k in self._map:
                        batch.set(_node_key(k, version), _TOMBSTONE)
                elif self._map.get(k) != v:
                    batch.set(_node_key(k, version), _SET + v)
            meta = {"root": root.hex(), "total": len(new_sorted)}
            if app_hash_override is not None:
                meta["app_hash"] = app_hash_override.hex()
            if extra:
                meta["extra"] = dict(extra)
            batch.set(_VERSION + _be64(version),
                      json.dumps(meta).encode())
            batch.set(_META_LATEST, _be64(version))
            if self.latest_version is None:
                batch.set(_META_BASE, _be64(version))
                self.base_version = version
            batch.write()
            self._map, self._sorted, self._leafh = \
                new_map, new_sorted, new_leafh
            self.latest_version = version
            self._roots[version] = root
            self._working.clear()
            self._pending = None
            return root

    # -- pruning / snapshots ---------------------------------------------------

    def prune(self, retain_from: int,
              pinned: Iterable[int] = ()) -> int:
        """Drop versions < ``retain_from`` except ``pinned`` ones (heights
        the lightserve cache can still serve: pruning one would break a
        cached height's proof).  Node records are compacted so every
        retained version still materializes the exact same pairs.
        Returns the number of versions dropped.

        The rows it leaves are the reference's: a record is kept iff it
        is the newest <= some kept version, rewritten AT the pruning
        floor when its own version was dropped below it, and deleted
        otherwise.  A record at a kept version is always the newest <=
        that version, so only records at other versions are examined,
        each against the next record of its key, in one ordered pass
        (the reference groups every record by key and searches each
        key's versions once per kept version)."""
        with self._lock:
            if self.latest_version is None:
                return 0
            retain_from = min(retain_from, self.latest_version)
            pinned = {p for p in pinned if p >= self.base_version}
            versions = self.versions()
            keep = sorted({v for v in versions if v >= retain_from} |
                          pinned)
            kept_set = set(keep)
            drop = [v for v in versions if v not in kept_set]
            if not drop:
                return 0
            floor = keep[0]
            batch = self._db.new_batch()

            def settle(raw: bytes, rec: bytes, ver: int,
                       next_ver: Optional[int]) -> None:
                # needed iff a kept version falls in [ver, next_ver)
                j = bisect.bisect_left(keep, ver)
                if j < len(keep) and (next_ver is None or
                                      keep[j] < next_ver):
                    if ver < floor:
                        # re-anchor at the pruning floor so the record
                        # stays visible to every retained version
                        # >= floor that needs it
                        batch.delete(raw)
                        if rec[:1] != _TOMBSTONE:
                            batch.set(raw[:-8] + _be64(floor), rec)
                else:
                    batch.delete(raw)

            # records of one key are contiguous and version-ascending,
            # and a record key ends in its be64 version
            pending = None
            for raw, rec in self._db.iterator(_NODE, _VERSION):
                (ver,) = struct.unpack(">Q", raw[-8:])
                if pending is not None:
                    settle(*pending, ver if raw[:-8] == pending[0][:-8]
                           else None)
                    pending = None
                if ver not in kept_set:
                    pending = (raw, rec, ver)
            if pending is not None:
                settle(*pending, None)
            for v in drop:
                batch.delete(_VERSION + _be64(v))
                self._roots.pop(v, None)
                self._memo.pop(v, None)
            batch.set(_META_BASE, _be64(floor))
            batch.write()
            self.base_version = floor
            return len(drop)

    def import_snapshot(self, version: int,
                        pairs: Iterable[tuple[bytes, bytes]],
                        app_hash_override: Optional[bytes] = None,
                        extra: Optional[dict] = None) -> bytes:
        """Replace all tree content with ``pairs`` committed at
        ``version`` (state-sync restore, and the kvstore's import of a
        pre-tree store under its legacy hash).  The resulting root is
        byte-identical to the snapshot producer's: same pairs, same
        sorted order, same leaf binding."""
        with self._lock:
            batch = self._db.new_batch()
            for raw, _ in self._db.iterator(None, None):
                batch.delete(raw)
            batch.write()
            self._map = {}
            self._sorted = []
            self._leafh = {}
            self._working = {}
            self._pending = None
            self._memo.clear()
            self._roots.clear()
            self.latest_version = None
            self.base_version = version
            for k, v in pairs:
                self.set(k, v)
            return self.commit(version, app_hash_override=app_hash_override,
                               extra=extra)

    # -- proofs ---------------------------------------------------------------

    def _view(self, version: Optional[int]) -> tuple:
        """(keys, values, leaf_hashes, index_of) at ``version``: latest
        from the live view, history from a memoised scan."""
        if self.latest_version is None:
            return [], [], [], {}
        v = self.latest_version if version is None else version
        if v == self.latest_version:
            keys = self._sorted
            return keys, [self._map[k] for k in keys], \
                [self._leafh[k] for k in keys], \
                {k: i for i, k in enumerate(keys)}
        if v in self._memo:
            self._memo.move_to_end(v)
            return self._memo[v]
        if v > self.latest_version or v < self.base_version or \
                self._db.get(_VERSION + _be64(v)) is None:
            raise KeyError(f"state tree has no version {v}")
        m = self._materialize(v)
        keys = sorted(m)
        view = (keys, [m[k] for k in keys],
                _leaf_hashes([merkle.value_op_leaf(k, m[k]) for k in keys]),
                {k: i for i, k in enumerate(keys)})
        self._memo[v] = view
        while len(self._memo) > self._memo_versions:
            self._memo.popitem(last=False)
        return view

    def prove(self, request_keys: Iterable[bytes],
              version: Optional[int] = None) -> dict:
        """Proof envelope (proof.py) for ``request_keys``: existence for
        present keys, non-inclusion for absent ones, at ``version``
        (default latest)."""
        from .proof import build_proof_envelope
        with self._lock:
            keys, values, hashes, index_of = self._view(version)
            v = self.latest_version if version is None else version
            return build_proof_envelope(
                list(request_keys), keys, values, hashes, index_of,
                0 if v is None else v)
