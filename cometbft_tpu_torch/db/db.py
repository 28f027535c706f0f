"""DB interface, MemDB, SQLiteDB and PrefixDB: the ordered key-value
store under the light client's trusted store, the state and block
stores and the kvstore app's state tree.

The port's copy of cometbft_tpu/db/db.py.  Reference: db/db.go (the
interface), db/pebbledb.go (the persistent engine), db/prefixdb.go (the
namespace wrapper).  Iteration is byte-ordered over [start, end) like
the reference's iterators.  The persistent engine is SQLite in WAL mode
from the Python standard library: an ordered key-value store of the same
durability class as PebbleDB, with nothing to build.
"""
from __future__ import annotations

import abc
import bisect
import os
import sqlite3
import threading
from typing import Iterator, Optional


class DBError(Exception):
    pass


class Batch:
    """Write batch applied atomically (reference: db.Batch)."""

    def __init__(self, db: "DB"):
        self._db = db
        self._ops: list[tuple[str, bytes, Optional[bytes]]] = []
        self._written = False

    def set(self, key: bytes, value: bytes) -> None:
        self._check(key, value)
        self._ops.append(("set", bytes(key), bytes(value)))

    def delete(self, key: bytes) -> None:
        self._check(key, b"x")
        self._ops.append(("del", bytes(key), None))

    @staticmethod
    def _check(key: bytes, value: bytes) -> None:
        if key is None or len(key) == 0:
            raise DBError("key cannot be empty")
        if value is None:
            raise DBError("value cannot be nil")

    def write(self) -> None:
        if self._written:
            raise DBError("batch already written")
        self._db._apply_batch(self._ops)
        self._written = True

    def write_sync(self) -> None:
        """Write, then make the write durable (SQLite: a full WAL
        checkpoint)."""
        if self._written:
            raise DBError("batch already written")
        self._db._apply_batch(self._ops, sync=True)
        self._written = True

    def close(self) -> None:
        """Drop the batch's pending operations (reference: Batch.Close)."""
        self._ops = []


class DB(abc.ABC):
    @abc.abstractmethod
    def get(self, key: bytes) -> Optional[bytes]: ...

    def has(self, key: bytes) -> bool:
        return self.get(key) is not None

    @abc.abstractmethod
    def set(self, key: bytes, value: bytes) -> None: ...

    def set_sync(self, key: bytes, value: bytes) -> None:
        self.set(key, value)

    @abc.abstractmethod
    def delete(self, key: bytes) -> None: ...

    def delete_sync(self, key: bytes) -> None:
        self.delete(key)

    @abc.abstractmethod
    def iterator(self, start: Optional[bytes] = None,
                 end: Optional[bytes] = None
                 ) -> Iterator[tuple[bytes, bytes]]:
        """Ascending byte-ordered iteration over [start, end)."""

    @abc.abstractmethod
    def reverse_iterator(self, start: Optional[bytes] = None,
                         end: Optional[bytes] = None
                         ) -> Iterator[tuple[bytes, bytes]]:
        """Descending iteration over [start, end)."""

    def new_batch(self) -> Batch:
        return Batch(self)

    @abc.abstractmethod
    def _apply_batch(self, ops, sync: bool = False) -> None: ...

    def close(self) -> None:
        pass

    def compact(self, start: Optional[bytes] = None,
                end: Optional[bytes] = None) -> None:
        """Reclaim space in [start, end); a no-op but on SQLite."""


class MemDB(DB):
    """In-memory ordered map (reference: test/ephemeral use)."""

    def __init__(self):
        self._m: dict[bytes, bytes] = {}
        self._keys: list[bytes] = []   # sorted
        self._lock = threading.RLock()

    def get(self, key: bytes) -> Optional[bytes]:
        self._check_key(key)
        with self._lock:
            return self._m.get(bytes(key))

    def set(self, key: bytes, value: bytes) -> None:
        self._check_key(key)
        if value is None:
            raise DBError("value cannot be nil")
        k = bytes(key)
        with self._lock:
            if k not in self._m:
                bisect.insort(self._keys, k)
            self._m[k] = bytes(value)

    def delete(self, key: bytes) -> None:
        self._check_key(key)
        k = bytes(key)
        with self._lock:
            if k in self._m:
                del self._m[k]
                i = bisect.bisect_left(self._keys, k)
                if i < len(self._keys) and self._keys[i] == k:
                    self._keys.pop(i)

    @staticmethod
    def _check_key(key: bytes) -> None:
        if key is None or len(key) == 0:
            raise DBError("key cannot be empty")

    def _range_keys(self, start: Optional[bytes],
                    end: Optional[bytes]) -> list[bytes]:
        with self._lock:
            lo = bisect.bisect_left(self._keys, start) if start else 0
            hi = bisect.bisect_left(self._keys, end) if end is not None \
                else len(self._keys)
            return self._keys[lo:hi]

    def iterator(self, start=None, end=None):
        for k in self._range_keys(start, end):
            v = self._m.get(k)
            if v is not None:
                yield k, v

    def reverse_iterator(self, start=None, end=None):
        for k in reversed(self._range_keys(start, end)):
            v = self._m.get(k)
            if v is not None:
                yield k, v

    def _apply_batch(self, ops, sync: bool = False) -> None:
        with self._lock:
            for op, k, v in ops:
                if op == "set":
                    self.set(k, v)
                else:
                    self.delete(k)


class SQLiteDB(DB):
    """Persistent ordered key-value store on SQLite in WAL mode."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.RLock()
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA synchronous=NORMAL")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv "
                "(k BLOB PRIMARY KEY, v BLOB NOT NULL) WITHOUT ROWID")
            self._conn.commit()

    def get(self, key: bytes) -> Optional[bytes]:
        MemDB._check_key(key)
        with self._lock:
            row = self._conn.execute(
                "SELECT v FROM kv WHERE k = ?", (bytes(key),)).fetchone()
        return row[0] if row else None

    def set(self, key: bytes, value: bytes) -> None:
        MemDB._check_key(key)
        if value is None:
            raise DBError("value cannot be nil")
        with self._lock:
            self._conn.execute(
                "INSERT INTO kv (k, v) VALUES (?, ?) "
                "ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                (bytes(key), bytes(value)))
            self._conn.commit()

    def set_sync(self, key: bytes, value: bytes) -> None:
        self.set(key, value)
        with self._lock:
            self._conn.execute("PRAGMA wal_checkpoint(FULL)")

    def delete(self, key: bytes) -> None:
        MemDB._check_key(key)
        with self._lock:
            self._conn.execute("DELETE FROM kv WHERE k = ?",
                               (bytes(key),))
            self._conn.commit()

    def iterator(self, start=None, end=None):
        q, args = "SELECT k, v FROM kv", []
        conds = []
        if start:
            conds.append("k >= ?")
            args.append(bytes(start))
        if end is not None:
            conds.append("k < ?")
            args.append(bytes(end))
        if conds:
            q += " WHERE " + " AND ".join(conds)
        q += " ORDER BY k ASC"
        with self._lock:
            rows = self._conn.execute(q, args).fetchall()
        yield from ((bytes(k), bytes(v)) for k, v in rows)

    def reverse_iterator(self, start=None, end=None):
        rows = list(self.iterator(start, end))
        yield from reversed(rows)

    def _apply_batch(self, ops, sync: bool = False) -> None:
        with self._lock:
            cur = self._conn.cursor()
            for op, k, v in ops:
                if op == "set":
                    cur.execute(
                        "INSERT INTO kv (k, v) VALUES (?, ?) "
                        "ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                        (k, v))
                else:
                    cur.execute("DELETE FROM kv WHERE k = ?", (k,))
            self._conn.commit()
            if sync:
                self._conn.execute("PRAGMA wal_checkpoint(FULL)")

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    def compact(self, start=None, end=None) -> None:
        with self._lock:
            self._conn.execute("PRAGMA incremental_vacuum")
            self._conn.commit()


class PrefixDB(DB):
    """Namespace wrapper (reference: db/prefixdb.go)."""

    def __init__(self, db: DB, prefix: bytes):
        self._db = db
        self._prefix = bytes(prefix)

    def _k(self, key: bytes) -> bytes:
        return self._prefix + key

    def get(self, key: bytes) -> Optional[bytes]:
        return self._db.get(self._k(key))

    def set(self, key: bytes, value: bytes) -> None:
        self._db.set(self._k(key), value)

    def set_sync(self, key: bytes, value: bytes) -> None:
        self._db.set_sync(self._k(key), value)

    def delete(self, key: bytes) -> None:
        self._db.delete(self._k(key))

    def iterator(self, start=None, end=None):
        p = self._prefix
        s = p + (start or b"")
        e = p + end if end is not None else _prefix_end(p)
        for k, v in self._db.iterator(s, e):
            yield k[len(p):], v

    def reverse_iterator(self, start=None, end=None):
        p = self._prefix
        s = p + (start or b"")
        e = p + end if end is not None else _prefix_end(p)
        for k, v in self._db.reverse_iterator(s, e):
            yield k[len(p):], v

    def _apply_batch(self, ops, sync: bool = False) -> None:
        self._db._apply_batch([(op, self._k(k), v) for op, k, v in ops],
                              sync)


def _prefix_end(prefix: bytes) -> Optional[bytes]:
    """Smallest byte string greater than every key with this prefix."""
    b = bytearray(prefix)
    while b:
        if b[-1] < 0xFF:
            b[-1] += 1
            return bytes(b)
        b.pop()
    return None


def new_db(name: str, backend: str = "sqlite",
           db_dir: str = ".") -> DB:
    """Reference: db.NewDB — backend registry."""
    if backend in ("memdb", "mem"):
        return MemDB()
    if backend in ("sqlite", "pebbledb", "goleveldb"):
        return SQLiteDB(os.path.join(db_dir, f"{name}.db"))
    raise DBError(f"unknown db backend {backend!r}")
