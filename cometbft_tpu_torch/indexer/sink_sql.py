"""SQL event sink.

Reference: state/indexer/sink/psql (psql.go + schema.sql) — an
operator-queryable relational mirror of block/tx events.  The sink
speaks BOTH targets with the same relational schema (blocks,
tx_results, events, attributes + the joined views):

- `tx_index.psql_conn = <path|:memory:>` — the embedded SQLite
  engine (no external database needed);
- `tx_index.psql_conn = postgres://user:pw@host/db` — a real
  PostgreSQL server via psycopg2 (gated: a clear error is raised
  when psycopg2 isn't installed).

Operator SQL written for the reference's views runs unchanged.  Like
the reference sink, it is write-only from the node's perspective:
tx_search/block_search RPCs are NOT served from this sink (psql.go
returns "not supported" for reads) — operators query the database
directly.

A copy of cometbft_tpu/indexer/sink_sql.py: the same schema, views,
rows and texts.
"""
from __future__ import annotations

import sqlite3
from datetime import datetime, timezone
from typing import Optional

from ..abci import types as abci
from ..wire import abci_pb, encode

_SCHEMA = """
CREATE TABLE IF NOT EXISTS blocks (
  rowid      INTEGER PRIMARY KEY AUTOINCREMENT,
  height     BIGINT NOT NULL,
  chain_id   VARCHAR NOT NULL,
  created_at TIMESTAMPTZ NOT NULL,
  UNIQUE (height, chain_id)
);
CREATE INDEX IF NOT EXISTS idx_blocks_height_chain
  ON blocks(height, chain_id);
CREATE TABLE IF NOT EXISTS tx_results (
  rowid      INTEGER PRIMARY KEY AUTOINCREMENT,
  block_id   BIGINT NOT NULL REFERENCES blocks(rowid),
  "index"    INTEGER NOT NULL,
  created_at TIMESTAMPTZ NOT NULL,
  tx_hash    VARCHAR NOT NULL,
  tx_result  BLOB NOT NULL,
  UNIQUE (block_id, "index")
);
CREATE TABLE IF NOT EXISTS events (
  rowid    INTEGER PRIMARY KEY AUTOINCREMENT,
  block_id BIGINT NOT NULL REFERENCES blocks(rowid),
  tx_id    BIGINT NULL REFERENCES tx_results(rowid),
  type     VARCHAR NOT NULL
);
CREATE TABLE IF NOT EXISTS attributes (
  event_id      BIGINT NOT NULL REFERENCES events(rowid),
  key           VARCHAR NOT NULL,
  composite_key VARCHAR NOT NULL,
  value         VARCHAR NULL,
  UNIQUE (event_id, key)
);
CREATE VIEW IF NOT EXISTS event_attributes AS
  SELECT block_id, tx_id, type, key, composite_key, value
  FROM events LEFT JOIN attributes
    ON (events.rowid = attributes.event_id);
CREATE VIEW IF NOT EXISTS block_events AS
  SELECT blocks.rowid as block_id, height, chain_id, type, key,
         composite_key, value
  FROM blocks JOIN event_attributes
    ON (blocks.rowid = event_attributes.block_id)
  WHERE event_attributes.tx_id IS NULL;
CREATE VIEW IF NOT EXISTS tx_events AS
  SELECT height, "index", chain_id, type, key, composite_key, value,
         tx_results.created_at
  FROM blocks JOIN tx_results ON (blocks.rowid = tx_results.block_id)
  JOIN event_attributes ON
    (tx_results.rowid = event_attributes.tx_id)
  WHERE event_attributes.tx_id IS NOT NULL;
"""


def _psql_schema() -> str:
    """The same schema in PostgreSQL dialect (reference: schema.sql —
    BIGSERIAL keys, BYTEA blobs; rowid is an explicit column in both
    dialects, so every query below runs unchanged)."""
    s = _SCHEMA.replace("INTEGER PRIMARY KEY AUTOINCREMENT",
                        "BIGSERIAL PRIMARY KEY")
    s = s.replace("BLOB", "BYTEA")
    return s.replace("CREATE VIEW IF NOT EXISTS",
                     "CREATE OR REPLACE VIEW")


class _Cursor:
    """Paramstyle-adapting cursor: rewrites the module's ?-placeholder
    SQL to the target's paramstyle at the single choke point."""

    def __init__(self, cur, ph: str):
        self._cur = cur
        self._ph = ph

    def execute(self, sql, params=()):
        if self._ph != "?":
            sql = sql.replace("?", self._ph)
        return self._cur.execute(sql, params)

    def insert_returning(self, sql, params=()):
        """INSERT and return the new rowid.  psycopg2's lastrowid is
        the table OID (0 for ordinary tables), so the %s dialect uses
        INSERT ... RETURNING rowid instead."""
        if self._ph == "?":
            self._cur.execute(sql, params)
            return self._cur.lastrowid
        self._cur.execute(
            sql.replace("?", self._ph) + " RETURNING rowid", params)
        return self._cur.fetchone()[0]

    def __getattr__(self, name):
        return getattr(self._cur, name)


class SQLEventSink:
    """Write-side event sink with the reference's psql schema."""

    def __init__(self, conn_str: str, chain_id: str):
        # conn_str: a PostgreSQL DSN (postgres://...) or a filesystem
        # path / :memory: for the embedded engine
        if conn_str.startswith(("postgres://", "postgresql://")):
            try:
                import psycopg2
            except ImportError:
                raise RuntimeError(
                    "tx_index.psql_conn is a PostgreSQL DSN but "
                    "psycopg2 is not installed — install it or "
                    "point psql_conn at an embedded database path")
            self._conn = psycopg2.connect(conn_str)
            self._ph = "%s"
            cur = self._conn.cursor()
            for stmt in _psql_schema().split(";"):
                if stmt.strip():
                    cur.execute(stmt)
        else:
            self._conn = sqlite3.connect(conn_str,
                                         check_same_thread=False)
            self._ph = "?"
            self._conn.executescript(_SCHEMA)
        self._conn.commit()
        self.chain_id = chain_id

    def _cursor(self) -> _Cursor:
        return _Cursor(self._conn.cursor(), self._ph)

    def close(self) -> None:
        self._conn.close()

    # -- write side --------------------------------------------------------
    def _rollback(self) -> None:
        try:
            self._conn.rollback()
        except Exception:
            pass

    def index_block_events(self, height: int, events: list) -> None:
        """Reference: psql.go IndexBlockEvents — insert the block row
        plus its begin/end-block-style events."""
        try:
            self._index_block_events(height, events)
        except Exception:
            self._rollback()
            raise

    def _index_block_events(self, height: int, events: list) -> None:
        now = datetime.now(timezone.utc).isoformat()
        cur = self._cursor()
        cur.execute(
            "INSERT INTO blocks (height, chain_id, created_at) "
            "VALUES (?, ?, ?) "
            "ON CONFLICT (height, chain_id) DO UPDATE SET "
            "created_at = excluded.created_at",
            (height, self.chain_id, now))
        cur.execute(
            "SELECT rowid FROM blocks WHERE height = ? AND "
            "chain_id = ?", (height, self.chain_id))
        block_rowid = cur.fetchone()[0]
        # re-indexing the same height must replace, not duplicate
        self._delete_events(cur, block_rowid, tx_events=False)
        # the reference also records the implicit block.height event
        self._insert_events(cur, block_rowid, None, [
            abci.Event(type="block", attributes=[
                abci.EventAttribute(key="height", value=str(height),
                                    index=True)])] + list(events or []))
        self._conn.commit()

    def index_tx_events(self, tx_results: list) -> None:
        try:
            self._index_tx_events(tx_results)
        except Exception:
            self._rollback()
            raise

    def _index_tx_events(self, tx_results: list) -> None:
        """Reference: psql.go IndexTxEvents — insert tx_results rows
        and their events (the TxResult proto bytes are stored for
        round-tripping)."""
        from ..types.tx import tx_hash
        now = datetime.now(timezone.utc).isoformat()
        cur = self._cursor()
        for txr in tx_results:
            cur.execute(
                "SELECT rowid FROM blocks WHERE height = ? AND "
                "chain_id = ?", (txr.height, self.chain_id))
            row = cur.fetchone()
            if row is None:
                block_rowid = cur.insert_returning(
                    "INSERT INTO blocks (height, chain_id, created_at)"
                    " VALUES (?, ?, ?)",
                    (txr.height, self.chain_id, now))
            else:
                block_rowid = row[0]
            raw = encode(abci_pb.TX_RESULT, {
                **({"height": txr.height} if txr.height else {}),
                **({"index": txr.index} if txr.index else {}),
                **({"tx": txr.tx} if txr.tx else {}),
                "result": _exec_result_proto(txr.result),
            })
            cur.execute(
                "INSERT INTO tx_results "
                "(block_id, \"index\", created_at, tx_hash, tx_result)"
                " VALUES (?, ?, ?, ?, ?) "
                "ON CONFLICT (block_id, \"index\") DO UPDATE SET "
                "tx_result = excluded.tx_result",
                (block_rowid, txr.index, now,
                 tx_hash(txr.tx).hex().upper(), raw))
            cur.execute(
                "SELECT rowid FROM tx_results WHERE block_id = ? AND "
                "\"index\" = ?", (block_rowid, txr.index))
            tx_rowid = cur.fetchone()[0]
            # replace any events from an earlier delivery of this tx
            cur.execute(
                "DELETE FROM attributes WHERE event_id IN "
                "(SELECT rowid FROM events WHERE tx_id = ?)",
                (tx_rowid,))
            cur.execute("DELETE FROM events WHERE tx_id = ?",
                        (tx_rowid,))
            implicit = [
                abci.Event(type="tx", attributes=[
                    abci.EventAttribute(
                        key="hash",
                        value=tx_hash(txr.tx).hex().upper(),
                        index=True)]),
                abci.Event(type="tx", attributes=[
                    abci.EventAttribute(key="height",
                                        value=str(txr.height),
                                        index=True)]),
            ]
            self._insert_events(cur, block_rowid, tx_rowid,
                                implicit + list(txr.result.events or []))
        self._conn.commit()

    def _delete_events(self, cur, block_id: int,
                       tx_events: bool) -> None:
        cond = "IS NOT NULL" if tx_events else "IS NULL"
        cur.execute(
            "DELETE FROM attributes WHERE event_id IN "
            f"(SELECT rowid FROM events WHERE block_id = ? "
            f" AND tx_id {cond})", (block_id,))
        cur.execute(
            f"DELETE FROM events WHERE block_id = ? AND "
            f"tx_id {cond}", (block_id,))

    def _insert_events(self, cur, block_id: int, tx_id: Optional[int],
                       events: list) -> None:
        for ev in events:
            if not ev.type:
                continue
            event_id = cur.insert_returning(
                "INSERT INTO events (block_id, tx_id, type) "
                "VALUES (?, ?, ?)", (block_id, tx_id, ev.type))
            for attr in ev.attributes or []:
                if not attr.key:
                    continue
                cur.execute(
                    "INSERT INTO attributes "
                    "(event_id, key, composite_key, value) "
                    "VALUES (?, ?, ?, ?) "
                    "ON CONFLICT (event_id, key) DO UPDATE SET "
                    "value = excluded.value",
                    (event_id, attr.key, f"{ev.type}.{attr.key}",
                     attr.value))

    # -- adapters so IndexerService can drive the sink ---------------------
    @property
    def tx_indexer(self) -> "_SinkTxAdapter":
        return _SinkTxAdapter(self)

    @property
    def block_indexer(self) -> "_SinkBlockAdapter":
        return _SinkBlockAdapter(self)


class _SinkTxAdapter:
    def __init__(self, sink: SQLEventSink):
        self._sink = sink

    def index(self, tx_result) -> None:
        self._sink.index_tx_events([tx_result])

    def get(self, tx_hash_: bytes):
        return None         # reads unsupported (reference psql.go)

    def search(self, query, limit: int = 100) -> list:
        raise NotImplementedError(
            "the SQL sink does not serve searches; query the "
            "database directly (reference: psql sink)")

    def prune(self, from_height: int, to_height: int) -> int:
        cur = self._sink._cursor()
        cur.execute(
            "DELETE FROM attributes WHERE event_id IN "
            "(SELECT events.rowid FROM events JOIN blocks "
            " ON events.block_id = blocks.rowid "
            " WHERE blocks.height >= ? AND blocks.height < ? "
            " AND events.tx_id IS NOT NULL)",
            (from_height, to_height))
        cur.execute(
            "DELETE FROM events WHERE tx_id IS NOT NULL AND "
            "block_id IN (SELECT rowid FROM blocks WHERE "
            "height >= ? AND height < ?)",
            (from_height, to_height))
        cur.execute(
            "DELETE FROM tx_results WHERE block_id IN "
            "(SELECT rowid FROM blocks WHERE height >= ? AND "
            "height < ?)", (from_height, to_height))
        n = cur.rowcount
        self._sink._conn.commit()
        return max(n, 0)


class _SinkBlockAdapter:
    def __init__(self, sink: SQLEventSink):
        self._sink = sink

    def index(self, height: int, events: list) -> None:
        self._sink.index_block_events(height, events)

    def search(self, query, limit: int = 100) -> list:
        raise NotImplementedError(
            "the SQL sink does not serve searches; query the "
            "database directly (reference: psql sink)")

    def prune(self, from_height: int, to_height: int) -> int:
        cur = self._sink._cursor()
        cur.execute(
            "DELETE FROM attributes WHERE event_id IN "
            "(SELECT events.rowid FROM events JOIN blocks "
            " ON events.block_id = blocks.rowid "
            " WHERE blocks.height >= ? AND blocks.height < ? "
            " AND events.tx_id IS NULL)",
            (from_height, to_height))
        cur.execute(
            "DELETE FROM events WHERE tx_id IS NULL AND block_id IN "
            "(SELECT rowid FROM blocks WHERE height >= ? AND "
            "height < ?)", (from_height, to_height))
        n = cur.rowcount
        self._sink._conn.commit()
        return max(n, 0)


def _exec_result_proto(r) -> dict:
    from .kv import _exec_result_proto as impl
    return impl(r)
