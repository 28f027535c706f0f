"""Embedded ordered key-value store (reference: db/db.go:24): MemDB for
tests and ephemeral use, SQLiteDB on disk, PrefixDB for namespaces."""
from .db import DB, Batch, DBError, MemDB, PrefixDB, SQLiteDB, new_db

__all__ = ["DB", "Batch", "DBError", "MemDB", "PrefixDB", "SQLiteDB",
           "new_db"]
