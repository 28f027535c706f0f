"""ABCI: the application interface, its in-process clients and the
kvstore app (reference: abci/)."""
