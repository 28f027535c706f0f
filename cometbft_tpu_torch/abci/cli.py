"""abci-cli: console for exercising an ABCI application.

Reference: abci/cmd/abci-cli/abci-cli.go (798 LoC) — echo, info,
check_tx, query, prepare/process proposal, finalize_block, commit
against a builtin or socket app, plus an interactive console.

    python -m cometbft_tpu_torch.abci.cli --address unix:///tmp/app.sock \
        echo hello
    python -m cometbft_tpu_torch.abci.cli --app kvstore console

A copy of cometbft_tpu/abci/cli.py: the same commands and output.
"""
from __future__ import annotations

import argparse
import asyncio
import base64
import shlex
import sys

from . import types as abci
from .types import BaseApplication


def _print(obj) -> None:
    print(obj)


class _Session:
    """One CLI session over either a socket client or an in-proc app."""

    def __init__(self, address: str = "", app_name: str = ""):
        self.address = address
        self.app_name = app_name
        self.client = None

    async def __aenter__(self):
        if self.address:
            from .client import SocketClient
            self.client = SocketClient(self.address)
            await self.client.connect()
        else:
            from .client import LocalClient
            from .server import _build_app
            self.client = LocalClient(
                _build_app(self.app_name or "kvstore"))
        return self

    async def __aexit__(self, *exc):
        if hasattr(self.client, "close"):
            await self.client.close()
        return False

    # -- commands ---------------------------------------------------------
    async def cmd(self, name: str, args: list[str]) -> None:
        c = self.client
        if name == "echo":
            res = await c.echo(" ".join(args))
            _print(f"-> message: {res.message}")
        elif name == "info":
            res = await c.info(abci.InfoRequest())
            _print(f"-> data: {res.data}")
            _print(f"-> last_block_height: {res.last_block_height}")
            _print(f"-> last_block_app_hash: "
                   f"{res.last_block_app_hash.hex().upper()}")
        elif name == "check_tx":
            if not args:
                _print("usage: check_tx <tx>")
                return
            res = await c.check_tx(abci.CheckTxRequest(
                tx=_parse_bytes(args[0]),
                type=abci.CHECK_TX_TYPE_CHECK))
            _print(f"-> code: {res.code}")
            _print(f"-> log: {res.log}")
        elif name == "finalize_block":
            res = await c.finalize_block(abci.FinalizeBlockRequest(
                txs=[_parse_bytes(a) for a in args],
                height=1))
            for i, r in enumerate(res.tx_results):
                _print(f"-> tx {i} code: {r.code}")
            _print(f"-> app_hash: {res.app_hash.hex().upper()}")
        elif name == "commit":
            res = await c.commit()
            _print(f"-> retain_height: {res.retain_height}")
        elif name == "query":
            path = args[0] if args else ""
            data = _parse_bytes(args[1]) if len(args) > 1 else b""
            res = await c.query(abci.QueryRequest(path=path, data=data))
            _print(f"-> code: {res.code}")
            _print(f"-> value: {res.value.decode(errors='replace')}")
        else:
            _print(f"unknown command {name!r}; try: echo info check_tx "
                   f"finalize_block commit query")

    async def console(self) -> None:
        _print("ABCI console (reference: abci-cli console); "
               "'quit' exits")
        loop = asyncio.get_running_loop()
        while True:
            line = await loop.run_in_executor(None, _read_line)
            if line is None or line.strip() in ("quit", "exit"):
                return
            parts = shlex.split(line)
            if not parts:
                continue
            try:
                await self.cmd(parts[0], parts[1:])
            except Exception as e:  # noqa: BLE001 — console survives
                _print(f"error: {e}")


def _read_line():
    try:
        return input("> ")
    except EOFError:
        return None


def _parse_bytes(s: str) -> bytes:
    if s.startswith("0x"):
        return bytes.fromhex(s[2:])
    if s.startswith("b64:"):
        return base64.b64decode(s[4:])
    return s.encode()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="abci-cli (reference: abci/cmd/abci-cli)")
    ap.add_argument("--address", default="",
                    help="socket app address (unix:// or tcp://); "
                         "omit for a builtin app")
    ap.add_argument("--app", default="kvstore",
                    help="builtin app when no --address")
    ap.add_argument("command", nargs="?", default="console")
    ap.add_argument("args", nargs="*")
    ns = ap.parse_args(argv)

    async def run():
        async with _Session(ns.address, ns.app) as sess:
            if ns.command == "console":
                await sess.console()
            else:
                await sess.cmd(ns.command, ns.args)

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
