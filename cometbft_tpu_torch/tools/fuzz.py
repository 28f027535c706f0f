"""Coverage-guided fuzzing for the port's network-facing parsers.

Counterpart of cometbft_tpu/tools/fuzz.py (reference: test/fuzz/ and
oss-fuzz-build.sh, which ship go-fuzz harnesses with persisted corpora
for the JSON-RPC server and the secret-connection read path).  The
engine is the same:

  * ``CoverageMap`` feeds on sys.monitoring (PEP 669) LINE events: the
    first execution of each (code object, line) location inside the
    target modules fires one callback, which records it and returns
    ``sys.monitoring.DISABLE``, so the callback stream is the "new
    coverage" signal;
  * an input that reaches a new location is kept and persisted to the
    corpus directory (sha1-named): ``tests/fuzz_corpus_torch/<target>/``;
  * an input that raises anything outside the target's declared error
    types is persisted to ``<target>/crashes/`` and reported, and
    ``main`` exits 1.

The three targets run over the port's own parsers: ``jsonrpc``
(``rpc/server.RPCServer._dispatch``), ``proto`` (``wire.decode`` over
the port's ``abci_pb`` / ``pb`` descriptors) and ``secretconn``
(``p2p/secret_connection.SecretConnection.make``).  The JAX package's
corpus (``tests/fuzz_corpus/``) is replayed read-only with
``replay_corpus``; nothing here writes to it.

Run:  python -m cometbft_tpu_torch.tools.fuzz --target all --budget 30
"""
from __future__ import annotations

import argparse
import asyncio
import hashlib
import json
import os
import random
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CORPUS = os.path.join(_REPO, "tests", "fuzz_corpus_torch")
# the JAX package's corpus: replayed, never written
REFERENCE_CORPUS = os.path.join(_REPO, "tests", "fuzz_corpus")

# PEP 669 is python 3.12+; on older interpreters the CoverageMap
# falls back to sys.settrace (slower, same semantics)
_HAVE_MONITORING = hasattr(sys, "monitoring")
_TOOL = sys.monitoring.COVERAGE_ID if _HAVE_MONITORING else 0
_MAX_INPUT = 4096


class CoverageMap:
    """Global line coverage over a set of module files, fed by
    sys.monitoring.  Locations outside the targets are DISABLEd on
    first sight; target locations report once ever, so `fresh` after
    a run means the run reached code no earlier input reached."""

    def __init__(self, filenames: Iterable[str]):
        self._files = {os.path.abspath(f) for f in filenames}
        self.locations: set[tuple[str, int]] = set()
        self.fresh = 0
        self._active = False

    def _on_line(self, code, line):
        fn = code.co_filename
        if fn in self._files:
            self.locations.add((fn, line))
            self.fresh += 1
        return sys.monitoring.DISABLE

    def _trace(self, frame, event, arg):
        # sys.settrace fallback (pre-3.12): per-call filtering keeps
        # the overhead on non-target frames to one dict lookup
        if event == "call":
            return self._trace \
                if frame.f_code.co_filename in self._files else None
        if event == "line":
            loc = (frame.f_code.co_filename, frame.f_lineno)
            if loc not in self.locations:
                self.locations.add(loc)
                self.fresh += 1
        return self._trace

    def __enter__(self):
        if not _HAVE_MONITORING:
            sys.settrace(self._trace)
            self._active = True
            return self
        sys.monitoring.use_tool_id(_TOOL, "cometbft-fuzz")
        sys.monitoring.register_callback(
            _TOOL, sys.monitoring.events.LINE, self._on_line)
        sys.monitoring.set_events(_TOOL, sys.monitoring.events.LINE)
        # locations DISABLEd by a previous session stay disabled
        # process-wide until restarted — without this, a second
        # fuzz_target over the same modules sees zero coverage
        sys.monitoring.restart_events()
        self._active = True
        return self

    def __exit__(self, *exc):
        if self._active:
            if not _HAVE_MONITORING:
                sys.settrace(None)
            else:
                sys.monitoring.set_events(
                    _TOOL, sys.monitoring.events.NO_EVENTS)
                sys.monitoring.register_callback(
                    _TOOL, sys.monitoring.events.LINE, None)
                sys.monitoring.free_tool_id(_TOOL)
            self._active = False
        return False

    def take_fresh(self) -> int:
        n, self.fresh = self.fresh, 0
        return n


def mutate(rng: random.Random, corpus: list[bytes]) -> bytes:
    """One havoc-mutated input from the corpus (or pure random)."""
    if rng.random() < 0.15 or not corpus:
        return rng.randbytes(rng.randrange(0, 256))
    base = bytearray(rng.choice(corpus))
    for _ in range(rng.randrange(1, 8)):
        op = rng.randrange(6)
        if op == 0 and base:                          # bit flip
            i = rng.randrange(len(base))
            base[i] ^= 1 << rng.randrange(8)
        elif op == 1 and base:                        # byte set
            base[rng.randrange(len(base))] = rng.randrange(256)
        elif op == 2 and base:                        # truncate
            del base[rng.randrange(len(base)):]
        elif op == 3:                                 # insert junk
            i = rng.randrange(len(base) + 1)
            base[i:i] = rng.randbytes(rng.randrange(1, 16))
        elif op == 4 and base:                        # splice corpus
            other = rng.choice(corpus)
            i = rng.randrange(len(base))
            base[i:i + rng.randrange(1, 32)] = \
                other[:rng.randrange(1, max(2, len(other)))]
        elif op == 5:                                 # magic ints
            magic = rng.choice(
                [b"\x00", b"\xff\xff\xff\xff", b"\x80", b"\x7f",
                 b"\xff\xff\xff\xff\xff\xff\xff\xff\x7f",
                 b'"', b"{", b"[", b"\\u0000"])
            i = rng.randrange(len(base) + 1)
            base[i:i] = magic
    return bytes(base[:_MAX_INPUT])


@dataclass
class FuzzStats:
    target: str
    runs: int = 0
    locations: int = 0
    corpus_size: int = 0
    new_inputs: int = 0
    crashes: list = field(default_factory=list)

    def to_dict(self) -> dict:
        d = dict(self.__dict__)
        d["crashes"] = [c[:200] for c in self.crashes]
        return d


class Target:
    """One fuzz target: a callable over raw bytes, the modules whose
    coverage guides it, seed inputs, and an optional close() for
    resources (event loops) the harness owns."""

    def __init__(self, name: str, run: Callable[[bytes], None],
                 modules: list[str], seeds: list[bytes],
                 close: Optional[Callable[[], None]] = None):
        self.name = name
        self.run = run
        self.modules = modules
        self.seeds = seeds
        self._close = close

    def close(self) -> None:
        if self._close is not None:
            self._close()


def _load_corpus(d: str) -> list[bytes]:
    out = []
    try:
        for fn in sorted(os.listdir(d)):
            p = os.path.join(d, fn)
            if os.path.isfile(p):
                with open(p, "rb") as f:
                    out.append(f.read(_MAX_INPUT))
    except OSError:
        pass
    return out


def _save(d: str, data: bytes) -> str:
    os.makedirs(d, exist_ok=True)
    name = hashlib.sha1(data).hexdigest()[:16] + ".bin"
    path = os.path.join(d, name)
    if not os.path.exists(path):
        with open(path, "wb") as f:
            f.write(data)
    return name


def fuzz_target(target: Target, budget_s: float,
                corpus_dir: str = DEFAULT_CORPUS,
                seed: int = 0) -> FuzzStats:
    """Run one coverage-guided loop.  Inputs that discover new lines
    are persisted to `{corpus_dir}/{target.name}/`; inputs that raise
    undeclared exceptions go to `.../crashes/` and are reported in
    the stats (the loop keeps going — one crash must not hide
    others).  The JAX package's corpus is never a ``corpus_dir``."""
    if os.path.abspath(corpus_dir) == os.path.abspath(REFERENCE_CORPUS):
        target.close()
        raise ValueError(f"{REFERENCE_CORPUS} is the JAX package's corpus: "
                         f"replay it with replay_corpus, do not fuzz into it")
    tdir = os.path.join(corpus_dir, target.name)
    stats = FuzzStats(target=target.name)
    corpus = list(target.seeds) + _load_corpus(tdir)
    rng = random.Random(seed or 0xF17E5)
    crash_sigs: set[str] = set()
    try:
        _fuzz_loop(target, budget_s, tdir, stats, corpus, rng,
                   crash_sigs)
    finally:
        target.close()
    stats.corpus_size = len(corpus)
    return stats


def replay_corpus(target: Target, corpus_dir: str) -> int:
    """Run every input of ``{corpus_dir}/{target.name}/`` (not its
    crashes) through the target; an undeclared exception propagates.
    Returns the number of inputs replayed."""
    n = 0
    for data in _load_corpus(os.path.join(corpus_dir, target.name)):
        target.run(data)
        n += 1
    return n


def _fuzz_loop(target, budget_s, tdir, stats, corpus, rng,
               crash_sigs) -> None:
    with CoverageMap(target.modules) as cov:
        # replay the corpus first so "fresh" afterwards means genuinely
        # new coverage, not first-touch of old territory
        for data in corpus:
            try:
                target.run(data)
            except Exception:
                pass
        cov.take_fresh()
        deadline = time.monotonic() + budget_s
        while time.monotonic() < deadline:
            data = mutate(rng, corpus)
            stats.runs += 1
            try:
                target.run(data)
            except Exception as e:
                sig = f"{type(e).__name__}: {e}"[:120]
                if sig not in crash_sigs:
                    crash_sigs.add(sig)
                    name = _save(os.path.join(tdir, "crashes"), data)
                    stats.crashes.append(f"{sig} [{name}]")
            if cov.take_fresh():
                corpus.append(data)
                _save(tdir, data)
                stats.new_inputs += 1
        stats.locations = len(cov.locations)


# --------------------------------------------------------------------------
# targets

def _jsonrpc_target() -> Target:
    from cometbft_tpu_torch.config import RPCConfig
    from cometbft_tpu_torch.rpc import server as rpc_server_mod
    from cometbft_tpu_torch.rpc.server import RPCServer

    class _NullNode:
        metrics_registry = None

    async def echo(*, s: str = "", i: int = 0):
        return {"s": s, "i": i}

    srv = RPCServer(_NullNode(), RPCConfig(), routes={"echo": echo})
    loop = asyncio.new_event_loop()

    def run(data: bytes) -> None:
        resp = loop.run_until_complete(
            srv._dispatch("POST", "/", data))
        assert isinstance(resp, (dict, list))
        json.dumps(resp)

    seeds = [
        b'{"jsonrpc":"2.0","method":"echo","params":{"s":"x"},"id":1}',
        b'[{"jsonrpc":"2.0","method":"echo","id":3}]',
        b'{"jsonrpc":"2.0","method":{"method":-1},"id":4}',
        b'{"method":"echo","params":{"i":-1}}',
        b"{}", b"[]", b"null", b"0",
    ]
    return Target("jsonrpc", run, [rpc_server_mod.__file__], seeds,
                  close=loop.close)


def _proto_target() -> Target:
    from cometbft_tpu_torch.wire import abci_pb, pb, proto
    from cometbft_tpu_torch.wire import decode, encode

    descs = [abci_pb.CHECK_TX_REQUEST, abci_pb.FINALIZE_BLOCK_REQUEST,
             abci_pb.INFO_RESPONSE, pb.BLOCK, pb.HEADER, pb.VOTE,
             pb.COMMIT]

    def run(data: bytes) -> None:
        for d in descs:
            try:
                decode(d, data)
            except ValueError:
                pass                # the decoder's declared rejection

    seeds = []
    for d in descs:
        try:
            seeds.append(encode(d, {}))
        except Exception:
            pass
    seeds += [b"\x0a\x02hi", b"\x08\x96\x01", b"\xff" * 10]
    return Target("proto", run, [proto.__file__], seeds)


def _secretconn_target() -> Target:
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.p2p import secret_connection as sc_mod
    from cometbft_tpu_torch.p2p.secret_connection import (
        SecretConnection, SecretConnectionError,
    )

    loop = asyncio.new_event_loop()
    key = ed25519.gen_priv_key()

    class _W:
        def write(self, b):
            pass

        async def drain(self):
            pass

        def close(self):
            pass

    def run(data: bytes) -> None:
        async def one():
            reader = asyncio.StreamReader()
            reader.feed_data(data)
            reader.feed_eof()
            try:
                await asyncio.wait_for(
                    SecretConnection.make(reader, _W(), key),
                    timeout=5)
            except (SecretConnectionError, ValueError,
                    asyncio.IncompleteReadError, ConnectionError,
                    asyncio.TimeoutError):
                pass
        loop.run_until_complete(one())

    seeds = [bytes(32), b"\x20" + bytes(32), b"\x20" + os.urandom(32)]
    return Target("secretconn", run, [sc_mod.__file__], seeds,
                  close=loop.close)


TARGETS = {
    "jsonrpc": _jsonrpc_target,
    "proto": _proto_target,
    "secretconn": _secretconn_target,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", default="all",
                    choices=["all"] + sorted(TARGETS))
    ap.add_argument("--budget", type=float, default=30.0,
                    help="seconds per target")
    ap.add_argument("--corpus", default=DEFAULT_CORPUS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    names = sorted(TARGETS) if args.target == "all" else [args.target]
    rc = 0
    for name in names:
        stats = fuzz_target(TARGETS[name](), args.budget,
                            corpus_dir=args.corpus, seed=args.seed)
        print(json.dumps(stats.to_dict()))
        if stats.crashes:
            rc = 1
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
