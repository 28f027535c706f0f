"""Crash consistency of the port: fire each fail point of the commit path
in a real ``cometbft_tpu_torch.node.Node`` process, hard-crash it there
(exit 99), restart it on its home and require it to commit on.

The port's copy of tests/test_failpoints.py over tests/torch_crash_driver.py,
with the node on ``device="cpu"``: the sweep over the 7 boundaries and
the later-height sweep over (0, 2, 5, 6) are ``slow``, as in the JAX
file; the clean run and the torn-WAL restart run in the default tier.
Indices count from process start, so indices 0-6 fire in the first
height's commit and ``2 * 7 + b`` in the third's, in both packages.

The parity tests hold the port's fail points to the JAX package's: the
same labelled call sites, in the same order, by ``ast`` over both
packages' ``_finalize_commit`` (with the pipelined apply it starts) and
``_apply_block``; and one in-process validator of each package fires
the same 7 labels per committed height, counted with ``fail.reset()``.
"""
import ast
import asyncio
import glob
import linecache
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

from cometbft_tpu.abci.client import AppConns as RAppConns
from cometbft_tpu.abci.kvstore import KVStoreApplication as RKVStore
from cometbft_tpu.config import test_config as r_test_config
from cometbft_tpu.consensus.state import ConsensusState as RConsensusState
from cometbft_tpu.crypto import batch as r_batch
from cometbft_tpu.db import MemDB as RMemDB
from cometbft_tpu.libs import fail as r_fail
from cometbft_tpu.state import make_genesis_state as r_make_genesis_state
from cometbft_tpu.state.execution import BlockExecutor as RBlockExecutor
from cometbft_tpu.state.store import Store as RStore
from cometbft_tpu.store import BlockStore as RBlockStore
from cometbft_tpu.types.genesis import GenesisDoc as RGenesisDoc
from cometbft_tpu.types.genesis import GenesisValidator as RGenesisValidator
from cometbft_tpu.types.priv_validator import new_mock_pv as r_new_mock_pv
from cometbft_tpu.types.timestamp import Timestamp as RTimestamp
from cometbft_tpu_torch.abci.client import AppConns
from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
from cometbft_tpu_torch.config import test_config as _test_config
from cometbft_tpu_torch.consensus.state import ConsensusState
from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.db import MemDB
from cometbft_tpu_torch.libs import fail as p_fail
from cometbft_tpu_torch.state import make_genesis_state
from cometbft_tpu_torch.state.execution import BlockExecutor
from cometbft_tpu_torch.state.store import Store
from cometbft_tpu_torch.store import BlockStore
from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from cometbft_tpu_torch.types.priv_validator import new_mock_pv
from cometbft_tpu_torch.types.timestamp import Timestamp
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
_DRIVER = str(REPO / "tests" / "torch_crash_driver.py")

# 7 fail() calls fire per committed height: 4 in consensus/state.py
# (_finalize_commit and the apply it starts) + 3 in state/execution.py
# _apply_block (order: 0 before block save, 1 before WAL barrier, 2 after
# barrier, 3 before response save, 4 after response save, 5 after app
# commit, 6 before update_to_state).
N_FAIL_POINTS = 7

# the functions that hold the commit path's fail points, per module
SITES = (("consensus/state.py",
          ("_finalize_commit", "_begin_pipelined_apply")),
         ("state/execution.py", ("_apply_block",)))


def _run(home: str, target: int, fail_index: int = -1,
         timeout: int = 60) -> int:
    env = {**os.environ, "COMETBFT_TPU_TORCH_CRASH_DEVICE": "cpu"}
    if fail_index >= 0:
        env["FAIL_TEST_INDEX"] = str(fail_index)
    else:
        env.pop("FAIL_TEST_INDEX", None)
    p = subprocess.run(
        [sys.executable, _DRIVER, home, str(target)],
        env=env, timeout=timeout, capture_output=True, text=True)
    return p.returncode


class TestCrashConsistency:
    @pytest.mark.slow
    def test_recovery_at_every_commit_boundary(self):
        """For each index i: crash a node mid-commit at boundary i
        (indices count from process start), then restart and require
        the chain to keep committing."""
        for i in range(N_FAIL_POINTS):
            with tempfile.TemporaryDirectory() as d:
                home = os.path.join(d, "node")
                rc = _run(home, target=50, fail_index=i)
                assert rc == 99, \
                    f"fail point {i} did not fire (rc={rc})"
                rc = _run(home, target=5)
                assert rc == 0, f"recovery after crash at {i} failed"

    @pytest.mark.slow
    def test_crash_at_later_height_boundaries(self):
        """Crash during the 3rd height's commit (index 2 heights in) and
        recover: catches faults that appear only once LastCommit
        exists."""
        for boundary in (0, 2, 5, 6):
            i = 2 * N_FAIL_POINTS + boundary
            with tempfile.TemporaryDirectory() as d:
                home = os.path.join(d, "node")
                rc = _run(home, target=50, fail_index=i)
                assert rc == 99, \
                    f"fail point {i} did not fire (rc={rc})"
                rc = _run(home, target=6)
                assert rc == 0, f"recovery after crash at {i} failed"

    def test_no_failpoint_runs_clean(self):
        with tempfile.TemporaryDirectory() as d:
            home = os.path.join(d, "node")
            assert _run(home, target=3) == 0


class TestCorruptWALRecovery:
    def test_node_repairs_corrupt_wal_and_restarts(self):
        """Append garbage to the WAL tail (torn/corrupt write), restart:
        the node truncates the corrupt tail, keeps a forensics copy, and
        keeps committing (reference: state.go OnStart repair retry)."""
        with tempfile.TemporaryDirectory() as d:
            home = os.path.join(d, "node")
            assert _run(home, target=5) == 0
            wal = os.path.join(home, "data", "cs.wal", "wal")
            if not os.path.exists(wal):
                cands = glob.glob(os.path.join(home, "data", "**",
                                               "wal*"),
                                  recursive=True)
                assert cands, "no WAL file found"
                wal = cands[0]
            with open(wal, "r+b") as f:
                f.seek(0, 2)
                size = f.tell()
                # corrupt the last frame's payload bytes
                f.seek(max(0, size - 20))
                f.write(b"\xde\xad\xbe\xef" * 5)
            assert _run(home, target=8) == 0, \
                "node failed to recover from corrupt WAL"
            assert os.path.exists(wal + ".corrupted")


# ----------------------------------------------------------------------
# the fail points themselves, in both packages

def _label(path: str, lineno: int) -> str:
    """The comment on a fail point's line and the comment-only lines
    that continue it: what the call site says it guards."""
    line = linecache.getline(path, lineno)
    parts = [line.split("#", 1)[1].strip()]
    col = line.index("#")
    while True:
        lineno += 1
        nxt = linecache.getline(path, lineno)
        if not nxt.strip().startswith("#") or nxt.index("#") != col:
            return " ".join(parts)
        parts.append(nxt.split("#", 1)[1].strip())


def _is_fail_call(node) -> bool:
    return isinstance(node, ast.Call) and \
        isinstance(node.func, ast.Attribute) and node.func.attr == "fail" \
        and isinstance(node.func.value, ast.Name) and \
        node.func.value.id == "fail"


def _static_sites(pkg: str) -> list:
    """(function, label) of every ``fail.fail()`` of the commit path, in
    source order."""
    out = []
    for rel, funcs in SITES:
        path = str(REPO / pkg / rel)
        tree = ast.parse(Path(path).read_text())
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and fn.name in funcs:
                calls = sorted((n.lineno for n in ast.walk(fn)
                                if _is_fail_call(n)))
                out += [(fn.name, _label(path, ln)) for ln in calls]
    return out


def test_the_port_has_the_jax_fail_points_in_the_jax_order():
    mine = _static_sites("cometbft_tpu_torch")
    theirs = _static_sites("cometbft_tpu")
    assert mine == theirs
    # the serial and the pipelined apply each hold one of the two
    # "applied" points; a height fires one of them
    assert len(mine) == N_FAIL_POINTS + 1
    assert all(label.startswith("crash point:") for _, label in mine)


class _Recorder:
    """Wraps a package's ``fail.fail`` to note each call site's label."""

    def __init__(self, mod, monkeypatch):
        self.labels = []
        real = mod.fail

        def fail():
            f = sys._getframe(1)
            self.labels.append(_label(f.f_code.co_filename, f.f_lineno))
            real()

        monkeypatch.setattr(mod, "fail", fail)


def _one_validator(pkg):
    """A one-validator ConsensusState of either package on MemDB stores."""
    if pkg == "port":
        pv = new_mock_pv()
        doc = GenesisDoc(
            chain_id="fail-chain", genesis_time=Timestamp(1700000000, 0),
            validators=[GenesisValidator(b"", pv.get_pub_key(), 10)])
        state = make_genesis_state(doc)
        store, blocks = Store(MemDB()), BlockStore(MemDB())
        store.save(state)
        ex = BlockExecutor(store, AppConns(KVStoreApplication()).consensus,
                           block_store=blocks, device="cpu")
        return ConsensusState(_test_config().consensus, state, ex, blocks,
                              priv_validator=pv, device="cpu")
    pv = r_new_mock_pv()
    doc = RGenesisDoc(
        chain_id="fail-chain", genesis_time=RTimestamp(1700000000, 0),
        validators=[RGenesisValidator(b"", pv.get_pub_key(), 10)])
    state = r_make_genesis_state(doc)
    store, blocks = RStore(RMemDB()), RBlockStore(RMemDB())
    store.save(state)
    ex = RBlockExecutor(store, RAppConns(RKVStore()).consensus,
                        block_store=blocks)
    return RConsensusState(r_test_config().consensus, state, ex, blocks,
                           priv_validator=pv)


async def _commit(cs, heights):
    await cs.start()
    try:
        for _ in range(1000):
            if cs.block_store.height >= heights:
                return
            await asyncio.sleep(0.01)
        raise AssertionError(f"height {cs.block_store.height}")
    finally:
        await cs.stop()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_each_height_fires_the_7_fail_points_in_order(pkg, monkeypatch):
    """``fail.reset()`` arms the counter without a target that fires;
    each committed height then counts 7 calls, whose labels follow the
    JAX package's order."""
    mod = p_fail if pkg == "port" else r_fail
    if pkg == "jax":
        r_batch.set_backend("cpu")
    rec = _Recorder(mod, monkeypatch)
    mod.reset(10 ** 9)
    try:
        asyncio.run(_commit(_one_validator(pkg), 3))
        count = mod.call_count()
    finally:
        mod.reset()
        r_batch.set_backend("auto")
        pipeline.reset_workers()
    assert count == len(rec.labels) >= 3 * N_FAIL_POINTS
    theirs = [label for _, label in _static_sites("cometbft_tpu")]
    # a height fires the pipelined "applied" point, not the serial one
    order = theirs[:3] + theirs[5:] + [theirs[4]]
    assert rec.labels[:3 * N_FAIL_POINTS] == order * 3


# ----------------------------------------------------------------------
# the node's own watch of its app (ROADMAP C.12)

def test_an_error_of_the_app_watch_is_the_nodes_failure(tmp_path):
    """The watch that turns a dead app connection into the node's
    failure runs under the node's supervisor: an error of the watch
    itself stops the node with that error, where a bare task would
    have died unseen and left the node running."""
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.node.node import Node, init_files

    cfg = Config()
    cfg.base.home = str(tmp_path)
    cfg.base.log_level = "error"
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.rpc.laddr = ""
    init_files(cfg, chain_id="watch")

    async def broken_watch():
        raise RuntimeError("the watch broke")

    async def go():
        node = Node(cfg, device="cpu")
        node.app_conns.wait_dead = broken_watch
        await node.start()
        try:
            with pytest.raises(RuntimeError, match="the watch broke"):
                await asyncio.wait_for(node.wait(), 10)
        finally:
            with pytest.raises(RuntimeError, match="the watch broke"):
                await node.stop()

    asyncio.run(go())
