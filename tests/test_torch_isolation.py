"""The port stands alone and runs on the card by default.

  * importing every module of cometbft_tpu_torch (in a fresh
    interpreter; the chain below consensus included: the block executor,
    the stores, the kvstore app, the state tree, the Handshaker; the
    consensus state machine: ConsensusState, the WAL, the round state,
    the ticker, adaptive timeouts, pubsub, the supervisor, the config,
    the host ed25519; and p2p with the consensus reactor: the p2p
    package, flowrate, the AEAD wrapper and its plain version) loads
    neither jax nor anything of cometbft_tpu;
  * importing the p2p stack and the reactor, and running a secret
    connection's handshake, loads no ``cryptography`` either: the port
    seals every frame in its own host library;
  * the entry points resolve ``device=None`` to CUDA and raise where
    CUDA is absent — no silent CPU fallback;
  * the kernel wrapper rejects wrong dtypes, shapes, devices and
    layouts before any pointer reaches native code.
"""
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import cometbft_tpu_torch
from cometbft_tpu_torch import device as pdevice
from cometbft_tpu_torch.crypto import batch as pbatch
from cometbft_tpu_torch.crypto import ed25519 as p_ed
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.types import validation as pv
from cometbft_tpu_torch.types.block_id import BlockID
from cometbft_tpu_torch.types.commit import Commit, CommitSig
from cometbft_tpu_torch.types.validator import Validator
from cometbft_tpu_torch.types.validator_set import ValidatorSet
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        cometbft_tpu_torch.__path__, "cometbft_tpu_torch."))


def test_port_imports_no_jax_and_no_reference():
    mods = _port_modules()
    assert "cometbft_tpu_torch.ops.ed25519_kernel" in mods
    assert {"cometbft_tpu_torch.light.client", "cometbft_tpu_torch.db.db",
            "cometbft_tpu_torch.types.evidence",
            "cometbft_tpu_torch.libs.log",
            "cometbft_tpu_torch.state.execution",
            "cometbft_tpu_torch.state.validation",
            "cometbft_tpu_torch.state.store",
            "cometbft_tpu_torch.store.store",
            "cometbft_tpu_torch.abci.kvstore",
            "cometbft_tpu_torch.abci.client",
            "cometbft_tpu_torch.statetree.tree",
            "cometbft_tpu_torch.consensus.replay",
            "cometbft_tpu_torch.types.genesis",
            "cometbft_tpu_torch.types.params"} <= set(mods)
    assert {"cometbft_tpu_torch.consensus.state",
            "cometbft_tpu_torch.consensus.wal",
            "cometbft_tpu_torch.consensus.round_state",
            "cometbft_tpu_torch.consensus.ticker",
            "cometbft_tpu_torch.consensus.adaptive",
            "cometbft_tpu_torch.consensus.metrics",
            "cometbft_tpu_torch.consensus.messages",
            "cometbft_tpu_torch.libs.pubsub",
            "cometbft_tpu_torch.libs.supervisor",
            "cometbft_tpu_torch.config",
            "cometbft_tpu_torch.types.events",
            "cometbft_tpu_torch.wire.consensus_pb",
            "cometbft_tpu_torch.crypto.benchmarking",
            "cometbft_tpu_torch.ops.ed25519_host"} <= set(mods)
    assert set(P2P_MODULES) <= set(mods)
    assert len(mods) >= 20
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'cometbft_tpu' or "
        "m.startswith('cometbft_tpu.'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


P2P_MODULES = ("cometbft_tpu_torch.p2p",
               "cometbft_tpu_torch.p2p.conn",
               "cometbft_tpu_torch.p2p.key",
               "cometbft_tpu_torch.p2p.metrics",
               "cometbft_tpu_torch.p2p.pex",
               "cometbft_tpu_torch.p2p.secret_connection",
               "cometbft_tpu_torch.p2p.switch",
               "cometbft_tpu_torch.consensus.reactor",
               "cometbft_tpu_torch.libs.flowrate",
               "cometbft_tpu_torch.ops.aead_host",
               "cometbft_tpu_torch.crypto._aead_ref")


def test_p2p_and_reactor_load_no_jax_reference_or_cryptography():
    code = (
        "import asyncio, importlib, sys\n"
        f"for m in {P2P_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from cometbft_tpu_torch.crypto import ed25519\n"
        "from cometbft_tpu_torch.p2p.secret_connection import "
        "SecretConnection\n"
        "async def go():\n"
        "    got = asyncio.Queue()\n"
        "    async def on_conn(r, w):\n"
        "        await got.put((r, w))\n"
        "    srv = await asyncio.start_server(on_conn, '127.0.0.1', 0)\n"
        "    cr, cw = await asyncio.open_connection(\n"
        "        '127.0.0.1', srv.sockets[0].getsockname()[1])\n"
        "    sr, sw = await got.get()\n"
        "    a, b = await asyncio.gather(\n"
        "        SecretConnection.make(cr, cw, ed25519.gen_priv_key()),\n"
        "        SecretConnection.make(sr, sw, ed25519.gen_priv_key()))\n"
        "    await a.write_msg(b'x' * 2000)\n"
        "    assert await b.read_msg() == b'x' * 2000\n"
        "    a.close(); b.close(); srv.close()\n"
        "asyncio.run(asyncio.wait_for(go(), 60))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'cometbft_tpu', 'cryptography'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_chip_smoke_imports_nothing_of_jax():
    src = (REPO / "chip_smoke.py").read_text()
    assert "import jax" not in src and "from jax" not in src
    assert "cometbft_tpu." not in src and "cometbft_tpu " not in src


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert pdevice.resolve(None) == torch.device("cuda")
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pdevice.resolve(None)
    assert pdevice.resolve("cpu") == torch.device("cpu")


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    priv = p_ed.Ed25519PrivKey(bytes(range(32)))
    item = (priv.pub_key().bytes(), b"m", priv.sign(b"m"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        oe.verify_batch([item])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pbatch.create_batch_verifier(priv.pub_key())
    vals = ValidatorSet([Validator.new(priv.pub_key(), 10)])
    commit = Commit(height=1, block_id=BlockID(b"h" * 32),
                    signatures=[CommitSig.absent()])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pv.verify_commit("c", vals, BlockID(b"h" * 32), 1, commit)


def test_consensus_state_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from cometbft_tpu_torch.abci.client import AppConns
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.config import ConsensusConfig
    from cometbft_tpu_torch.consensus.state import ConsensusState
    from cometbft_tpu_torch.db import MemDB
    from cometbft_tpu_torch.state import make_genesis_state
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.state.store import Store
    from cometbft_tpu_torch.store import BlockStore
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    priv = p_ed.Ed25519PrivKey(bytes(range(32)))
    doc = GenesisDoc(chain_id="c", validators=[
        GenesisValidator(b"", priv.pub_key(), 10)])
    state = make_genesis_state(doc)
    store, blocks = Store(MemDB()), BlockStore(MemDB())
    conns = AppConns(KVStoreApplication())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BlockExecutor(store, conns.consensus, block_store=blocks)
    exec_ = BlockExecutor(store, conns.consensus, block_store=blocks,
                          device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ConsensusState(ConsensusConfig(), state, exec_, blocks)
    cs = ConsensusState(ConsensusConfig(), state, exec_, blocks,
                        device="cpu")
    assert cs.device == torch.device("cpu")


def _cols(n=4, dtype=torch.int32):
    return (torch.zeros(32, n, dtype=dtype), torch.zeros(32, n, dtype=dtype),
            torch.zeros(64, n, dtype=dtype), torch.zeros(64, n, dtype=dtype))


@pytest.mark.parametrize("fault", ["dtype", "rows", "lanes", "layout",
                                   "not_tensor", "device"])
def test_wrapper_rejects_bad_inputs(fault):
    a, r, s, k = _cols()
    if fault == "dtype":
        a = a.long()
        exc = TypeError
    elif fault == "rows":
        r = torch.zeros(31, 4, dtype=torch.int32)
        exc = ValueError
    elif fault == "lanes":
        k = torch.zeros(64, 5, dtype=torch.int32)
        exc = ValueError
    elif fault == "layout":
        s = torch.zeros(4, 64, dtype=torch.int32).t()
        exc = ValueError
    elif fault == "not_tensor":
        a = a.numpy()
        exc = TypeError
    else:
        a, r, s, k = (t.to("meta") for t in (a, r, s, k))
        exc = ValueError
    before = ek.launches
    with pytest.raises(exc):
        ek.verify_cols(a, r, s, k)
    assert ek.launches == before


def test_wrapper_runs_plain_version_on_cpu_tensors():
    # all-zero columns: A = R = (sqrt(-1), 0), a point of order 4, and
    # s = k = 0, so [8](0·B - R - 0·A) is the identity -> valid
    before = ek.launches
    ok = ek.verify_cols(*_cols(2))
    assert ok.dtype == torch.bool and ok.tolist() == [True, True]
    assert ek.launches == before


def test_unsupported_key_type_rejected():
    class Other(p_ed.Ed25519PubKey):
        def type(self):
            return "secp256k1"

    with pytest.raises(ValueError, match="unsupported"):
        pbatch.create_batch_verifier(Other(bytes(32)), device="cpu")
    bv = pbatch.create_batch_verifier(
        p_ed.Ed25519PubKey(bytes(32)), device="cpu")
    with pytest.raises(ValueError, match="malformed"):
        bv.add(p_ed.Ed25519PubKey(bytes(32)), b"m", b"short")
