"""The port stands alone and runs on the card by default.

  * importing every module of cometbft_tpu_torch (in a fresh
    interpreter; the chain below consensus included: the block executor,
    the stores, the kvstore app, the state tree, the Handshaker; the
    consensus state machine: ConsensusState, the WAL, the round state,
    the ticker, adaptive timeouts, pubsub, the supervisor, the config,
    the host ed25519; p2p with the consensus reactor: the p2p
    package, flowrate, the AEAD wrapper and its plain version; block
    sync, the evidence pool and reactor, the mempool with its messages,
    reactor and metrics, the node provider and the load generator's
    payloads; state sync's syncer, reactor and metrics, the pruner and
    rollback, with the stores, the state tree and the kvstore they
    extend; privval's FilePV and remote signer, the kv indexers and
    their service, the RPC server, routes, WebSocket and client, the
    HTTP provider, the RPC state provider, the load generator and the
    flight recorder the trace route reads; the lightserve cache and
    routes, the state tree's proofs, the state proof check and the light
    proxy; the ABCI socket protocol, server, clients, metrics, grammar
    and CLI, the gRPC transports and the companion services, the SQL
    sink, armor, protoio, service, health and pprof; the node, the CLI,
    confix, the manifest runner and the fuzzed connection; the QA tool,
    the fuzzer, the fleet analysis, the mesh split and tally and the
    sharding report; the modules that took the JAX package's last public
    names: the package root and version, the golden model, the batch
    seam, the key types, the stores, bits, the logger, the light client,
    the mempool, the field, the executor, the block types, tx proofs and
    the wire descriptors) loads neither jax nor anything of cometbft_tpu; the
    testnet tools and the mesh load no psutil and nothing of the
    repository's root ``tools/`` either, and ``make_mesh()`` raises
    without CUDA;
  * the record readers (the trace report, the fleet report, the metrics
    catalog) load none of those nor the root ``tools/``, and the trace
    and fleet reports no torch;
  * the port's fault harnesses (tests/torch_nemesis.py and
    tests/torch_crash_driver.py) import neither jax nor the JAX package;
  * only the three gRPC transports import ``grpc``: with it unimportable
    (the card's machine has no grpcio) every other module and
    chip_smoke.py load;
  * importing the p2p stack and the reactor, and running a secret
    connection's handshake, loads no ``cryptography`` either: the port
    seals every frame in its own host library;
  * the entry points resolve ``device=None`` to CUDA and raise where
    CUDA is absent — no silent CPU fallback; a light client over
    HttpProviders, ``new_rpc_state_provider``, the light proxy and the
    Node included;
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
    assert set(SYNC_MODULES) <= set(mods)
    assert set(STATESYNC_MODULES) <= set(mods)
    assert set(RPC_MODULES) <= set(mods)
    assert set(LIGHTSERVE_MODULES) <= set(mods)
    assert set(ABCI_MODULES) <= set(mods)
    assert set(GRPC_TRANSPORTS) <= set(mods)
    assert set(NODE_MODULES) <= set(mods)
    assert set(TESTNET_MODULES) <= set(mods)
    assert set(READER_MODULES) <= set(mods)
    assert "cometbft_tpu_torch.tools.benchmarks" in mods
    assert set(API_MODULES) <= set(mods)
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


# the modules that took the JAX package's last public names (the guard:
# tests/test_torch_api_parity.py)
API_MODULES = ("cometbft_tpu_torch.version",
               "cometbft_tpu_torch.crypto._ed25519_ref",
               "cometbft_tpu_torch.crypto.batch",
               "cometbft_tpu_torch.crypto.bls12381",
               "cometbft_tpu_torch.crypto.keys",
               "cometbft_tpu_torch.crypto.secp256k1eth",
               "cometbft_tpu_torch.db.db",
               "cometbft_tpu_torch.libs.bits",
               "cometbft_tpu_torch.libs.log",
               "cometbft_tpu_torch.light.client",
               "cometbft_tpu_torch.mempool.mempool",
               "cometbft_tpu_torch.ops.field",
               "cometbft_tpu_torch.state.execution",
               "cometbft_tpu_torch.types.block",
               "cometbft_tpu_torch.types.block_id",
               "cometbft_tpu_torch.types.timestamp",
               "cometbft_tpu_torch.types.tx",
               "cometbft_tpu_torch.types.validator_set",
               "cometbft_tpu_torch.wire.pb",
               "cometbft_tpu_torch.wire.proto",
               "cometbft_tpu_torch.tools.qa")


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


SYNC_MODULES = ("cometbft_tpu_torch.blocksync",
                "cometbft_tpu_torch.blocksync.metrics",
                "cometbft_tpu_torch.blocksync.pool",
                "cometbft_tpu_torch.blocksync.reactor",
                "cometbft_tpu_torch.evidence",
                "cometbft_tpu_torch.evidence.pool",
                "cometbft_tpu_torch.evidence.reactor",
                "cometbft_tpu_torch.mempool",
                "cometbft_tpu_torch.mempool.mempool",
                "cometbft_tpu_torch.mempool.messages",
                "cometbft_tpu_torch.mempool.metrics",
                "cometbft_tpu_torch.mempool.reactor",
                "cometbft_tpu_torch.light.provider",
                "cometbft_tpu_torch.tools.loadtime")


STATESYNC_MODULES = ("cometbft_tpu_torch.statesync",
                     "cometbft_tpu_torch.statesync.metrics",
                     "cometbft_tpu_torch.statesync.reactor",
                     "cometbft_tpu_torch.statesync.syncer",
                     "cometbft_tpu_torch.state.pruner",
                     "cometbft_tpu_torch.state.rollback",
                     "cometbft_tpu_torch.state.store",
                     "cometbft_tpu_torch.state.metrics",
                     "cometbft_tpu_torch.store.store",
                     "cometbft_tpu_torch.statetree.tree",
                     "cometbft_tpu_torch.abci.kvstore",
                     "cometbft_tpu_torch.config")


RPC_MODULES = ("cometbft_tpu_torch.privval",
               "cometbft_tpu_torch.privval.file",
               "cometbft_tpu_torch.privval.signer",
               "cometbft_tpu_torch.wire.privval_pb",
               "cometbft_tpu_torch.crypto.encoding",
               "cometbft_tpu_torch.indexer",
               "cometbft_tpu_torch.indexer.kv",
               "cometbft_tpu_torch.indexer.service",
               "cometbft_tpu_torch.rpc",
               "cometbft_tpu_torch.rpc.client",
               "cometbft_tpu_torch.rpc.core",
               "cometbft_tpu_torch.rpc.server",
               "cometbft_tpu_torch.rpc.ws",
               "cometbft_tpu_torch.light.provider",
               "cometbft_tpu_torch.statesync.syncer",
               "cometbft_tpu_torch.libs.tracing",
               "cometbft_tpu_torch.libs.metrics",
               "cometbft_tpu_torch.state.pruner",
               "cometbft_tpu_torch.tools.loadtime",
               "cometbft_tpu_torch.config")


LIGHTSERVE_MODULES = ("cometbft_tpu_torch.lightserve",
                      "cometbft_tpu_torch.lightserve.cache",
                      "cometbft_tpu_torch.lightserve.core",
                      "cometbft_tpu_torch.statetree.proof",
                      "cometbft_tpu_torch.light.state_proof",
                      "cometbft_tpu_torch.light.proxy")


ABCI_MODULES = ("cometbft_tpu_torch.abci.pb",
                "cometbft_tpu_torch.abci.server",
                "cometbft_tpu_torch.abci.client",
                "cometbft_tpu_torch.abci.metrics",
                "cometbft_tpu_torch.abci.grammar",
                "cometbft_tpu_torch.abci.cli",
                "cometbft_tpu_torch.wire.abci_pb",
                "cometbft_tpu_torch.rpc.grpc",
                "cometbft_tpu_torch.rpc.grpc.pb",
                "cometbft_tpu_torch.rpc.grpc.services",
                "cometbft_tpu_torch.state.pruner",
                "cometbft_tpu_torch.indexer.sink_sql",
                "cometbft_tpu_torch.crypto.armor",
                "cometbft_tpu_torch.libs.protoio",
                "cometbft_tpu_torch.libs.service",
                "cometbft_tpu_torch.libs.health",
                "cometbft_tpu_torch.libs.pprof",
                "cometbft_tpu_torch.privval.signer")

NODE_MODULES = ("cometbft_tpu_torch.node",
                "cometbft_tpu_torch.node.node",
                "cometbft_tpu_torch.cmd",
                "cometbft_tpu_torch.cmd.__main__",
                "cometbft_tpu_torch.config",
                "cometbft_tpu_torch.confix",
                "cometbft_tpu_torch.tools.manifest",
                "cometbft_tpu_torch.p2p.fuzz")
TESTNET_MODULES = ("cometbft_tpu_torch.tools.qa",
                   "cometbft_tpu_torch.tools.fuzz",
                   "cometbft_tpu_torch.tools.fleet_report",
                   "cometbft_tpu_torch.parallel",
                   "cometbft_tpu_torch.parallel.mesh",
                   "cometbft_tpu_torch.parallel.report")
# the only modules of the port that import grpc
GRPC_TRANSPORTS = ("cometbft_tpu_torch.abci.grpc",
                   "cometbft_tpu_torch.rpc.grpc.client",
                   "cometbft_tpu_torch.rpc.grpc.server")


def test_abci_and_companion_load_no_jax_or_reference():
    """The socket protocol, its server, clients, metrics, grammar and CLI,
    the companion services' bodies, the pruner, the SQL sink, armor and
    the small libraries, imported in a fresh interpreter, load nothing of
    jax, of the JAX package, of ``cryptography`` or of ``grpc``."""
    code = (
        "import importlib, sys\n"
        f"for m in {ABCI_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'cometbft_tpu', 'cryptography', 'grpc'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_node_and_cli_load_no_jax_reference_or_grpc():
    """The node, the CLI, the config and confix, the manifest runner and
    the fuzzed connection, imported in a fresh interpreter with ``grpc``
    unimportable, load nothing of jax, of the JAX package, of
    ``cryptography`` or of ``grpc``; the CLI answers ``version`` and
    ``--help`` there."""
    code = (
        "import importlib, sys\n"
        "sys.modules['grpc'] = None\n"
        f"for m in {NODE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from cometbft_tpu_torch.cmd.__main__ import main\n"
        "assert main(['version']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'cometbft_tpu', 'cryptography') or (m.startswith('grpc') "
        "and sys.modules[m] is not None))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert out.stdout.strip().splitlines()[0] == "1.0.0-tpu"
    out = subprocess.run([sys.executable, "-m", "cometbft_tpu_torch.cmd",
                          "--help"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "testnet" in out.stdout, out.stderr


def test_testnet_tools_and_mesh_load_no_jax_reference_or_psutil():
    """The QA tool, the fuzzer, the fleet analysis, the mesh split and
    tally and the sharding report, imported in a fresh interpreter with
    ``psutil`` and ``grpc`` unimportable (the card's machine has
    neither), load nothing of jax, of the JAX package, of psutil or of
    the repository's root ``tools/``; none of their sources imports
    them."""
    code = (
        "import importlib, sys\n"
        "sys.modules['psutil'] = None\n"
        "sys.modules['grpc'] = None\n"
        f"for m in {TESTNET_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'cometbft_tpu', 'tools') or (m.split('.')[0] in "
        "('psutil', 'grpc') and sys.modules[m] is not None))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    root = REPO / "cometbft_tpu_torch"
    for path in [root / "tools" / f"{m}.py" for m in
                 ("qa", "fuzz", "fleet_report")] + \
            list((root / "parallel").glob("*.py")):
        assert not _imports_of(path) & {"jax", "cometbft_tpu", "psutil",
                                        "tools"}, path
        text = path.read_text()
        assert "spec_from_file_location" not in text, path


READER_MODULES = ("cometbft_tpu_torch.tools.trace_report",
                  "cometbft_tpu_torch.tools.fleet_report",
                  "cometbft_tpu_torch.tools.metrics_catalog")


def test_record_readers_load_no_jax_reference_or_root_tools():
    """The three record readers, imported in a fresh interpreter with
    ``psutil`` and ``grpc`` unimportable, load nothing of jax, of the JAX
    package or of the repository's root ``tools/``; the trace and fleet
    reports load no torch either (they read JSON), and the catalog builds
    there.  None of their sources imports those packages or loads a file
    by path; tests/torch_exposition.py and tests/torch_catalog.py, which
    chip_smoke.py's phase 23 imports on the card, import neither jax nor
    the JAX package."""
    code = (
        "import sys\n"
        "sys.modules['psutil'] = None\n"
        "sys.modules['grpc'] = None\n"
        "import cometbft_tpu_torch.tools.trace_report\n"
        "import cometbft_tpu_torch.tools.fleet_report\n"
        "print('torch' in sys.modules)\n"
        "from cometbft_tpu_torch.tools import metrics_catalog\n"
        "print(len(metrics_catalog.collect_catalog()))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'cometbft_tpu', 'tools') or (m.split('.')[0] in "
        "('psutil', 'grpc') and sys.modules[m] is not None))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "110", "[]"]
    tools = REPO / "cometbft_tpu_torch" / "tools"
    paths = [tools / f"{m.rsplit('.', 1)[1]}.py" for m in READER_MODULES]
    for path in paths:
        assert not _imports_of(path) & {"jax", "cometbft_tpu", "psutil",
                                        "tools", "grpc"}, path
        assert "spec_from_file_location" not in path.read_text(), path
    for name in ("torch_exposition.py", "torch_catalog.py"):
        assert not _imports_of(REPO / "tests" / name) & {"jax",
                                                         "cometbft_tpu"}


def test_benchmarks_runner_loads_alone_and_needs_the_card():
    """The BASELINE configs' runner, imported in a fresh interpreter with
    ``psutil`` and ``grpc`` unimportable, loads nothing of jax, of the JAX
    package or of the root ``tools/``; run as a module where CUDA is
    absent it exits non-zero and prints no result line."""
    code = (
        "import sys\n"
        "sys.modules['psutil'] = None\n"
        "sys.modules['grpc'] = None\n"
        "import cometbft_tpu_torch.tools.benchmarks\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'cometbft_tpu', 'tools') or (m.split('.')[0] in "
        "('psutil', 'grpc') and sys.modules[m] is not None))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    path = REPO / "cometbft_tpu_torch" / "tools" / "benchmarks.py"
    assert not _imports_of(path) & {"jax", "cometbft_tpu", "psutil",
                                    "tools"}
    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "-m", "cometbft_tpu_torch.tools.benchmarks",
         "--config", "2"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA is not available" in out.stderr


def test_make_mesh_raises_without_cuda():
    """The mesh's default is the card: without CUDA it raises; the CPU
    entries are the tests' only way in."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from cometbft_tpu_torch.parallel import mesh
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.make_mesh(2)
    assert mesh.make_mesh(2, device="cpu") == [torch.device("cpu")] * 2


def test_node_raises_without_cuda(tmp_path):
    """``Node`` left at device=None raises where CUDA is absent, at
    construction, before it opens a store; device="cpu" builds it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.node import Node, init_files
    cfg = Config()
    cfg.base.home = str(tmp_path)
    init_files(cfg, chain_id="iso")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Node(cfg)
    assert not (tmp_path / "data" / "blockstore.db").exists()
    assert Node(cfg, device="cpu").device == torch.device("cpu")


def test_port_loads_without_grpc():
    """With ``grpc`` unimportable (the card's machine has no grpcio), every
    module of the port but the three gRPC transports imports, the
    companion servicers included, and so do chip_smoke.py and its
    imports; the transports fail on ``grpc`` alone."""
    mods = [m for m in _port_modules() if m not in GRPC_TRANSPORTS]
    code = (
        "import importlib, sys\n"
        "sys.modules['grpc'] = None\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "failed = []\n"
        f"for m in {GRPC_TRANSPORTS!r}:\n"
        "    try:\n"
        "        importlib.import_module(m)\n"
        "    except ImportError as e:\n"
        "        failed.append(e.name)\n"
        "print(failed)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['grpc', 'grpc', 'grpc']"


def _imports_of(path):
    import ast
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module:
            names.add(node.module.split(".")[0])
    return names


def test_only_the_grpc_transports_import_grpc():
    root = REPO / "cometbft_tpu_torch"
    importers = sorted(
        "cometbft_tpu_torch." + ".".join(
            p.relative_to(root).with_suffix("").parts)
        for p in root.rglob("*.py") if "grpc" in _imports_of(p))
    assert importers == sorted(GRPC_TRANSPORTS)
    assert "grpc" not in _imports_of(REPO / "chip_smoke.py")


def test_lightserve_loads_no_jax_or_reference():
    """The lightserve cache and routes, the state tree's proofs, the state
    proof check and the light proxy, imported in a fresh interpreter,
    load nothing of jax, of the JAX package or of ``cryptography``."""
    code = (
        "import importlib, sys\n"
        f"for m in {LIGHTSERVE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'cometbft_tpu', 'cryptography'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_light_proxy_raises_without_cuda():
    """``LightProxy`` left at device=None raises where CUDA is absent, at
    construction, before any request leaves; device="cpu" builds it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from cometbft_tpu_torch.light.proxy import LightProxy
    args = ("c", "http://127.0.0.1:1", [], 1, b"h" * 32,
            "tcp://127.0.0.1:0")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LightProxy(*args)
    assert LightProxy(*args, device="cpu").device == torch.device("cpu")


def test_privval_indexer_and_rpc_load_no_jax_or_reference():
    """privval, the indexers, the RPC server, routes, WebSocket and
    client, the HTTP provider, the RPC state provider and the load
    generator, imported in a fresh interpreter, load nothing of jax, of
    the JAX package or of ``cryptography``."""
    code = (
        "import importlib, sys\n"
        f"for m in {RPC_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'cometbft_tpu', 'cryptography'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_statesync_and_pruning_load_no_jax_or_reference():
    """State sync, the pruner, rollback and the stores, tree and kvstore
    they extend, imported in a fresh interpreter, load nothing of jax, of
    the JAX package or of ``cryptography``."""
    code = (
        "import importlib, sys\n"
        f"for m in {STATESYNC_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'cometbft_tpu', 'cryptography'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sync_evidence_and_mempool_load_no_jax_or_reference():
    """The modules of block sync, evidence and the mempool, imported in a
    fresh interpreter, load nothing of jax or of the JAX package (the
    mempool's short ids use hashlib, not the JAX package's native
    hashes)."""
    code = (
        "import importlib, sys\n"
        f"for m in {SYNC_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'cometbft_tpu', 'cryptography'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


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


def test_fault_harnesses_import_nothing_of_jax_or_the_reference():
    """tests/torch_nemesis.py and tests/torch_crash_driver.py (which the
    card runs too, from chip_smoke.py's phase 22) name neither ``jax``
    nor the JAX package in any import, nested ones included; imported
    in a fresh interpreter with the modules the crash driver's node
    loads, they load nothing of either."""
    harnesses = [REPO / "tests" / f for f in
                 ("torch_nemesis.py", "torch_crash_driver.py")]
    for path in harnesses:
        assert not _imports_of(path) & {"jax", "cometbft_tpu"}, path
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tests')\n"
        "import torch_nemesis, torch_crash_driver\n"
        "import cometbft_tpu_torch.node.node, cometbft_tpu_torch.privval\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'cometbft_tpu'))\n"
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


def test_sync_entry_points_raise_without_cuda():
    """BlocksyncReactor and EvidencePool resolve device=None to CUDA and
    raise where it is absent; device="cpu" builds them."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from cometbft_tpu_torch.blocksync import BlocksyncReactor
    from cometbft_tpu_torch.db import MemDB
    from cometbft_tpu_torch.evidence import EvidencePool
    from cometbft_tpu_torch.state.store import Store
    from cometbft_tpu_torch.store import BlockStore
    store, blocks = Store(MemDB()), BlockStore(MemDB())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BlocksyncReactor(None, None, blocks, active=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EvidencePool(MemDB(), store, blocks)
    assert BlocksyncReactor(None, None, blocks, active=True,
                            device="cpu").device == torch.device("cpu")
    assert EvidencePool(MemDB(), store, blocks,
                        device="cpu").device == torch.device("cpu")


def test_state_sync_raises_without_cuda():
    """A state sync whose light client is left at device=None raises
    where CUDA is absent: the client resolves its device when it is
    built, before any snapshot is offered; device="cpu" builds it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from cometbft_tpu_torch.db import MemDB
    from cometbft_tpu_torch.light.client import Client, TrustOptions
    from cometbft_tpu_torch.light.provider import NodeProvider
    from cometbft_tpu_torch.light.store import TrustedStore
    from cometbft_tpu_torch.state.store import Store
    from cometbft_tpu_torch.statesync import StateProvider
    from cometbft_tpu_torch.store import BlockStore
    provider = NodeProvider(BlockStore(MemDB()), Store(MemDB()), "c")
    trust = TrustOptions(period_ns=10**9, height=1, header_hash=b"h" * 32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StateProvider(Client("c", trust, provider, [],
                             TrustedStore(MemDB())), "c", None)
    client = Client("c", trust, provider, [], TrustedStore(MemDB()),
                    device="cpu")
    assert StateProvider(client, "c", None).light_client.device == \
        torch.device("cpu")


def test_rpc_light_client_and_state_provider_raise_without_cuda():
    """A light client over HttpProviders and ``new_rpc_state_provider``
    left at device=None raise where CUDA is absent, before any request
    leaves; device="cpu" builds the client."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import asyncio
    from cometbft_tpu_torch.db import MemDB
    from cometbft_tpu_torch.light.client import Client, TrustOptions
    from cometbft_tpu_torch.light.provider import HttpProvider
    from cometbft_tpu_torch.light.store import TrustedStore
    from cometbft_tpu_torch.statesync.syncer import new_rpc_state_provider
    primary = HttpProvider("http://127.0.0.1:1", "c")
    trust = TrustOptions(period_ns=10**9, height=1, header_hash=b"h" * 32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Client("c", trust, primary, [], TrustedStore(MemDB()))
    assert Client("c", trust, primary, [], TrustedStore(MemDB()),
                  device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        asyncio.run(new_rpc_state_provider(
            "c", None, ["http://127.0.0.1:1"], 1, b"h" * 32))


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
