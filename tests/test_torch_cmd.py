"""The port's operator CLI (cometbft_tpu_torch/cmd/__main__.py) beside the
JAX package's, each through its own ``main([...])``:

  * ``testnet`` with seeded keys, a fixed clock and the same ports writes
    the JAX files byte for byte;
  * ``version``, ``init``, ``show-node-id``, ``show-validator``,
    ``gen-node-key``, ``unsafe-reset-all``, ``config validate|view|get|
    set|diff|migrate`` and ``generate-manifests`` print the same output
    and leave the same files (the home's path aside);
  * ``rollback`` and ``reindex-event`` on copies of one home a node ran
    give the same output;
  * ``load``, ``load-report`` and ``debug dump`` against a running port
    node give the same keys and files;
  * ``start`` without ``--device cpu`` stops where CUDA is absent, with
    the error on stderr; on a card (``cuda``-marked, skipped without one)
    ``testnet`` and four ``start`` processes commit.

Tolerance is equality, random ids aside.
"""
import asyncio
import hashlib
import itertools
import json
import os
import secrets
import shutil
import subprocess
import sys
import threading
import time

import pytest
import torch

import chip_smoke
from cometbft_tpu.cmd.__main__ import main as r_main
from cometbft_tpu_torch.cmd.__main__ import main as p_main
from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from torch_helpers import one_torch_thread  # noqa: F401

MAINS = {"port": p_main, "jax": r_main}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seeded(mp, seed):
    ctr = itertools.count()
    mp.setattr(secrets, "token_bytes", lambda n=32: hashlib.sha512(
        b"cmd/%d/%d" % (seed, next(ctr))).digest()[:n])
    mp.setattr(time, "time_ns", lambda: 1_700_000_000_000_000_011)


def _files(root) -> dict:
    out = {}
    for d, _, names in os.walk(root):
        for f in names:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _both(tmp_path, capsys, monkeypatch, argvs, seed=3, prepare=None):
    """Each package's main over ``argvs`` in a home of its own, seeded the
    same: [(rc, stdout with the home as HOME)] per package, and its
    files."""
    out = {}
    for name, main in MAINS.items():
        home = str(tmp_path / name)
        os.makedirs(home, exist_ok=True)
        if prepare is not None:
            prepare(home)
        rows = []
        with monkeypatch.context() as mp:
            _seeded(mp, seed)
            for argv in argvs:
                capsys.readouterr()
                rc = main([a.replace("HOME", home) for a in argv])
                got = capsys.readouterr()
                rows.append((rc, got.out.replace(home, "HOME"),
                             got.err.replace(home, "HOME")))
        out[name] = (rows, _files(home))
    return out


def test_testnet_writes_the_jax_files(tmp_path, capsys, monkeypatch):
    argv = ["testnet", "--v", "4", "--o", "HOME/net", "--chain-id", "tn",
            "--starting-p2p-port", "36656", "--starting-rpc-port", "36756"]
    out = _both(tmp_path, capsys, monkeypatch, [argv])
    assert out["port"] == out["jax"]
    rows, files = out["port"]
    assert rows[0][0] == 0 and len(files) == 4 * 5
    cfg = json.loads(files["net/node1/config/config.json"])
    assert cfg["p2p"]["laddr"] == "tcp://127.0.0.1:36657"
    assert cfg["rpc"]["laddr"] == "tcp://127.0.0.1:36757"
    assert cfg["p2p"]["persistent_peers"].count("@127.0.0.1:") == 3


def test_subcommands_print_the_jax_output(tmp_path, capsys, monkeypatch):
    argvs = [
        ["version"],
        ["--home", "HOME", "init", "--chain-id", "cli-chain"],
        ["--home", "HOME", "init"],
        ["--home", "HOME", "show-node-id"],
        ["--home", "HOME", "show-validator"],
        ["--home", "HOME", "gen-node-key"],
        ["--home", "HOME", "config", "validate"],
        ["--home", "HOME", "config", "set", "mempool.size", "2500"],
        ["--home", "HOME", "config", "set", "consensus.timeout_vote_ns",
         "250ms"],
        ["--home", "HOME", "config", "set", "mempool.size", "0"],
        ["--home", "HOME", "config", "set", "nope.size", "1"],
        ["--home", "HOME", "config", "get", "mempool.size"],
        ["--home", "HOME", "config", "get", "nope.size"],
        ["--home", "HOME", "config", "diff"],
        ["--home", "HOME", "config", "view"],
        ["--home", "HOME", "config", "migrate", "--dry-run"],
        ["--home", "HOME", "config", "migrate"],
        ["--home", "HOME", "config", "validate"],
        ["--home", "HOME", "unsafe-reset-all"],
        ["--home", "HOME", "generate-manifests", "-o", "HOME/mf", "-n", "3",
         "--seed", "5"],
    ]
    out = _both(tmp_path, capsys, monkeypatch, argvs)
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    rows = dict(zip(map(tuple, argvs), out["port"][0]))
    assert rows[("version",)][1].strip() == "1.0.0-tpu"
    assert rows[("--home", "HOME", "gen-node-key")][0] == 1
    assert rows[("--home", "HOME", "config", "get", "mempool.size")][1] \
        == "2500\n"


def _ran_home(tmp_path, monkeypatch):
    """A single-validator home the port's node ran to height 4 with txs."""
    from cometbft_tpu_torch import confix
    from cometbft_tpu_torch.node import Node, init_files

    def verify_cols(a, r, s, k):
        ek.launches += 1
        return torch.ones(a.shape[1], dtype=torch.bool)
    monkeypatch.setattr(ek, "verify_cols", verify_cols)
    home = str(tmp_path / "ran")
    cfg = confix.effective_config(home)
    cfg.rpc.laddr, cfg.p2p.laddr = "tcp://127.0.0.1:0", "tcp://127.0.0.1:0"
    cfg.base.log_level = "error"
    init_files(cfg, chain_id="ran-chain")

    async def go():
        node = Node(cfg, device="cpu")
        await node.start()
        try:
            for i in range(6):
                await node.mempool.check_tx(b"k%d=v%d" % (i, i))
            while node.height < 4:
                node.raise_if_failed()
                await asyncio.sleep(0.01)
        finally:
            await node.stop()
    asyncio.run(go())
    pipeline.reset_workers()
    return home


def test_rollback_and_reindex_equal_the_jax_ones(tmp_path, capsys,
                                                 monkeypatch):
    src = _ran_home(tmp_path, monkeypatch)

    def prepare(home):
        shutil.rmtree(home)
        shutil.copytree(src, home)
    out = _both(tmp_path, capsys, monkeypatch, [
        ["--home", "HOME", "reindex-event"],
        ["--home", "HOME", "reindex-event", "--start-height", "2",
         "--end-height", "3"],
        ["--home", "HOME", "rollback"],
        ["--home", "HOME", "rollback", "--hard"],
    ], prepare=prepare)
    assert out["port"][0] == out["jax"][0]
    rows = out["port"][0]
    assert all(rc == 0 for rc, _, _ in rows), rows
    assert rows[0][1].startswith("reindexed ")
    assert rows[2][1].startswith("Rolled back state to height ")


def test_load_report_and_debug_dump_against_a_node(tmp_path, capsys,
                                                   monkeypatch):
    from cometbft_tpu_torch import confix
    from cometbft_tpu_torch.node import Node, init_files

    def verify_cols(a, r, s, k):
        ek.launches += 1
        return torch.ones(a.shape[1], dtype=torch.bool)
    monkeypatch.setattr(ek, "verify_cols", verify_cols)
    home = str(tmp_path / "served")
    cfg = confix.effective_config(home)
    cfg.rpc.laddr, cfg.p2p.laddr = "tcp://127.0.0.1:0", "tcp://127.0.0.1:0"
    cfg.base.log_level = "error"
    init_files(cfg, chain_id="served-chain")
    ready, done = threading.Event(), threading.Event()
    box = {}

    def serve():
        async def go():
            node = Node(cfg, device="cpu")
            await node.start()
            box["url"] = f"http://{node._rpc_server.listen_addr}"
            ready.set()
            try:
                while not done.is_set():
                    node.raise_if_failed()
                    await asyncio.sleep(0.02)
            finally:
                await node.stop()
        try:
            asyncio.run(go())
        except BaseException as e:   # noqa: BLE001 — re-raised below
            box["error"] = e
            ready.set()
    t = threading.Thread(target=serve)
    t.start()
    try:
        assert ready.wait(60) and "error" not in box, box
        url = box["url"]
        out = {}
        for name, main in MAINS.items():
            capsys.readouterr()
            assert main(["load", "--endpoints", url, "--rate", "20",
                         "--duration", "0.5", "--size", "64"]) == 0
            res = json.loads(capsys.readouterr().out.splitlines()[-1])
            time.sleep(0.3)
            assert main(["load-report", "--endpoint", url,
                         "--experiment-id", res["experiment_id"]]) == 0
            rep = json.loads(capsys.readouterr().out)
            dump = str(tmp_path / f"dump-{name}")
            assert main(["debug", "dump", dump, "--rpc-laddr", url]) == 0
            line = capsys.readouterr().out.replace(dump, "DIR")
            out[name] = (sorted(res), res["accepted"] > 0, sorted(rep),
                         rep["experiment_id"] == res["experiment_id"],
                         sorted(os.listdir(dump)), line)
        assert out["port"] == out["jax"]
        assert out["port"][1] and out["port"][3]
    finally:
        done.set()
        t.join(60)
        pipeline.reset_workers()
    assert "error" not in box, box


def test_start_without_a_device_stops_without_cuda(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    home = str(tmp_path / "h")
    assert p_main(["--home", home, "init", "--chain-id", "nodev"]) == 0
    capsys.readouterr()
    assert p_main(["--home", home, "start"]) == 1
    err = capsys.readouterr().err
    assert "node stopped: RuntimeError: CUDA is not available" in err
    assert not os.path.exists(os.path.join(home, "data", "blockstore.db"))


@pytest.mark.cuda
def test_testnet_of_four_start_processes_commits_on_the_card(tmp_path):
    """BASELINE.json config 1 through the CLI on the card: ``testnet --v
    4`` and four ``start`` processes with no ``--device`` commit 5 heights
    and stop with 0 on SIGTERM."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from cometbft_tpu_torch.rpc.client import HTTPClient
    p2p, rpc = chip_smoke._free_port_base(4), chip_smoke._free_port_base(4)
    out = str(tmp_path / "net")
    assert p_main(["testnet", "--v", "4", "--o", out, "--starting-p2p-port",
                   str(p2p), "--starting-rpc-port", str(rpc)]) == 0
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cometbft_tpu_torch.cmd", "--home",
         os.path.join(out, f"node{i}"), "start"], cwd=REPO,
        stderr=subprocess.DEVNULL) for i in range(4)]
    try:
        async def heights():
            return [int((await HTTPClient(f"http://127.0.0.1:{rpc + i}")
                         .status())["sync_info"]["latest_block_height"])
                    for i in range(4)]
        deadline = time.time() + 180
        while True:
            try:
                if min(asyncio.run(heights())) >= 5:
                    break
            except OSError:
                pass
            assert time.time() < deadline and all(
                p.poll() is None for p in procs)
            time.sleep(0.5)
    finally:
        for p in procs:
            p.terminate()
        codes = [p.wait(60) for p in procs]
    assert codes == [0, 0, 0, 0]
