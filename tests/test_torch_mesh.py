"""The port's mesh split and tally (cometbft_tpu_torch/parallel/) against
the JAX package's (cometbft_tpu/parallel/mesh.py), on the CPU.

The JAX mesh tests need a JAX kernel on a virtual mesh and are ``slow``
(tests/test_ops_ed25519.py), so parity runs through the padding
arithmetic and the golden model:

  * ``padded_lanes`` / ``PipelinePartitioner._padded`` equal the JAX
    ``PipelinePartitioner._padded`` on a grid of m, ndev and block,
    called on a stub (no JAX mesh is built);
  * ``verify_sharded`` over 4 CPU entries (B1's plain version on each
    shard) equals the JAX golden model's mask on mixed lanes: a bad S,
    S = 0, a tampered message, a malformed lane;
  * one kernel call a shard, equal shards, padding sliced off;
  * ``sharded_verify_tally`` in 4 gloo processes: each rank's shard and
    a count equal to the sum, one all_reduce a rank;
  * the report counts 0 collectives on the verify path and 1 on the
    tally, and writes no timing without a card;
  * several shards on one numbered card launch B1 once a shard (marked
    ``cuda``; skips here).
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import _ed25519_ref as r_ref
from cometbft_tpu.parallel import mesh as r_mesh
from cometbft_tpu_torch.crypto import _ed25519_ref as ref
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.parallel import mesh
from cometbft_tpu_torch.parallel import report
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("block", [0, 16, 128])
@pytest.mark.parametrize("ndev", [1, 2, 3, 4, 8])
def test_padding_is_the_jax_arithmetic(ndev, block):
    stub = SimpleNamespace(ndev=ndev, block=block)
    for m in (1, 2, 15, 16, 17, 63, 64, 1000, 1023, 1024, 4096, 10000,
              10240, 10241):
        want = r_mesh.PipelinePartitioner._padded(stub, m)
        assert mesh.padded_lanes(m, ndev, block) == want
        assert mesh.PipelinePartitioner._padded(stub, m) == want
        assert want % ndev == 0 and want >= m
        if block:
            assert (want // ndev) % block == 0


def _mixed(n):
    """n lanes: good ones and, by index, a bad S (>= L), S = 0, a
    tampered message and a malformed public key."""
    items = []
    for i in range(n):
        seed = bytes([i + 1]) * 32
        msg = b"mesh-%d" % i
        pub, sig = ref.public_key(seed), ref.sign(seed, msg)
        kind = i % 5
        if kind == 1:
            sig = sig[:32] + ref.L.to_bytes(32, "little")
        elif kind == 2:
            sig = sig[:32] + bytes(32)
        elif kind == 3:
            msg += b"!"
        elif kind == 4 and i % 2:
            pub = pub[:31]
        items.append((pub, msg, sig))
    return items


def _golden(items):
    return [len(p) == 32 and len(s) == 64 and r_ref.verify(p, m, s)
            for p, m, s in items]


def test_verify_sharded_on_four_cpu_entries_is_the_golden_mask():
    items = _mixed(13)
    a, r, s, k, pre_bad = oe.prep_arrays(items, 13)
    ok = mesh.verify_sharded(a, r, s, k, ndev=4, device="cpu")
    assert ok.shape == (13,)
    ok[pre_bad] = False
    want = _golden(items)
    assert ok.tolist() == want
    assert True in want and False in want


def test_one_kernel_call_a_shard():
    calls = []

    def verify_cols(a, r, s, k):
        calls.append((a.shape, s.shape, a.device.type))
        return torch.arange(a.shape[1]) % 3 != 0

    kernel = SimpleNamespace(verify_cols=verify_cols)
    items = _mixed(37)
    a, r, s, k, _pre_bad = oe.prep_arrays(items, 37)
    ok = mesh.verify_sharded(a, r, s, k, ndev=3, device="cpu", kernel=kernel)
    # 37 lanes over 3 shards of 16 (one B1 block each), 11 padding lanes
    assert calls == [((32, 16), (64, 16), "cpu")] * 3
    assert ok.tolist() == [i % 16 % 3 != 0 for i in range(37)]


@pytest.mark.parametrize("ndev,m", [(2, 33), (3, 50), (8, 70)])
def test_uneven_lanes_split_into_equal_shards(ndev, m):
    """m lanes that are no whole number of blocks a shard: each shard
    is the same whole number of blocks, the rows land in lane order,
    the padding is zero and sliced off, and the mask is the golden one."""
    seen = []
    plain = oe.KERNELS["cuda"]

    def verify_cols(a, r, s, k):
        seen.append(torch.cat([a, r, s, k]).clone())
        return plain.verify_cols(a, r, s, k)

    items = _mixed(m)
    a, r, s, k, pre_bad = oe.prep_arrays(items, m)
    ok = mesh.verify_sharded(a, r, s, k, ndev=ndev, device="cpu",
                             kernel=SimpleNamespace(verify_cols=verify_cols))
    shard = mesh.padded_lanes(m, ndev) // ndev
    assert len(seen) == ndev
    assert all(x.shape == (192, shard) for x in seen)
    cols = torch.cat(seen, dim=1)
    want_rows = torch.as_tensor(np.concatenate([a, r, s, k], 1)).T
    assert torch.equal(cols[:, :m], want_rows)
    assert not cols[:, m:].any()
    assert ok.shape == (m,)
    ok[pre_bad] = False
    assert ok.tolist() == _golden(items)


def test_make_mesh_on_the_cpu():
    assert mesh.make_mesh(4, "cpu") == [torch.device("cpu")] * 4
    assert mesh.make_mesh(None, "cpu") == [torch.device("cpu")]


TALLY = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.parallel import mesh
rank, world, port, items_path, out = sys.argv[1:]
rank, world = int(rank), int(world)
items = [tuple(bytes.fromhex(x) for x in it)
         for it in json.load(open(items_path))]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=world, rank=rank)
a, r, s, k, pre_bad = oe.prep_arrays(items, len(items))
ok, count = mesh.sharded_verify_tally(device="cpu")(a, r, s, k,
                                                    pre_bad=pre_bad)
json.dump({"ok": ok.tolist(), "count": count,
           "all_reduce": mesh.collectives["all_reduce"]}, open(out, "w"))
dist.destroy_process_group()
"""


def test_tally_in_four_gloo_processes(tmp_path):
    items = _mixed(64)
    path = tmp_path / "items.json"
    path.write_text(json.dumps([[x.hex() for x in it] for it in items]))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep +
           os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", TALLY, str(rank), "4", str(port), str(path),
         str(tmp_path / f"rank{rank}.json")], env=env, cwd=str(REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(4)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out
    golden = _golden(items)
    for rank in range(4):
        got = json.loads((tmp_path / f"rank{rank}.json").read_text())
        assert got["ok"] == golden[16 * rank:16 * (rank + 1)]
        assert got["count"] == sum(golden)
        assert got["all_reduce"] == 1


def test_tally_needs_equal_shards(monkeypatch):
    import torch.distributed as dist
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    step = mesh.sharded_verify_tally(device="cpu")
    rows = [np.zeros((3, w), np.uint8) for w in (32, 32, 64, 64)]
    with pytest.raises(ValueError, match="3 lanes do not split over 2"):
        step(*rows)


def test_report_counts_the_collectives(tmp_path):
    out = tmp_path / "sharding.json"
    assert report.main(["--out", str(out), "--ndev", "4", "--run-lanes",
                        "64", "--device", "cpu"]) == 0
    rep = json.loads(out.read_text())
    assert rep["collectives"]["verify_path"] == 0
    assert rep["collectives"]["tally_path"] == 1
    assert rep["geometry"]["per_shard_lanes"] == \
        mesh.padded_lanes(10240, 4) // 4 == 2560
    assert rep["geometry"]["b1_blocks_per_shard"] == 160
    assert rep["executed_reduced"]["ok"] and \
        rep["executed_reduced"]["tally_ok"]
    assert rep["timing_model"]["measured"] is False
    # the JAX report's SHARDING_10K.json is never a default
    with pytest.raises(SystemExit):
        report.main(["--device", "cpu"])


@pytest.mark.cuda
def test_four_shards_on_one_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    monkeypatch.setenv("COMETBFT_TPU_TORCH_KERNEL", "cuda")
    items = _mixed(1000)
    a, r, s, k, pre_bad = oe.prep_arrays(items, 1000)
    ek.launches = 0
    ok = mesh.verify_sharded(a, r, s, k, ndev=4, device="cuda:0")
    assert ek.launches == 4
    ok[pre_bad] = False
    assert ok.tolist() == _golden(items)
