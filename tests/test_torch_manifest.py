"""The port's e2e manifest runner and fuzzed connection
(cometbft_tpu_torch/tools/manifest.py, p2p/fuzz.py) against the JAX
package's:

  * ``generate(seed, max_nodes)`` gives the JAX manifest for every seed
    tried, and a saved manifest is the JAX file byte for byte;
  * ``setup`` with seeded keys, a fixed clock and the same ports writes
    the JAX homes byte for byte (keys, states, node keys, genesis) and
    the same configs;
  * a latency relay delays each direction by its delay;
  * a short ``run_manifest`` on the port (three validators, a late full
    node, a killed and restarted validator, tx load) passes its
    invariants;
  * a ``FuzzedConnection`` drops, delays, corrupts, reorders and
    duplicates the same frames as the JAX one under the same seed.

The port runs ``device="cpu"`` with the accept-all stand-in kernel.
"""
import asyncio
import dataclasses
import hashlib
import itertools
import os
import secrets
import time

import pytest
import torch

from cometbft_tpu.p2p import fuzz as r_fuzz
from cometbft_tpu.tools import manifest as r_mf
from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.p2p import fuzz as p_fuzz
from cometbft_tpu_torch.tools import manifest as p_mf
from cometbft_tpu_torch.types import vote as p_vote_mod
from torch_helpers import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("max_nodes", [2, 4, 6])
def test_generate_equals_the_jax_one(max_nodes):
    for seed in range(60):
        mine = p_mf.generate(seed, max_nodes=max_nodes)
        theirs = r_mf.generate(seed, max_nodes=max_nodes)
        assert mine.to_dict() == theirs.to_dict(), seed
        assert [f.name for f in dataclasses.fields(mine)] == \
            [f.name for f in dataclasses.fields(theirs)]


def test_saved_manifest_is_the_jax_file(tmp_path):
    for seed in (3, 793):
        p_mf.generate(seed).save(str(tmp_path / "p.json"))
        r_mf.generate(seed).save(str(tmp_path / "r.json"))
        assert (tmp_path / "p.json").read_bytes() == \
            (tmp_path / "r.json").read_bytes()
        back = p_mf.Manifest.load(str(tmp_path / "p.json"))
        assert back.to_dict() == p_mf.generate(seed).to_dict()
    m = p_mf.Manifest(latency_ms={"zone-a:zone-b": 70})
    assert m.link_delay_s("zone-b", "zone-a") == 0.07
    assert m.link_delay_s("zone-a", "zone-a") == 0.0


def test_setup_writes_the_jax_homes(tmp_path, monkeypatch):
    man = p_mf.generate(9, max_nodes=4)
    assert man.latency_ms            # relays too
    out = {}
    for name, mod in (("port", p_mf), ("jax", r_mf)):
        ctr, ports = itertools.count(), itertools.count(41000)
        with monkeypatch.context() as mp:
            mp.setattr(secrets, "token_bytes", lambda n=32: hashlib.sha512(
                b"setup/%d" % next(ctr)).digest()[:n])
            mp.setattr(time, "time_ns", lambda: 1_700_000_000_000_000_007)
            mp.setattr(mod, "_free_port", lambda: next(ports))
            m = mod.Manifest.from_dict(man.to_dict())
            cfgs, relays = mod.setup(m, str(tmp_path / name))
        files = {}
        for root, _, names in os.walk(tmp_path / name):
            for f in names:
                path = os.path.join(root, f)
                files[os.path.relpath(path, tmp_path / name)] = \
                    open(path, "rb").read()
        out[name] = (files, {k: dataclasses.asdict(c.p2p)
                             for k, c in cfgs.items()},
                     [dataclasses.asdict(r) for r in relays])
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    assert out["port"][2] == out["jax"][2] and out["port"][2]


def test_relay_delays_each_direction():
    async def go():
        async def echo(reader, writer):
            while data := await reader.read(1024):
                writer.write(data)
                await writer.drain()
            writer.close()
        server = await asyncio.start_server(echo, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        spec = p_mf.RelaySpec(port=p_mf._free_port(), target_host="127.0.0.1",
                              target_port=port, delay_s=0.05)
        relay = await p_mf.start_relay(spec)
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           spec.port)
            t0 = time.perf_counter()
            writer.write(b"ping")
            await writer.drain()
            got = await asyncio.wait_for(reader.readexactly(4), 5)
            rtt = time.perf_counter() - t0
            writer.close()
        finally:
            relay.close()
            await relay.wait_closed()
            server.close()
            await server.wait_closed()
        return got, rtt
    got, rtt = asyncio.run(go())
    assert got == b"ping" and 0.1 <= rtt < 1.0


def test_run_manifest_with_perturbation_and_late_joiner(tmp_path,
                                                        monkeypatch):
    """tests/test_manifest_runner.py's case on the port: three
    validators, a late full node, one validator killed and restarted,
    tx load; the nodes agree on every block id and app hash."""
    def verify_cols(a, r, s, k):
        ek.launches += 1
        return torch.ones(a.shape[1], dtype=torch.bool)
    monkeypatch.setattr(ek, "verify_cols", verify_cols)
    p_vote_mod._VERIFIED.clear()
    m = p_mf.Manifest(chain_id="runner-net", load_tx_rate=20,
                      load_tx_size=128)
    for i in range(3):
        m.nodes[f"validator{i:02d}"] = p_mf.ManifestNode(mode="validator")
        m.validators[f"validator{i:02d}"] = 100
    m.nodes["validator02"].perturb = ["kill"]
    m.nodes["full00"] = p_mf.ManifestNode(mode="full", start_at=2)
    ek.launches = 0
    try:
        rep = asyncio.run(p_mf.run_manifest(m, str(tmp_path), target_height=5,
                                            timeout_s=21.0, device="cpu"))
    finally:
        pipeline.reset_workers()
    assert rep.mismatches == [], rep
    assert rep.perturbed == ["validator02:kill"]
    assert min(rep.heights.values()) >= 5 and rep.load_accepted > 0
    assert ek.launches > 0


class _Pipe:
    def __init__(self, frames):
        self.frames = list(frames)
        self.sent = []
        self.closed = False

    async def read_msg(self):
        return self.frames.pop(0)

    async def write_msg(self, data):
        self.sent.append(data)

    def close(self):
        self.closed = True


@pytest.mark.parametrize("cfg", [
    dict(prob_drop_write=0.2, prob_delay=0.1, max_delay_s=0.001,
         prob_corrupt_read=0.3, seed=5),
    dict(prob_reorder=0.3, prob_duplicate=0.2, seed=11),
    dict(prob_drop_write=0.1, prob_reorder=0.2, prob_duplicate=0.1,
         prob_corrupt_read=0.1, seed=0),
])
def test_fuzzed_connection_equals_the_jax_one(monkeypatch, cfg):
    import random
    frames = [bytes([i]) * (i % 7 + 1) for i in range(60)]
    out = []
    for mod in (p_fuzz, r_fuzz):
        if cfg["seed"] == 0:
            # an unseeded schedule: the same system draws in both
            monkeypatch.setattr(random, "Random",
                                lambda s=None, R=random.Random: R(99))
        pipe = _Pipe(frames)
        conn = mod.FuzzedConnection(pipe, mod.FuzzConfig(**cfg))

        async def go():
            got = [await conn.read_msg() for _ in range(30)]
            for f in frames[:30]:
                await conn.write_msg(f)
            conn.close()
            return got
        got = asyncio.run(go())
        out.append((got, pipe.sent, pipe.closed, conn.dropped, conn.delayed,
                    conn.corrupted, conn.reordered, conn.duplicated))
    assert out[0] == out[1]
    assert [f.name for f in dataclasses.fields(p_fuzz.FuzzConfig)] == \
        [f.name for f in dataclasses.fields(r_fuzz.FuzzConfig)]
