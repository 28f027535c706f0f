"""The port's BASELINE configs' runner (cometbft_tpu_torch/tools/
benchmarks.py) against the JAX package's (cometbft_tpu/tools/
benchmarks.py):

  * ``_make_valset`` and ``_signed_commit`` give byte-equal validator
    sets and commits for the same seeded private keys;
  * configs #2-#5 at the JAX test's tiny sizes (tests/test_loadtime.py
    ``TestBaselineBenchmarks``) on ``device="cpu"``, with the same keys
    as the JAX functions (the JAX package on its CPU backend): the
    port's line has the JAX line's keys and ``device``, the same sizes,
    config 2's ``backend`` "cpu", and positive times; each config
    launches B1;
  * one case runs B1's plain version, whose verdicts the config checks;
  * ``main`` without CUDA raises unless ``--device cpu``, and prints one
    line a config.

Logic cases use the accept-all stand-in kernel.  Every value compared is
exact; times are only checked to be positive.
"""
import json

import pytest
import torch

from cometbft_tpu.crypto import batch as r_batch
from cometbft_tpu.crypto import ed25519 as r_ed
from cometbft_tpu.crypto import secp256k1 as r_secp
from cometbft_tpu.tools import benchmarks as r_bench
from cometbft_tpu_torch.crypto import ed25519 as p_ed
from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.tools import benchmarks as bench
from cometbft_tpu_torch.types.block_id import BlockID
from cometbft_tpu_torch.types.part_set import PartSetHeader
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

SEED = 11

# the JAX test's sizes (tests/test_loadtime.py:121-128)
TINY = {2: {"sizes": (16,)}, 3: {"n_vals": 8, "hops": 2},
        4: {"n_vals": 8, "heights": 2}, 5: {"n_vals": 12, "n_bls": 4}}
PORT_FN = {2: bench.config2_batch_verify, 3: bench.config3_light_client,
           4: bench.config4_replay_tally, 5: bench.config5_mixed_stress}
JAX_FN = {2: r_bench.config2_batch_verify, 3: r_bench.config3_light_client,
          4: r_bench.config4_replay_tally, 5: r_bench.config5_mixed_stress}
TIMES = {"results_ms", "value_ms", "tally_ms_p50", "commit_verify_ms_p50",
         "mixed_commit_verify_ms", "bls_aggregate_verify_ms"}


@pytest.fixture(autouse=True)
def _clean():
    yield
    pipeline.reset_workers()
    oe.reset_bucket_tuning()


def _accept_all(monkeypatch):
    def verify_cols(a, r, s, k):
        ek.launches += 1
        return torch.ones(a.shape[1], dtype=torch.bool)
    monkeypatch.setattr(ek, "verify_cols", verify_cols)


def _seeded_jax_keys(monkeypatch, seed):
    """The JAX package's fresh keys replaced by the port's seeded draw:
    key i of a config is ``gen_priv_key_from_secret(b"bench-<seed>-<i>")``
    of its type, i counted over every draw."""
    drawn = []

    def draw(mod):
        def gen():
            secret = b"bench-%d-%d" % (seed, len(drawn))
            drawn.append(secret)
            return mod.gen_priv_key_from_secret(secret)
        return gen
    monkeypatch.setattr(r_ed, "gen_priv_key", draw(r_ed))
    monkeypatch.setattr(r_secp, "gen_priv_key", draw(r_secp))
    return drawn


@pytest.fixture
def jax_cpu():
    r_batch.set_backend("cpu")
    yield
    r_batch.set_backend("auto")


def test_valset_and_commit_are_byte_equal():
    secrets = [b"vs-%d" % i for i in range(9)]
    vset, privs = bench._make_valset(
        [p_ed.gen_priv_key_from_secret(s) for s in secrets])
    r_vset, r_privs = r_bench._make_valset(
        [r_ed.gen_priv_key_from_secret(s) for s in secrets])
    assert vset.hash() == r_vset.hash()
    assert [p.bytes() for p in privs] == [p.bytes() for p in r_privs]
    from cometbft_tpu.types.block_id import BlockID as RBlockID
    from cometbft_tpu.types.part_set import PartSetHeader as RPSH
    bid = BlockID(hash=b"\x21" * 32,
                  part_set_header=PartSetHeader(1, b"\x11" * 32))
    r_bid = RBlockID(hash=b"\x21" * 32,
                     part_set_header=RPSH(1, b"\x11" * 32))
    commit = bench._signed_commit("bench-chain", vset, privs, 12, bid)
    r_commit = r_bench._signed_commit("bench-chain", r_vset, r_privs, 12,
                                      r_bid)
    assert commit.hash() == r_commit.hash()
    assert [s.signature for s in commit.signatures] == \
        [s.signature for s in r_commit.signatures]


@pytest.mark.parametrize("config", [2, 3, 4, 5])
def test_config_matches_reference(config, monkeypatch, jax_cpu):
    _accept_all(monkeypatch)
    launches = ek.launches
    line = PORT_FN[config](device="cpu", seed=SEED, **TINY[config])
    assert ek.launches > launches
    drawn = _seeded_jax_keys(monkeypatch, SEED)
    want = JAX_FN[config](**TINY[config])
    assert drawn, "the JAX config drew no key"
    assert set(line) == set(want) | {"device"}
    for k, v in want.items():
        if k in TIMES:
            continue
        assert line[k] == (v if k != "backend" else "cpu"), k
    assert line["device"] == "cpu"
    for k in TIMES & set(line):
        vals = line[k].values() if isinstance(line[k], dict) else [line[k]]
        assert all(x > 0 for x in vals), k
    if config == 2:
        assert list(line["results_ms"]) == list(want["results_ms"])


def test_config_keys_follow_the_seed(monkeypatch):
    """The port's seeded draw equals the JAX config's keys under the same
    seed: config 3's validator set, built both ways (exact hash)."""
    _accept_all(monkeypatch)
    seen = {}
    real = bench._make_valset

    def spy(privs):
        out = real(privs)
        seen["port"] = out[0].hash()
        return out
    monkeypatch.setattr(bench, "_make_valset", spy)
    bench.config3_light_client(n_vals=8, hops=1, device="cpu", seed=SEED)
    r_real = r_bench._make_valset

    def r_spy(privs):
        out = r_real(privs)
        seen["jax"] = out[0].hash()
        return out
    monkeypatch.setattr(r_bench, "_make_valset", r_spy)
    _seeded_jax_keys(monkeypatch, SEED)
    r_batch.set_backend("cpu")
    try:
        r_bench.config3_light_client(n_vals=8, hops=1)
    finally:
        r_batch.set_backend("auto")
    assert seen["port"] == seen["jax"]


def test_config2_on_the_plain_kernel():
    """B1's plain version judges every signature (~2.5 s here): the
    config raises unless all 16 verify."""
    line = bench.config2_batch_verify(sizes=(16,), device="cpu", seed=3)
    assert line["results_ms"]["16"] > 0


def test_a_rejected_signature_raises(monkeypatch):
    def reject_one(a, r, s, k):
        ek.launches += 1
        out = torch.ones(a.shape[1], dtype=torch.bool)
        out[0] = False
        return out
    monkeypatch.setattr(ek, "verify_cols", reject_one)
    with pytest.raises(AssertionError, match="rejected"):
        bench.config2_batch_verify(sizes=(8,), device="cpu", seed=3)


def test_main_needs_the_card_unless_told_cpu(monkeypatch, capsys):
    _accept_all(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--config", "2"])
    assert capsys.readouterr().out == ""
    assert bench.main(["--config", "2", "--device", "cpu"]) == 0
    (line,) = capsys.readouterr().out.splitlines()
    rec = json.loads(line)
    assert rec["config"] == 2 and list(rec["results_ms"]) == ["64", "256"]
    assert rec["backend"] == "cpu" and rec["device"] == "cpu"


def test_main_runs_every_config_in_order(monkeypatch, capsys):
    """``main`` with no ``--config`` prints configs 2-5, one line each, at
    the default sizes (config 5 shrunk to the tiny size here)."""
    _accept_all(monkeypatch)
    real5 = bench.config5_mixed_stress
    monkeypatch.setattr(
        bench, "config5_mixed_stress",
        lambda n, b, device=None: real5(12, 4, device=device))
    assert bench.main(["--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["config"] for r in lines] == [2, 3, 4, 5]
    assert lines[1]["validators"] == 100 and lines[2]["heights"] == 3


# -- chip_smoke.py's phase 21, rehearsed -------------------------------------

# the runner as a process on the CPU: the accept-all stand-in kernel, then
# the module's main with --device cpu added
BENCH_STUB = """
import sys, torch
from cometbft_tpu_torch.ops import ed25519_kernel as ek
def verify_cols(a, r, s, k):
    ek.launches += 1
    return torch.ones(a.shape[1], dtype=torch.bool)
ek.verify_cols = verify_cols
from cometbft_tpu_torch.tools.benchmarks import main
sys.exit(main(sys.argv[1:] + ["--device", "cpu"]))
"""


def test_phase_21_rehearsed_at_default_sizes(monkeypatch):
    """Phase 21 as on the card, at the runner's default sizes on the CPU
    with the accept-all stand-in kernel (~20 s here): 21b's process runs
    BENCH_STUB; the card's name is "cpu"."""
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(repo))
    import chip_smoke
    _accept_all(monkeypatch)
    monkeypatch.setattr(chip_smoke, "BENCH_ARGS", [
        ["--device", "cpu", "--config", str(n)] for n in (2, 3, 4, 5)])
    monkeypatch.setattr(chip_smoke, "BENCH_SIZES", ["64", "256"])
    monkeypatch.setattr(chip_smoke, "BENCH_CLI",
                        [sys.executable, "-c", BENCH_STUB])
    b1 = chip_smoke._bench_phases(0, "cpu, 0 W", device="cpu")
    assert set(b1) == {"bench_config_2", "bench_config_3",
                       "bench_config_4", "bench_config_5", "flight_giveup"}
    assert all(v > 0 for v in b1.values())
    assert b1["flight_giveup"] >= chip_smoke.FLIGHT_RESTARTS + 1
