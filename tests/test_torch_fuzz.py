"""The port's coverage-guided fuzzer (cometbft_tpu_torch/tools/fuzz.py)
against the JAX package's (cometbft_tpu/tools/fuzz.py).

  * each port target (the JSON-RPC dispatch, the proto decoder, the
    secret-connection handshake) fuzzes clean for 2 s from a scratch
    corpus, with a live coverage feed;
  * the JAX package's corpus (tests/fuzz_corpus/, read only) and the
    port's (tests/fuzz_corpus_torch/) replay clean through the port's
    targets, and the JSON-RPC answers equal the JAX server's;
  * the coverage map sees a new branch, as tests/test_fuzz_coverage.py
    has the JAX one do;
  * the engine's mutator is the JAX one, byte for byte on a seed;
  * a crash is persisted under the corpus and ``main`` exits 1; the JAX
    corpus is never a corpus to fuzz into.
"""
import asyncio
import importlib.util
import json
import os
import random

import pytest

from cometbft_tpu.tools import fuzz as r_fuzz
from cometbft_tpu_torch.tools import fuzz
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)


def test_corpus_locations():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert fuzz.DEFAULT_CORPUS == os.path.join(repo, "tests",
                                               "fuzz_corpus_torch")
    assert fuzz.REFERENCE_CORPUS == r_fuzz.DEFAULT_CORPUS
    assert sorted(fuzz.TARGETS) == sorted(r_fuzz.TARGETS)


@pytest.mark.parametrize("name", sorted(fuzz.TARGETS))
def test_target_fuzzes_clean(name, tmp_path):
    stats = fuzz.fuzz_target(fuzz.TARGETS[name](), budget_s=2.0,
                             corpus_dir=str(tmp_path), seed=1)
    assert stats.runs > 100, stats.to_dict()
    # the coverage feed is live (locations discovered during replay)
    assert stats.locations > 10, stats.to_dict()
    assert stats.crashes == [], stats.to_dict()


@pytest.mark.parametrize("corpus", ["reference", "port"])
def test_corpus_replays_clean(corpus):
    """Every persisted input of the corpus passes its port target's
    invariant (an undeclared exception would raise here)."""
    d = fuzz.REFERENCE_CORPUS if corpus == "reference" else \
        fuzz.DEFAULT_CORPUS
    total = 0
    for name, mk in fuzz.TARGETS.items():
        t = mk()
        try:
            total += fuzz.replay_corpus(t, d)
        finally:
            t.close()
    assert total > 0, f"{d} is missing or empty"


def test_jsonrpc_answers_equal_the_jax_servers():
    """The JSON-RPC target's dispatch answers every input of both
    corpora, and its seeds, as the JAX server does."""
    from cometbft_tpu.config import RPCConfig as RConfig
    from cometbft_tpu.rpc.server import RPCServer as RServer
    from cometbft_tpu_torch.config import RPCConfig
    from cometbft_tpu_torch.rpc.server import RPCServer

    class _NullNode:
        metrics_registry = None

    async def echo(*, s: str = "", i: int = 0):
        return {"s": s, "i": i}

    port = RPCServer(_NullNode(), RPCConfig(), routes={"echo": echo})
    ref = RServer(_NullNode(), RConfig(), routes={"echo": echo})
    inputs = []
    for d in (fuzz.REFERENCE_CORPUS, fuzz.DEFAULT_CORPUS):
        inputs += fuzz._load_corpus(os.path.join(d, "jsonrpc"))
    inputs += [b'{"jsonrpc":"2.0","method":"echo","params":{"s":"x"},"id":1}',
               b"[]", b"{}", b"\xff\xfe", b'{"method":"nope","id":2}']
    loop = asyncio.new_event_loop()
    try:
        for data in inputs:
            got = loop.run_until_complete(port._dispatch("POST", "/", data))
            want = loop.run_until_complete(ref._dispatch("POST", "/", data))
            assert json.dumps(got, sort_keys=True) == \
                json.dumps(want, sort_keys=True), data
    finally:
        loop.close()


def test_coverage_map_sees_new_lines(tmp_path):
    # the probe function lives in its own module so the test's own
    # lines don't count as target coverage
    mod_path = tmp_path / "cov_probe_torch.py"
    mod_path.write_text(
        "def f(x):\n"
        "    if x > 3:\n"
        "        return x * 2\n"
        "    return x + 1\n")
    spec = importlib.util.spec_from_file_location(
        "cov_probe_torch", mod_path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)

    with fuzz.CoverageMap([str(mod_path)]) as cov:
        probe.f(1)
        n1 = cov.take_fresh()
        probe.f(1)
        n2 = cov.take_fresh()
        probe.f(5)              # new branch
        n3 = cov.take_fresh()
    assert n1 > 0
    assert n2 == 0              # nothing new on the same path
    assert n3 > 0               # the x > 3 arm is fresh


@pytest.mark.parametrize("seed", [0, 1, 7, 0xF17E5])
def test_mutator_is_the_jax_one(seed):
    corpus = [b'{"jsonrpc":"2.0","method":"echo","id":1}', b"\x08\x96\x01",
              b""]
    got_rng, want_rng = random.Random(seed), random.Random(seed)
    for _ in range(200):
        assert fuzz.mutate(got_rng, corpus) == r_fuzz.mutate(want_rng, corpus)


def test_a_crash_is_persisted_and_main_exits_1(tmp_path, monkeypatch,
                                                 capsys):
    def boom_target():
        def run(data: bytes) -> None:
            if len(data) % 3 == 1:
                raise KeyError("undeclared")
        return fuzz.Target("boom", run, [fuzz.__file__], [b"ab"])

    monkeypatch.setitem(fuzz.TARGETS, "boom", boom_target)
    rc = fuzz.main(["--target", "boom", "--budget", "0.5",
                    "--corpus", str(tmp_path)])
    assert rc == 1
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["target"] == "boom" and stats["crashes"]
    assert stats["crashes"][0].startswith("KeyError: 'undeclared'")
    crashes = os.listdir(tmp_path / "boom" / "crashes")
    assert crashes and all(c.endswith(".bin") for c in crashes)


def test_the_jax_corpus_is_never_written(tmp_path):
    before = sorted(os.walk(fuzz.REFERENCE_CORPUS))
    with pytest.raises(ValueError, match="JAX package's corpus"):
        fuzz.fuzz_target(fuzz.TARGETS["proto"](), 0.1,
                         corpus_dir=fuzz.REFERENCE_CORPUS)
    assert sorted(os.walk(fuzz.REFERENCE_CORPUS)) == before
