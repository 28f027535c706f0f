"""The host ed25519 (ops/csrc/ed25519_host.cpp via ops/ed25519_host.py)
against the golden model and the JAX package's keys.

  * seeded seeds and messages (numpy) at SHA-512 block edges: the public
    key, the RFC 8032 signature and the verdict equal the golden model's
    (crypto/_ed25519_ref.py) byte for byte, and the JAX package's keys
    (OpenSSL) sign the same bytes;
  * the ZIP-215 edge items of chip_smoke.py (small order, y >= p,
    negative zero, S >= L, corruptions, random bytes) and every
    signature of test_torch_validation.py's SCENARIOS get the golden
    model's verdict;
  * ``gen_priv_key_from_secret`` gives the JAX package's key;
  * a failed g++ build and a failed self-test raise; nothing falls back
    to the golden model;
  * crypto/benchmarking.py's harness runs on the port's keys.
"""
import shutil

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import ed25519 as r_ed
from cometbft_tpu_torch.crypto import _ed25519_ref as ref
from cometbft_tpu_torch.crypto import benchmarking
from cometbft_tpu_torch.crypto import ed25519 as p_ed
from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import ed25519_host as host
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from test_torch_validation import CHAIN_ID, SCENARIOS, _signed
from torch_chain import cs
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

# SHA-512 block edges of the nonce hash (prefix || msg) and of
# k = H(R || A || msg)
MSG_LENS = (0, 1, 63, 64, 95, 96, 111, 112, 127, 128, 175, 176, 239, 240,
            1000)


class _SerialPool:
    def map(self, fn, items, chunksize=None):
        return [fn(x) for x in items]


def _inputs(n, base):
    rng = np.random.default_rng(base)
    return [(rng.bytes(32), rng.bytes(MSG_LENS[i % len(MSG_LENS)]))
            for i in range(n)]


@pytest.mark.parametrize("block", range(3))
def test_sign_and_verify_equal_the_golden_model(block):
    for seed, msg in _inputs(20, 1100 + block):
        pub = host.public_key(seed)
        sig = host.sign(seed, pub, msg)
        assert pub == ref.public_key(seed)
        assert sig == ref.sign(seed, msg)
        assert host.verify(pub, msg, sig)
        bad = bytearray(sig)
        bad[len(msg) % 64] ^= 0x04
        assert host.verify(pub, msg, bytes(bad)) == \
            ref.verify(pub, msg, bytes(bad))


def test_keys_equal_the_jax_packages():
    for seed, msg in _inputs(16, 1110):
        mine, theirs = p_ed.Ed25519PrivKey(seed), r_ed.Ed25519PrivKey(seed)
        assert mine.bytes() == theirs.bytes()
        assert mine.pub_key().bytes() == theirs.pub_key().bytes()
        assert mine.pub_key().address() == theirs.pub_key().address()
        sig = mine.sign(msg)
        assert sig == theirs.sign(msg)
        assert theirs.pub_key().verify_signature(msg, sig)
        assert mine.pub_key().verify_signature(msg, sig)
        assert not mine.pub_key().verify_signature(msg + b"x", sig)


def test_verify_equals_the_golden_model_on_edge_items():
    items = cs._edge_items(1120, _SerialPool())
    assert len(items) > 800
    got = [host.verify(*item) for item in items]
    assert got == [ref.verify(*item) for item in items]
    assert 0 < sum(got) < len(got)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_verify_equals_the_golden_model_on_scenarios(scenario):
    vals, commit = _signed(**SCENARIOS[scenario])
    checked = 0
    for i, sig in enumerate(commit.signatures):
        if not sig.signature:
            continue
        _, val = vals.get_by_address(sig.validator_address)
        pub = val.pub_key.bytes() if val is not None else bytes(32)
        msg = commit.vote_sign_bytes(CHAIN_ID, i)
        assert host.verify(pub, msg, sig.signature) == \
            ref.verify(pub, msg, sig.signature)
        checked += 1
    assert checked > 0


def test_gen_priv_key_from_secret_equals_the_jax_packages():
    for secret in (b"", b"validator-0", b"x" * 100):
        assert p_ed.gen_priv_key_from_secret(secret).bytes() == \
            r_ed.gen_priv_key_from_secret(secret).bytes()
    a, b = p_ed.gen_priv_key(), p_ed.gen_priv_key()
    assert a.bytes() != b.bytes()
    assert a.pub_key().verify_signature(b"m", a.sign(b"m"))


def test_wrong_lengths_are_false_or_raise():
    seed = bytes(range(32))
    pub = host.public_key(seed)
    sig = host.sign(seed, pub, b"m")
    assert not host.verify(pub[:31], b"m", sig)
    assert not host.verify(pub, b"m", sig[:63])
    with pytest.raises(ValueError):
        host.public_key(seed[:31])
    with pytest.raises(ValueError):
        host.sign(seed, pub[:31], b"m")


def _isolated_build(monkeypatch, tmp_path, source_text):
    """Point the loader at a copy of csrc holding ``source_text`` as
    ed25519_host.cpp, with an empty build dir and no loaded library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    (csrc / _build.ED25519_HOST_SOURCE).write_text(source_text)
    monkeypatch.setattr(_build, "_CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_ed25519_host_lib", None)


def test_failed_build_raises(monkeypatch, tmp_path):
    src = (_build._CSRC / _build.ED25519_HOST_SOURCE).read_text()
    _isolated_build(monkeypatch, tmp_path, src + "\nnot C++ at all\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        host.public_key(bytes(32))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        p_ed.Ed25519PrivKey(bytes(32))


def test_failed_self_test_raises(monkeypatch, tmp_path):
    src = (_build._CSRC / _build.ED25519_HOST_SOURCE).read_text()
    vector = "e5564300c360ac729086e2cc806e828a"
    assert vector in src
    _isolated_build(monkeypatch, tmp_path,
                    src.replace(vector, "f" + vector[1:]))
    with pytest.raises(RuntimeError, match="failed its self-test"):
        host.verify(bytes(32), b"m", bytes(64))


def test_benchmarking_harness(monkeypatch):
    monkeypatch.setattr(ek, "verify_cols", lambda a, r, s, k: torch.ones(
        a.shape[1], dtype=torch.bool))
    key = p_ed.gen_priv_key_from_secret(b"bench")
    try:
        assert benchmarking.bench_sign(key, iters=5) > 0
        assert benchmarking.bench_verify(key, iters=5) > 0
        assert benchmarking.bench_batch_verify(
            p_ed.gen_priv_key, batch_size=4, iters=1, device="cpu") > 0
    finally:
        pipeline.reset_workers()
