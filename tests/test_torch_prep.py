"""The port's C host prep (ops/csrc/ed25519_prep.cpp, through
ops/ed25519.prep_arrays) against its plain version
(ops/ed25519.prep_arrays_plain, numpy and hashlib) and the JAX
package's ``prep_arrays`` (cometbft_tpu/ops/ed25519_jax.py), byte for
byte on seeded inputs: wrong lengths, S at and around L, empty and
block-crossing messages, a message long enough for the scalar SHA-512
path, partial 8-message groups, padding lanes, and one batch large
enough for the threaded split.  Outputs are bytes and booleans, so the
tolerance is exact equality.
"""
from pathlib import Path

import numpy as np
import pytest

from cometbft_tpu.crypto import _ed25519_ref as ref
from cometbft_tpu.ops import ed25519_jax as ej
from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import ed25519 as oe
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
L = ref.L


@pytest.fixture(autouse=True)
def _no_leftovers():
    yield
    pipeline.reset_workers()
    oe.reset_bucket_tuning()


class _Gen:
    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def bytes(self, n):
        return self.rng.bytes(n)

    def canonical_sig(self):
        """R random, S random below L (top byte < 0x10)."""
        s = bytearray(self.bytes(32))
        s[31] &= 0x0F
        return self.bytes(32) + bytes(s)

    def item(self, msg_len):
        return self.bytes(32), self.bytes(msg_len), self.canonical_sig()


def _signed(g, msg):
    seed = g.bytes(32)
    return ref.public_key(seed), msg, ref.sign(seed, msg)


def _assert_identical(items, m):
    got = oe.prep_arrays(items, m)
    plain = oe.prep_arrays_plain(items, m)
    want = ej.prep_arrays(items, m)
    names = ("a_b", "r_b", "s_w8", "k_w8", "pre_bad")
    for name, x, y, z in zip(names, got, plain, want):
        assert x.dtype == y.dtype == z.dtype, name
        assert x.shape == y.shape == z.shape, name
        assert np.array_equal(x, y), f"{name}: C != plain"
        assert np.array_equal(x, z), f"{name}: C != reference"
    return got


def _s_bytes(s: int) -> bytes:
    return s.to_bytes(32, "little")


def _case(name):
    g = _Gen(sum(map(ord, name)))
    if name == "wrong_lengths":
        pub, msg, sig = _signed(g, b"lengths")
        return [(pub, msg, sig), (pub[:31], msg, sig), (pub + b"\0", msg, sig),
                (b"", msg, sig), (pub, msg, sig[:63]), (pub, msg, sig + b"\0"),
                (pub, msg, b""), (b"short", msg, sig[:10]), (pub, msg, sig)]
    if name == "s_around_l":
        pub, msg, sig = _signed(g, b"canonical S")
        r = sig[:32]
        s = int.from_bytes(sig[32:], "little")
        return [(pub, msg, r + _s_bytes(v)) for v in
                (L - 1, L, L + 1, s + L, (1 << 256) - 1, 0, s)]
    if name == "empty_message":
        return [_signed(g, b""), g.item(0), _signed(g, b"x")]
    if name == "block_crossing":
        # R || A || msg is 64 + len bytes: 47/48 and 175/176 cross a
        # SHA-512 block once padded, 111/112 a 128-byte boundary
        lens = (47, 48, 111, 112, 175, 176)
        return [_signed(g, g.bytes(n)) for n in lens[:2]] + \
            [g.item(n) for n in lens]
    if name == "scalar_path":
        # 17 KiB: more than 128 blocks, hashed one message at a time
        return [g.item(17 * 1024), _signed(g, g.bytes(17 * 1024)),
                g.item(40), g.item(17 * 1024 + 1)]
    if name == "partial_groups":
        # 1-9 items of mixed block counts: groups of 1..8, never full
        return [g.item(n) for n in (10, 60, 10, 200, 60, 10, 300, 10, 60)]
    raise KeyError(name)


CASES = ("wrong_lengths", "s_around_l", "empty_message", "block_crossing",
         "scalar_path", "partial_groups")


@pytest.mark.parametrize("name", CASES)
def test_c_prep_byte_identical(name):
    items = _case(name)
    got = _assert_identical(items, 16)
    if name == "s_around_l":
        # L-1 and the signed S pass; L, L+1, S+L, 2^256-1 are rejected;
        # S = 0 is canonical
        assert got[4][:7].tolist() == [False, True, True, True, True,
                                       False, False]
    if name == "wrong_lengths":
        assert got[4][:9].tolist() == [False] + [True] * 7 + [False]


@pytest.mark.parametrize("n", range(1, 10))
def test_c_prep_partial_groups_of_mixed_blocks(n):
    g = _Gen(100 + n)
    items = [g.item(int(x)) for x in g.rng.choice([5, 50, 100, 150, 250],
                                                   size=n)]
    _assert_identical(items, n)


@pytest.mark.parametrize("m", [9, 64, 100])
def test_c_prep_pads_to_m(m):
    items = _case("partial_groups")
    a, r, s, k, bad = _assert_identical(items, m)
    b_row = np.frombuffer(oe._B_BYTES, np.uint8)
    id_row = np.frombuffer(oe._IDENTITY_BYTES, np.uint8)
    assert (a[9:] == b_row).all() and (r[9:] == id_row).all()
    assert not s[9:].any() and not k[9:].any() and not bad[9:].any()


def test_c_prep_empty_batch_is_all_padding():
    a, r, s, k, bad = _assert_identical([], 4)
    assert (a == np.frombuffer(oe._B_BYTES, np.uint8)).all()
    assert not bad.any()


@pytest.mark.threads
def test_c_prep_threaded_split_byte_identical():
    """2,100 items: above the 2,048 the C pass splits across threads."""
    lib = _build.load_host()
    assert lib.ed25519_prep_threads(2047) == 1
    assert 1 <= lib.ed25519_prep_threads(2100) <= 8
    g = _Gen(2100)
    items = [g.item(int(n)) for n in g.rng.integers(0, 300, size=2100)]
    items[7] = (b"short", b"m", bytes(64))
    items[2000] = items[2000][:2] + (items[2000][2][:32] + _s_bytes(L),)
    got = _assert_identical(items, 4096)
    assert got[4][[7, 2000]].tolist() == [True, True]


def test_pack_layout():
    g = _Gen(5)
    items = [g.item(3), (b"short", b"abc", bytes(64)), g.item(0),
             (bytes(32), b"xy", bytes(63))]
    pubs, sigs, msgs, offsets, bad = oe.pack(items)
    assert bad.tolist() == [False, True, False, True]
    assert offsets.tolist() == [0, 3, 6, 6, 8]
    assert msgs == b"".join(it[1] for it in items)
    assert pubs == items[0][0] + bytes(32) + items[2][0] + bytes(32)
    assert sigs == items[0][2] + bytes(64) + items[2][2] + bytes(64)


def test_prep_rejects_m_below_n():
    with pytest.raises(ValueError, match="m = 1 < 2"):
        oe.prep_arrays([_Gen(1).item(3)] * 2, 1)


def test_failed_host_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "HOST_FLAGS",
                        (*_build.HOST_FLAGS, "--no-such-flag"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _build.build_host()
    assert not list(tmp_path.glob("*.so"))


def test_host_library_reports_its_hash_path():
    _build.load_host()
    info = _build.host_build_info
    assert Path(info["path"]).parent == _build.BUILD_DIR
    assert Path(info["path"]).name.startswith("cometbft_prep-")


def test_sha512_headers_are_copies_of_native():
    for name in ("sha512.hpp", "sha512_mb.hpp"):
        port = REPO / "cometbft_tpu_torch" / "ops" / "csrc" / name
        assert port.read_bytes() == (REPO / "native" / name).read_bytes()
    src = (REPO / "cometbft_tpu_torch/ops/csrc/ed25519_prep.cpp").read_text()
    includes = [ln for ln in src.splitlines() if ln.startswith("#include")]
    assert includes and not any("Python.h" in ln or "native" in ln
                                for ln in includes)


def test_verify_batch_never_reaches_the_plain_prep(monkeypatch):
    def plain(*_):
        raise AssertionError("verify_batch reached prep_arrays_plain")

    monkeypatch.setattr(oe, "prep_arrays_plain", plain)
    g = _Gen(8)
    items = [_signed(g, b"a"), _signed(g, b"b")]
    items.append((items[0][0], b"tampered", items[0][2]))
    ok, mask = oe.verify_batch(items, device="cpu")
    assert (ok, mask) == (False, [True, True, False])
