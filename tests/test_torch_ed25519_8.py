"""The port's second ed25519 kernel (ops/ed25519_kernel8.py, B2: radix
2^16, fold 38, extended B table, unified adds) against the ZIP-215
golden model (cometbft_tpu/crypto/_ed25519_ref.py), against the first
kernel's plain version and against the JAX package's ed25519_pallas8
constants and kernel, plus the kernel choice COMETBFT_TPU_TORCH_KERNEL.
Inputs come from seeded numpy generators (the cases of
tests/test_torch_ed25519.py); verdicts are booleans, so tolerance is
exact equality.

The CUDA kernel itself is held to the plain version on the card by the
``cuda``-marked test below (skipped without a GPU) and by chip_smoke.py.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import _ed25519_ref as ref
from cometbft_tpu.ops import ed25519_pallas8 as ep8
from cometbft_tpu.ops import field as jfield
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import ed25519_kernel8 as ek8
from cometbft_tpu_torch.ops import field16 as F16
from tests.test_torch_ed25519 import CASES, _Gen, _cases, _golden
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
ENV = "COMETBFT_TPU_TORCH_KERNEL"


@pytest.fixture
def cuda8(monkeypatch):
    monkeypatch.setenv(ENV, "cuda8")


def _cols(items, m=None):
    m = m or oe._bucket(len(items))
    a, r, s, k, bad = oe.prep_arrays(items, m)
    return [oe.to_cols(x, CPU) for x in (a, r, s, k)], bad


def _mask(ok, bad, n):
    mask = ok.numpy()[:n].copy()
    mask[bad[:n]] = False
    return mask.tolist()


@pytest.mark.parametrize("name", CASES)
def test_verify_batch_cuda8_matches_golden(name, cuda8, monkeypatch):
    """verify_batch(device="cpu") under cuda8 runs B2's plain version
    (and never B1's) and gives the golden mask."""
    items = _cases(name)
    golden = _golden(items)

    def first_kernel(*_):
        raise AssertionError("cuda8 reached the first kernel")

    monkeypatch.setattr(ek, "verify_cols", first_kernel)
    ok, mask = oe.verify_batch(items, device="cpu")
    assert mask == golden and ok == all(golden)


def test_verify_cols_plain_matches_golden_on_mixed_lanes():
    items = (_cases("valid_and_corrupted") + _cases("negative_zero") +
             _cases("non_canonical_y") + _cases("small_order"))
    cols, bad = _cols(items)
    assert _mask(ek8.verify_cols_plain(*cols), bad, len(items)) == \
        _golden(items)


def test_plain_mask_equals_first_kernel_on_random_mix():
    """Both plain versions on the same columns, every lane (padding
    included): B2's field and formulas check B1's."""
    g = _Gen(14)
    items = _cases("random_mix")
    items += [(g.bytes(32), g.bytes(7), g.bytes(32) + bytes(31) + b"\x01")
              for _ in range(6)]                  # random A, R; S < L
    cols, _ = _cols(items)
    got8, got1 = ek8.verify_cols_plain(*cols), ek.verify_cols_plain(*cols)
    assert torch.equal(got8, got1)
    assert not bool(got8[:len(items)].all())


def test_padding_lanes_verify_trivially():
    item = _Gen(8).sig()
    cols, bad = _cols([item], 64)
    assert ek8.verify_cols_plain(*cols).tolist() == [True] * 64
    assert not bad.any()


def test_empty_batch(cuda8):
    assert oe.verify_batch([], device="cpu") == (True, [])


def test_batch_spanning_two_tiles(cuda8, monkeypatch):
    """n = 70 at tile 64: two balanced tiles, both through B2's plain
    version; the CPU path launches no kernel."""
    g = _Gen(9)
    items, golden = [], []
    base = [g.sig() for _ in range(4)]
    for i in range(70):
        pub, msg, sig = base[i % 4]
        if i in (3, 41):
            sig = sig[:32] + bytes(32)              # S = 0
        if i == 50:
            msg = msg + b"tampered"
        if i == 66:
            pub = b"short"
        items.append((pub, msg, sig))
        golden.append(ref.verify(pub, msg, sig))
    monkeypatch.setenv("COMETBFT_TPU_TORCH_VERIFY_TILE", "64")
    calls = []
    plain = ek8.verify_cols_plain
    monkeypatch.setattr(ek8, "verify_cols_plain",
                        lambda *a: calls.append(a[0].shape[1]) or plain(*a))
    before8, before1 = ek8.launches, ek.launches
    ok, mask = oe.verify_batch(items, device="cpu")
    assert mask == golden and not ok
    assert calls == [64, 64]
    assert (ek8.launches, ek.launches) == (before8, before1)


def test_b_table_matches_pallas8_constants():
    """B_TABLE equals ed25519_pallas8._B_TABLE_NP (32 limbs of 8 bits,
    limb i at weight 2^(8 i)) entry by entry, coordinate by coordinate,
    as integers mod p; the constant block leads with D, 2D, sqrt(-1)."""
    assert len(ek8.B_TABLE) == 16
    for i in range(16):
        for c in range(4):
            want = jfield.from_limbs(ep8._B_TABLE_NP[i, c, :, 0])
            assert F16.from_limbs(ek8.B_TABLE[i][c]) == want, (i, c)
    L = F16.LIMBS
    consts = ek8.CONSTS
    assert len(consts) == 3 * L + 16 * 4 * L
    assert F16.from_limbs(consts[0:L]) == ref.D
    assert F16.from_limbs(consts[L:2 * L]) == 2 * ref.D % ref.P
    assert F16.from_limbs(consts[2 * L:3 * L]) == ref.SQRT_M1
    assert consts[3 * L:] == [v for e in ek8.B_TABLE for c in e for v in c]


def _bad_cols(fault):
    a, r, s, k = (torch.zeros(32, 4, dtype=torch.int32),
                  torch.zeros(32, 4, dtype=torch.int32),
                  torch.zeros(64, 4, dtype=torch.int32),
                  torch.zeros(64, 4, dtype=torch.int32))
    if fault == "dtype":
        return (a.long(), r, s, k), TypeError
    if fault == "rows":
        return (a, torch.zeros(31, 4, dtype=torch.int32), s, k), ValueError
    if fault == "lanes":
        return (a, r, s, torch.zeros(64, 5, dtype=torch.int32)), ValueError
    if fault == "layout":
        return (a, r, torch.zeros(4, 64, dtype=torch.int32).t(), k), \
            ValueError
    return tuple(t.to("meta") for t in (a, r, s, k)), ValueError


@pytest.mark.parametrize("fault", ["dtype", "rows", "lanes", "layout",
                                   "device"])
def test_wrapper_rejects_bad_inputs(fault):
    args, exc = _bad_cols(fault)
    before = ek8.launches
    with pytest.raises(exc):
        ek8.verify_cols(*args)
    assert ek8.launches == before


def test_wrapper_runs_plain_version_on_cpu_tensors():
    # all-zero columns: A = R = a point of order 4, s = k = 0 -> valid
    z32 = torch.zeros(32, 2, dtype=torch.int32)
    z64 = torch.zeros(64, 2, dtype=torch.int32)
    before = ek8.launches
    ok = ek8.verify_cols(z32, z32, z64, z64)
    assert ok.dtype == torch.bool and ok.tolist() == [True, True]
    assert ek8.launches == before


@pytest.mark.parametrize("value", ["pallas", "pallas8", "xla", "auto",
                                   "CUDA", "cuda9", ""])
def test_unknown_kernel_choice_raises(value, monkeypatch):
    monkeypatch.setenv(ENV, value)
    with pytest.raises(ValueError, match=ENV):
        oe._kernel_choice()
    item = _Gen(3).sig()
    with pytest.raises(ValueError, match=ENV):
        oe.verify_batch([item], device="cpu")


def test_kernel_choice_default_and_jax_variable(monkeypatch):
    """Unset means cuda (B1); the JAX package's COMETBFT_TPU_KERNEL does
    not reach the port; the choice is read on every call."""
    monkeypatch.delenv(ENV, raising=False)
    monkeypatch.setenv("COMETBFT_TPU_KERNEL", "pallas8")
    assert oe._kernel_choice() == "cuda"
    assert oe.KERNELS["cuda"] is ek and oe.KERNELS["cuda8"] is ek8
    monkeypatch.setenv(ENV, "cuda8")
    assert oe._kernel_choice() == "cuda8"
    monkeypatch.setenv(ENV, "cuda")
    assert oe._kernel_choice() == "cuda"


@pytest.mark.slow
def test_plain_matches_pallas8_interpret():
    """B2's plain version against the TPU kernel it replaces, run in
    interpret mode with a block of 8 lanes (slow, as the JAX package's
    own TestPallas8Fallback is)."""
    g = _Gen(21)
    items = [g.sig() for _ in range(3)]
    pub, msg, sig = items[0]
    items += [(pub, msg, sig[:10] + bytes([sig[10] ^ 0xFF]) + sig[11:]),
              (pub, b"other", sig), (pub, msg, sig[:32] + bytes(32))]
    items += _cases("negative_zero")
    assert len(items) == 8
    a, r, s, k, bad = oe.prep_arrays(items, 8)
    want = np.asarray(ep8._pallas_verify(
        *(np.ascontiguousarray(x.T).astype(np.int32) for x in (a, r, s, k)),
        interpret=True, block=8))
    cols = [oe.to_cols(x, CPU) for x in (a, r, s, k)]
    got = ek8.verify_cols_plain(*cols).numpy()
    assert got.tolist() == want.tolist()
    assert _mask(torch.from_numpy(got), bad, 8) == _golden(items)


@pytest.mark.cuda
def test_kernel8_matches_plain_and_first_kernel_on_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    items = (_cases("valid_and_corrupted") + _cases("negative_zero") +
             _cases("small_order") + _cases("non_canonical_y") +
             _cases("random_mix"))
    a, r, s, k, bad = oe.prep_arrays(items, 64)
    dev = torch.device("cuda")
    cols = [oe.to_cols(x, dev) for x in (a, r, s, k)]
    before = ek8.launches
    got = ek8.verify_cols(*cols)
    torch.cuda.synchronize()
    assert ek8.launches == before + 1
    assert torch.equal(got, ek8.verify_cols_plain(*cols))
    assert torch.equal(got, ek.verify_cols(*cols))
    assert _mask(got.cpu(), bad, len(items)) == _golden(items)


def test_build_key_covers_every_source_and_header(tmp_path, monkeypatch):
    """One library from every .cu under csrc/; its name hashes the
    sources and every .cuh, so an edited header cannot load a stale
    build."""
    import shutil
    from cometbft_tpu_torch.ops import _build
    csrc = Path(_build.__file__).parent / "csrc"
    assert sorted(_build.SOURCES) == sorted(p.name for p in csrc.glob("*.cu"))
    assert (csrc / "ed25519_field.cuh").is_file()
    for p in csrc.iterdir():
        shutil.copy(p, tmp_path / p.name)
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    key = _build._source_key()
    header = tmp_path / "ed25519_field.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build._source_key() != key
    header.write_text(header.read_text().replace("\n// edited\n", ""))
    assert _build._source_key() == key
