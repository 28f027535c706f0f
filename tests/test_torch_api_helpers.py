"""The port's last public names against the JAX package's, on the same
seeded inputs:

  * ``types/tx.txs_proof``: root and proof for n in {1, 2, 3, 7, 64} at
    every index, each proof verified against the root, and its
    ``TxProof`` (``wire/pb.TX_PROOF``) bytes and round trip;
  * ``wire/proto.Msg.empty`` and ``wire/pb.APP_VERSION``: the same bytes;
  * ``ValidatorSet.__len__``, ``__iter__``, ``__str__`` on a seeded set
    and an empty one;
  * ``BitArray.and_`` and ``is_full`` on random arrays of unequal sizes,
    0 bits included;
  * ``Logger.with_`` and ``set_module_level``: the formatted line, and a
    module set to ``error`` drops ``info`` (the loggers' roots differ:
    ``cometbft`` and ``cometbft_torch``, so names are not compared);
  * ``DB.delete_sync``, ``DB.compact``, ``SQLiteDB.compact`` and
    ``Batch.close`` on MemDB, SQLiteDB and PrefixDB: every key reads
    back as in the JAX package;
  * ``crypto/batch.PAD_BUCKETS`` and ``pad_bucket`` for n in 0..20,000
    after each side's ``reset_bucket_tuning()``;
  * the golden model's ``IDENT`` and ``batch_verify``: the same
    ``(ok, mask)`` under the same ``rand_fn`` on good, bad and malformed
    batches;
  * ``Bls12381PubKey.point`` (the affine point of the plain formulas)
    and both ``ENABLED`` flags;
  * ``ops/field.py``'s ``constant``, ``carry_fold``, ``normalize``,
    ``add``, ``sub``, ``neg``, ``mul_const``, ``bytes_to_limbs`` and
    ``canonical_bytes``: the same value mod p on the port's own limbs
    (``canonical_bytes``: the same bytes);
  * the constants: ``ADDRESS_SIZE``, ``NIL_BLOCK_ID``,
    ``MAX_HEADER_BYTES``, ``MAX_OVERHEAD_FOR_BLOCK``, ``ZERO``, the
    package's ``__version__`` and protocol numbers, ``ABCI_VERSION``.

``Client.trusted_light_block`` is in test_torch_light_client.py and
``CListMempool.iter_entries`` in test_torch_mempool.py, beside the
clients and pools those files build.
"""
import logging
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cometbft_tpu
import cometbft_tpu_torch
from cometbft_tpu import version as r_version
from cometbft_tpu.crypto import _ed25519_ref as r_ref
from cometbft_tpu.crypto import _native_loader
from cometbft_tpu.crypto import batch as r_batch
from cometbft_tpu.crypto import bls12381 as r_bls
from cometbft_tpu.crypto import keys as r_keys
from cometbft_tpu.crypto import secp256k1eth as r_secp_eth
from cometbft_tpu.db import db as r_db
from cometbft_tpu.libs import bits as r_bits
from cometbft_tpu.libs import log as r_log
from cometbft_tpu.ops import ed25519_jax as r_ej
from cometbft_tpu.state import execution as r_exec
from cometbft_tpu.ops import field as r_field
from cometbft_tpu.types import block as r_block
from cometbft_tpu.types import block_id as r_block_id
from cometbft_tpu.types import timestamp as r_timestamp
from cometbft_tpu.types import tx as r_tx
from cometbft_tpu.types.validator import Validator as RValidator
from cometbft_tpu.types.validator_set import ValidatorSet as RValidatorSet
from cometbft_tpu.wire import decode as r_decode
from cometbft_tpu.wire import encode as r_encode
from cometbft_tpu.wire import pb as r_pb
from cometbft_tpu.crypto.ed25519 import Ed25519PrivKey as REd25519PrivKey
from cometbft_tpu_torch import version
from cometbft_tpu_torch.crypto import _ed25519_ref as ref
from cometbft_tpu_torch.crypto import batch
from cometbft_tpu_torch.crypto import bls12381
from cometbft_tpu_torch.crypto import keys
from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.crypto import secp256k1eth
from cometbft_tpu_torch.crypto.ed25519 import Ed25519PrivKey
from cometbft_tpu_torch.db import db
from cometbft_tpu_torch.libs import bits
from cometbft_tpu_torch.libs import log
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.ops import field
from cometbft_tpu_torch.state import execution
from cometbft_tpu_torch.types import block
from cometbft_tpu_torch.types import block_id
from cometbft_tpu_torch.types import timestamp
from cometbft_tpu_torch.types import tx
from cometbft_tpu_torch.types.validator import Validator
from cometbft_tpu_torch.types.validator_set import ValidatorSet
from cometbft_tpu_torch.wire import decode, encode, pb
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

P = field.P


def _txs(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(rng.integers(0, 40))) for _ in range(n)]


def _proof_proto(p):
    return {"total": p.total, "index": p.index, "leaf_hash": p.leaf_hash,
            "aunts": list(p.aunts)}


# --- types/tx.txs_proof, wire/pb.TX_PROOF, Msg.empty, APP_VERSION ----------

@pytest.mark.parametrize("n", [1, 2, 3, 7, 64])
def test_txs_proof_matches_the_reference_at_every_index(n):
    txs = _txs(n, 100 + n)
    assert tx.txs_hash(txs) == r_tx.txs_hash(txs)
    for i in range(n):
        root, proof = tx.txs_proof(txs, i)
        r_root, r_proof = r_tx.txs_proof(txs, i)
        assert root == r_root == tx.txs_hash(txs)
        assert proof.to_dict() == r_proof.to_dict()
        proof.verify(root, tx.tx_hash(txs[i]))
        r_proof.verify(r_root, r_tx.tx_hash(txs[i]))
        msg = {"root_hash": root, "data": txs[i],
               "proof": _proof_proto(proof)}
        raw = encode(pb.TX_PROOF, msg)
        assert raw == r_encode(r_pb.TX_PROOF, msg)
        assert encode(pb.PROOF, _proof_proto(proof)) == \
            r_encode(r_pb.PROOF, _proof_proto(r_proof))
        back = decode(pb.TX_PROOF, raw)
        assert back == r_decode(r_pb.TX_PROOF, raw)
        assert back.get("root_hash", b"") == root
        assert back.get("data", b"") == txs[i]
        pp = back.get("proof", {})
        again = merkle.Proof(total=pp.get("total", 0),
                             index=pp.get("index", 0),
                             leaf_hash=pp.get("leaf_hash", b""),
                             aunts=list(pp.get("aunts", [])))
        assert again.to_dict() == proof.to_dict()
        again.verify(back["root_hash"], tx.tx_hash(txs[i]))


def test_a_proof_does_not_verify_another_tx():
    txs = _txs(7, 5)
    root, proof = tx.txs_proof(txs, 3)
    with pytest.raises(Exception) as got:
        proof.verify(root, tx.tx_hash(txs[4] + b"x"))
    r_root, r_proof = r_tx.txs_proof(txs, 3)
    with pytest.raises(Exception) as want:
        r_proof.verify(r_root, r_tx.tx_hash(txs[4] + b"x"))
    assert str(got.value) == str(want.value)


def test_empty_message_and_app_version_encode_as_the_reference():
    assert pb.APP_VERSION.empty() == r_pb.APP_VERSION.empty() == {}
    assert pb.TX_PROOF.empty() == r_pb.TX_PROOF.empty() == {}
    for msg in ({}, {"protocol": 3}, {"software": "kvstore-1.2"},
                {"protocol": 2**63 + 5, "software": "é"}):
        raw = encode(pb.APP_VERSION, msg)
        assert raw == r_encode(r_pb.APP_VERSION, msg)
        assert decode(pb.APP_VERSION, raw) == \
            r_decode(r_pb.APP_VERSION, raw)
    assert encode(pb.APP_VERSION, pb.APP_VERSION.empty()) == b""
    assert pb.APP_VERSION.name == r_pb.APP_VERSION.name
    assert pb.TX_PROOF.name == r_pb.TX_PROOF.name


# --- ValidatorSet dunders -----------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 5])
def test_validator_set_len_iter_str_match_the_reference(n):
    rng = np.random.default_rng(40 + n)
    seeds = [rng.bytes(32) for _ in range(n)]
    powers = [int(rng.integers(1, 100)) for _ in range(n)]
    vs = ValidatorSet([Validator.new(Ed25519PrivKey(s).pub_key(), p)
                       for s, p in zip(seeds, powers)])
    r_vs = RValidatorSet([RValidator.new(REd25519PrivKey(s).pub_key(), p)
                          for s, p in zip(seeds, powers)])
    assert len(vs) == len(r_vs) == n
    assert bool(vs) == bool(r_vs) == (n > 0)
    assert [v.address for v in vs] == [v.address for v in r_vs]
    assert [v.voting_power for v in vs] == [v.voting_power for v in r_vs]
    assert str(vs) == str(r_vs)


# --- libs/bits ---------------------------------------------------------------

def _bit_pair(rng, n):
    on = [i for i in range(n) if rng.random() < 0.6]
    return bits.BitArray.from_indices(n, on), \
        r_bits.BitArray.from_indices(n, on)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_and_and_is_full_match_the_reference(seed):
    rng = random.Random(seed)
    sizes = [0, 1, 7, 8, 9, 63, 64, 65, 200]
    for _ in range(60):
        a, ra = _bit_pair(rng, rng.choice(sizes))
        b, rb = _bit_pair(rng, rng.choice(sizes))
        got, want = a.and_(b), ra.and_(rb)
        assert (got.size(), got.true_indices()) == \
            (want.size(), want.true_indices())
        assert got.to_le_bytes() == want.to_le_bytes()
        full = bits.BitArray.from_indices(a.size(), range(a.size()))
        r_full = r_bits.BitArray.from_indices(ra.size(), range(ra.size()))
        for x, rx in ((a, ra), (b, rb), (got, want), (full, r_full)):
            assert x.is_full() == rx.is_full()
        assert full.is_full() == (a.size() > 0)


# --- libs/log ----------------------------------------------------------------

class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.lines = []

    def emit(self, record):
        self.lines.append((record.levelname, record.getMessage()))


def _capture(logger_obj):
    h = _Lines()
    logger_obj._logger.addHandler(h)
    return h


def test_with_binds_the_same_fields():
    out = []
    for mod in (log, r_log):
        lg = mod.new_logger("api-parity-with", level="debug")
        h = _capture(lg)
        bound = lg.with_(height=7, peer=b"\x01\xab", note="two words")
        bound.info("hello", round=2)
        bound.with_(height=8).debug("again")
        lg.info("plain")
        out.append(h.lines)
    assert out[0] == out[1]
    assert out[0][0] == ("INFO", "hello height=7 peer=01AB "
                                 "note='two words' round=2")


def test_set_module_level_drops_info_below_error():
    out = []
    for mod in (log, r_log):
        lg = mod.new_logger("api-parity-level")
        h = _capture(lg)
        mod.set_module_level("api-parity-level", "error")
        lg.info("dropped")
        lg.error("kept", code=1)
        mod.set_module_level("api-parity-level", "debug")
        lg.debug("back")
        out.append(h.lines)
    assert out[0] == out[1] == [("ERROR", "kept code=1"), ("DEBUG", "back")]


# --- db ----------------------------------------------------------------------

def _dbs(kind, tmp_path):
    if kind == "mem":
        return db.MemDB(), r_db.MemDB()
    if kind == "sqlite":
        return (db.SQLiteDB(str(tmp_path / "port.db")),
                r_db.SQLiteDB(str(tmp_path / "ref.db")))
    return (db.PrefixDB(db.MemDB(), b"pre/"),
            r_db.PrefixDB(r_db.MemDB(), b"pre/"))


@pytest.mark.parametrize("kind", ["mem", "sqlite", "prefix"])
def test_delete_sync_compact_and_batch_close_match_the_reference(
        kind, tmp_path):
    rng = np.random.default_rng(9)
    keys_ = [rng.bytes(int(rng.integers(1, 9))) for _ in range(40)]
    out = []
    for d in _dbs(kind, tmp_path):
        for k in keys_:
            d.set(k, k[::-1] + b"v")
        for k in keys_[:10]:
            d.delete_sync(k)
        d.compact()
        d.compact(keys_[20], keys_[30])
        b = d.new_batch()
        for k in keys_[10:20]:
            b.delete(k)
        b.set(b"never", b"written")
        b.close()
        b.write()            # a closed batch writes nothing
        b2 = d.new_batch()
        b2.set(b"after", b"close")
        b2.write_sync()
        out.append(([d.get(k) for k in keys_ + [b"never", b"after"]],
                    list(d.iterator())))
        d.close()
    assert out[0] == out[1]


# --- crypto/batch pad buckets ---------------------------------------------------

def test_pad_buckets_match_the_reference_for_every_n():
    oe.reset_bucket_tuning()
    r_ej.reset_bucket_tuning()
    assert batch.PAD_BUCKETS == r_batch.PAD_BUCKETS
    assert [batch.pad_bucket(n) for n in range(20_001)] == \
        [r_batch.pad_bucket(n) for n in range(20_001)]


# --- the golden model -------------------------------------------------------

def _rand_fn(seed):
    rng = random.Random(seed)
    return lambda: rng.getrandbits(128) | 1


def _sig_items(seed, n):
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(n):
        sk, msg = rng.bytes(32), rng.bytes(int(rng.integers(0, 50)))
        items.append((ref.public_key(sk), msg, ref.sign(sk, msg)))
    return items


def _malformed(items):
    pub, msg, sig = items[0]
    high_s = sig[:32] + (ref.L + 1).to_bytes(32, "little")
    off_curve = bytes([2]) + bytes(31)     # y = 2 has no x on the curve
    return [(pub, msg, sig[:63]), (pub[:31], msg, sig),
            (pub, msg, high_s), (pub, msg, off_curve + sig[32:]),
            (off_curve, msg, sig)]


@pytest.mark.parametrize("case", ["good", "bad", "malformed", "empty"])
def test_golden_batch_verify_matches_the_reference(case):
    items = _sig_items(70, 3)
    if case == "bad":
        pub, msg, sig = items[1]
        items[1] = (pub, msg + b"!", sig)
    elif case == "malformed":
        items = items[:1] + _malformed(items)
    elif case == "empty":
        items = []
    got = ref.batch_verify(items, rand_fn=_rand_fn(5))
    want = r_ref.batch_verify(items, rand_fn=_rand_fn(5))
    assert got == want
    assert got[0] == (case in ("good", "empty"))
    assert ref.batch_verify(items) == want      # its own randomizers
    assert ref.IDENT == r_ref.IDENT == (0, 1)
    assert ref.is_identity_cofactored(ref.IDENT)


# --- BLS point and the ENABLED flags -------------------------------------------

def test_bls_point_is_the_references_affine_point():
    _native_loader.load()
    rng = np.random.default_rng(31)
    for _ in range(3):
        secret = rng.bytes(32)
        pk = bls12381.gen_priv_key_from_secret(secret).pub_key()
        r_pk = r_bls.gen_priv_key_from_secret(secret).pub_key()
        assert pk.bytes() == r_pk.bytes()
        assert pk.point() == tuple(r_pk.point())
        assert bls12381.Bls12381PubKey(pk.bytes()).point() == pk.point()
    assert bls12381.ENABLED == r_bls.ENABLED is True
    assert secp256k1eth.ENABLED == r_secp_eth.ENABLED is True


# --- ops/field helpers ---------------------------------------------------------

def _jax(x):
    return jnp.asarray(r_field.to_limbs(x))


def _val(t):
    return field.from_limbs(t)


@pytest.mark.parametrize("seed", [0, 1])
def test_field_helpers_hold_the_same_value_mod_p(seed):
    rng = random.Random(seed)
    for _ in range(12):
        x, y = rng.randrange(2**256), rng.randrange(2**256)
        c = rng.randrange(1 << 15)
        px, py = field.constant(x, "cpu"), field.constant(y, "cpu")
        jx, jy = r_field.constant(x), r_field.constant(y)
        assert _val(px) == r_field.from_limbs(jx) == x % P
        lazy = field.add(field.sub(px, py), field.neg(field.add(px, px)))
        r_lazy = r_field.add(r_field.sub(jx, jy),
                             r_field.neg(r_field.add(jx, jx)))
        assert _val(lazy) == r_field.from_limbs(r_lazy) == (-x - y) % P
        assert _val(field.carry_fold(lazy)) == \
            r_field.from_limbs(r_field.carry_fold(r_lazy))
        assert _val(field.normalize(lazy)) == \
            r_field.from_limbs(r_field.normalize(r_lazy))
        assert _val(field.normalize(lazy, passes=1)) == \
            r_field.from_limbs(r_field.normalize(r_lazy, passes=1))
        assert _val(field.mul_const(px, c)) == \
            r_field.from_limbs(r_field.mul_const(jx, c)) == x * c % P
        raw = np.frombuffer(x.to_bytes(32, "little"), np.uint8)
        limbs = field.bytes_to_limbs(torch.from_numpy(raw.copy()))
        r_limbs = r_field.bytes_to_limbs(jnp.asarray(raw))
        assert _val(limbs) == r_field.from_limbs(r_limbs) == x % P
        got = field.canonical_bytes(lazy).numpy().tobytes()
        want = np.asarray(r_field.canonical_bytes(r_lazy)).tobytes()
        assert got == want == ((-x - y) % P).to_bytes(32, "little")


def test_bytes_above_p_keep_their_value():
    for x in (P, P + 1, 2**255 - 1, 2**256 - 1, 2**255 + 19):
        raw = np.frombuffer(x.to_bytes(32, "little"), np.uint8)
        limbs = field.bytes_to_limbs(torch.from_numpy(raw.copy()))
        assert _val(limbs) == r_field.from_limbs(
            r_field.bytes_to_limbs(jnp.asarray(raw))) == x % P
        assert field.canonical_bytes(limbs).numpy().tobytes() == \
            np.asarray(r_field.canonical_bytes(
                r_field.bytes_to_limbs(jnp.asarray(raw)))).tobytes()


# --- constants -------------------------------------------------------------------

def test_constants_equal_the_references():
    assert keys.ADDRESS_SIZE == r_keys.ADDRESS_SIZE == 20
    assert block_id.NIL_BLOCK_ID.to_proto() == \
        r_block_id.NIL_BLOCK_ID.to_proto()
    assert block_id.NIL_BLOCK_ID.is_nil()
    assert (block.MAX_HEADER_BYTES, block.MAX_OVERHEAD_FOR_BLOCK) == \
        (r_block.MAX_HEADER_BYTES, r_block.MAX_OVERHEAD_FOR_BLOCK)
    assert tuple(timestamp.ZERO) == tuple(r_timestamp.ZERO)
    assert timestamp.ZERO.is_zero()
    for name in ("__version__", "BLOCK_PROTOCOL", "P2P_PROTOCOL",
                 "ABCI_SEMVER"):
        assert getattr(cometbft_tpu_torch, name) == \
            getattr(cometbft_tpu, name)
    assert version.ABCI_VERSION == r_version.ABCI_VERSION == \
        version.ABCI_SEM_VER


def test_max_data_bytes_reads_the_public_pair(monkeypatch):
    """state/execution takes the pair from types/block: moving them
    moves its cap."""
    args = (22_020_096, 1_000, 150)
    assert execution.max_data_bytes(*args) == r_exec.max_data_bytes(*args)
    monkeypatch.setattr(execution, "MAX_HEADER_BYTES",
                        block.MAX_HEADER_BYTES + 10)
    assert execution.max_data_bytes(*args) == \
        r_exec.max_data_bytes(*args) - 10
