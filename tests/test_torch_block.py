"""The port's block types (cometbft_tpu_torch/types/block.py, part_set.py,
params.py, genesis.py, proposal.py, tx.py, crypto/merkle.py) against the
JAX package's, byte for byte:

  * merkle proofs of 0..17 items: the same root and aunts, each proof
    verifies, a tampered leaf or root is refused with the same text;
  * ``Data`` and the tx hashes; ``Block`` hash, proto bytes, fill_header
    and validate_basic (and its refusals, with the same texts);
  * ``PartSet`` of 1, 2 and 17 parts: the same header and part bytes,
    every proof verifies, ``add_part`` rebuilds the set from the JAX
    package's parts, ``Block.from_parts`` round-trips;
  * ``BlockMeta``, ``make_block``;
  * consensus params: hash, proto bytes, updates and refusals;
  * the genesis doc: its JSON both ways and validate_and_complete's
    refusals;
  * a proposal's sign bytes and MockPV's signatures.

Inputs come from seeded numpy generators; the JAX package's objects are
carried across through their ``to_proto()`` dicts.
"""
import json

import numpy as np
import pytest

from cometbft_tpu.crypto import ed25519 as r_ed
from cometbft_tpu.crypto import merkle as r_merkle
from cometbft_tpu.types import block as r_block
from cometbft_tpu.types import genesis as r_genesis
from cometbft_tpu.types import params as r_params
from cometbft_tpu.types import part_set as r_part_set
from cometbft_tpu.types import priv_validator as r_pv
from cometbft_tpu.types import proposal as r_proposal
from cometbft_tpu.types import tx as r_tx
from cometbft_tpu.types.block_id import BlockID as RBlockID
from cometbft_tpu.types.commit import Commit as RCommit
from cometbft_tpu.types.commit import CommitSig as RCommitSig
from cometbft_tpu.types.part_set import PartSetHeader as RPSH
from cometbft_tpu.types.timestamp import Timestamp as RTimestamp
from cometbft_tpu.types.vote import Vote as RVote
from cometbft_tpu.wire import pb as r_pb
from cometbft_tpu.wire.proto import encode as r_encode
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import ed25519 as p_ed
from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.types import block as p_block
from cometbft_tpu_torch.types import genesis, params, part_set, tx
from cometbft_tpu_torch.types import priv_validator, proposal
from cometbft_tpu_torch.types.block_id import BlockID
from cometbft_tpu_torch.types.part_set import PartSetHeader
from cometbft_tpu_torch.types.timestamp import Timestamp
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.wire import pb
from cometbft_tpu_torch.wire.proto import encode
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)


def _items(n, seed, size=40):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(rng.integers(0, size))) for _ in range(n)]


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — compared by the caller
        return type(e).__name__, str(e)
    return None


# -- merkle ----------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 7, 8, 9, 17])
def test_merkle_proofs_match(n):
    items = _items(n, 10 + n)
    root, proofs = merkle.proofs_from_byte_slices(items)
    r_root, r_proofs = r_merkle.proofs_from_byte_slices(items)
    assert root == r_root == merkle.hash_from_byte_slices(items)
    assert [(p.total, p.index, p.leaf_hash, p.aunts) for p in proofs] == \
        [(p.total, p.index, p.leaf_hash, p.aunts) for p in r_proofs]
    for item, proof in zip(items, proofs):
        proof.verify(root, item)
    if n:
        assert _error(lambda: proofs[0].verify(root, items[0] + b"x")) == \
            _error(lambda: r_proofs[0].verify(root, items[0] + b"x"))
        assert _error(lambda: proofs[-1].verify(b"\0" * 32, items[-1])) == \
            _error(lambda: r_proofs[-1].verify(b"\0" * 32, items[-1]))
    hashes = [merkle.leaf_hash(it) for it in items]
    assert merkle.root_from_leaf_hashes(hashes) == \
        r_merkle.root_from_leaf_hashes(hashes) == root


def test_value_op_leaf_matches():
    for key, value in ((b"k", b"v"), (b"a" * 200, b""), (b"", b"x" * 300)):
        assert merkle.value_op_leaf(key, value) == \
            r_merkle.value_op_leaf(key, value)


# -- data and blocks ---------------------------------------------------------

def _pair_commit(n_sigs, seed):
    """A height-4 commit in both packages (signatures are random bytes:
    nothing here verifies them)."""
    rng = np.random.default_rng(seed)
    bid = (rng.bytes(32), 3, rng.bytes(32))
    sigs = [(2, rng.bytes(20), (1_700_000_000 + i, i), rng.bytes(64))
            for i in range(n_sigs)] + [(1, b"", None, b"")]
    r = RCommit(4, 1, RBlockID(bid[0], RPSH(bid[1], bid[2])), [
        RCommitSig(f, a, RTimestamp(*t) if t else RTimestamp.zero(), s)
        for f, a, t, s in sigs])
    return convert.commit(r.to_proto()), r


def _pair_block(txs, n_sigs=3, seed=1, height=5):
    p_commit, r_commit = _pair_commit(n_sigs, seed)
    hdr = dict(chain_id="blocks", height=height,
               validators_hash=b"\x01" * 32, proposer_address=b"\x02" * 20)
    r = r_block.Block(header=r_block.Header(**hdr),
                      data=r_block.Data(txs=list(txs)),
                      last_commit=r_commit)
    r.fill_header()
    p = p_block.Block(header=p_block.Header(**hdr),
                      data=p_block.Data(txs=list(txs)),
                      last_commit=p_commit)
    p.fill_header()
    return p, r


def test_data_and_tx_hashes_match():
    for n in (0, 1, 5, 33):
        txs = _items(n, 100 + n, 300)
        assert p_block.Data(txs=txs).hash() == r_block.Data(txs=txs).hash()
        assert tx.txs_hash(txs) == r_tx.txs_hash(txs)
        assert tx.hash_each(txs) == r_tx.hash_each(txs)
    for n in (0, 127, 128, 16383, 16384, 2**21):
        assert tx.compute_proto_size_overhead(n) == \
            r_tx.compute_proto_size_overhead(n)


def test_block_hash_proto_and_validate_basic_match():
    p, r = _pair_block(_items(9, 3, 200))
    assert p.hash() == r.hash() != b""
    assert p.header.last_commit_hash == r.header.last_commit_hash
    assert p.last_commit.hash() == r.last_commit.hash()
    assert encode(pb.BLOCK, p.to_proto()) == r_encode(r_pb.BLOCK,
                                                      r.to_proto())
    assert convert.block(r_encode(r_pb.BLOCK, r.to_proto())).hash() == \
        p.hash()
    p.validate_basic()
    r.validate_basic()
    assert str(p) == str(r)


@pytest.mark.parametrize("fault", ["data_hash", "last_commit_hash",
                                   "evidence_hash", "height", "commit"])
def test_block_refusals_match(fault):
    p, r = _pair_block(_items(3, 4, 50))
    for b in (p, r):
        if fault == "height":
            b.header.height = 0
        elif fault == "commit":
            b.last_commit.signatures[0].signature = b"x" * 200
        else:
            setattr(b.header, fault, b"\x07" * 32)
    got, want = _error(p.validate_basic), _error(r.validate_basic)
    assert got == want and got is not None


def test_block_median_time_matches():
    from cometbft_tpu.types.validator import Validator as RValidator
    from cometbft_tpu.types.validator_set import ValidatorSet as RVS
    from cometbft_tpu_torch.types.validator import Validator
    from cometbft_tpu_torch.types.validator_set import ValidatorSet
    rng = np.random.default_rng(7)
    keys = [rng.bytes(32) for _ in range(6)]
    powers = [int(rng.integers(1, 100)) for _ in keys]
    rvals = RVS([RValidator.new(r_ed.Ed25519PrivKey(k).pub_key(), w)
                 for k, w in zip(keys, powers)])
    pvals = ValidatorSet([Validator.new(p_ed.Ed25519PrivKey(k).pub_key(), w)
                          for k, w in zip(keys, powers)])
    sigs = [RCommitSig(2, v.address,
                       RTimestamp(1_700_000_000 + int(rng.integers(0, 9)),
                                  int(rng.integers(0, 10**9))),
                       b"s" * 64) for v in rvals.validators]
    sigs[2] = RCommitSig.absent()
    rc = RCommit(3, 0, RBlockID(b"h" * 32, RPSH(1, b"p" * 32)), sigs)
    pc = convert.commit(rc.to_proto())
    assert pc.median_time(pvals) == Timestamp(*rc.median_time(rvals))


@pytest.mark.parametrize("want_parts", [1, 2, 17])
def test_part_sets_match(want_parts):
    # a 4,096-byte tx encodes in 4,099 bytes: one more than fill
    # want_parts - 1 parts
    n = (want_parts - 1) * part_set.BLOCK_PART_SIZE // 4099 + 1
    rng = np.random.default_rng(want_parts)
    txs = [rng.bytes(4096) for _ in range(n)]
    p, r = _pair_block(txs, n_sigs=2, seed=want_parts)
    ps, rps = p.make_part_set(), r.make_part_set()
    assert ps.total == rps.total == want_parts
    assert ps.header() == PartSetHeader(rps.header().total,
                                        rps.header().hash)
    assert ps.byte_size == rps.byte_size
    assert ps.is_complete()
    for i in range(ps.total):
        part, rpart = ps.get_part(i), rps.get_part(i)
        assert encode(pb.PART, part.to_proto()) == \
            r_encode(r_pb.PART, rpart.to_proto())
        part.proof.verify(ps.header().hash, part.bytes_)
    # the JAX package's parts fill an empty port set, in reverse order
    fresh = part_set.PartSet(ps.header())
    for i in reversed(range(rps.total)):
        assert fresh.add_part(part_set.Part.from_proto(
            rps.get_part(i).to_proto()))
        assert not fresh.add_part(part_set.Part.from_proto(
            rps.get_part(i).to_proto()))
    assert fresh.is_complete() and fresh.assemble() == ps.assemble()
    back = p_block.Block.from_parts(fresh)
    assert back.hash() == p.hash()
    assert encode(pb.BLOCK, back.to_proto()) == encode(pb.BLOCK,
                                                       p.to_proto())


def test_part_refusals_match():
    p, r = _pair_block(_items(40, 9, 4000), seed=9)
    ps, rps = p.make_part_set(1024), r.make_part_set(1024)
    assert ps.total == rps.total > 2
    bad = part_set.Part.from_proto(ps.get_part(1).to_proto())
    rbad = r_part_set.Part.from_proto(rps.get_part(1).to_proto())
    outs = []
    for mod, part, header in ((part_set, bad, ps.header()),
                              (r_part_set, rbad, rps.header())):
        fresh = mod.PartSet(header)
        tampered = mod.Part(part.index, part.bytes_[:-1] + b"\0", part.proof)
        outs.append((_error(lambda: fresh.add_part(tampered)),
                     _error(lambda: fresh.add_part(mod.Part(
                         header.total, b"", part.proof))),
                     _error(fresh.assemble)))
    assert outs[0] == outs[1]
    assert all(e is not None for e in outs[0])


def test_block_meta_and_make_block_match():
    p, r = _pair_block(_items(4, 12, 100))
    ps, rps = p.make_part_set(), r.make_part_set()
    meta = p_block.BlockMeta(p.block_id(ps.header()), ps.byte_size,
                             p.header, len(p.data.txs))
    rmeta = r_block.BlockMeta(r.block_id(rps.header()), rps.byte_size,
                              r.header, len(r.data.txs))
    raw = r_encode(r_pb.BLOCK_META, rmeta.to_proto())
    assert encode(pb.BLOCK_META, meta.to_proto()) == raw
    assert encode(pb.BLOCK_META, convert.block_meta(raw).to_proto()) == raw
    txs = _items(5, 13)
    pm = p_block.make_block(7, txs, p.last_commit, [])
    rm = r_block.make_block(7, txs, r.last_commit, [])
    assert encode(pb.BLOCK, pm.to_proto()) == r_encode(r_pb.BLOCK,
                                                       rm.to_proto())


# -- consensus params --------------------------------------------------------

def _params_pairs():
    yield params.default_consensus_params(), \
        r_params.default_consensus_params()
    p, r = params.ConsensusParams(), r_params.ConsensusParams()
    for c in (p, r):
        c.block.max_bytes = 22020096
        c.block.max_gas = -1
        c.evidence.max_age_num_blocks = 7
        c.synchrony.precision_ns = 1_500_000_123
        c.feature.pbts_enable_height = 3
        c.feature.vote_extensions_enable_height = 9
        c.validator.pub_key_types = ["ed25519", "secp256k1"]
        c.version.app = 4
    yield p, r


@pytest.mark.parametrize("i", range(2))
def test_params_hash_and_proto_match(i):
    p, r = list(_params_pairs())[i]
    assert p.hash() == r.hash()
    raw = r_encode(r_pb.CONSENSUS_PARAMS, r.to_proto())
    assert encode(pb.CONSENSUS_PARAMS, p.to_proto()) == raw
    assert convert.consensus_params(raw).hash() == p.hash()
    assert p.feature.pbts_enabled(3) == r.feature.pbts_enabled(3)
    assert p.feature.aggregate_commits_enabled(5) == \
        r.feature.aggregate_commits_enabled(5)
    upd_p = params.ConsensusParams(block=params.BlockParams(1000, 5),
                                   evidence=None, validator=None,
                                   version=None, synchrony=None,
                                   feature=None)
    upd_r = r_params.ConsensusParams(block=r_params.BlockParams(1000, 5),
                                     evidence=None, validator=None,
                                     version=None, synchrony=None,
                                     feature=None)
    assert encode(pb.CONSENSUS_PARAMS, p.update(upd_p).to_proto()) == \
        r_encode(r_pb.CONSENSUS_PARAMS, r.update(upd_r).to_proto())
    assert params.BLOCK_PART_SIZE_BYTES == r_params.BLOCK_PART_SIZE_BYTES \
        == 65536


@pytest.mark.parametrize("fault", [
    ("block", "max_bytes", 0), ("block", "max_gas", -2),
    ("evidence", "max_age_num_blocks", 0),
    ("validator", "pub_key_types", ["rsa"]),
    ("synchrony", "precision_ns", 0),
    ("feature", "aggregate_commit_enable_height", 5)])
def test_params_refusals_match(fault):
    sub, name, value = fault
    p, r = params.ConsensusParams(), r_params.ConsensusParams()
    setattr(getattr(p, sub), name, value)
    setattr(getattr(r, sub), name, value)
    got, want = _error(p.validate_basic), _error(r.validate_basic)
    assert got == want and got is not None


# -- genesis -----------------------------------------------------------------

def _genesis_pair(n=3, seed=21):
    rng = np.random.default_rng(seed)
    keys = [rng.bytes(32) for _ in range(n)]
    common = dict(chain_id="genesis-parity",
                  initial_height=5, app_hash=b"\x11" * 32,
                  app_state={"accounts": [1, 2]})
    p = genesis.GenesisDoc(
        genesis_time=Timestamp(1_700_000_000, 123_000_000),
        validators=[genesis.GenesisValidator(
            b"", p_ed.Ed25519PrivKey(k).pub_key(), 10 + i, f"v{i}")
            for i, k in enumerate(keys)], **common)
    r = r_genesis.GenesisDoc(
        genesis_time=RTimestamp(1_700_000_000, 123_000_000),
        validators=[r_genesis.GenesisValidator(
            b"", r_ed.Ed25519PrivKey(k).pub_key(), 10 + i, f"v{i}")
            for i, k in enumerate(keys)], **common)
    return p, r


def test_genesis_json_matches_both_ways():
    p, r = _genesis_pair()
    p.validate_and_complete()
    r.validate_and_complete()
    assert p.to_json() == r.to_json()
    assert p.validator_hash() == r.validator_hash()
    back = convert.genesis_doc(r.to_json())
    assert back.to_json() == r.to_json()
    assert genesis.GenesisDoc.from_json(p.to_json()).to_json() == \
        r_genesis.GenesisDoc.from_json(p.to_json()).to_json()
    assert json.loads(p.to_json())["validators"][0]["pub_key"]["type"] == \
        "tendermint/PubKeyEd25519"


@pytest.mark.parametrize("fault", ["chain_id", "long_chain_id", "power",
                                   "address", "initial_height", "params"])
def test_genesis_refusals_match(fault):
    p, r = _genesis_pair(seed=22)
    for d, mod in ((p, params), (r, r_params)):
        if fault == "chain_id":
            d.chain_id = ""
        elif fault == "long_chain_id":
            d.chain_id = "c" * 51
        elif fault == "power":
            d.validators[1].power = 0
        elif fault == "address":
            d.validators[0].address = b"\x01" * 20
        elif fault == "initial_height":
            d.initial_height = -1
        else:
            d.consensus_params = mod.ConsensusParams(
                block=mod.BlockParams(max_bytes=0))
    got, want = _error(p.validate_and_complete), \
        _error(r.validate_and_complete)
    assert got == want and got is not None


# -- proposals and MockPV ----------------------------------------------------

def test_proposal_and_mock_pv_match():
    rng = np.random.default_rng(31)
    seed = rng.bytes(32)
    bid_args = (rng.bytes(32), 2, rng.bytes(32))
    p = proposal.Proposal(height=9, round=2, pol_round=1,
                          block_id=BlockID(bid_args[0], PartSetHeader(
                              bid_args[1], bid_args[2])),
                          timestamp=Timestamp(1_700_000_009, 5))
    r = r_proposal.Proposal(height=9, round=2, pol_round=1,
                            block_id=RBlockID(bid_args[0], RPSH(
                                bid_args[1], bid_args[2])),
                            timestamp=RTimestamp(1_700_000_009, 5))
    assert p.sign_bytes("c") == r.sign_bytes("c")
    pv = priv_validator.MockPV(p_ed.Ed25519PrivKey(seed))
    rpv = r_pv.MockPV(r_ed.Ed25519PrivKey(seed))
    pv.sign_proposal("c", p)
    rpv.sign_proposal("c", r)
    assert p.signature == r.signature
    p.validate_basic()
    assert encode(pb.PROPOSAL, p.to_proto()) == r_encode(r_pb.PROPOSAL,
                                                         r.to_proto())
    v = Vote(type=2, height=9, round=2, block_id=p.block_id,
             timestamp=Timestamp(1_700_000_010, 0),
             validator_address=pv.get_pub_key().address())
    rv = RVote(type=2, height=9, round=2, block_id=r.block_id,
               timestamp=RTimestamp(1_700_000_010, 0),
               validator_address=rpv.get_pub_key().address())
    pv.sign_vote("c", v, sign_extension=True)
    rpv.sign_vote("c", rv, sign_extension=True)
    assert (v.signature, v.extension_signature,
            v.non_rp_extension_signature) == \
        (rv.signature, rv.extension_signature,
         rv.non_rp_extension_signature)
    bad = proposal.Proposal(height=9, round=1, pol_round=1,
                            block_id=p.block_id, signature=b"s")
    rbad = r_proposal.Proposal(height=9, round=1, pol_round=1,
                               block_id=r.block_id, signature=b"s")
    assert _error(bad.validate_basic) == _error(rbad.validate_basic)
