"""The light client's types in the port against the JAX package's:

  * ``Header.hash``, the header and light-block wire bytes and
    ``validate_basic`` on seeded random headers, per-signature and
    aggregate signed headers (cometbft_tpu/types/block.py);
  * ``ValidatorSet.update_with_change_set``: hash, order, priorities and
    proposer after seeded add / update / remove sets, the memoised hash
    and address index dropped by every change, and the error texts of
    invalid change sets (cometbft_tpu/types/validator_set.py);
  * evidence bytes, hash and ``get_byzantine_validators`` for a lunatic
    fork, an equivocation and an amnesia case, per-signature and
    aggregate, and duplicate-vote evidence (cometbft_tpu/types/evidence.py);
  * the ordered key-value stores and ``TrustedStore`` on MemDB, PrefixDB
    and SQLiteDB: heights, ``first``, ``latest``, ``prune``, and a store
    the JAX package wrote on disk read back by the port;
  * ``convert.header`` / ``signed_header`` / ``light_block`` /
    ``evidence`` round trips from the JAX object's proto and wire bytes.

Inputs come from seeded numpy generators; equality is exact.  No
signature is verified here.
"""
import dataclasses

import numpy as np
import pytest

from cometbft_tpu.crypto import ed25519 as r_ed
from cometbft_tpu.db import db as r_db
from cometbft_tpu.libs.bits import BitArray as RBitArray
from cometbft_tpu.light.store import TrustedStore as RTrustedStore
from cometbft_tpu.types import block as r_block
from cometbft_tpu.types import canonical as r_canonical
from cometbft_tpu.types import evidence as r_evidence
from cometbft_tpu.types.block_id import BlockID as RBlockID
from cometbft_tpu.types.commit import AggregateCommit as RAggregateCommit
from cometbft_tpu.types.commit import Commit as RCommit
from cometbft_tpu.types.commit import CommitSig as RCommitSig
from cometbft_tpu.types.part_set import PartSetHeader as RPSH
from cometbft_tpu.types.timestamp import Timestamp as RTimestamp
from cometbft_tpu.types.validator import Validator as RValidator
from cometbft_tpu.types.validator_set import ValidatorSet as RValidatorSet
from cometbft_tpu.types.vote import Vote as RVote
from cometbft_tpu.wire import encode as r_encode
from cometbft_tpu.wire import pb as rpb
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.db import db as p_db
from cometbft_tpu_torch.light.store import TrustedStore
from cometbft_tpu_torch.types import evidence as p_evidence
from cometbft_tpu_torch.types.validator import Validator
from cometbft_tpu_torch.types.validator_set import ValidatorSet
from cometbft_tpu_torch.wire import encode, pb
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

CHAIN_ID = "light-types"
COMMIT = 2
ABSENT = 1


def _outcome(fn, *args):
    try:
        out = fn(*args)
    except Exception as e:  # noqa: BLE001 — the text is what is compared
        return type(e).__name__, str(e)
    return "ok", out


def _privs(rng, n):
    return [r_ed.Ed25519PrivKey(rng.bytes(32)) for _ in range(n)]


def _rset(privs, powers=None):
    powers = powers or [10] * len(privs)
    return RValidatorSet([RValidator.new(p.pub_key(), w)
                          for p, w in zip(privs, powers)])


def _pset(rset):
    return convert.validator_set(rset.to_proto())


def _commit(rset, privs, header, signers=None, round_=0):
    """A JAX commit of header by rset; unsigned slots absent."""
    by_addr = {p.pub_key().address(): p for p in privs}
    bid = RBlockID(header.hash(), RPSH(1, b"\x5a" * 32))
    sigs = []
    for i, v in enumerate(rset.validators):
        if signers is not None and i not in signers:
            sigs.append(RCommitSig.absent())
            continue
        ts = RTimestamp(header.time.seconds, i + 1)
        vote = RVote(type=r_canonical.PRECOMMIT_TYPE, height=header.height,
                     round=round_, block_id=bid, timestamp=ts,
                     validator_address=v.address, validator_index=i)
        sigs.append(RCommitSig(COMMIT, v.address, ts,
                               by_addr[v.address].sign(
                                   vote.sign_bytes(CHAIN_ID))))
    return RCommit(height=header.height, round=round_, block_id=bid,
                   signatures=sigs)


def _header(rng, rset, next_set, height=None, app_hash=None):
    def maybe():
        return rng.bytes(32) if rng.random() < 0.7 else b""

    return r_block.Header(
        version=r_block.ConsensusVersion(
            block=11, app=int(rng.integers(0, 3))),
        chain_id=CHAIN_ID,
        height=height or int(rng.integers(1, 1 << 40)),
        time=RTimestamp(int(rng.integers(1, 1 << 33)),
                        int(rng.integers(0, 10**9))),
        last_block_id=RBlockID(rng.bytes(32), RPSH(
            int(rng.integers(1, 9)), rng.bytes(32)))
        if rng.random() < 0.8 else RBlockID(),
        last_commit_hash=maybe(), data_hash=maybe(),
        validators_hash=rset.hash(),
        next_validators_hash=next_set.hash(),
        consensus_hash=maybe(),
        app_hash=app_hash if app_hash is not None else
        rng.bytes(int(rng.integers(0, 40))),
        last_results_hash=maybe(), evidence_hash=maybe(),
        proposer_address=rset.get_proposer().address)


def _light_block(rng, n=4, height=None):
    privs = _privs(rng, n)
    rset = _rset(privs, [int(w) for w in rng.integers(1, 50, n)])
    hdr = _header(rng, rset, rset, height)
    commit = _commit(rset, privs, hdr)
    return r_block.LightBlock(r_block.SignedHeader(hdr, commit), rset)


# -- headers and light blocks -------------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_header_hash_and_light_block_bytes(seed):
    rng = np.random.default_rng(seed)
    rlb = _light_block(rng, n=int(rng.integers(1, 7)))
    rh = rlb.signed_header.header
    for src in (rh.to_proto(), r_encode(rpb.HEADER, rh.to_proto())):
        ph = convert.header(src)
        assert ph.hash() == rh.hash()
        assert encode(pb.HEADER, ph.to_proto()) == \
            r_encode(rpb.HEADER, rh.to_proto())
    want = r_encode(rpb.LIGHT_BLOCK, rlb.to_proto())
    for src in (rlb.to_proto(), want):
        plb = convert.light_block(src)
        assert encode(pb.LIGHT_BLOCK, plb.to_proto()) == want
        assert plb.hash() == rlb.hash() and plb.height == rlb.height
        assert _outcome(plb.validate_basic, CHAIN_ID) == \
            _outcome(rlb.validate_basic, CHAIN_ID) == ("ok", None)
    psh = convert.signed_header(
        r_encode(rpb.SIGNED_HEADER, rlb.signed_header.to_proto()))
    assert psh.to_proto() == rlb.signed_header.to_proto()


def test_incomplete_header_hashes_empty():
    hdr = r_block.Header(chain_id=CHAIN_ID, height=3)
    assert convert.header(hdr.to_proto()).hash() == hdr.hash() == b""
    zero = r_block.Header(validators_hash=b"\x01" * 32)
    assert convert.header(zero.to_proto()).hash() == zero.hash()


@pytest.mark.parametrize("seed", range(3))
def test_aggregate_signed_header_bytes(seed):
    rng = np.random.default_rng(100 + seed)
    privs = _privs(rng, 9)
    rset = _rset(privs)
    hdr = _header(rng, rset, rset)
    agg = RAggregateCommit(
        height=hdr.height, round=1,
        block_id=RBlockID(hdr.hash(), RPSH(1, rng.bytes(32))),
        signers=RBitArray.from_indices(9, [0, 2, 3, 5, 6, 8]),
        signature=rng.bytes(96))
    rlb = r_block.LightBlock(r_block.SignedHeader(hdr, agg), rset)
    want = r_encode(rpb.LIGHT_BLOCK, rlb.to_proto())
    plb = convert.light_block(want)
    assert encode(pb.LIGHT_BLOCK, plb.to_proto()) == want
    assert type(plb.signed_header.commit).__name__ == "AggregateCommit"
    assert _outcome(plb.validate_basic, CHAIN_ID) == \
        _outcome(rlb.validate_basic, CHAIN_ID)


def _set_header(name, value):
    return lambda lb: setattr(lb.signed_header.header, name, value)


def _set_commit(name, value):
    return lambda lb: setattr(lb.signed_header.commit, name, value)


def _set_sig(i, name, value):
    return lambda lb: setattr(lb.signed_header.commit.signatures[i], name,
                              value)


def _drop(obj, name):
    def mut(lb):
        setattr(lb.signed_header if obj == "sh" else lb, name, None)
    return mut


def _proposer_address(lb):
    lb.validator_set.proposer = dataclasses.replace(
        lb.validator_set.proposer, address=b"\x07" * 20)


def _empty_set(lb):
    lb.validator_set.validators = []


VALIDATE_CASES = {
    "ok": lambda lb: None,
    "protocol": lambda lb: setattr(
        lb.signed_header.header, "version",
        type(lb.signed_header.header.version)(block=10)),
    "chain_id_long": _set_header("chain_id", "c" * 51),
    "other_chain": _set_header("chain_id", "other"),
    "zero_height": _set_header("height", 0),
    "negative_height": _set_header("height", -4),
    "last_commit_hash": _set_header("last_commit_hash", b"\x01" * 31),
    "evidence_hash": _set_header("evidence_hash", b"\x01" * 33),
    "proposer_len": _set_header("proposer_address", b"\x01" * 19),
    "next_vals_hash": _set_header("next_validators_hash", b"\x01" * 3),
    "commit_height": _set_commit("height", 77),
    "negative_round": _set_commit("round", -1),
    "unknown_flag": _set_sig(1, "block_id_flag", 7),
    "absent_with_address": lambda lb: (
        setattr(lb.signed_header.commit.signatures[0], "block_id_flag",
                ABSENT)),
    "missing_signature": _set_sig(2, "signature", b""),
    "signature_too_big": _set_sig(0, "signature", b"\x01" * 97),
    "address_size": _set_sig(1, "validator_address", b"\x01" * 21),
    "header_differs": _set_header("app_hash", b"other app"),
    "no_commit": _drop("sh", "commit"),
    "no_header": _drop("sh", "header"),
    "no_signed_header": _drop("lb", "signed_header"),
    "no_validator_set": _drop("lb", "validator_set"),
    "vals_hash": _set_header("validators_hash", b"\x02" * 32),
    "proposer_not_in_set": _proposer_address,
    "empty_set": _empty_set,
}


@pytest.mark.parametrize("case", sorted(VALIDATE_CASES))
def test_light_block_validate_basic_texts(case):
    rng = np.random.default_rng(7)
    rlb = _light_block(rng, n=4, height=12)
    plb = convert.light_block(rlb.to_proto())
    VALIDATE_CASES[case](rlb)
    VALIDATE_CASES[case](plb)
    want = _outcome(rlb.validate_basic, CHAIN_ID)
    assert _outcome(plb.validate_basic, CHAIN_ID) == want
    assert (want[0] == "ok") == (case == "ok")


# -- validator-set change sets ------------------------------------------------

def _both(rvals):
    return rvals, [Validator.from_proto(v.to_proto()) for v in rvals]


def _state(vs):
    return (vs.hash(), [(v.address, v.voting_power, v.proposer_priority)
                        for v in vs.validators],
            vs.get_proposer().address, vs.total_voting_power(),
            vs.to_proto())


@pytest.mark.parametrize("seed", range(10))
def test_update_with_change_set_matches_reference(seed):
    rng = np.random.default_rng(200 + seed)
    pool = _privs(rng, 24)
    start = [RValidator.new(p.pub_key(), int(w)) for p, w in
             zip(pool[:int(rng.integers(2, 10))],
                 rng.integers(1, 1000, 10))]
    rset = RValidatorSet(start)
    # built, not decoded: the proposer is then one of the set's own
    # validators on both sides, and moves with their priorities
    pset = ValidatorSet(_both(start)[1])
    assert _state(pset) == _state(rset)
    for _ in range(4):
        changes = []
        for p in rng.permutation(len(pool))[:int(rng.integers(1, 7))]:
            kind = rng.random()
            power = 0 if kind < 0.3 else int(rng.integers(1, 5000))
            changes.append(RValidator.new(pool[p].pub_key(), power))
        r_changes, p_changes = _both(changes)
        want = _outcome(rset.update_with_change_set, r_changes)
        assert _outcome(pset.update_with_change_set, p_changes) == want
        assert _state(pset) == _state(rset)
        times = int(rng.integers(1, 5))
        rcp = rset.copy_increment_proposer_priority(times)
        pcp = pset.copy_increment_proposer_priority(times)
        assert _state(pcp) == _state(rcp)
        assert _state(pset) == _state(rset)
    rset.increment_proposer_priority(3)
    pset.increment_proposer_priority(3)
    assert _state(pset) == _state(rset)


def test_update_drops_the_memos():
    rng = np.random.default_rng(5)
    privs = _privs(rng, 8)
    pset = _pset(_rset(privs[:5]))
    old_hash = pset.hash()
    gone = pset.validators[1].address
    assert pset.index_by_address(gone) == 1 and pset.has_address(gone)
    cp = pset.copy()
    changes = [Validator.from_proto(RValidator.new(p.pub_key(), w)
                                    .to_proto())
               for p, w in ((privs[5], 50), (privs[6], 3))]
    changes.append(Validator(gone, pset.validators[1].pub_key, 0))
    pset.update_with_change_set(changes)
    fresh = ValidatorSet([Validator(v.address, v.pub_key, v.voting_power)
                          for v in pset.validators])
    assert pset.hash() == fresh.hash() != old_hash
    assert pset.index_by_address(gone) == -1 and not pset.has_address(gone)
    assert pset.get_by_address(gone) == (-1, None)
    for i, v in enumerate(pset.validators):
        assert pset.index_by_address(v.address) == i
        assert pset.get_by_address(v.address)[0] == i
    # the copy kept the old members, hash and index
    assert cp.hash() == old_hash and cp.index_by_address(gone) == 1
    r_cp = RValidatorSet.from_proto(cp.to_proto())
    assert r_cp.hash() == old_hash


def _vals(privs, powers):
    return [RValidator.new(p.pub_key(), w) for p, w in zip(privs, powers)]


CHANGE_ERRORS = {
    "duplicate": lambda privs: _vals([privs[0], privs[0]], [5, 6]),
    "negative": lambda privs: _vals([privs[5]], [-1]),
    "too_big": lambda privs: _vals([privs[5]], [(2**63 - 1) // 8 + 1]),
    "remove_unknown": lambda privs: _vals([privs[6]], [0]),
    "remove_all": lambda privs: _vals(privs[:3], [0, 0, 0]),
    "overflow": lambda privs: _vals(privs[4:6], [(2**63 - 1) // 8 - 10,
                                                 (2**63 - 1) // 8 - 10]),
}


@pytest.mark.parametrize("case", sorted(CHANGE_ERRORS))
def test_invalid_change_set_texts(case):
    rng = np.random.default_rng(11)
    privs = _privs(rng, 8)
    rset = _rset(privs[:3])
    pset = _pset(rset)
    r_changes, p_changes = _both(CHANGE_ERRORS[case](privs))
    want = _outcome(rset.update_with_change_set, r_changes)
    assert want[0] != "ok"
    assert _outcome(pset.update_with_change_set, p_changes) == want


@pytest.mark.parametrize("powers", [[10, 0, 5], [10, -3], [10, 10]])
def test_new_set_rejections_match(powers):
    rng = np.random.default_rng(12)
    privs = _privs(rng, 3)
    if powers == [10, 10]:
        privs = [privs[0], privs[0]]
    r_vals, p_vals = _both(_vals(privs, powers))
    assert _outcome(ValidatorSet, p_vals)[0] == \
        _outcome(RValidatorSet, r_vals)[0] != "ok"
    assert _outcome(ValidatorSet, p_vals)[1] == \
        _outcome(RValidatorSet, r_vals)[1]


# -- evidence -----------------------------------------------------------------

class Attack:
    """A trusted light block at a height and a conflicting one signed by
    a common set (and some outsiders)."""

    def __init__(self, seed, kind, aggregate):
        rng = np.random.default_rng(300 + seed)
        privs = _privs(rng, 10)
        self.common = _rset(privs[:6], [10, 20, 10, 30, 10, 10])
        trusted_h = _header(rng, self.common, self.common, height=20,
                            app_hash=b"app")
        if kind == "lunatic":
            conf_set = _rset(privs[2:9])
            conf_h = _header(rng, conf_set, conf_set, height=20,
                             app_hash=b"lunatic")
            round_ = 0
        else:
            conf_set = self.common
            conf_h = _header(rng, conf_set, conf_set, height=20,
                             app_hash=b"app")
            conf_h.validators_hash = trusted_h.validators_hash
            conf_h.next_validators_hash = trusted_h.next_validators_hash
            conf_h.consensus_hash = trusted_h.consensus_hash
            conf_h.last_results_hash = trusted_h.last_results_hash
            round_ = 0 if kind == "equivocation" else 2
        trusted_c = _commit(self.common, privs, trusted_h,
                            signers={0, 1, 3, 4, 5})
        conf_signers = {0, 1, 2, 4, 5, 6} & set(range(conf_set.size()))
        if aggregate:
            conf_c = RAggregateCommit(
                height=20, round=round_,
                block_id=RBlockID(conf_h.hash(), RPSH(1, b"\x11" * 32)),
                signers=RBitArray.from_indices(conf_set.size(),
                                               sorted(conf_signers)),
                signature=rng.bytes(96))
        else:
            conf_c = _commit(conf_set, privs, conf_h, signers=conf_signers,
                             round_=round_)
        self.trusted = r_block.SignedHeader(trusted_h, trusted_c)
        conf = r_block.LightBlock(r_block.SignedHeader(conf_h, conf_c),
                                  conf_set)
        self.ev = r_evidence.LightClientAttackEvidence(
            conflicting_block=conf, common_height=17,
            total_voting_power=self.common.total_voting_power(),
            timestamp=RTimestamp(1_700_000_017, 5))
        self.ev.byzantine_validators = self.ev.get_byzantine_validators(
            self.common, self.trusted)


@pytest.mark.parametrize("aggregate", [False, True],
                         ids=["per_signature", "aggregate"])
@pytest.mark.parametrize("kind", ["lunatic", "equivocation", "amnesia"])
def test_attack_evidence_matches_reference(kind, aggregate):
    a = Attack(0, kind, aggregate)
    wrapped = a.ev.to_proto_wrapped()
    for src in (wrapped, r_encode(rpb.EVIDENCE, wrapped)):
        pev = convert.evidence(src)
        assert pev.bytes() == a.ev.bytes()
        assert pev.hash() == a.ev.hash()
    pev = convert.evidence(wrapped)
    common = _pset(a.common)
    trusted = convert.signed_header(a.trusted.to_proto())
    got = pev.get_byzantine_validators(common, trusted)
    want = a.ev.get_byzantine_validators(a.common, a.trusted)
    assert [v.to_proto() for v in got] == [v.to_proto() for v in want]
    if kind == "amnesia":
        assert not want
    else:
        assert want
    assert pev.conflicting_header_is_invalid(trusted.header) == \
        a.ev.conflicting_header_is_invalid(a.trusted.header) == \
        (kind == "lunatic")
    assert _outcome(pev.validate_basic) == _outcome(a.ev.validate_basic)
    assert p_evidence.evidence_list_hash([pev, pev]) == \
        r_evidence.evidence_list_hash([a.ev, a.ev])


def test_duplicate_vote_evidence_matches_reference():
    rng = np.random.default_rng(400)
    privs = _privs(rng, 4)
    rset = _rset(privs)
    by_addr = {p.pub_key().address(): p for p in privs}
    addr = rset.validators[2].address

    def vote(bid):
        v = RVote(type=r_canonical.PREVOTE_TYPE, height=9, round=1,
                  block_id=bid, timestamp=RTimestamp(1_700_000_009, 3),
                  validator_address=addr, validator_index=2)
        v.signature = by_addr[addr].sign(v.sign_bytes(CHAIN_ID))
        return v

    va = vote(RBlockID(b"\xee" * 32, RPSH(1, b"\x01" * 32)))
    vb = vote(RBlockID(b"\x0e" * 32, RPSH(1, b"\x01" * 32)))
    when = RTimestamp(1_700_000_010, 0)
    rev = r_evidence.DuplicateVoteEvidence.new(va, vb, when, rset)
    pev = p_evidence.DuplicateVoteEvidence.new(
        convert.vote(va.to_proto()), convert.vote(vb.to_proto()),
        convert.header({"time": when.to_proto()}).time, _pset(rset))
    assert pev.bytes() == rev.bytes() and pev.hash() == rev.hash()
    assert convert.evidence(r_encode(rpb.EVIDENCE, rev.to_proto_wrapped())
                            ).bytes() == rev.bytes()
    assert _outcome(pev.validate_basic) == _outcome(rev.validate_basic)
    swapped = p_evidence.DuplicateVoteEvidence(pev.vote_b, pev.vote_a)
    r_swapped = r_evidence.DuplicateVoteEvidence(rev.vote_b, rev.vote_a)
    assert _outcome(swapped.validate_basic) == \
        _outcome(r_swapped.validate_basic) != ("ok", None)
    assert _outcome(convert.evidence, {"other": {}}) == \
        _outcome(r_evidence.evidence_from_proto_wrapped, {"other": {}})


# -- key-value stores and the trusted store -----------------------------------

def _dbs(backend, tmp_path):
    if backend == "mem":
        return r_db.MemDB(), p_db.MemDB()
    if backend == "prefix":
        r_base, p_base = r_db.MemDB(), p_db.MemDB()
        for base in (r_base, p_base):
            base.set(b"lc", b"outside")
            base.set(b"lb/zzz", b"outside too")
        return (r_db.PrefixDB(r_base, b"light/"),
                p_db.PrefixDB(p_base, b"light/"))
    return (r_db.SQLiteDB(str(tmp_path / "jax" / "light.db")),
            p_db.SQLiteDB(str(tmp_path / "port" / "light.db")))


@pytest.mark.parametrize("backend", ["mem", "prefix", "sqlite"])
def test_kv_iteration_and_batches_match(backend, tmp_path):
    rdb, pdb = _dbs(backend, tmp_path)
    rng = np.random.default_rng(500)
    keys = [bytes(rng.integers(0, 256, int(rng.integers(1, 4)),
                               dtype=np.uint8)) for _ in range(40)]
    for db in (rdb, pdb):
        for i, k in enumerate(keys):
            db.set(k, b"v%d" % i)
        b = db.new_batch()
        b.set(b"\x00batch", b"1")
        b.delete(keys[3])
        b.write()
        db.delete(keys[5])
    for start, end in ((None, None), (b"\x10", b"\x80"), (b"\x80", None),
                       (None, b"\x05")):
        assert list(pdb.iterator(start, end)) == \
            list(rdb.iterator(start, end))
        assert list(pdb.reverse_iterator(start, end)) == \
            list(rdb.reverse_iterator(start, end))
    assert [pdb.get(k) for k in keys] == [rdb.get(k) for k in keys]
    assert _outcome(pdb.set, b"", b"x") == _outcome(rdb.set, b"", b"x")
    for db in (rdb, pdb):
        db.close()


@pytest.mark.parametrize("backend", ["mem", "prefix", "sqlite"])
def test_trusted_store_matches_reference(backend, tmp_path):
    rdb, pdb = _dbs(backend, tmp_path)
    rstore, pstore = RTrustedStore(rdb), TrustedStore(pdb)
    rng = np.random.default_rng(600)
    for h in (5, 1, 9, 3, 300, 7, 2**40):
        rlb = _light_block(rng, n=3, height=h)
        rstore.save_light_block(rlb)
        pstore.save_light_block(convert.light_block(rlb.to_proto()))

    def view(store):
        return (store.heights(), store.first().height,
                store.latest().height,
                [store.light_block(h).to_proto() for h in store.heights()],
                store.light_block(4))

    assert view(pstore) == view(rstore)
    assert pstore.prune(4) == rstore.prune(4) == 3
    assert view(pstore) == view(rstore)
    pstore.delete(2**40)
    rstore.delete(2**40)
    assert view(pstore) == view(rstore)
    assert pstore.prune() == rstore.prune() == 0
    for h in pstore.heights():
        pstore.delete(h)
    assert pstore.latest() is None and pstore.first() is None
    for db in (rdb, pdb):
        db.close()


def test_port_reads_the_reference_store_on_disk(tmp_path):
    path = str(tmp_path / "shared.db")
    rdb = r_db.new_db("shared", "sqlite", str(tmp_path))
    rstore = RTrustedStore(rdb)
    rng = np.random.default_rng(700)
    blocks = [_light_block(rng, n=4, height=h) for h in (3, 8, 13)]
    for rlb in blocks:
        rstore.save_light_block(rlb)
    rdb.close()
    pdb = p_db.new_db("shared", "sqlite", str(tmp_path))
    pstore = TrustedStore(pdb)
    assert pstore.heights() == [3, 8, 13]
    for rlb in blocks:
        plb = pstore.light_block(rlb.height)
        assert encode(pb.LIGHT_BLOCK, plb.to_proto()) == \
            r_encode(rpb.LIGHT_BLOCK, rlb.to_proto())
        assert plb.hash() == rlb.hash()
    assert pstore.latest().hash() == blocks[-1].hash()
    pdb.close()
    assert str(tmp_path / "shared.db") == path
    assert _outcome(p_db.new_db, "x", "leveldb?") == \
        _outcome(r_db.new_db, "x", "leveldb?")
