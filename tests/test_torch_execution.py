"""The port's block executor (cometbft_tpu_torch/state/execution.py) and
its stores against the JAX package's, both driving the same chain:

  * 7 validators for 6 heights, each height built as tests/test_state.py
    ``_run_chain`` builds one (create_proposal_block, the txs spliced in
    through state.make_block, process_proposal, apply_block, save_block
    with the signed commit), with val= txs that add a validator at
    height 2, re-power one at 3 and remove one at 5: the same block
    hashes and ``State.bytes()`` at every height, the same rows in the
    state store, the block store and the app's db, the validator changes
    at h+2, and one launch of B1 a height from height 2;
  * the mirror of ``TestValidatorLoadCache`` (tests/test_state.py:238-300):
    the store's roll-forward cache bit-equal to the cold path, and to
    the JAX package's;
  * every rejection of chip_smoke.py's phase 11d, with the same error
    type and text (the corrupted signature through B1's plain version),
    nothing stored;
  * a kernel that raises inside ``validate_block``: the error leaves
    ``apply_block`` as itself, not as an invalid block, and nothing is
    stored;
  * ``tx_results_hash``, ``provisional_next_state``, ``extend_vote`` and
    ``verify_vote_extension`` as in the JAX package;
  * chip_smoke.py's phase 11 rehearsed at 12 validators for 6 heights.

The JAX side runs its CPU backend; the port ``device="cpu"`` with the
accept-all stand-in kernel where verdicts do not matter.  Tolerance is
byte equality.
"""
import asyncio
import os

import pytest

from cometbft_tpu.abci import types as r_abci
from cometbft_tpu.abci.kvstore import make_val_set_change_tx as r_val_tx
from cometbft_tpu.consensus.replay import Handshaker as RHandshaker
from cometbft_tpu.crypto import batch as r_batch
from cometbft_tpu.crypto import ed25519 as r_ed
from cometbft_tpu.db import MemDB as RMemDB
from cometbft_tpu.state import execution as r_exec
from cometbft_tpu.state import store as r_store
from cometbft_tpu.store import BlockStore as RBlockStore
from cometbft_tpu.store.store import _meta_key as r_meta_key
from cometbft_tpu.types.block_id import BlockID as RBlockID
from cometbft_tpu.types.commit import Commit as RCommit
from cometbft_tpu.types.commit import CommitSig as RCommitSig
from cometbft_tpu.types.validator_set import Validator as RValidator
from cometbft_tpu.types.validator_set import ValidatorSet as RValidatorSet
from cometbft_tpu.types.vote import Vote as RVote
from cometbft_tpu.wire import pb as r_pb
from cometbft_tpu.wire.proto import encode as r_encode
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.abci.kvstore import make_val_set_change_tx
from cometbft_tpu_torch.consensus.replay import Handshaker
from cometbft_tpu_torch.crypto import ed25519 as p_ed
from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.db import MemDB
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import ed25519_kernel8 as ek8
from cometbft_tpu_torch.state import execution
from cometbft_tpu_torch.state import store as p_store
from cometbft_tpu_torch.state.validation import validate_block
from cometbft_tpu_torch.store import BlockStore
from cometbft_tpu_torch.store.store import _meta_key
from cometbft_tpu_torch.types.block_id import BlockID
from cometbft_tpu_torch.types.commit import Commit, CommitSig
from cometbft_tpu_torch.types.validator import Validator
from cometbft_tpu_torch.types.validator_set import ValidatorSet
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.wire import pb
from cometbft_tpu_torch.wire.proto import encode
from torch_chain import RChain, accept_all, cs, port_chain, rows, seeds
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

CHAIN_ID = "exec-parity"
N, TOP, TXS = 7, 6, 12


@pytest.fixture(autouse=True)
def _fresh():
    r_batch.set_backend("cpu")
    yield
    pipeline.reset_workers()
    oe.reset_bucket_tuning()


def _updates(new_seed, genesis_pub, gone_pub):
    """val= txs: add a validator at 2, re-power one at 3, remove one at 5
    (power 0 deletes its record from the app's tree)."""
    new_pub = r_ed.Ed25519PrivKey(new_seed).pub_key().bytes()
    plan = {2: (new_pub, 10), 3: (genesis_pub, 20), 5: (gone_pub, 0)}
    out = {}
    for h, (pub, power) in plan.items():
        tx = make_val_set_change_tx("ed25519", pub, power)
        assert tx == r_val_tx("ed25519", pub, power)
        out[h] = tx
    return out


def _txs(h, updates):
    txs = [cs._load_tx(5, h, j) for j in range(TXS)]
    return txs + ([updates[h]] if h in updates else [])


@pytest.fixture(scope="module")
def chains():
    key_seeds = seeds(N, 101)
    new_seed = seeds(1, 102)[0]
    with pytest.MonkeyPatch.context() as mp:
        rec = accept_all(mp)
        r_batch.set_backend("cpu")
        p = port_chain(CHAIN_ID, key_seeds)
        r = RChain(CHAIN_ID, key_seeds)
        p.seed_of[p_ed.Ed25519PrivKey(new_seed).pub_key().address()] = \
            new_seed
        r.add_keys([new_seed])
        vals = r.state.validators.validators
        updates = _updates(new_seed, vals[0].pub_key.bytes(),
                           vals[1].pub_key.bytes())
        per = []
        for h in range(1, TOP + 1):
            lanes_want = p.state.last_validators.size()
            pb_ = p.step(_txs(h, updates))[0]
            rb_ = r.step(_txs(h, updates))
            per.append({"p_hash": pb_.hash(), "r_hash": rb_.hash(),
                        "p_state": p.state.bytes(),
                        "r_state": r.state.bytes(),
                        "p_size": p.state.validators.size(),
                        "r_size": r.state.validators.size(),
                        "lanes_want": lanes_want})
        launches, lanes = rec["launches"], list(rec["lanes"])
    return {"p": p, "r": r, "per": per, "launches": launches,
            "lanes": lanes}


def test_block_hashes_and_states_equal_at_every_height(chains):
    for h, rec in enumerate(chains["per"], 1):
        assert rec["p_hash"] == rec["r_hash"], h
        assert rec["p_state"] == rec["r_state"], h
    p, r = chains["p"], chains["r"]
    assert p.state.app_hash == r.state.app_hash != b""
    assert p.info().last_block_app_hash == r.info().last_block_app_hash


@pytest.mark.parametrize("db", ["state", "block", "app"])
def test_store_rows_equal(chains, db):
    got, want = rows(chains["p"].dbs[db]), rows(chains["r"].dbs[db])
    assert len(got) == len(want) > 0
    assert got == want


def test_validator_changes_land_at_h_plus_2(chains):
    sizes = [(rec["p_size"], rec["r_size"]) for rec in chains["per"]]
    # after height h the state holds the set of h + 1: the addition from
    # height 2 shows from height 4's set, the removal from 5 at 7
    assert sizes == [(N, N), (N, N), (N + 1, N + 1), (N + 1, N + 1),
                     (N + 1, N + 1), (N, N)]
    p, r = chains["p"], chains["r"]
    assert p.state_store.load_validators(3).size() == N
    assert p.state_store.load_validators(4).size() == N + 1
    assert p.state_store.load_validators(TOP + 1).size() == N
    for h in range(1, TOP + 2):
        assert p.state_store.load_validators(h).to_proto() == \
            r.state_store.load_validators(h).to_proto()
        assert p.state_store.load_consensus_params(h).hash() == \
            r.state_store.load_consensus_params(h).hash()


def test_one_launch_a_height_from_height_two(chains):
    assert chains["launches"] == TOP - 1
    # each launch pads the LastCommit's signatures to the smallest bucket
    assert all(m == oe._bucket(1) for m in chains["lanes"])
    assert [rec["lanes_want"] for rec in chains["per"][1:]] == \
        [N, N, N, N + 1, N + 1]


def test_blocks_and_metas_load_back(chains):
    p, r = chains["p"], chains["r"]
    for h in range(1, TOP + 1):
        blk = p.block_store.load_block(h)
        assert blk.hash() == p.applied[h] == r.applied[h]
        meta = p.block_store.load_block_meta(h)
        assert encode(pb.BLOCK_META, meta.to_proto()) == r_encode(
            r_pb.BLOCK_META, r.block_store.load_block_meta(h).to_proto())
        assert convert.block(r.block_store.load_block(h).to_proto()) \
            .hash() == blk.hash()
        assert p.block_store.load_block_by_hash(blk.hash()).hash() == \
            blk.hash()
        seen = p.block_store.load_seen_commit(h)
        assert seen.hash() == r.block_store.load_seen_commit(h).hash()
    assert p.block_store.load_block_commit(TOP) is None
    assert p.block_store.load_block_commit(TOP - 1).hash() == \
        r.block_store.load_block_commit(TOP - 1).hash()
    fbr = p.state_store.load_finalize_block_response(3)
    assert fbr.app_hash == \
        r.state_store.load_finalize_block_response(3).app_hash
    assert len(fbr.tx_results) == TXS + 1
    assert convert.state(r.state.to_proto()).bytes() == p.state.bytes()


# -- the roll-forward cache (tests/test_state.py:238-300) -------------------

def _store_with_pointers(store_mod, db, desc_encode, vals, last_changed,
                         upto):
    st = store_mod.Store(db)
    st._db.set(store_mod._validators_key(last_changed),
               desc_encode(store_mod.state_pb.VALIDATORS_INFO,
                           {"last_height_changed": last_changed,
                            "validator_set": vals.to_proto()}))
    for h in range(last_changed + 1, upto + 1):
        st._db.set(store_mod._validators_key(h),
                   desc_encode(store_mod.state_pb.VALIDATORS_INFO,
                               {"last_height_changed": last_changed}))
    return st


@pytest.mark.parametrize("powers,priorities", [
    ([100, 200, 300], [0, 0, 0]),
    # a spread wider than twice the total power: the rescale prologue
    # matters, the adversarial case for chained increments
    ([10 ** 9, 10, 1000, 1000, 10 ** 9],
     [5 * 10 ** 9, -5 * 10 ** 9, 0, 17, -3]),
], ids=["plain", "spread"])
def test_validator_load_cache_is_the_cold_path(powers, priorities):
    keys = [p_ed.Ed25519PrivKey(s).pub_key() for s in seeds(len(powers),
                                                             103)]

    def port_set():
        return ValidatorSet([Validator(k.address(), k, p, pr) for k, (p, pr)
                             in zip(keys, zip(powers, priorities))])

    def ref_set():
        rk = [r_ed.Ed25519PubKey(k.bytes()) for k in keys]
        return RValidatorSet([RValidator(address=k.address(), pub_key=k,
                                         voting_power=p, proposer_priority=pr)
                              for k, (p, pr) in zip(rk, zip(powers,
                                                            priorities))])

    upto = 40
    warm = _store_with_pointers(p_store, MemDB(), encode, port_set(), 1,
                                upto)
    cold = _store_with_pointers(p_store, MemDB(), encode, port_set(), 1,
                                upto)
    ref = _store_with_pointers(r_store, RMemDB(), r_encode, ref_set(), 1,
                               upto)
    for h in range(1, upto + 1):
        got = warm.load_validators(h)
        cold._val_cache.clear()
        want = cold.load_validators(h)
        ref._val_cache.clear()
        r_want = ref.load_validators(h)
        pri = [v.proposer_priority for v in got.validators]
        assert pri == [v.proposer_priority for v in want.validators], h
        assert pri == [v.proposer_priority for v in r_want.validators], h
        assert got.get_proposer().address == want.get_proposer().address \
            == r_want.get_proposer().address


def test_validator_load_cache_invalidated_on_rewrite():
    k = p_ed.Ed25519PrivKey(seeds(1, 104)[0]).pub_key()
    vs = ValidatorSet([Validator(k.address(), k, 5, 0)])
    st = _store_with_pointers(p_store, MemDB(), encode, vs, 1, 10)
    st.load_validators(7)
    assert 7 in st._val_cache
    st._save_validators(7, vs, 7)
    assert 7 not in st._val_cache


# -- phase 11d's rejections -------------------------------------------------

def _corrupt(commit, commit_cls, sig_cls, i):
    sigs = list(commit.signatures)
    c = sigs[i]
    sigs[i] = sig_cls(c.block_id_flag, c.validator_address, c.timestamp,
                      bytes([c.signature[0] ^ 1]) + c.signature[1:])
    return commit_cls(commit.height, commit.round, commit.block_id, sigs)


def _short(commit, commit_cls):
    return commit_cls(commit.height, commit.round, commit.block_id,
                      commit.signatures[:-1])


OUTSIDER = bytes(range(20))
CASES = {
    "corrupted_signature": (lambda c, C, S: _corrupt(c, C, S,
                                                     cs.EXEC_BAD_SIG), {}),
    "wrong_app_hash": (lambda c, C, S: c, {"app_hash": b"\x99" * 32}),
    "commit_one_short": (lambda c, C, S: _short(c, C), {}),
    "proposer_outside": (lambda c, C, S: c,
                         {"proposer_address": OUTSIDER}),
}


def _reject(chain, commit_cls, sig_cls, bid_cls, case):
    make_commit, fields = CASES[case]
    state = chain.state
    h = state.last_block_height + 1
    block = state.make_block(h, [cs._load_tx(5, h, 0)],
                             make_commit(chain.last_commit, commit_cls,
                                         sig_cls), [],
                             state.validators.get_proposer().address)
    for k, v in fields.items():
        setattr(block.header, k, v)
    parts = block.make_part_set()
    before = (chain.state_store.load().bytes(), chain.block_store.height,
              chain.info().last_block_height)
    try:
        asyncio.run(chain.exec.apply_block(
            state, bid_cls(block.hash(), parts.header()), block))
    except Exception as e:  # noqa: BLE001 — compared below
        out = (type(e).__name__, str(e))
    else:
        out = ("applied", "")
    after = (chain.state_store.load().bytes(), chain.block_store.height,
             chain.info().last_block_height)
    assert after == before
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_rejections_match(chains, case, monkeypatch):
    if case != "corrupted_signature":
        accept_all(monkeypatch)         # the verdict of B1 does not matter
    p = _reject(chains["p"], Commit, CommitSig, BlockID, case)
    r = _reject(chains["r"], RCommit, RCommitSig, RBlockID, case)
    assert p == r
    assert p[0] == "InvalidBlockError"
    text = {"corrupted_signature": "invalid LastCommit: wrong signature "
                                   f"(#{cs.EXEC_BAD_SIG})",
            "wrong_app_hash": "wrong Block.Header.AppHash",
            "commit_one_short": f"invalid block commit size: want {N + 1}, "
                                f"got {N}",
            "proposer_outside": f"block proposer {OUTSIDER.hex().upper()} "
                                f"is not a validator"}[case]
    assert p[1].startswith(text)


def test_lost_height_replay_error_matches(chains, monkeypatch):
    accept_all(monkeypatch)
    outs = []
    for chain, mem, bs_cls, hs_cls, meta_key, kw in (
            (chains["p"], MemDB, BlockStore, Handshaker, _meta_key,
             {"device": "cpu"}),
            (chains["r"], RMemDB, RBlockStore, RHandshaker, r_meta_key,
             {})):
        lost = mem()
        for k, v in chain.dbs["block"].iterator():
            if k != meta_key(cs.EXEC_MISSING):
                lost.set(k, v)
        app = type(chain.app)(db=mem())
        hs = hs_cls(chain.state_store, chain.state_store.load(),
                    bs_cls(lost), chain.doc, **kw)
        try:
            asyncio.run(hs.handshake(type(chain.conns)(app)))
        except Exception as e:  # noqa: BLE001 — compared below
            outs.append((type(e).__name__, str(e), hs.n_blocks))
    assert outs[0] == outs[1] == (
        "ReplayError", f"block {cs.EXEC_MISSING} missing from store",
        cs.EXEC_MISSING - 1)


# -- a kernel that raises ----------------------------------------------------

def test_kernel_failure_surfaces_as_itself(monkeypatch):
    def broken(a, r, s, k):
        raise RuntimeError("kernel launch failed: unspecified launch "
                           "failure")

    accept_all(monkeypatch)
    chain = port_chain("exec-broken", seeds(4, 105))
    chain.step([b"k1=v1"])
    monkeypatch.setattr(ek, "verify_cols", broken)
    state, h = chain.state, chain.state.last_block_height + 1
    block = state.make_block(h, [b"k2=v2"], chain.last_commit, [],
                             state.validators.get_proposer().address)
    parts = block.make_part_set()
    with pytest.raises(RuntimeError, match="unspecified launch failure"):
        validate_block(state, block, "cpu")
    before = (chain.state_store.load().bytes(), chain.info())
    with pytest.raises(RuntimeError, match="unspecified launch failure") \
            as err:
        asyncio.run(chain.exec.apply_block(
            state, BlockID(block.hash(), parts.header()), block))
    assert not isinstance(err.value, execution.ExecutionError)
    assert (chain.state_store.load().bytes(), chain.info()) == before
    assert chain.block_store.height == 1


def test_executor_device_resolves_at_construction():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from cometbft_tpu_torch.state.store import Store
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        execution.BlockExecutor(Store(MemDB()), None)


# -- the executor's pure functions -------------------------------------------

def test_tx_results_hash_matches():
    results = [abci.ExecTxResult(code=c, data=d, log="nondet", gas_used=g,
                                 codespace=cs_)
               for c, d, g, cs_ in ((0, b"x", 0, ""), (1, b"", 7, "sdk"),
                                    (0, b"y" * 300, 2**40, ""))]
    ref = [r_abci.ExecTxResult(code=r.code, data=r.data, log="other",
                               gas_used=r.gas_used, codespace=r.codespace)
           for r in results]
    assert execution.tx_results_hash(results) == \
        r_exec.tx_results_hash(ref)
    assert execution.tx_results_hash([]) == r_exec.tx_results_hash([])
    for args in ((4194304, 0, 150), (22020096, 1000, 10000)):
        assert execution.max_data_bytes(*args) == \
            r_exec.max_data_bytes(*args)


def test_provisional_next_state_matches(chains):
    p, r = chains["p"], chains["r"]
    h = TOP
    pb_ = p.block_store.load_block(h)
    rb_ = r.block_store.load_block(h)
    pm = p.block_store.load_block_meta(h)
    rm = r.block_store.load_block_meta(h)
    prev_p = convert.state(r.state_store.load().to_proto())
    assert execution.provisional_next_state(
        prev_p, pm.block_id, pb_).bytes() == r_exec.provisional_next_state(
        r.state_store.load(), rm.block_id, rb_).bytes()


def test_extend_and_verify_vote_extension_match(chains):
    p, r = chains["p"], chains["r"]
    h = TOP
    pblk, rblk = p.block_store.load_block(h), r.block_store.load_block(h)
    pbid = p.block_store.load_block_meta(h).block_id
    rbid = r.block_store.load_block_meta(h).block_id
    pvote = Vote(type=2, height=h, block_id=pbid,
                 validator_address=pblk.header.proposer_address)
    rvote = RVote(type=2, height=h, block_id=rbid,
                  validator_address=rblk.header.proposer_address)
    prev_p = p.state_store.load()
    got = (asyncio.run(p.exec.extend_vote(pvote, pblk, prev_p)),
           asyncio.run(p.exec.verify_vote_extension(pvote)))
    want = (asyncio.run(r.exec.extend_vote(rvote, rblk,
                                           r.state_store.load())),
            asyncio.run(r.exec.verify_vote_extension(rvote)))
    assert got == want


# -- chip_smoke.py's phase 11, rehearsed on the CPU ---------------------------

def test_phase_11_rehearsed_at_12_validators(monkeypatch):
    """The phases run as on the card, B1 replaced by a golden-model check
    that counts a launch a tile, at 12 validators for 6 heights and a
    40-key 11c."""
    from cometbft_tpu_torch.crypto import _ed25519_ref as ref
    from cometbft_tpu_torch.crypto.pipeline import DEFAULT_TILE, tile_plan

    def verify_batch(items, device=None, **kw):
        mod = ek8 if os.environ.get(oe.KERNEL_ENV) == "cuda8" else ek
        mod.launches += len(tile_plan(len(items), DEFAULT_TILE))
        mask = [ref.verify(p, m, s) for p, m, s in items]
        return all(mask), mask

    monkeypatch.setattr(oe, "verify_batch", verify_batch)
    monkeypatch.setattr(cs, "_device_busy",
                        lambda fn: (fn(), (1.0, None, None, 0))[1])
    for name, value in (("EXEC_VALIDATORS", 12), ("EXEC_HEIGHTS", 6),
                        ("EXEC_UPDATES", (2, 3, 4)), ("EXEC_PROFILED", 2),
                        ("EXEC_SQLITE_HEIGHTS", 2)):
        monkeypatch.setattr(cs, name, value)
    keys = [p_ed.Ed25519PubKey(cs._fast_pub_job(cs._seed(0, j)))
            for j in range(40)]
    launches, launches8 = cs._exec_phases(0, "CPU", None, keys,
                                          device="cpu")
    assert launches == {"chain_150x100": 5, "block_10k": 1,
                        "exec_reject": 2}
    assert launches8 == {"block_10k_cuda8": 1}
