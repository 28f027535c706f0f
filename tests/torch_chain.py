"""Chains built height by height in both packages, for the parity tests of
the chain below consensus (test_torch_execution.py, test_torch_replay.py).

The port's side is chip_smoke.py's ``_ExecChain`` (the chain phase 11
drives on the card) on ``device="cpu"`` with a serial signer; the JAX
package's side, ``RChain``, takes the same steps with the same seeded
keys: genesis, the Handshaker's InitChain, then each height as
tests/test_state.py ``_run_chain`` builds it.  Keys come from a seeded
numpy generator.
"""
import asyncio
import sys
from pathlib import Path

import numpy as np
import torch

from cometbft_tpu.abci import types as r_abci
from cometbft_tpu.abci.client import AppConns as RAppConns
from cometbft_tpu.abci.kvstore import KVStoreApplication as RKVStore
from cometbft_tpu.consensus.replay import Handshaker as RHandshaker
from cometbft_tpu.crypto import ed25519 as r_ed
from cometbft_tpu.db import MemDB as RMemDB
from cometbft_tpu.state import make_genesis_state as r_make_genesis_state
from cometbft_tpu.state.execution import BlockExecutor as RBlockExecutor
from cometbft_tpu.state.store import Store as RStore
from cometbft_tpu.store import BlockStore as RBlockStore
from cometbft_tpu.types import canonical as r_canonical
from cometbft_tpu.types.block_id import BlockID as RBlockID
from cometbft_tpu.types.commit import Commit as RCommit
from cometbft_tpu.types.commit import CommitSig as RCommitSig
from cometbft_tpu.types.genesis import GenesisDoc as RGenesisDoc
from cometbft_tpu.types.genesis import GenesisValidator as RGenesisValidator
from cometbft_tpu.types.timestamp import Timestamp as RTimestamp
from cometbft_tpu.types.vote import BLOCK_ID_FLAG_COMMIT
from cometbft_tpu_torch.ops import ed25519_kernel as ek

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def seeds(n, base):
    rng = np.random.default_rng(base)
    return [rng.bytes(32) for _ in range(n)]


def accept_all(monkeypatch):
    """The accept-all stand-in kernel: counts its launches and the lanes
    of each."""
    rec = {"launches": 0, "lanes": []}

    def verify_cols(a, r, s, k):
        rec["launches"] += 1
        rec["lanes"].append(int(a.shape[1]))
        return torch.ones(a.shape[1], dtype=torch.bool)

    monkeypatch.setattr(ek, "verify_cols", verify_cols)
    return rec


def port_chain(chain_id, key_seeds, **kw):
    return cs._ExecChain(chain_id, key_seeds, cs._Signer(), device="cpu",
                         **kw)


class RChain:
    """The JAX package's side of ``cs._ExecChain``: the same genesis, the
    same steps, commits signed with the JAX package's keys."""

    def __init__(self, chain_id, key_seeds, power=cs.EXEC_POWER):
        keys = [r_ed.Ed25519PrivKey(s) for s in key_seeds]
        self.chain_id = chain_id
        self.priv_of = {k.pub_key().address(): k for k in keys}
        self.doc = RGenesisDoc(
            chain_id=chain_id, genesis_time=RTimestamp(cs.EXEC_T0, 0),
            validators=[RGenesisValidator(b"", k.pub_key(), power)
                        for k in keys])
        self.dbs = {"state": RMemDB(), "block": RMemDB(), "app": RMemDB()}
        state = r_make_genesis_state(self.doc)
        self.app = RKVStore(db=self.dbs["app"])
        self.conns = RAppConns(self.app)
        self.state_store = RStore(self.dbs["state"])
        self.block_store = RBlockStore(self.dbs["block"])
        self.state_store.save(state)
        asyncio.run(RHandshaker(self.state_store, state, self.block_store,
                                self.doc).handshake(self.conns))
        self.state = state
        self.exec = RBlockExecutor(self.state_store, self.conns.consensus,
                                   block_store=self.block_store)
        self.last_commit = RCommit()
        self.applied = {}

    def add_keys(self, key_seeds):
        for s in key_seeds:
            k = r_ed.Ed25519PrivKey(s)
            self.priv_of[k.pub_key().address()] = k

    def sign_commit(self, vals, h, block_id, skip=()):
        slots = []
        for i, v in enumerate(vals.validators):
            if i in skip:
                slots.append(RCommitSig.absent())
                continue
            ts = RTimestamp(cs.EXEC_T0 + h, i + 1)
            msg = r_canonical.vote_sign_bytes(
                self.chain_id, r_canonical.PRECOMMIT_TYPE, h, 0, block_id,
                ts)
            slots.append(RCommitSig(BLOCK_ID_FLAG_COMMIT, v.address, ts,
                                    self.priv_of[v.address].sign(msg)))
        return RCommit(h, 0, block_id, slots)

    async def _propose_apply(self, txs):
        state = self.state
        h = state.last_block_height + 1
        proposer = state.validators.get_proposer()
        block = await self.exec.create_proposal_block(
            h, state, self.last_commit.wrapped_extended_commit(),
            proposer.address)
        block = state.make_block(h, txs, self.last_commit, [],
                                 proposer.address,
                                 block_time=block.header.time)
        parts = block.make_part_set()
        block_id = RBlockID(block.hash(), parts.header())
        assert await self.exec.process_proposal(block, state)
        self.state = await self.exec.apply_block(state, block_id, block)
        return block, parts, block_id, state.validators

    def step(self, txs):
        block, parts, block_id, signing_set = asyncio.run(
            self._propose_apply(txs))
        commit = self.sign_commit(signing_set, block.header.height,
                                  block_id)
        self.block_store.save_block(block, parts, commit)
        self.last_commit = commit
        self.applied[block.header.height] = block.hash()
        return block

    def info(self, conns=None):
        return asyncio.run((conns or self.conns).query.info(
            r_abci.InfoRequest()))


def rows(db):
    """Every (key, value) row of a db of either package, in key order."""
    return list(db.iterator())
