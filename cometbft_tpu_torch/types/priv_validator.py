"""PrivValidator: the validator signing interface.

Reference: types/priv_validator.go — SignVote / SignProposal /
SignBytes(raw) over a PrivKey; MockPV for tests — through
cometbft_tpu/types/priv_validator.py.  MockPV takes its key from the
caller, so a test can make it from a seed; ``new_mock_pv`` makes one on
a fresh random ed25519 key.  The file-backed signer with double-sign
protection is not ported.
"""
from __future__ import annotations

import abc

from ..crypto.keys import PrivKey, PubKey
from .proposal import Proposal
from .vote import Vote
from . import canonical


class PrivValidatorError(Exception):
    pass


class PrivValidator(abc.ABC):
    @abc.abstractmethod
    def get_pub_key(self) -> PubKey: ...

    @abc.abstractmethod
    def sign_vote(self, chain_id: str, vote: Vote,
                  sign_extension: bool) -> None:
        """Sign the vote in place (vote.signature, and extension
        signatures when sign_extension and vote is a precommit)."""

    @abc.abstractmethod
    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        """Sign the proposal in place."""

    def sign_bytes(self, msg: bytes) -> bytes:
        raise PrivValidatorError("raw sign_bytes not supported")


class MockPV(PrivValidator):
    """In-memory signer without double-sign protection (reference:
    types/priv_validator.go MockPV — test use only)."""

    def __init__(self, priv_key: PrivKey,
                 break_proposal_sigs: bool = False,
                 break_vote_sigs: bool = False):
        self.priv_key = priv_key
        self.break_proposal_sigs = break_proposal_sigs
        self.break_vote_sigs = break_vote_sigs

    def get_pub_key(self) -> PubKey:
        return self.priv_key.pub_key()

    def sign_vote(self, chain_id: str, vote: Vote,
                  sign_extension: bool) -> None:
        use_chain_id = "incorrect-chain-id" if self.break_vote_sigs \
            else chain_id
        vote.signature = self.priv_key.sign(vote.sign_bytes(use_chain_id))
        if sign_extension and vote.type == canonical.PRECOMMIT_TYPE and \
                not vote.block_id.is_nil():
            vote.extension_signature = self.priv_key.sign(
                vote.extension_sign_bytes(use_chain_id))
            vote.non_rp_extension_signature = self.priv_key.sign(
                vote.non_rp_extension_sign_bytes())

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        use_chain_id = "incorrect-chain-id" if self.break_proposal_sigs \
            else chain_id
        proposal.signature = self.priv_key.sign(
            proposal.sign_bytes(use_chain_id))

    def sign_bytes(self, msg: bytes) -> bytes:
        return self.priv_key.sign(msg)


def new_mock_pv() -> MockPV:
    from ..crypto import ed25519
    return MockPV(ed25519.gen_priv_key())
