"""The consensus vote intake: burst pre-verification of gossiped votes,
and the last commit restored as a vote set.

Reference: cometbft_tpu/consensus/state.py — the methods
``ConsensusState._preverify_burst`` and ``_append_vote_entries``
(:325-391), ``_vote_set_from_commit``, ``_preverify_votes`` and
``_vote_set_from_extended_commit`` (:591-659), ported as module functions
of the same names less the underscore.  Each takes explicitly what the
method read from ``self``: the round state's height and validator set,
the chain id, the stored validator set.  ``ConsensusState`` itself, its
state machine and ``_receive_routine`` (:282-313), which drains bursts
of at most 256 queued messages and calls ``preverify_burst`` before the
serial tally, come with the consensus slice (ROADMAP.md A.7d), which
needs block execution, the WAL and the stores.

The filters are the JAX package's: only VoteMessages of the current
height whose index and address match the validator set; three triples
for a non-nil precommit carrying both extension signatures, one
otherwise; nothing is batched below two triples.  One departure: a
failure of the batch (a kernel that does not build or launch, the BLS
library) raises from ``preverify_burst`` and ``preverify_votes``, where
the JAX package logs it and leaves every vote to the serial tally.
"""
from __future__ import annotations

import asyncio
import logging

from ..types import canonical
from ..types import vote as vote_mod
from ..types.commit import AggregateCommit, Commit, ExtendedCommit
from ..types.validator_set import ValidatorSet
from ..types.vote_set import VoteSet
from .messages import VoteMessage

_log = logging.getLogger(__name__)


async def preverify_burst(burst, height: int, validators: ValidatorSet,
                          chain_id: str, device=None) -> None:
    """Batch-verify the signatures of the burst's VoteMessages for
    ``height`` against ``validators`` into the verified-triple memo
    (types/vote.py).  ``burst`` holds (kind, msg, peer_id) entries as
    the receive routine queues them.  The batch runs on the
    verification staging worker; this await is the verdict barrier
    after which the burst is tallied serially in arrival order."""
    entries = []
    for kind, msg, _peer in burst:
        if kind == "timeout" or not isinstance(msg, VoteMessage):
            continue
        vote = msg.vote
        if vote is None or vote.height != height:
            continue
        if (validators is None or vote.validator_index < 0 or
                vote.validator_index >= validators.size()):
            continue
        val = validators.validators[vote.validator_index]
        if (val.pub_key is None or
                val.pub_key.address() != vote.validator_address):
            continue
        append_vote_entries(entries, vote, val.pub_key, chain_id)
    if len(entries) >= 2:
        await asyncio.wrap_future(
            vote_mod.preverify_signatures_async(entries, device))


def append_vote_entries(entries, vote, pub_key, chain_id: str) -> None:
    """Append a vote's signature triples — the vote's own and, for a
    non-nil precommit carrying both, the two extension signatures.
    Never raises: a malformed vote is left for the serial path's own
    errors."""
    try:
        entries.append((pub_key, vote.sign_bytes(chain_id),
                        vote.signature))
        if (vote.type == canonical.PRECOMMIT_TYPE and
                not vote.block_id.is_nil() and
                vote.extension_signature and
                vote.non_rp_extension_signature):
            entries.append((pub_key, vote.extension_sign_bytes(chain_id),
                            vote.extension_signature))
            entries.append((pub_key, vote.non_rp_extension_sign_bytes(),
                            vote.non_rp_extension_signature))
    except Exception:
        _log.debug("vote preverify: skipping malformed vote (serial tally "
                   "will report it)", exc_info=True)


def preverify_votes(chain_id: str, vals: ValidatorSet, votes,
                    device=None) -> None:
    """Batch pre-verification of constructed votes into the memo, all
    three signatures of an extended vote.  A vote whose validator is
    not in ``vals`` is left to the serial path."""
    entries = []
    for v in votes:
        idx = vals.index_by_address(v.validator_address)
        if idx < 0:
            continue
        pub_key = vals.validators[idx].pub_key
        if pub_key is None:
            continue
        append_vote_entries(entries, v, pub_key, chain_id)
    if len(entries) >= 2:
        vote_mod.preverify_signatures(entries, device)


def vote_set_from_commit(chain_id: str, commit: Commit | AggregateCommit,
                         vals: ValidatorSet, device=None) -> VoteSet:
    """The last commit as a precommit VoteSet (reference: types
    Commit.ToVoteSet).  The votes are built once, pre-verified in one
    batch and tallied serially, each add_vote reading the memo.  An
    AggregateCommit has no per-vote signatures: it is restored as an
    aggregate-backed set (VoteSet.from_aggregate_commit)."""
    if isinstance(commit, AggregateCommit):
        return VoteSet.from_aggregate_commit(chain_id, commit, vals)
    votes = [commit.get_vote(i) for i, cs in enumerate(commit.signatures)
             if not cs.absent_flag()]
    preverify_votes(chain_id, vals, votes, device)
    vs = VoteSet(chain_id, commit.height, commit.round,
                 canonical.PRECOMMIT_TYPE, vals)
    for v in votes:
        vs.add_vote(v)
    return vs


def vote_set_from_extended_commit(chain_id: str, ec: ExtendedCommit,
                                  vals: ValidatorSet,
                                  device=None) -> VoteSet:
    """The last extended commit as an extended precommit VoteSet: every
    vote's signature and both extension signatures pre-verified in one
    batch, then tallied serially."""
    votes = [ec.get_extended_vote(i)
             for i, ecs in enumerate(ec.extended_signatures)
             if not ecs.absent_flag()]
    preverify_votes(chain_id, vals, votes, device)
    vs = VoteSet.extended(chain_id, ec.height, ec.round,
                          canonical.PRECOMMIT_TYPE, vals)
    for v in votes:
        vs.add_vote(v)
    return vs

