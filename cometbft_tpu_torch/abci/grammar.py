"""ABCI call-sequence grammar checker.

Reference: test/e2e/pkg/grammar/checker.go + abci_grammar.md — the
spec's expected-behavior grammar
(spec/abci/abci++_comet_expected_behavior.md):

    start             = clean-start / recovery
    clean-start       = ( init-chain / state-sync ) consensus-exec
    state-sync        = *state-sync-attempt success-sync
    state-sync-attempt= offer-snapshot *apply-chunk
    success-sync      = offer-snapshot 1*apply-chunk
    recovery          = [init-chain] consensus-exec
    consensus-exec    = 1*consensus-height
    consensus-height  = *consensus-round finalize-block commit
    consensus-round   = proposer / non-proposer   (any mix of
                        prepare/process/extend/got-vote tokens)

Info/Echo/Query/CheckTx/Flush and snapshot serving calls are ignored
(the reference ignores Info for the same reason).  The checker is an
exact state machine over the remaining calls; because round
productions concatenate freely, any mix of the four round tokens is
derivable between commits — the structure the grammar actually
enforces is the handshake/state-sync prefix, the strict
finalize->commit pairing, and chunk placement.  A copy of
cometbft_tpu/abci/grammar.py: the same verdicts and texts.
"""
from __future__ import annotations

# grammar-relevant call names (reference: checker.go filter)
GRAMMAR_CALLS = frozenset({
    "init_chain", "offer_snapshot", "apply_snapshot_chunk",
    "prepare_proposal", "process_proposal", "extend_vote",
    "verify_vote_extension", "finalize_block", "commit",
})

_ROUND = frozenset({"prepare_proposal", "process_proposal",
                    "extend_vote", "verify_vote_extension"})


class GrammarError(Exception):
    def __init__(self, index: int, call: str, msg: str):
        super().__init__(f"call #{index} {call!r}: {msg}")
        self.index = index
        self.call = call


class GrammarChecker:
    """Verify a full execution trace (reference: Checker.Verify)."""

    def verify(self, calls: list[str],
               clean_start: bool = True) -> bool:
        """Raises GrammarError on the first violating call.  calls is
        the raw trace; non-grammar calls are filtered out.  With
        clean_start, the trace must begin with init_chain or a
        state-sync; a recovery trace may jump straight into consensus.
        """
        trace = [c for c in calls if c in GRAMMAR_CALLS]
        state = "start"
        chunks_in_attempt = 0
        commits = 0
        for i, c in enumerate(trace):
            if c == "init_chain":
                if i != 0:
                    raise GrammarError(i, c, "only valid as the "
                                       "first call")
                state = "consensus"
            elif c == "offer_snapshot":
                if state not in ("start", "sync"):
                    raise GrammarError(i, c, "state-sync after "
                                       "consensus started")
                state = "sync"
                chunks_in_attempt = 0
            elif c == "apply_snapshot_chunk":
                if state != "sync":
                    raise GrammarError(i, c, "chunk outside a "
                                       "snapshot attempt")
                chunks_in_attempt += 1
            elif c in _ROUND or c == "finalize_block":
                if state == "start":
                    if clean_start:
                        raise GrammarError(
                            i, c, "consensus before init_chain/"
                            "state-sync on a clean start")
                    state = "consensus"
                elif state == "sync":
                    # leaving state-sync requires a successful final
                    # attempt (success-sync = offer 1*chunk)
                    if chunks_in_attempt == 0:
                        raise GrammarError(
                            i, c, "state-sync never succeeded (last "
                            "offer_snapshot applied no chunks)")
                    state = "consensus"
                elif state == "expect_commit":
                    raise GrammarError(i, c, "expected commit after "
                                       "finalize_block")
                if c == "finalize_block":
                    state = "expect_commit"
            elif c == "commit":
                if state != "expect_commit":
                    raise GrammarError(i, c, "commit without "
                                       "finalize_block")
                state = "consensus"
                commits += 1
        if state == "expect_commit":
            raise GrammarError(len(trace), "<end>",
                               "trace ends between finalize_block "
                               "and commit")
        if state == "sync":
            raise GrammarError(len(trace), "<end>",
                               "trace ends inside state-sync")
        if commits == 0:
            raise GrammarError(len(trace), "<end>",
                               "consensus-exec requires at least one "
                               "height (no commit in trace)")
        return True


class RecordingClient:
    """ABCI client middleware that records the call-name trace for
    grammar checking (reference: the e2e app writes each ABCI request
    to disk for the checker)."""

    _RECORDED = GRAMMAR_CALLS | {"info", "query", "check_tx",
                                 "list_snapshots",
                                 "load_snapshot_chunk"}

    def __init__(self, inner, calls: list[str] | None = None):
        # `calls` may be shared by several connections so the trace
        # preserves true cross-connection call order
        self._inner = inner
        self.calls = calls if calls is not None else []

    def __getattr__(self, name):
        target = getattr(self._inner, name)
        if name in self._RECORDED and callable(target):
            async def wrapper(*a, _t=target, _n=name, **kw):
                self.calls.append(_n)
                return await _t(*a, **kw)
            return wrapper
        return target
