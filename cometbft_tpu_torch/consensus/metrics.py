"""Consensus metrics, fed at the point of action inside the state
machine and reactor.

Reference: internal/consensus/metrics.go:190 (+ metrics.gen.go) — the
metric names, labels and semantics match the reference so existing
dashboards port unchanged; recording mirrors recordMetrics in
internal/consensus/state.go.  The port's copy of
cometbft_tpu/consensus/metrics.py, on the port's libs/metrics.py.
"""
from __future__ import annotations

import time
from typing import Optional

from ..libs import metrics as libmetrics


class Metrics:
    def __init__(self, registry: Optional[libmetrics.Registry] = None):
        m = registry if registry is not None else libmetrics.Registry()
        self.height = m.gauge(
            "consensus", "height", "Height of the chain.")
        self.validator_last_signed_height = m.gauge(
            "consensus", "validator_last_signed_height",
            "Last height signed by this validator if the node is a "
            "validator.")
        self.rounds = m.gauge(
            "consensus", "rounds", "Number of rounds.")
        self.round_duration_seconds = m.histogram(
            "consensus", "round_duration_seconds",
            "Histogram of round duration.")
        self.validators = m.gauge(
            "consensus", "validators", "Number of validators.")
        self.validators_power = m.gauge(
            "consensus", "validators_power",
            "Total power of all validators.")
        self.missing_validators = m.gauge(
            "consensus", "missing_validators",
            "Number of validators who did not sign.")
        self.missing_validators_power = m.gauge(
            "consensus", "missing_validators_power",
            "Total power of the missing validators.")
        self.byzantine_validators = m.gauge(
            "consensus", "byzantine_validators",
            "Number of validators who tried to double sign.")
        self.byzantine_validators_power = m.gauge(
            "consensus", "byzantine_validators_power",
            "Total power of the byzantine validators.")
        self.block_interval_seconds = m.histogram(
            "consensus", "block_interval_seconds",
            "Time between this and the last block.")
        self.num_txs = m.gauge(
            "consensus", "num_txs", "Number of transactions.")
        self.block_size_bytes = m.gauge(
            "consensus", "block_size_bytes", "Size of the block.")
        self.chain_size_bytes = m.counter(
            "consensus", "chain_size_bytes",
            "Size of the chain in bytes.")
        self.total_txs = m.counter(
            "consensus", "total_txs",
            "Total number of transactions.")
        self.latest_block_height = m.gauge(
            "consensus", "latest_block_height",
            "The latest block height.")
        self.step_duration_seconds = m.histogram(
            "consensus", "step_duration_seconds",
            "Histogram of durations for each step in the consensus "
            "protocol.", labels=("step",))
        self.block_parts = m.counter(
            "consensus", "block_parts",
            "Number of block parts transmitted by each peer.",
            labels=("peer_id",))
        self.duplicate_block_part = m.counter(
            "consensus", "duplicate_block_part",
            "Number of times we received a duplicate block part")
        self.duplicate_vote = m.counter(
            "consensus", "duplicate_vote",
            "Number of times we received a duplicate vote")
        self.block_gossip_parts_received = m.counter(
            "consensus", "block_gossip_parts_received",
            "Number of block parts received by the node, separated "
            "by whether the part was relevant to the block the node "
            "is trying to gather or not.",
            labels=("matches_current",))
        # compact-block proposal relay (docs/gossip.md)
        self.compact_blocks_sent = m.counter(
            "consensus", "compact_blocks_sent",
            "Compact proposals (skeleton + tx hashes) sent to "
            "negotiated peers instead of full parts.")
        self.compact_blocks_reconstructed = m.counter(
            "consensus", "compact_blocks_reconstructed",
            "Compact proposals fully rebuilt from the local mempool "
            "— no full block parts needed.")
        self.compact_block_misses = m.counter(
            "consensus", "compact_block_misses",
            "Compact proposals with at least one tx hash the local "
            "mempool could not resolve (fell back to full parts).")
        self.compact_block_mismatches = m.counter(
            "consensus", "compact_block_mismatches",
            "Compact proposals whose reconstructed part set did not "
            "match the advertised part-set header.")
        self.vote_batches_sent = m.counter(
            "consensus", "vote_batches_sent",
            "Coalesced vote messages sent on the vote channel "
            "(votebatch/1 links).")
        self.quorum_prevote_delay = m.gauge(
            "consensus", "quorum_prevote_delay",
            "Interval in seconds between the proposal timestamp and "
            "the timestamp of the earliest prevote that achieved a "
            "quorum.", labels=("proposer_address",))
        self.full_prevote_delay = m.gauge(
            "consensus", "full_prevote_delay",
            "Interval in seconds between the proposal timestamp and "
            "the timestamp of the latest prevote in a round where "
            "all validators voted.", labels=("proposer_address",))
        # metrics v2: distribution views of the quorum/full delays.
        # The reference gauges above only hold the LAST delay per
        # proposer; the unlabeled histograms answer "what is the p99
        # quorum delay" over time without a per-proposer bucket
        # explosion.
        _delay_buckets = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                          1.0, 2.5, 5.0, 10.0)
        self.quorum_prevote_delay_seconds = m.histogram(
            "consensus", "quorum_prevote_delay_seconds",
            "Histogram of the interval in seconds between the "
            "proposal timestamp and the earliest quorum-achieving "
            "prevote.", buckets=_delay_buckets)
        self.full_prevote_delay_seconds = m.histogram(
            "consensus", "full_prevote_delay_seconds",
            "Histogram of the interval in seconds between the "
            "proposal timestamp and the latest prevote in rounds "
            "where all validators voted.", buckets=_delay_buckets)
        self.rounds_per_height = m.histogram(
            "consensus", "rounds_per_height",
            "Histogram of the round number blocks commit in "
            "(0 = first round).",
            buckets=(0, 1, 2, 3, 5, 10, 20))
        self.vote_extension_receive_count = m.counter(
            "consensus", "vote_extension_receive_count",
            "Number of vote extensions received, annotated by "
            "application verdict.", labels=("status",))
        self.proposal_receive_count = m.counter(
            "consensus", "proposal_receive_count",
            "Total number of proposals received since process "
            "start, annotated by app verdict.", labels=("status",))
        self.proposal_create_count = m.counter(
            "consensus", "proposal_create_count",
            "Total number of proposals created since process start.")
        self.round_voting_power_percent = m.gauge(
            "consensus", "round_voting_power_percent",
            "Percentage of the total voting power received with a "
            "round, by vote type.", labels=("vote_type",))
        self.late_votes = m.counter(
            "consensus", "late_votes",
            "Number of votes received corresponding to earlier "
            "heights/rounds than the node is in.",
            labels=("vote_type",))
        # commit pipeline (docs/pipeline.md): how long the background
        # execute/commit of height H ran, and how long the receive
        # routine actually stalled on the barrier when it needed the
        # applied state — overlap won = apply minus barrier wait
        _pipe_buckets = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                         0.5, 1.0, 2.5, 5.0)
        self.pipeline_apply_seconds = m.histogram(
            "consensus", "pipeline_apply_seconds",
            "Duration of the pipelined background execute/commit "
            "(FinalizeBlock through mempool update) per height.",
            buckets=_pipe_buckets)
        self.pipeline_barrier_wait_seconds = m.histogram(
            "consensus", "pipeline_barrier_wait_seconds",
            "Time the consensus routine waited on the pipeline "
            "barrier before a step that needs the applied state.",
            buckets=_pipe_buckets)
        self.proposal_timestamp_difference = m.histogram(
            "consensus", "proposal_timestamp_difference",
            "Difference in seconds between local receive time and "
            "the proposal message timestamp.",
            labels=("is_timely",),
            buckets=(-1.0, -0.5, -0.1, 0.0, 0.1, 0.5, 1.0, 2.0, 5.0))

        self._step_name = ""
        self._step_t = time.monotonic()
        self._round_t = time.monotonic()
        self._block_t = 0.0

    # ---- recording hooks (mirrors recordMetrics) ---------------------
    def mark_step(self, rs) -> None:
        now = time.monotonic()
        if self._step_name:
            self.step_duration_seconds.with_labels(
                self._step_name).observe(now - self._step_t)
        self._step_name = rs.step_name()
        self._step_t = now
        self.rounds.set(rs.round)

    def mark_round(self, round_: int) -> None:
        now = time.monotonic()
        self.round_duration_seconds.observe(now - self._round_t)
        self._round_t = now
        self.rounds.set(round_)

    def record_commit(self, block, last_validators,
                      current_validators,
                      block_size: int = 0,
                      commit_round: int = -1) -> None:
        """Per-commit stats (reference: recordMetrics, state.go).
        last_validators signed block.last_commit; block_size is the
        full wire size (part-set byte size)."""
        now = time.monotonic()
        self.height.set(block.header.height)
        if commit_round >= 0:
            self.rounds_per_height.observe(commit_round)
        self.latest_block_height.set(block.header.height)
        self.num_txs.set(len(block.data.txs))
        self.total_txs.add(len(block.data.txs))
        size = block_size or sum(len(tx) for tx in block.data.txs)
        self.block_size_bytes.set(size)
        self.chain_size_bytes.add(size)
        if self._block_t:
            self.block_interval_seconds.observe(now - self._block_t)
        self._block_t = now
        if current_validators is not None:
            self.validators.set(current_validators.size())
            self.validators_power.set(
                current_validators.total_voting_power())
        lc = block.last_commit
        if last_validators is not None and lc is not None and lc.size():
            from ..types.commit import AggregateCommit
            missing = 0
            missing_power = 0
            if isinstance(lc, AggregateCommit):
                # aggregate form: unset signer bits are "missing"
                # (nil votes are indistinguishable from absence —
                # both are excluded from the bitmap); complement walk
                # keeps this O(absent), not O(n) bignum shifts
                nvals = last_validators.size()
                for i in lc.signers.not_().true_indices():
                    if i < nvals:
                        missing += 1
                        missing_power += \
                            last_validators.validators[i].voting_power
            else:
                from ..types.commit import BLOCK_ID_FLAG_ABSENT
                for i, sig in enumerate(lc.signatures):
                    if sig.block_id_flag == BLOCK_ID_FLAG_ABSENT and \
                            i < last_validators.size():
                        missing += 1
                        missing_power += \
                            last_validators.validators[i].voting_power
            self.missing_validators.set(missing)
            self.missing_validators_power.set(missing_power)
        byz = 0
        byz_power = 0
        for ev in block.evidence:   # gauges reset below when no evidence
            byz_vals = getattr(ev, "byzantine_validators", None)
            if byz_vals is not None:       # light-client attack
                addrs = [v.address for v in byz_vals]
            else:
                va = getattr(ev, "vote_a", None)
                addrs = [va.validator_address] if va is not None \
                    else []
            for addr in addrs:
                byz += 1
                if last_validators is not None:
                    _, v = last_validators.get_by_address(addr)
                    if v is not None:
                        byz_power += v.voting_power
        self.byzantine_validators.set(byz)
        self.byzantine_validators_power.set(byz_power)
