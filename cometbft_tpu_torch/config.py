"""Node configuration: the consensus and p2p sections.

Reference: config/config.go — P2PConfig (:588), ConsensusConfig (:1218)
and TestConfig (:128) — through cometbft_tpu/config.py, whose
``ConsensusConfig`` (:173-234) and the consensus part of
``test_config`` (:411-417) this copy keeps, with the same field names,
defaults and timeout arithmetic, and of whose ``P2PConfig`` (:86-104)
it keeps the fields the port reads.  The other sections (base, RPC,
mempool, state sync, storage, instrumentation) come with the node,
ROADMAP.md A.7e-6.
"""
from __future__ import annotations

from dataclasses import dataclass, field

_MS = 1_000_000
_S = 1_000_000_000


@dataclass
class P2PConfig:
    """The p2p fields the port reads: the switch hands its rates to
    every MConnection, and PexReactor reads its mode and outbound
    limit.  The rest of the section (listen and external addresses,
    seeds, persistent and private peers, the address-book file, the
    handshake and dial timeouts) comes with the node, A.7e-6."""
    send_rate: int = 5_120_000
    recv_rate: int = 5_120_000
    max_num_outbound_peers: int = 10
    seed_mode: bool = False


@dataclass
class ConsensusConfig:
    wal_file: str = "data/cs.wal/wal"
    # reference: config.go:1255-1259
    timeout_propose_ns: int = 3000 * _MS
    timeout_propose_delta_ns: int = 500 * _MS
    timeout_vote_ns: int = 1000 * _MS
    timeout_vote_delta_ns: int = 500 * _MS
    timeout_commit_ns: int = 0        # deprecated; app next_block_delay
    skip_timeout_commit: bool = False
    double_sign_check_height: int = 0
    create_empty_blocks: bool = True
    create_empty_blocks_interval_ns: int = 0
    peer_gossip_sleep_duration_ns: int = 100 * _MS
    peer_query_maj23_sleep_duration_ns: int = 2 * _S
    # pipelined commit: run FinalizeBlock/apply/app-Commit/mempool
    # update of height H in a supervised background task while the
    # round state advances to H+1; steps that need H's applied state
    # wait on an explicit pipeline barrier.  Replay always runs serial.
    pipeline_commit: bool = True
    # adaptive timeouts: derive propose/vote timeouts and the commit
    # padding from an EWMA of the measured p95 quorum-prevote delay,
    # clamped to [floor, ceiling]; static config until measured.
    adaptive_timeouts: bool = False
    adaptive_timeout_floor_ns: int = 200 * _MS
    adaptive_timeout_ceiling_ns: int = 10 * _S
    # compact-block proposal relay (negotiated "compactblocks/1")
    compact_blocks: bool = True
    compact_block_grace_ns: int = 250 * _MS
    # missing votes coalesced per wire message ("votebatch/1")
    vote_batch_max: int = 16
    # advertise "aggcommit/1": this build parses AggregateCommit arms
    aggregate_commits_wire: bool = True

    def propose_timeout_ns(self, round_: int) -> int:
        return self.timeout_propose_ns + \
            self.timeout_propose_delta_ns * round_

    def prevote_timeout_ns(self, round_: int) -> int:
        return self.timeout_vote_ns + self.timeout_vote_delta_ns * round_

    def precommit_timeout_ns(self, round_: int) -> int:
        return self.timeout_vote_ns + self.timeout_vote_delta_ns * round_

    def wait_for_txs(self) -> bool:
        return not self.create_empty_blocks or \
            self.create_empty_blocks_interval_ns > 0


@dataclass
class Config:
    """The configuration tree, holding its p2p and consensus sections."""
    p2p: P2PConfig = field(default_factory=P2PConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)


def test_config() -> Config:
    """Reference: config.go TestConfig (:128) — tight timeouts."""
    cfg = Config()
    cfg.consensus.timeout_propose_ns = 40 * _MS
    cfg.consensus.timeout_propose_delta_ns = 1 * _MS
    cfg.consensus.timeout_vote_ns = 10 * _MS
    cfg.consensus.timeout_vote_delta_ns = 1 * _MS
    cfg.consensus.timeout_commit_ns = 0
    return cfg
