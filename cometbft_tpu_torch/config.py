"""Node configuration: the consensus, RPC, p2p, mempool, block-sync,
state-sync and storage sections.

Reference: config/config.go — P2PConfig (:588), MempoolConfig,
StateSyncConfig, BlockSyncConfig, ConsensusConfig (:1218), StorageConfig
and TestConfig (:128) — through cometbft_tpu/config.py, whose
``ConsensusConfig`` (:173-234) and the consensus part of ``test_config``
(:411-417) this copy keeps, with the same field names, defaults and
timeout arithmetic, and of whose ``RPCConfig`` (:55-69),
``P2PConfig`` (:86-104),
``MempoolConfig`` (:108-152), ``StateSyncConfig`` (:155-164),
``BlockSyncConfig`` (:168) and ``StorageConfig`` (:238-240) it keeps the
fields the port reads, with their defaults.  The other sections (base,
gRPC, instrumentation) come with the node, ROADMAP.md A.7e-6.
"""
from __future__ import annotations

from dataclasses import dataclass, field

_MS = 1_000_000
_S = 1_000_000_000


@dataclass
class RPCConfig:
    """What rpc/server.RPCServer and rpc/core's routes read, with the JAX
    defaults: the listen address, the limits on connections, header and
    body bytes (a zero connection or header limit means none and 1 MiB,
    as in the reference), broadcast_tx_commit's wait, the unsafe routes'
    gate and the lightserve response cache's budget (0 disables it).
    The subscription limits come with their readers."""
    laddr: str = "tcp://127.0.0.1:26657"
    max_open_connections: int = 900
    timeout_broadcast_tx_commit_ns: int = 10 * _S
    max_body_bytes: int = 1_000_000
    max_header_bytes: int = 1 << 20
    unsafe: bool = False
    # lightserve response cache budget: immutable height-keyed RPC
    # responses (blocks, commits, light blocks, multiproofs below the
    # tip) held in RAM; 0 disables
    cache_max_bytes: int = 32 * 1024 * 1024


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
class MempoolConfig:
    """What CListMempool and MempoolReactor read, with the JAX defaults.
    ``recheck_timeout_ns`` is left out: no module of either package reads
    it."""
    recheck: bool = True
    broadcast: bool = True
    size: int = 5000
    max_txs_bytes: int = 64 * 1024 * 1024
    cache_size: int = 10000
    keep_invalid_txs_in_cache: bool = False
    max_tx_bytes: int = 1024 * 1024
    # incremental recheck: after a commit, CheckTx again only the pooled
    # txs whose app-reported state keys overlap the committed block's,
    # plus any tx not revalidated within recheck_max_age_blocks heights;
    # False restores the full-pool recheck
    recheck_incremental: bool = True
    recheck_max_age_blocks: int = 12
    # CheckTx calls issued together in a recheck pass
    recheck_batch_size: int = 64
    # have/want gossip ("txrecon/1", negotiated per link): advertise short
    # salted tx ids, let peers pull what they miss
    gossip_reconciliation: bool = True
    recon_advert_max_ids: int = 256
    recon_want_timeout_ns: int = 1 * _S
    # brand-new local txs are pushed in full to about this many peers
    recon_push_peers: int = 2
    # heights a salt epoch lasts
    recon_salt_epoch_blocks: int = 16


@dataclass
class StateSyncConfig:
    """The fields of a fresh node's state sync that the port reads: the
    light client's trusting period, the discovery time, the chunk timeout
    and the chunks' directory.  The switch and the light client's RPC
    servers and trust root come with the node and the RPC client
    (ROADMAP.md A.7e-5, A.7e-6)."""
    trust_period_ns: int = 168 * 3600 * _S
    discovery_time_ns: int = 15 * _S
    chunk_request_timeout_ns: int = 10 * _S
    temp_dir: str = ""


@dataclass
class BlockSyncConfig:
    """Whether a node block-syncs before consensus: read where a node
    wires BlocksyncReactor(active=...) and ConsensusReactor(wait_sync=...)
    (cometbft_tpu/node/node.py:419-425)."""
    enable: bool = True


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
class StorageConfig:
    """The pruner service's interval (state/pruner.Pruner's
    ``interval_s``)."""
    pruning_interval_ns: int = 10 * _S


@dataclass
class Config:
    """The configuration tree, holding its RPC, p2p, mempool, state-sync,
    block-sync, consensus and storage sections."""
    rpc: RPCConfig = field(default_factory=RPCConfig)
    p2p: P2PConfig = field(default_factory=P2PConfig)
    mempool: MempoolConfig = field(default_factory=MempoolConfig)
    statesync: StateSyncConfig = field(default_factory=StateSyncConfig)
    blocksync: BlockSyncConfig = field(default_factory=BlockSyncConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)


def test_config() -> Config:
    """Reference: config.go TestConfig (:128) — tight timeouts."""
    cfg = Config()
    cfg.consensus.timeout_propose_ns = 40 * _MS
    cfg.consensus.timeout_propose_delta_ns = 1 * _MS
    cfg.consensus.timeout_vote_ns = 10 * _MS
    cfg.consensus.timeout_vote_delta_ns = 1 * _MS
    cfg.consensus.timeout_commit_ns = 0
    return cfg
