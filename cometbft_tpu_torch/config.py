"""Node configuration tree.

Reference: config/config.go:93 — Config{Base,RPC,GRPC,P2P,Mempool,
StateSync,BlockSync,Consensus,Storage,TxIndex,Instrumentation}, defaults
(:111), TestConfig (:128) and each section's ValidateBasic — through
cometbft_tpu/config.py, of which this is a copy: the same sections,
field names and defaults, the same ``validate_basic`` texts and the same
timeout arithmetic.  Durations are nanoseconds (ints) for determinism.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

_MS = 1_000_000
_S = 1_000_000_000


@dataclass
class BaseConfig:
    chain_id: str = ""
    home: str = "."
    moniker: str = "anonymous"
    proxy_app: str = "kvstore"
    abci: str = "builtin"
    db_backend: str = "sqlite"
    db_dir: str = "data"
    log_level: str = "info"
    genesis_file: str = "config/genesis.json"
    priv_validator_key_file: str = "config/priv_validator_key.json"
    priv_validator_state_file: str = "data/priv_validator_state.json"
    # when set, the node listens here for an external remote signer and
    # uses it instead of the file-backed key
    priv_validator_laddr: str = ""
    node_key_file: str = "config/node_key.json"
    filter_peers: bool = False
    # record the ABCI call trace for the grammar checker
    abci_grammar_trace: bool = False
    # per-call deadline for remote (socket/grpc) ABCI transports; 0
    # disables.  The consensus-path methods get 6x this budget; read-only
    # calls retry on transient transport errors up to abci_call_retries
    # times.
    abci_call_timeout_ns: int = 20 * _S
    abci_call_retries: int = 2
    # LRU cap of the shared sig -> (addr, sign_bytes) verification cache
    # (types/signature_cache.py)
    signature_cache_size: int = 10_000

    def path(self, rel: str) -> str:
        return rel if os.path.isabs(rel) else os.path.join(self.home, rel)


@dataclass
class RPCConfig:
    """A zero connection or header limit means none and 1 MiB, as in the
    reference (rpc/server.py)."""
    laddr: str = "tcp://127.0.0.1:26657"
    max_open_connections: int = 900
    max_subscription_clients: int = 100
    max_subscriptions_per_client: int = 5
    timeout_broadcast_tx_commit_ns: int = 10 * _S
    max_body_bytes: int = 1_000_000
    max_header_bytes: int = 1 << 20
    # enables dial_seeds / dial_peers / unsafe_flush_mempool
    unsafe: bool = False
    # lightserve response cache budget: immutable height-keyed RPC
    # responses (blocks, commits, light blocks, multiproofs below the
    # tip) held in RAM; 0 disables
    cache_max_bytes: int = 32 * 1024 * 1024


@dataclass
class GRPCConfig:
    """gRPC data-companion API: grpc.laddr plus a separate privileged
    endpoint whose pruning service lets a companion drive retain
    heights."""
    laddr: str = ""                       # e.g. "tcp://127.0.0.1:26670"
    version_service_enabled: bool = True
    block_service_enabled: bool = True
    block_results_service_enabled: bool = True
    privileged_laddr: str = ""            # e.g. "tcp://127.0.0.1:26671"
    pruning_service_enabled: bool = False


@dataclass
class P2PConfig:
    """The switch hands its rates to every MConnection; PexReactor reads
    its mode and outbound limit; the node reads the addresses and
    peers."""
    laddr: str = "tcp://0.0.0.0:26656"
    external_address: str = ""
    seeds: str = ""
    persistent_peers: str = ""
    addr_book_file: str = "config/addrbook.json"
    addr_book_strict: bool = True
    max_num_inbound_peers: int = 40
    max_num_outbound_peers: int = 10
    flush_throttle_timeout_ns: int = 10 * _MS
    max_packet_msg_payload_size: int = 1024
    send_rate: int = 5_120_000
    recv_rate: int = 5_120_000
    pex: bool = True
    seed_mode: bool = False
    private_peer_ids: str = ""
    allow_duplicate_ip: bool = False
    handshake_timeout_ns: int = 20 * _S
    dial_timeout_ns: int = 3 * _S


@dataclass
class MempoolConfig:
    recheck: bool = True
    recheck_timeout_ns: int = 1 * _S
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
    enable: bool = False
    rpc_servers: list[str] = field(default_factory=list)
    trust_height: int = 0
    trust_hash: str = ""
    trust_period_ns: int = 168 * 3600 * _S
    discovery_time_ns: int = 15 * _S
    chunk_request_timeout_ns: int = 10 * _S
    chunk_fetchers: int = 4
    temp_dir: str = ""


@dataclass
class BlockSyncConfig:
    """Whether a node block-syncs before consensus: read where the node
    wires BlocksyncReactor(active=...) and ConsensusReactor(wait_sync=...)
    (node/node.py)."""
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
    discard_abci_responses: bool = False
    pruning_interval_ns: int = 10 * _S


@dataclass
class TxIndexConfig:
    indexer: str = "kv"          # kv | psql | null
    # for the psql sink: the SQL event sink's database target
    psql_conn: str = ""


@dataclass
class InstrumentationConfig:
    prometheus: bool = False
    prometheus_listen_addr: str = ":26660"
    pprof_listen_addr: str = ""
    namespace: str = "cometbft"
    # flight recorder (libs/tracing.py): ring-buffer span tracing served
    # at the /trace RPC; trace_categories is a comma list, empty enables
    # every category
    trace_enabled: bool = True
    trace_buffer_size: int = 4096
    trace_categories: str = ""
    # kept for the JAX package's config files: the port's recorder keeps
    # no dump file and refreshes its clock anchor on its own cadence
    dump_dir: str = ""
    trace_anchor_interval_s: float = 30.0
    # event-loop lag sampler (libs/health.py) cadence; 0 disables
    loop_lag_interval_s: float = 0.25


@dataclass
class Config:
    base: BaseConfig = field(default_factory=BaseConfig)
    rpc: RPCConfig = field(default_factory=RPCConfig)
    grpc: GRPCConfig = field(default_factory=GRPCConfig)
    p2p: P2PConfig = field(default_factory=P2PConfig)
    mempool: MempoolConfig = field(default_factory=MempoolConfig)
    statesync: StateSyncConfig = field(default_factory=StateSyncConfig)
    blocksync: BlockSyncConfig = field(default_factory=BlockSyncConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    tx_index: TxIndexConfig = field(default_factory=TxIndexConfig)
    instrumentation: InstrumentationConfig = field(
        default_factory=InstrumentationConfig)


class ConfigError(Exception):
    pass


def validate_basic(cfg: Config) -> None:
    """Per-section sanity checks (reference: config.go ValidateBasic on
    every sub-config).  Raises ConfigError naming the section.key."""
    if cfg.base.db_backend not in ("memdb", "mem", "sqlite",
                                   "goleveldb", "pebbledb"):
        raise ConfigError(
            f"base.db_backend: unknown backend {cfg.base.db_backend!r}")
    if cfg.base.abci_call_timeout_ns < 0 or \
            cfg.base.abci_call_retries < 0:
        raise ConfigError(
            "base.abci_call_timeout/abci_call_retries cannot be "
            "negative")
    if cfg.rpc.max_body_bytes <= 0:
        raise ConfigError("rpc.max_body_bytes must be positive")
    if cfg.rpc.timeout_broadcast_tx_commit_ns <= 0:
        raise ConfigError(
            "rpc.timeout_broadcast_tx_commit must be positive")
    if cfg.p2p.send_rate < 0 or cfg.p2p.recv_rate < 0:
        raise ConfigError("p2p.send_rate/recv_rate cannot be negative")
    if cfg.p2p.max_num_inbound_peers < 0 or \
            cfg.p2p.max_num_outbound_peers < 0:
        raise ConfigError("p2p peer limits cannot be negative")
    if cfg.mempool.size <= 0:
        raise ConfigError("mempool.size must be positive")
    if cfg.mempool.max_tx_bytes <= 0:
        raise ConfigError("mempool.max_tx_bytes must be positive")
    if cfg.mempool.max_txs_bytes < 0:
        raise ConfigError("mempool.max_txs_bytes cannot be negative")
    if cfg.statesync.enable:
        if not cfg.statesync.rpc_servers:
            raise ConfigError(
                "statesync.rpc_servers required when statesync enabled")
        if cfg.statesync.trust_height <= 0:
            raise ConfigError(
                "statesync.trust_height required when statesync enabled")
        try:
            bytes.fromhex(cfg.statesync.trust_hash)
        except ValueError:
            raise ConfigError(
                "statesync.trust_hash must be hex") from None
        if not cfg.statesync.trust_hash:
            raise ConfigError(
                "statesync.trust_hash required when statesync enabled")
        if cfg.statesync.trust_period_ns <= 0:
            raise ConfigError("statesync.trust_period must be positive")
    for name in ("timeout_propose_ns", "timeout_propose_delta_ns",
                 "timeout_vote_ns", "timeout_vote_delta_ns",
                 "peer_gossip_sleep_duration_ns",
                 "peer_query_maj23_sleep_duration_ns"):
        if getattr(cfg.consensus, name) < 0:
            raise ConfigError(f"consensus.{name} cannot be negative")
    if cfg.consensus.create_empty_blocks_interval_ns < 0:
        raise ConfigError(
            "consensus.create_empty_blocks_interval cannot be negative")
    if cfg.consensus.adaptive_timeout_floor_ns < 0 or \
            cfg.consensus.adaptive_timeout_ceiling_ns < \
            cfg.consensus.adaptive_timeout_floor_ns:
        raise ConfigError(
            "consensus.adaptive_timeout_floor/ceiling must satisfy "
            "0 <= floor <= ceiling")
    if cfg.mempool.recheck_max_age_blocks <= 0:
        raise ConfigError(
            "mempool.recheck_max_age_blocks must be positive")
    if cfg.mempool.recheck_batch_size <= 0:
        raise ConfigError(
            "mempool.recheck_batch_size must be positive")
    if cfg.mempool.recon_advert_max_ids <= 0:
        raise ConfigError(
            "mempool.recon_advert_max_ids must be positive")
    if cfg.mempool.recon_want_timeout_ns <= 0:
        raise ConfigError(
            "mempool.recon_want_timeout must be positive")
    if cfg.mempool.recon_push_peers < 0:
        raise ConfigError(
            "mempool.recon_push_peers cannot be negative")
    if cfg.mempool.recon_salt_epoch_blocks <= 0:
        raise ConfigError(
            "mempool.recon_salt_epoch_blocks must be positive")
    if cfg.consensus.compact_block_grace_ns < 0:
        raise ConfigError(
            "consensus.compact_block_grace cannot be negative")
    if cfg.consensus.vote_batch_max < 0:
        raise ConfigError(
            "consensus.vote_batch_max cannot be negative")
    if cfg.tx_index.indexer not in ("kv", "psql", "null"):
        raise ConfigError(
            f"tx_index.indexer must be kv|psql|null, "
            f"got {cfg.tx_index.indexer!r}")
    if cfg.instrumentation.prometheus and \
            not cfg.instrumentation.prometheus_listen_addr:
        raise ConfigError(
            "instrumentation.prometheus_listen_addr required when "
            "prometheus enabled")
    if cfg.instrumentation.trace_buffer_size <= 0:
        raise ConfigError(
            "instrumentation.trace_buffer_size must be positive")
    if cfg.instrumentation.trace_anchor_interval_s <= 0:
        raise ConfigError(
            "instrumentation.trace_anchor_interval_s must be "
            "positive")
    if cfg.instrumentation.loop_lag_interval_s < 0:
        raise ConfigError(
            "instrumentation.loop_lag_interval_s cannot be negative")
    if cfg.base.signature_cache_size <= 0:
        raise ConfigError(
            "base.signature_cache_size must be positive")


def default_config() -> Config:
    return Config()


def test_config() -> Config:
    """Reference: config.go TestConfig (:128) — tight timeouts."""
    cfg = Config()
    cfg.consensus.timeout_propose_ns = 40 * _MS
    cfg.consensus.timeout_propose_delta_ns = 1 * _MS
    cfg.consensus.timeout_vote_ns = 10 * _MS
    cfg.consensus.timeout_vote_delta_ns = 1 * _MS
    cfg.consensus.timeout_commit_ns = 0
    cfg.base.db_backend = "memdb"
    return cfg
