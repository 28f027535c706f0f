"""Node: assembles DBs, state, ABCI, mempool, consensus, p2p, RPC.

Reference: node/node.go:53 (Node struct), node/setup.go:102-750 (the
constructors), boot order in OnStart (:~370): RPC listeners → transport
listen → switch start (dials peers) → consensus — through
cometbft_tpu/node/node.py, whose boot order this copy keeps.  What
differs:

  * ``device``: resolved once at construction (None is the card, and a
    machine without CUDA raises there) and handed to every part that
    verifies signatures: the Handshaker, the BlockExecutor, the
    ConsensusState, block sync, the evidence pool and the RPC state
    provider.  The CPU runs only when the caller names it.
  * ``start`` builds and loads the CUDA library and the host libraries
    off the loop before anything verifies (``prebuild``); a build or
    self-test that fails raises from ``start``.
  * A node whose out-of-process app dies stops: the first app connection
    that ends with an error is the node's ``failure``, which ``wait``,
    ``raise_if_failed`` and ``stop`` raise (reference: proxy/
    multi_app_conn.go killTMOnClientError).  So do a consensus, block
    sync or evidence failure (ROADMAP.md section C, declared departures).
  * gRPC servers need grpcio: a node configured with one on a machine
    without it raises from ``start``.
  * The flight recorder dumps into the data dir, or into
    ``instrumentation.dump_dir`` when it is set, as the JAX node's does.
"""
from __future__ import annotations

import asyncio
import os
import secrets as _secrets
from typing import Optional

from ..abci import types as abci
from ..abci.client import ClientCreator
from ..abci.kvstore import KVStoreApplication
from ..config import Config, validate_basic
from ..consensus.reactor import ConsensusReactor
from ..consensus.replay import Handshaker, ReplayError, catchup_replay
from ..consensus.state import ConsensusState
from ..consensus.wal import WAL, CorruptWALError
from ..db import new_db
from ..device import resolve
from ..libs.log import Logger, new_logger, set_level
from ..mempool import CListMempool
from ..mempool.reactor import MempoolReactor
from ..p2p.key import NodeKey
from ..p2p.switch import Switch
from ..privval import FilePV
from ..state import make_genesis_state
from ..state.execution import BlockExecutor
from ..state.store import Store
from ..store import BlockStore
from ..types.events import EventBus
from ..types.genesis import GenesisDoc, pub_key_to_json

# how often ``wait`` looks at the node's failure slots
_WAIT_POLL_S = 0.1


class NodeError(Exception):
    pass


def init_files(config: Config, chain_id: str = "") -> GenesisDoc:
    """`cometbft init`: write node key, priv validator, genesis
    (reference: cmd/cometbft/commands/init.go)."""
    from ..types.genesis import GenesisValidator
    from ..types.timestamp import Timestamp

    home = config.base.home
    os.makedirs(os.path.join(home, "config"), exist_ok=True)
    os.makedirs(os.path.join(home, "data"), exist_ok=True)

    pv = FilePV.load_or_generate(
        config.base.path(config.base.priv_validator_key_file),
        config.base.path(config.base.priv_validator_state_file))
    NodeKey.load_or_gen(config.base.path(config.base.node_key_file))

    genesis_path = config.base.path(config.base.genesis_file)
    if os.path.exists(genesis_path):
        return GenesisDoc.from_file(genesis_path)
    doc = GenesisDoc(
        chain_id=chain_id or f"test-chain-{_secrets.token_hex(3)}",
        genesis_time=Timestamp.now(),
        validators=[GenesisValidator(
            address=b"", pub_key=pv.get_pub_key(), power=10)],
    )
    doc.validate_and_complete()
    doc.save_as(genesis_path)
    return doc


def prebuild(device, key_types=()) -> None:
    """Build (or load from ``build/``) every library a node runs, and
    self-test the host ones: the CUDA library (B1, B2, B3) when ``device``
    is a CUDA device, the C prep, the host ed25519, the AEAD, and the BLS
    library when ``key_types`` names BLS.  Raises if one fails to build,
    load or self-test."""
    from ..crypto import bls12381
    from ..ops import _build
    if resolve(device).type == "cuda":
        _build.load()
    _build.load_host()
    _build.load_ed25519_host()
    _build.load_aead()
    if bls12381.KEY_TYPE in key_types:
        _build.load_bls()


def pin_cache_heights(app, cache) -> None:
    """Keep the state tree's versions for the heights ``cache`` serves
    responses for: pruning must not drop a version a client that just
    read a cached height asks to have proven (the kvstore's
    ``version_pin``; apps without one keep their own pruning)."""
    if hasattr(app, "version_pin"):
        app.version_pin = cache.heights


class Node:
    def __init__(self, config: Config,
                 app=None,
                 genesis_doc: Optional[GenesisDoc] = None,
                 logger: Optional[Logger] = None,
                 device=None):
        self.config = config
        validate_basic(config)
        self.device = resolve(device)   # the card unless the caller names one
        self.logger = logger if logger is not None else \
            new_logger("node")
        set_level(config.base.log_level)
        db_dir = config.base.path(config.base.db_dir)

        # flight recorder (libs/tracing.py): the span rings every
        # subsystem appends to, served at /trace; crash dumps land in the
        # data dir unless instrumentation.dump_dir points elsewhere
        from ..libs import tracing
        dump_dir = config.instrumentation.dump_dir
        tracing.configure(
            enabled=config.instrumentation.trace_enabled,
            buffer_size=config.instrumentation.trace_buffer_size,
            categories=config.instrumentation.trace_categories or None,
            dump_dir=config.base.path(dump_dir) if dump_dir else db_dir,
            anchor_interval_s=config.instrumentation
            .trace_anchor_interval_s)
        from ..types import signature_cache
        signature_cache.set_default_capacity(
            config.base.signature_cache_size)

        # --- genesis & identity -----------------------------------------
        self.genesis_doc = genesis_doc if genesis_doc is not None else \
            GenesisDoc.from_file(config.base.path(
                config.base.genesis_file))
        self.node_key = NodeKey.load_or_gen(
            config.base.path(config.base.node_key_file))
        tracing.recorder().node_id = self.node_key.id[:12]
        if config.base.priv_validator_laddr:
            # remote signer: the key lives in an external process;
            # connected in start()
            self.priv_validator = None
        else:
            self.priv_validator = FilePV.load_or_generate(
                config.base.path(config.base.priv_validator_key_file),
                config.base.path(config.base.priv_validator_state_file))

        # --- storage ----------------------------------------------------
        backend = config.base.db_backend
        self.block_store = BlockStore(new_db("blockstore", backend,
                                             db_dir))
        self.state_store = Store(new_db("state", backend, db_dir))

        # --- application ------------------------------------------------
        if app is None and config.base.abci in ("builtin",
                                                "builtin_unsync"):
            if config.base.proxy_app in ("kvstore", "persistent_kvstore"):
                # snapshots on, so any builtin-kvstore node can serve
                # state-sync joiners
                app = KVStoreApplication(
                    db=new_db("app", backend, db_dir),
                    snapshot_interval=10)
            else:
                raise NodeError(
                    f"unknown proxy_app {config.base.proxy_app!r} "
                    f"(pass an Application instance for custom apps)")
        self.app = app
        self.app_conns = ClientCreator(
            app=app, addr=config.base.proxy_app,
            transport=config.base.abci).new_app_conns()

        # --- state ------------------------------------------------------
        state = self.state_store.load()
        if state is None:
            state = make_genesis_state(self.genesis_doc)
            self.state_store.save(state)
        self.initial_state = state

        self.event_bus = EventBus()

        # --- metrics: one registry, served at /metrics ------------------
        from ..abci.metrics import Metrics as ProxyMetrics
        from ..blocksync.metrics import Metrics as BlocksyncMetrics
        from ..consensus.metrics import Metrics as ConsensusMetrics
        from ..libs.health import Metrics as HealthMetrics
        from ..libs.metrics import Registry
        from ..libs.supervisor import Metrics as SupervisorMetrics
        from ..libs.supervisor import Supervisor
        from ..mempool.metrics import Metrics as MempoolMetrics
        from ..p2p.metrics import Metrics as P2PMetrics
        from ..state.metrics import Metrics as StateMetrics
        from ..statesync.metrics import Metrics as StatesyncMetrics
        self.metrics_registry = Registry()
        self.consensus_metrics = ConsensusMetrics(self.metrics_registry)
        self.mempool_metrics = MempoolMetrics(self.metrics_registry)
        self.p2p_metrics = P2PMetrics(self.metrics_registry)
        self.blocksync_metrics = BlocksyncMetrics(self.metrics_registry)
        self.statesync_metrics = StatesyncMetrics(self.metrics_registry)
        self.state_metrics = StateMetrics(self.metrics_registry)
        self.proxy_metrics = ProxyMetrics(self.metrics_registry)
        self.supervisor_metrics = SupervisorMetrics(
            self.metrics_registry)
        self.supervisor = Supervisor("node", logger=self.logger,
                                     metrics=self.supervisor_metrics)
        self.health_metrics = HealthMetrics(self.metrics_registry)

        # --- lightserve: height-keyed RPC response cache ----------------
        from ..lightserve.cache import Metrics as LightserveMetrics
        from ..lightserve.cache import ResponseCache
        self.lightserve_cache = None
        if config.rpc.cache_max_bytes > 0:
            self.lightserve_cache = ResponseCache(
                config.rpc.cache_max_bytes,
                metrics=LightserveMetrics(self.metrics_registry))
            pin_cache_heights(self.app, self.lightserve_cache)

        self.mempool: Optional[CListMempool] = None
        self.mempool_reactor: Optional[MempoolReactor] = None
        self.consensus_state: Optional[ConsensusState] = None
        self.consensus_reactor: Optional[ConsensusReactor] = None
        self.blocksync_reactor = None
        self.evidence_reactor = None

        # --- p2p --------------------------------------------------------
        self.switch = Switch(
            self.node_key, self.genesis_doc.chain_id,
            listen_addr=config.p2p.laddr.replace("tcp://", ""),
            moniker=config.base.moniker,
            config=config.p2p,
            metrics=self.p2p_metrics,
            supervisor_metrics=self.supervisor_metrics)
        self.switch.private_ids = {
            s.strip() for s in
            config.p2p.private_peer_ids.split(",") if s.strip()}

        self._rpc_server = None
        self._started = False
        # the first fatal error of the node itself (a dead app)
        self.failure: Optional[BaseException] = None
        self._stopping = False

    # ------------------------------------------------------------------
    async def start(self) -> None:
        """Boot order mirrors node.OnStart.  A boot that fails part-way
        tears down what already started, then raises."""
        try:
            await self._start()
        except BaseException:
            await self._teardown()
            raise

    async def _start(self) -> None:
        cfg = self.config

        # every library is built before the first verification, so no
        # validate_block waits on nvcc or g++
        key_types = {v.pub_key.type() for v in self.genesis_doc.validators}
        key_types.update(
            self.genesis_doc.consensus_params.validator.pub_key_types)
        await asyncio.get_running_loop().run_in_executor(
            None, prebuild, self.device, tuple(sorted(key_types)))

        if cfg.base.priv_validator_laddr:
            from ..privval.signer import (
                RetrySignerClient, SignerClient, SignerListenerEndpoint,
            )
            self._signer_endpoint = SignerListenerEndpoint(
                cfg.base.priv_validator_laddr)
            await self._signer_endpoint.start()
            await self._signer_endpoint.wait_for_signer()
            client = RetrySignerClient(SignerClient(
                self._signer_endpoint, self.genesis_doc.chain_id))
            await client.fetch_pub_key()
            self.priv_validator = client

        # out-of-process app: open the four AppConns first
        await self.app_conns.start()
        if hasattr(self.app_conns, "wait_dead"):
            # supervised, so an error of the watch itself is the node's
            # failure instead of a task that dies unseen
            self.supervisor.spawn(
                self._watch_app, name="app_watch", kind="app_watch",
                on_giveup=self._on_watch_giveup, fatal=lambda e: True)

        # deadlines on the remote ABCI boundary (builtin apps share our
        # event loop, so no deadline there)
        if cfg.base.abci not in ("local", "builtin",
                                 "builtin_unsync") and \
                cfg.base.abci_call_timeout_ns > 0:
            from ..abci.client import apply_deadlines
            apply_deadlines(
                self.app_conns,
                default_timeout_s=cfg.base.abci_call_timeout_ns / 1e9,
                retries=cfg.base.abci_call_retries)

        # a flight-recorder span per ABCI call, then per-method timing
        from ..abci.client import apply_tracing
        apply_tracing(self.app_conns)
        from ..abci.metrics import instrument_app_conns
        instrument_app_conns(self.app_conns, self.proxy_metrics)

        # ABCI call-trace recording for the grammar checker
        if cfg.base.abci_grammar_trace:
            from ..abci.grammar import RecordingClient
            self.abci_trace: list = []
            for _conn in ("consensus", "mempool", "query", "snapshot"):
                setattr(self.app_conns, _conn,
                        RecordingClient(getattr(self.app_conns, _conn),
                                        self.abci_trace))

        # ABCI handshake reconciles app and store
        handshaker = Handshaker(self.state_store, self.initial_state,
                                self.block_store, self.genesis_doc,
                                logger=new_logger("handshaker"),
                                device=self.device)
        await handshaker.handshake(self.app_conns)
        state = self.state_store.load() or self.initial_state

        # mempool (lanes from the app's Info)
        info = await self.app_conns.query.info(abci.InfoRequest())
        self.mempool = CListMempool(
            cfg.mempool, self.app_conns.mempool,
            lanes=info.lane_priorities or None,
            default_lane=info.default_lane,
            height=state.last_block_height,
            metrics=self.mempool_metrics)

        # pruner service, started once the indexers are attached
        from ..state.pruner import Pruner
        self.pruner = Pruner(
            self.state_store, self.block_store,
            new_db("pruner", cfg.base.db_backend,
                   cfg.base.path(cfg.base.db_dir)),
            companion_enabled=bool(cfg.grpc.privileged_laddr and
                                   cfg.grpc.pruning_service_enabled),
            metrics=self.state_metrics)

        from ..evidence import EvidencePool, EvidenceReactor
        self.evidence_pool = EvidencePool(
            new_db("evidence", cfg.base.db_backend,
                   cfg.base.path(cfg.base.db_dir)),
            self.state_store, self.block_store, device=self.device)

        # indexers + service
        from ..indexer import BlockIndexer, IndexerService, TxIndexer
        if cfg.tx_index.indexer == "kv":
            idx_db = new_db("tx_index", cfg.base.db_backend,
                            cfg.base.path(cfg.base.db_dir))
            self.tx_indexer = TxIndexer(idx_db)
            self.block_indexer = BlockIndexer(idx_db)
            self.indexer_service = IndexerService(
                self.tx_indexer, self.block_indexer, self.event_bus)
            await self.indexer_service.start()
        elif cfg.tx_index.indexer == "psql":
            from ..indexer.sink_sql import SQLEventSink
            conn = cfg.tx_index.psql_conn or cfg.base.path(
                os.path.join(cfg.base.db_dir, "events.sqlite"))
            self._event_sink = SQLEventSink(
                conn, self.genesis_doc.chain_id)
            self.tx_indexer = self._event_sink.tx_indexer
            self.block_indexer = self._event_sink.block_indexer
            self.indexer_service = IndexerService(
                self.tx_indexer, self.block_indexer, self.event_bus)
            await self.indexer_service.start()
        else:
            self.tx_indexer = None
            self.block_indexer = None
            self.indexer_service = None
        self.pruner.tx_indexer = self.tx_indexer
        self.pruner.block_indexer = self.block_indexer
        await self.pruner.start()

        block_exec = BlockExecutor(
            self.state_store, self.app_conns.consensus,
            mempool=self.mempool, evpool=self.evidence_pool,
            event_bus=self.event_bus,
            block_store=self.block_store,
            metrics=self.state_metrics, device=self.device)
        block_exec.pruner = self.pruner
        self.block_exec = block_exec

        wal_path = cfg.base.path(cfg.consensus.wal_file)
        self.consensus_state = ConsensusState(
            cfg.consensus, state, block_exec, self.block_store,
            priv_validator=self.priv_validator,
            event_bus=self.event_bus, wal=WAL(wal_path),
            metrics=self.consensus_metrics,
            supervisor=self.supervisor, device=self.device)
        try:
            try:
                await catchup_replay(self.consensus_state, wal_path)
            except CorruptWALError as e:
                # one repair attempt: keep the valid prefix, replay again
                from ..consensus.wal import repair_wal_file
                # off the loop; awaited, so the truncate ends before
                # anything else touches the WAL
                dropped = await asyncio.to_thread(repair_wal_file, wal_path)
                self.consensus_state.wal.reopen()
                self.logger.error(
                    "WAL corrupted; repaired by truncating",
                    err=str(e), dropped_bytes=dropped)
                await catchup_replay(self.consensus_state, wal_path)
        except (ReplayError, CorruptWALError) as e:
            # a non-corruption catchup error is logged and the node
            # starts anyway (reference state.go OnStart)
            self.logger.error(
                "Error on catchup replay; proceeding to start node "
                "anyway", err=str(e))
        state = self.state_store.load() or state

        # state sync runs only on a fresh node and always hands off to
        # block sync
        run_statesync = (cfg.statesync.enable and
                         state.last_block_height == 0)
        run_blocksync = run_statesync or (
            cfg.blocksync.enable and
            not _only_validator_is_us(
                state, self.priv_validator.get_pub_key()))

        self.consensus_reactor = ConsensusReactor(
            self.consensus_state, wait_sync=run_blocksync)
        self.switch.add_reactor(self.consensus_reactor)
        self.mempool_reactor = MempoolReactor(self.mempool, cfg.mempool)
        self.switch.add_reactor(self.mempool_reactor)
        self.evidence_reactor = EvidenceReactor(self.evidence_pool)
        self.switch.add_reactor(self.evidence_reactor)

        from ..blocksync import BlocksyncReactor
        self.blocksync_reactor = BlocksyncReactor(
            state, block_exec, self.block_store,
            active=run_blocksync,
            on_caught_up=self._switch_to_consensus,
            metrics=self.blocksync_metrics, device=self.device)
        self.switch.add_reactor(self.blocksync_reactor)
        self._run_blocksync = run_blocksync

        # state sync: a fresh node with statesync enabled bootstraps from
        # a peer snapshot, its trusted state and commit fetched by the
        # light client over the configured RPC servers; every node
        # serves snapshots
        from ..statesync.reactor import StatesyncReactor
        from ..statesync.syncer import Syncer
        self._statesync_syncer = None
        if run_statesync:
            sp = await self._make_state_provider(state)
            syncer = Syncer(
                self.app_conns, sp,
                request_chunk=lambda snap, i:
                    self.statesync_reactor.request_chunk(snap, i),
                chunk_timeout_s=(cfg.statesync
                                 .chunk_request_timeout_ns / 1e9),
                chunk_dir=cfg.statesync.temp_dir or None)
            self._statesync_syncer = syncer
            self.statesync_reactor = StatesyncReactor(
                self.app_conns, syncer,
                metrics=self.statesync_metrics)
        else:
            self.statesync_reactor = StatesyncReactor(
                self.app_conns, metrics=self.statesync_metrics)
        self.switch.add_reactor(self.statesync_reactor)

        if cfg.instrumentation.loop_lag_interval_s > 0:
            from ..libs.health import LoopLagSampler
            sampler = LoopLagSampler(
                self.health_metrics,
                interval_s=cfg.instrumentation.loop_lag_interval_s)
            self.supervisor.spawn(sampler.run, name="loop_lag",
                                  kind="loop_lag")

        # RPC before p2p (reference: OnStart order)
        if cfg.rpc.laddr:
            from ..rpc.server import RPCServer
            self._rpc_server = RPCServer(self, cfg.rpc)
            await self._rpc_server.start()

        if cfg.instrumentation.pprof_listen_addr:
            from ..libs.pprof import PprofServer
            self._pprof_server = PprofServer(
                cfg.instrumentation.pprof_listen_addr)
            await self._pprof_server.start()

        # gRPC data-companion services
        if cfg.grpc.laddr:
            self._grpc_server = _grpc_server(
                "grpc.laddr",
                block_store=self.block_store,
                state_store=self.state_store,
                event_bus=self.event_bus,
                version_service=cfg.grpc.version_service_enabled,
                block_service=cfg.grpc.block_service_enabled,
                block_results_service=(
                    cfg.grpc.block_results_service_enabled))
            await self._grpc_server.start(cfg.grpc.laddr)
        if cfg.grpc.privileged_laddr and \
                cfg.grpc.pruning_service_enabled:
            self._grpc_priv_server = _grpc_server(
                "grpc.privileged_laddr",
                pruner=self.pruner, pruning_service=True)
            await self._grpc_priv_server.start(
                cfg.grpc.privileged_laddr)

        await self.switch.start()
        if cfg.p2p.persistent_peers:
            addrs = [a.strip() for a in
                     cfg.p2p.persistent_peers.split(",") if a.strip()]
            self.switch.dial_peers_async(
                [a.split("@")[-1] for a in addrs])

        if self._statesync_syncer is not None:
            new_state, commit = await self._statesync_syncer.sync_any(
                cfg.statesync.discovery_time_ns / 1e9)
            # bootstrap the stores at the snapshot height; consensus
            # takes the state at the block-sync hand-off
            self.state_store.bootstrap(new_state)
            self.block_store.save_seen_commit_standalone(commit)
            self.blocksync_reactor.state = new_state
            self.statesync_reactor.metrics.syncing.set(0)
            self.logger.info("State sync complete",
                             height=new_state.last_block_height)
            await self.blocksync_reactor.start_sync()
        elif self._run_blocksync:
            await self.blocksync_reactor.start_sync()
        else:
            await self.consensus_state.start()
        self._started = True
        self.logger.info("Node started",
                         node_id=self.node_key.id[:12],
                         chain=self.genesis_doc.chain_id)

    async def _switch_to_consensus(self, new_state, height) -> None:
        """Reference: consensus.Reactor.SwitchToConsensus — LastCommit
        rebuilt from the stored seen commit (B1, off the loop) before the
        synced state is taken."""
        if new_state.last_block_height > 0:
            self.consensus_state.rs.last_commit = None
            await self.consensus_state \
                .reconstruct_last_commit_off_loop(new_state)
        self.consensus_state.update_to_state(new_state)
        # flip wait_sync only once RoundState reflects the synced height
        self.consensus_reactor.wait_sync = False
        await self.consensus_state.start()
        self.logger.info("Switched from blocksync to consensus",
                         height=height)

    async def _watch_app(self) -> None:
        """The node's failure once an app connection ends with an
        error (reference: killTMOnClientError)."""
        err = await self.app_conns.wait_dead()
        if err is None or self._stopping:
            return
        self.failure = NodeError(
            f"ABCI client connection terminated; did the application "
            f"crash? ({err})")
        self.logger.error("ABCI connection terminated; stopping the node",
                          err=str(err))
        if self.consensus_state is not None:
            # consensus must not go on against an app whose state is
            # unknown: stopped as a crash is (the WAL and the handshake
            # recover the height on a restart)
            try:
                await self.consensus_state.stop(drain_pipeline=False)
            except Exception as e:  # noqa: BLE001 — the app's error is the node's
                self.logger.error("consensus stopped with an error after "
                                  "the app died", err=repr(e))

    def _on_watch_giveup(self, st, exc: BaseException) -> None:
        if self.failure is None:
            self.failure = exc

    def raise_if_failed(self) -> None:
        """Raise the error that stopped the node, if any: a dead app, or
        a fatal error of consensus, block sync or the evidence reactor."""
        if self.failure is not None:
            raise self.failure
        for part in (self.consensus_state, self.blocksync_reactor,
                     self.evidence_reactor):
            if part is not None:
                part.raise_if_failed()

    async def wait(self) -> None:
        """Return never while the node runs; raise its failure as soon as
        it has one (what ``cmd start`` awaits beside its signals)."""
        while True:
            self.raise_if_failed()
            await asyncio.sleep(_WAIT_POLL_S)

    async def stop(self) -> None:
        """Stop every part that started; then raise the node's failure,
        if it had one."""
        from ..ops import ed25519_kernel, ed25519_kernel8
        if self._stopping:
            self.raise_if_failed()
            return
        await self._teardown()
        # the kernels' launch counts of this process, for an operator
        # (and chip_smoke.py) to read from a node process's log
        self.logger.info("Node stopped", b1_launches=ed25519_kernel.launches,
                         b2_launches=ed25519_kernel8.launches)
        self.raise_if_failed()

    async def _teardown(self) -> None:
        self._stopping = True
        failure = None
        if getattr(self, "pruner", None) is not None:
            await self.pruner.stop()
        if getattr(self, "indexer_service", None) is not None:
            await self.indexer_service.stop()
        if getattr(self, "_event_sink", None) is not None:
            self._event_sink.close()
        if self.blocksync_reactor is not None:
            try:
                await self.blocksync_reactor.stop_sync()
            except Exception as e:  # noqa: BLE001 — raised by stop()
                failure = failure or e
        if self.consensus_state is not None:
            try:
                await self.consensus_state.stop()
            except Exception as e:  # noqa: BLE001 — raised by stop()
                failure = failure or e
        await self.supervisor.stop()
        await self.switch.stop()
        if self._rpc_server is not None:
            await self._rpc_server.stop()
        if getattr(self, "_pprof_server", None) is not None:
            await self._pprof_server.stop()
        if getattr(self, "_grpc_server", None) is not None:
            await self._grpc_server.stop()
        if getattr(self, "_grpc_priv_server", None) is not None:
            await self._grpc_priv_server.stop()
        await self.app_conns.stop()
        if getattr(self, "_signer_endpoint", None) is not None:
            await self._signer_endpoint.stop()
        self._started = False
        if failure is not None and self.failure is None:
            self.failure = failure

    async def _make_state_provider(self, state):
        """Light-client state provider over the configured RPC servers
        (reference: stateprovider.go:29), verifying on the node's
        device."""
        from ..statesync.syncer import new_rpc_state_provider
        cfg = self.config.statesync
        if not cfg.rpc_servers or not cfg.trust_hash or \
                not cfg.trust_height:
            raise NodeError(
                "statesync.enable requires rpc_servers and "
                "trust_height/trust_hash (reference config)")
        return await new_rpc_state_provider(
            self.genesis_doc.chain_id, self.genesis_doc,
            list(cfg.rpc_servers), cfg.trust_height,
            bytes.fromhex(cfg.trust_hash), cfg.trust_period_ns,
            device=self.device)

    # ------------------------------------------------------------------
    @property
    def height(self) -> int:
        return self.block_store.height

    def status(self) -> dict:
        state = self.state_store.load()
        latest_meta = self.block_store.load_block_meta(
            self.block_store.height)
        pub = self.priv_validator.get_pub_key()
        return {
            "node_info": {
                "id": self.node_key.id,
                "listen_addr": self.switch.listen_addr,
                "network": self.genesis_doc.chain_id,
                "moniker": self.config.base.moniker,
            },
            "sync_info": {
                "latest_block_hash":
                    latest_meta.block_id.hash.hex().upper()
                    if latest_meta else "",
                "latest_app_hash":
                    (state.app_hash.hex().upper() if state else ""),
                "latest_block_height": str(self.block_store.height),
                "latest_block_time":
                    latest_meta.header.time.rfc3339()
                    if latest_meta else "",
                "earliest_block_height": str(self.block_store.base),
                "catching_up": False,
            },
            "validator_info": {
                "address": pub.address().hex().upper(),
                "pub_key": pub_key_to_json(pub),
                "voting_power": str(_voting_power(state, pub)),
            },
        }


def _grpc_server(key: str, **kw):
    """A gRPC companion server; raises NodeError naming ``key`` where
    grpcio is not installed (the node does not skip a configured
    server)."""
    try:
        from ..rpc.grpc import GRPCServer
    except ImportError as e:
        raise NodeError(f"{key} is set but the gRPC server cannot load: "
                        f"{e}") from e
    return GRPCServer(**kw)


def _voting_power(state, pub) -> int:
    if state is None or state.validators is None:
        return 0
    _, val = state.validators.get_by_address(pub.address())
    return val.voting_power if val else 0


def _only_validator_is_us(state, pub) -> bool:
    """Reference: node/setup.go onlyValidatorIsUs."""
    if state.validators is None or state.validators.size() != 1:
        return False
    return state.validators.validators[0].address == pub.address()
