"""QA scale run: a 15+ node, 100+ validator live net under staged
load, with a kill/restart perturbation and a state-sync late joiner.

The port's counterpart of cometbft_tpu/tools/qa.py.  Reference:
docs/references/qa/method.md and CometBFT-QA-v1.md (the 200-node /
175-validator saturation study, scaled to one host) and
test/e2e/runner/benchmark.go (block-interval stats).  The run records a
tx/s saturation table and latency quantiles per load window.

Shape of the net (single host):
- 12 live validators (power 100 each) + 3 full nodes across three
  latency zones (50/100/150 ms one-way links through
  ``tools/manifest.RelaySpec`` relays)
- 90 ghost validators in the genesis set with power 1 and mixed key
  types (ed25519/secp256k1) that never come online: every commit
  carries a 102-slot signature array, while quorum rests with the
  live 12 (1200 of 1290 power)
- one state-sync late joiner that bootstraps from a snapshot mid-run

Two modes.  ``run_qa`` runs every node as a ``Node`` in this process;
``run_qa_procs`` runs one ``python -m cometbft_tpu_torch.cmd --home H
start`` process a node, the reference method's shape.  Every node
verifies its commits with B1 on the card unless the caller names
another device (``run_qa(device=...)``; a process fleet's children take
the card as ``cmd start`` does).  Where this differs from the JAX tool:

  * a child node process runs on the card (no CPU pin) and writes its
    log to ``<home>/node.log``; its B1 / B2 launch counts are read from
    its "Node stopped" line at teardown (``QAReport.node_launches``); the
    kill -9 victim's first life keeps its log in ``<home>/node.kill9.log``;
  * a child that exits on its own, or with a code other than 0 when it
    is stopped, is a mismatch (with its log's last line), and so is a
    state-sync joiner that does not reach its target, so ``main`` exits
    1; a node's failure is never degraded away;
  * the resource sampler reads ``/proc/<pid>/{stat,statm,fd}`` itself;
  * the default outputs are ``QA_torch_*.json``.

Run:  python -m cometbft_tpu_torch.tools.qa [--quick] [--procs]
"""
from __future__ import annotations

import asyncio
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..config import Config
from ..crypto import ed25519, secp256k1
from ..libs.log import new_logger
from ..p2p.key import NodeKey
from ..privval import FilePV
from ..types.genesis import GenesisDoc, GenesisValidator
from ..types.timestamp import Timestamp

logger = new_logger("qa")

ZONES = ["zone-a", "zone-b", "zone-c"]
ZONE_LATENCY_MS = {"zone-a:zone-b": 50, "zone-a:zone-c": 100,
                   "zone-b:zone-c": 150}


@dataclass
class WindowResult:
    rate: int
    duration_s: float
    sent: int = 0
    accepted: int = 0
    dropped: int = 0            # open-loop ticks held by the cap
    stalled: bool = False       # net could not advance 2 blocks after
    committed: int = 0          # the window: past saturation
    tx_per_s: float = 0.0
    latency_p50_s: float = 0.0
    latency_p90_s: float = 0.0
    latency_max_s: float = 0.0
    # per-window resource series (process mode; reference QA method
    # tables: CometBFT-QA-v1.md:318-334 record RSS/CPU per node)
    rss_avg_mb: float = 0.0
    rss_max_mb: float = 0.0
    cpu_total_pct: float = 0.0
    fds_max: int = 0
    mempool_avg: float = 0.0
    mempool_max: int = 0
    # fraction of peer-delivered txs the dedup cache had already seen
    # during this window, summed over all nodes: the gated redundancy
    # number of the tx gossip plane (flood runs ~0.9)
    dup_ratio: float = -1.0
    gossip_txs: int = 0


@dataclass
class QAReport:
    nodes: int = 0
    validators_total: int = 0
    validators_live: int = 0
    windows: list[WindowResult] = field(default_factory=list)
    saturation_rate: int = 0
    # generator self-check against a null sink (offered ~= requested
    # must hold independent of the engine under test)
    offered_check: dict = field(default_factory=dict)
    # commit signature width actually flowing through verification
    commit_sigs_avg: float = 0.0
    commit_sigs_min: int = 0
    commit_sigs_heights: int = 0
    # top hot-path entries from node 0's cProfile during the highest-
    # rate window (libs/pprof.py /debug/pprof/profile)
    profile_top: list = field(default_factory=list)
    block_interval_avg_s: float = 0.0
    block_interval_std_s: float = 0.0
    block_interval_min_s: float = 0.0
    block_interval_max_s: float = 0.0
    final_height: int = 0
    perturbation: str = ""
    perturbed_recovered: bool = False
    statesync_joiner_height: int = 0
    # cumulative duplicate-delivery ratio over the whole run (gated
    # <= 0.50 — at most 2 deliveries per tx per node on average)
    dup_ratio_overall: float = -1.0
    # compact-block protocol totals scraped at run end (proc mode):
    # sent / reconstructed prove the fast path ran, misses +
    # mismatches prove the full-part fallback was exercised in-run
    compact_blocks: dict = field(default_factory=dict)
    # cluster critical-path metrics from the fleet collector's
    # artifact (-1 = not measured): p95 time from proposal
    # first-sent to 2/3 prevote power arriving at a node, and the max
    # inter-node commit skew observed at any height
    fleet_path: str = ""
    prevote_t23_p95_s: float = -1.0
    commit_skew_max_s: float = -1.0
    mismatches: list[str] = field(default_factory=list)
    notes: list[str] = field(default_factory=list)
    # measurements that ran but missed their objective (a scrape, a
    # latency gate): a degraded scenario must be explicit in the
    # artifact; a node's failure, the joiner's included, is a mismatch
    degraded: list[str] = field(default_factory=list)
    # process mode: B1 / B2 launches of each node process that logged
    # its "Node stopped" line ({name: {"b1": n, "b2": n}}), and the
    # seconds from the first spawn to the net's height 2
    node_launches: dict = field(default_factory=dict)
    first_block_s: float = 0.0

    def to_dict(self) -> dict:
        import dataclasses
        return dataclasses.asdict(self)


# every port this run has handed out: the bind-then-close pattern can
# yield the same port twice across many rapid allocations (observed as
# a relay bind EADDRINUSE on the 70-relay full-scale run)
_USED_PORTS: set = set()


def _free_port() -> int:
    import socket
    while True:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        p = s.getsockname()[1]
        s.close()
        if p not in _USED_PORTS:
            _USED_PORTS.add(p)
            return p


def _mk_cfg(root: str, name: str, zone: str) -> Config:
    home = os.path.join(root, name)
    cfg = Config()
    cfg.base.home = home
    cfg.base.moniker = name
    cfg.base.db_backend = "memdb"
    cfg.p2p.laddr = f"tcp://127.0.0.1:{_free_port()}"
    cfg.rpc.laddr = f"tcp://127.0.0.1:{_free_port()}"
    cfg.p2p.allow_duplicate_ip = True
    cfg.p2p.pex = False          # fixed topology under latency relays
    cfg.consensus.timeout_commit_ns = 200_000_000
    # rig configuration: pipelined commit + incremental recheck are
    # the defaults; adaptive timeouts are off by default product-wide
    # but ON for the QA rig — propose/vote timeouts derived from the
    # measured quorum delay
    cfg.consensus.adaptive_timeouts = True
    # empty blocks at most every 2 s: at pipelined sub-second
    # intervals, 16 time-shared processes otherwise burn the core
    # committing empty blocks between load windows
    cfg.consensus.create_empty_blocks_interval_ns = 2_000_000_000
    cfg.mempool.size = 20_000
    # 16 KiB wire packets (reference default 1 KiB): a 512 KiB part
    # fallback at 1 KiB packets pays 512 framing + AEAD passes per
    # link — pure per-packet python overhead on a time-shared core.
    # The reconciliation plane makes big blocks cheap to PROPOSE
    # (compact form); this makes the remaining full-part traffic
    # cheap to carry.
    cfg.p2p.max_packet_msg_payload_size = 16384
    os.makedirs(os.path.join(home, "config"), exist_ok=True)
    os.makedirs(os.path.join(home, "data"), exist_ok=True)
    return cfg


def _ghost_validators(n: int) -> list[GenesisValidator]:
    """Validators in the set that never come online — mixed key types
    so the commit verification path sees a heterogeneous 100+ slot
    array (BASELINE config #5's shape)."""
    out = []
    for i in range(n):
        if i % 2 == 0:
            pub = ed25519.gen_priv_key().pub_key()
        else:
            pub = secp256k1.gen_priv_key().pub_key()
        out.append(GenesisValidator(address=b"", pub_key=pub, power=1))
    return out


def _link_port(zones: dict, relay_specs: list, a: str, b: str,
               target_port: int) -> int:
    """Port for a->b traffic: direct when same zone, else through a
    latency relay matching the zone pair (manifest.py pattern)."""
    from .manifest import RelaySpec
    za, zb = zones.get(a, ZONES[0]), zones.get(b, ZONES[0])
    key = f"{za}:{zb}" if f"{za}:{zb}" in ZONE_LATENCY_MS \
        else f"{zb}:{za}"
    ms = ZONE_LATENCY_MS.get(key, 0) if za != zb else 0
    if ms == 0:
        return target_port
    port = _free_port()
    relay_specs.append(RelaySpec(
        port=port, target_host="127.0.0.1",
        target_port=target_port, delay_s=ms / 1000.0))
    return port


def _setup_net(outdir: str, n_validators: int, n_full: int,
               ghosts: int, report: "QAReport",
               single_zone: bool = False, peer_degree: int = 0,
               max_block_bytes: int = 262144):
    """Everything both QA modes share before boot: per-node homes and
    keys, the mixed-key genesis with ghost validators, the topology
    (full mesh over inter-zone latency relays by default;
    single_zone=True drops the WAN emulation and peer_degree=k bounds
    each node to ring+skip neighbors — the sig-scale stage uses both,
    where the deliverable is signature width, not WAN behavior, and
    363 relay links across 33 time-shared processes starve the core).

    Returns (names, zones, cfgs, joiner_cfg, node_ids, p2p_port,
    relay_specs); cfgs have persistent_peers filled in."""
    names = [f"validator{i:02d}" for i in range(n_validators)] + \
            [f"full{i:02d}" for i in range(n_full)]
    zones = {name: ZONES[0] if single_zone
             else ZONES[i % len(ZONES)]
             for i, name in enumerate(names)}
    cfgs = {name: _mk_cfg(outdir, name, zones[name])
            for name in names}
    joiner_cfg = _mk_cfg(outdir, "joiner", ZONES[0])

    pvs = {}
    for name in names + ["joiner"]:
        cfg = cfgs.get(name, joiner_cfg)
        pvs[name] = FilePV.generate(
            cfg.base.path(cfg.base.priv_validator_key_file),
            cfg.base.path(cfg.base.priv_validator_state_file))
        NodeKey.load_or_gen(cfg.base.path(cfg.base.node_key_file))
    vals = [GenesisValidator(address=b"",
                             pub_key=pvs[n].get_pub_key(), power=100)
            for n in names[:n_validators]]
    vals += _ghost_validators(ghosts)
    doc = GenesisDoc(chain_id="qa-net", genesis_time=Timestamp.now(),
                     validators=vals)
    doc.consensus_params.validator.pub_key_types = [
        "ed25519", "secp256k1"]
    doc.consensus_params.feature.pbts_enable_height = 1
    # bound proposals under backlog: with 256 B load txs and the 4 MB
    # default, a single post-saturation proposal reaps the entire
    # queue — a block too big to gossip through the latency relays
    # before the propose timeout, so rounds churn while the backlog
    # (and the next proposal) keeps growing.  128 KiB ≈ 450 txs kept
    # rounds bounded for the serial engine; with pipelined commits
    # and timeouts that adapt to the measured gossip delay the rig
    # carries 256 KiB ≈ 900 txs per block — operators size real
    # chains the same way.  With the reconciliation data plane a
    # proposal's bytes stop scaling with peer
    # count — compact-capable peers receive skeleton + tx hashes and
    # rebuild from their pools — and the adaptive timeouts absorb
    # whatever gossip delay remains, so the rate-100+ acceptance run
    # escalates past this cap (run_qa_procs(max_block_bytes=...)).
    doc.consensus_params.block.max_bytes = max_block_bytes
    doc.consensus_params.evidence.max_bytes = 32768
    report.validators_total = len(vals)
    report.validators_live = n_validators
    report.nodes = len(names) + 1

    node_ids = {}
    for name in names + ["joiner"]:
        cfg = cfgs.get(name, joiner_cfg)
        doc.save_as(cfg.base.path(cfg.base.genesis_file))
        node_ids[name] = NodeKey.load_or_gen(
            cfg.base.path(cfg.base.node_key_file)).id

    relay_specs: list = []
    p2p_port = {name: int(cfgs[name].p2p.laddr.rsplit(":", 1)[1])
                for name in names}
    n = len(names)
    for i, name in enumerate(names):
        if peer_degree and n > peer_degree:
            # ring + doubling skips: connected, diameter O(log n)
            offs = {1, 2}
            k = 4
            while k < n and len(offs) < peer_degree:
                offs.add(k)
                k *= 2
            targets = [names[(i + o) % n] for o in sorted(offs)]
        else:
            targets = names[i + 1:]
        peers = []
        for other in targets:
            if other == name:
                continue
            peers.append(
                f"{node_ids[other]}@127.0.0.1:"
                f"{_link_port(zones, relay_specs, name, other, p2p_port[other])}")
        cfgs[name].p2p.persistent_peers = ",".join(peers)
    return names, zones, cfgs, joiner_cfg, node_ids, p2p_port, \
        relay_specs


def _note_saturation(report: "QAReport", w: "WindowResult",
                     rate: float) -> None:
    """Saturation rule (one place): the highest offered rate whose
    committed throughput still tracks >= 80% of it — and whose window
    did not stall (a net that needs minutes to advance after the
    window is past saturation even if the backlog commits)."""
    if not w.stalled and w.tx_per_s >= 0.8 * rate:
        report.saturation_rate = rate


async def _selfcheck_generator(report: "QAReport", rate: int) -> None:
    """Prove the generator offers the requested rate against a null
    sink BEFORE the run — a generator regression must never read as
    an engine saturation point."""
    from . import loadtime
    report.offered_check = await loadtime.selfcheck(
        rate=rate, duration_s=2.0)
    logger.info("load generator self-check",
                **report.offered_check)


# BLOCK_ID_FLAG_COMMIT / _NIL: slots that carry a real signature (the
# width the batch verification path actually processes) — the single
# definition both QA modes share
_PRESENT_SIG_FLAGS = (2, 3)


def _count_commit_sigs(signatures: list) -> int:
    """Non-absent signatures in a commit's 102-slot array (JSON
    form)."""
    return sum(1 for s in signatures
               if s is not None
               and s.get("block_id_flag") in _PRESENT_SIG_FLAGS)


async def _sample_commit_sigs(report: "QAReport", cli,
                              final_height: int) -> None:
    """Per-block verified-signature counts over sampled heights (the
    report states how many real signatures each commit carries
    through the batch path)."""
    counts = []
    for h in range(2, final_height + 1, max(1, final_height // 40)):
        try:
            c = await cli.call("commit", height=str(h))
            sigs = c["signed_header"]["commit"]["signatures"]
            counts.append(_count_commit_sigs(sigs))
        except Exception:
            continue
    if counts:
        report.commit_sigs_avg = round(
            sum(counts) / len(counts), 1)
        report.commit_sigs_min = min(counts)
        report.commit_sigs_heights = len(counts)


def _configure_joiner(joiner_cfg: Config, endpoints: list,
                      trust_height: int, trust_hash: str,
                      node_ids: dict, p2p_port: dict,
                      names: list) -> None:
    """Statesync late-joiner config (one place): light-client trust
    anchored 8 blocks back, first two nodes as RPC providers, first
    four as peers."""
    joiner_cfg.statesync.enable = True
    joiner_cfg.statesync.rpc_servers = [endpoints[0], endpoints[1]]
    joiner_cfg.statesync.trust_height = trust_height
    joiner_cfg.statesync.trust_hash = trust_hash
    joiner_cfg.statesync.discovery_time_ns = int(2e9)
    joiner_cfg.p2p.persistent_peers = ",".join(
        f"{node_ids[n]}@127.0.0.1:{p2p_port[n]}"
        for n in names[:4])


def _record_intervals(report: "QAReport", secs: list) -> None:
    """Block-interval stats (benchmark.go:15-24) from a sorted list
    of block timestamps in seconds."""
    intervals = [b - a for a, b in zip(secs, secs[1:])]
    if intervals:
        report.block_interval_avg_s = statistics.mean(intervals)
        report.block_interval_std_s = (
            statistics.pstdev(intervals)
            if len(intervals) > 1 else 0.0)
        report.block_interval_min_s = min(intervals)
        report.block_interval_max_s = max(intervals)


async def run_qa(outdir: str, n_validators: int = 12, n_full: int = 3,
                 ghosts: int = 90,
                 rates: tuple = (10, 25, 50, 100, 200),
                 window_s: float = 15.0, device=None) -> QAReport:
    """Every node a ``Node`` in this process, each verifying on
    ``device`` (None: the card).  A node's failure raises out of the
    run, the joiner's included."""
    from ..abci.kvstore import KVStoreApplication
    from ..db import new_db
    from ..node.node import Node
    from ..rpc.client import HTTPClient
    from . import loadtime
    from .manifest import Relay, start_relay

    report = QAReport()
    names, zones, cfgs, joiner_cfg, node_ids, p2p_port, relay_specs = \
        _setup_net(outdir, n_validators, n_full, ghosts, report)

    nodes: dict[str, Node] = {}
    relays: list[Relay] = []
    joiner: Optional[Node] = None
    try:
        for spec in relay_specs:
            relays.append(await start_relay(spec))
        for name in names:
            app = KVStoreApplication(
                db=new_db("app", "memdb",
                          cfgs[name].base.path("data")),
                snapshot_interval=5)
            nodes[name] = Node(cfgs[name], app=app, device=device)
            await nodes[name].start()
        logger.info("net booted", nodes=len(nodes),
                    relays=len(relays))

        endpoints = [f"http://{nodes[n]._rpc_server.listen_addr}"
                     for n in names[:3]]
        ref = nodes[names[0]]

        async def wait_height(h: int, budget: float,
                              who=None) -> None:
            pool = who if who is not None else list(nodes.values())
            deadline = time.monotonic() + budget
            while time.monotonic() < deadline:
                for n in pool:
                    n.raise_if_failed()
                if all(n.height >= h for n in pool):
                    return
                await asyncio.sleep(0.1)
            raise TimeoutError(
                f"net stuck: {[n.height for n in pool]} < {h}")

        await wait_height(2, 120.0)
        await _selfcheck_generator(report, max(rates))

        def _inproc_gossip_counters() -> tuple:
            recv = dup = 0.0
            for n in nodes.values():
                m = n.mempool.metrics
                recv += m.gossip_txs_received.value
                dup += m.gossip_txs_duplicate.value
            return recv, dup

        # --- load windows at increasing rates -----------------------
        for wi, rate in enumerate(rates):
            dup0 = _inproc_gossip_counters()
            res = await loadtime.generate(
                endpoints, rate=rate, connections=2,
                duration_s=window_s, size=256, method="async",
                max_in_flight=16)
            # let the tail commit; a net that cannot advance 2 blocks
            # is past saturation — record the window and stop
            # escalating instead of failing the whole run
            stalled = False
            h0 = ref.height
            try:
                await wait_height(h0 + 2, 60.0, who=[ref])
            except TimeoutError:
                stalled = True
            rep = await loadtime.report(
                endpoints[0], experiment_id=res.experiment_id)
            w = WindowResult(
                rate=rate, duration_s=window_s, sent=res.sent,
                accepted=res.accepted, dropped=res.dropped,
                stalled=stalled, committed=rep.latency.count,
                tx_per_s=rep.latency.count / window_s,
                latency_p50_s=rep.latency.p50_s,
                latency_p90_s=rep.latency.p90_s,
                latency_max_s=rep.latency.max_s)
            _apply_dup_window(w, dup0, _inproc_gossip_counters())
            report.windows.append(w)
            logger.info("load window done", rate=rate,
                        committed=w.committed,
                        tx_s=round(w.tx_per_s, 1),
                        p50=round(w.latency_p50_s, 3),
                        dup_ratio=w.dup_ratio,
                        stalled=stalled)
            _note_saturation(report, w, rate)
            if stalled:
                logger.info("net past saturation; stopping the ladder",
                            rate=rate)
                break

            if wi == 1:
                # --- perturbation between windows: kill/restart one
                # validator (reference: perturb.go)
                victim = names[n_validators - 1]
                report.perturbation = f"{victim}:kill-restart"
                await nodes[victim].stop()
                await asyncio.sleep(0.5)
                app = KVStoreApplication(
                    db=new_db("app", "memdb",
                              cfgs[victim].base.path("data")),
                    snapshot_interval=5)
                nodes[victim] = Node(cfgs[victim], app=app,
                                     device=device)
                await nodes[victim].start()
                h = ref.height
                await wait_height(h + 2, 120.0,
                                  who=[nodes[victim]])
                report.perturbed_recovered = True
                logger.info("perturbed node recovered",
                            victim=victim)

        # --- statesync late joiner ----------------------------------
        # a joiner that does not reach the target is a mismatch, not a
        # degraded stage; the recorded windows are kept in the report
        cli = HTTPClient(endpoints[0], timeout=30.0)
        try:
            th = max(1, ref.height - 8)
            blk = await cli.call("block", height=str(th))
            _configure_joiner(joiner_cfg, endpoints, th,
                              blk["block_id"]["hash"], node_ids,
                              p2p_port, names)
            # the joiner dials its peers and nobody dials it: it binds
            # free ports now, since the ones picked at setup may have
            # been taken by another process in the meantime
            joiner_cfg.p2p.laddr = "tcp://127.0.0.1:0"
            joiner_cfg.rpc.laddr = "tcp://127.0.0.1:0"
            app = KVStoreApplication(
                db=new_db("app", "memdb",
                          joiner_cfg.base.path("data")),
                snapshot_interval=5)
            joiner = Node(joiner_cfg, app=app, device=device)
            await joiner.start()
            target = ref.height
            await wait_height(target, 180.0, who=[joiner])
            report.statesync_joiner_height = joiner.height
            logger.info("statesync joiner caught up",
                        height=joiner.height)
        except Exception as e:
            # a node that failed is not a degraded stage
            for n in [*nodes.values(), joiner]:
                if n is not None:
                    n.raise_if_failed()
            logger.error("joiner stage failed", err=repr(e))
            report.mismatches.append(f"statesync_joiner: {e!r:.200}")

        report.final_height = ref.height
        _gate_dup_ratio(report, _inproc_gossip_counters())

        # --- commit signature width over sampled heights ------------
        counts = []
        step = max(1, report.final_height // 40)
        for h in range(2, report.final_height + 1, step):
            blk = ref.block_store.load_block(h)
            if blk is None:
                continue
            lc = blk.last_commit
            if hasattr(lc, "signers"):       # AggregateCommit
                counts.append(lc.signers.popcount())
            else:
                counts.append(sum(
                    1 for s in lc.signatures
                    if s.block_id_flag in _PRESENT_SIG_FLAGS))
        if counts:
            report.commit_sigs_avg = round(sum(counts) / len(counts), 1)
            report.commit_sigs_min = min(counts)
            report.commit_sigs_heights = len(counts)

        # --- block interval stats (benchmark.go:15-24) --------------
        times = []
        for h in range(2, ref.height + 1):
            meta = ref.block_store.load_block_meta(h)
            if meta is not None:
                times.append(meta.header.time.unix_ns() / 1e9)
        _record_intervals(report, times)

        # --- invariants ---------------------------------------------
        for h in range(1, report.final_height + 1):
            want = ref.block_store.load_block_meta(h)
            if want is None:
                continue
            for name, n in list(nodes.items()) + \
                    ([("joiner", joiner)] if joiner else []):
                got = n.block_store.load_block_meta(h)
                if got is None:
                    continue
                if got.block_id.hash != want.block_id.hash:
                    report.mismatches.append(
                        f"{name}@{h}: block hash mismatch")
                if got.header.app_hash != want.header.app_hash:
                    report.mismatches.append(
                        f"{name}@{h}: app hash mismatch")
    finally:
        stop_errors = []
        for n in list(nodes.values()) + ([joiner] if joiner else []):
            try:
                await n.stop()
            except Exception as e:  # noqa: BLE001 — raised below
                stop_errors.append(e)
        for r in relays:
            r.close()
        for r in relays:
            await r.wait_closed()
    if stop_errors:
        # a node that failed fails the run, found at its stop or before
        raise stop_errors[0]
    return report


# --------------------------------------------------------------------------
# process mode: every node is a separate OS process (real GC/scheduler/
# fd isolation), sampled from /proc — the reference QA method's shape
# (docs/references/qa/method.md; resource tables CometBFT-QA-v1.md).

_PAGE_BYTES = os.sysconf("SC_PAGE_SIZE")
_CLK_TCK = os.sysconf("SC_CLK_TCK")


def _proc_sample(pid: int) -> tuple[int, int, int]:
    """(RSS bytes, user + system CPU ticks, open fds) of a live process
    from /proc/<pid>/statm, /proc/<pid>/stat and /proc/<pid>/fd.
    Raises OSError (or ValueError on a torn read) once it is gone."""
    with open(f"/proc/{pid}/statm") as f:
        rss = int(f.read().split()[1]) * _PAGE_BYTES
    with open(f"/proc/{pid}/stat") as f:
        stat = f.read()
    # the fields after "(comm)": state is field 3, utime 14, stime 15
    rest = stat[stat.rindex(")") + 2:].split()
    ticks = int(rest[11]) + int(rest[12])
    fds = len(os.listdir(f"/proc/{pid}/fd"))
    return rss, ticks, fds


class _Sampler:
    """2 s sampler over the node subprocesses: RSS, CPU percent since
    the previous sample (100 = one core) and open fds of each, read
    from /proc."""

    def __init__(self, procs: dict):
        self.samples: list[tuple] = []     # (t, name, rss, cpu, fds)
        self._task: Optional[asyncio.Task] = None
        self._last: dict = {}              # name -> (pid, t, ticks)
        for name, proc in procs.items():
            self.track(name, proc)

    def track(self, name: str, proc) -> None:
        """Follow ``proc`` under ``name`` (a restarted node replaces its
        first life); the first reading primes the CPU counter."""
        try:
            _rss, ticks, _fds = _proc_sample(proc.pid)
        except (OSError, ValueError, IndexError):
            self._last.pop(name, None)
            return
        self._last[name] = (proc.pid, time.monotonic(), ticks)

    def sample_once(self) -> None:
        t = time.monotonic()
        for name, (pid, t0, ticks0) in list(self._last.items()):
            try:
                rss, ticks, fds = _proc_sample(pid)
            except (OSError, ValueError, IndexError):
                continue                   # process died/restarting
            dt = t - t0
            cpu = 100.0 * (ticks - ticks0) / _CLK_TCK / dt if dt > 0 \
                else 0.0
            self._last[name] = (pid, t, ticks)
            self.samples.append((t, name, rss, cpu, fds))

    async def _run(self, interval: float) -> None:
        while True:
            self.sample_once()
            await asyncio.sleep(interval)

    def start(self, interval: float = 2.0) -> None:
        self._task = asyncio.get_running_loop().create_task(
            self._run(interval))

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()

    def window_stats(self, t0: float, t1: float) -> dict:
        sel = [s for s in self.samples if t0 <= s[0] <= t1]
        if not sel:
            return {}
        rss = [s[2] for s in sel]
        # total CPU: sum of simultaneous per-process readings / ticks
        ticks = sorted({round(s[0], 1) for s in sel})
        cpu_by_tick = {}
        for s in sel:
            cpu_by_tick.setdefault(round(s[0], 1), 0.0)
            cpu_by_tick[round(s[0], 1)] += s[3]
        return {
            "rss_avg_mb": sum(rss) / len(rss) / 1e6,
            "rss_max_mb": max(rss) / 1e6,
            "cpu_total_pct": (sum(cpu_by_tick.values()) /
                              max(1, len(ticks))),
            "fds_max": max(s[4] for s in sel),
        }


# a node's log level in a fleet: the node's own lines (its start, its
# state-sync switch and its "Node stopped" line with the kernels'
# launch counts) and every module's errors
FLEET_LOG_LEVEL = "node:info,*:error"


def _write_node_overrides(cfg: Config) -> None:
    from ..confix import save_overrides
    save_overrides(cfg.base.home, {
        "base": {"moniker": cfg.base.moniker, "db_backend": "memdb",
                 "log_level": FLEET_LOG_LEVEL, "proxy_app": "kvstore"},
        "p2p": {"laddr": cfg.p2p.laddr,
                "persistent_peers": cfg.p2p.persistent_peers,
                "max_packet_msg_payload_size":
                    cfg.p2p.max_packet_msg_payload_size,
                "allow_duplicate_ip": True, "pex": False},
        "rpc": {"laddr": cfg.rpc.laddr},
        "instrumentation": {
            "pprof_listen_addr":
                cfg.instrumentation.pprof_listen_addr},
        "consensus": {
            "timeout_commit_ns": cfg.consensus.timeout_commit_ns,
            "pipeline_commit": cfg.consensus.pipeline_commit,
            "compact_blocks": cfg.consensus.compact_blocks,
            "vote_batch_max": cfg.consensus.vote_batch_max,
            "adaptive_timeouts": cfg.consensus.adaptive_timeouts,
            "adaptive_timeout_floor_ns":
                cfg.consensus.adaptive_timeout_floor_ns,
            "adaptive_timeout_ceiling_ns":
                cfg.consensus.adaptive_timeout_ceiling_ns,
            "create_empty_blocks_interval_ns":
                cfg.consensus.create_empty_blocks_interval_ns},
        "mempool": {
            "size": cfg.mempool.size,
            "recheck_incremental": cfg.mempool.recheck_incremental,
            "recheck_max_age_blocks":
                cfg.mempool.recheck_max_age_blocks,
            "gossip_reconciliation":
                cfg.mempool.gossip_reconciliation,
            "recon_push_peers": cfg.mempool.recon_push_peers},
        "statesync": {
            "enable": cfg.statesync.enable,
            "rpc_servers": list(cfg.statesync.rpc_servers or []),
            "trust_height": cfg.statesync.trust_height,
            "trust_hash": cfg.statesync.trust_hash,
            "discovery_time_ns": cfg.statesync.discovery_time_ns,
        },
    })


# the port's entry point a fleet starts for each node; ``--home H
# start`` follows.  No device flag: a child verifies on the card.
NODE_CLI = [sys.executable, "-m", "cometbft_tpu_torch.cmd"]
NODE_LOG = "node.log"
KILLED_LOG = "node.kill9.log"
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_STOPPED = re.compile(r"Node stopped b1_launches=(\d+) b2_launches=(\d+)")

_PRCTL = None                     # resolved lazily, in the parent


def _node_argv(home: str) -> list:
    return [*NODE_CLI, "--home", home, "start"]


def _node_env(extra: Optional[dict] = None) -> dict:
    """A child's environment: this process's, the repo on PYTHONPATH,
    then ``extra``.  Nothing pins the child to the CPU."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra or {})
    return env


def _spawn_node(home: str, env: Optional[dict] = None):
    """Start ``cmd start`` for ``home``, its stdout and stderr in
    ``<home>/node.log`` (the Popen's ``log_path``); ``env`` adds to the
    child's environment."""
    # resolve libc.prctl in the PARENT: importing/loading inside the
    # post-fork pre-exec window can deadlock on runtime locks held by
    # other threads (asyncio executor/getaddrinfo threads are live
    # when the victim restart and joiner spawns happen)
    global _PRCTL
    if _PRCTL is None:
        import ctypes
        try:
            _PRCTL = ctypes.CDLL("libc.so.6").prctl
        except OSError:
            _PRCTL = False

    def _die_with_parent():
        # a coordinator killed with SIGKILL never reaches its finally
        # block; leaked node processes then poison the NEXT run (CPU
        # contention + same chain-id p2p noise).  PR_SET_PDEATHSIG ties
        # each child's life to the coordinator's.
        if _PRCTL:
            _PRCTL(1, 9)                  # PR_SET_PDEATHSIG, SIGKILL

    log_path = os.path.join(home, NODE_LOG)
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            _node_argv(home), stdout=log, stderr=subprocess.STDOUT,
            env=_node_env(env), cwd=_REPO, preexec_fn=_die_with_parent)
    proc.log_path = log_path
    return proc


def _last_line(path: str) -> str:
    try:
        with open(path, errors="replace") as f:
            lines = [ln.strip() for ln in f if ln.strip()]
    except OSError as e:
        return f"(no log: {e})"
    return lines[-1][:300] if lines else "(empty log)"


def _stop_launches(path: str) -> Optional[dict]:
    """B1 / B2 launches from the last "Node stopped" line of a node's
    log, or None if it logged none."""
    try:
        with open(path, errors="replace") as f:
            found = _STOPPED.findall(f.read())
    except OSError:
        return None
    if not found:
        return None
    b1, b2 = map(int, found[-1])
    return {"b1": b1, "b2": b2}


def _note_exits(report: QAReport, procs: dict, seen: set) -> None:
    """Each child that has exited on its own since the last look is a
    mismatch, with its log's last line.  ``seen`` holds the processes
    already accounted for (the kill -9 victim's first life, noted
    exits)."""
    for name, proc in procs.items():
        if id(proc) in seen or proc.poll() is None:
            continue
        seen.add(id(proc))
        report.mismatches.append(
            f"{name}: node process exited on its own with rc "
            f"{proc.returncode}: {_last_line(proc.log_path)}")


async def _fetch_profile(pprof_port: int, seconds: int = 30) -> list:
    """Top cumulative-time lines from the node's live cProfile
    endpoint (libs/pprof.py), trimmed for the report."""
    import urllib.request

    def _get():
        url = (f"http://127.0.0.1:{pprof_port}/debug/pprof/profile"
               f"?seconds={seconds}")
        with urllib.request.urlopen(url, timeout=seconds + 30) as r:
            return r.read().decode(errors="replace")
    try:
        text = await asyncio.to_thread(_get)
    except Exception as e:
        return [f"profile fetch failed: {e!r}"]
    lines = [ln.rstrip() for ln in text.splitlines()]
    # keep the stats header + the first ~25 rows of the table
    out = []
    for ln in lines:
        if len(out) >= 30:
            break
        if ln.strip():
            out.append(ln)
    return out


# --------------------------------------------------------------------------
# fleet collector (docs/observability.md): periodic /trace + /health
# scrapes across every node streamed into one run-level artifact, so
# a finished (or crashed) run always has the cross-node evidence
# tools/fleet_report.py needs — not just the one node that failed.

class _FleetCollector:
    """Scrapes /trace (events + clock anchors) and /health from every
    node on a fixed cadence, deduplicating events across overlapping
    ring snapshots, and writes a ``fleet_<run>.json`` the fleet
    report consumes directly.  Best-effort throughout: a node
    mid-restart just misses a round."""

    def __init__(self, rpc_ep: dict, path: str,
                 interval_s: float = 10.0):
        self.rpc_ep = dict(rpc_ep)
        self.path = path
        self.interval_s = interval_s
        self._nodes: dict[str, dict] = {}
        self._health: dict[str, dict] = {}
        self._task = None
        self._stop = asyncio.Event()

    def track(self, name: str, endpoint: str) -> None:
        self.rpc_ep[name] = endpoint

    async def scrape_once(self) -> None:
        from ..rpc.client import HTTPClient
        for name, ep in list(self.rpc_ep.items()):
            cli = HTTPClient(ep, timeout=10.0)
            try:
                body = await cli.call("trace")
            except Exception as e:
                logger.debug("fleet trace scrape failed", node=name,
                             err=repr(e))
                continue
            rec = self._nodes.setdefault(
                name, {"node": name, "anchors": [], "events": {}})
            if body.get("node"):
                rec["node"] = body["node"]
            if body.get("anchors"):
                rec["anchors"] = body["anchors"]
            for e in body.get("events") or []:
                key = (e.get("ts_ns"), e.get("category"),
                       e.get("name"), e.get("dur_ns"))
                rec["events"][key] = e
            try:
                self._health[name] = await cli.call("health")
            except Exception as e:
                logger.debug("fleet health scrape failed", node=name,
                             err=repr(e))

    async def _run(self) -> None:
        while not self._stop.is_set():
            try:
                await self.scrape_once()
            except Exception as e:
                logger.debug("fleet scrape round failed",
                             err=repr(e))
            try:
                await asyncio.wait_for(self._stop.wait(),
                                       self.interval_s)
            except asyncio.TimeoutError:
                pass

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(
            self._run())

    async def stop_and_write(self) -> str:
        """Final fleet-wide scrape (the nodes are still up — this
        runs before teardown), then the artifact.  Returns the path
        or "" if nothing was ever collected."""
        self._stop.set()
        if self._task is not None:
            try:
                await self._task
            except Exception as e:
                logger.debug("fleet collector task died",
                             err=repr(e))
            self._task = None
        try:
            await self.scrape_once()
        except Exception as e:
            logger.debug("final fleet scrape failed", err=repr(e))
        if not self._nodes:
            return ""
        doc = {"nodes": {
            name: {"node": rec["node"], "anchors": rec["anchors"],
                   "events": sorted(
                       rec["events"].values(),
                       key=lambda e: int(e.get("ts_ns") or 0))}
            for name, rec in self._nodes.items()},
            "health": self._health}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, self.path)
        return self.path


# cluster-level gates: the waterfall numbers a healthy rig
# must hold.  p95 time-to-2/3-prevotes spans proposal receipt through
# vote gossip across WAN-profile relays under load; inter-node commit
# skew is bounded by one gossip round.  Generous on purpose — these
# catch regressions of kind (a stuck straggler, a gossip plane that
# stopped fanning out), not percentage drift.
PREVOTE_T23_P95_LIMIT_S = 10.0
COMMIT_SKEW_LIMIT_S = 5.0


def _gate_fleet(report: "QAReport", fleet_path: str) -> None:
    """Derive the gated cluster metrics from the collected fleet
    artifact via tools/fleet_report.py.  Self-degrading, never
    raising: a failed analysis leaves the metrics at their -1
    sentinels with a note."""
    if not fleet_path:
        return
    try:
        from . import fleet_report as fr
        fleet = fr.analyze(fr.load_inputs([fleet_path]))
        t23s = [r["prevote_t23_ms"] / 1e3
                for h in fleet["heights"].values()
                for r in h["nodes"].values()
                if r["prevote_t23_ms"] is not None]
        skews = [h["commit_skew_ms"] / 1e3
                 for h in fleet["heights"].values()]
        if t23s:
            t23s.sort()
            report.prevote_t23_p95_s = round(
                t23s[min(len(t23s) - 1, int(0.95 * len(t23s)))], 4)
            if report.prevote_t23_p95_s > PREVOTE_T23_P95_LIMIT_S:
                report.degraded.append("prevote_t23_p95")
        if skews:
            report.commit_skew_max_s = round(max(skews), 4)
            if report.commit_skew_max_s > COMMIT_SKEW_LIMIT_S:
                report.degraded.append("commit_skew")
    except Exception as e:
        logger.error("fleet gate failed", err=repr(e))
        report.notes.append(f"fleet-gate: {e!r:.120}")


# duplicate-delivery gate: at most 2 deliveries per tx
# per node on average — one useful + one duplicate, i.e. a duplicate
# fraction <= 0.5 of all gossip deliveries (flood ran ~0.9, >= 5x
# over the bar).  The hybrid push fast path and want-timeout
# refetches spend SOME redundancy for latency on purpose; a
# regression back toward flood self-degrades the run.  Windows with
# too few gossip deliveries to be meaningful are not judged.
DUP_RATIO_LIMIT = 0.50
_DUP_MIN_SAMPLES = 200


async def _scrape_metric_sums(eps: list, names: tuple) -> dict:
    """Sum the given (label-free) metric families over the /metrics
    endpoints, best-effort: a node mid-restart just drops out of the
    sum.  One transport/parse loop serving every scrape-based gate."""
    import urllib.request

    def _get(u: str) -> str:
        with urllib.request.urlopen(u + "/metrics", timeout=10) as r:
            return r.read().decode(errors="replace")

    out = {n: 0.0 for n in names}
    for ep in eps:
        try:
            text = await asyncio.to_thread(_get, ep)
        except Exception as e:
            logger.debug("metrics scrape failed", endpoint=ep,
                         err=repr(e))
            continue
        for line in text.splitlines():
            name, _, value = line.partition(" ")
            if name in out and value:
                out[name] += float(value)
    return out


async def _scrape_gossip_counters(eps: list) -> tuple[float, float]:
    s = await _scrape_metric_sums(
        eps, ("cometbft_mempool_gossip_txs_received",
              "cometbft_mempool_gossip_txs_duplicate"))
    return (s["cometbft_mempool_gossip_txs_received"],
            s["cometbft_mempool_gossip_txs_duplicate"])


def _apply_dup_window(w: "WindowResult", before: tuple,
                      after: tuple) -> None:
    recv = after[0] - before[0]
    dup = after[1] - before[1]
    w.gossip_txs = int(recv)
    if recv > 0:
        w.dup_ratio = round(dup / recv, 4)


def _gate_dup_ratio(report: "QAReport", totals: tuple) -> None:
    recv, dup = totals
    if recv > 0:
        report.dup_ratio_overall = round(dup / recv, 4)
    judged = [w for w in report.windows
              if w.gossip_txs >= _DUP_MIN_SAMPLES and
              w.dup_ratio >= 0]
    if judged and max(w.dup_ratio for w in judged) > DUP_RATIO_LIMIT:
        report.degraded.append("duplicate_delivery_ratio")


async def _scrape_compact_counters(eps: list) -> dict:
    """Compact-block / vote-batch totals (see _scrape_metric_sums)."""
    names = ("compact_blocks_sent", "compact_blocks_reconstructed",
             "compact_block_misses", "compact_block_mismatches",
             "vote_batches_sent")
    s = await _scrape_metric_sums(
        eps, tuple("cometbft_consensus_" + n for n in names))
    return {n: int(s["cometbft_consensus_" + n]) for n in names}


async def _rpc_ready(endpoint: str, budget: float, proc=None) -> bool:
    """True once ``endpoint`` answers /status within ``budget`` s;
    False at the budget, or as soon as the node process ``proc`` has
    exited."""
    from ..rpc.client import HTTPClient
    deadline = time.monotonic() + budget
    while time.monotonic() < deadline:
        if proc is not None and proc.poll() is not None:
            return False
        try:
            cli = HTTPClient(endpoint, timeout=5.0)
            await cli.call("status")
            return True
        except Exception:
            await asyncio.sleep(0.5)
    return False


async def _rpc_height(endpoint: str, attempts: int = 4) -> int:
    """Tip height with bounded retries: one slow /status on a busy
    host right after a load window must not void a 40-minute run
    (the pipelined engine commits sub-second blocks, so the
    post-window burst is much busier than it was at 7 s intervals)."""
    from ..rpc.client import HTTPClient
    last: Exception = RuntimeError("unreachable")
    for i in range(attempts):
        cli = HTTPClient(endpoint, timeout=10.0)
        try:
            st = await cli.call("status")
            return int(st["sync_info"]["latest_block_height"])
        except Exception as e:
            last = e
            logger.debug("status probe failed; retrying",
                         endpoint=endpoint, attempt=i + 1,
                         err=repr(e))
            await asyncio.sleep(2.0)
    raise last


async def run_qa_procs(outdir: str, n_validators: int = 12,
                       n_full: int = 3, ghosts: int = 90,
                       rates: tuple = (10, 25, 50, 100, 200),
                       window_s: float = 90.0,
                       perturb: bool = True,
                       joiner: bool = True,
                       profile: bool = True,
                       commit_timeout_ns: int = 0,
                       single_zone: bool = False,
                       peer_degree: int = 0,
                       max_block_bytes: int = 262144,
                       window_s_high: float = 0.0,
                       high_rate: int = 100,
                       device=None,
                       child_env: Optional[dict] = None,
                       on_live: Optional[Callable] = None) -> QAReport:
    """The reference-method QA run: separate OS process per node,
    90 s load windows, /proc resource series, mempool occupancy.

    Reference: docs/references/qa/method.md (the 90 s window and
    saturation-point procedure) and CometBFT-QA-v1.md:141-170 (result
    tables this report mirrors).

    perturb/joiner gate the kill-restart and statesync stages (the
    sig-scale stage runs without them); profile captures a cProfile
    window from node 0's live pprof in a DEDICATED window after the
    ladder — never overlapping a recorded window, since cProfile
    drags the profiled node ~2x.

    The libraries are built here, once, on ``device`` (None: the card)
    before any child starts, so no child builds.  ``child_env`` maps a
    node's name to variables added to its process's environment.
    ``on_live`` is called with ``{name: pid}`` of the live node
    processes after the first load window.  A child that exits on its
    own (or with a code other than 0 when it is stopped) is a mismatch;
    the run goes on without it.
    """
    from ..node.node import prebuild
    from ..rpc.client import HTTPClient
    from . import loadtime
    from .manifest import Relay, start_relay

    report = QAReport()
    names, zones, cfgs, joiner_cfg, node_ids, p2p_port, relay_specs = \
        _setup_net(outdir, n_validators, n_full, ghosts, report,
                   single_zone=single_zone, peer_degree=peer_degree,
                   max_block_bytes=max_block_bytes)
    pprof_port = _free_port()
    if profile:
        cfgs[names[0]].instrumentation.pprof_listen_addr = \
            f"127.0.0.1:{pprof_port}"
    if commit_timeout_ns:
        for cfg in cfgs.values():
            cfg.consensus.timeout_commit_ns = commit_timeout_ns
    for name in names:
        _write_node_overrides(cfgs[name])
    child_env = child_env or {}
    await asyncio.to_thread(prebuild, device)

    rpc_ep = {name: "http://" + cfgs[name].rpc.laddr[len("tcp://"):]
              for name in names}
    endpoints = [rpc_ep[n] for n in names[:3]]

    procs: dict = {}
    seen: set = set()          # children whose exit is accounted for
    relays: list[Relay] = []
    sampler: Optional[_Sampler] = None
    fleet: Optional[_FleetCollector] = None
    profile_task = None
    try:
        for spec in relay_specs:
            relays.append(await start_relay(spec))
        t_spawn = time.monotonic()
        for name in names:
            procs[name] = _spawn_node(cfgs[name].base.home,
                                      child_env.get(name))
        ready = await asyncio.gather(
            *(_rpc_ready(rpc_ep[n], 240.0, procs[n]) for n in names))
        _note_exits(report, procs, seen)
        if not all(ok or procs[n].poll() is not None
                   for n, ok in zip(names, ready)):
            raise TimeoutError("not all nodes became RPC-ready")
        sampler = _Sampler(procs)
        sampler.start()
        # fleet collector: /trace + /health across every node,
        # streamed into the run artifact; the final scrape happens in
        # the finally block BEFORE teardown, so even a crashed run
        # leaves the fleet-wide record (not just the failing node's)
        fleet = _FleetCollector(
            rpc_ep, os.path.join(
                outdir,
                f"fleet_{time.strftime('%Y%m%d-%H%M%S')}.json"))
        fleet.start()
        logger.info("process net booted", nodes=len(procs),
                    relays=len(relays))

        async def wait_height(h: int, budget: float, eps=None):
            eps = eps or [endpoints[0]]
            deadline = time.monotonic() + budget
            while time.monotonic() < deadline:
                _note_exits(report, procs, seen)
                hs = await asyncio.gather(
                    *(_rpc_height(e) for e in eps),
                    return_exceptions=True)
                if all(isinstance(x, int) and x >= h for x in hs):
                    return
                await asyncio.sleep(0.5)
            raise TimeoutError(f"net stuck below {h}")

        await wait_height(2, 180.0)
        report.first_block_s = time.monotonic() - t_spawn
        await _selfcheck_generator(report, max(rates))

        async def drain_mempool(budget_s: float = 150.0) -> None:
            """Let the backlog commit before the next stage so every
            window measures its own offered rate (not the previous
            rung's leftovers) and the joiner doesn't have to chase a
            tip that is digesting minutes of queued load."""
            deadline = time.monotonic() + budget_s
            cli0 = HTTPClient(endpoints[0], timeout=10.0)
            while time.monotonic() < deadline:
                try:
                    r = await cli0.call("num_unconfirmed_txs")
                    if int(r.get("n_txs", r.get("total", 0)) or 0) \
                            < 50:
                        return
                except Exception:
                    pass
                await asyncio.sleep(3.0)

        async def occupancy_series(stopper: asyncio.Event, out: list):
            cli = HTTPClient(endpoints[0], timeout=10.0)
            while not stopper.is_set():
                try:
                    r = await cli.call("num_unconfirmed_txs")
                    out.append(int(r.get("n_txs", r.get(
                        "total", 0)) or 0))
                except Exception:
                    pass
                await asyncio.sleep(2.0)

        all_eps = list(rpc_ep.values())
        for wi, rate in enumerate(rates):
            # wider windows at the high end of the ladder (the
            # rate-100+ numbers are the deliverable, so they get more
            # settling time than the warm-up rates)
            ws = window_s_high if (window_s_high > 0 and
                                   rate >= high_rate) else window_s
            occ: list[int] = []
            stop_occ = asyncio.Event()
            occ_task = asyncio.get_running_loop().create_task(
                occupancy_series(stop_occ, occ))
            dup0 = await _scrape_gossip_counters(all_eps)
            t0 = time.monotonic()
            res = await loadtime.generate(
                endpoints, rate=rate, connections=2,
                duration_s=ws, size=256, method="async",
                max_in_flight=16)
            stalled = False
            h0 = await _rpc_height(endpoints[0])
            try:
                await wait_height(h0 + 2, 90.0)
            except TimeoutError:
                # past saturation: record the window, stop escalating
                stalled = True
            t1 = time.monotonic()
            stop_occ.set()
            await occ_task
            rep = await loadtime.report(
                endpoints[0], experiment_id=res.experiment_id)
            w = WindowResult(
                rate=rate, duration_s=ws, sent=res.sent,
                accepted=res.accepted, dropped=res.dropped,
                stalled=stalled, committed=rep.latency.count,
                tx_per_s=rep.latency.count / ws,
                latency_p50_s=rep.latency.p50_s,
                latency_p90_s=rep.latency.p90_s,
                latency_max_s=rep.latency.max_s,
                mempool_avg=(sum(occ) / len(occ)) if occ else 0.0,
                mempool_max=max(occ) if occ else 0)
            for k, v in sampler.window_stats(t0, t1).items():
                setattr(w, k, v)
            _apply_dup_window(
                w, dup0, await _scrape_gossip_counters(all_eps))
            report.windows.append(w)
            logger.info(
                "load window done", rate=rate, committed=w.committed,
                tx_s=round(w.tx_per_s, 1),
                p50=round(w.latency_p50_s, 3),
                rss_max_mb=round(w.rss_max_mb, 1),
                cpu_pct=round(w.cpu_total_pct, 1),
                mempool_max=w.mempool_max,
                dup_ratio=w.dup_ratio, stalled=stalled)
            _note_saturation(report, w, rate)
            if wi == 0 and on_live is not None:
                _note_exits(report, procs, seen)
                on_live({n: p.pid for n, p in procs.items()
                         if p.poll() is None})
            if stalled:
                logger.info("net past saturation; stopping the ladder",
                            rate=rate)
                break
            await drain_mempool()

            if wi == 1 and perturb:
                # kill -9 + restart one validator (reference:
                # perturb.go kill); memdb state is lost, so recovery
                # exercises a real from-scratch blocksync
                victim = names[n_validators - 1]
                report.perturbation = f"{victim}:kill9-restart"
                _note_exits(report, procs, seen)
                first = procs[victim]
                seen.add(id(first))
                first.kill()
                await asyncio.to_thread(first.wait, timeout=30)
                # the first life's log stays beside the restart's
                killed_log = os.path.join(cfgs[victim].base.home,
                                          KILLED_LOG)
                os.replace(first.log_path, killed_log)
                first.log_path = killed_log
                await asyncio.sleep(0.5)
                procs[victim] = _spawn_node(cfgs[victim].base.home,
                                            child_env.get(victim))
                sampler.track(victim, procs[victim])
                if not await _rpc_ready(rpc_ep[victim], 240.0,
                                        procs[victim]):
                    _note_exits(report, procs, seen)
                    raise TimeoutError("victim never came back")
                h = await _rpc_height(endpoints[0])
                await wait_height(h + 2, 240.0,
                                  eps=[rpc_ep[victim]])
                report.perturbed_recovered = True
                logger.info("perturbed node recovered",
                            victim=victim)

        if profile:
            # DEDICATED profile window, outside the measured ladder:
            # cProfile costs ~2x on the profiled node and drags the
            # whole net, so it must never overlap a recorded window
            prate = report.saturation_rate or rates[0]
            profile_task = asyncio.get_running_loop().create_task(
                _fetch_profile(pprof_port, seconds=25))
            await loadtime.generate(
                endpoints, rate=prate, connections=2,
                duration_s=30.0, size=256, method="async",
                max_in_flight=16)
            report.profile_top = await profile_task
            profile_task = None
            logger.info("profile window captured", rate=prate,
                        lines=len(report.profile_top))

        cli = HTTPClient(endpoints[0], timeout=30.0)
        joiner_ep = None
        if joiner:
            # let any remaining backlog commit first: the joiner
            # otherwise blocksyncs against a net that is busy
            # committing minutes of queued load
            await drain_mempool(240.0)

            # --- statesync late joiner (own process) ----------------
            th = max(1, await _rpc_height(endpoints[0]) - 8)
            blk = await cli.call("block", height=str(th))
            _configure_joiner(joiner_cfg, endpoints, th,
                              blk["block_id"]["hash"], node_ids,
                              p2p_port, names)
            _write_node_overrides(joiner_cfg)
            target = await _rpc_height(endpoints[0])
            procs["joiner"] = _spawn_node(joiner_cfg.base.home,
                                          child_env.get("joiner"))
            sampler.track("joiner", procs["joiner"])
            joiner_ep = "http://" + \
                joiner_cfg.rpc.laddr[len("tcp://"):]
            if fleet is not None:
                fleet.track("joiner", joiner_ep)
            try:
                if not await _rpc_ready(joiner_ep, 240.0,
                                        procs["joiner"]):
                    raise TimeoutError("joiner RPC never came up")
                await wait_height(target, 600.0, eps=[joiner_ep])
                report.statesync_joiner_height = await _rpc_height(
                    joiner_ep)
                logger.info("statesync joiner caught up",
                            height=report.statesync_joiner_height)
            except Exception as e:
                # a joiner that does not reach the target is a mismatch,
                # as is a joiner process that died; the report is kept
                _note_exits(report, procs, seen)
                logger.error("joiner stage failed", err=repr(e))
                report.mismatches.append(f"statesync_joiner: {e!r:.200}")
                joiner_ep = None

        for _ in range(3):
            try:
                report.final_height = await _rpc_height(endpoints[0])
                break
            except Exception:
                await asyncio.sleep(2.0)
        if not report.final_height:
            report.notes.append(
                "final-height probe failed; commit-sig/interval/"
                "invariant scans skipped")
        _gate_dup_ratio(report,
                        await _scrape_gossip_counters(all_eps))
        report.compact_blocks = await _scrape_compact_counters(
            all_eps)
        await _sample_commit_sigs(report, cli, report.final_height)

        # --- block interval stats over RPC --------------------------
        # best-effort with retries: 40 minutes of window data must
        # never be lost to one slow RPC on the still-busy host
        times = []
        lo = 2
        while lo <= report.final_height:
            hi = min(lo + 19, report.final_height)
            bc = None
            for _ in range(3):
                try:
                    bc = await cli.call("blockchain",
                                        minHeight=str(lo),
                                        maxHeight=str(hi))
                    break
                except Exception:
                    await asyncio.sleep(2.0)
            if bc is None:
                report.notes.append(
                    f"block-interval scan truncated at {lo}")
                break
            for meta in sorted(
                    bc.get("block_metas", []),
                    key=lambda m: int(m["header"]["height"])):
                ts = meta["header"]["time"]
                times.append((int(meta["header"]["height"]), ts))
            lo = hi + 1
        times.sort()

        def _parse_ns(ts: str) -> float:
            from ..types.timestamp import Timestamp
            return Timestamp.from_rfc3339(ts).unix_ns() / 1e9

        _record_intervals(report, [_parse_ns(t) for _, t in times])

        # --- invariants over RPC (sampled heights) ------------------
        # adaptive stride: the scan was sized for ~140-block runs;
        # the pipelined engine commits several blocks per second, so
        # a fixed stride of 5 over a 1000-block run would cost
        # thousands of RPC round trips on the already-busy host
        check_eps = [rpc_ep[n] for n in names] + \
            ([joiner_ep] if joiner_ep else [])
        stride = max(5, report.final_height // 30)
        for h in range(1, report.final_height + 1, stride):
            want = None
            for ep in check_eps:
                c2 = HTTPClient(ep, timeout=15.0)
                try:
                    b = await c2.call("block", height=str(h))
                except Exception:
                    continue
                pair = (b["block_id"]["hash"],
                        b["block"]["header"]["app_hash"])
                if want is None:
                    want = pair
                elif pair != want:
                    report.mismatches.append(
                        f"{ep}@{h}: hash/app_hash mismatch")
    finally:
        if profile_task is not None and not profile_task.done():
            # a mid-window failure must not abandon the urlopen thread
            profile_task.cancel()
            try:
                await profile_task
            except (asyncio.CancelledError, Exception):
                pass
        if fleet is not None:
            # final fleet-wide scrape while the nodes are still up —
            # this is the give-up/violation evidence path too
            try:
                report.fleet_path = await fleet.stop_and_write()
                _gate_fleet(report, report.fleet_path)
            except Exception as e:
                logger.error("fleet collection failed", err=repr(e))
                report.notes.append(f"fleet-collect: {e!r:.120}")
        if sampler is not None:
            sampler.stop()
        _note_exits(report, procs, seen)
        await _stop_children(report, procs, seen)
        for r in relays:
            r.close()
        for r in relays:
            await r.wait_closed()
    return report


async def _stop_children(report: QAReport, procs: dict,
                         seen: set) -> None:
    """SIGTERM every child still running and wait for it (SIGKILL past
    15 s); a child that exits with a code other than 0 on SIGTERM is a
    mismatch.  Each child's B1 / B2 launches come from its "Node
    stopped" line."""
    live = {n: p for n, p in procs.items() if p.poll() is None}
    for proc in live.values():
        try:
            proc.terminate()
        except OSError:
            pass
    for name, proc in live.items():
        try:
            await asyncio.to_thread(proc.wait, timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            await asyncio.to_thread(proc.wait)
            report.mismatches.append(
                f"{name}: node process did not stop in 15 s on SIGTERM")
            seen.add(id(proc))
            continue
        if id(proc) not in seen and proc.returncode != 0:
            seen.add(id(proc))
            report.mismatches.append(
                f"{name}: node process exited with rc {proc.returncode} "
                f"on SIGTERM: {_last_line(proc.log_path)}")
    for name, proc in procs.items():
        counts = _stop_launches(proc.log_path)
        if counts is not None:
            report.node_launches[name] = counts


# --------------------------------------------------------------------------
# lightserve scale stage: ~1000 simulated
# light clients hammer a 4-validator net's proof-serving RPC surface
# (light_block / multiproof / commit) at immutable heights while a
# background tx load keeps consensus busy.  Deliverables: the cache
# hit rate on immutable heights (> 90% expected — the whole point of
# the height-keyed tier), light-client request latency quantiles, and
# the consensus latency SLO — block intervals during the hammer vs
# before it.

@dataclass
class LightserveReport:
    nodes: int = 0
    clients: int = 0
    requests_total: int = 0
    request_errors: int = 0
    proofs_verified: int = 0
    proof_verify_errors: int = 0
    req_p50_ms: float = 0.0
    req_p90_ms: float = 0.0
    req_max_ms: float = 0.0
    hammer_duration_s: float = 0.0
    requests_per_s: float = 0.0
    cache_hits: int = 0
    cache_misses: int = 0
    cache_evictions: int = 0
    cache_hit_rate: float = 0.0
    cache_entries: int = 0
    cache_bytes: int = 0
    block_interval_before_s: float = 0.0
    block_interval_during_s: float = 0.0
    slo_ratio: float = 0.0
    slo_ok: bool = False
    heights_served: int = 0
    final_height: int = 0
    degraded: list[str] = field(default_factory=list)
    notes: list[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        import dataclasses
        return dataclasses.asdict(self)


async def run_lightserve(outdir: str, n_clients: int = 1000,
                         requests_per_client: int = 6,
                         max_in_flight: int = 64,
                         device=None) -> LightserveReport:
    """In-process 4-validator net + n_clients simulated light
    clients.  Each client loops over random immutable heights calling
    light_block/multiproof/commit; every ~8th multiproof response is
    verified against the light block's header data_hash, closing the
    proof loop client-side.  max_in_flight bounds concurrently open
    requests (1000 truly simultaneous sockets on one host would
    measure the OS, not the cache).  A write load of 5 tx/s runs from
    the hammer's start to its end.  Every node verifies on ``device``
    (None: the card); a node's failure raises out of the run."""
    import base64 as _b64
    import hashlib as _hashlib
    import random as _random

    from ..abci.kvstore import KVStoreApplication
    from ..crypto.merkle import Multiproof
    from ..db import new_db
    from ..node.node import Node
    from ..rpc.client import HTTPClient
    from . import loadtime

    report = LightserveReport()
    qa_stub = QAReport()
    names, zones, cfgs, _joiner_cfg, node_ids, p2p_port, relay_specs = \
        _setup_net(outdir, n_validators=4, n_full=0, ghosts=0,
                   report=qa_stub, single_zone=True)
    report.nodes = len(names)
    report.clients = n_clients

    nodes: dict[str, "Node"] = {}
    try:
        for name in names:
            app = KVStoreApplication(
                db=new_db("app", "memdb",
                          cfgs[name].base.path("data")),
                snapshot_interval=0)
            nodes[name] = Node(cfgs[name], app=app, device=device)
            await nodes[name].start()
        endpoints = [f"http://{nodes[n]._rpc_server.listen_addr}"
                     for n in names]
        ref = nodes[names[0]]

        async def wait_height(h: int, budget: float) -> None:
            deadline = time.monotonic() + budget
            while time.monotonic() < deadline:
                for n in nodes.values():
                    n.raise_if_failed()
                if ref.height >= h:
                    return
                await asyncio.sleep(0.1)
            raise TimeoutError(f"net stuck below {h}")

        # --- warm the chain: commit enough history (with txs) that
        # the hammer has a spread of immutable heights to replay
        await wait_height(2, 120.0)
        await loadtime.generate(endpoints, rate=10, connections=1,
                                duration_s=8.0, size=128,
                                method="async", max_in_flight=8)
        await wait_height(20, 120.0)
        h_start = ref.height

        # --- background tx load for the whole hammer window so the
        # SLO measures consensus UNDER the read traffic; cancelled
        # when the hammer ends, so its 35 s only bound a slow hammer
        bg_load = asyncio.get_running_loop().create_task(
            loadtime.generate(endpoints, rate=5, connections=1,
                              duration_s=35.0, size=128,
                              method="async", max_in_flight=4))

        # --- the hammer -------------------------------------------
        latencies: list[float] = []
        errors = 0                  # failed RPC requests
        verified = 0                # client-side proof checks passed
        verify_errors = 0           # ...and failed (NOT request errors)
        gate = asyncio.Semaphore(max_in_flight)

        async def gated_call(cli, method, **params):
            """One accounted request: gated, timed on its own attempt
            (a retry restarts the clock, so a failed first attempt
            never pollutes the latency sample)."""
            async with gate:
                t0 = time.monotonic()
                res = await cli.call(method, **params)
                latencies.append(time.monotonic() - t0)
                return res

        async def light_client(cid: int) -> None:
            nonlocal errors, verified, verify_errors
            rng = _random.Random(cid)
            cli = HTTPClient(endpoints[cid % len(endpoints)],
                             timeout=30.0)
            # clients replay the recent immutable window, zipf-ish:
            # real light clients cluster on the same sync targets
            for r in range(requests_per_client):
                h = 2 + int(rng.betavariate(2, 1) * (h_start - 4))
                # verifying clients ask for tx 0 so the proof check
                # below exercises real leaves; empty blocks answer
                # out-of-range and the client falls back to the
                # (still root-binding) empty key set
                idx = "0" if cid % 8 == 0 else ""
                method, params = [
                    ("light_block", {"height": str(h)}),
                    ("multiproof", {"height": str(h),
                                    "indices": idx}),
                    ("commit", {"height": str(h)}),
                ][r % 3]
                try:
                    try:
                        res = await gated_call(cli, method, **params)
                    except Exception as e:
                        if method == "multiproof" and idx and \
                                "out of range" in str(e):
                            params["indices"] = ""
                            res = await gated_call(cli, method,
                                                   **params)
                        else:
                            raise
                except Exception as e:
                    errors += 1
                    logger.debug("light client request failed",
                                 method=method, height=h,
                                 err=repr(e))
                    continue
                if method == "multiproof" and cid % 8 == 0:
                    # close the loop: fetch the header and check the
                    # (possibly empty-keyset) proof binds data_hash
                    try:
                        lb = await gated_call(cli, "light_block",
                                              height=str(h))
                    except Exception as e:
                        errors += 1
                        logger.debug("light client request failed",
                                     method="light_block", height=h,
                                     err=repr(e))
                        continue
                    try:
                        dh = bytes.fromhex(
                            lb["light_block"]["signed_header"]
                            ["header"]["data_hash"])
                        # the tx tree's items are per-tx digests:
                        # verify() applies the leaf-prefix hash
                        mp = Multiproof.from_dict(res["multiproof"])
                        mp.verify(dh, [
                            _hashlib.sha256(_b64.b64decode(t))
                            .digest() for t in res["txs"]])
                        verified += 1
                    except Exception as e:
                        verify_errors += 1
                        report.notes.append(
                            f"proof-verify@{h}: {e!r:.80}"[:120])

        t_hammer0 = time.monotonic()
        await asyncio.gather(*(light_client(i)
                               for i in range(n_clients)))
        report.hammer_duration_s = time.monotonic() - t_hammer0
        h_end = ref.height          # the window consensus shared
        bg_load.cancel()            # with the read hammer
        try:
            await bg_load
        except asyncio.CancelledError:
            pass
        except Exception as e:
            report.notes.append(f"bg-load: {e!r:.100}")
        for n in nodes.values():
            n.raise_if_failed()

        # --- results ----------------------------------------------
        report.requests_total = len(latencies) + errors
        report.request_errors = errors
        report.proofs_verified = verified
        report.proof_verify_errors = verify_errors
        if latencies:
            latencies.sort()
            report.req_p50_ms = round(
                latencies[len(latencies) // 2] * 1e3, 3)
            report.req_p90_ms = round(
                latencies[int(len(latencies) * 0.9)] * 1e3, 3)
            report.req_max_ms = round(latencies[-1] * 1e3, 3)
        if report.hammer_duration_s > 0:
            report.requests_per_s = round(
                len(latencies) / report.hammer_duration_s, 1)
        for n in nodes.values():
            st = n.lightserve_cache.stats()
            report.cache_hits += st["hits"]
            report.cache_misses += st["misses"]
            report.cache_evictions += st["evictions"]
            report.cache_entries += st["entries"]
            report.cache_bytes += st["bytes"]
        probes = report.cache_hits + report.cache_misses
        report.cache_hit_rate = round(
            report.cache_hits / probes, 4) if probes else 0.0
        report.heights_served = h_start - 2
        report.final_height = h_end

        def _intervals(lo: int, hi: int) -> list[float]:
            ts = []
            for h in range(lo, hi + 1):
                meta = ref.block_store.load_block_meta(h)
                if meta is not None:
                    ts.append(meta.header.time.unix_ns() / 1e9)
            return [b - a for a, b in zip(ts, ts[1:])]

        before = _intervals(2, h_start)
        during = _intervals(h_start, h_end)
        if before:
            report.block_interval_before_s = round(
                statistics.mean(before), 3)
        if during:
            report.block_interval_during_s = round(
                statistics.mean(during), 3)
        # SLO: consensus under the read hammer stays within 2x of its
        # pre-hammer block interval (+100 ms scheduling slack on a
        # shared host) and never stops advancing
        if not during:
            report.slo_ok = False
            report.degraded.append("consensus_stalled_under_hammer")
        else:
            limit = report.block_interval_before_s * 2.0 + 0.1
            report.slo_ratio = round(
                report.block_interval_during_s /
                max(report.block_interval_before_s, 1e-9), 2)
            report.slo_ok = report.block_interval_during_s <= limit
            if not report.slo_ok:
                report.degraded.append("consensus_latency_slo")
        if report.cache_hit_rate < 0.9:
            report.degraded.append("cache_hit_rate_below_90pct")
        if errors > report.requests_total * 0.01:
            report.degraded.append("request_error_rate")
        if verify_errors:
            # a served proof that fails client-side verification is
            # a correctness event, not load noise — any count degrades
            report.degraded.append("proof_verification_failures")
        logger.info("lightserve hammer done",
                    clients=n_clients,
                    requests=report.requests_total,
                    errors=errors,
                    hit_rate=report.cache_hit_rate,
                    p90_ms=report.req_p90_ms,
                    interval_before=report.block_interval_before_s,
                    interval_during=report.block_interval_during_s,
                    slo_ok=report.slo_ok)
    finally:
        stop_errors = []
        for n in nodes.values():
            try:
                await n.stop()
            except Exception as e:  # noqa: BLE001 — raised below
                stop_errors.append(e)
    if stop_errors:
        raise stop_errors[0]
    return report


async def run_sig_scale(outdir: str, window_s: float = 30.0,
                        device=None) -> QAReport:
    """Signature-scale stage: 32 LIVE validators
    (power 100 each) + 70 power-1 ghosts, so every commit carries
    >= 32 real signatures through the batch verification path in a
    running network.  Lighter stages (no perturbation / joiner /
    profile — 33 processes on one host saturate its cores by
    themselves), and a 2 s commit timeout: at 200 ms the proposer
    commits before the slowest third of 32 time-shared validators
    deliver their precommits, capping the measured width at ~22-24 of
    32.  The deliverable is the per-block verified-signature width +
    that the net sustains load at that width."""
    return await run_qa_procs(
        outdir, n_validators=32, n_full=1, ghosts=70,
        rates=(5, 10), window_s=window_s,
        perturb=False, joiner=False, profile=False,
        commit_timeout_ns=2_000_000_000,
        single_zone=True, peer_degree=6, device=device)


def _child_env_arg(entries: list) -> dict:
    """``NAME:KEY=VALUE`` entries -> {name: {key: value}}."""
    out: dict = {}
    for entry in entries:
        name, sep, kv = entry.partition(":")
        key, eq, value = kv.partition("=")
        if not (sep and eq and name and key):
            raise SystemExit(f"--child-env wants NAME:KEY=VALUE, got "
                             f"{entry!r}")
        out.setdefault(name, {})[key] = value
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="small shape for CI (6 nodes, 2 windows)")
    ap.add_argument("--procs", action="store_true",
                    help="one OS process per node + /proc resource "
                         "series (the reference QA method's shape)")
    ap.add_argument("--sigscale", action="store_true",
                    help="32 live validators: every commit carries "
                         ">=32 real signatures through the batch path")
    ap.add_argument("--lightserve", action="store_true",
                    help="~1000 simulated light clients hammer a "
                         "4-node net's proof-serving RPC (cache hit "
                         "rate + consensus latency SLO)")
    ap.add_argument("--clients", type=int, default=1000,
                    help="lightserve stage: simulated light clients")
    ap.add_argument("--no-sigscale", action="store_true",
                    help="full run without the sig-scale stage")
    ap.add_argument("--window", type=float, default=0.0)
    ap.add_argument("--rates", default="",
                    help="comma-separated load ladder (tx/s) instead of "
                         "the mode's own")
    ap.add_argument("--no-joiner", action="store_true",
                    help="process mode: no state-sync late joiner")
    ap.add_argument("--no-profile", action="store_true",
                    help="process mode: no profile window")
    ap.add_argument("--child-env", action="append", default=[],
                    metavar="NAME:KEY=VALUE",
                    help="process mode: add KEY=VALUE to node NAME's "
                         "environment (repeatable)")
    ap.add_argument("--device", default="",
                    help="torch device the in-process nodes verify on, "
                         "and the process fleet's libraries are built "
                         "for (default: the card)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    device = args.device or None
    rates = tuple(int(r) for r in args.rates.split(",") if r.strip())
    # the port's own records: never a JAX tool's QA_r0N.json
    out_path = args.out or (
        "QA_torch_quick.json" if args.quick else
        "QA_torch_sigscale.json" if args.sigscale else
        "QA_torch_lightserve.json" if args.lightserve else
        "QA_torch.json")
    if args.lightserve:
        with tempfile.TemporaryDirectory() as d:
            ls_rep = asyncio.run(run_lightserve(
                d, n_clients=args.clients, device=device))
        out = {"scenario": "lightserve_scale",
               **ls_rep.to_dict()}
        with open(out_path, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
        print(json.dumps({
            "clients": ls_rep.clients,
            "requests": ls_rep.requests_total,
            "errors": ls_rep.request_errors,
            "cache_hit_rate": ls_rep.cache_hit_rate,
            "req_p90_ms": ls_rep.req_p90_ms,
            "interval_before_s": ls_rep.block_interval_before_s,
            "interval_during_s": ls_rep.block_interval_during_s,
            "slo_ok": ls_rep.slo_ok,
            "degraded": ls_rep.degraded,
        }))
        return 0 if not ls_rep.degraded else 1
    procs_kw = dict(joiner=not args.no_joiner,
                    profile=not args.no_profile, device=device,
                    child_env=_child_env_arg(args.child_env))
    sig_rep: Optional[QAReport] = None
    with tempfile.TemporaryDirectory() as d:
        if args.sigscale:
            rep = asyncio.run(run_sig_scale(
                d, window_s=args.window or 30.0, device=device))
        elif args.quick and args.procs:
            rep = asyncio.run(run_qa_procs(
                d, n_validators=4, n_full=1, ghosts=20,
                rates=rates or (25, 50), window_s=args.window or 10.0,
                **procs_kw))
        elif args.quick:
            rep = asyncio.run(run_qa(
                d, n_validators=4, n_full=1, ghosts=20,
                rates=rates or (25, 50), window_s=args.window or 8.0,
                device=device))
        elif args.procs:
            rep = asyncio.run(run_qa_procs(
                d, window_s=args.window or 90.0,
                **({"rates": rates} if rates else {}), **procs_kw))
        else:
            rep = asyncio.run(run_qa(
                d, window_s=args.window or 15.0, device=device,
                **({"rates": rates} if rates else {})))
    if args.procs and not args.quick and not args.no_sigscale \
            and not args.sigscale:
        # the full reference-method run carries the sig-scale stage
        # as a second net (the validator set is fixed at genesis)
        with tempfile.TemporaryDirectory() as d:
            try:
                sig_rep = asyncio.run(run_sig_scale(d, device=device))
            except Exception as e:
                # a stage that fails fails the run
                logger.error("sig-scale stage failed", err=repr(e))
                rep.mismatches.append(f"sig-scale stage: {e!r:.200}")
    out = rep.to_dict()
    if sig_rep is not None:
        out["sig_scale"] = sig_rep.to_dict()
    with open(out_path, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(json.dumps({
        "nodes": rep.nodes, "validators": rep.validators_total,
        "saturation_rate": rep.saturation_rate,
        "offered_ratio": rep.offered_check.get("offered_ratio"),
        "commit_sigs_avg": rep.commit_sigs_avg,
        "dup_ratio_overall": rep.dup_ratio_overall,
        "windows": [[w.rate, round(w.tx_per_s, 1),
                     round(w.latency_p50_s, 3)]
                    for w in rep.windows],
        "block_interval_avg_s": round(rep.block_interval_avg_s, 3),
        "sig_scale_commit_sigs_avg":
            sig_rep.commit_sigs_avg if sig_rep else None,
        "mismatches": len(rep.mismatches),
        "degraded": rep.degraded,
    }))
    return 0 if not rep.mismatches and not (
        sig_rep is not None and sig_rep.mismatches) else 1


if __name__ == "__main__":
    raise SystemExit(main())
