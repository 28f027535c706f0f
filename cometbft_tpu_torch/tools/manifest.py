"""Testnet manifests, random generation, setup, and an in-process
runner with perturbations and invariant checks.

Reference: test/e2e/pkg/manifest.go (the TOML manifest schema),
test/e2e/generator (random sampling of the config space for nightly
runs), test/e2e/runner (setup.go writes per-node homes; start.go,
perturb.go, wait.go drive the net; tests assert invariants).  The
docker-compose layer is replaced by in-process `Node` objects on real
localhost sockets — same protocols end to end, no containers.  A copy of
cometbft_tpu/tools/manifest.py (the same schema, seeded generator, files
and invariants) over the port's Node: ``run_manifest(..., device=None)``
runs every node on the card unless the caller names another device.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import random
import socket
from dataclasses import dataclass, field
from typing import Optional

# -- manifest schema ---------------------------------------------------------

PERTURBATIONS = ("kill", "restart", "pause")
MODES = ("validator", "full")


@dataclass
class ManifestNode:
    """Reference: manifest.go ManifestNode."""
    mode: str = "validator"            # validator | full
    # height at which the node joins (0 = from genesis); late joiners
    # exercise blocksync (reference: StartAt)
    start_at: int = 0
    key_type: str = "ed25519"
    db_backend: str = "memdb"
    # perturbations applied mid-run (reference: perturb.go)
    perturb: list[str] = field(default_factory=list)
    # reference: RetainBlocks drives app retain height
    retain_blocks: int = 0
    send_no_load: bool = False
    # emulated-latency zone (reference: latency_emulation.go — tc/
    # netem between zones; here a TCP relay adds the delay per link)
    zone: str = ""


@dataclass
class Manifest:
    """Reference: manifest.go Manifest (the supported subset)."""
    chain_id: str = "e2e-net"
    initial_height: int = 1
    key_type: str = "ed25519"
    abci_protocol: str = "builtin"     # builtin | builtin_unsync
    disable_pex: bool = False
    # target load during the run
    load_tx_rate: int = 40
    load_tx_size: int = 200
    nodes: dict[str, ManifestNode] = field(default_factory=dict)
    # node name -> voting power (defaults: validators at 100)
    validators: dict[str, int] = field(default_factory=dict)
    # one-way link latency between zones, "zoneA:zoneB" -> ms
    # (reference: manifest zones + latency_emulation.go)
    latency_ms: dict[str, int] = field(default_factory=dict)
    # artificial ABCI call delays in ms (reference: manifest
    # prepare_proposal_delay etc.)
    prepare_proposal_delay_ms: int = 0
    process_proposal_delay_ms: int = 0
    check_tx_delay_ms: int = 0
    finalize_block_delay_ms: int = 0
    # duplicate-vote evidences to inject mid-run over RPC
    # (reference: manifest.go Evidence + runner/evidence.go)
    evidence: int = 0

    def link_delay_s(self, za: str, zb: str) -> float:
        if not za or not zb or za == zb:
            return 0.0
        ms = self.latency_ms.get(f"{za}:{zb}",
                                 self.latency_ms.get(f"{zb}:{za}", 0))
        return ms / 1000.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Manifest":
        nodes = {name: ManifestNode(**nd)
                 for name, nd in (d.get("nodes") or {}).items()}
        kw = {k: v for k, v in d.items() if k != "nodes"}
        m = cls(**kw)
        m.nodes = nodes
        return m

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "Manifest":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def generate(seed: int = 0, max_nodes: int = 4) -> Manifest:
    """Randomly sample the testnet config space (reference:
    test/e2e/generator/generate.go)."""
    # scramble the seed: consecutive small seeds otherwise share
    # their first Mersenne draws and sample near-identical configs
    rng = random.Random((seed * 2654435761 + 97) % 2 ** 32)
    n_vals = rng.randint(2, max(2, max_nodes - 1))
    n_full = rng.randint(0, max(0, max_nodes - n_vals))
    m = Manifest(
        chain_id=f"gen-{seed}",
        key_type=rng.choice(["ed25519", "secp256k1"]),
        abci_protocol=rng.choice(["builtin", "builtin_unsync"]),
        disable_pex=rng.random() < 0.25,
        load_tx_rate=rng.choice([20, 40, 80]),
        load_tx_size=rng.choice([128, 256, 1024]),
    )
    for i in range(n_vals):
        node = ManifestNode(mode="validator",
                            key_type=m.key_type,
                            db_backend=rng.choice(["memdb", "sqlite"]))
        # perturb at most one validator so the net keeps quorum
        if i == n_vals - 1 and n_vals > 2 and rng.random() < 0.5:
            node.perturb = [rng.choice(PERTURBATIONS)]
        m.nodes[f"validator{i:02d}"] = node
        m.validators[f"validator{i:02d}"] = rng.choice([50, 100])
    for i in range(n_full):
        m.nodes[f"full{i:02d}"] = ManifestNode(
            mode="full", key_type=m.key_type,
            start_at=rng.choice([0, 3]))
    # sometimes spread the net over two latency zones
    if rng.random() < 0.3:
        zones = ["zone-a", "zone-b"]
        for i, nm in enumerate(m.nodes.values()):
            nm.zone = zones[i % 2]
        m.latency_ms["zone-a:zone-b"] = rng.choice([50, 100, 200])
    # sometimes mimic app computation time
    if rng.random() < 0.3:
        m.finalize_block_delay_ms = rng.choice([20, 50])
        m.check_tx_delay_ms = rng.choice([0, 5])
    # sometimes inject byzantine evidence mid-run
    if rng.random() < 0.25:
        m.evidence = rng.choice([1, 2, 4])
    return m


# -- setup (reference: runner/setup.go) --------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@dataclass
class RelaySpec:
    """One latency-emulation relay: listens on `port`, forwards to
    the target with a one-way delay (reference: tc/netem in
    latency_emulation.go, externalized as a TCP relay)."""
    port: int
    target_host: str
    target_port: int
    delay_s: float


def setup(manifest: Manifest, outdir: str
          ) -> tuple[dict[str, "object"], list[RelaySpec]]:
    """Write per-node homes (keys, genesis, config overrides with
    pre-allocated ports and persistent-peer wiring).  Returns
    (node name -> Config, latency relays to run).  With zone
    latencies configured, a node's persistent-peers entries point at
    per-link relays; PEX is disabled in that case so gossiped real
    addresses don't bypass the emulated links."""
    from ..config import Config
    from ..p2p.key import NodeKey
    from ..privval import FilePV
    from ..types.genesis import GenesisDoc, GenesisValidator
    from ..types.timestamp import Timestamp

    use_latency = bool(manifest.latency_ms)
    cfgs: dict[str, Config] = {}
    pvs: dict[str, object] = {}
    node_ids: dict[str, str] = {}
    p2p_ports: dict[str, int] = {}
    for name, nm in manifest.nodes.items():
        home = os.path.join(outdir, name)
        cfg = Config()
        cfg.base.home = home
        cfg.base.moniker = name
        cfg.base.db_backend = nm.db_backend
        p2p_port, rpc_port = _free_port(), _free_port()
        cfg.p2p.laddr = f"tcp://127.0.0.1:{p2p_port}"
        cfg.rpc.laddr = f"tcp://127.0.0.1:{rpc_port}"
        cfg.p2p.pex = not manifest.disable_pex and not use_latency
        cfg.p2p.allow_duplicate_ip = True
        cfg.consensus.timeout_commit_ns = 50_000_000
        cfg.blocksync.enable = True
        os.makedirs(os.path.join(home, "config"), exist_ok=True)
        os.makedirs(os.path.join(home, "data"), exist_ok=True)
        pv = FilePV.load_or_generate(
            cfg.base.path(cfg.base.priv_validator_key_file),
            cfg.base.path(cfg.base.priv_validator_state_file),
            key_type=nm.key_type)
        nk = NodeKey.load_or_gen(cfg.base.path(cfg.base.node_key_file))
        node_ids[name] = nk.id
        p2p_ports[name] = p2p_port
        cfgs[name] = cfg
        pvs[name] = pv
    doc = GenesisDoc(
        chain_id=manifest.chain_id,
        genesis_time=Timestamp.now(),
        initial_height=manifest.initial_height,
        validators=[GenesisValidator(
            address=b"", pub_key=pvs[name].get_pub_key(),
            power=manifest.validators.get(name, 100))
            for name, nm in manifest.nodes.items()
            if nm.mode == "validator"],
    )
    # genesis must permit the net's key type or the first validator
    # UPDATE (e.g. equivocation punishment) halts consensus
    # (reference: runner/setup.go:169 sets PubKeyTypes = [KeyType])
    doc.consensus_params.validator.pub_key_types = \
        [manifest.key_type]
    relays: list[RelaySpec] = []
    for name, cfg in cfgs.items():
        doc.save_as(cfg.base.path(cfg.base.genesis_file))
        peers = []
        for other, other_port in p2p_ports.items():
            # dial only "later" nodes: one direction per pair, so
            # slow links can't race both ends into mutually-rejected
            # duplicate connections (the reverse direction is covered
            # by the other node's inbound accept)
            if other <= name:
                continue
            delay = manifest.link_delay_s(
                manifest.nodes[name].zone, manifest.nodes[other].zone)
            port = other_port
            if delay > 0:
                port = _free_port()
                relays.append(RelaySpec(
                    port=port, target_host="127.0.0.1",
                    target_port=other_port, delay_s=delay))
            peers.append(f"{node_ids[other]}@127.0.0.1:{port}")
        cfg.p2p.persistent_peers = ",".join(peers)
    return cfgs, relays


class Relay:
    """A running latency relay: the listening server plus its live
    connection handlers (so close() actually tears everything down)."""

    def __init__(self):
        self.server = None
        self.tasks: set = set()

    def close(self) -> None:
        if self.server is not None:
            self.server.close()
        for t in list(self.tasks):
            t.cancel()

    async def wait_closed(self) -> None:
        if self.server is not None:
            await self.server.wait_closed()
        # handler/pump tasks were cancelled by close(): wait them out
        # so loop teardown never sees pending relay tasks
        if self.tasks:
            await asyncio.gather(*list(self.tasks),
                                 return_exceptions=True)


async def start_relay(spec: RelaySpec) -> Relay:
    """Run one latency relay.  Bytes are delivered delay_s after they
    arrive WITHOUT throttling bandwidth (a per-direction delivery
    queue, like netem's constant delay)."""
    relay = Relay()

    async def handle(reader, writer):
        try:
            tr, tw = await asyncio.open_connection(
                spec.target_host, spec.target_port)
        except OSError:
            writer.close()
            return

        async def pump(src, dst):
            loop = asyncio.get_running_loop()
            queue: asyncio.Queue = asyncio.Queue()

            async def deliver():
                while True:
                    at, data = await queue.get()
                    if data is None:
                        break
                    now = loop.time()
                    if at > now:
                        await asyncio.sleep(at - now)
                    try:
                        dst.write(data)
                        await dst.drain()
                    except (ConnectionError, OSError):
                        break

            task = loop.create_task(deliver())
            try:
                while True:
                    data = await src.read(65536)
                    if not data:
                        break
                    queue.put_nowait(
                        (loop.time() + spec.delay_s, data))
            except (ConnectionError, OSError):
                pass
            finally:
                queue.put_nowait((0, None))
                await task
                try:
                    dst.close()
                except OSError:
                    pass

        await asyncio.gather(pump(reader, tw), pump(tr, writer))

    async def tracked_handle(reader, writer):
        task = asyncio.current_task()
        relay.tasks.add(task)
        try:
            await handle(reader, writer)
        except asyncio.CancelledError:
            for w in (writer,):
                try:
                    w.close()
                except OSError:
                    pass
            raise
        finally:
            relay.tasks.discard(task)

    relay.server = await asyncio.start_server(tracked_handle,
                                              "127.0.0.1", spec.port)
    return relay


async def inject_evidence(manifest: Manifest, cfgs: dict,
                          endpoint: str, count: int) -> list[str]:
    """Forge `count` duplicate-vote evidences signed by a real
    validator's key and submit them over RPC (reference:
    runner/evidence.go — generates conflicting precommits against a
    recent height and broadcasts them).  Returns evidence hashes."""
    import base64

    from ..privval import FilePV
    from ..rpc.client import HTTPClient
    from ..types import canonical
    from ..types.block_id import BlockID
    from ..types.evidence import DuplicateVoteEvidence
    from ..types.part_set import PartSetHeader
    from ..types.vote import Vote
    from ..wire import encode as wencode, pb as wpb

    # byzantine validators: rotate across the manifest's validators
    # (reference: evidence.go targets different validators per
    # evidence, and a block carrying several offences by ONE
    # validator exercises a different app path than several offenders)
    val_names = [name for name, nm in manifest.nodes.items()
                 if nm.mode == "validator"]
    pvs = {}
    for name in val_names:
        cfg = cfgs[name]
        pvs[name] = FilePV.load_or_generate(
            cfg.base.path(cfg.base.priv_validator_key_file),
            cfg.base.path(cfg.base.priv_validator_state_file))

    cli = HTTPClient(endpoint, timeout=30.0)
    st = await cli.status()
    tip = int(st["sync_info"]["latest_block_height"])
    total_power = sum(manifest.validators.get(name, 100)
                      for name in val_names)
    vals = await cli.validators(max(1, tip - 2))
    index_by_addr = {v.address: i
                     for i, v in enumerate(vals.validators)}
    per_val = {}
    for name in val_names:
        addr = pvs[name].get_pub_key().address()
        if addr not in index_by_addr:
            raise ValueError(
                f"validator {name} (addr {addr.hex()[:12]}) not in "
                f"the set at height {max(1, tip - 2)}")
        per_val[name] = (addr, index_by_addr[addr],
                         manifest.validators.get(name, 100))

    hashes = []
    for j in range(count):
        val_name = val_names[j % len(val_names)]
        pv = pvs[val_name]
        addr, val_index, val_power = per_val[val_name]
        # heights may clamp together on a young chain, so the forged
        # block ids vary per evidence — identical evidence would be
        # deduped by the pool and never reach the requested count
        h = max(1, tip - 2 - j)
        sh, _ = await cli.commit(h)          # exact header time
        votes = []
        # a < b block-id order via the leading byte; the j suffix
        # keeps evidences distinct at any count without byte overflow
        for lead in (b"\x01", b"\x02"):
            bid = lead + j.to_bytes(31, "big")
            v = Vote(type=canonical.PRECOMMIT_TYPE, height=h, round=0,
                     block_id=BlockID(
                         hash=bid,
                         part_set_header=PartSetHeader(1, bid)),
                     timestamp=sh.header.time,
                     validator_address=addr,
                     validator_index=val_index)
            # sign directly with the raw key: FilePV would (rightly)
            # refuse the second, conflicting signature
            v.signature = pv.priv_key.sign(
                v.sign_bytes(manifest.chain_id))
            votes.append(v)
        ev = DuplicateVoteEvidence(
            vote_a=votes[0], vote_b=votes[1],
            total_voting_power=total_power,
            validator_power=val_power,
            timestamp=sh.header.time)
        raw = wencode(wpb.EVIDENCE, ev.to_proto_wrapped())
        res = await cli.call(
            "broadcast_evidence",
            evidence=base64.b64encode(raw).decode())
        hashes.append(res["hash"])
    return hashes


# -- runner (reference: runner/{start,perturb,wait}.go) ----------------------

@dataclass
class RunReport:
    target_height: int = 0
    heights: dict[str, int] = field(default_factory=dict)
    load_sent: int = 0
    load_accepted: int = 0
    perturbed: list[str] = field(default_factory=list)
    mismatches: list[str] = field(default_factory=list)
    evidence_injected: list[str] = field(default_factory=list)
    evidence_committed: int = 0
    # seconds from first boot until every node reached target_height
    # (excludes load-drain/teardown; the benchmark-comparable number)
    reached_target_s: float = 0.0


async def run_manifest(manifest: Manifest, outdir: str,
                       target_height: int = 8,
                       timeout_s: float = 90.0,
                       device=None) -> RunReport:
    """Boot every node, inject load, apply perturbations once the net
    is past the halfway height, wait for target_height everywhere,
    then check cross-node block-hash/app-hash invariants
    (reference: runner/main.go stage order; tests/block_test.go)."""
    from ..node.node import Node
    from ..rpc.client import HTTPClient
    from . import loadtime

    cfgs, relay_specs = setup(manifest, outdir)
    nodes: dict[str, Node] = {}
    report = RunReport(target_height=target_height)
    load_task: Optional[asyncio.Task] = None
    relay_servers: list[Relay] = []

    def _apply_delays(node: Node) -> None:
        delays = {
            "prepare_proposal":
                manifest.prepare_proposal_delay_ms / 1000.0,
            "process_proposal":
                manifest.process_proposal_delay_ms / 1000.0,
            "check_tx": manifest.check_tx_delay_ms / 1000.0,
            "finalize_block":
                manifest.finalize_block_delay_ms / 1000.0,
        }
        if any(delays.values()) and \
                hasattr(node.app, "abci_delays"):
            node.app.abci_delays = delays

    try:
        boot_t0 = asyncio.get_event_loop().time()
        for r in relay_specs:
            relay_servers.append(await start_relay(r))
        # start_at=0 nodes boot now; late joiners wait for the height
        for name, cfg in cfgs.items():
            if manifest.nodes[name].start_at == 0:
                nodes[name] = Node(cfg, device=device)
                _apply_delays(nodes[name])
                await nodes[name].start()
        if not nodes:
            raise ValueError(
                "manifest needs at least one node with start_at=0")

        first = next(iter(nodes.values()))
        endpoint = f"http://{first._rpc_server.listen_addr}"

        load_res = loadtime.LoadResult(experiment_id="")

        async def _load():
            nonlocal load_res
            load_res = await loadtime.generate(
                [endpoint], rate=manifest.load_tx_rate,
                connections=1, duration_s=timeout_s / 3,
                size=manifest.load_tx_size, method="async")

        load_task = asyncio.get_running_loop().create_task(_load())

        async def wait_height(h: int, budget: float) -> None:
            deadline = asyncio.get_running_loop().time() + budget
            while asyncio.get_running_loop().time() < deadline:
                if all(n.height >= h for n in nodes.values()):
                    return
                await asyncio.sleep(0.05)
            raise TimeoutError(
                f"heights {[n.height for n in nodes.values()]} "
                f"< {h} after {budget}s")

        await wait_height(target_height // 2, timeout_s / 3)

        # late joiners enter mid-run and must blocksync to catch up
        for name, cfg in cfgs.items():
            if name not in nodes:
                nodes[name] = Node(cfg, device=device)
                _apply_delays(nodes[name])
                await nodes[name].start()

        # perturbations (reference: perturb.go — one node at a time)
        for name, nm in manifest.nodes.items():
            for p in nm.perturb:
                report.perturbed.append(f"{name}:{p}")
                # kill/restart/pause all stop the node and boot a
                # fresh one on the same durable stores (pause maps to
                # a short stop: asyncio tasks can't be frozen the way
                # docker pause freezes a process)
                await nodes[name].stop()
                await asyncio.sleep(0.2 if p != "pause" else 1.0)
                nodes[name] = Node(cfgs[name], device=device)
                _apply_delays(nodes[name])
                await nodes[name].start()

        # evidence stage (reference: runner/evidence.go InjectEvidence)
        if manifest.evidence > 0:
            report.evidence_injected = await inject_evidence(
                manifest, cfgs, endpoint, manifest.evidence)

        await wait_height(target_height, timeout_s / 2)
        report.reached_target_s = \
            asyncio.get_event_loop().time() - boot_t0

        # wait for injected evidence to land in committed blocks
        if report.evidence_injected:
            deadline = asyncio.get_event_loop().time() + timeout_s / 4
            want = len(report.evidence_injected)
            ref_node = next(iter(nodes.values()))
            seen = 0
            scanned = manifest.initial_height - 1
            while asyncio.get_event_loop().time() < deadline:
                # incremental: only newly committed blocks each tick
                while scanned < ref_node.height:
                    scanned += 1
                    blk = ref_node.block_store.load_block(scanned)
                    if blk is not None:
                        seen += len(blk.evidence)
                report.evidence_committed = seen
                if seen >= want:
                    break
                await asyncio.sleep(0.1)
    finally:
        if load_task is not None:
            await load_task
        report.load_sent = load_res.sent
        report.load_accepted = load_res.accepted
        for name, n in nodes.items():
            report.heights[name] = n.height
            try:
                await n.stop()
            except Exception as e:  # noqa: BLE001 — a node that failed
                report.mismatches.append(f"{name} failed: {e!r}")
        for srv in relay_servers:
            srv.close()
        for srv in relay_servers:
            await srv.wait_closed()

    # invariants on the durable stores: identical block ids and app
    # hashes at every common height (reference: tests/block_test.go,
    # app_test.go)
    ref_name = next(iter(nodes))
    ref = nodes[ref_name]
    for h in range(manifest.initial_height, target_height + 1):
        want = ref.block_store.load_block_meta(h)
        if want is None:
            report.mismatches.append(f"{ref_name} missing meta @{h}")
            continue
        for name, n in nodes.items():
            got = n.block_store.load_block_meta(h)
            if got is None:
                continue            # pruned or still syncing
            if got.block_id.hash != want.block_id.hash:
                report.mismatches.append(
                    f"{name}@{h}: block hash mismatch")
            if got.header.app_hash != want.header.app_hash:
                report.mismatches.append(
                    f"{name}@{h}: app hash mismatch")
    return report
