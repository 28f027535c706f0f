"""The node operator CLI.

Reference: cmd/cometbft/ — init, start, show-node-id, show-validator,
gen-node-key, gen-validator, unsafe-reset-all, testnet, version,
rollback (cmd/cometbft/commands/) — through cometbft_tpu/cmd/__main__.py,
whose subcommands, arguments and output this copy keeps.  ``start`` and
``light`` verify on the card; ``--device cpu`` is the only way to run them
on the CPU (tests do).  ``start`` returns 1 with the error on stderr when
the node stops on a failure (a dead app, a fatal consensus error) instead
of on a signal.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import shutil
import sys


def _load_config(home: str):
    from ..confix import effective_config
    return effective_config(home)


def cmd_init(args) -> int:
    from ..node import init_files
    cfg = _load_config(args.home)
    doc = init_files(cfg, chain_id=args.chain_id)
    print(f"Initialized node in {args.home} "
          f"(chain_id={doc.chain_id})")
    return 0


def cmd_start(args) -> int:
    from ..node import Node
    # live-stack debugging for a wedged/starved node: SIGUSR1 dumps
    # every thread's Python stack to stderr without killing the
    # process (faulthandler is async-signal-safe, so this works even
    # when the event loop is livelocked and RPC cannot answer)
    import faulthandler
    import signal
    try:
        faulthandler.register(signal.SIGUSR1)
    except (AttributeError, ValueError, OSError):
        pass   # platform without SIGUSR1 / non-main thread
    cfg = _load_config(args.home)
    if args.proxy_app:
        cfg.base.proxy_app = args.proxy_app
    if args.p2p_laddr:
        cfg.p2p.laddr = args.p2p_laddr
    if args.rpc_laddr:
        cfg.rpc.laddr = args.rpc_laddr
    if args.persistent_peers:
        cfg.p2p.persistent_peers = args.persistent_peers
    if args.log_level:
        cfg.base.log_level = args.log_level

    async def main():
        node = Node(cfg, device=args.device or None)
        stop = asyncio.Event()
        try:
            import signal
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGINT, signal.SIGTERM):
                loop.add_signal_handler(sig, stop.set)
        except (NotImplementedError, ImportError):
            pass
        await node.start()
        # the node's failure ends the wait as a signal does
        failed = asyncio.ensure_future(node.wait())
        signalled = asyncio.ensure_future(stop.wait())
        await asyncio.wait({failed, signalled},
                           return_when=asyncio.FIRST_COMPLETED)
        for task in (failed, signalled):
            task.cancel()
        # the failure is raised again by stop()
        await asyncio.gather(failed, signalled, return_exceptions=True)
        await node.stop()

    try:
        asyncio.run(main())
    except Exception as e:  # noqa: BLE001 — the node's failure, reported
        print(f"node stopped: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    return 0


def cmd_show_node_id(args) -> int:
    from ..p2p.key import NodeKey
    cfg = _load_config(args.home)
    nk = NodeKey.load_or_gen(cfg.base.path(cfg.base.node_key_file))
    print(nk.id)
    return 0


def cmd_show_validator(args) -> int:
    from ..privval import FilePV
    cfg = _load_config(args.home)
    pv = FilePV.load_or_generate(
        cfg.base.path(cfg.base.priv_validator_key_file),
        cfg.base.path(cfg.base.priv_validator_state_file))
    pub = pv.get_pub_key()
    from ..types.genesis import pub_key_to_json
    print(json.dumps(pub_key_to_json(pub)))
    return 0


def cmd_gen_node_key(args) -> int:
    from ..p2p.key import NodeKey
    cfg = _load_config(args.home)
    path = cfg.base.path(cfg.base.node_key_file)
    if os.path.exists(path):
        print(f"node key already exists at {path}", file=sys.stderr)
        return 1
    nk = NodeKey.generate()
    nk.save_as(path)
    print(nk.id)
    return 0


def cmd_unsafe_reset_all(args) -> int:
    """Reference: commands/reset.go — wipe data, keep keys, reset
    priv validator state."""
    from ..privval import FilePV
    cfg = _load_config(args.home)
    data_dir = cfg.base.path(cfg.base.db_dir)
    if os.path.isdir(data_dir):
        shutil.rmtree(data_dir)
    os.makedirs(data_dir, exist_ok=True)
    key_file = cfg.base.path(cfg.base.priv_validator_key_file)
    if os.path.exists(key_file):
        pv = FilePV.load(key_file,
                         cfg.base.path(
                             cfg.base.priv_validator_state_file))
        pv.reset()
    print(f"Reset {data_dir}")
    return 0


def cmd_config_validate(args) -> int:
    """Reference: `cometbft config` (internal/confix) — validate the
    persisted config file."""
    from ..config import ConfigError, validate_basic
    cfg = _load_config(args.home)
    try:
        validate_basic(cfg)
    except ConfigError as e:
        print(f"config invalid: {e}")
        return 1
    print("config is valid")
    return 0


def cmd_config_view(args) -> int:
    """Print the effective config (defaults + overrides) as JSON
    (reference: confix view)."""
    from .. import confix
    print(json.dumps(
        confix.config_to_dict(confix.effective_config(args.home)),
        indent=2, sort_keys=True))
    return 0


def cmd_config_get(args) -> int:
    from .. import confix
    try:
        print(json.dumps(confix.get_value(args.home, args.key)))
    except KeyError:
        print(f"unknown key {args.key!r}")
        return 1
    return 0


def cmd_config_set(args) -> int:
    from .. import confix
    try:
        v = confix.set_value(args.home, args.key, args.value)
    except (KeyError, ValueError) as e:
        print(f"cannot set {args.key!r}: {e}")
        return 1
    print(f"{args.key} = {json.dumps(v)}")
    return 0


def cmd_config_diff(args) -> int:
    """Show overrides differing from defaults plus unknown entries
    (reference: confix diff)."""
    from .. import confix
    print(json.dumps(confix.diff_from_defaults(args.home), indent=2,
                     sort_keys=True))
    return 0


def cmd_config_migrate(args) -> int:
    """Normalize the persisted config against the current schema
    (reference: confix migrate)."""
    from .. import confix
    log = confix.migrate(args.home, dry_run=args.dry_run)
    for line in log:
        print(("would have " if args.dry_run else "") + line)
    if not log:
        print("config already up to date")
    return 0


def cmd_priv_val_server(args) -> int:
    """Standalone remote signer daemon: dial the node's privval
    listener and serve signing requests from a FilePV (reference:
    cmd/priv_val_server + privval/signer_server.go)."""
    import asyncio

    from ..privval import FilePV
    from ..privval.signer import SignerServer

    pv = FilePV.load_or_generate(args.priv_key_file, args.state_file)
    print(f"remote signer: validator "
          f"{pv.get_pub_key().address().hex().upper()[:12]} "
          f"-> {args.addr} (chain {args.chain_id})")

    async def main():
        srv = SignerServer(args.addr, args.chain_id, pv,
                           retries=10 ** 9)
        await srv.start()
        try:
            await asyncio.Event().wait()
        finally:
            await srv.stop()
    try:
        asyncio.run(main())
    except KeyboardInterrupt:
        pass
    return 0


def cmd_generate_manifests(args) -> int:
    """Reference: test/e2e/generator — write N random manifests."""
    from ..tools.manifest import generate

    os.makedirs(args.o, exist_ok=True)
    for i in range(args.n):
        m = generate(seed=args.seed + i)
        path = os.path.join(args.o, f"gen-{args.seed + i:03d}.json")
        m.save(path)
        print(path)
    return 0


def cmd_load(args) -> int:
    """Timestamped-tx load generation (reference: test/loadtime
    cmd/load)."""
    import asyncio

    from ..tools import loadtime

    async def run():
        res = await loadtime.generate(
            args.endpoints.split(","), rate=args.rate,
            connections=args.connections,
            duration_s=args.duration, size=args.size,
            method=args.broadcast_tx_method)
        print(json.dumps({
            "experiment_id": res.experiment_id, "sent": res.sent,
            "accepted": res.accepted, "errors": res.errors,
            "duration_s": round(res.duration_s, 3)}))
        if args.report:
            rep = await loadtime.report(
                args.endpoints.split(",")[0],
                experiment_id=res.experiment_id)
            print(json.dumps(rep.to_dict()))
    asyncio.run(run())
    return 0


def cmd_load_report(args) -> int:
    """Latency + block-interval report over committed blocks
    (reference: test/loadtime cmd/report + e2e runner/benchmark.go)."""
    import asyncio

    from ..tools import loadtime

    async def run():
        rep = await loadtime.report(
            args.endpoint, experiment_id=args.experiment_id or None,
            from_height=args.from_height, to_height=args.to_height)
        print(json.dumps(rep.to_dict(), indent=2))
    asyncio.run(run())
    return 0


def cmd_inspect(args) -> int:
    """Serve read-only RPC over the data stores of a stopped/crashed
    node — no consensus, no p2p (reference: commands/inspect.go +
    inspect/inspect.go)."""
    import asyncio

    cfg = _load_config(args.home)

    class _InspectNode:
        """The minimal node surface rpc/core needs for read paths."""

        def __init__(self):
            from ..db import new_db
            from ..state.store import Store
            from ..store import BlockStore
            from ..types.events import EventBus
            from ..types.genesis import GenesisDoc
            db_dir = cfg.base.path(cfg.base.db_dir)
            backend = cfg.base.db_backend
            self.block_store = BlockStore(
                new_db("blockstore", backend, db_dir))
            self.state_store = Store(new_db("state", backend, db_dir))
            self.genesis_doc = GenesisDoc.from_file(
                cfg.base.path(cfg.base.genesis_file))
            self.event_bus = EventBus()
            self.mempool = None
            self.consensus_state = None
            self.config = cfg
            from ..indexer import BlockIndexer, TxIndexer
            idx_db = new_db("tx_index", backend, db_dir)
            self.tx_indexer = TxIndexer(idx_db)
            self.block_indexer = BlockIndexer(idx_db)
            self.metrics_registry = None

        def status(self):
            h = self.block_store.height
            meta = self.block_store.load_block_meta(h)
            return {"node_info": {"moniker": "inspect"},
                    "sync_info": {
                        "latest_block_height": str(h),
                        "latest_block_hash":
                            meta.block_id.hash.hex().upper()
                            if meta else "",
                        "earliest_block_height":
                            str(self.block_store.base),
                        "catching_up": False}}

    async def run():
        from ..rpc import core as rpc_core
        from ..rpc.server import RPCServer
        node = _InspectNode()
        cfg.rpc.laddr = args.rpc_laddr or cfg.rpc.laddr or \
            "tcp://127.0.0.1:26657"
        # restricted read-only route set (reference: inspect/rpc.go
        # Routes) — store/index reads only, no mempool/consensus/p2p
        env = rpc_core.Environment(node)
        all_routes = rpc_core.routes(env)
        routes = {name: all_routes[name] for name in (
            "health", "status", "genesis", "block", "block_by_hash",
            "block_results", "commit", "blockchain", "validators",
            "consensus_params", "tx", "tx_search", "block_search",
        ) if name in all_routes}
        srv = RPCServer(node, cfg.rpc, routes=routes)
        await srv.start()
        print(f"inspect server on {srv.listen_addr} "
              f"(height {node.block_store.height})")
        await asyncio.Event().wait()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    return 0


def cmd_reindex_event(args) -> int:
    """Rebuild the tx/block indexes from the block store + stored
    FinalizeBlockResponses (reference: commands/reindex_event.go)."""
    from ..abci import types as abci
    from ..db import new_db
    from ..indexer import BlockIndexer, TxIndexer
    from ..state.store import Store
    from ..store import BlockStore

    cfg = _load_config(args.home)
    db_dir = cfg.base.path(cfg.base.db_dir)
    backend = cfg.base.db_backend
    block_store = BlockStore(new_db("blockstore", backend, db_dir))
    state_store = Store(new_db("state", backend, db_dir))
    idx_db = new_db("tx_index", backend, db_dir)
    txi, bi = TxIndexer(idx_db), BlockIndexer(idx_db)

    start = args.start_height or block_store.base
    end = args.end_height or block_store.height
    n_txs = n_blocks = 0
    for h in range(start, end + 1):
        block = block_store.load_block(h)
        resp = state_store.load_finalize_block_response(h)
        if block is None or resp is None:
            continue
        bi.index(h, resp.events)
        n_blocks += 1
        for i, tx in enumerate(block.data.txs):
            if i < len(resp.tx_results):
                txi.index(abci.TxResult(height=h, index=i, tx=tx,
                                        result=resp.tx_results[i]))
                n_txs += 1
    print(f"reindexed {n_blocks} blocks / {n_txs} txs "
          f"(heights {start}..{end})")
    return 0


def cmd_debug_dump(args) -> int:
    """Capture a diagnostic bundle from a RUNNING node over RPC
    (reference: cmd/cometbft/commands/debug — status, net_info,
    consensus state, config, metrics)."""
    import asyncio
    import json as _json
    import os as _os

    async def run():
        from ..rpc.client import HTTPClient
        cli = HTTPClient(args.rpc_laddr)
        out_dir = args.output_directory
        _os.makedirs(out_dir, exist_ok=True)
        for method in ("status", "net_info", "consensus_state",
                       "num_unconfirmed_txs"):
            try:
                res = await cli.call(method)
            except Exception as e:  # noqa: BLE001 — best-effort bundle
                res = {"error": str(e)}
            with open(_os.path.join(out_dir, f"{method}.json"),
                      "w") as f:
                _json.dump(res, f, indent=2)
        # metrics exposition
        import urllib.request
        try:
            url = args.rpc_laddr.replace("tcp://", "http://")
            with urllib.request.urlopen(f"{url}/metrics",
                                        timeout=5) as r:
                text = r.read().decode()
        except Exception as e:  # noqa: BLE001
            text = f"# error: {e}\n"
        with open(_os.path.join(out_dir, "metrics.txt"), "w") as f:
            f.write(text)
        print(f"debug bundle written to {out_dir}")

    asyncio.run(run())
    return 0


def cmd_light(args) -> int:
    """Reference: cmd/cometbft/commands/light.go — stand-alone verifying
    proxy daemon."""
    import asyncio

    from ..light.proxy import LightProxy

    async def run():
        proxy = LightProxy(
            args.chain_id, args.primary, list(args.witness),
            args.trusted_height, bytes.fromhex(args.trusted_hash),
            args.laddr, device=args.device or None)
        await proxy.start()
        await asyncio.Event().wait()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    return 0


def cmd_testnet(args) -> int:
    """Generate configs/genesis for an N-validator local testnet
    (reference: commands/testnet.go)."""
    from ..config import Config
    from ..node import init_files
    from ..privval import FilePV
    from ..types.genesis import GenesisDoc, GenesisValidator
    from ..types.timestamp import Timestamp
    from ..p2p.key import NodeKey

    n = args.v
    out = args.o
    pvs, node_ids = [], []
    for i in range(n):
        home = os.path.join(out, f"node{i}")
        cfg = Config()
        cfg.base.home = home
        os.makedirs(os.path.join(home, "config"), exist_ok=True)
        os.makedirs(os.path.join(home, "data"), exist_ok=True)
        pv = FilePV.load_or_generate(
            cfg.base.path(cfg.base.priv_validator_key_file),
            cfg.base.path(cfg.base.priv_validator_state_file),
            key_type=getattr(args, "key_type", "ed25519"))
        nk = NodeKey.load_or_gen(cfg.base.path(cfg.base.node_key_file))
        pvs.append(pv)
        node_ids.append(nk.id)
    doc = GenesisDoc(
        chain_id=args.chain_id or "local-testnet",
        genesis_time=Timestamp.now(),
        validators=[GenesisValidator(address=b"",
                                     pub_key=pv.get_pub_key(),
                                     power=1)
                    for pv in pvs])
    doc.validate_and_complete()
    base_p2p, base_rpc = args.starting_p2p_port, args.starting_rpc_port
    for i in range(n):
        home = os.path.join(out, f"node{i}")
        doc.save_as(os.path.join(home, "config", "genesis.json"))
        peers = ",".join(
            f"{node_ids[j]}@127.0.0.1:{base_p2p + j}"
            for j in range(n) if j != i)
        with open(os.path.join(home, "config", "config.json"),
                  "w") as f:
            json.dump({
                "p2p": {"laddr": f"tcp://127.0.0.1:{base_p2p + i}",
                        "persistent_peers": peers},
                "rpc": {"laddr": f"tcp://127.0.0.1:{base_rpc + i}"},
            }, f, indent=2)
    print(f"Successfully initialized {n} node directories in {out}")
    return 0


def cmd_version(args) -> int:
    from .. import version
    print(version.CMT_SEM_VER)
    return 0


def cmd_rollback(args) -> int:
    """Reference: commands/rollback.go + state/rollback.go."""
    from ..db import new_db
    from ..state.rollback import rollback_state
    from ..state.store import Store
    from ..store import BlockStore
    cfg = _load_config(args.home)
    db_dir = cfg.base.path(cfg.base.db_dir)
    bs = BlockStore(new_db("blockstore", cfg.base.db_backend, db_dir))
    ss = Store(new_db("state", cfg.base.db_backend, db_dir))
    height, app_hash = rollback_state(ss, bs,
                                      remove_block=args.hard)
    print(f"Rolled back state to height {height} and hash "
          f"{app_hash.hex().upper()}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="cometbft-tpu",
        description="TPU-native BFT consensus node")
    p.add_argument("--home", default=os.path.expanduser("~/.cometbft"),
                   help="node home directory")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("init", help="initialize files for a node")
    sp.add_argument("--chain-id", default="")
    sp.set_defaults(fn=cmd_init)

    sp = sub.add_parser("start", help="run the node")
    sp.add_argument("--proxy_app", default="")
    sp.add_argument("--p2p.laddr", dest="p2p_laddr", default="")
    sp.add_argument("--rpc.laddr", dest="rpc_laddr", default="")
    sp.add_argument("--p2p.persistent_peers",
                    dest="persistent_peers", default="")
    sp.add_argument("--log_level", default="")
    sp.add_argument("--device", default="",
                    help="torch device to verify on (default: the card; "
                         "'cpu' runs the plain version)")
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("show-node-id", help="show the node ID")
    sp.set_defaults(fn=cmd_show_node_id)

    sp = sub.add_parser("show-validator",
                        help="show the validator pubkey")
    sp.set_defaults(fn=cmd_show_validator)

    sp = sub.add_parser("gen-node-key", help="generate a node key")
    sp.set_defaults(fn=cmd_gen_node_key)

    sp = sub.add_parser("unsafe-reset-all",
                        help="wipe data, keep keys")
    sp.set_defaults(fn=cmd_unsafe_reset_all)

    sp = sub.add_parser("testnet",
                        help="generate a local testnet")
    sp.add_argument("--v", type=int, default=4,
                    help="number of validators")
    sp.add_argument("--o", default="./mytestnet",
                    help="output directory")
    sp.add_argument("--chain-id", default="")
    sp.add_argument("--starting-p2p-port", type=int, default=26656)
    sp.add_argument("--starting-rpc-port", type=int, default=26657)
    sp.add_argument("--key-type", dest="key_type", default="ed25519",
                    help="validator key type: ed25519|secp256k1|bls12_381 "
                         "(reference: testnet.go --key-type)")
    sp.set_defaults(fn=cmd_testnet)

    sp = sub.add_parser(
        "light", help="run a light-client verifying RPC proxy")
    sp.add_argument("chain_id")
    sp.add_argument("--primary", required=True,
                    help="primary full node RPC address")
    sp.add_argument("--witness", action="append", default=[],
                    help="witness RPC address (repeatable)")
    sp.add_argument("--trusted-height", type=int, required=True)
    sp.add_argument("--trusted-hash", required=True,
                    help="hex header hash at the trusted height")
    sp.add_argument("--laddr", default="tcp://127.0.0.1:8888")
    sp.add_argument("--device", default="",
                    help="torch device to verify on (default: the card)")
    sp.set_defaults(fn=cmd_light)

    sp = sub.add_parser("config", help="config tooling")
    cfgsub = sp.add_subparsers(dest="config_cmd", required=True)
    cv = cfgsub.add_parser("validate", help="validate the config file")
    cv.set_defaults(fn=cmd_config_validate)
    cv = cfgsub.add_parser("view", help="print the effective config")
    cv.set_defaults(fn=cmd_config_view)
    cv = cfgsub.add_parser("get", help="print one config value")
    cv.add_argument("key", help="section.key")
    cv.set_defaults(fn=cmd_config_get)
    cv = cfgsub.add_parser("set", help="persist one config value")
    cv.add_argument("key", help="section.key")
    cv.add_argument("value")
    cv.set_defaults(fn=cmd_config_set)
    cv = cfgsub.add_parser("diff",
                           help="show changes vs the defaults")
    cv.set_defaults(fn=cmd_config_diff)
    cv = cfgsub.add_parser(
        "migrate", help="normalize the config file to this schema")
    cv.add_argument("--dry-run", action="store_true")
    cv.set_defaults(fn=cmd_config_migrate)

    sp = sub.add_parser(
        "priv-val-server",
        help="standalone remote signer daemon (dials the node)")
    sp.add_argument("--addr", required=True,
                    help="node's priv_validator_laddr to dial")
    sp.add_argument("--chain-id", required=True)
    sp.add_argument("--priv-key-file", required=True)
    sp.add_argument("--state-file", required=True)
    sp.set_defaults(fn=cmd_priv_val_server)

    sp = sub.add_parser(
        "generate-manifests",
        help="randomly sample testnet manifests (e2e generator)")
    sp.add_argument("-o", default=".", help="output directory")
    sp.add_argument("-n", type=int, default=4,
                    help="number of manifests")
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=cmd_generate_manifests)

    sp = sub.add_parser("load", help="generate timestamped tx load")
    sp.add_argument("--endpoints", required=True,
                    help="comma-separated RPC base URLs")
    sp.add_argument("--rate", type=int, default=100)
    sp.add_argument("--connections", type=int, default=1)
    sp.add_argument("--duration", type=float, default=10.0)
    sp.add_argument("--size", type=int, default=256)
    sp.add_argument("--broadcast-tx-method", default="sync",
                    choices=["sync", "async"])
    sp.add_argument("--report", action="store_true",
                    help="print the latency report afterwards")
    sp.set_defaults(fn=cmd_load)

    sp = sub.add_parser(
        "load-report", help="latency report over committed blocks")
    sp.add_argument("--endpoint", required=True)
    sp.add_argument("--experiment-id", default="")
    sp.add_argument("--from-height", type=int, default=0)
    sp.add_argument("--to-height", type=int, default=0)
    sp.set_defaults(fn=cmd_load_report)

    sp = sub.add_parser(
        "inspect", help="read-only RPC over a stopped node's data")
    sp.add_argument("--rpc.laddr", dest="rpc_laddr", default="")
    sp.set_defaults(fn=cmd_inspect)

    sp = sub.add_parser("reindex-event",
                        help="rebuild tx/block indexes from stores")
    sp.add_argument("--start-height", type=int, default=0)
    sp.add_argument("--end-height", type=int, default=0)
    sp.set_defaults(fn=cmd_reindex_event)

    sp = sub.add_parser("debug", help="debug a running node")
    dbg = sp.add_subparsers(dest="debug_cmd", required=True)
    dd = dbg.add_parser("dump", help="capture a diagnostic bundle")
    dd.add_argument("output_directory")
    dd.add_argument("--rpc-laddr", default="tcp://127.0.0.1:26657")
    dd.set_defaults(fn=cmd_debug_dump)

    sp = sub.add_parser("rollback", help="roll back one height")
    sp.add_argument("--hard", action="store_true",
                    help="also remove the block")
    sp.set_defaults(fn=cmd_rollback)

    sp = sub.add_parser("version", help="show version")
    sp.set_defaults(fn=cmd_version)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
