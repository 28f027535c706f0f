"""kvstore: the canonical example/test application.

Reference: abci/example/kvstore/kvstore.go — key=value txs,
validator-update txs ("val=<type>!<b64 pubkey>!<power>"), priority lanes,
the /val query path — through cometbft_tpu/abci/kvstore.py, whose app
hashes, query answers and validator updates this copy reproduces byte
for byte.

Storage is the committed state tree (statetree/): every kv pair and
validator record is a tree leaf, FinalizeBlock returns the tree's
working root as app_hash and Commit persists it as the height's version,
so queries serve versioned (historical) reads.  Not ported: the
/multistore proof query (ROADMAP A.7b'), state-sync snapshots, pruning
by retain height, artificial call delays, and the import of pre-tree
stores.
"""
from __future__ import annotations

import base64
import json
from typing import Optional

from .. import version as _version
from ..crypto import encoding as crypto_encoding
from ..db import DB, MemDB
from ..db.db import PrefixDB
from ..libs.log import new_logger
from ..statetree import StateTree
from . import types as abci

VALIDATOR_PREFIX = "val="
APP_VERSION = 1
DEFAULT_LANE = "default"

CODE_TYPE_OK = 0
CODE_TYPE_ENCODING_ERROR = 1
CODE_TYPE_INVALID_TX_FORMAT = 2
CODE_TYPE_UNAUTHORIZED = 3
CODE_TYPE_EXECUTED = 5

_KV_PREFIX = b"kvPairKey:"        # the recheck-key prefix of a kv tx
_TREE_PREFIX = b"statetree/"

# lane priorities (reference: kvstore.go NewInMemoryApplication lanes)
DEFAULT_LANES = {"val": 9, "foo": 7, DEFAULT_LANE: 3, "bar": 1}


def make_val_set_change_tx(pub_key_type: str, pub_key_bytes: bytes,
                           power: int) -> bytes:
    """Reference: helpers.go MakeValSetChangeTx."""
    pub = base64.b64encode(pub_key_bytes).decode()
    return f"{VALIDATOR_PREFIX}{pub_key_type}!{pub}!{power}".encode()


def _parse_val_value(raw: bytes) -> tuple[str, int]:
    """Stored validator value 'type!power' (pre-mixed-key stores held
    a bare power: treat those as ed25519)."""
    s = raw.decode()
    if "!" in s:
        key_type, power_s = s.split("!", 1)
        return key_type, int(power_s)
    return "ed25519", int(s)


def is_validator_tx(tx: bytes) -> bool:
    return tx.startswith(VALIDATOR_PREFIX.encode())


def parse_validator_tx(tx: bytes) -> tuple[str, bytes, int]:
    """Returns (key_type, pub_key_bytes, power)."""
    body = tx[len(VALIDATOR_PREFIX):].decode()
    parts = body.split("!")
    if len(parts) != 3:
        raise ValueError(f"expected 'type!pubkey!power', got {body!r}")
    key_type, pub_b64, power_s = parts
    pub = base64.b64decode(pub_b64)
    power = int(power_s)
    if power < 0:
        raise ValueError("power can not be less than 0")
    return key_type, pub, power


def parse_tx(tx: bytes) -> tuple[str, str]:
    parts = tx.split(b"=")
    if len(parts) != 2:
        raise ValueError(f"invalid tx format: {tx!r}")
    if not parts[0]:
        raise ValueError("key cannot be empty")
    return parts[0].decode(), parts[1].decode()


def is_valid_tx(tx: bytes) -> bool:
    """key=value or key:value, exactly one separator, not at the ends."""
    for sep, other in ((b":", b"="), (b"=", b":")):
        if tx.count(sep) == 1 and tx.count(other) == 0:
            if not tx.startswith(sep) and not tx.endswith(sep):
                return True
    return False


def tx_recheck_keys(tx: bytes) -> list:
    """The state keys a tx's validity depends on, for the mempool's
    incremental recheck.  kvstore txs write exactly one kv key (or one
    validator record); kvstore CheckTx is stateless, so this is a
    conservative over-report — which is the safe direction."""
    try:
        if is_validator_tx(tx):
            _, pub, _ = parse_validator_tx(tx)
            return [VALIDATOR_PREFIX.encode() +
                    base64.b64encode(pub)]
        key, _ = parse_tx(tx.replace(b":", b"="))
        return [_KV_PREFIX + key.encode()]
    except ValueError:
        return []


def assign_lane(tx: bytes) -> str:
    """Deterministic lane assignment (reference: kvstore.go assignLane)."""
    if is_validator_tx(tx):
        return "val"
    try:
        key, _ = parse_tx(tx)
        key_int = int(key)
    except ValueError:
        return DEFAULT_LANE
    if key_int % 11 == 0:
        return "foo"
    if key_int % 3 == 0:
        return "bar"
    return DEFAULT_LANE


def _val_tree_key(pub_key_bytes: bytes) -> bytes:
    """Validator record key inside the state tree.  kv tx keys can
    never contain '=' (parse_tx requires exactly one separator), so
    the 'val=' prefix cannot collide with a user kv key."""
    return (VALIDATOR_PREFIX +
            base64.b64encode(pub_key_bytes).decode()).encode()


class KVStoreApplication(abci.Application):
    def __init__(self, db: Optional[DB] = None,
                 lane_priorities: Optional[dict[str, int]] = DEFAULT_LANES):
        self.db = db if db is not None else MemDB()
        self.lane_priorities = dict(lane_priorities or {})
        self.logger = new_logger("kvstore")
        self._val_updates: list[abci.ValidatorUpdate] = []
        self._val_addr_to_pubkey: dict[bytes, tuple[str, bytes]] = {}
        self._height = 0
        self._size = 0
        self.tree = StateTree(PrefixDB(self.db, _TREE_PREFIX))
        self._load_state()

    # ------------------------------------------------------------------
    def _load_state(self) -> None:
        if self.tree.latest_version is not None:
            # the tree is the source of truth: height/size ride the
            # version record's extra blob, written in the same atomic
            # batch as the state — no crash window between them
            self._height = self.tree.latest_version
            self._size = int(
                self.tree.version_extra().get("size", 0))
            self._rebuild_val_map()

    def _rebuild_val_map(self) -> None:
        self._val_addr_to_pubkey.clear()
        val_prefix = VALIDATOR_PREFIX.encode()
        for key, raw_val in self.tree.pairs():
            if not key.startswith(val_prefix):
                continue
            pub = base64.b64decode(key[len(val_prefix):])
            key_type, _ = _parse_val_value(raw_val)
            pk = crypto_encoding.pub_key_from_type_and_bytes(
                key_type, pub)
            self._val_addr_to_pubkey[pk.address()] = (key_type, pub)

    def _app_hash(self) -> bytes:
        """The committed app hash: the state tree root."""
        return self.tree.reported_hash()

    # ------------------------------------------------------------------
    async def info(self, req: abci.InfoRequest) -> abci.InfoResponse:
        default_lane = ""
        if self.lane_priorities:
            default_lane = DEFAULT_LANE
        return abci.InfoResponse(
            data=json.dumps({"size": self._size}),
            version=_version.ABCI_SEM_VER,
            app_version=APP_VERSION,
            last_block_height=self._height,
            last_block_app_hash=self._app_hash(),
            lane_priorities=dict(self.lane_priorities),
            default_lane=default_lane,
        )

    async def init_chain(self, req: abci.InitChainRequest
                         ) -> abci.InitChainResponse:
        self.tree.reset_working()
        for v in req.validators:
            self._stage_validator(v)
            self._track_validator(v)
        # genesis state = tree version 0; its root is the app_hash
        # block 1's header carries.  Re-running InitChain over an
        # already-committed version 0 (crash before height 1, then
        # handshake replay) is an idempotent no-op in the tree.
        app_hash = self.tree.commit(0, extra={"size": self._size})
        return abci.InitChainResponse(app_hash=app_hash)

    async def check_tx(self, req: abci.CheckTxRequest
                       ) -> abci.CheckTxResponse:
        if is_validator_tx(req.tx):
            try:
                parse_validator_tx(req.tx)
            except ValueError:
                return abci.CheckTxResponse(
                    code=CODE_TYPE_INVALID_TX_FORMAT)
        elif not is_valid_tx(req.tx):
            return abci.CheckTxResponse(code=CODE_TYPE_INVALID_TX_FORMAT)
        keys = tx_recheck_keys(req.tx)
        if not self.lane_priorities:
            return abci.CheckTxResponse(code=CODE_TYPE_OK, gas_wanted=1,
                                        recheck_keys=keys)
        return abci.CheckTxResponse(code=CODE_TYPE_OK, gas_wanted=1,
                                    lane_id=assign_lane(req.tx),
                                    recheck_keys=keys)

    async def prepare_proposal(self, req: abci.PrepareProposalRequest
                               ) -> abci.PrepareProposalResponse:
        """Normalize 'k:v' to 'k=v', drop invalid txs (reference:
        formatTxs)."""
        txs = []
        for tx in req.txs:
            if is_validator_tx(tx):
                try:
                    parse_validator_tx(tx)
                except ValueError:
                    continue
                txs.append(tx)
            elif is_valid_tx(tx):
                txs.append(tx.replace(b":", b"="))
        return abci.PrepareProposalResponse(txs=txs)

    async def process_proposal(self, req: abci.ProcessProposalRequest
                               ) -> abci.ProcessProposalResponse:
        for tx in req.txs:
            if is_validator_tx(tx):
                try:
                    parse_validator_tx(tx)
                except ValueError:
                    return abci.ProcessProposalResponse(
                        status=abci.PROCESS_PROPOSAL_STATUS_REJECT)
            elif not is_valid_tx(tx) or b":" in tx:
                # only the proposer's "=" normal form is acceptable here
                return abci.ProcessProposalResponse(
                    status=abci.PROCESS_PROPOSAL_STATUS_REJECT)
        return abci.ProcessProposalResponse(
            status=abci.PROCESS_PROPOSAL_STATUS_ACCEPT)

    async def finalize_block(self, req: abci.FinalizeBlockRequest
                             ) -> abci.FinalizeBlockResponse:
        self._val_updates = []
        # a previous FinalizeBlock whose Commit never arrived (crash
        # replay) must not leak staged writes into this block
        self.tree.reset_working()

        # punish equivocators by one power unit per offence
        # (reference: kvstore.go:318), ONE update per address — a
        # block can carry several evidences against one validator, and
        # duplicate entries in validator_updates are a consensus-
        # failure per the ABCI contract
        punish: dict[bytes, int] = {}
        for ev in req.misbehavior:
            if ev.type == abci.MISBEHAVIOR_TYPE_DUPLICATE_VOTE:
                addr = ev.validator.address
                punish[addr] = min(
                    punish.get(addr, ev.validator.power) - 1,
                    ev.validator.power - 1)
        for addr, new_power in punish.items():
            entry = self._val_addr_to_pubkey.get(addr)
            if entry is not None:
                key_type, pub = entry
                self._val_updates.append(abci.ValidatorUpdate(
                    power=max(new_power, 0),
                    pub_key_type=key_type, pub_key_bytes=pub))
                self.logger.info(
                    "Decreased val power for equivocation",
                    val=addr.hex(), new_power=max(new_power, 0))

        tx_results = []
        for tx in req.txs:
            if is_validator_tx(tx):
                key_type, pub, power = parse_validator_tx(tx)
                self._val_updates.append(abci.ValidatorUpdate(
                    power=power, pub_key_type=key_type,
                    pub_key_bytes=pub))
            else:
                parts = tx.split(b"=")
                if len(parts) == 2:
                    self.tree.set(parts[0], parts[1])
            parts = tx.split(b"=")
            if len(parts) == 2:
                key, value = parts[0].decode(), parts[1].decode()
            else:
                key = value = tx.decode(errors="replace")
            tx_results.append(abci.ExecTxResult(
                code=CODE_TYPE_OK,
                recheck_keys=tx_recheck_keys(tx),
                events=[abci.Event(type="app", attributes=[
                    abci.EventAttribute("creator", "Cosmoshi Netowoko",
                                        True),
                    abci.EventAttribute("key", key, True),
                    abci.EventAttribute("index_key", "index is working",
                                        True),
                    abci.EventAttribute("noindex_key", "index is working",
                                        False),
                ])],
            ))
            self._size += 1

        self._height = req.height
        # one update per pubkey across ALL sources (punishments and
        # validator txs may both touch the same validator in one
        # block; duplicate entries are a consensus failure) — the
        # LAST write wins, so an explicit val-tx overrides the
        # evidence punishment, matching append order
        by_key: dict[bytes, abci.ValidatorUpdate] = {}
        for u in self._val_updates:
            by_key[u.pub_key_bytes] = u
        for u in by_key.values():
            self._stage_validator(u)
        # the app hash IS this height's tree root; Commit persists
        # the same staged view (the tree caches the computation)
        return abci.FinalizeBlockResponse(
            tx_results=tx_results,
            validator_updates=list(by_key.values()),
            app_hash=self.tree.working_root(req.height),
        )

    async def commit(self, req: abci.CommitRequest) -> abci.CommitResponse:
        # one atomic batch: kv writes, validator records, version
        # metadata (height implicit, size in extra) — a crash either
        # side of this line replays to the exact same root
        self.tree.commit(self._height, extra={"size": self._size})
        for u in self._dedup_val_updates():
            self._track_validator(u)
        return abci.CommitResponse()

    def _dedup_val_updates(self) -> list[abci.ValidatorUpdate]:
        by_key: dict[bytes, abci.ValidatorUpdate] = {}
        for u in self._val_updates:
            by_key[u.pub_key_bytes] = u
        return list(by_key.values())

    def _resolve_version(self, height: int) -> Optional[int]:
        """Query height -> tree version (they coincide: version H is
        the state after block H).  0 = latest.  Raises ValueError for
        a height the tree cannot serve (not yet committed);
        returns None when nothing was ever committed."""
        latest = self.tree.latest_version
        if latest is None:
            if height > 0:
                raise ValueError("no committed state")
            return None
        if height == 0:
            return latest
        if height > latest:
            raise ValueError(f"height {height} not yet committed "
                             f"(latest {latest})")
        return height

    async def query(self, req: abci.QueryRequest) -> abci.QueryResponse:
        if req.path == "/multistore":
            return self._multistore_query(req)
        try:
            v = self._resolve_version(req.height)
        except ValueError as e:
            return abci.QueryResponse(code=CODE_TYPE_ENCODING_ERROR,
                                      log=str(e), height=self._height)
        if req.path == "/val":
            value = b""
            if v is not None:
                value = self.tree.get(
                    (VALIDATOR_PREFIX + req.data.decode()).encode(),
                    v) or b""
            if value:
                # external contract stays the bare power (the key
                # type tag is internal to the stored value)
                value = str(_parse_val_value(value)[1]).encode()
            return abci.QueryResponse(key=req.data, value=value)
        value = self.tree.get(req.data, v) if v is not None else None
        return abci.QueryResponse(
            key=req.data,
            value=value or b"",
            log="exists" if value is not None else "does not exist",
            height=v if v is not None else self._height,
        )

    # ------------------------------------------------------------------
    def _multistore_query(self, req: abci.QueryRequest
                          ) -> abci.QueryResponse:
        """The batched provable lookup waits for the state tree's proofs
        (ROADMAP A.7b')."""
        raise NotImplementedError(
            "the /multistore proof query is not ported yet (ROADMAP "
            "A.7b')")

    # ------------------------------------------------------------------
    def _stage_validator(self, v: abci.ValidatorUpdate) -> None:
        """Stage a validator record into the tree's working set —
        validator state is part of the committed app state, so it is
        provable (and prunable) like any kv pair."""
        key = _val_tree_key(v.pub_key_bytes)
        if v.power == 0:
            self.tree.delete(key)
        else:
            # record the key TYPE with the power: a restart must
            # rebuild a mixed-key validator map (the b64 pubkey alone
            # can't distinguish ed25519 from secp256k1)
            self.tree.set(key, f"{v.pub_key_type}!{v.power}".encode())

    def _track_validator(self, v: abci.ValidatorUpdate) -> None:
        pub = crypto_encoding.pub_key_from_type_and_bytes(
            v.pub_key_type, v.pub_key_bytes)
        addr = pub.address()
        if v.power == 0:
            self._val_addr_to_pubkey.pop(addr, None)
        else:
            self._val_addr_to_pubkey[addr] = (v.pub_key_type,
                                              v.pub_key_bytes)

    def get_validators(self) -> list[abci.ValidatorUpdate]:
        out = []
        for addr, (key_type, pub) in self._val_addr_to_pubkey.items():
            raw = self.tree.get(_val_tree_key(pub))
            if raw:
                out.append(abci.ValidatorUpdate(
                    power=_parse_val_value(raw)[1],
                    pub_key_type=key_type,
                    pub_key_bytes=pub))
        return out
