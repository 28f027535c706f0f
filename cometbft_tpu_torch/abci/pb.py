"""ABCI dataclass <-> proto-dict conversion and the socket envelope codec.

Reference: abci/types/messages.go (WriteMessage/ReadMessage framing) and
proto/cometbft/abci/v2/types.proto (Request :18-36 / Response :222-244
oneofs).  Field names of the dataclasses in abci/types.py deliberately
match the proto field names, so most conversion is mechanical; the
exceptions (timestamps, consensus params, durations, the lane-priority
map) are handled explicitly.  A copy of cometbft_tpu/abci/pb.py: the
same envelopes, so the frames are byte-equal; FinalizeBlockResponse goes
through the codec the state store keeps its rows with (defined here).
"""
from __future__ import annotations

from typing import Any, Optional

from ..types.params import ConsensusParams
from ..types.timestamp import Timestamp
from ..wire import abci_pb, decode, encode
from ..wire.proto import decode_uvarint, encode_uvarint
from . import types as abci


class ABCIProtoError(Exception):
    pass


# --- leaf converters --------------------------------------------------------

def _event_to(e: abci.Event) -> dict:
    return {"type": e.type,
            "attributes": [{"key": a.key, "value": a.value,
                            "index": a.index} for a in e.attributes]}


def _event_from(d: dict) -> abci.Event:
    return abci.Event(
        type=d.get("type", ""),
        attributes=[abci.EventAttribute(key=a.get("key", ""),
                                        value=a.get("value", ""),
                                        index=a.get("index", False))
                    for a in d.get("attributes", [])])


def _validator_to(v: abci.ABCIValidator) -> dict:
    return {"address": v.address, "power": v.power}


def _validator_from(d: dict) -> abci.ABCIValidator:
    return abci.ABCIValidator(address=d.get("address", b""),
                              power=d.get("power", 0))


def _val_update_to(v: abci.ValidatorUpdate) -> dict:
    return {"power": v.power, "pub_key_bytes": v.pub_key_bytes,
            "pub_key_type": v.pub_key_type}


def _val_update_from(d: dict) -> abci.ValidatorUpdate:
    return abci.ValidatorUpdate(power=d.get("power", 0),
                                pub_key_bytes=d.get("pub_key_bytes", b""),
                                pub_key_type=d.get("pub_key_type", ""))


def _commit_info_to(ci: abci.CommitInfo) -> dict:
    return {"round": ci.round,
            "votes": [{"validator": _validator_to(v.validator),
                       "block_id_flag": v.block_id_flag}
                      for v in ci.votes]}


def _commit_info_from(d: dict) -> abci.CommitInfo:
    return abci.CommitInfo(
        round=d.get("round", 0),
        votes=[abci.VoteInfo(
            validator=_validator_from(v.get("validator") or {}),
            block_id_flag=v.get("block_id_flag", 0))
            for v in d.get("votes", [])])


def _ext_commit_info_to(ci: abci.ExtendedCommitInfo) -> dict:
    return {"round": ci.round,
            "votes": [{
                "validator": _validator_to(v.validator),
                "vote_extension": v.vote_extension,
                "extension_signature": v.extension_signature,
                "block_id_flag": v.block_id_flag,
                "non_rp_vote_extension": v.non_rp_vote_extension,
                "non_rp_extension_signature": v.non_rp_extension_signature,
            } for v in ci.votes]}


def _ext_commit_info_from(d: dict) -> abci.ExtendedCommitInfo:
    return abci.ExtendedCommitInfo(
        round=d.get("round", 0),
        votes=[abci.ExtendedVoteInfo(
            validator=_validator_from(v.get("validator") or {}),
            vote_extension=v.get("vote_extension", b""),
            extension_signature=v.get("extension_signature", b""),
            block_id_flag=v.get("block_id_flag", 0),
            non_rp_vote_extension=v.get("non_rp_vote_extension", b""),
            non_rp_extension_signature=v.get(
                "non_rp_extension_signature", b""))
            for v in d.get("votes", [])])


def _misbehavior_to(m: abci.Misbehavior) -> dict:
    return {"type": m.type, "validator": _validator_to(m.validator),
            "height": m.height, "time": m.time.to_proto(),
            "total_voting_power": m.total_voting_power}


def _misbehavior_from(d: dict) -> abci.Misbehavior:
    return abci.Misbehavior(
        type=d.get("type", 0),
        validator=_validator_from(d.get("validator") or {}),
        height=d.get("height", 0),
        time=Timestamp.from_proto(d.get("time") or {}),
        total_voting_power=d.get("total_voting_power", 0))


def _snapshot_to(s: Optional[abci.Snapshot]) -> Optional[dict]:
    if s is None:
        return None
    return {"height": s.height, "format": s.format, "chunks": s.chunks,
            "hash": s.hash, "metadata": s.metadata}


def _snapshot_from(d: Optional[dict]) -> Optional[abci.Snapshot]:
    if not d:
        return None
    return abci.Snapshot(height=d.get("height", 0),
                         format=d.get("format", 0),
                         chunks=d.get("chunks", 0),
                         hash=d.get("hash", b""),
                         metadata=d.get("metadata", b""))


def _exec_tx_result_to(r: abci.ExecTxResult) -> dict:
    return {"code": r.code, "data": r.data, "log": r.log, "info": r.info,
            "gas_wanted": r.gas_wanted, "gas_used": r.gas_used,
            "events": [_event_to(e) for e in r.events],
            "codespace": r.codespace}


def _exec_tx_result_from(d: dict) -> abci.ExecTxResult:
    return abci.ExecTxResult(
        code=d.get("code", 0), data=d.get("data", b""),
        log=d.get("log", ""), info=d.get("info", ""),
        gas_wanted=d.get("gas_wanted", 0), gas_used=d.get("gas_used", 0),
        events=[_event_from(e) for e in d.get("events", [])],
        codespace=d.get("codespace", ""))


def _params_to(p: Optional[Any]) -> Optional[dict]:
    if p is None:
        return None
    return p.to_proto()


def _params_from(d: Optional[dict]) -> Optional[ConsensusParams]:
    if not d:
        return None
    return ConsensusParams.from_proto(d)


def fbr_to_proto(resp) -> dict:
    """abci.FinalizeBlockResponse dataclass -> proto dict: the state
    store's rows and the socket envelope's body alike (the reference
    package's state/store.py _fbr_to_proto).  It lives here, not in
    state/, so that an app process serving FinalizeBlock imports
    nothing of state/'s (which loads torch)."""
    def event(e):
        return {
            **({"type": e.type} if e.type else {}),
            "attributes": [
                {**({"key": a.key} if a.key else {}),
                 **({"value": a.value} if a.value else {}),
                 **({"index": True} if a.index else {})}
                for a in e.attributes],
        }

    def txr(r):
        d: dict = {}
        if r.code:
            d["code"] = r.code
        if r.data:
            d["data"] = r.data
        if r.log:
            d["log"] = r.log
        if r.info:
            d["info"] = r.info
        if r.gas_wanted:
            d["gas_wanted"] = r.gas_wanted
        if r.gas_used:
            d["gas_used"] = r.gas_used
        if r.events:
            d["events"] = [event(e) for e in r.events]
        if r.codespace:
            d["codespace"] = r.codespace
        if r.recheck_keys:
            d["recheck_keys"] = list(r.recheck_keys)
        return d

    d: dict = {"next_block_delay": {}}
    if resp.events:
        d["events"] = [event(e) for e in resp.events]
    if resp.tx_results:
        d["tx_results"] = [txr(r) for r in resp.tx_results]
    if resp.validator_updates:
        d["validator_updates"] = [
            {**({"power": v.power} if v.power else {}),
             **({"pub_key_bytes": v.pub_key_bytes}
                if v.pub_key_bytes else {}),
             **({"pub_key_type": v.pub_key_type}
                if v.pub_key_type else {})}
            for v in resp.validator_updates]
    if resp.consensus_param_updates is not None:
        d["consensus_param_updates"] = \
            resp.consensus_param_updates.to_proto()
    if resp.app_hash:
        d["app_hash"] = resp.app_hash
    if resp.next_block_delay_ns:
        s, ns = divmod(resp.next_block_delay_ns, 1_000_000_000)
        nd: dict = {}
        if s:
            nd["seconds"] = s
        if ns:
            nd["nanos"] = ns
        d["next_block_delay"] = nd
    return d


def fbr_from_proto(d: dict):
    def event(e):
        return abci.Event(
            type=e.get("type", ""),
            attributes=[abci.EventAttribute(
                key=a.get("key", ""), value=a.get("value", ""),
                index=a.get("index", False))
                for a in e.get("attributes", [])])

    nd = d.get("next_block_delay") or {}
    cpu = d.get("consensus_param_updates")
    return abci.FinalizeBlockResponse(
        events=[event(e) for e in d.get("events", [])],
        tx_results=[abci.ExecTxResult(
            code=r.get("code", 0), data=r.get("data", b""),
            log=r.get("log", ""), info=r.get("info", ""),
            gas_wanted=r.get("gas_wanted", 0),
            gas_used=r.get("gas_used", 0),
            events=[event(e) for e in r.get("events", [])],
            codespace=r.get("codespace", ""),
            recheck_keys=list(r.get("recheck_keys", [])))
            for r in d.get("tx_results", [])],
        validator_updates=[abci.ValidatorUpdate(
            power=v.get("power", 0),
            pub_key_bytes=v.get("pub_key_bytes", b""),
            pub_key_type=v.get("pub_key_type", ""))
            for v in d.get("validator_updates", [])],
        consensus_param_updates=ConsensusParams.from_proto(cpu)
        if cpu is not None else None,
        app_hash=d.get("app_hash", b""),
        next_block_delay_ns=nd.get("seconds", 0) * 1_000_000_000 +
        nd.get("nanos", 0),
    )


# --- request conversion -----------------------------------------------------

def request_to_proto(req: Any) -> dict:
    """ABCI request dataclass -> {oneof_field: body} Request dict."""
    t = type(req).__name__
    if t == "EchoRequest":
        return {"echo": {"message": req.message}}
    if t == "FlushRequest":
        return {"flush": {}}
    if t == "InfoRequest":
        return {"info": {"version": req.version,
                         "block_version": req.block_version,
                         "p2p_version": req.p2p_version,
                         "abci_version": req.abci_version}}
    if t == "InitChainRequest":
        return {"init_chain": {
            "time": req.time.to_proto(),
            "chain_id": req.chain_id,
            "consensus_params": _params_to(req.consensus_params),
            "validators": [_val_update_to(v) for v in req.validators],
            "app_state_bytes": req.app_state_bytes,
            "initial_height": req.initial_height}}
    if t == "QueryRequest":
        return {"query": {"data": req.data, "path": req.path,
                          "height": req.height, "prove": req.prove}}
    if t == "CheckTxRequest":
        return {"check_tx": {"tx": req.tx, "type": req.type}}
    if t == "CommitRequest":
        return {"commit": {}}
    if t == "ListSnapshotsRequest":
        return {"list_snapshots": {}}
    if t == "OfferSnapshotRequest":
        return {"offer_snapshot": {"snapshot": _snapshot_to(req.snapshot),
                                   "app_hash": req.app_hash}}
    if t == "LoadSnapshotChunkRequest":
        return {"load_snapshot_chunk": {"height": req.height,
                                        "format": req.format,
                                        "chunk": req.chunk}}
    if t == "ApplySnapshotChunkRequest":
        return {"apply_snapshot_chunk": {"index": req.index,
                                         "chunk": req.chunk,
                                         "sender": req.sender}}
    if t == "PrepareProposalRequest":
        return {"prepare_proposal": {
            "max_tx_bytes": req.max_tx_bytes, "txs": list(req.txs),
            "local_last_commit": _ext_commit_info_to(req.local_last_commit),
            "misbehavior": [_misbehavior_to(m) for m in req.misbehavior],
            "height": req.height, "time": req.time.to_proto(),
            "next_validators_hash": req.next_validators_hash,
            "proposer_address": req.proposer_address}}
    if t == "ProcessProposalRequest":
        return {"process_proposal": {
            "txs": list(req.txs),
            "proposed_last_commit": _commit_info_to(req.proposed_last_commit),
            "misbehavior": [_misbehavior_to(m) for m in req.misbehavior],
            "hash": req.hash, "height": req.height,
            "time": req.time.to_proto(),
            "next_validators_hash": req.next_validators_hash,
            "proposer_address": req.proposer_address}}
    if t == "ExtendVoteRequest":
        return {"extend_vote": {
            "hash": req.hash, "height": req.height,
            "time": req.time.to_proto(), "txs": list(req.txs),
            "proposed_last_commit": _commit_info_to(req.proposed_last_commit),
            "misbehavior": [_misbehavior_to(m) for m in req.misbehavior],
            "next_validators_hash": req.next_validators_hash,
            "proposer_address": req.proposer_address}}
    if t == "VerifyVoteExtensionRequest":
        return {"verify_vote_extension": {
            "hash": req.hash, "validator_address": req.validator_address,
            "height": req.height, "vote_extension": req.vote_extension,
            "non_rp_vote_extension": req.non_rp_vote_extension}}
    if t == "FinalizeBlockRequest":
        return {"finalize_block": {
            "txs": list(req.txs),
            "decided_last_commit": _commit_info_to(req.decided_last_commit),
            "misbehavior": [_misbehavior_to(m) for m in req.misbehavior],
            "hash": req.hash, "height": req.height,
            "time": req.time.to_proto(),
            "next_validators_hash": req.next_validators_hash,
            "proposer_address": req.proposer_address,
            "syncing_to_height": req.syncing_to_height}}
    raise ABCIProtoError(f"unknown request type {t}")


def request_from_proto(d: dict) -> Any:
    if "echo" in d:
        return abci.EchoRequest(message=d["echo"].get("message", ""))
    if "flush" in d:
        return abci.FlushRequest()
    if "info" in d:
        b = d["info"]
        return abci.InfoRequest(
            version=b.get("version", ""),
            block_version=b.get("block_version", 0),
            p2p_version=b.get("p2p_version", 0),
            abci_version=b.get("abci_version", ""))
    if "init_chain" in d:
        b = d["init_chain"]
        return abci.InitChainRequest(
            time=Timestamp.from_proto(b.get("time") or {}),
            chain_id=b.get("chain_id", ""),
            consensus_params=_params_from(b.get("consensus_params")),
            validators=[_val_update_from(v)
                        for v in b.get("validators", [])],
            app_state_bytes=b.get("app_state_bytes", b""),
            initial_height=b.get("initial_height", 0))
    if "query" in d:
        b = d["query"]
        return abci.QueryRequest(data=b.get("data", b""),
                                 path=b.get("path", ""),
                                 height=b.get("height", 0),
                                 prove=b.get("prove", False))
    if "check_tx" in d:
        b = d["check_tx"]
        return abci.CheckTxRequest(tx=b.get("tx", b""),
                                   type=b.get("type", 0))
    if "commit" in d:
        return abci.CommitRequest()
    if "list_snapshots" in d:
        return abci.ListSnapshotsRequest()
    if "offer_snapshot" in d:
        b = d["offer_snapshot"]
        return abci.OfferSnapshotRequest(
            snapshot=_snapshot_from(b.get("snapshot")),
            app_hash=b.get("app_hash", b""))
    if "load_snapshot_chunk" in d:
        b = d["load_snapshot_chunk"]
        return abci.LoadSnapshotChunkRequest(height=b.get("height", 0),
                                             format=b.get("format", 0),
                                             chunk=b.get("chunk", 0))
    if "apply_snapshot_chunk" in d:
        b = d["apply_snapshot_chunk"]
        return abci.ApplySnapshotChunkRequest(index=b.get("index", 0),
                                              chunk=b.get("chunk", b""),
                                              sender=b.get("sender", ""))
    if "prepare_proposal" in d:
        b = d["prepare_proposal"]
        return abci.PrepareProposalRequest(
            max_tx_bytes=b.get("max_tx_bytes", 0),
            txs=list(b.get("txs", [])),
            local_last_commit=_ext_commit_info_from(
                b.get("local_last_commit") or {}),
            misbehavior=[_misbehavior_from(m)
                         for m in b.get("misbehavior", [])],
            height=b.get("height", 0),
            time=Timestamp.from_proto(b.get("time") or {}),
            next_validators_hash=b.get("next_validators_hash", b""),
            proposer_address=b.get("proposer_address", b""))
    if "process_proposal" in d:
        b = d["process_proposal"]
        return abci.ProcessProposalRequest(
            txs=list(b.get("txs", [])),
            proposed_last_commit=_commit_info_from(
                b.get("proposed_last_commit") or {}),
            misbehavior=[_misbehavior_from(m)
                         for m in b.get("misbehavior", [])],
            hash=b.get("hash", b""), height=b.get("height", 0),
            time=Timestamp.from_proto(b.get("time") or {}),
            next_validators_hash=b.get("next_validators_hash", b""),
            proposer_address=b.get("proposer_address", b""))
    if "extend_vote" in d:
        b = d["extend_vote"]
        return abci.ExtendVoteRequest(
            hash=b.get("hash", b""), height=b.get("height", 0),
            time=Timestamp.from_proto(b.get("time") or {}),
            txs=list(b.get("txs", [])),
            proposed_last_commit=_commit_info_from(
                b.get("proposed_last_commit") or {}),
            misbehavior=[_misbehavior_from(m)
                         for m in b.get("misbehavior", [])],
            next_validators_hash=b.get("next_validators_hash", b""),
            proposer_address=b.get("proposer_address", b""))
    if "verify_vote_extension" in d:
        b = d["verify_vote_extension"]
        return abci.VerifyVoteExtensionRequest(
            hash=b.get("hash", b""),
            validator_address=b.get("validator_address", b""),
            height=b.get("height", 0),
            vote_extension=b.get("vote_extension", b""),
            non_rp_vote_extension=b.get("non_rp_vote_extension", b""))
    if "finalize_block" in d:
        b = d["finalize_block"]
        return abci.FinalizeBlockRequest(
            txs=list(b.get("txs", [])),
            decided_last_commit=_commit_info_from(
                b.get("decided_last_commit") or {}),
            misbehavior=[_misbehavior_from(m)
                         for m in b.get("misbehavior", [])],
            hash=b.get("hash", b""), height=b.get("height", 0),
            time=Timestamp.from_proto(b.get("time") or {}),
            next_validators_hash=b.get("next_validators_hash", b""),
            proposer_address=b.get("proposer_address", b""),
            syncing_to_height=b.get("syncing_to_height", 0))
    raise ABCIProtoError(f"unknown request oneof: {sorted(d)}")


# --- response conversion ----------------------------------------------------

def response_to_proto(resp: Any) -> dict:
    t = type(resp).__name__
    if t == "ExceptionResponse":
        return {"exception": {"error": resp.error}}
    if t == "EchoResponse":
        return {"echo": {"message": resp.message}}
    if t == "FlushResponse":
        return {"flush": {}}
    if t == "InfoResponse":
        return {"info": {
            "data": resp.data, "version": resp.version,
            "app_version": resp.app_version,
            "last_block_height": resp.last_block_height,
            "last_block_app_hash": resp.last_block_app_hash,
            "lane_priorities": [{"key": k, "value": v}
                                for k, v in sorted(
                                    resp.lane_priorities.items())],
            "default_lane": resp.default_lane}}
    if t == "InitChainResponse":
        return {"init_chain": {
            "consensus_params": _params_to(resp.consensus_params),
            "validators": [_val_update_to(v) for v in resp.validators],
            "app_hash": resp.app_hash}}
    if t == "QueryResponse":
        return {"query": {
            "code": resp.code, "log": resp.log, "info": resp.info,
            "index": resp.index, "key": resp.key, "value": resp.value,
            "proof_ops": resp.proof_ops, "height": resp.height,
            "codespace": resp.codespace}}
    if t == "CheckTxResponse":
        return {"check_tx": {
            "code": resp.code, "data": resp.data, "log": resp.log,
            "info": resp.info, "gas_wanted": resp.gas_wanted,
            "gas_used": resp.gas_used,
            "events": [_event_to(e) for e in resp.events],
            "codespace": resp.codespace, "lane_id": resp.lane_id,
            "recheck_keys": list(resp.recheck_keys)}}
    if t == "CommitResponse":
        return {"commit": {"retain_height": resp.retain_height}}
    if t == "ListSnapshotsResponse":
        return {"list_snapshots": {
            "snapshots": [_snapshot_to(s) for s in resp.snapshots]}}
    if t == "OfferSnapshotResponse":
        return {"offer_snapshot": {"result": resp.result}}
    if t == "LoadSnapshotChunkResponse":
        return {"load_snapshot_chunk": {"chunk": resp.chunk}}
    if t == "ApplySnapshotChunkResponse":
        return {"apply_snapshot_chunk": {
            "result": resp.result,
            "refetch_chunks": list(resp.refetch_chunks),
            "reject_senders": list(resp.reject_senders)}}
    if t == "PrepareProposalResponse":
        return {"prepare_proposal": {"txs": list(resp.txs)}}
    if t == "ProcessProposalResponse":
        return {"process_proposal": {"status": resp.status}}
    if t == "ExtendVoteResponse":
        return {"extend_vote": {
            "vote_extension": resp.vote_extension,
            "non_rp_extension": resp.non_rp_extension}}
    if t == "VerifyVoteExtensionResponse":
        return {"verify_vote_extension": {"status": resp.status}}
    if t == "FinalizeBlockResponse":
        return {"finalize_block": fbr_to_proto(resp)}
    raise ABCIProtoError(f"unknown response type {t}")


def response_from_proto(d: dict) -> Any:
    if "exception" in d:
        return abci.ExceptionResponse(error=d["exception"].get("error", ""))
    if "echo" in d:
        return abci.EchoResponse(message=d["echo"].get("message", ""))
    if "flush" in d:
        return abci.FlushResponse()
    if "info" in d:
        b = d["info"]
        return abci.InfoResponse(
            data=b.get("data", ""), version=b.get("version", ""),
            app_version=b.get("app_version", 0),
            last_block_height=b.get("last_block_height", 0),
            last_block_app_hash=b.get("last_block_app_hash", b""),
            lane_priorities={e.get("key", ""): e.get("value", 0)
                             for e in b.get("lane_priorities", [])},
            default_lane=b.get("default_lane", ""))
    if "init_chain" in d:
        b = d["init_chain"]
        return abci.InitChainResponse(
            consensus_params=_params_from(b.get("consensus_params")),
            validators=[_val_update_from(v)
                        for v in b.get("validators", [])],
            app_hash=b.get("app_hash", b""))
    if "query" in d:
        b = d["query"]
        return abci.QueryResponse(
            code=b.get("code", 0), log=b.get("log", ""),
            info=b.get("info", ""), index=b.get("index", 0),
            key=b.get("key", b""), value=b.get("value", b""),
            proof_ops=b.get("proof_ops"), height=b.get("height", 0),
            codespace=b.get("codespace", ""))
    if "check_tx" in d:
        b = d["check_tx"]
        return abci.CheckTxResponse(
            code=b.get("code", 0), data=b.get("data", b""),
            log=b.get("log", ""), info=b.get("info", ""),
            gas_wanted=b.get("gas_wanted", 0),
            gas_used=b.get("gas_used", 0),
            events=[_event_from(e) for e in b.get("events", [])],
            codespace=b.get("codespace", ""),
            lane_id=b.get("lane_id", ""),
            recheck_keys=list(b.get("recheck_keys", [])))
    if "commit" in d:
        return abci.CommitResponse(
            retain_height=d["commit"].get("retain_height", 0))
    if "list_snapshots" in d:
        return abci.ListSnapshotsResponse(
            snapshots=[_snapshot_from(s)
                       for s in d["list_snapshots"].get("snapshots", [])])
    if "offer_snapshot" in d:
        return abci.OfferSnapshotResponse(
            result=d["offer_snapshot"].get("result", 0))
    if "load_snapshot_chunk" in d:
        return abci.LoadSnapshotChunkResponse(
            chunk=d["load_snapshot_chunk"].get("chunk", b""))
    if "apply_snapshot_chunk" in d:
        b = d["apply_snapshot_chunk"]
        return abci.ApplySnapshotChunkResponse(
            result=b.get("result", 0),
            refetch_chunks=list(b.get("refetch_chunks", [])),
            reject_senders=list(b.get("reject_senders", [])))
    if "prepare_proposal" in d:
        return abci.PrepareProposalResponse(
            txs=list(d["prepare_proposal"].get("txs", [])))
    if "process_proposal" in d:
        return abci.ProcessProposalResponse(
            status=d["process_proposal"].get("status", 0))
    if "extend_vote" in d:
        b = d["extend_vote"]
        return abci.ExtendVoteResponse(
            vote_extension=b.get("vote_extension", b""),
            non_rp_extension=b.get("non_rp_extension", b""))
    if "verify_vote_extension" in d:
        return abci.VerifyVoteExtensionResponse(
            status=d["verify_vote_extension"].get("status", 0))
    if "finalize_block" in d:
        return fbr_from_proto(d["finalize_block"])
    raise ABCIProtoError(f"unknown response oneof: {sorted(d)}")


# --- length-delimited framing ----------------------------------------------
# Reference: abci/types/messages.go WriteMessage — uvarint length prefix.

MAX_MSG_SIZE = 104_857_600          # 100 MB, reference socket server cap


def encode_request_frame(req: Any) -> bytes:
    payload = encode(abci_pb.REQUEST, request_to_proto(req))
    return encode_uvarint(len(payload)) + payload


def encode_response_frame(resp: Any) -> bytes:
    payload = encode(abci_pb.RESPONSE, response_to_proto(resp))
    return encode_uvarint(len(payload)) + payload


def decode_request(payload: bytes) -> Any:
    return request_from_proto(decode(abci_pb.REQUEST, payload))


def decode_response(payload: bytes) -> Any:
    return response_from_proto(decode(abci_pb.RESPONSE, payload))
