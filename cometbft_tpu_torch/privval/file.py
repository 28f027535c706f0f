"""FilePV: file-backed validator signer with double-sign protection.

Reference: privval/file.go — persisted last-signed HRS state (:100
CheckHRS), sign-vote (:281/:332) with the same-HRS recovery rules
(identical sign-bytes reuse the signature; timestamp-only differences
reuse signature + old timestamp; anything else is a double-sign
attempt), fsync'd state file before every signature leaves the process.

A copy of cometbft_tpu/privval/file.py: the same key and state files,
byte for byte, for the same key and sign history, and the same texts.
Keys sign through the port's key types, so ed25519 signs on the host
library (ops/ed25519_host.py); nothing here touches the card.
"""
from __future__ import annotations

import base64
import json
import os
from dataclasses import dataclass
from typing import Optional

from ..crypto import ed25519
from ..crypto import encoding as crypto_encoding
from ..crypto.keys import PrivKey, PubKey
from ..types import canonical
from ..types.priv_validator import PrivValidator
from ..types.proposal import Proposal
from ..types.timestamp import Timestamp
from ..types.vote import Vote
from ..wire import pb, unmarshal_delimited

# amino-JSON type names (single registry: crypto/encoding.py)
_AMINO_NAMES = {
    kt: (crypto_encoding.AMINO_PUBKEY_NAMES[kt],
         crypto_encoding.AMINO_PRIVKEY_NAMES[kt])
    for kt in crypto_encoding.AMINO_PUBKEY_NAMES
}
_KEY_TYPE_BY_PRIV_NAME = {v[1]: k for k, v in _AMINO_NAMES.items()}

# sign step (reference: privval/file.go stepPropose/Prevote/Precommit)
STEP_PROPOSE = 1
STEP_PREVOTE = 2
STEP_PRECOMMIT = 3

_STEP_BY_VOTE_TYPE = {
    canonical.PREVOTE_TYPE: STEP_PREVOTE,
    canonical.PRECOMMIT_TYPE: STEP_PRECOMMIT,
}


class PrivValidatorError(Exception):
    pass


class DoubleSignError(PrivValidatorError):
    pass


@dataclass
class LastSignState:
    height: int = 0
    round: int = 0
    step: int = 0
    signature: bytes = b""
    sign_bytes: bytes = b""

    def check_hrs(self, height: int, round_: int,
                  step: int) -> bool:
        """True when (height, round, step) matches the last signed HRS;
        raises on regression (reference: CheckHRS :100)."""
        if self.height > height:
            raise DoubleSignError(
                f"height regression: got {height}, last {self.height}")
        if self.height != height:
            return False
        if self.round > round_:
            raise DoubleSignError(
                f"round regression at height {height}: got {round_}, "
                f"last {self.round}")
        if self.round != round_:
            return False
        if self.step > step:
            raise DoubleSignError(
                f"step regression at {height}/{round_}: got {step}, "
                f"last {self.step}")
        if self.step < step:
            return False
        if not self.sign_bytes:
            raise PrivValidatorError("no SignBytes found")
        if not self.signature:
            raise PrivValidatorError(
                "signature is empty but sign bytes are not")
        return True

    def to_json(self) -> dict:
        return {
            "height": str(self.height),
            "round": self.round,
            "step": self.step,
            "signature": base64.b64encode(self.signature).decode()
            if self.signature else "",
            "signbytes": self.sign_bytes.hex().upper()
            if self.sign_bytes else "",
        }

    @classmethod
    def from_json(cls, d: dict) -> "LastSignState":
        return cls(
            height=int(d.get("height", 0)),
            round=int(d.get("round", 0)),
            step=int(d.get("step", 0)),
            signature=base64.b64decode(d["signature"])
            if d.get("signature") else b"",
            sign_bytes=bytes.fromhex(d["signbytes"])
            if d.get("signbytes") else b"",
        )


class FilePV(PrivValidator):
    def __init__(self, priv_key: PrivKey, key_file_path: str,
                 state_file_path: str,
                 last_sign_state: Optional[LastSignState] = None):
        self.priv_key = priv_key
        self.key_file_path = key_file_path
        self.state_file_path = state_file_path
        self.last_sign_state = last_sign_state or LastSignState()

    # ------------------------------------------------------------------
    @classmethod
    def generate(cls, key_file_path: str, state_file_path: str,
                 key_type: str = ed25519.KEY_TYPE) -> "FilePV":
        """Reference: privval.GenFilePV with keytypes registry (testnet
        --key-type flag)."""
        pv = cls(crypto_encoding.gen_priv_key_by_type(key_type),
                 key_file_path, state_file_path)
        pv.save()
        return pv

    @classmethod
    def load(cls, key_file_path: str,
             state_file_path: str) -> "FilePV":
        with open(key_file_path) as f:
            kd = json.load(f)
        amino_name = kd["priv_key"].get("type",
                                        "tendermint/PrivKeyEd25519")
        key_type = _KEY_TYPE_BY_PRIV_NAME.get(amino_name)
        if key_type is None:
            raise PrivValidatorError(
                f"unknown priv_key type {amino_name!r}")
        priv = crypto_encoding.priv_key_from_type_and_bytes(
            key_type, base64.b64decode(kd["priv_key"]["value"]))
        lss = LastSignState()
        if os.path.exists(state_file_path):
            with open(state_file_path) as f:
                lss = LastSignState.from_json(json.load(f))
        return cls(priv, key_file_path, state_file_path, lss)

    @classmethod
    def load_or_generate(cls, key_file_path: str, state_file_path: str,
                         key_type: str = ed25519.KEY_TYPE) -> "FilePV":
        if os.path.exists(key_file_path):
            return cls.load(key_file_path, state_file_path)
        return cls.generate(key_file_path, state_file_path, key_type)

    def save(self) -> None:
        pub = self.priv_key.pub_key()
        os.makedirs(os.path.dirname(self.key_file_path) or ".",
                    exist_ok=True)
        with open(self.key_file_path, "w") as f:
            json.dump({
                "address": pub.address().hex().upper(),
                "pub_key": {"type": _AMINO_NAMES[pub.type()][0],
                            "value": base64.b64encode(
                                pub.bytes()).decode()},
                "priv_key": {"type": _AMINO_NAMES[pub.type()][1],
                             "value": base64.b64encode(
                                 self.priv_key.bytes()).decode()},
            }, f, indent=2)
        os.chmod(self.key_file_path, 0o600)  # private key: owner-only
        self._save_state()

    def _save_state(self) -> None:
        """Durably record the last-signed state BEFORE the signature can
        leave the process (the double-sign barrier)."""
        os.makedirs(os.path.dirname(self.state_file_path) or ".",
                    exist_ok=True)
        tmp = self.state_file_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.last_sign_state.to_json(), f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.state_file_path)
        os.chmod(self.state_file_path, 0o600)

    # ------------------------------------------------------------------
    def get_pub_key(self) -> PubKey:
        return self.priv_key.pub_key()

    def sign_vote(self, chain_id: str, vote: Vote,
                  sign_extension: bool) -> None:
        """Reference: signVote (:332)."""
        height, round_ = vote.height, vote.round
        step = _STEP_BY_VOTE_TYPE.get(vote.type)
        if step is None:
            raise PrivValidatorError(f"unknown vote type {vote.type}")
        lss = self.last_sign_state
        same_hrs = lss.check_hrs(height, round_, step)
        sign_bytes = vote.sign_bytes(chain_id)

        if sign_extension:
            if vote.type == canonical.PRECOMMIT_TYPE and \
                    not vote.block_id.is_nil():
                # extensions are non-deterministic; always re-sign them
                vote.extension_signature = self.priv_key.sign(
                    vote.extension_sign_bytes(chain_id))
                vote.non_rp_extension_signature = self.priv_key.sign(
                    vote.non_rp_extension_sign_bytes())
            elif vote.extension or vote.non_rp_extension:
                raise PrivValidatorError(
                    "unexpected vote extension on non-nil-precommit")

        if same_hrs:
            # crashed between signing and WAL write: recover
            if sign_bytes == lss.sign_bytes:
                vote.signature = lss.signature
                return
            ts = _votes_differ_only_by_timestamp(lss.sign_bytes,
                                                 sign_bytes)
            if ts is not None:
                vote.timestamp = ts
                vote.signature = lss.signature
                return
            raise DoubleSignError(
                f"conflicting vote data at {height}/{round_}/{step}")

        sig = self.priv_key.sign(sign_bytes)
        self.last_sign_state = LastSignState(
            height=height, round=round_, step=step, signature=sig,
            sign_bytes=sign_bytes)
        self._save_state()
        vote.signature = sig

    def sign_proposal(self, chain_id: str,
                      proposal: Proposal) -> None:
        """Reference: signProposal."""
        height, round_ = proposal.height, proposal.round
        lss = self.last_sign_state
        same_hrs = lss.check_hrs(height, round_, STEP_PROPOSE)
        sign_bytes = proposal.sign_bytes(chain_id)

        if same_hrs:
            if sign_bytes == lss.sign_bytes:
                proposal.signature = lss.signature
                return
            ts = _proposals_differ_only_by_timestamp(lss.sign_bytes,
                                                     sign_bytes)
            if ts is not None:
                proposal.timestamp = ts
                proposal.signature = lss.signature
                return
            raise DoubleSignError(
                f"conflicting proposal data at {height}/{round_}")

        sig = self.priv_key.sign(sign_bytes)
        self.last_sign_state = LastSignState(
            height=height, round=round_, step=STEP_PROPOSE,
            signature=sig, sign_bytes=sign_bytes)
        self._save_state()
        proposal.signature = sig

    def sign_bytes(self, msg: bytes) -> bytes:
        return self.priv_key.sign(msg)

    def reset(self) -> None:
        """Danger: wipes double-sign protection (reference:
        unsafe_reset_priv_validator)."""
        self.last_sign_state = LastSignState()
        self._save_state()


def _strip_timestamp(desc, raw: bytes, ts_field: str):
    """Decode a canonical sign-bytes message and return (fields minus
    timestamp, timestamp)."""
    d, _ = unmarshal_delimited(desc, raw)
    ts = d.pop(ts_field, None)
    return d, ts


def _votes_differ_only_by_timestamp(last: bytes,
                                    new: bytes) -> Optional[Timestamp]:
    """Reference: checkVotesOnlyDifferByTimestamp — returns the LAST
    timestamp when everything else matches."""
    try:
        d1, ts1 = _strip_timestamp(pb.CANONICAL_VOTE, last, "timestamp")
        d2, _ = _strip_timestamp(pb.CANONICAL_VOTE, new, "timestamp")
    except Exception:
        return None
    if d1 == d2 and ts1 is not None:
        return Timestamp.from_proto(ts1)
    return None


def _proposals_differ_only_by_timestamp(last: bytes, new: bytes
                                        ) -> Optional[Timestamp]:
    try:
        d1, ts1 = _strip_timestamp(pb.CANONICAL_PROPOSAL, last,
                                   "timestamp")
        d2, _ = _strip_timestamp(pb.CANONICAL_PROPOSAL, new,
                                 "timestamp")
    except Exception:
        return None
    if d1 == d2 and ts1 is not None:
        return Timestamp.from_proto(ts1)
    return None
