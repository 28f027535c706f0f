"""Node identity: ed25519 node key; ID = hex(address).

Reference: p2p/internal/nodekey/ (node_key.go) — ID is the hex-encoded
20-byte address of the node pubkey — through cometbft_tpu/p2p/key.py,
with the same JSON file.
"""
from __future__ import annotations

import base64
import json
import os
from dataclasses import dataclass

from ..crypto import ed25519
from ..crypto.keys import PrivKey, PubKey


def node_id_from_pub_key(pub_key: PubKey) -> str:
    return pub_key.address().hex()


@dataclass
class NodeKey:
    priv_key: PrivKey

    @property
    def id(self) -> str:
        return node_id_from_pub_key(self.priv_key.pub_key())

    def pub_key(self) -> PubKey:
        return self.priv_key.pub_key()

    @classmethod
    def generate(cls) -> "NodeKey":
        return cls(priv_key=ed25519.gen_priv_key())

    def save_as(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({
                "priv_key": {
                    "type": "tendermint/PrivKeyEd25519",
                    "value": base64.b64encode(
                        self.priv_key.bytes()).decode(),
                }
            }, f, indent=2)
        os.chmod(path, 0o600)   # private key: owner-only

    @classmethod
    def load(cls, path: str) -> "NodeKey":
        with open(path) as f:
            d = json.load(f)
        raw = base64.b64decode(d["priv_key"]["value"])
        return cls(priv_key=ed25519.Ed25519PrivKey(raw))

    @classmethod
    def load_or_gen(cls, path: str) -> "NodeKey":
        if os.path.exists(path):
            return cls.load(path)
        nk = cls.generate()
        nk.save_as(path)
        return nk
