"""Mempool gossip messages: flood txs + have/want reconciliation.

Wire: cometbft.mempool.v2.Message extends the reference Txs oneof with
two reconciliation arms (docs/gossip.md):

  * TxHave — "here is what I hold": a batch of short salted tx-hash
    ids.  Ids are the first ``SHORT_ID_LEN`` bytes of
    ``sha256(salt || tx_key)`` and ride as ONE concatenated bytes blob
    (no per-id tag/length overhead: 256 ids = 2 KiB + envelope).
  * TxWant — "send me these": the subset of a peer's advertised ids
    the receiver could not resolve against its pool + dedup cache.

The salt is carried explicitly so receivers can diff against ANY
advertiser.  Policy (reactor.py) derives it from the chain height
epoch, so nodes near the same height agree on it and short ids stay
comparable across peers — that is what lets the in-flight want
tracker dedup pulls of the same tx from many advertisers.  An
engineered 2^32-work collision only suppresses a pull under ONE salt:
epoch rotation, per-summary self-collision rotation (the sender
re-salts a batch whose own ids collide), and the compact-block /
full-part fallback all bound the damage to a delay.

Old peers negotiate none of this: the capability string
``txrecon/1`` must appear in both handshake NodeInfos or the link
speaks plain flooded Txs.

The port's copy of cometbft_tpu/mempool/messages.py: the same bytes.  The
JAX package hashes many short ids through its native sha256 path
(``batched_hashes``); the port hashes them with hashlib, as it does its
other hashes.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..wire.proto import F, Msg, decode, encode

FEATURE_TXRECON = "txrecon/1"

# bytes per short id: 8 bytes keeps the natural collision rate at
# ~n^2/2^65 (immeasurable at any real pool size) while an advert
# costs 1/32nd of the raw txs it summarizes at 256 B/tx
SHORT_ID_LEN = 8

TXS = Msg("cometbft.mempool.v2.Txs",
          F(1, "txs", "bytes", repeated=True))
TX_HAVE = Msg("cometbft.mempool.v2.TxHave",
              F(1, "salt", "bytes"),
              F(2, "ids", "bytes"))
TX_WANT = Msg("cometbft.mempool.v2.TxWant",
              F(1, "salt", "bytes"),
              F(2, "ids", "bytes"))
MESSAGE = Msg("cometbft.mempool.v2.Message",
              F(1, "txs", "msg", msg=TXS),
              F(2, "tx_have", "msg", msg=TX_HAVE),
              F(3, "tx_want", "msg", msg=TX_WANT))


@dataclass
class TxsMessage:
    txs: list

    TYPE = "txs"


@dataclass
class TxHaveMessage:
    salt: bytes
    ids: list          # list[bytes], each SHORT_ID_LEN long

    TYPE = "tx_have"


@dataclass
class TxWantMessage:
    salt: bytes
    ids: list

    TYPE = "tx_want"


def short_id(salt: bytes, key: bytes) -> bytes:
    """One short salted id (the bulk path is short_ids)."""
    return hashlib.sha256(salt + key).digest()[:SHORT_ID_LEN]


def short_ids(salt: bytes, keys: list) -> list:
    """Short ids for many tx keys."""
    return [hashlib.sha256(salt + k).digest()[:SHORT_ID_LEN]
            for k in keys]


def _split_ids(blob: bytes) -> list:
    n = len(blob) // SHORT_ID_LEN
    return [blob[i * SHORT_ID_LEN:(i + 1) * SHORT_ID_LEN]
            for i in range(n)]


def encode_mempool(msg) -> bytes:
    if isinstance(msg, TxsMessage):
        d = {"txs": {"txs": list(msg.txs)}}
    elif isinstance(msg, TxHaveMessage):
        d = {"tx_have": {"salt": msg.salt,
                         "ids": b"".join(msg.ids)}}
    elif isinstance(msg, TxWantMessage):
        d = {"tx_want": {"salt": msg.salt,
                         "ids": b"".join(msg.ids)}}
    else:
        raise ValueError(f"cannot encode mempool message {type(msg)}")
    return encode(MESSAGE, d)


def decode_mempool(raw: bytes):
    d = decode(MESSAGE, raw)
    if "txs" in d:
        return TxsMessage(txs=list(d["txs"].get("txs", [])))
    if "tx_have" in d:
        n = d["tx_have"]
        return TxHaveMessage(salt=n.get("salt", b""),
                             ids=_split_ids(n.get("ids", b"")))
    if "tx_want" in d:
        n = d["tx_want"]
        return TxWantMessage(salt=n.get("salt", b""),
                             ids=_split_ids(n.get("ids", b"")))
    raise ValueError(f"unknown mempool message {sorted(d)}")
