"""SecretConnection: authenticated encryption for peer links.

Reference: p2p/transport/tcp/conn/secret_connection.go:67,101 — STS-style
handshake: X25519 ECDH → KDF → ChaCha20-Poly1305 AEAD with counter
nonces, then an ed25519 proof of the node identity over a handshake
challenge.  The reference derives the challenge with a merlin/STROBE
transcript; here the transcript hash is HKDF-SHA256 over the same inputs
(ephemeral keys sorted lexicographically + DH secret) — equivalent
binding, not wire-compatible with Go peers by design.

The port's copy of cometbft_tpu/p2p/secret_connection.py: the same HKDF
info string and salt order, the same 1,024-byte data and 1,044-byte
sealed frames, the same little-endian 96-bit counter nonces and the
same error texts, so a port peer and a JAX peer complete the handshake
with each other.  Where the JAX package takes the ``cryptography``
package's OpenSSL or, without it, its Python X25519 and HKDF and the
reference's native AEAD, the port takes one path: X25519 and HKDF in
Python (crypto/_aead_ref.py; twice a connection) and every frame's seal
and open in the host library (ops/aead_host.py), which raises if it
cannot be built or fails its self-test.
"""
from __future__ import annotations

import asyncio
import struct

from ..crypto import _aead_ref
from ..crypto import ed25519
from ..crypto.keys import PrivKey, PubKey
from ..ops.aead_host import ChaCha20Poly1305

DATA_LEN_SIZE = 4
DATA_MAX_SIZE = 1024
TOTAL_FRAME_SIZE = DATA_MAX_SIZE + DATA_LEN_SIZE
AEAD_TAG_SIZE = 16
SEALED_FRAME_SIZE = TOTAL_FRAME_SIZE + AEAD_TAG_SIZE
_NONCE_SIZE = 12

_HKDF_INFO = b"CMT_TPU_SECRET_CONNECTION_KEY_AND_CHALLENGE_GEN"


class SecretConnectionError(Exception):
    pass


class AuthFailureError(SecretConnectionError):
    pass


def _derive(dh_secret: bytes, lo: bytes, hi: bytes,
            loc_is_least: bool) -> tuple[bytes, bytes, bytes]:
    """(recv_secret, send_secret, challenge) — reference:
    deriveSecrets + transcript challenge extraction."""
    okm = _aead_ref.hkdf_sha256(dh_secret, lo + hi, _HKDF_INFO, 96)
    s1, s2, challenge = okm[:32], okm[32:64], okm[64:]
    if loc_is_least:
        return s2, s1, challenge   # recv, send
    return s1, s2, challenge


def _dh(priv: bytes, rem_pub: bytes) -> bytes:
    out = _aead_ref.x25519(priv, rem_pub)
    if out == bytes(32):
        # OpenSSL's contributory-behavior check: a small-order peer
        # point yields the all-zero secret, which would let an active
        # attacker fix the connection's keys
        raise SecretConnectionError(
            "x25519: low-order peer public key")
    return out


class SecretConnection:
    """Frames every write into fixed-size sealed chunks so traffic
    analysis sees uniform ciphertext (reference: fixed 1044-byte sealed
    frames)."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter,
                 send_aead: ChaCha20Poly1305,
                 recv_aead: ChaCha20Poly1305,
                 remote_pub_key: PubKey):
        self._reader = reader
        self._writer = writer
        self._send_aead = send_aead
        self._recv_aead = recv_aead
        self._send_nonce = 0
        self._recv_nonce = 0
        self._recv_buffer = b""
        self.remote_pub_key = remote_pub_key

    # ------------------------------------------------------------------
    @classmethod
    async def make(cls, reader: asyncio.StreamReader,
                   writer: asyncio.StreamWriter,
                   loc_priv_key: PrivKey) -> "SecretConnection":
        """The 2-round handshake (reference: MakeSecretConnection)."""
        eph_priv, eph_pub = _aead_ref.x25519_keypair()

        # 1) exchange ephemeral pubkeys in the clear
        writer.write(eph_pub)
        await writer.drain()
        rem_eph_pub = await reader.readexactly(32)

        lo, hi = sorted([eph_pub, rem_eph_pub])
        loc_is_least = eph_pub == lo
        dh_secret = _dh(eph_priv, rem_eph_pub)
        recv_secret, send_secret, challenge = _derive(
            dh_secret, lo, hi, loc_is_least)

        sc = cls(reader, writer, ChaCha20Poly1305(send_secret),
                 ChaCha20Poly1305(recv_secret), remote_pub_key=None)

        # 2) prove identity: send (pubkey || sig(challenge)) encrypted
        loc_pub = loc_priv_key.pub_key()
        sig = loc_priv_key.sign(challenge)
        await sc.write_msg(loc_pub.bytes() + sig)
        auth = await sc.read_msg()
        if len(auth) != 32 + 64:
            raise AuthFailureError("malformed auth message")
        rem_pub = ed25519.Ed25519PubKey(auth[:32])
        if not rem_pub.verify_signature(challenge, auth[32:]):
            raise AuthFailureError("challenge verification failed")
        sc.remote_pub_key = rem_pub
        return sc

    # ------------------------------------------------------------------
    def _next_nonce(self, recv: bool) -> bytes:
        if recv:
            n = self._recv_nonce
            self._recv_nonce += 1
        else:
            n = self._send_nonce
            self._send_nonce += 1
        if n >= 1 << 95:
            raise SecretConnectionError("nonce overflow")
        return n.to_bytes(_NONCE_SIZE, "little")

    def _seal_chunk(self, chunk: bytes) -> bytes:
        frame = struct.pack("<I", len(chunk)) + chunk
        frame = frame.ljust(TOTAL_FRAME_SIZE, b"\x00")
        return self._send_aead.encrypt(
            self._next_nonce(recv=False), frame, None)

    async def write_msg(self, data: bytes) -> None:
        """Write one message: full chunks then a terminating short
        (possibly empty) chunk, so read_msg always sees the boundary."""
        view = memoryview(data)
        while len(view) >= DATA_MAX_SIZE:
            self._writer.write(self._seal_chunk(bytes(
                view[:DATA_MAX_SIZE])))
            view = view[DATA_MAX_SIZE:]
        self._writer.write(self._seal_chunk(bytes(view)))
        await self._writer.drain()

    async def _read_frame(self) -> bytes:
        sealed = await self._reader.readexactly(SEALED_FRAME_SIZE)
        frame = self._recv_aead.decrypt(
            self._next_nonce(recv=True), sealed, None)
        ln = struct.unpack("<I", frame[:DATA_LEN_SIZE])[0]
        if ln > DATA_MAX_SIZE:
            raise SecretConnectionError(f"frame length {ln} too large")
        return frame[DATA_LEN_SIZE:DATA_LEN_SIZE + ln]

    async def read_chunk(self) -> bytes:
        """One decrypted chunk (up to 1024 bytes) — MConnection packets
        are framed inside these."""
        return await self._read_frame()

    async def read_msg(self) -> bytes:
        """Read one full-frame message written by write_msg: reads
        frames until a non-full chunk terminates the message."""
        out = bytearray()
        while True:
            chunk = await self._read_frame()
            out += chunk
            if len(chunk) < DATA_MAX_SIZE:
                return bytes(out)

    def close(self) -> None:
        try:
            self._writer.close()
        except Exception:
            pass
