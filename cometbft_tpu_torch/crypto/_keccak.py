"""Legacy Keccak-256 (pre-NIST padding), as used by Ethereum addresses.

From-scratch Keccak-f[1600] sponge over the public FIPS-202 permutation
with the ORIGINAL Keccak domain padding (0x01), which differs from NIST
SHA3-256's 0x06 — hashlib.sha3_256 therefore cannot be used here.
Reference consumer: crypto/secp256k1eth (go-ethereum crypto.Keccak256).
The port's copy of cometbft_tpu/crypto/_keccak.py.
"""
from __future__ import annotations

_ROUNDS = 24
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_MASK = (1 << 64) - 1


def _rol(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _MASK


def _keccak_f(state: list[int]) -> None:
    """In-place Keccak-f[1600] on a 5x5 lane list (index x*5+y)."""
    for rnd in range(_ROUNDS):
        # theta
        c = [state[x * 5] ^ state[x * 5 + 1] ^ state[x * 5 + 2] ^
             state[x * 5 + 3] ^ state[x * 5 + 4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                state[x * 5 + y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y * 5 + (2 * x + 3 * y) % 5] = _rol(
                    state[x * 5 + y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                state[x * 5 + y] = b[x * 5 + y] ^ (
                    (~b[(x + 1) % 5 * 5 + y]) & b[(x + 2) % 5 * 5 + y]
                ) & _MASK
        # iota
        state[0] ^= _RC[rnd]


def keccak256(data: bytes) -> bytes:
    """Legacy Keccak-256: rate 136 bytes, padding 0x01...0x80."""
    rate = 136
    state = [0] * 25
    # pad
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" \
        if pad_len >= 2 else b"\x81"
    # absorb
    for off in range(0, len(padded), rate):
        block = padded[off:off + rate]
        for i in range(rate // 8):
            lane = int.from_bytes(block[i * 8:(i + 1) * 8], "little")
            x, y = i % 5, i // 5
            state[x * 5 + y] ^= lane
        _keccak_f(state)
    # squeeze 32 bytes
    out = b""
    for i in range(4):
        x, y = i % 5, i // 5
        out += state[x * 5 + y].to_bytes(8, "little")
    return out
