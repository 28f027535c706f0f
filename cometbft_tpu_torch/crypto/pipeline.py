"""Tile plan for large verification batches.

Reference: crypto/pipeline.py tile_plan/tile_size.  Tiles run one after
another on the current CUDA stream; overlapping host prep of tile i+1
with the kernel of tile i on separate streams is not ported yet.
"""
from __future__ import annotations

# a pad-bucket shape (ops/ed25519._BASE_BUCKETS)
DEFAULT_TILE = 4096


def tile_plan(n: int, tile: int = DEFAULT_TILE) -> list[tuple[int, int]]:
    """[(start, end), ...] covering n lanes in BALANCED slices of at
    most ``tile`` lanes: 10k at tile 4096 plans three ~3334-lane
    tiles, not 4096+4096+1808."""
    if n <= 0:
        return []
    ntiles = -(-n // tile)
    size = -(-n // ntiles)
    return [(s, min(s + size, n)) for s in range(0, n, size)]
