"""Splitting a verification batch over every visible card, and the tally.

Counterpart of cometbft_tpu/parallel/mesh.py.  Reference parallelism
(SURVEY §2.11): the reference's batch verifier
(crypto/ed25519/ed25519.go:189-222) is single-host; here a large batch
splits data-parallel over the cards of one host, and the vote tally
reduces with one all_reduce.  Validators are WAN peers, so the cards
live inside one node; p2p traffic never touches NVLink.

  * ``make_mesh`` lists the first *n* CUDA devices (``device="cpu"``
    gives *n* CPU entries, for the tests).
  * ``PipelinePartitioner`` pads a batch to equal shards, each a whole
    number of B1 blocks (``LANES_PER_BLOCK``), and sends each shard to
    its card's side stream through ``ops/ed25519._dispatch``: one B1
    launch a shard.  It is the explicit multi-card API:
    ``ops/ed25519.verify_batch`` keeps each tile on one card.
  * ``verify_sharded`` returns the exact mask of the original lanes;
    the caller masks pre-bad lanes, as in the JAX package.
  * ``sharded_verify_tally`` runs one step on each ``torch.distributed``
    rank: its shard's mask, and the valid count summed with exactly one
    ``all_reduce`` (NCCL on the card, gloo on the CPU) — the psum of the
    JAX step.  The mask needs no collective.

``collectives`` counts the collectives this module issues, by kind.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..device import resolve

# B1 launches 64-thread blocks, four threads a signature: a shard of a
# multiple of 16 lanes ends on a whole block
LANES_PER_BLOCK = 16

# collectives issued by this module, by kind (the verify path issues
# none; each tally step one all_reduce)
collectives: dict[str, int] = {"all_reduce": 0}


def make_mesh(n_devices: Optional[int] = None,
              device=None) -> list[torch.device]:
    """The first ``n_devices`` CUDA devices (all of them for None).
    ``device="cpu"`` gives ``n_devices`` (default 1) CPU entries, and a
    numbered card (``"cuda:1"``) that card ``n_devices`` times.  Without
    CUDA and without ``device="cpu"`` it raises."""
    dev = resolve(device)
    if dev.type == "cpu" or dev.index is not None:
        return [dev] * (n_devices or 1)
    count = torch.cuda.device_count()
    if n_devices is not None and count < n_devices:
        raise ValueError(
            f"requested {n_devices}-device mesh but only {count} CUDA "
            f"devices are available")
    return [torch.device("cuda", i) for i in range(n_devices or count)]


def padded_lanes(m: int, ndev: int, block: int = LANES_PER_BLOCK) -> int:
    """m lanes padded to ndev equal shards of whole ``block``s."""
    shard = -(-m // ndev)
    if block:
        shard = -(-shard // block) * block
    return shard * ndev


class ShardedDispatch:
    """The shards of one dispatch, in lane order: each shard's verdicts
    on the host and its event (None on the CPU).  ``synchronize`` waits
    for every shard; ``numpy`` joins the verdicts, padding included."""

    def __init__(self, parts: list, wires: list):
        self.parts = parts
        # each shard's host block, held until the shards are settled
        self._wires = wires

    def synchronize(self) -> None:
        for _ok, event in self.parts:
            if event is not None:
                event.synchronize()

    def numpy(self) -> np.ndarray:
        return np.concatenate([ok.numpy() for ok, _ in self.parts])


class PipelinePartitioner:
    """The devices, their side streams and the shard arithmetic of a
    pipeline, resolved once; each tile then costs one host copy of its
    rows into a block a shard and one launch a shard."""

    def __init__(self, ndev: int, device=None):
        self.ndev = ndev
        self.block = LANES_PER_BLOCK
        self.devices = make_mesh(ndev, device)

    def _padded(self, m: int) -> int:
        return padded_lanes(m, self.ndev, self.block)

    def dispatch(self, kernel, a_b, r_b, s_w8, k_w8) -> ShardedDispatch:
        """Send the m lanes' rows (a_b, r_b [m, 32], s_w8, k_w8 [m, 64]
        uint8, numpy or host tensors) to ``kernel`` in ``ndev`` equal
        shards, zero padding lanes last; returns without waiting."""
        from ..ops import ed25519 as oe
        rows = [torch.as_tensor(x) for x in (a_b, r_b, s_w8, k_w8)]
        m = rows[0].shape[0]
        shard = self._padded(m) // self.ndev
        parts, wires = [], []
        for i, dev in enumerate(self.devices):
            lo, hi = min(i * shard, m), min((i + 1) * shard, m)
            cuda = dev.type == "cuda"
            wire = torch.zeros(oe._WIRE * shard, dtype=torch.uint8,
                               pin_memory=cuda)
            at = 0
            for r in rows:
                w = r.shape[1]
                wire[at * shard:at * shard + (hi - lo) * w] = \
                    r[lo:hi].reshape(-1)
                at += w
            stream = oe._side_stream(dev) if cuda else None
            parts.append(oe._dispatch(kernel, wire, shard, dev, stream))
            wires.append(wire)
        return ShardedDispatch(parts, wires)


@functools.lru_cache(maxsize=None)
def _partitioner(ndev: int, device: str) -> PipelinePartitioner:
    return PipelinePartitioner(ndev, None if device == "cuda" else device)


def pipeline_partitioner(ndev: int, device=None) -> PipelinePartitioner:
    """Cached partitioner per (ndev, device): the once-per-pipeline
    setup amortizes to once per process."""
    return _partitioner(ndev, "cuda" if device is None else str(device))


def _kernel(kernel):
    from ..ops import ed25519 as oe
    return kernel if kernel is not None else oe.KERNELS[oe._kernel_choice()]


def verify_sharded(a_b, r_b, s_w8, k_w8, *, ndev: Optional[int] = None,
                   device=None, kernel=None) -> np.ndarray:
    """Data-parallel batch verify over ``ndev`` devices (all visible
    cards for None).  Pads the lane count so every shard is equal and a
    whole number of B1 blocks; padding lanes are sliced off and the
    caller masks pre-bad lanes itself.  Returns the exact per-lane mask
    of the original m lanes.  ``kernel`` is a kernel module (default:
    the one ``COMETBFT_TPU_TORCH_KERNEL`` names)."""
    m = np.asarray(a_b).shape[0]
    if ndev is None:
        ndev = len(make_mesh(None, device))
    part = pipeline_partitioner(ndev, device)
    sd = part.dispatch(_kernel(kernel), a_b, r_b, s_w8, k_w8)
    sd.synchronize()
    return sd.numpy()[:m].copy()


def sharded_verify_tally(group=None, device=None, kernel=None):
    """The multi-card step for ``torch.distributed`` (the default group
    for None): fn(a_b, r_b, s_w8, k_w8, pre_bad=None) -> (ok, count).
    Every rank passes the whole batch (n a multiple of the group's
    size), verifies its own shard on ``device`` (None: the card of its
    rank) and returns its shard's mask and the valid count of the whole
    batch, summed with one all_reduce.  ``pre_bad`` [n] bool, when
    given, masks the lanes the prep rejected before they are counted.

    Voting-power totals stay on the host from the exact per-lane mask:
    validator powers are int64 (total capped at MaxInt64/8,
    types/validator_set.go)."""
    import torch.distributed as dist

    def step(a_b, r_b, s_w8, k_w8, pre_bad=None):
        world = dist.get_world_size(group)
        rank = dist.get_rank(group)
        n = np.asarray(a_b).shape[0]
        if n % world:
            raise ValueError(f"{n} lanes do not split over {world} ranks")
        shard = n // world
        lo, hi = rank * shard, (rank + 1) * shard
        if device is None:
            resolve(None)          # the card: raises without CUDA
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        else:
            dev = resolve(device)
        ok = verify_sharded(*(np.asarray(x)[lo:hi]
                              for x in (a_b, r_b, s_w8, k_w8)),
                            ndev=1, device=dev, kernel=kernel)
        if pre_bad is not None:
            ok &= ~np.asarray(pre_bad, bool)[lo:hi]
        on = dev if dist.get_backend(group) == "nccl" else "cpu"
        count = torch.tensor([int(ok.sum())], dtype=torch.int64, device=on)
        dist.all_reduce(count, op=dist.ReduceOp.SUM, group=group)
        collectives["all_reduce"] += 1
        return ok, int(count.item())

    return step
