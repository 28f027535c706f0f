"""Driver ``commit_serial``: one caller in a closed loop checks whole
commits, one call after another, over a pool of heights.

The program is ``cometbft_tpu_torch``.  The mix names its entry in
``cometbft_tpu_torch.types.validation`` (``entry``); every call is
``entry(chain_id, vals, block_id, height, commit, device=device)`` with
no signature cache.  Each call gets a new ``Commit`` over the pool
height's signatures, made before its clock starts, so nothing a commit
object memoises carries from one call to the next, as a node receives
each commit anew.  The inputs come from ``portbench.generator``; the
plain reference is the module the configuration names
(``reference/<name>.py``).

In the window only the calls run, one after another: for each, one
monotonic start and end and the verdict go into preallocated lists.
"""
from __future__ import annotations

import importlib
import re
import time
from dataclasses import dataclass

from portbench import generator


@dataclass
class Program:
    entry: object           # the program's entry function
    chain_id: str
    vals: object            # the program's ValidatorSet
    pool: list              # [(height, round, BlockID, [CommitSig])]
    order: list             # pool index of call i: order[i % len(order)]
    device: object
    n: int                  # signatures a call
    commit_cls: object
    errors: tuple           # the exceptions that carry a verdict


def inputs(config: dict, traffic: dict, seed: int, pool=None):
    return generator.start_inputs(config, traffic, seed, pool)


def build(inputs, traffic: dict, device) -> Program:
    """The program's validator set and commit pool for ``inputs``."""
    from cometbft_tpu_torch.crypto.ed25519 import Ed25519PubKey
    from cometbft_tpu_torch.types import validation
    from cometbft_tpu_torch.types.block_id import BlockID
    from cometbft_tpu_torch.types.commit import Commit, CommitSig
    from cometbft_tpu_torch.types.part_set import PartSetHeader
    from cometbft_tpu_torch.types.timestamp import Timestamp
    from cometbft_tpu_torch.types.validator import Validator
    from cometbft_tpu_torch.types.validator_set import ValidatorSet
    from cometbft_tpu_torch.types.vote import BLOCK_ID_FLAG_COMMIT

    vals = ValidatorSet([Validator.new(Ed25519PubKey(pub), power)
                         for pub, power in inputs.validators])
    pool = []
    for h in inputs.heights:
        bid = BlockID(h.block_hash, PartSetHeader(h.psh_total, h.psh_hash))
        sigs = [CommitSig.absent() if sig is None else
                CommitSig(BLOCK_ID_FLAG_COMMIT, addr, Timestamp(*stamp), sig)
                for addr, stamp, sig in zip(inputs.addresses, h.stamps,
                                            h.sigs)]
        pool.append((h.height, h.round, bid, sigs))
    return Program(
        entry=getattr(validation, traffic["entry"]),
        chain_id=inputs.chain_id, vals=vals, pool=pool,
        order=list(inputs.order), device=device,
        n=len(inputs.validators), commit_cls=Commit,
        errors=(validation.VerificationError,))


def _bind(prog: Program):
    """(make, call): ``make(i)`` builds call i's arguments from the
    pool's rotation; ``call(*args)`` runs the entry on them and returns
    the exception that carries its verdict, or None."""
    pool, order, n_order = prog.pool, prog.order, len(prog.order)
    entry, chain_id, vals, device = (prog.entry, prog.chain_id, prog.vals,
                                     prog.device)
    commit_cls, errors = prog.commit_cls, prog.errors

    def make(i):
        height, round_, bid, sigs = pool[order[i % n_order]]
        return bid, height, commit_cls(height=height, round=round_,
                                       block_id=bid, signatures=sigs)

    def call(bid, height, commit):
        try:
            entry(chain_id, vals, bid, height, commit, device=device)
        except errors as e:
            # the verdict is kept, not the frames: a kept traceback
            # would hold the call's batch alive for the whole window
            return e.with_traceback(None)
        return None
    return make, call


def _ladder(prog: Program) -> tuple:
    """The pad buckets the program would launch a call's tiles at now."""
    from cometbft_tpu_torch.crypto import batch, pipeline
    return tuple(batch.pad_bucket(hi - lo)
                 for lo, hi in pipeline.tile_plan(prog.n))


def warm(prog: Program, traffic: dict) -> dict:
    """Warm calls until the pad ladder has stayed the same for
    ``warm_settle_s`` seconds (or ``warm_calls_max`` ran), so that its
    refinement is over before the window opens."""
    settle_s = float(traffic["warm_settle_s"])
    max_calls = int(traffic["warm_calls_max"])
    make, call = _bind(prog)
    last, changes, shortest, i = None, [], float("inf"), 0
    stable_since = time.perf_counter()
    while i < max_calls:
        args = make(i)
        t0 = time.perf_counter()
        call(*args)
        t1 = time.perf_counter()
        shortest = min(shortest, t1 - t0)
        i += 1
        now = _ladder(prog)
        if now != last:
            if last is not None:
                changes.append(i)
            last, stable_since = now, t1
        elif t1 - stable_since >= settle_s:
            break
    return {"calls": i, "shortest_s": shortest,
            "note": f"{i} calls of {prog.n} signatures over "
                    f"{len(prog.pool)} heights, ladder {list(last or ())}, "
                    f"changed at calls {changes}"}


def measure(prog: Program, seconds: float, seen: dict):
    """The window: calls back to back, on from the warm-up's last
    rotation index, until ``seconds`` have passed.  The lists hold
    twice the calls the warm-up's shortest call would fit."""
    first = seen["calls"]
    cap = int(seconds / max(seen["shortest_s"], 1e-4) * 2) + 64
    starts, ends, outs = [0] * cap, [0] * cap, [None] * cap
    make, call = _bind(prog)
    clock = time.monotonic_ns
    i = 0
    t_open = clock()
    t_close = t_open + int(seconds * 1e9)
    t1 = t_open
    while True:
        args = make(first + i)
        t0 = clock()
        if t0 >= t_close:
            break
        out = call(*args)
        t1 = clock()
        if i < cap:
            starts[i], ends[i], outs[i] = t0, t1, out
        else:
            starts.append(t0)
            ends.append(t1)
            outs.append(out)
        i += 1
    return starts[:i], ends[:i], outs[:i], t_open, t1


def verdict(exc) -> tuple:
    """A call's outcome in the reference's terms: ``("ok",)``,
    ``("power", got, needed)``, ``("bad_sig", index)`` or
    ``("error", text)``."""
    if exc is None:
        return ("ok",)
    got, needed = getattr(exc, "got", None), getattr(exc, "needed", None)
    if got is not None and needed is not None:
        return ("power", got, needed)
    m = re.match(r"wrong signature \(#(\d+)\)", str(exc))
    if m:
        return ("bad_sig", int(m.group(1)))
    return ("error", str(exc)[:200])


def judge(inputs, outs: list, first: int, pool=None) -> list:
    """Every call whose verdict differs from the reference's verdict on
    its pool height."""
    reference = importlib.import_module(
        f"portbench.reference.{inputs.reference}")
    want = reference.verdicts(inputs.chain_id, inputs.validators,
                              inputs.heights, pool)
    order = inputs.order
    bad = []
    for i, out in enumerate(outs):
        got, ref = verdict(out), want[order[(first + i) % len(order)]]
        if got != ref:
            bad.append((i, got, ref))
    return bad
