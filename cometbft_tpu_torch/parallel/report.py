"""Sharded-dispatch report for a 10k commit over several cards.

Counterpart of cometbft_tpu/parallel/report.py.  It states what this
host can show of splitting a 10,240-lane batch over ``ndev`` cards, with
every assumption in the output:

  * geometry: ``PipelinePartitioner``'s padding for m lanes over ndev
    devices (lanes a shard, B1 blocks a shard, padded total);
  * collectives, counted by the port itself (``mesh.collectives``): the
    sharded verify issues none, a tally step exactly one all_reduce;
  * execution: the sharded dispatch runs at reduced lanes over the
    cards present (``ndev`` CPU entries without one) and its mask is
    held to the golden model; one tally step runs in a one-rank group
    (NCCL on a card, gloo on the CPU) and its count is held to the mask;
  * timing model: sharded_ms = lanes_a_shard x us_a_lane + overhead_ms,
    calibrated from B1 measured on the card in the same run (CUDA
    events, median of 5, at 10,240 lanes; the overhead is B1's time at
    one block of lanes), with B1's measured time at one shard's lanes
    and the card's name and power limit beside it.  Without a card
    there is no timing, and the report says so.

Run:  python -m cometbft_tpu_torch.parallel.report --out FILE
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

N_STAR = 10_000
BUCKET = 10_240
NDEV = 8
TIMED_RUNS = 5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _card() -> str:
    """nvidia-smi's name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


def _items(n: int, bad_every: int = 4) -> tuple[list, list]:
    """n golden-model signatures, every ``bad_every``-th with S zeroed,
    and the golden verdicts."""
    from ..crypto import _ed25519_ref as ref
    items, golden = [], []
    for i in range(n):
        seed = bytes([i + 1]) * 32
        msg = b"shard-%d" % i
        sig = ref.sign(seed, msg)
        if i % bad_every == bad_every - 1:
            sig = sig[:32] + bytes(32)
        items.append((ref.public_key(seed), msg, sig))
        golden.append(ref.verify(*items[-1]))
    return items, golden


def _tally_once(args, pre_bad, backend: str, device) -> tuple[int, int]:
    """One tally step in a one-rank group (made here unless one is up);
    returns (count, all_reduces it issued)."""
    import torch.distributed as dist
    from . import mesh
    made = not dist.is_initialized()
    if made:
        dist.init_process_group(backend,
                                init_method=f"tcp://localhost:{_free_port()}",
                                world_size=1, rank=0)
    try:
        before = mesh.collectives["all_reduce"]
        _ok, count = mesh.sharded_verify_tally(device=device)(
            *args, pre_bad=pre_bad)
        return count, mesh.collectives["all_reduce"] - before
    finally:
        if made:
            dist.destroy_process_group()


def _b1_ms(lanes: int, items: list) -> float:
    """Median of TIMED_RUNS CUDA-event times of one B1 launch over
    ``lanes`` lanes of ``items`` repeated."""
    import torch
    from ..ops import ed25519 as oe
    from ..ops import ed25519_kernel as ek
    rows = (items * (-(-lanes // len(items))))[:lanes]
    dev = torch.device("cuda")
    cols = [oe.to_cols(x, dev) for x in oe.prep_arrays(rows, lanes)[:4]]
    ek.verify_cols(*cols)          # warm
    times = []
    for _ in range(TIMED_RUNS):
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        ek.verify_cols(*cols)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def sharded_10k_report(ndev: int = NDEV, m: int = BUCKET,
                       run_lanes: int = 2048, device=None) -> dict:
    """The report as a dict.  ``device`` None runs on the cards present
    (raising without CUDA); ``"cpu"`` runs the plain versions on ndev
    CPU entries and writes no timing."""
    import numpy as np
    import torch
    from ..ops import ed25519 as oe
    from ..ops import ed25519_kernel as ek
    from . import mesh as pmesh

    on_card = torch.device(device or "cuda").type == "cuda"
    padded = pmesh.padded_lanes(m, ndev)
    shard = padded // ndev
    geometry = {
        "n_signatures": N_STAR, "bucket": m, "devices": ndev,
        "per_shard_lanes": shard,
        "b1_blocks_per_shard": shard // pmesh.LANES_PER_BLOCK,
        "lanes_per_block": pmesh.LANES_PER_BLOCK,
        "padded_total": padded,
    }

    # --- execution at reduced lanes, counting the collectives --------
    items, golden = _items(max(1, run_lanes // 256))
    a_b, r_b, s_w8, k_w8, pre_bad = oe.prep_arrays(items, run_lanes)
    run_ndev = min(ndev, torch.cuda.device_count()) if on_card else ndev
    before = dict(pmesh.collectives)
    launches0 = ek.launches
    ok = pmesh.verify_sharded(a_b, r_b, s_w8, k_w8, ndev=run_ndev,
                              device=None if on_card else "cpu",
                              kernel=ek)
    verify_collectives = sum(pmesh.collectives[k] - before[k]
                             for k in before)
    verify_launches = ek.launches - launches0
    ok[pre_bad] = False
    executed = bool(ok[:len(items)].tolist() == golden)
    count, tally_collectives = _tally_once(
        (a_b, r_b, s_w8, k_w8), pre_bad, "nccl" if on_card else "gloo",
        None if on_card else "cpu")
    collectives = {"verify_path": verify_collectives,
                   "tally_path": tally_collectives,
                   "tally_kind": "all_reduce(SUM)"}

    # --- timing model from B1 measured here ---------------------------
    if on_card:
        # distinct signatures on the host ed25519, repeated to the lanes
        from ..crypto import ed25519
        keys = [ed25519.gen_priv_key_from_secret(b"calib-%d" % i)
                for i in range(256)]
        calib = [(k.pub_key().bytes(), b"calib-%d" % i,
                  k.sign(b"calib-%d" % i)) for i, k in enumerate(keys)]
        b1_ms = _b1_ms(BUCKET, calib)
        overhead_ms = _b1_ms(pmesh.LANES_PER_BLOCK, calib)
        shard_ms = _b1_ms(shard, calib)
        us_per_lane = b1_ms * 1000.0 / BUCKET
        sharded_ms = shard * us_per_lane / 1000.0 + overhead_ms
        model = {
            "measured": True,
            "card": _card(),
            "calibration": {
                "b1_ms_10240": b1_ms, "b1_ms_one_block": overhead_ms,
                "runs": TIMED_RUNS, "statistic": "median",
                "timer": "CUDA events"},
            "us_per_lane_measured": us_per_lane,
            "overhead_ms": overhead_ms,
            "assumptions": [
                "perfect lane scaling (the verify path issues no "
                "collective - counted above; lanes are independent)",
                "a shard costs its card one B1 launch of its lanes plus "
                "the fixed cost of a one-block launch, measured above",
                "every card runs the kernel measured here, at the same "
                "power limit",
            ],
            "single_card_10240_ms": b1_ms,
            f"sharded_{ndev}way_ms": sharded_ms,
            # one card's B1 time for one shard's lanes, measured: what
            # each of the ndev cards would spend, without the model
            "b1_ms_at_shard_lanes": shard_ms,
        }
    else:
        model = {"measured": False,
                 "note": "no CUDA device: no B1 time, so no timing model"}
    return {"geometry": geometry, "collectives": collectives,
            "executed_reduced": {"lanes": run_lanes, "devices": run_ndev,
                                 "ok": executed,
                                 "b1_launches": verify_launches,
                                 "tally_count": int(count),
                                 "tally_ok": int(count) == int(ok.sum())},
            "timing_model": model}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True,
                    help="where the JSON report goes")
    ap.add_argument("--ndev", type=int, default=NDEV)
    ap.add_argument("--run-lanes", type=int, default=2048)
    ap.add_argument("--device", default="",
                    help="'cpu' for the plain versions (default: the card)")
    args = ap.parse_args(argv)
    rep = sharded_10k_report(ndev=args.ndev, run_lanes=args.run_lanes,
                             device=args.device or None)
    tmp = args.out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rep, f, indent=1)
        f.write("\n")
    os.replace(tmp, args.out)
    print(json.dumps(rep["timing_model"], indent=1), file=sys.stderr)
    print(args.out)
    return 0 if rep["executed_reduced"]["ok"] and \
        rep["executed_reduced"]["tally_ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
