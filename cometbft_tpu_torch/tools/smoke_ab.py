"""Run chip_smoke.py's mempool cell (14c) from two checkouts on one card,
alternately, so that their readings share a host and a card.

    python -m cometbft_tpu_torch.tools.smoke_ab --runs 2 OLD NEW
    python -m cometbft_tpu_torch.tools.smoke_ab --whole OLD NEW

Each checkout runs in a process of its own.  By default the processes
run in the order OLD, NEW, NEW, OLD, and each builds its checkout's
kernels and runs ``_mempool_net`` ``--runs`` times on the card; with
``--whole`` each checkout's ``chip_smoke.py`` runs to its end instead,
OLD then NEW.  The script prints the card's name and power limit, then
each process's 14c lines and phase times under the checkout's name, and
with ``--out DIR`` writes each process's whole output to DIR.  Compare
readings only within one call.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

_CELL = """
import asyncio, logging, subprocess, sys
import chip_smoke as cs
from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import ed25519_kernel as ek
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True, check=True).stdout.strip().splitlines()[0]
_build.load()
for _ in range({runs}):
    loop = asyncio.new_event_loop()
    logging.disable(logging.INFO)
    try:
        cs._mempool_net(0, card, ek, tracing, None, loop)
    finally:
        logging.disable(logging.NOTSET)
        loop.close()
"""

_KEEP = ("mempool_", "phase 14 took", "exit ")


def _run(label: str, root: str, argv: list[str], out: str | None) -> int:
    proc = subprocess.run(argv, cwd=root, capture_output=True, text=True,
                          timeout=1200)
    if out:
        with open(out, "w") as f:
            f.write(proc.stdout + proc.stderr)
    for line in proc.stdout.splitlines():
        if line.startswith(_KEEP):
            print(f"[{label}] {line}", flush=True)
    if proc.returncode != 0:
        print(f"[{label}] exit {proc.returncode}: "
              f"{proc.stderr.strip()[-2000:]}", flush=True)
    return proc.returncode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--whole", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    if args.whole:
        cmd = [sys.executable, "chip_smoke.py"]
    else:
        cmd = [sys.executable, "-c",
               _CELL.format(runs=args.runs)]
    order = [("old", args.old), ("new", args.new)]
    if not args.whole:
        order += order[::-1]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    rc = 0
    for i, (label, root) in enumerate(order):
        out = args.out and os.path.join(
            os.path.abspath(args.out),
            f"{'whole' if args.whole else 'cell'}-{i}-{label}.log")
        rc |= _run(label, os.path.abspath(root), cmd, out)
    return rc


if __name__ == "__main__":
    sys.exit(main())
