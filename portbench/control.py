"""The readings that the limit on ``mismatched_calls`` was set from: the
program's runs over many seeds, its control, and the faults that the
check has to catch.  Not part of any benchmark run.

    python3 -m portbench.control --workload commit-10k --seconds 30 \
        --seeds 1,2,3 [--entry verify_commit_light] [--fault skip_kernel]

runs the cell once a seed in one process (one CUDA context, the
program's libraries loaded once) and prints one line a seed with the
number compared.

The control is the program's own light path, ``verify_commit_light``,
in the place of ``verify_commit``: it stops at 2/3 of the power, which
breaks the configuration's guarantee that every present signature is
checked, and so accepts a commit whose only bad signature lies past the
2/3 mark.  The faults (``FAULTS``) break the timed path underneath:
the kernel's launch skipped, the first or the second half of each batch
left out, a verdict flipped where the kernel produces it.  The exchange
between chips has no fault here, as every cell runs on one chip.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time
from types import SimpleNamespace


def _broken_kernel(fault: str):
    """A context manager that puts a kernel module whose verdicts are
    broken by ``fault`` in the place of every kernel the program can
    choose."""
    @contextlib.contextmanager
    def plant():
        import torch
        from cometbft_tpu_torch.ops import ed25519 as oe
        saved = dict(oe.KERNELS)

        def wrap(real):
            def verify_cols(a, r, s, k):
                if fault == "skip_kernel":
                    return torch.ones(a.shape[1], dtype=torch.bool,
                                      device=a.device)
                ok = real.verify_cols(a, r, s, k).clone()
                ok[0] = ~ok[0]
                return ok
            return SimpleNamespace(verify_cols=verify_cols)

        for name, module in saved.items():
            oe.KERNELS[name] = wrap(module)
        try:
            yield
        finally:
            oe.KERNELS.update(saved)
    return plant


def _half_left_out(half: int):
    """A context manager under which the batch verifier checks one half
    of its signatures and reports the other half (``half`` 0: the
    first, 1: the second) valid."""
    @contextlib.contextmanager
    def plant():
        from cometbft_tpu_torch.ops import ed25519 as oe
        real = oe.verify_batch

        def verify_batch(items, device=None):
            h = len(items) // 2
            if half == 0:
                _, rest = real(items[h:], device=device)
                mask = [True] * h + list(rest)
            else:
                _, rest = real(items[:h], device=device)
                mask = list(rest) + [True] * (len(items) - h)
            return all(mask), mask

        oe.verify_batch = verify_batch
        try:
            yield
        finally:
            oe.verify_batch = real
    return plant


# every lane reported valid, the launch skipped; the first or the second
# half of each batch left out and reported valid; lane 0's verdict of
# each launch flipped where the kernel produces it
FAULTS = {"skip_kernel": _broken_kernel("skip_kernel"),
          "first_half_left_out": _half_left_out(0),
          "second_half_left_out": _half_left_out(1),
          "answer_flipped": _broken_kernel("answer_flipped")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--entry", default="")
    ap.add_argument("--fault", default="", choices=("",) + tuple(FAULTS))
    args = ap.parse_args(argv)
    from portbench import manifest, run
    root = manifest.ROOT
    cell = manifest.cell(manifest.load(root / "BENCHMARK.json"),
                         args.workload, root)
    run.pin_caches(root)
    with run.worker_pool() as pool:
        return _readings(cell, args, pool)


def _readings(cell, args, pool) -> int:
    from portbench import run
    import torch
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    what = args.entry or args.fault or "program"
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        out = run.run_cell(cell, seed, args.seconds, False, t_start=t0,
                           traffic={"entry": args.entry} if args.entry
                           else None, plant=FAULTS.get(args.fault),
                           pool=pool)
        res = out["result"]
        mism = res["checks"]["mismatched_calls"]["value"]
        print(f"control {args.workload} {what} seed {seed}: "
              f"mismatched_calls {mism} of {res['attempted']} calls, "
              f"correct {res['correct']}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for line in out["lines"]:
            if line.startswith("mismatch"):
                print(f"  {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
