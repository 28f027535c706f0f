"""Time the state tree's prune in both packages on 15a's source history.

    JAX_PLATFORMS=cpu python tests/prune_forms_timing.py [--heights 105]

chip_smoke.py's 15a source commits 200 keyed txs of 256 bytes a height
and, with ``retain_blocks=50``, prunes the tree to ``h - 50`` in every
Commit from height 50 on.  This script makes the same history of sets
(no consensus, no app) in a JAX ``StateTree`` and a port ``StateTree``,
each on its package's MemDB, times each ``prune`` on the host clock, and
checks that the two trees hold the same rows at the end.  It prints one
line per form: the pairs and kept versions at the end, and ms a prune at
p50 / p90 / max with the total.  It imports both packages, so it runs
where the JAX package does (not on the card's machine); it is not a test.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cometbft_tpu.db import MemDB as RMemDB  # noqa: E402
from cometbft_tpu.statetree import StateTree as RStateTree  # noqa: E402
from cometbft_tpu_torch.db import MemDB  # noqa: E402
from cometbft_tpu_torch.statetree import StateTree  # noqa: E402

TXS, TX_BYTES, RETAIN = 200, 256, 50


def _history(heights: int, seed: int):
    rng = np.random.default_rng(seed)
    for h in range(1, heights + 1):
        yield h, [(b"%d.%d" % (h, j), rng.bytes(TX_BYTES))
                  for j in range(TXS)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--heights", type=int, default=105)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    forms = {"jax (group by key)": (RStateTree(RMemDB()), []),
             "port (one ordered pass)": (StateTree(MemDB()), [])}
    for h, pairs in _history(args.heights, args.seed):
        for tree, ms in forms.values():
            for k, v in pairs:
                tree.set(k, v)
            tree.commit(h)
            if h >= RETAIN:
                t0 = time.perf_counter()
                tree.prune(h - RETAIN)
                ms.append((time.perf_counter() - t0) * 1e3)
    (r, _), (p, _) = forms.values()
    if list(r._db.iterator(None, None)) != list(p._db.iterator(None, None)):
        print("the two trees' rows differ")
        return 1
    for name, (tree, ms) in forms.items():
        q = statistics.quantiles(ms, n=10)
        print(f"{name}: {len(tree.pairs())} pairs, versions "
              f"{tree.versions()[0]}-{tree.versions()[-1]}; {len(ms)} prunes, "
              f"ms a prune p50 {statistics.median(ms):.3f} p90 {q[-1]:.3f} "
              f"max {max(ms):.3f}, {sum(ms) / 1e3:.3f} s in all")
    return 0


if __name__ == "__main__":
    sys.exit(main())
