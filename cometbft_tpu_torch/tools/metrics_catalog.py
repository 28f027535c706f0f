"""The catalog of every metric family a port node registers.

The port's copy of the repository's ``tools/metrics_catalog.py``.  It
puts the ten subsystem ``Metrics`` classes on one registry and adds the
process-global families of ``libs/metrics.DEFAULT`` (the batch-verify
and kernel-dispatch histograms, the overlap ratio, the pad-bucket
refinement counter, the signature-cache and aggregate-pubkey counters,
the commit-verify histogram and the verification workers' queue
families), then prints one row a family: name, type, labels and help.

The reference's catalog has four families more: the circuit breaker's
three (the port has no breaker: a kernel that fails raises) and the
CPU pipeline's tile-reject counter (the port has no CPU verify path).
``tests/test_torch_observability_drift.py`` holds the two catalogs row
for row apart from those four.

Run:  python -m cometbft_tpu_torch.tools.metrics_catalog [--json]
"""
from __future__ import annotations

import argparse
import json


def collect_catalog() -> list[dict]:
    """Every family's descriptor (name, kind, help, labels, series),
    sorted by name, each name once."""
    from ..abci.metrics import Metrics as ProxyMetrics
    from ..blocksync.metrics import Metrics as BlocksyncMetrics
    from ..consensus.metrics import Metrics as ConsensusMetrics
    from ..crypto import batch as crypto_batch
    from ..crypto import bls12381  # noqa: F401  (aggregate-pubkey counters)
    from ..crypto import pipeline as crypto_pipeline
    from ..libs import metrics as libmetrics
    from ..libs.health import Metrics as HealthMetrics
    from ..libs.supervisor import Metrics as SupervisorMetrics
    from ..libs.workers import SupervisedWorker
    from ..lightserve.cache import Metrics as LightserveMetrics
    from ..mempool.metrics import Metrics as MempoolMetrics
    from ..ops import ed25519 as ops_ed25519  # noqa: F401  (refinements)
    from ..p2p.metrics import Metrics as P2PMetrics
    from ..state.metrics import Metrics as StateMetrics
    from ..statesync.metrics import Metrics as StatesyncMetrics
    from ..types import signature_cache  # noqa: F401  (cache counters)
    from ..types import validation as types_validation

    reg = libmetrics.Registry()
    for cls in (ConsensusMetrics, MempoolMetrics, P2PMetrics,
                BlocksyncMetrics, StatesyncMetrics, StateMetrics,
                ProxyMetrics, SupervisorMetrics, LightserveMetrics,
                HealthMetrics):
        cls(reg)
    # The port registers its process-global families when their modules
    # are imported; these calls name the ones the reference makes lazily.
    crypto_batch.verify_seconds_histogram()
    crypto_pipeline.dispatch_histogram()
    crypto_pipeline.overlap_histogram()
    types_validation.commit_verify_histogram()
    # a throwaway worker registers the workers' queue-wait and depth
    # families on DEFAULT, as the verify_stage worker does
    SupervisedWorker("catalog_probe").stop()

    seen = set()
    out = []
    for fam in reg.collect() + libmetrics.DEFAULT.collect():
        if fam["name"] in seen:
            continue
        seen.add(fam["name"])
        out.append(fam)
    return sorted(out, key=lambda f: f["name"])


def to_markdown(catalog: list[dict]) -> str:
    """The catalog as a markdown table, one row a family."""
    lines = ["| Name | Type | Labels | Help |",
             "|------|------|--------|------|"]
    for fam in catalog:
        labels = ", ".join(f"`{l}`" for l in fam["labels"]) or "—"
        help_ = fam["help"].replace("\n", " ").replace("|", "\\|")
        lines.append(
            f"| `{fam['name']}` | {fam['kind']} | {labels} "
            f"| {help_} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="The metric families a port node registers")
    ap.add_argument("--json", action="store_true",
                    help="JSON instead of markdown")
    args = ap.parse_args(argv)
    catalog = collect_catalog()
    if args.json:
        print(json.dumps(catalog, indent=2))
    else:
        print(to_markdown(catalog))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
