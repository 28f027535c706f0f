"""Mempool metrics (reference: mempool/metrics.go + metrics.gen.go —
the same names and labels, so dashboards port).

The port's copy of cometbft_tpu/mempool/metrics.py, on the port's
libs/metrics.py.
"""
from __future__ import annotations

from typing import Optional

from ..libs import metrics as libmetrics


class Metrics:
    def __init__(self, registry: Optional[libmetrics.Registry] = None):
        m = registry if registry is not None else libmetrics.Registry()
        self.size = m.gauge(
            "mempool", "size",
            "Number of uncommitted transactions in the mempool.")
        self.size_bytes = m.gauge(
            "mempool", "size_bytes",
            "Total size of the mempool in bytes.")
        self.lane_size = m.gauge(
            "mempool", "lane_size",
            "Number of txs in a lane.", labels=("lane",))
        self.lane_bytes = m.gauge(
            "mempool", "lane_bytes",
            "Bytes in a lane.", labels=("lane",))
        self.tx_size_bytes = m.histogram(
            "mempool", "tx_size_bytes",
            "Histogram of transaction sizes in bytes.",
            buckets=(16, 64, 256, 1024, 4096, 16384, 65536, 262144,
                     1048576))
        self.failed_txs = m.counter(
            "mempool", "failed_txs",
            "Number of failed transactions.")
        self.rejected_txs = m.counter(
            "mempool", "rejected_txs",
            "Number of rejected transactions (mempool full / too "
            "large).")
        self.evicted_txs = m.counter(
            "mempool", "evicted_txs",
            "Number of evicted transactions.")
        self.recheck_times = m.counter(
            "mempool", "recheck_times",
            "Number of times transactions were rechecked in the "
            "mempool.")
        self.recheck_duration_seconds = m.gauge(
            "mempool", "recheck_duration_seconds",
            "Duration of the last recheck pass.")
        # metrics v2: latency distributions for the two mempool hot
        # paths — per-CheckTx app round-trips and whole recheck passes
        # (the last-value gauge above stays for reference parity)
        self.checktx_duration_seconds = m.histogram(
            "mempool", "checktx_duration_seconds",
            "Histogram of CheckTx app round-trip latency in seconds.",
            buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1,
                     0.5, 1.0, 5.0))
        self.recheck_pass_duration_seconds = m.histogram(
            "mempool", "recheck_pass_duration_seconds",
            "Histogram of full post-commit recheck pass duration in "
            "seconds.",
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 2.5,
                     5.0, 10.0))
        self.already_received_txs = m.counter(
            "mempool", "already_received_txs",
            "Number of duplicate transaction receptions (cache "
            "hits).")
        # incremental recheck (docs/pipeline.md)
        self.recheck_skipped_txs = m.counter(
            "mempool", "recheck_skipped_txs",
            "Pooled transactions the incremental recheck proved "
            "untouched by the committed block and skipped.")
        self.checktx_revalidations = m.counter(
            "mempool", "checktx_revalidations",
            "CheckTx calls re-issued because a commit cycle raced "
            "the in-flight validation (the FinalizeBlock-to-recheck "
            "admission gap).")
        # reconciliation gossip (docs/gossip.md): the duplicate-
        # delivery ratio is the fraction of peer-delivered txs the
        # dedup cache had already seen.
        self.gossip_txs_received = m.counter(
            "mempool", "gossip_txs_received",
            "Transactions delivered by peer gossip, duplicates "
            "included.")
        self.gossip_txs_duplicate = m.counter(
            "mempool", "gossip_txs_duplicate",
            "Peer-delivered transactions the dedup cache had "
            "already seen.")
        self.duplicate_delivery_ratio = m.gauge(
            "mempool", "duplicate_delivery_ratio",
            "gossip_txs_duplicate / gossip_txs_received, cumulative "
            "— the redundancy of the tx gossip plane.")
        self.recon_wants_sent = m.counter(
            "mempool", "recon_wants_sent",
            "Short ids pulled from peers (TxWant) after a summary "
            "diff found them missing.")
        self.recon_wants_received = m.counter(
            "mempool", "recon_wants_received",
            "Short ids peers pulled from this node.")
        self.recon_want_refetches = m.counter(
            "mempool", "recon_want_refetches",
            "In-flight wants re-issued to another advertiser after "
            "the want timeout.")
        self.recon_want_expired = m.counter(
            "mempool", "recon_want_expired",
            "In-flight wants dropped with no advertiser left to "
            "retry.")
        self.recon_pushed_txs = m.counter(
            "mempool", "recon_pushed_txs",
            "Brand-new local transactions pushed in full to the "
            "fast-path peer subset.")
        self.recon_salt_rotations = m.counter(
            "mempool", "recon_salt_rotations",
            "Summary salt rotations forced by a short-id "
            "self-collision.")

    def update_sizes(self, mempool) -> None:
        self.size.set(mempool.size())
        self.size_bytes.set(mempool.size_bytes())
        for lane in getattr(mempool, "_lane_txs", {}):
            n, b = mempool.lane_sizes(lane)
            self.lane_size.with_labels(lane).set(n)
            self.lane_bytes.with_labels(lane).set(b)
