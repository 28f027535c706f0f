"""P2P metrics (reference: p2p/metrics.go + metrics.gen.go — per-
channel byte counters, peer gauge, flow-control delay), the port's copy
of cometbft_tpu/p2p/metrics.py: the same families, names and labels."""
from __future__ import annotations

from typing import Optional

from ..libs import metrics as libmetrics


class Metrics:
    def __init__(self, registry: Optional[libmetrics.Registry] = None):
        m = registry if registry is not None else libmetrics.Registry()
        self.peers = m.gauge(
            "p2p", "peers", "Number of peers.")
        self.message_receive_bytes_total = m.counter(
            "p2p", "message_receive_bytes_total",
            "Number of bytes of each message type received.",
            labels=("chID",))
        self.message_send_bytes_total = m.counter(
            "p2p", "message_send_bytes_total",
            "Number of bytes of each message type sent.",
            labels=("chID",))
        self.peer_pending_send_bytes = m.gauge(
            "p2p", "peer_pending_send_bytes",
            "Pending bytes to be sent to a given peer.",
            labels=("peer_id",))
        self.recv_rate_limiter_delay = m.counter(
            "p2p", "recv_rate_limiter_delay",
            "Seconds spent sleeping in the receive rate limiter.",
            labels=("peer_id",))
        self.send_rate_limiter_delay = m.counter(
            "p2p", "send_rate_limiter_delay",
            "Seconds spent sleeping in the send rate limiter.",
            labels=("peer_id",))
        # metrics v2: distributions per channel (channel ids are a
        # small fixed set claimed by reactors, so the label is
        # bounded; peers are NOT a histogram label on purpose —
        # buckets x peers would explode under churn)
        _size_buckets = (16, 64, 256, 1024, 4096, 16384, 65536,
                         262144, 1048576, 4194304)
        self.message_send_size_bytes = m.histogram(
            "p2p", "message_send_size_bytes",
            "Histogram of complete message sizes sent per channel.",
            labels=("chID",), buckets=_size_buckets)
        self.message_recv_size_bytes = m.histogram(
            "p2p", "message_recv_size_bytes",
            "Histogram of complete message sizes received per "
            "channel.", labels=("chID",), buckets=_size_buckets)
        self.queue_stall_seconds = m.histogram(
            "p2p", "queue_stall_seconds",
            "Histogram of time a send stalled per channel: blocking "
            "waits on a full send queue plus rate-limiter sleeps in "
            "the send routine.", labels=("chID",),
            buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1,
                     0.5, 1.0, 5.0))
        self.send_queue_drops = m.counter(
            "p2p", "send_queue_drops",
            "Number of messages dropped by TrySend on a full "
            "per-channel send queue.", labels=("chID",))
        # bytes-useful vs bytes-sent per channel (docs/gossip.md):
        # reactors credit payload bytes that carried NOVEL content
        # (a tx the pool admitted, a block part the part set lacked,
        # a vote the peer-state bitmap lacked); the ratio against
        # message_send/receive_bytes_total is the redundancy of each
        # gossip plane
        self.message_useful_bytes_total = m.counter(
            "p2p", "message_useful_bytes_total",
            "Received bytes whose payload was novel to this node, "
            "credited per channel by the owning reactor.",
            labels=("chID",))

    def touch_channel(self, ch_id: str) -> None:
        """Materialize the per-channel series at connection setup so
        /metrics always exposes the full bucket ladder for every
        claimed channel, observations or not (the exposition contract
        test relies on this)."""
        self.message_send_size_bytes.with_labels(ch_id)
        self.message_recv_size_bytes.with_labels(ch_id)
        self.queue_stall_seconds.with_labels(ch_id)
        self.message_useful_bytes_total.with_labels(ch_id)
