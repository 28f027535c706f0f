"""The event bus the block executor publishes to.

Reference: types/event_bus.go NopEventBus, through
cometbft_tpu/types/events.py:180 — every ``publish_*`` call is dropped.
The subscribing EventBus and libs/pubsub wait for the consensus state
machine (ROADMAP A.7d-2).
"""
from __future__ import annotations


class NopEventBus:
    """Event bus that drops everything."""

    def __getattr__(self, name):
        if name.startswith("publish"):
            return lambda *a, **k: None
        raise AttributeError(name)
