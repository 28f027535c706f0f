"""Typed consensus events and the EventBus.

Reference: types/events.go (event strings + query constants) and
types/event_bus.go:34 (EventBus wrapping libs/pubsub, feeding RPC
websocket subscribers and the indexer), through
cometbft_tpu/types/events.py, whose event names, attribute keys and
queries this copy keeps.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ..libs import pubsub

# event types (reference: types/events.go)
EVENT_NEW_BLOCK = "NewBlock"
EVENT_NEW_BLOCK_HEADER = "NewBlockHeader"
EVENT_NEW_BLOCK_EVENTS = "NewBlockEvents"
EVENT_NEW_EVIDENCE = "NewEvidence"
EVENT_TX = "Tx"
EVENT_VALIDATOR_SET_UPDATES = "ValidatorSetUpdates"
EVENT_COMPLETE_PROPOSAL = "CompleteProposal"
EVENT_LOCK = "Lock"
EVENT_NEW_ROUND = "NewRound"
EVENT_NEW_ROUND_STEP = "NewRoundStep"
EVENT_POLKA = "Polka"
EVENT_RELOCK = "Relock"
EVENT_TIMEOUT_PROPOSE = "TimeoutPropose"
EVENT_TIMEOUT_WAIT = "TimeoutWait"
EVENT_VALID_BLOCK = "ValidBlock"
EVENT_VOTE = "Vote"
EVENT_PROPOSAL_BLOCK_PART = "ProposalBlockPart"

# reserved event attribute keys
EVENT_TYPE_KEY = "tm.event"
TX_HASH_KEY = "tx.hash"
TX_HEIGHT_KEY = "tx.height"
BLOCK_HEIGHT_KEY = "block.height"


def query_for_event(event_type: str) -> pubsub.Query:
    return pubsub.Query(f"{EVENT_TYPE_KEY} = '{event_type}'")


EVENT_QUERY_NEW_BLOCK = query_for_event(EVENT_NEW_BLOCK)
EVENT_QUERY_NEW_BLOCK_HEADER = query_for_event(EVENT_NEW_BLOCK_HEADER)
EVENT_QUERY_NEW_BLOCK_EVENTS = query_for_event(EVENT_NEW_BLOCK_EVENTS)
EVENT_QUERY_TX = query_for_event(EVENT_TX)
EVENT_QUERY_VOTE = query_for_event(EVENT_VOTE)
EVENT_QUERY_NEW_EVIDENCE = query_for_event(EVENT_NEW_EVIDENCE)
EVENT_QUERY_VALIDATOR_SET_UPDATES = query_for_event(
    EVENT_VALIDATOR_SET_UPDATES)


@dataclass
class EventData:
    """A published event: payload + ABCI-style event attributes."""
    kind: str
    payload: Any = None
    attrs: dict[str, list[str]] = field(default_factory=dict)


class EventBus:
    """Typed pub/sub over libs/pubsub (reference: event_bus.go:34)."""

    def __init__(self):
        self._server = pubsub.Server()

    def subscribe(self, subscriber: str, query: pubsub.Query | str,
                  out_capacity: int = 100) -> pubsub.Subscription:
        return self._server.subscribe(subscriber, query, out_capacity)

    def unsubscribe(self, subscriber: str,
                    query: pubsub.Query | str) -> None:
        self._server.unsubscribe(subscriber, query)

    def unsubscribe_all(self, subscriber: str) -> None:
        self._server.unsubscribe_all(subscriber)

    def num_clients(self) -> int:
        return self._server.num_clients()

    def num_client_subscriptions(self, subscriber: str) -> int:
        return self._server.num_client_subscriptions(subscriber)

    # ------------------------------------------------------------------
    def _publish(self, event_type: str, payload: Any,
                 extra: Optional[dict[str, list[str]]] = None) -> None:
        events = dict(extra or {})
        events.setdefault(EVENT_TYPE_KEY, []).append(event_type)
        self._server.publish(
            EventData(kind=event_type, payload=payload, attrs=events),
            events)

    def publish_new_block(self, block, block_id, result_finalize) -> None:
        self._publish(EVENT_NEW_BLOCK,
                      {"block": block, "block_id": block_id,
                       "result_finalize_block": result_finalize},
                      {BLOCK_HEIGHT_KEY: [str(block.header.height)]})

    def publish_new_block_header(self, header) -> None:
        self._publish(EVENT_NEW_BLOCK_HEADER, {"header": header},
                      {BLOCK_HEIGHT_KEY: [str(header.height)]})

    def publish_new_block_events(self, height: int, events: list,
                                 num_txs: int) -> None:
        extra = _abci_events_to_map(events)
        extra[BLOCK_HEIGHT_KEY] = [str(height)]
        self._publish(EVENT_NEW_BLOCK_EVENTS,
                      {"height": height, "events": events,
                       "num_txs": num_txs}, extra)

    def publish_tx(self, height: int, index: int, tx: bytes, result,
                   events: list) -> None:
        from .tx import tx_hash
        extra = _abci_events_to_map(events)
        extra[TX_HASH_KEY] = [tx_hash(tx).hex().upper()]
        extra[TX_HEIGHT_KEY] = [str(height)]
        self._publish(EVENT_TX, {"height": height, "index": index,
                                 "tx": tx, "result": result}, extra)

    def publish_vote(self, vote) -> None:
        self._publish(EVENT_VOTE, {"vote": vote})

    def publish_new_evidence(self, evidence, height: int) -> None:
        self._publish(EVENT_NEW_EVIDENCE,
                      {"evidence": evidence, "height": height})

    def publish_validator_set_updates(self, updates: list) -> None:
        self._publish(EVENT_VALIDATOR_SET_UPDATES,
                      {"validator_updates": updates})

    def publish_new_round_step(self, round_state) -> None:
        self._publish(EVENT_NEW_ROUND_STEP, round_state)

    def publish_new_round(self, round_state) -> None:
        self._publish(EVENT_NEW_ROUND, round_state)

    def publish_complete_proposal(self, round_state) -> None:
        self._publish(EVENT_COMPLETE_PROPOSAL, round_state)

    def publish_polka(self, round_state) -> None:
        self._publish(EVENT_POLKA, round_state)

    def publish_lock(self, round_state) -> None:
        self._publish(EVENT_LOCK, round_state)

    def publish_relock(self, round_state) -> None:
        self._publish(EVENT_RELOCK, round_state)

    def publish_valid_block(self, round_state) -> None:
        self._publish(EVENT_VALID_BLOCK, round_state)

    def publish_timeout_propose(self, round_state) -> None:
        self._publish(EVENT_TIMEOUT_PROPOSE, round_state)

    def publish_timeout_wait(self, round_state) -> None:
        self._publish(EVENT_TIMEOUT_WAIT, round_state)


def _field(obj, name: str, default):
    if isinstance(obj, dict):
        return obj.get(name, default)
    return getattr(obj, name, default)


def _abci_events_to_map(events: list) -> dict[str, list[str]]:
    """Flatten ABCI events [{type, attributes: [{key, value, index}]}]
    into composite-key tag map (reference: pubsub 'events' map)."""
    out: dict[str, list[str]] = {}
    for ev in events or []:
        etype = _field(ev, "type", "")
        for attr in _field(ev, "attributes", []):
            k = _field(attr, "key", "")
            v = _field(attr, "value", "")
            if etype and k:
                out.setdefault(f"{etype}.{k}", []).append(v)
    return out


class NopEventBus:
    """Event bus that drops everything (reference: event_bus.go
    NopEventBus — subscribe/unsubscribe are no-ops too)."""

    def subscribe(self, subscriber, query, out_capacity: int = 100):
        return pubsub.Subscription(out_capacity)

    def unsubscribe(self, subscriber, query) -> None:
        pass

    def unsubscribe_all(self, subscriber) -> None:
        pass

    def num_clients(self) -> int:
        return 0

    def num_client_subscriptions(self, subscriber) -> int:
        return 0

    def __getattr__(self, name):
        if name.startswith("publish"):
            return lambda *a, **k: None
        raise AttributeError(name)
