"""libs/pubsub.py and types/events.py's EventBus in the port against the
JAX package's.

  * a table of queries (every operator, numbers, strings with escapes,
    dates and times, multi-valued tags, AND chains) against a table of
    event tag maps: both packages match the same pairs, and refuse the
    same malformed queries with the same text;
  * Server: subscribe, the "already subscribed" and "subscription not
    found" errors, a full subscriber cancelled for capacity, client
    counts, in both packages;
  * EventBus: the typed publishers give the same kinds and tag maps,
    the tx events carry the tx hash and height, and NewBlock reaches a
    ``query_for_event`` subscriber with its payload.
"""
import asyncio

import pytest

from cometbft_tpu.libs import pubsub as r_pubsub
from cometbft_tpu.types import events as r_events
from cometbft_tpu_torch.libs import pubsub
from cometbft_tpu_torch.types import events
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

QUERIES = [
    "",
    "tm.event = 'NewBlock'",
    "tm.event='Tx' AND tx.height > 5",
    "tx.height >= 5 AND tx.height <= 7",
    "tx.height < 5",
    "account.name CONTAINS 'igor'",
    "account.name EXISTS",
    "account.owner = 'Ivan' AND account.owner CONTAINS 'va'",
    "transfer.amount = 10.5",
    "transfer.amount > 10",
    "label = 'a\\'b'",
    "block.time > TIME 2013-05-03T14:45:00Z",
    "block.time <= TIME 2013-05-03T14:45:00.123456789+02:00",
    "block.date = DATE 2017-01-01",
    "block.date < DATE 2017-01-02",
    "tx.hash = 'ABCDEF' AND tm.event = 'Tx' AND tx.height = 3",
    "name > 'bob'",
]

BAD_QUERIES = [
    "tm.event",
    "tm.event = ",
    "= 'x'",
    "a = 'b' AND",
    "a = 'b' OR c = 'd'",
    "a = 'unterminated",
    "a = TIME not-a-time",
    "a = 'b' c = 'd'",
    "label = 'it''s'",
]

EVENTS = [
    {},
    {"tm.event": ["NewBlock"]},
    {"tm.event": ["Tx"], "tx.height": ["6"]},
    {"tm.event": ["Tx"], "tx.height": ["5"]},
    {"tx.height": ["4", "7"]},
    {"account.name": ["igor", "ivan"]},
    {"account.name": ["anna"], "account.owner": ["Ivan"]},
    {"account.owner": ["Ivan"]},
    {"transfer.amount": ["10.5"]},
    {"transfer.amount": ["9", "11"]},
    {"label": ["it's"], "name": ["carol"]},
    {"label": ["a'b"]},
    {"block.time": ["2013-05-03T14:45:01Z"]},
    {"block.time": ["2013-05-03T12:45:00.1Z", "garbage"]},
    {"block.date": ["2017-01-01"]},
    {"block.date": ["2016-12-31T23:00:00Z"]},
    {"tx.hash": ["ABCDEF"], "tm.event": ["Tx"], "tx.height": ["3"]},
    {"name": ["bobby"]},
]


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — compared by type and text
        return type(e).__name__, str(e)


@pytest.mark.parametrize("query", QUERIES)
def test_queries_match_the_same_events(query):
    mine, theirs = pubsub.Query(query), r_pubsub.Query(query)
    assert str(mine) == str(theirs)
    assert [mine.matches(ev) for ev in EVENTS] == \
        [theirs.matches(ev) for ev in EVENTS]


def test_the_table_is_not_trivial():
    hits = [sum(pubsub.Query(q).matches(ev) for ev in EVENTS)
            for q in QUERIES]
    assert hits[0] == len(EVENTS)
    assert all(0 < h < len(EVENTS) for h in hits[1:])


@pytest.mark.parametrize("query", BAD_QUERIES)
def test_malformed_queries_raise_the_same_text(query):
    mine = _outcome(lambda: pubsub.Query(query).conditions)
    theirs = _outcome(lambda: r_pubsub.Query(query).conditions)
    assert mine[0] == theirs[0] == "QueryError"
    assert mine[1] == theirs[1]


def _server_story(mod):
    """The same calls on a Server of either package; their outcomes."""
    async def go():
        srv = mod.Server()
        out = []
        a = srv.subscribe("alice", "tm.event = 'Tx'", out_capacity=2)
        b = srv.subscribe("bob", mod.Query("tx.height > 1"))
        out.append(_outcome(lambda: srv.subscribe("alice",
                                                  "tm.event = 'Tx'")))
        out.append((srv.num_clients(), srv.num_client_subscriptions("alice")))
        for h in range(4):
            srv.publish({"h": h}, {"tm.event": ["Tx"], "tx.height": [str(h)]})
        out.append(a.canceled)
        got = []
        while True:
            try:
                msg = await asyncio.wait_for(b.next(), 0.01)
            except asyncio.TimeoutError:
                break
            got.append(msg.data["h"])
        out.append(got)
        out.append(_outcome(lambda: srv.unsubscribe("carol", "a = 'b'")))
        srv.unsubscribe("bob", "tx.height > 1")
        out.append(b.canceled)
        out.append(_outcome(lambda: srv.unsubscribe_all("bob")))
        out.append(srv.num_clients())
        return out
    return asyncio.run(go())


def test_server_behaves_as_the_jax_packages():
    mine, theirs = _server_story(pubsub), _server_story(r_pubsub)
    assert mine == theirs
    assert mine[2] == "out of capacity"
    assert mine[3] == [2, 3]


class _Tx:
    """An ABCI event in both packages' accepted shapes."""

    def __init__(self, etype, attrs):
        self.type = etype
        self.attributes = [{"key": k, "value": v} for k, v in attrs]


def _bus_story(mod, pubsub_mod):
    async def go():
        bus = mod.EventBus()
        every = bus.subscribe("all", pubsub_mod.Query(""), out_capacity=100)
        blocks = bus.subscribe("blocks", mod.EVENT_QUERY_NEW_BLOCK)
        txs = bus.subscribe("txs", "tm.event = 'Tx' AND transfer.to = 'x'")
        block = type("B", (), {"header": type("H", (), {"height": 7})()})()
        bus.publish_new_block(block, "bid", "result")
        bus.publish_new_block_header(block.header)
        bus.publish_new_block_events(7, [_Tx("mint", [("amount", "3")])], 2)
        bus.publish_tx(7, 0, b"k=v", "res",
                       [_Tx("transfer", [("to", "x"), ("to", "y")])])
        bus.publish_tx(7, 1, b"k=w", "res", [_Tx("transfer", [("to", "z")])])
        bus.publish_vote("vote")
        bus.publish_new_round_step({"height": 7, "round": 0,
                                    "step": "Propose"})
        bus.publish_validator_set_updates(["u"])
        bus.publish_new_evidence("ev", 7)
        for name in ("new_round", "complete_proposal", "polka", "lock",
                     "relock", "valid_block", "timeout_propose",
                     "timeout_wait"):
            getattr(bus, f"publish_{name}")({"height": 7})
        seen = []
        while True:
            try:
                msg = await asyncio.wait_for(every.next(), 0.01)
            except asyncio.TimeoutError:
                break
            seen.append((msg.data.kind, sorted(msg.events.items())))
        nb = await blocks.next()
        tx = await txs.next()
        return (seen, nb.data.payload["block"].header.height,
                tx.data.payload["index"], bus.num_clients(),
                bus.num_client_subscriptions("all"),
                sorted(mod.query_for_event(mod.EVENT_VOTE).conditions[0]
                       .__dict__.items()))
    return asyncio.run(go())


def test_event_bus_behaves_as_the_jax_packages():
    mine = _bus_story(events, pubsub)
    theirs = _bus_story(r_events, r_pubsub)
    assert mine == theirs
    kinds = [k for k, _ in mine[0]]
    assert kinds[:5] == ["NewBlock", "NewBlockHeader", "NewBlockEvents",
                         "Tx", "Tx"]
    assert len(kinds) == 17
    assert mine[1:5] == (7, 0, 3, 1)


def test_nop_event_bus_drops_everything():
    bus = events.NopEventBus()
    assert bus.publish_new_block(1, 2, 3) is None
    assert bus.num_clients() == 0
    sub = bus.subscribe("x", "a = 'b'")
    assert isinstance(sub, pubsub.Subscription)
    with pytest.raises(AttributeError):
        bus.not_a_method
