"""lightserve: the proof-serving read path.

The port's copy of cometbft_tpu/lightserve/:

  * ``core.py``: the bodies of the RPC methods ``light_block`` (one
    response with everything a skipping-sync hop needs), ``multiproof``
    (one compact proof over many txs of a block) and
    ``abci_query_batch`` (many app keys a round trip, with one state
    multiproof when the app can serve one);
  * ``cache.py``: a height-keyed response cache: answers at heights
    below the chain tip are immutable, so light clients replaying the
    same sync path are served from memory, not from the stores.
"""
from .cache import Metrics, ResponseCache  # noqa: F401
