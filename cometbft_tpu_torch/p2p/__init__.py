"""P2P: the distributed communication backend.

Reference: p2p/ — Switch (peer lifecycle + reactor registry),
MConnection (multiplexed prioritized streams over one TCP conn),
SecretConnection (authenticated encryption), PEX/address book — through
cometbft_tpu/p2p/, whose modules this package copies (all but the fuzz
link wrappers, ROADMAP.md A.7e-6).

Validators are WAN peers: this host-side socket stack carries consensus;
the card is used only inside signature verification.
"""
from .conn import ChannelDescriptor, MConnection
from .key import NodeKey, node_id_from_pub_key
from .pex import AddrBook, PexReactor
from .secret_connection import SecretConnection
from .switch import NodeInfo, Peer, Reactor, Switch

__all__ = ["AddrBook", "ChannelDescriptor", "MConnection", "NodeInfo",
           "NodeKey", "PexReactor", "Peer", "Reactor", "SecretConnection",
           "Switch", "node_id_from_pub_key"]
