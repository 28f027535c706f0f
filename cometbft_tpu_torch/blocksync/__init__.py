"""Block sync: catch up by downloading committed blocks."""
from .pool import BlockPool
from .reactor import BlocksyncReactor

__all__ = ["BlocksyncReactor", "BlockPool"]
