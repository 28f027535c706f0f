"""State sync: bootstrap a fresh node from application snapshots."""
from .reactor import StatesyncReactor
from .syncer import StateProvider, Syncer

__all__ = ["StatesyncReactor", "StateProvider", "Syncer"]
