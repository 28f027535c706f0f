"""State and execution: the bridge between consensus and the application
(reference: state/)."""
from .state import State, StateError, make_genesis_state

__all__ = ["State", "StateError", "make_genesis_state"]
