"""Node assembly: wiring every subsystem into one process."""
from .node import Node, NodeError, init_files

__all__ = ["Node", "NodeError", "init_files"]
