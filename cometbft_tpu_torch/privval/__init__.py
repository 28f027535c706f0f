"""Validator key management and signing with double-sign protection."""
from .file import DoubleSignError, FilePV, PrivValidatorError

__all__ = ["FilePV", "DoubleSignError", "PrivValidatorError"]
