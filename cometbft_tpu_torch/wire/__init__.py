"""Deterministic protobuf wire encoding for the consensus-critical bytes
the port signs and carries across (canonical votes, commits, validator
sets)."""
from .proto import Msg, F, encode, decode, marshal_delimited, \
    unmarshal_delimited
from . import pb

__all__ = ["Msg", "F", "encode", "decode", "marshal_delimited",
           "unmarshal_delimited", "pb"]
