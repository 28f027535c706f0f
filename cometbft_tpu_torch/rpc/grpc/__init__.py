"""gRPC data-companion API.

Reference: rpc/grpc/server/services/{versionservice,blockservice,
blockresultservice,pruningservice} and the corresponding
proto/cometbft/services/*/v1 schemas, through cometbft_tpu/rpc/grpc/.
Real gRPC on the wire (grpc.aio with generic handlers); messages are
encoded with the descriptor codec (wire/proto.py), so no generated
stubs are needed.

The services' bodies are the servicers of services.py, which import no
``grpc``; the server and the clients (server.py, client.py) import it,
so this package loads them only when one of their names is asked for.
"""
_LAZY = {"GRPCServer": "server", "VersionServiceClient": "client",
         "BlockServiceClient": "client",
         "BlockResultsServiceClient": "client",
         "PruningServiceClient": "client"}

__all__ = list(_LAZY)


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)
