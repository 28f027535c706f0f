"""PyTorch and CUDA port of cometbft_tpu: batch ed25519 commit verification
running through a hand-written CUDA kernel on an NVIDIA H100.

Entry points run on the card unless the caller passes device="cpu".
"""

__version__ = "0.1.0"

# Protocol versions (reference: version/version.go:21), as the JAX
# package's root states them; its ABCI_SEMVER differs from
# version.ABCI_SEM_VER there too, and the port keeps both as they are.
BLOCK_PROTOCOL = 11
P2P_PROTOCOL = 9
ABCI_SEMVER = "2.0.0"
