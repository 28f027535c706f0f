"""PyTorch and CUDA port of cometbft_tpu: batch ed25519 commit verification
running through a hand-written CUDA kernel on an NVIDIA H100.

Entry points run on the card unless the caller passes device="cpu".
"""
