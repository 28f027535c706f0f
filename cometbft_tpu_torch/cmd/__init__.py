"""The node operator CLI (``python -m cometbft_tpu_torch.cmd``)."""
