"""Protocol versions (the port's copy of cometbft_tpu/version.py).

Reference: version/version.go:21 — block protocol 11, which every
Header carries and Header.validate_basic checks.
"""

# uint64 protocol version
BLOCK_PROTOCOL = 11
