"""Protocol versions (the port's copy of cometbft_tpu/version.py).

Reference: version/version.go:21 — block protocol 11, which every
Header carries and Header.validate_basic checks; p2p protocol 9, which
every NodeInfo carries; the software version a State records (it is
part of State.bytes()) and the ABCI semver the kvstore app reports.
"""

CMT_SEM_VER = "1.0.0-tpu"
ABCI_SEM_VER = "2.2.0"
ABCI_VERSION = ABCI_SEM_VER

# uint64 protocol versions
P2P_PROTOCOL = 9
BLOCK_PROTOCOL = 11
