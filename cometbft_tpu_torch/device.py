"""Where the port's entry points run.

Every entry point takes ``device=None`` and resolves it here: ``None``
means the card (``cuda``).  The CPU is used only when a caller asks for
it by name, as the tests do; there is no silent fallback to it.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> ``torch.device("cuda")``; raises if that device is a
    CUDA device and CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card by "
            "default; pass device='cpu' to run the plain PyTorch version")
    return dev
