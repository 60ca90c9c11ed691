"""Device resolution for the port's entry points.

Entry points take an explicit ``device`` and default to the card.  Asking
for the card where there is none is an error, never a quiet fall-back to
the CPU: a caller that wants the CPU (the parity tests) says so.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it names a CUDA
    device and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev
