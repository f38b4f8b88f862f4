"""Device resolution for the port's entry points.

Entry points default to ``"cuda"`` and raise where there is no card: a
run that asked for the GPU never falls back to the CPU silently.  Callers
that mean the CPU (the parity tests) pass ``device="cpu"``.
"""
from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device]


def resolve_device(device: Device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU")
    return dev
