"""Shared helpers of the port: device resolution and state-size accounting."""
from repro_torch.core.device import resolve_device

__all__ = ["resolve_device"]
