"""Architecture registry of the port: ``get_config(arch_id)``.

It holds the architectures whose serving path the port runs so far: the
attention-only GQA decoders.
"""
from __future__ import annotations

from typing import List

from repro_torch.configs.base import ModelConfig  # noqa: F401  (re-exported)
from repro_torch.configs.starcoder2_3b import CONFIG as _STARCODER2_3B

_CONFIGS = {"starcoder2-3b": _STARCODER2_3B}


def get_config(arch: str) -> ModelConfig:
    if arch not in _CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(_CONFIGS)}")
    return _CONFIGS[arch]


def list_archs() -> List[str]:
    return list(_CONFIGS)
