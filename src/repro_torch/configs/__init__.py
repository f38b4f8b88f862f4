"""Architecture registry of the port: ``get_config(arch_id)``.

It holds the architectures whose serving path the port runs so far: the
attention-only GQA decoders and the hybrid Mamba+MoE stack.
"""
from __future__ import annotations

from typing import List

from repro_torch.configs.base import ModelConfig  # noqa: F401  (re-exported)
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as _JAMBA_1_5_LARGE
from repro_torch.configs.starcoder2_3b import CONFIG as _STARCODER2_3B

_CONFIGS = {"starcoder2-3b": _STARCODER2_3B,
            "jamba-1.5-large-398b": _JAMBA_1_5_LARGE}


def get_config(arch: str) -> ModelConfig:
    if arch not in _CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(_CONFIGS)}")
    return _CONFIGS[arch]


def list_archs() -> List[str]:
    return list(_CONFIGS)
