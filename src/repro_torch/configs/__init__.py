"""Architecture registry of the port: ``get_config(arch_id)``.

It holds the architectures whose serving path the port runs so far: the
attention-only GQA decoders (with arctic's MoE beside a dense residual
MLP), llama2-70b (the paper's evaluation model, which the simulator
prices) and the hybrid Mamba+MoE stack.
"""
from __future__ import annotations

from typing import List

from repro_torch.configs.arctic_480b import CONFIG as _ARCTIC_480B
from repro_torch.configs.base import ModelConfig  # noqa: F401  (re-exported)
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as _JAMBA_1_5_LARGE
from repro_torch.configs.llama2_70b import CONFIG as _LLAMA2_70B
from repro_torch.configs.minicpm_2b import CONFIG as _MINICPM_2B
from repro_torch.configs.phi3_medium_14b import CONFIG as _PHI3_MEDIUM_14B
from repro_torch.configs.starcoder2_3b import CONFIG as _STARCODER2_3B
from repro_torch.configs.starcoder2_7b import CONFIG as _STARCODER2_7B

_CONFIGS = {c.name: c for c in (
    _PHI3_MEDIUM_14B, _MINICPM_2B, _STARCODER2_3B, _ARCTIC_480B,
    _STARCODER2_7B, _JAMBA_1_5_LARGE, _LLAMA2_70B)}


def get_config(arch: str) -> ModelConfig:
    if arch not in _CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(_CONFIGS)}")
    return _CONFIGS[arch]


def list_archs() -> List[str]:
    return list(_CONFIGS)
