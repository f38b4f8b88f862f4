"""Architecture registry of the port: ``get_config(arch_id)``,
``list_archs()`` and ``get_shape(name)``.

It holds every architecture of the JAX package's registry: the
attention-only GQA decoders (with arctic's MoE beside a dense residual
MLP), llama2-70b (the paper's evaluation model, which the simulator
prices), deepseek-v3-671b (latent attention, MLA), the hybrid Mamba+MoE
stack, the xLSTM stack, the vision-language internvl2-1b (a patch prefix
through a projector) and the speech encoder-decoder
seamless-m4t-large-v2.  As in the JAX package, ``list_archs()`` gives
the ten assigned architectures (``ASSIGNED_ARCHS``), which the dry run
sweeps and the launchers' ``--arch`` accept, and
``list_archs(include_extra=True)`` adds llama2-70b; ``get_config`` takes
any of the eleven.
"""
from __future__ import annotations

from typing import List

from repro_torch.configs.arctic_480b import CONFIG as _ARCTIC_480B
from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    INPUT_SHAPES, InputShape, ModelConfig)
from repro_torch.configs.deepseek_v3_671b import CONFIG as _DEEPSEEK_V3_671B
from repro_torch.configs.internvl2_1b import CONFIG as _INTERNVL2_1B
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as _JAMBA_1_5_LARGE
from repro_torch.configs.llama2_70b import CONFIG as _LLAMA2_70B
from repro_torch.configs.minicpm_2b import CONFIG as _MINICPM_2B
from repro_torch.configs.phi3_medium_14b import CONFIG as _PHI3_MEDIUM_14B
from repro_torch.configs.seamless_m4t_large_v2 import CONFIG as _SEAMLESS_M4T
from repro_torch.configs.starcoder2_3b import CONFIG as _STARCODER2_3B
from repro_torch.configs.starcoder2_7b import CONFIG as _STARCODER2_7B
from repro_torch.configs.xlstm_1_3b import CONFIG as _XLSTM_1_3B

_CONFIGS = {c.name: c for c in (
    _PHI3_MEDIUM_14B, _INTERNVL2_1B, _MINICPM_2B, _SEAMLESS_M4T,
    _STARCODER2_3B, _ARCTIC_480B, _XLSTM_1_3B, _DEEPSEEK_V3_671B,
    _STARCODER2_7B, _JAMBA_1_5_LARGE, _LLAMA2_70B)}


def get_config(arch: str) -> ModelConfig:
    if arch not in _CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(_CONFIGS)}")
    return _CONFIGS[arch]


ASSIGNED_ARCHS = tuple(k for k in _CONFIGS if k != "llama2-70b")


def list_archs(include_extra: bool = False) -> List[str]:
    return list(_CONFIGS) if include_extra else list(ASSIGNED_ARCHS)


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]
