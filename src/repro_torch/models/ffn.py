"""Dense feed-forward layers (SwiGLU / GeLU MLP)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, gelu, swiglu


def init_dense_ffn(gen: torch.Generator, cfg: ModelConfig, d_ff: int,
                   repeats: int, dtype, device):
    d = cfg.d_model
    names = (("w_gate", "w_up", "w_down") if cfg.activation == "swiglu"
             else ("w_up", "w_down"))
    return {n: dense_init(gen, (repeats, d_ff, d) if n == "w_down"
                          else (repeats, d, d_ff), dtype, device)
            for n in names}


def dense_ffn(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "swiglu":
        h = swiglu(x @ params["w_gate"], x @ params["w_up"])
    else:
        h = gelu(x @ params["w_up"])
    return h @ params["w_down"]
