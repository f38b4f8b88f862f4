"""Dense feed-forward layers (SwiGLU / GeLU MLP).

Under tensor parallelism ``w_gate``/``w_up`` are column-parallel (their
input enters through ``sharding.copy_in``) and ``w_down`` row-parallel:
a rank holding fewer than ``d_ff`` rows of ``w_down`` sums its partial
with the other ranks'.  Under sequence parallelism (``seq``) the input is
the rank's rows of the residual: they are gathered at the entry and the
sum reduce-scattered at the exit (``sharding.module_in``/``module_out``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import sharding
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


def dense_ffn(cfg: ModelConfig, params, x: torch.Tensor,
              d_ff: Optional[int] = None, seq: bool = False) -> torch.Tensor:
    """``d_ff`` is the layer's whole hidden width, which tells a rank's
    shard (fewer rows) from the whole layer."""
    sharded = d_ff is not None and params["w_down"].shape[-2] != d_ff
    x = sharding.module_in(x, sharded, seq)
    if cfg.activation == "swiglu":
        h = swiglu(x @ params["w_gate"], x @ params["w_up"])
    else:
        h = gelu(x @ params["w_up"])
    return sharding.module_out(h @ params["w_down"], sharded, seq)
