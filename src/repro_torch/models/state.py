"""Serving-state trees: attention KV caches (dense / ring-buffer) and Mamba
states.

States are nested dicts of tensors, laid out as in the JAX package so the
two can be compared leaf by leaf.  Every state dict carries only tensors;
the scalar clock ``t`` lives in the engine, passed per call.

Layout (R = segment repeat dim, added by the layer stack):
  attention KV : k,v          (R, B, W, KVH, HD)    W = cache window capacity
  mamba        : conv         (R, B, d_conv, d_in)  model dtype
                 ssm          (R, B, d_in, d_state) f32
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def cache_capacity(cfg: ModelConfig, seq_len: int) -> int:
    """KV capacity for attention layers: the sliding window when it is
    shorter than ``seq_len`` (a ring buffer), else full ``seq_len``."""
    if cfg.sliding_window is not None and seq_len > cfg.sliding_window:
        return cfg.sliding_window
    return seq_len


def init_attn_kv(cfg: ModelConfig, repeats: int, batch: int, capacity: int,
                 dtype, device):
    if cfg.attention_kind != "gqa":
        raise NotImplementedError(
            f"{cfg.attention_kind} attention state waits for the MLA slice "
            f"of the port")
    shape = (repeats, batch, capacity, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_mamba_state(cfg: ModelConfig, repeats: int, batch: int, dtype,
                     device):
    mc = cfg.mamba
    d_in = mc.expand * cfg.d_model
    return {
        "conv": torch.zeros((repeats, batch, mc.d_conv, d_in), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((repeats, batch, d_in, mc.d_state),
                           dtype=torch.float32, device=device),
    }


def xlstm_dims(cfg: ModelConfig, kind: str):
    xc = cfg.xlstm
    if kind == "mlstm":
        d_in = int(xc.proj_factor_mlstm * cfg.d_model)
    else:
        d_in = int(xc.proj_factor_slstm * cfg.d_model)
    head_dim = d_in // cfg.num_heads
    return d_in, head_dim


def init_layer_state(cfg: ModelConfig, kind: str, repeats: int, batch: int,
                     capacity: int, dtype, device):
    """State for one position of a segment, stacked over its repeats."""
    if kind == "attn":
        return init_attn_kv(cfg, repeats, batch, capacity, dtype, device)
    if kind == "mamba":
        return init_mamba_state(cfg, repeats, batch, dtype, device)
    raise NotImplementedError(
        f"{kind!r} block state waits for the xLSTM slice of the port")


def state_bytes(state) -> int:
    """Physical bytes of every tensor in a (nested) state tree."""
    if isinstance(state, torch.Tensor):
        return state.numel() * state.element_size()
    if isinstance(state, dict):
        return sum(state_bytes(v) for v in state.values())
    if isinstance(state, (list, tuple)):
        return sum(state_bytes(v) for v in state)
    return 0
