"""Serving-state trees: attention KV caches (dense / ring-buffer / MLA
latent), Mamba states and xLSTM states.

States are nested dicts of tensors, laid out as in the JAX package so the
two can be compared leaf by leaf.  Every state dict carries only tensors;
the scalar clock ``t`` lives in the engine, passed per call.

Layout (R = segment repeat dim, added by the layer stack):
  attention KV : k,v          (R, B, W, KVH, HD)    W = cache window capacity
  MLA latent   : c_kv         (R, B, W, kv_lora_rank)
                 k_rope       (R, B, W, qk_rope_head_dim)
  mamba        : conv         (R, B, d_conv, d_in)  model dtype
                 ssm          (R, B, d_in, d_state) f32
  mlstm        : C            (R, B, H, DK, DV)     f32
                 n            (R, B, H, DK)         f32
                 m            (R, B, H)             f32
                 conv         (R, B, ksize, d_in)   f32
  slstm        : c,n,h,m      (R, B, d_model)       f32
  cross K/V    : xk,xv        (R, B, S_src, KVH, HD) (enc-dec decoder layers)
  encoder memory (enc-dec): the state's ``enc_out`` (B, S_src, D)
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig


def cache_capacity(cfg: ModelConfig, seq_len: int,
                   long_context: bool = False) -> int:
    """KV capacity for attention layers: a ring buffer of the sliding
    window when it is shorter than ``seq_len``, else full ``seq_len``.
    Under the long-context policy every family but the hybrid keeps a ring
    of ``sliding_window or long_context_window`` lines; the hybrid stack
    (Jamba, whose few attention layers make it affordable) keeps full KV,
    which the dry run shards over the data axis."""
    if not long_context:
        if cfg.sliding_window is not None and seq_len > cfg.sliding_window:
            return cfg.sliding_window
        return seq_len
    if cfg.family == "hybrid":
        return seq_len
    return min(cfg.sliding_window or cfg.long_context_window, seq_len)


def init_attn_kv(cfg: ModelConfig, repeats: int, batch: int, capacity: int,
                 dtype, device):
    if cfg.attention_kind == "mla":
        m = cfg.mla
        lead = (repeats, batch, capacity)
        return {"c_kv": torch.zeros(lead + (m.kv_lora_rank,), dtype=dtype,
                                    device=device),
                "k_rope": torch.zeros(lead + (m.qk_rope_head_dim,),
                                      dtype=dtype, device=device)}
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


def init_mlstm_state(cfg: ModelConfig, repeats: int, batch: int, device):
    d_in, hd = xlstm_dims(cfg, "mlstm")
    h, lead = cfg.num_heads, (repeats, batch)
    ks = cfg.xlstm.conv1d_kernel_size
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros(lead + (h, hd, hd), **f32),
            "n": torch.zeros(lead + (h, hd), **f32),
            "m": torch.zeros(lead + (h,), **f32),
            "conv": torch.zeros(lead + (ks, d_in), **f32)}


def init_slstm_state(cfg: ModelConfig, repeats: int, batch: int, device):
    shape = (repeats, batch, cfg.d_model)
    return {k: torch.zeros(shape, dtype=torch.float32, device=device)
            for k in ("c", "n", "h", "m")}


def init_layer_state(cfg: ModelConfig, kind: str, repeats: int, batch: int,
                     capacity: int, dtype, device,
                     cross_len: Optional[int] = None):
    """State for one position of a segment, stacked over its repeats; an
    enc-dec decoder layer (``cross_len``) also caches its cross K/V."""
    if kind == "attn":
        st = init_attn_kv(cfg, repeats, batch, capacity, dtype, device)
        if cross_len is not None:
            shape = (repeats, batch, cross_len, cfg.num_kv_heads,
                     cfg.head_dim)
            st["xk"] = torch.zeros(shape, dtype=dtype, device=device)
            st["xv"] = torch.zeros(shape, dtype=dtype, device=device)
        return st
    if kind == "mamba":
        return init_mamba_state(cfg, repeats, batch, dtype, device)
    if kind == "mlstm":
        return init_mlstm_state(cfg, repeats, batch, device)
    if kind == "slstm":
        return init_slstm_state(cfg, repeats, batch, device)
    raise ValueError(kind)


def state_bytes(state) -> int:
    """Physical bytes of every tensor in a (nested) state tree."""
    if isinstance(state, torch.Tensor):
        return state.numel() * state.element_size()
    if isinstance(state, dict):
        return sum(state_bytes(v) for v in state.values())
    if isinstance(state, (list, tuple)):
        return sum(state_bytes(v) for v in state)
    return 0
