"""Serving-state size accounting per architecture.

AcceLLM's scheduler balances decode batches by the *bytes of state read per
step* (decode is HBM-bandwidth-bound, §3.3) and its redundancy manager
budgets replica memory. Both need bytes-per-request as a function of the
current sequence length. For attention archs that is length-proportional
KV; for MLA it is the (much smaller) latent; for SSM blocks it is a
length-independent constant — which is why the balancer weights requests by
``state_bytes(cfg, length)`` rather than raw length (DESIGN.md §4).

These formulas are consumed through ``repro_torch.kvstore.LineCosts``, the cost
card both the live ``PagedStore`` and the simulator's ``SimStore`` ledger
charge from — change them here and every backend reprices identically.

The per-config quantities are memoized: configs are frozen (hashable)
and these are pure functions of them, yet the simulator prices every
decode iteration through ``state_bytes_at`` — without the cache the
walk over ``block_pattern`` dominates million-request replays.
"""
from __future__ import annotations

from functools import lru_cache

from repro_torch.configs.base import ModelConfig
from repro_torch.models.state import xlstm_dims


@lru_cache(maxsize=None)
def bytes_per_token(cfg: ModelConfig, dtype_bytes: int = 2) -> float:
    """KV-cache bytes added per token (attention layers only)."""
    n_attn = sum(1 for b in cfg.block_pattern if b == "attn")
    if cfg.attention_kind == "mla":
        per = (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) * dtype_bytes
    else:
        per = 2 * cfg.num_kv_heads * cfg.head_dim * dtype_bytes
    return n_attn * per


@lru_cache(maxsize=None)
def recurrent_state_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    """Length-independent state that CHANGES every decode step
    (SSM/conv/xLSTM memories).  This is the constant-size per-step mirror
    payload for recurrent blocks (AcceLLM treats it as "one KV line" of
    fixed size)."""
    total = 0
    for blk in cfg.block_pattern:
        if blk == "mamba":
            mc = cfg.mamba
            d_in = mc.expand * cfg.d_model
            total += d_in * mc.d_state * 4          # ssm state f32
            total += mc.d_conv * d_in * dtype_bytes  # conv window
        elif blk == "mlstm":
            d_in, hd = xlstm_dims(cfg, "mlstm")
            h = cfg.num_heads
            total += (h * hd * hd + h * hd + h) * 4
            total += cfg.xlstm.conv1d_kernel_size * d_in * 4
        elif blk == "slstm":
            total += 4 * cfg.d_model * 4
    return total


@lru_cache(maxsize=None)
def static_state_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    """Length-independent state written once at prefill and immutable
    thereafter (enc-dec: cached encoder output + cross K/V).  Streamed
    when a request is replicated, never re-mirrored per step."""
    total = 0
    if cfg.is_encoder_decoder:
        src = cfg.encoder.max_source_positions
        total += src * cfg.d_model * dtype_bytes
        total += (len(cfg.block_pattern) * 2 * src
                  * cfg.num_kv_heads * cfg.head_dim * dtype_bytes)
    return total


@lru_cache(maxsize=None)
def fixed_state_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    """Length-independent state bytes (recurrent memories + enc-dec
    static caches)."""
    return (recurrent_state_bytes(cfg, dtype_bytes)
            + static_state_bytes(cfg, dtype_bytes))


def state_bytes_at(cfg: ModelConfig, length: int, dtype_bytes: int = 2) -> float:
    """Total serving-state bytes for one request at sequence length."""
    return bytes_per_token(cfg, dtype_bytes) * length + fixed_state_bytes(
        cfg, dtype_bytes)


def decode_read_bytes(cfg: ModelConfig, length: int,
                      dtype_bytes: int = 2) -> float:
    """Bytes streamed from HBM for this request in ONE decode step — the
    quantity the load balancer equalizes across a pair (weights are shared
    by the batch, so the per-request marginal cost is exactly its state)."""
    return state_bytes_at(cfg, length, dtype_bytes)
