"""GQA attention (RoPE, optional sliding window) on tensors.

Three execution modes of :func:`gqa_forward`, as in the JAX package:
  * full          — prefill over S tokens through the prefill kernel
                    (:func:`repro_torch.kernels.flash_attention.flash_attention_cuda`);
  * paged decode  — one token per active request; the new K/V line is
                    written into the cache and attention reads back only the
                    request's live line blocks through the paged decode
                    kernel;
  * dense decode  — one token against each request's own rows of the
                    cache, lines past its length masked, through the dense
                    decode kernel (the path of engines that do not page:
                    the hybrid stack, and the oracle of paged engines).

Caches are updated in place: a state leaf handed in is the leaf that comes
back, written.  KV caches use ring-buffer indexing when the capacity is
smaller than the number of positions.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  paged_decode_attention_cuda)
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.models.common import apply_rope, dense_init

Clock = Union[int, torch.Tensor]


class PagedDecode:
    """Paged-decode context threaded through the layer stack.

    The decode batch is *compacted*: row ``i`` of the activations is
    request slot ``slots[i]`` of the full ``num_slots``-row cache, and its
    K/V is read back through ``tables[i]``, physical line-block ids into the
    pool view of the cache (the dense ``(B, W, ...)`` leaf viewed as
    ``(B * W / block_lines, block_lines, ...)``)."""

    __slots__ = ("slots", "tables", "block_lines")

    def __init__(self, slots: torch.Tensor, tables: torch.Tensor,
                 block_lines: int):
        self.slots = slots.long()     # (Bc,) state rows of the batch
        self.tables = tables          # (Bc, max_blocks) int32 pool block ids
        self.block_lines = block_lines


# ---------------------------------------------------------------------------
# Ring-buffer cache helpers
# ---------------------------------------------------------------------------


def ring_write(cache: torch.Tensor, values: torch.Tensor, t: Clock,
               capacity: int) -> torch.Tensor:
    """Write values (B, S, ...) at logical positions [t, t+S) modulo
    capacity, in place.  ``t`` is a scalar clock shared by the batch
    (prefill) or a (B,) per-request clock (continuous batching decode).
    With S >= capacity only the last ``capacity`` rows land."""
    B, S = values.shape[:2]
    dev = cache.device
    if S >= capacity:
        values = values[:, -capacity:]
        t = t + S - capacity
        S = capacity
    offsets = torch.arange(S, device=dev)
    if isinstance(t, int) or t.dim() == 0:   # an int clock stays on the host
        cache[:, (offsets + t) % capacity] = values
    else:
        pos = (t.long()[:, None] + offsets[None]) % capacity
        cache[torch.arange(B, device=dev)[:, None], pos] = values
    return cache


# ---------------------------------------------------------------------------
# GQA module
# ---------------------------------------------------------------------------


def init_gqa(gen: torch.Generator, cfg: ModelConfig, repeats: int, dtype,
             device):
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, (repeats, d, h * hd), dtype, device),
        "wk": dense_init(gen, (repeats, d, kvh * hd), dtype, device),
        "wv": dense_init(gen, (repeats, d, kvh * hd), dtype, device),
        "wo": dense_init(gen, (repeats, h * hd, d), dtype, device),
    }


def gqa_forward(
    cfg: ModelConfig,
    params,
    x: torch.Tensor,                 # (B, S, D)
    *,
    mode: str,                       # "full" | "decode"
    positions: torch.Tensor,         # (S,) absolute positions (or (B, S))
    state=None,                      # KV cache dict {"k", "v"}: (B, W, KVH, hd)
    t: Optional[Clock] = None,       # clock (cache writes)
    window: Optional[int] = None,
    update_cache: bool = False,
    causal: bool = True,
    history: int = 0,
    paged: Optional[PagedDecode] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    if history:
        raise NotImplementedError(
            "chunked-prefill resume (history > 0) waits for the chunk-resume "
            "slice of the port")
    B, S, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    q = (x @ params["wq"]).reshape(B, S, h, hd)
    k = (x @ params["wk"]).reshape(B, S, kvh, hd)
    v = (x @ params["wv"]).reshape(B, S, kvh, hd)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if mode == "full":
        out = flash_attention_cuda(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal, scale=scale,
                                   window=window)
        if update_cache and state is not None:
            cap = state["k"].shape[1]
            t0 = t if t is not None else 0
            ring_write(state["k"], k, t0, cap)
            ring_write(state["v"], v, t0, cap)
    elif mode == "decode" and paged is not None:
        # the batch is compacted to the active primary slots: the new K/V
        # line lands at (slot, t mod W) of the full cache, and attention
        # gathers back ONLY the request's live line blocks
        if state is None or t is None or S != 1:
            raise ValueError("paged decode needs a state, a clock and S == 1")
        kc, vc = state["k"], state["v"]
        cap = kc.shape[1]
        pos = (t % cap).long()
        kc[paged.slots, pos] = k[:, 0]
        vc[paged.slots, pos] = v[:, 0]
        bl = paged.block_lines
        pool_shape = (kc.shape[0] * (cap // bl), bl, kvh, hd)
        lengths = torch.clamp(t + 1, max=cap).to(torch.int32)
        out = paged_decode_attention_cuda(
            q.contiguous(), kc.view(pool_shape), vc.view(pool_shape),
            paged.tables, lengths, scale=scale)
    elif mode == "decode":
        if state is None or t is None:
            raise ValueError("decode needs a state and a clock")
        if S != 1:
            raise ValueError("dense decode takes one token per request")
        cap = state["k"].shape[1]
        kc = ring_write(state["k"], k, t, cap)
        vc = ring_write(state["v"], v, t, cap)
        # after the write the live lines of each ring are a prefix of
        # length min(t + 1, cap)
        lengths = torch.clamp(torch.as_tensor(t, device=x.device) + S,
                              max=cap).to(torch.int32).expand(B)
        out = decode_attention_cuda(q.contiguous(), kc, vc,
                                    lengths.contiguous(), scale=scale)
    else:
        raise ValueError(mode)

    out = out.reshape(B, S, h * hd) @ params["wo"]
    return out, state
