"""Attention: GQA (RoPE, optional sliding window) and MLA (DeepSeek's
multi-head latent attention), on tensors.

Three execution modes of :func:`gqa_forward`, as in the JAX package:
  * full          — prefill over S tokens through the prefill kernel
                    (:func:`repro_torch.kernels.flash_attention.flash_attention_cuda`);
                    with ``history > 0`` a chunk resumes a prompt whose
                    first ``history`` rows are cached, through the same
                    kernel at ``q_offset = history``; with ``train``
                    (``forward_train``) through the plain chunked
                    :func:`flash_attention` instead, on which autograd
                    runs: the kernel has no backward, as the JAX
                    package's Pallas kernel has none;
  * paged decode  — one token per active request; the new K/V line is
                    written into the cache and attention reads back only the
                    request's live line blocks through the paged decode
                    kernel;
  * dense decode  — one token against each request's own rows of the
                    cache, lines past its length masked, through the dense
                    decode kernel (the path of engines that do not page:
                    the hybrid stack, and the oracle of paged engines).

:func:`cross_attn_forward` (enc-dec decoder layers) attends to the
encoder memory through the plain chunked :func:`flash_attention`, as the
JAX package does on every backend; its K/V are projected once at prefill
and cached per layer (``xk``/``xv``).

:func:`gqa_forward`, :func:`cross_attn_forward` and :func:`mla_forward`
run under tensor parallelism on the rank's whole heads, read from the
weights' shapes: the input every rank holds whole enters the
column-parallel projections through ``sharding.copy_in`` (MLA: the
latents), and the row-parallel ``wo`` partials are summed.  Under
sequence parallelism (``seq``: ``x`` is the rank's rows of the residual)
the entry gathers the rows and the exit reduce-scatters the sum
(``sharding.module_in``/``module_out``); attention runs on the gathered
rows at the rank's heads, with the shapes it has with the sequence whole.
MLA computes its latents on the rank's rows and gathers them.

:func:`mla_forward` computes MLA as the JAX package does, outside any
kernel: in full mode it expands the latent into per-head K/V (qk head dim
192, v 128) and attends through the plain chunked online softmax
:func:`flash_attention`; in decode mode it scores and reads in latent
space (the absorbed path, in f32).  Its cache holds the latent ``c_kv``
and the shared roped key ``k_rope`` per line, and it never pages.

Caches are updated in place: a state leaf handed in is the leaf that comes
back, written.  KV caches use ring-buffer indexing when the capacity is
smaller than the number of positions.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from repro_torch import sharding
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import decode_attention as decode_kernels
from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  paged_decode_attention_cuda)
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.models.common import apply_rope, dense_init, rms_norm
from repro_torch.core import opcount as count

Clock = Union[int, torch.Tensor]

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Chunked online-softmax attention (plain PyTorch)
# ---------------------------------------------------------------------------


def _pick_chunk(n: int, target: int) -> int:
    """Largest divisor of n that is <= target."""
    c = min(n, target)
    while n % c:
        c -= 1
    return c


def flash_attention(
    q: torch.Tensor,     # (B, Sq, H, hd)
    k: torch.Tensor,     # (B, Skv, KVH, hd)
    v: torch.Tensor,     # (B, Skv, KVH, dv)
    *,
    causal: bool,
    scale: float,
    window: Optional[int] = None,
    q_offset: int = 0,   # absolute position of q[0] relative to k[0]
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over q and kv chunks in f32, the JAX
    package's model-level ``flash_attention``: a score tensor never exceeds
    ``(B, H, q_chunk, kv_chunk)``.  The value head dim may differ from the
    query's (MLA: qk 192, v 128).  Under a causal mask the q blocks are
    grouped into at most 8 bands, and each band's blocks visit only the kv
    blocks the band can see.  Returns (B, Sq, H, dv) in q's dtype."""
    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    dv = v.shape[3]
    G = H // KVH
    qc = _pick_chunk(Sq, q_chunk)
    kc = _pick_chunk(Skv, kv_chunk)
    nq, nk = Sq // qc, Skv // kc
    dev = q.device
    arange_q = torch.arange(qc, device=dev)
    arange_k = torch.arange(kc, device=dev)

    def kv_block(t: torch.Tensor, j: int) -> torch.Tensor:
        # (B, kc, KVH, d) -> (B, H, kc, d) in f32: the GQA broadcast
        blk = t[:, j * kc: (j + 1) * kc].float()
        if G > 1:
            blk = blk.repeat_interleave(G, dim=2)
        return blk.transpose(1, 2)

    def kv_step(j: int, carry, qb, k, v, qp):
        m, l, acc = carry
        s = (qb @ kv_block(k, j).transpose(-1, -2)) * scale
        kp = j * kc + arange_k
        mask = torch.ones((qc, kc), dtype=torch.bool, device=dev)
        if causal:
            mask &= qp[:, None] >= kp[None, :]
        if window is not None:
            mask &= qp[:, None] - kp[None, :] < window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p @ kv_block(v, j)
        return (m_new, l, acc), None

    def q_block(i: int, q, k, v, kv_lo: int, kv_hi: int) -> torch.Tensor:
        qb = q[:, i * qc: (i + 1) * qc].float().transpose(1, 2)
        qp = q_offset + i * qc + arange_q
        m = torch.full((B, H, qc), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, qc, dv), dtype=torch.float32, device=dev)
        (m, l, acc), _ = count.steps(
            "attention.kv_blocks", kv_hi - kv_lo,
            lambda jj, carry, qb, k, v: kv_step(kv_lo + jj, carry, qb, k, v,
                                                qp),
            (m, l, acc), qb, k, v)
        out = acc / torch.clamp(l, min=1e-30)[..., None]   # (B, H, qc, dv)
        return out.transpose(1, 2)                          # (B, qc, H, dv)

    def q_blocks(i0: int, i1: int, kv_lo: int, kv_hi: int):
        _, outs = count.steps(
            "attention.q_blocks", i1 - i0,
            lambda ii, carry, q, k, v: (carry, q_block(i0 + ii, q, k, v,
                                                       kv_lo, kv_hi)),
            None, q, k, v)
        return outs

    outs = []
    if causal and nq > 1:
        n_bands = min(nq, 8)
        per = -(-nq // n_bands)
        for b0 in range(0, nq, per):
            b1 = min(nq, b0 + per)
            kv_hi = min(nk, -(-(q_offset + b1 * qc) // kc))
            kv_lo = 0
            if window is not None:
                kv_lo = max(0, (q_offset + b0 * qc - window + 1) // kc)
            outs += q_blocks(b0, b1, kv_lo, kv_hi)
    else:
        outs = q_blocks(0, nq, 0, nk)
    return torch.cat(outs, dim=1).to(q.dtype)


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


def ring_valid(t_next: Clock, capacity: int) -> torch.Tensor:
    """Valid-line mask after ``t_next`` tokens were written into a ring of
    ``capacity`` lines: a scalar clock gives (capacity,), a (B,) clock
    (B, capacity)."""
    t_next = torch.as_tensor(t_next)
    lines = torch.arange(capacity, device=t_next.device)
    n_valid = torch.clamp(t_next, max=capacity)
    if n_valid.dim() == 0:
        return lines < n_valid
    return lines[None] < n_valid[:, None]


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
    train: bool = False,
    seq: bool = False,
) -> Tuple[torch.Tensor, Optional[dict]]:
    hd = cfg.head_dim
    # under tensor parallelism the projections hold this rank's whole
    # heads (column-parallel wq/wk/wv, row-parallel wo): the local head
    # counts come from the weights
    h, kvh = params["wq"].shape[-1] // hd, params["wk"].shape[-1] // hd
    scale = 1.0 / math.sqrt(hd)
    x = sharding.module_in(x, h != cfg.num_heads, seq)
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, h, hd)
    k = (x @ params["wk"]).reshape(B, S, kvh, hd)
    v = (x @ params["wv"]).reshape(B, S, kvh, hd)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if mode == "full" and train:
        # training: the model-level chunked attention, the path on which
        # the JAX package takes its gradient; no cache
        if history or update_cache:
            raise ValueError("training attends over the whole sequence "
                             "and writes no cache")
        out = flash_attention(q, k, v, causal=causal, scale=scale,
                              window=window)
    elif mode == "full" and history:
        # chunked-prefill continuation: this chunk's queries attend to the
        # cached rows [0, history) (roped at their absolute positions) and
        # to the chunk itself, through the prefill kernel at q_offset =
        # history; the chunk's rows land at [t, t + S)
        if state is None or not causal:
            raise ValueError("a chunk resume needs a cache and causal "
                             "attention")
        k_all = torch.cat([state["k"][:, :history].to(k.dtype), k], dim=1)
        v_all = torch.cat([state["v"][:, :history].to(v.dtype), v], dim=1)
        out = flash_attention_cuda(q.contiguous(), k_all, v_all, causal=True,
                                   scale=scale, window=window,
                                   q_offset=history)
        if update_cache:
            cap = state["k"].shape[1]
            t0 = t if t is not None else history
            ring_write(state["k"], k, t0, cap)
            ring_write(state["v"], v, t0, cap)
    elif mode == "full":
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
        out = decode_kernels.paged_decode_attention_cuda(
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
    # sum the ranks' head partials
    return sharding.module_out(out, h != cfg.num_heads, seq), state


# ---------------------------------------------------------------------------
# Cross attention (encoder-decoder)
# ---------------------------------------------------------------------------


def init_cross_attn(gen: torch.Generator, cfg: ModelConfig, repeats: int,
                    dtype, device):
    return init_gqa(gen, cfg, repeats, dtype, device)


def cross_attn_forward(
    cfg: ModelConfig,
    params,
    x: torch.Tensor,                       # (B, S, D) decoder states
    *,
    enc_out: Optional[torch.Tensor],       # (B, S_src, D) or None when cached
    state=None,                            # {"xk", "xv"}: (B, S_src, KVH, hd)
    precompute: bool = False,
    seq: bool = False,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Decoder queries against the encoder memory, not causal.  With
    ``precompute`` (prefill), or with no cached K/V, K and V are projected
    from ``enc_out``; a state's ``xk``/``xv`` are overwritten in place, or
    added to a state that has none, as the JAX package adds them.
    Otherwise (decode) the cached ones are read.  As in the JAX package, it
    attends through the plain chunked :func:`flash_attention` on every
    device, so it reaches no kernel.  Under ``seq`` the decoder rows are
    gathered and the encoder memory stays whole."""
    hd = cfg.head_dim
    # under tensor parallelism the rank's whole heads, as in gqa_forward
    h, kvh = params["wq"].shape[-1] // hd, params["wk"].shape[-1] // hd
    scale = 1.0 / math.sqrt(hd)
    sharded = h != cfg.num_heads
    x = sharding.module_in(x, sharded, seq)
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, h, hd)
    cached = state is not None and "xk" in state
    if precompute or not cached:
        if enc_out is None:
            raise ValueError("cross attention needs enc_out or cached K/V")
        if sharded:
            enc_out = sharding.copy_in(enc_out)
        k = (enc_out @ params["wk"]).reshape(B, -1, kvh, hd)
        v = (enc_out @ params["wv"]).reshape(B, -1, kvh, hd)
        if cached:
            if state["xk"].shape != k.shape:
                raise ValueError(
                    f"encoder memory of {k.shape[1]} frames for a cross "
                    f"cache of {state['xk'].shape[1]}")
            state["xk"].copy_(k)
            state["xv"].copy_(v)
        elif state is not None:
            state["xk"], state["xv"] = k, v
    else:
        k, v = state["xk"], state["xv"]
    out = flash_attention(q, k, v, causal=False, scale=scale)
    out = out.reshape(B, S, h * hd) @ params["wo"]
    return sharding.module_out(out, sharded, seq), state


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# ---------------------------------------------------------------------------


def init_mla(gen: torch.Generator, cfg: ModelConfig, repeats: int, dtype,
             device):
    m = cfg.mla
    d, h, r = cfg.d_model, cfg.num_heads, repeats
    nope, vd = m.qk_nope_head_dim, m.v_head_dim
    return {
        "wq_a": dense_init(gen, (r, d, m.q_lora_rank), dtype, device),
        "q_norm": torch.ones((r, m.q_lora_rank), dtype=dtype, device=device),
        "wq_b": dense_init(gen, (r, m.q_lora_rank, h * m.qk_head_dim), dtype,
                           device),
        "wkv_a": dense_init(gen, (r, d, m.kv_lora_rank + m.qk_rope_head_dim),
                            dtype, device),
        "kv_norm": torch.ones((r, m.kv_lora_rank), dtype=dtype,
                              device=device),
        "wkv_b": dense_init(gen, (r, m.kv_lora_rank, h * (nope + vd)), dtype,
                            device),
        "wo": dense_init(gen, (r, h * vd, d), dtype, device),
    }


def _mla_qkv_latent(cfg: ModelConfig, params, x: torch.Tensor,
                    positions: torch.Tensor, seq: bool = False):
    """The shared projections: roped q split into (nope, rope), the normed
    latent and the roped shared key-rope.  Under tensor parallelism q
    holds the rank's whole heads (the head count comes from ``wq_b``);
    the latent and the key-rope are whole on every rank.  Under ``seq``
    the latents of the rank's rows are gathered in one all-gather, and
    the whole leaves that ran on those rows sum their gradients over the
    model ranks (``copy_in``)."""
    m = cfg.mla
    h = params["wq_b"].shape[-1] // m.qk_head_dim
    sharded = h != cfg.num_heads
    w = {k: sharding.copy_in(params[k]) if seq else params[k]
         for k in ("wq_a", "q_norm", "wkv_a", "kv_norm")}
    q = rms_norm(x @ w["wq_a"], w["q_norm"], cfg.rms_norm_eps)
    kv = x @ w["wkv_a"]
    c_kv = rms_norm(kv[..., :m.kv_lora_rank], w["kv_norm"],
                    cfg.rms_norm_eps)
    k_pe = kv[..., m.kv_lora_rank:]
    if seq:
        lat = sharding.seq_gather(torch.cat([q, c_kv, k_pe], -1),
                                  whole=not sharded)
        q, c_kv, k_pe = lat.split([m.q_lora_rank, m.kv_lora_rank,
                                   m.qk_rope_head_dim], -1)
    # the latents are whole on every rank and enter the rank's heads (the
    # gather's backward already sums the ranks' gradients)
    enter = sharding.copy_in if sharded and not seq else (lambda t: t)
    B, S = q.shape[:2]
    q = (enter(q) @ params["wq_b"]).reshape(B, S, h, m.qk_head_dim)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = apply_rope(k_pe[:, :, None], positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, enter(c_kv), enter(k_rope)


def _expand_latent(params, c_kv: torch.Tensor, k_rope: torch.Tensor, h: int,
                   nope: int):
    """Per-head K (nope from the latent, rope shared by every head) and V
    from latent rows (B, S, rank) and (B, S, rope)."""
    B, S = c_kv.shape[:2]
    kvb = (c_kv @ params["wkv_b"]).reshape(B, S, h, -1)
    k = torch.cat([kvb[..., :nope],
                   k_rope[:, :, None].expand(B, S, h, k_rope.shape[-1])], -1)
    return k, kvb[..., nope:]


def mla_forward(
    cfg: ModelConfig,
    params,
    x: torch.Tensor,                 # (B, S, D)
    *,
    mode: str,                       # "full" | "decode"
    positions: torch.Tensor,
    state=None,                      # {"c_kv": (B, W, rank), "k_rope": (B, W, rope)}
    t: Optional[Clock] = None,
    window: Optional[int] = None,
    update_cache: bool = False,
    causal: bool = True,
    history: int = 0,
    paged: Optional[PagedDecode] = None,
    seq: bool = False,
) -> Tuple[torch.Tensor, Optional[dict]]:
    if paged is not None:
        raise ValueError("paged decode gathers per-head K/V blocks; the MLA "
                         "latent cache decodes through the absorbed dense "
                         "path")
    m = cfg.mla
    h = params["wq_b"].shape[-1] // m.qk_head_dim     # this rank's heads
    nope, vd = m.qk_nope_head_dim, m.v_head_dim
    scale = 1.0 / math.sqrt(m.qk_head_dim)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv_latent(cfg, params, x, positions,
                                                   seq)
    B, S = q_nope.shape[:2]

    if mode == "full":
        # materialized path: expand the latent into per-head K/V
        k, v = _expand_latent(params, c_kv, k_rope, h, nope)
        if history:
            # chunk resume: expand the cached latent rows [0, history)
            # (already normed and roped) the same way
            if state is None or not causal:
                raise ValueError("a chunk resume needs a cache and causal "
                                 "attention")
            k_h, v_h = _expand_latent(
                params, state["c_kv"][:, :history].to(c_kv.dtype),
                state["k_rope"][:, :history].to(k_rope.dtype), h, nope)
            k = torch.cat([k_h, k], dim=1)
            v = torch.cat([v_h, v], dim=1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = flash_attention(q, k, v, causal=causal, scale=scale,
                              window=window, q_offset=history)
        if update_cache and state is not None:
            cap = state["c_kv"].shape[1]
            t0 = t if t is not None else 0
            ring_write(state["c_kv"], c_kv, t0, cap)
            ring_write(state["k_rope"], k_rope, t0, cap)
    elif mode == "decode":
        # absorbed path: score and read in latent space, in f32
        if state is None or t is None:
            raise ValueError("decode needs a state and a clock")
        if S != 1:
            raise ValueError("MLA decode takes one token per request")
        cap = state["c_kv"].shape[1]
        ckv = ring_write(state["c_kv"], c_kv, t, cap).float()
        krope = ring_write(state["k_rope"], k_rope, t, cap).float()
        valid = ring_valid(torch.as_tensor(t, device=x.device) + S, cap)
        if valid.dim() == 1:
            valid = valid[None]
        wkv_b = params["wkv_b"].reshape(m.kv_lora_rank, h, nope + vd).float()
        w_uk, w_uv = wkv_b[..., :nope], wkv_b[..., nope:]
        # absorb W_UK into q: (B, 1, H, nope) x (rank, H, nope) -> (B, H, rank)
        q_lat = torch.einsum("bshn,lhn->bhl", q_nope.float(), w_uk)
        s = torch.einsum("bhl,bwl->bhw", q_lat, ckv)
        s = s + torch.einsum("bshr,bwr->bhw", q_rope.float(), krope)
        s = torch.where(valid[:, None, :], s * scale, NEG_INF)
        p = torch.softmax(s, dim=-1)
        ctx_lat = torch.einsum("bhw,bwl->bhl", p, ckv)
        out = torch.einsum("bhl,lhv->bhv", ctx_lat, w_uv)
        out = out[:, None].to(x.dtype)                      # (B, 1, H, vd)
    else:
        raise ValueError(mode)

    out = out.reshape(B, S, h * vd) @ params["wo"]
    # sum the ranks' head partials
    return sharding.module_out(out, h != cfg.num_heads, seq), state


# ---------------------------------------------------------------------------
# Unified entry
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig, repeats: int,
                   dtype, device):
    if cfg.attention_kind == "mla":
        return init_mla(gen, cfg, repeats, dtype, device)
    return init_gqa(gen, cfg, repeats, dtype, device)


def attention_forward(cfg: ModelConfig, params, x: torch.Tensor, **kw):
    if cfg.attention_kind == "mla":
        # MLA's full mode always attends through the plain chunked
        # flash_attention, so training needs no switch there
        kw.pop("train", None)
        return mla_forward(cfg, params, x, **kw)
    return gqa_forward(cfg, params, x, **kw)
