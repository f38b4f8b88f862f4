"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory with
exponential gating), after arXiv:2405.04517, on tensors.

The JAX package computes both outside any kernel, and so does the port.
Full mode runs the mLSTM chunkwise-parallel when the sequence holds at
least two whole chunks of :data:`MLSTM_CHUNK`, else the stabilized
recurrence step by step; the sLSTM always steps (a Python loop of steps on
tensors).  Decode mode advances one step from the stored state.

Dtypes follow the JAX package: every recurrence runs in f32; the gate
leaves ``w_i``, ``b_i``, ``w_f``, ``b_f``, ``w_o`` (mLSTM) and ``b``
(sLSTM) are f32; every state leaf is f32.  State leaves are written in
place.

Faithfulness notes, as in the JAX package:
  * q/k/v projections are headwise block-diagonal (LinearHeadwiseExpand in
    the reference code), matching the ~1.3B parameter budget.
  * i/f gates are per-head scalars from the conv features; the o gate is an
    elementwise sigmoid on the up-projected stream.
  * sLSTM recurrent gates use headwise block-diagonal recurrent matrices.

Under tensor parallelism (``repro_torch.meshserve``) an mLSTM rank holds
whole heads: its heads' columns of ``w_up``, ``w_z``, the conv and
``w_o``, its heads of the q/k/v and i/f gate leaves, ``w_down``'s rows
and its heads' state, so the whole recurrence runs locally and only
``w_down``'s partials are summed.  The sLSTM recurrence stays whole on
every rank (its headwise recurrent product feeds every unit's gates);
its gated FFN is cut, each half of ``w_up`` and ``w_down``'s rows, and
its partials summed.  The weights' shapes tell a shard from the whole.
Under sequence parallelism (``seq``) the input is the rank's rows of the
residual: each block gathers them at its entry (the sLSTM's whole
recurrence and an mLSTM whose heads do not divide the slice as a
computation every rank runs whole) and hands back the rank's rows
(``sharding.module_in``/``module_out``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, gelu
from repro_torch.models.state import xlstm_dims
from repro_torch.core import opcount as count

#: chunk length of the chunkwise-parallel mLSTM
MLSTM_CHUNK = 64


def _headwise_init(gen: torch.Generator, repeats: int, heads: int,
                   hd_in: int, hd_out: int, dtype, device) -> torch.Tensor:
    w = torch.randn((repeats, heads, hd_in, hd_out), generator=gen,
                    dtype=torch.float32, device=device)
    return (w * hd_in ** -0.5).to(dtype)


def _headwise(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., H, hd_in) @ w (H, hd_in, hd_out) -> (..., H, hd_out)."""
    return torch.einsum("...hi,hio->...ho", x, w)


def _randn(gen, shape, device, std):
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device) * std


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(gen: torch.Generator, cfg: ModelConfig, repeats: int, dtype,
               device):
    d, h, r = cfg.d_model, cfg.num_heads, repeats
    d_in, hd = xlstm_dims(cfg, "mlstm")
    ks = cfg.xlstm.conv1d_kernel_size
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_up": dense_init(gen, (r, d, d_in), dtype, device),
        "w_z": dense_init(gen, (r, d, d_in), dtype, device),
        "conv_w": _randn(gen, (r, ks, d_in), device, 0.5).to(dtype),
        "conv_b": torch.zeros((r, d_in), dtype=dtype, device=device),
        "wq": _headwise_init(gen, r, h, hd, hd, dtype, device),
        "wk": _headwise_init(gen, r, h, hd, hd, dtype, device),
        "wv": _headwise_init(gen, r, h, hd, hd, dtype, device),
        "w_i": _randn(gen, (r, h, hd), device, 0.01),
        "b_i": torch.zeros((r, h), **f32),
        "w_f": _randn(gen, (r, h, hd), device, 0.01),
        "b_f": torch.full((r, h), 3.0, **f32),   # forget bias: remember
        "w_o": torch.zeros((r, d_in), **f32),
        "w_down": dense_init(gen, (r, d_in, d), dtype, device),
    }


def _mlstm_step(q_t, k_t, v_t, i_t, f_t, carry):
    """One stabilized mLSTM step, all f32.  q/k/v (B, H, hd); i/f (B, H);
    carry (C (B, H, hd, hd), n (B, H, hd), m (B, H))."""
    C, n, m = carry
    m_new = torch.maximum(f_t + m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(f_t + m - m_new)
    C = f_p[..., None, None] * C + i_p[..., None, None] * (
        v_t[..., None, :] * k_t[..., :, None])           # C[k-dim, v-dim]
    n = f_p[..., None] * n + i_p[..., None] * k_t
    num = torch.einsum("bhkv,bhk->bhv", C, q_t)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n, q_t).abs(),
                        torch.exp(-m_new))[..., None]
    return (C, n, m_new), num / den


def _mlstm_qkvif(cfg: ModelConfig, params, x: torch.Tensor,
                 conv_hist: Optional[torch.Tensor] = None):
    """conv_hist: (B, ksize - 1, d_in) previous inputs (decode continuity).
    ``d_in`` and the heads are this rank's under TP (from the weights);
    ``x`` has entered the rank's heads (:func:`mlstm_forward`)."""
    d_in, h = params["w_up"].shape[-1], params["wq"].shape[-3]
    hd = d_in // h
    B, S, _ = x.shape
    x_up = x @ params["w_up"]
    z = x @ params["w_z"]
    # causal depthwise conv + silu, continued from the history in decode
    w = params["conv_w"].float()
    ks = cfg.xlstm.conv1d_kernel_size
    if conv_hist is not None:
        x_ext = torch.cat([conv_hist.to(x_up.dtype), x_up], dim=1)
    else:
        x_ext = F.pad(x_up, (0, 0, ks - 1, 0))
    acc = torch.zeros((B, S, d_in), dtype=torch.float32, device=x.device)
    for i in range(ks):
        acc += x_ext[:, i: i + S].float() * w[i]
    x_c = F.silu(acc + params["conv_b"].float())
    x_ch = x_c.reshape(B, S, h, hd)
    x_uh = x_up.float().reshape(B, S, h, hd)
    q = _headwise(x_ch, params["wq"].float())
    k = _headwise(x_ch, params["wk"].float()) * hd ** -0.5
    v = _headwise(x_uh, params["wv"].float())
    i_pre = torch.einsum("bshd,hd->bsh", x_ch, params["w_i"]) + params["b_i"]
    f_pre = F.logsigmoid(torch.einsum("bshd,hd->bsh", x_ch, params["w_f"])
                         + params["b_f"])
    o = torch.sigmoid(x_up.float() * params["w_o"])
    return q, k, v, i_pre, f_pre, o, z


def _mlstm_chunkwise(q, k, v, i_pre, f_pre, carry0, chunk: int):
    """The stabilized recurrence over chunks of length ``chunk``: within a
    chunk causal matmuls (the D-masked q.k^T form), the matrix memory C
    touched only at chunk boundaries.  The carry convention (C scaled by
    exp(-m), n, m) is the step's, so chunkwise prefill composes with
    stepwise decode.  q/k/v (B, S, H, hd) f32; i_pre/f_pre (B, S, H);
    carry0 (C, n, m).  Returns (carry, h (B, S, H, hd))."""
    L = chunk
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=q.device))[None, :, :, None]

    def chunk_step(ci: int, carry, q, k, v, i_pre, f_pre):
        C, n, m_c = carry
        c0 = ci * L
        qc, kc, vc, ic, fc = (t[:, c0: c0 + L]
                              for t in (q, k, v, i_pre, f_pre))
        b = torch.cumsum(fc, dim=1)                 # (B, L, H) log-decay
        b_last = b[:, -1]                           # (B, H)
        a = ic - b
        M = torch.cummax(a, dim=1).values           # running max over s <= t
        m_t = b + torch.maximum(m_c[:, None], M)    # (B, L, H)
        # intra-chunk: D[t, s] = exp(b_t - m_t + a_s), s <= t
        log_d = (b - m_t)[:, :, None, :] + a[:, None, :, :]   # (B, t, s, H)
        D = torch.where(causal, torch.exp(log_d), 0.0)
        s_qk = torch.einsum("blhd,bmhd->blmh", qc, kc)
        intra_num = torch.einsum("blmh,bmhv->blhv", s_qk * D, vc)
        intra_n = torch.einsum("blmh,bmhd->blhd", D, kc)
        # inter-chunk: the decayed state's contribution
        inter_scale = torch.exp(m_c[:, None] - torch.maximum(m_c[:, None], M))
        inter_num = torch.einsum("blhd,bhdv->blhv", qc, C) \
            * inter_scale[..., None]
        n_comb = n[:, None] * inter_scale[..., None] + intra_n
        den = torch.maximum(torch.einsum("blhd,blhd->blh", qc, n_comb).abs(),
                            torch.exp(-m_t))
        h_c = (inter_num + intra_num) / den[..., None]
        # chunk-end state update
        m_new = b_last + torch.maximum(m_c, M[:, -1])
        w = torch.exp(a + (b_last - m_new)[:, None])          # (B, L, H)
        decay = torch.exp(m_c + b_last - m_new)
        C = C * decay[..., None, None] + torch.einsum(
            "blhd,blhv->bhdv", kc * w[..., None], vc)
        n = n * decay[..., None] + torch.einsum("blh,blhd->bhd", w, kc)
        return (C, n, m_new), h_c

    carry, hs = count.steps("xlstm.mlstm_chunks", -(-q.shape[1] // L),
                            chunk_step, carry0, q, k, v, i_pre, f_pre)
    return carry, torch.cat(hs, dim=1)


def mlstm_forward(cfg: ModelConfig, params, x: torch.Tensor, *, mode: str,
                  state=None, update_cache: bool = False, seq: bool = False
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    d_whole, _ = xlstm_dims(cfg, "mlstm")
    d_in, h = params["w_up"].shape[-1], params["wq"].shape[-3]
    hd = d_in // h
    # the rank's heads' w_up, w_z
    x = sharding.module_in(x, d_in != d_whole, seq)
    B, S, _ = x.shape
    conv_hist = (state["conv"][:, 1:] if mode == "decode"
                 and state is not None else None)
    q, k, v, i_pre, f_pre, o, z = _mlstm_qkvif(cfg, params, x, conv_hist)
    if state is not None:
        carry0 = (state["C"], state["n"], state["m"])
    else:
        f32 = dict(dtype=torch.float32, device=x.device)
        carry0 = (torch.zeros((B, h, hd, hd), **f32),
                  torch.zeros((B, h, hd), **f32), torch.zeros((B, h), **f32))

    if mode == "full":
        if S % MLSTM_CHUNK == 0 and S >= 2 * MLSTM_CHUNK:
            carry, h_seq = _mlstm_chunkwise(q, k, v, i_pre, f_pre, carry0,
                                            MLSTM_CHUNK)
        else:
            carry, hs = count.steps(
                "xlstm.mlstm_steps", S,
                lambda s, carry, q, k, v, i_pre, f_pre: _mlstm_step(
                    q[:, s], k[:, s], v[:, s], i_pre[:, s], f_pre[:, s],
                    carry),
                carry0, q, k, v, i_pre, f_pre)
            h_seq = torch.stack(hs, dim=1)                # (B, S, H, hd)
        if update_cache and state is not None:
            ks = cfg.xlstm.conv1d_kernel_size
            tail = (x @ params["w_up"]).float()[:, -ks:]
            if tail.shape[1] < ks:
                tail = F.pad(tail, (0, 0, ks - tail.shape[1], 0))
            _write_state(state, ("C", "n", "m"), carry)
            state["conv"].copy_(tail)
    elif mode == "decode":
        if state is None or S != 1:
            raise ValueError("mLSTM decode needs a state and S == 1")
        carry, h_t = _mlstm_step(q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0],
                                 f_pre[:, 0], carry0)
        h_seq = h_t[:, None]
        conv = torch.cat([state["conv"][:, 1:],
                          (x @ params["w_up"]).float()], dim=1)
        _write_state(state, ("C", "n", "m"), carry)
        state["conv"].copy_(conv)
    else:
        raise ValueError(mode)

    out = (h_seq.reshape(B, S, d_in) * o).to(x.dtype)
    out = (out * F.silu(z)) @ params["w_down"]
    # sum the ranks' head partials
    return sharding.module_out(out, d_in != d_whole, seq), state


def _write_state(state, keys, values):
    for key, val in zip(keys, values):
        state[key].copy_(val)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(gen: torch.Generator, cfg: ModelConfig, repeats: int, dtype,
               device):
    d, h, r = cfg.d_model, cfg.num_heads, repeats
    d_ff, _ = xlstm_dims(cfg, "slstm")
    hd = d // h
    b = torch.cat([torch.zeros((d,)), torch.full((d,), 3.0),
                   torch.zeros((2 * d,))]).to(device)
    return {
        "w_in": dense_init(gen, (r, d, 4 * d), dtype, device),  # i, f, z, o
        "r": _headwise_init(gen, r, h, hd, 4 * hd, dtype, device),
        "b": b.expand(r, 4 * d).contiguous(),
        "w_up": dense_init(gen, (r, d, 2 * d_ff), dtype, device),  # gated FFN
        "w_down": dense_init(gen, (r, d_ff, d), dtype, device),
    }


def _slstm_step(cfg: ModelConfig, rec_w: torch.Tensor, bias: torch.Tensor,
                x_t: torch.Tensor, carry):
    """x_t (B, 4d) input pre-activations; ``rec_w`` the headwise recurrent
    matrices in f32; carry (c, n, h, m), each (B, d)."""
    d, heads = cfg.d_model, cfg.num_heads
    c, n, h_prev, m = carry
    rec = _headwise(h_prev.reshape(-1, heads, d // heads),
                    rec_w).reshape(-1, 4 * d)
    i_pre, f_pre, z_pre, o_pre = (x_t + rec + bias).chunk(4, dim=-1)
    f_pre = F.logsigmoid(f_pre)
    m_new = torch.maximum(f_pre + m, i_pre)
    i_p = torch.exp(i_pre - m_new)
    f_p = torch.exp(f_pre + m - m_new)
    c_new = f_p * c + i_p * torch.tanh(z_pre)
    n_new = f_p * n + i_p
    h_new = torch.sigmoid(o_pre) * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, h_new, m_new), h_new


def slstm_forward(cfg: ModelConfig, params, x: torch.Tensor, *, mode: str,
                  state=None, update_cache: bool = False, seq: bool = False
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    d = cfg.d_model
    if seq:
        x = sharding.seq_gather(x, whole=True)   # the whole recurrence
    B, S, _ = x.shape
    x_pre = (x @ params["w_in"]).float()                   # (B, S, 4d)
    rec_w = params["r"].float()
    keys = ("c", "n", "h", "m")
    if state is not None:
        carry = tuple(state[k] for k in keys)
    else:
        z = torch.zeros((B, d), dtype=torch.float32, device=x.device)
        carry = (z, z, z, z)

    if mode == "full":
        carry, hs = count.steps(
            "xlstm.slstm_steps", S,
            lambda s, carry, x_pre, rec_w, bias: _slstm_step(
                cfg, rec_w, bias, x_pre[:, s], carry),
            carry, x_pre, rec_w, params["b"])
        h_seq = torch.stack(hs, dim=1)
        if update_cache and state is not None:
            _write_state(state, keys, carry)
    elif mode == "decode":
        if state is None or S != 1:
            raise ValueError("sLSTM decode needs a state and S == 1")
        carry, h_t = _slstm_step(cfg, rec_w, params["b"], x_pre[:, 0], carry)
        h_seq = h_t[:, None]
        _write_state(state, keys, carry)
    else:
        raise ValueError(mode)

    sharded = params["w_down"].shape[-2] != xlstm_dims(cfg, "slstm")[0]
    h_in = h_seq.to(x.dtype)
    if sharded:
        h_in = sharding.copy_in(h_in)    # the whole recurrence's output
    up = h_in @ params["w_up"]
    gate, val = up.chunk(2, dim=-1)
    out = (gelu(gate) * val) @ params["w_down"]
    # the rank's rows of the FFN
    return sharding.module_out(out, sharded, seq), state
