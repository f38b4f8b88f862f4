"""Mamba-1 selective SSM block (Jamba's sequence mixer), on tensors.

Full mode runs the selective scan over the whole sequence through the
scan kernel (:func:`repro_torch.kernels.mamba_scan.mamba_scan_cuda`), for
any S and d_in; in training (``train``) it runs the JAX package's
``lax.scan`` branch instead, a loop over :func:`_ssm_step` on which
autograd runs (the kernel has no backward, as the Pallas one has none).
Decode mode advances one step from the stored (conv window, ssm state)
in plain PyTorch, as the JAX package does.

Dtypes follow the JAX package: the scan runs in f32; ``A_log``, ``D`` and
``dt_b`` are f32 leaves; the ``conv`` state is in the model dtype and the
``ssm`` state in f32.  State leaves are written in place.

Under tensor parallelism (``repro_torch.meshserve``) a rank holds its
block of the inner channels ``d_in``: both halves of ``in_proj``, the
conv, ``dt_w``'s columns, ``dt_b``, ``A_log``, ``D``, and the rows of
``x_proj`` and ``out_proj``; the scan runs on its channels alone.  dt, B
and C read every channel, so the ranks' ``x_proj`` partials are summed
(in f32) before they split, and the ``out_proj`` partials after.  The
weights' shapes tell a shard from the whole layer.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba_scan import mamba_scan_cuda
from repro_torch.models.common import dense_init
from repro_torch.core import opcount as count


def _dims(cfg: ModelConfig):
    mc = cfg.mamba
    d_in = mc.expand * cfg.d_model
    dt_rank = mc.dt_rank or -(-cfg.d_model // 16)
    return mc, d_in, dt_rank


def init_mamba(gen: torch.Generator, cfg: ModelConfig, repeats: int, dtype,
               device):
    mc, d_in, dt_rank = _dims(cfg)
    d = cfg.d_model
    r = repeats
    conv_w = torch.randn((r, mc.d_conv, d_in), generator=gen,
                         dtype=torch.float32, device=device)
    # S4D-real initialization for A
    a_init = torch.arange(1, mc.d_state + 1, dtype=torch.float32,
                          device=device).expand(r, d_in, mc.d_state)
    return {
        "in_proj": dense_init(gen, (r, d, 2 * d_in), dtype, device),
        "conv_w": (conv_w * mc.d_conv ** -0.5).to(dtype),
        "conv_b": torch.zeros((r, d_in), dtype=dtype, device=device),
        "x_proj": dense_init(gen, (r, d_in, dt_rank + 2 * mc.d_state), dtype,
                             device),
        "dt_w": dense_init(gen, (r, dt_rank, d_in), dtype, device),
        "dt_b": torch.full((r, d_in), -4.6, dtype=torch.float32,
                           device=device),  # softplus^-1(0.01)
        "A_log": torch.log(a_init).contiguous(),
        "D": torch.ones((r, d_in), dtype=torch.float32, device=device),
        "out_proj": dense_init(gen, (r, d_in, d), dtype, device),
    }


def _split_proj(params, x):
    """x and z from the packed ``in_proj`` [x | z] (this rank's channels
    of each half under TP)."""
    xz = x @ params["in_proj"]
    d_in = xz.shape[-1] // 2
    return xz[..., :d_in], xz[..., d_in:]


def _causal_conv_full(params, xp: torch.Tensor, d_conv: int) -> torch.Tensor:
    """Depthwise causal conv via shifted adds; xp (B, S, d_in) -> f32."""
    w = params["conv_w"].float()                       # (d_conv, d_in)
    S = xp.shape[1]
    acc = torch.zeros(xp.shape, dtype=torch.float32, device=xp.device)
    for i in range(d_conv):
        shift = d_conv - 1 - i
        rolled = F.pad(xp, (0, 0, shift, 0))[:, :S]
        acc += rolled.float() * w[i]
    return acc + params["conv_b"].float()


def _ssm_inputs(cfg, params, x_c, dt_rank, sharded: bool):
    mc = cfg.mamba
    w = params["x_proj"]
    if sharded:
        # row-parallel: the ranks' partials over their channels, summed
        # in f32, then rounded once to the weights' dtype; dt, B and C
        # then enter the rank's channels (copy_in)
        dbc = sharding.copy_in(sharding.reduce(
            x_c.to(w.dtype).float() @ w.float()).to(w.dtype))
    else:
        dbc = x_c.to(w.dtype) @ w
    dt = dbc[..., :dt_rank]
    b_ssm = dbc[..., dt_rank: dt_rank + mc.d_state].float()
    c_ssm = dbc[..., dt_rank + mc.d_state:].float()
    dt = F.softplus((dt @ params["dt_w"]).float() + params["dt_b"])
    return dt, b_ssm, c_ssm


def _ssm_step(A, D, h, x_t, dt_t, b_t, c_t):
    """One selective-scan step. h (B, d_in, N); x_t/dt_t (B, d_in);
    b_t/c_t (B, N)."""
    dA = torch.exp(dt_t[..., None] * A)                    # (B, d_in, N)
    dBx = (dt_t * x_t)[..., None] * b_t[:, None, :]
    h = dA * h + dBx
    y = torch.einsum("bdn,bn->bd", h, c_t) + D * x_t
    return h, y


def mamba_forward(
    cfg: ModelConfig,
    params,
    x: torch.Tensor,                # (B, S, D)
    *,
    mode: str,                      # "full" | "decode"
    state=None,
    update_cache: bool = False,
    train: bool = False,
    seq: bool = False,
) -> Tuple[torch.Tensor, Optional[dict]]:
    mc, d_in, dt_rank = _dims(cfg)
    sharded = params["in_proj"].shape[-1] != 2 * d_in
    # column-parallel in_proj (under ``seq`` the rank's rows, gathered)
    x = sharding.module_in(x, sharded, seq)
    B, S, _ = x.shape
    xp, z = _split_proj(params, x)
    d_in = xp.shape[-1]
    A = -torch.exp(params["A_log"])
    D = params["D"]

    if mode == "full":
        x_c = F.silu(_causal_conv_full(params, xp, mc.d_conv))
        dt, b_ssm, c_ssm = _ssm_inputs(cfg, params, x_c, dt_rank, sharded)
        h0 = (state["ssm"] if state is not None
              else torch.zeros((B, d_in, mc.d_state), dtype=torch.float32,
                               device=x.device))
        if train:
            hT, ys = count.steps(
                "mamba.ssm_steps", S,
                lambda t, h, A, D, x_c, dt, b_ssm, c_ssm: _ssm_step(
                    A, D, h, x_c[:, t], dt[:, t], b_ssm[:, t], c_ssm[:, t]),
                h0, A, D, x_c, dt, b_ssm, c_ssm)
            y = torch.stack(ys, 1)                           # (B, S, d_in)
        else:
            y, hT = mamba_scan_cuda(x_c.contiguous(), dt.contiguous(),
                                    b_ssm.contiguous(), c_ssm.contiguous(),
                                    A.contiguous(), D.contiguous(),
                                    h0.contiguous())
        if update_cache and state is not None:
            tail = xp[:, -mc.d_conv:]
            pad = mc.d_conv - tail.shape[1]
            if pad > 0:
                tail = F.pad(tail, (0, 0, pad, 0))
            state["ssm"].copy_(hT)
            state["conv"].copy_(tail)
    elif mode == "decode":
        if state is None or S != 1:
            raise ValueError("mamba decode needs a state and S == 1")
        conv = torch.cat([state["conv"][:, 1:],
                          xp.to(state["conv"].dtype)], dim=1)
        w = params["conv_w"].float()
        x_c = F.silu(torch.einsum("bkd,kd->bd", conv.float(), w)
                     + params["conv_b"].float())[:, None]   # (B, 1, d_in)
        dt, b_ssm, c_ssm = _ssm_inputs(cfg, params, x_c, dt_rank, sharded)
        h, y = _ssm_step(A, D, state["ssm"], x_c[:, 0], dt[:, 0],
                         b_ssm[:, 0], c_ssm[:, 0])
        y = y[:, None]
        state["conv"].copy_(conv)
        state["ssm"].copy_(h)
    else:
        raise ValueError(mode)

    y = (y.to(x.dtype) * F.silu(z)).to(x.dtype)
    # sum the ranks' channel partials
    return sharding.module_out(y @ params["out_proj"], sharded, seq), state
