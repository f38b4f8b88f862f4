"""Mixture-of-Experts FFN, local dispatch, on tensors.

Token dispatch is the JAX package's sort-free scatter/gather: a stable
argsort ranks each (token, expert) assignment within its expert, and an
assignment whose rank reaches the expert's capacity is dropped (its slot
is the sentinel ``num_experts * C``, which the buffer scatter drops).
Capacity dropping decides tokens, so it follows the JAX package exactly:
rank order is flat assignment order, token-major.

Only the local strategy (all experts on one device) runs here.  The
mesh strategies (``psum`` and ``a2a`` in the JAX package) wait for the
mesh slice of the port.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, swiglu
from repro_torch.models.ffn import dense_ffn, init_dense_ffn


def init_moe(gen: torch.Generator, cfg: ModelConfig, repeats: int, dtype,
             device):
    """Routed-expert leaves ``(repeats, E, ...)``.  Each expert's slice is
    drawn in f32 on its own and cast into the leaf, so a full-width leaf
    never exists in f32."""
    m = cfg.moe
    if cfg.activation != "swiglu":
        raise NotImplementedError("routed experts are implemented for swiglu")
    d, f, e = cfg.d_model, m.expert_d_ff, m.num_experts

    def experts(a, b, std):
        w = torch.empty((repeats, e, a, b), dtype=dtype, device=device)
        for r in range(repeats):
            for i in range(e):
                w[r, i] = torch.randn((a, b), generator=gen,
                                      dtype=torch.float32,
                                      device=device) * std
        return w

    p = {
        "router": dense_init(gen, (repeats, d, e), torch.float32, device),
        "w_gate": experts(d, f, d ** -0.5),
        "w_up": experts(d, f, d ** -0.5),
        "w_down": experts(f, d, f ** -0.5),
    }
    if m.num_shared_experts:
        sf = (m.shared_d_ff or f) * m.num_shared_experts
        p["shared"] = init_dense_ffn(gen, cfg, sf, repeats, dtype, device)
    if m.dense_residual_d_ff:
        p["dense_residual"] = init_dense_ffn(gen, cfg, m.dense_residual_d_ff,
                                             repeats, dtype, device)
    return p


# ---------------------------------------------------------------------------
# Dispatch primitives (pure local math)
# ---------------------------------------------------------------------------


def _route(x2: torch.Tensor, router: torch.Tensor, top_k: int):
    """x2 (T, d) -> gates (T, k), expert ids (T, k), router probs (T, E)."""
    logits = x2.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, eidx, probs


def _ranks_of(e_flat: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Within-expert arrival rank of each flat assignment (stable)."""
    n = e_flat.shape[0]
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    start = torch.searchsorted(
        sorted_e, torch.arange(num_experts, device=e_flat.device))
    rank_sorted = torch.arange(n, device=e_flat.device) - start[sorted_e]
    ranks = torch.empty_like(e_flat)
    ranks[order] = rank_sorted
    return ranks


def _fill_buffer(x2: torch.Tensor, tok: torch.Tensor, slot: torch.Tensor,
                 num_slots: int) -> torch.Tensor:
    """Scatter token vectors into the dispatch buffer; slot == num_slots
    drops."""
    buf = torch.zeros((num_slots + 1, x2.shape[1]), dtype=x2.dtype,
                      device=x2.device)
    buf[slot] = x2[tok]
    return buf[:num_slots]


def _expert_ffn(params, xs: torch.Tensor) -> torch.Tensor:
    """xs (E, C, d) -> (E, C, d)."""
    h = swiglu(torch.bmm(xs, params["w_gate"]), torch.bmm(xs, params["w_up"]))
    return torch.bmm(h, params["w_down"])


def _combine(y_flat: torch.Tensor, slot: torch.Tensor, gates: torch.Tensor,
             T: int, k: int) -> torch.Tensor:
    """Gather per-assignment outputs back and mix with gate weights."""
    d = y_flat.shape[-1]
    y_pad = torch.cat([y_flat, y_flat.new_zeros((1, d))], 0)
    contrib = y_pad[slot]                                   # (T*k, d)
    g = gates.reshape(-1, 1).float()
    return (contrib.float() * g).reshape(T, k, d).sum(1)


def _aux_loss(eidx: torch.Tensor, probs: torch.Tensor, num_experts: int,
              coef: float) -> torch.Tensor:
    tk = eidx.numel()
    counts = torch.zeros((num_experts,), dtype=torch.float32,
                         device=eidx.device)
    counts.index_add_(0, eidx.reshape(-1),
                      torch.ones((tk,), dtype=torch.float32,
                                 device=eidx.device))
    f = counts / tk
    p_mean = probs.mean(0)
    return num_experts * torch.sum(f * p_mean) * coef


def _capacity(tokens: int, k: int, num_experts: int, cf: float) -> int:
    return max(1, math.ceil(tokens * k * cf / num_experts))


def _routed_local(cfg: ModelConfig, params, x2: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    m = cfg.moe
    T = x2.shape[0]
    gates, eidx, probs = _route(x2, params["router"], m.top_k)
    C = _capacity(T, m.top_k, m.num_experts, m.capacity_factor)
    e_flat = eidx.reshape(-1)
    ranks = _ranks_of(e_flat, m.num_experts)
    keep = ranks < C
    slot = torch.where(keep, e_flat * C + ranks,
                       torch.full_like(e_flat, m.num_experts * C))
    tok = torch.arange(T * m.top_k, device=x2.device) // m.top_k
    xs = _fill_buffer(x2, tok, slot, m.num_experts * C).reshape(
        m.num_experts, C, -1)
    ys = _expert_ffn(params, xs)
    y = _combine(ys.reshape(m.num_experts * C, -1), slot, gates, T, m.top_k)
    return y, _aux_loss(eidx, probs, m.num_experts, m.router_aux_loss_coef)


def _routed_psum(*args, **kwargs):
    raise NotImplementedError(
        "the psum expert-parallel strategy waits for the mesh slice of the "
        "port")


def _routed_a2a(*args, **kwargs):
    raise NotImplementedError(
        "the all-to-all expert-parallel strategy waits for the mesh slice of "
        "the port")


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def moe_forward(cfg: ModelConfig, params, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), router aux loss scalar)."""
    B, S, d = x.shape
    y, aux = _routed_local(cfg, params, x.reshape(B * S, d))
    y = y.reshape(B, S, d).to(x.dtype)
    if "shared" in params:
        y = y + dense_ffn(cfg, params["shared"], x)
    if "dense_residual" in params:
        y = y + dense_ffn(cfg, params["dense_residual"], x)
    return y, aux
