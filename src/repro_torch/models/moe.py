"""Mixture-of-Experts FFN, local dispatch, on tensors.

Token dispatch is the JAX package's sort-free scatter/gather: a stable
argsort ranks each (token, expert) assignment within its expert, and an
assignment whose rank reaches the expert's capacity is dropped (its slot
is the sentinel ``num_experts * C``, which the buffer scatter drops).
Capacity dropping decides tokens, so it follows the JAX package exactly:
rank order is flat assignment order, token-major.

Experts held whole run locally.  Split over a mesh's model ranks
(``repro_torch.meshserve``), they run the JAX package's two strategies
on ``torch.distributed``: ``psum`` (an all-reduce of the ranks' partial
outputs) and ``a2a`` (two all-to-alls over the model group).  ``a2a``
drops assignments against each shard's capacity, as the JAX package's
does, so at a capacity factor that binds a mesh's tokens can differ from
one device's.

Under sequence parallelism (``seq``: the input is the rank's S / tp rows
of the residual) ``a2a`` routes those rows, which are the block of the
sequence it routes anyway, and hands back its rows of the output with no
gather; ``psum`` and experts held whole run on the gathered rows (a
computation every rank runs whole), and ``psum`` reduce-scatters its
partials.  The shared and dense-residual FFNs gather and scatter their
own rows (``repro_torch.models.ffn``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch import sharding
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
        if w.is_meta:                    # shapes only: nothing to draw
            return w
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


def _model_ctx(strategy: str) -> sharding.ShardCtx:
    try:
        return sharding.model_sharded(f"the {strategy} expert dispatch")
    except RuntimeError:
        raise RuntimeError(
            f"the {strategy} expert-parallel strategy needs a mesh: install "
            f"the model axis's process group with sharding.use_mesh"
        ) from None


def _routed_psum(cfg: ModelConfig, params, x2: torch.Tensor,
                 leave=sharding.reduce) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each model rank runs its local experts over all its tokens; the
    ranks' partial outputs are summed by ``leave`` (the all-reduce; under
    sequence parallelism the reduce-scatter to the rank's rows).  The
    tokens and the gates, whole on every rank, enter the rank's experts
    through ``copy_in`` (the router and the aux loss run whole on every
    rank)."""
    ctx = _model_ctx("psum")
    m = cfg.moe
    T = x2.shape[0]
    E_loc = params["w_gate"].shape[0]
    gates, eidx, probs = _route(x2, params["router"], m.top_k)
    x2e, gates = sharding.copy_in(x2), sharding.copy_in(gates)
    C = _capacity(T, m.top_k, m.num_experts, m.capacity_factor)
    e_flat = eidx.reshape(-1)
    ranks = _ranks_of(e_flat, m.num_experts)
    e_local = e_flat - ctx.model_rank * E_loc
    keep = (e_local >= 0) & (e_local < E_loc) & (ranks < C)
    slot = torch.where(keep, e_local * C + ranks,
                       torch.full_like(e_flat, E_loc * C))
    tok = torch.arange(T * m.top_k, device=x2.device) // m.top_k
    xs = _fill_buffer(x2e, tok, slot, E_loc * C).reshape(E_loc, C, -1)
    ys = _expert_ffn(params, xs)
    y = _combine(ys.reshape(E_loc * C, -1), slot, gates, T, m.top_k)
    aux = _aux_loss(eidx, probs, m.num_experts, m.router_aux_loss_coef)
    return leave(y), sharding.batch_mean(aux)


def _routed_a2a(cfg: ModelConfig, params, x: torch.Tensor, seq: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Classic expert parallelism: each model rank routes its slice of the
    sequence, two all-to-alls carry the dispatch buffers to the experts'
    ranks and back, and the slices are gathered again.  x (B, S, d), whole
    on every model rank; returns y (B, S, d) f32.  Each rank reads its
    slice of ``x`` and routes it with the whole router, so both enter
    through ``copy_in``.  Under ``seq`` x is that slice, (B, S / tp, d),
    and so is y."""
    ctx = _model_ctx("a2a")
    m = cfg.moe
    B, S, d = x.shape
    E, M = m.num_experts, ctx.model_size
    E_loc, S_loc = E // M, (S if seq else S // M)
    if not seq:
        x = sharding.copy_in(x)
        x = x[:, ctx.model_rank * S_loc:(ctx.model_rank + 1) * S_loc]
    x2 = x.reshape(B * S_loc, d)
    T = x2.shape[0]
    gates, eidx, probs = _route(x2, sharding.copy_in(params["router"]),
                                m.top_k)
    C = _capacity(T, m.top_k, E, m.capacity_factor)
    e_flat = eidx.reshape(-1)
    ranks = _ranks_of(e_flat, E)
    slot = torch.where(ranks < C, e_flat * C + ranks,
                       torch.full_like(e_flat, E * C))
    tok = torch.arange(T * m.top_k, device=x.device) // m.top_k
    send = _fill_buffer(x2, tok, slot, E * C)             # (M * E_loc * C, d)
    recv = sharding.all_to_all(send)
    xs = recv.reshape(M, E_loc, C, d).transpose(0, 1).reshape(E_loc, M * C, d)
    ys = _expert_ffn(params, xs)
    back = ys.reshape(E_loc, M, C, d).transpose(0, 1).reshape(E * C, d)
    got = sharding.all_to_all(back)
    y = _combine(got, slot, gates, T, m.top_k).reshape(B, S_loc, d)
    aux = _aux_loss(eidx, probs, E, m.router_aux_loss_coef)
    aux = sharding.batch_mean(sharding.reduce(aux) / M)
    return (y if seq else sharding.gather(y, 1, S)), aux


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def moe_forward(cfg: ModelConfig, params, x: torch.Tensor,
                seq: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), router aux loss scalar).  Experts held
    whole run locally; experts split over the model ranks run ``a2a``
    where the sequence divides the ranks, else ``psum`` (the JAX
    package's rule; the context's ``moe_strategy`` may force either).
    Under ``seq`` x and y are the rank's rows (B, S / tp, d) of the
    sequence."""
    m = cfg.moe
    B, S_loc, d = x.shape
    if params["w_gate"].shape[0] == m.num_experts:
        xw = sharding.seq_gather(x, whole=True) if seq else x
        y, aux = _routed_local(cfg, params, xw.reshape(-1, d))
        y = y.reshape(xw.shape)
        if seq:
            y = sharding.seq_split(y)
    else:
        ctx = _model_ctx("expert-parallel")
        M = ctx.model_size
        S = S_loc * M if seq else S_loc
        strategy = ctx.moe_strategy
        if strategy == "auto":
            strategy = "a2a" if S % M == 0 and S >= M else "psum"
        if strategy == "a2a":
            y, aux = _routed_a2a(cfg, params, x, seq)
        elif seq:
            y, aux = _routed_psum(
                cfg, params,
                sharding.seq_gather(x, whole=True).reshape(B * S, d),
                lambda y: sharding.seq_scatter(y.reshape(B, S, d)))
        else:
            y, aux = _routed_psum(cfg, params, x.reshape(B * S, d))
    y = y.reshape(B, S_loc, d).to(x.dtype)
    if "shared" in params:
        sf = (m.shared_d_ff or m.expert_d_ff) * m.num_shared_experts
        y = y + dense_ffn(cfg, params["shared"], x, sf, seq)
    if "dense_residual" in params:
        y = y + dense_ffn(cfg, params["dense_residual"], x,
                          m.dense_residual_d_ff, seq)
    return y, aux
