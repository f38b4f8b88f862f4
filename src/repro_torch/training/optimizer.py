"""AdamW with configurable optimizer-state dtype (bf16 m/v for the >=398B
MoE archs), a copy of the JAX package's ``repro.training.optimizer`` on
nested-dict parameter trees.

Plain tensor ops, no ``torch.optim``: the update is out of place and
returns a new tree, as the JAX package's does.  Its arithmetic follows
the JAX package's step for step in f32: clipping by the global norm,
bias correction from the step count, decoupled weight decay on leaves
with ``ndim >= 2`` only, and the cast back to each leaf's dtype.  The
arithmetic is elementwise, so a large leaf is updated a slice of
:data:`CHUNK` elements at a time into its new tensors: its f32
temporaries never exceed a slice, where whole ones would take 3.7 GB
each for deepseek-v3-671b's embedding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"     # "float32" | "bfloat16"


#: elements of a leaf updated at once (bounds the f32 temporaries)
CHUNK = 1 << 26


class OptState(NamedTuple):
    step: torch.Tensor               # 0-dim int32
    m: Any
    v: Any


def init_opt_state(cfg: AdamWConfig, params) -> OptState:
    dt = torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    leaves = tree_flatten(params)[0]
    dev = leaves[0].device if leaves else None
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree, cuts=None) -> torch.Tensor:
    """The norm of the whole tree.  With ``cuts`` (the sharded step's
    ``training.fsdp.plan``) ``tree`` is this rank's part: each leaf's sum
    of squares is summed over the axes that cut it ("data", "model",
    both), so every element counts once and a leaf replicated on an axis
    is counted once there."""
    # the norm of the leaves' norms; on the card vector_norm reduces a bf16
    # leaf in f32 without an f32 copy of it
    if cuts is None:
        leaves = tree_flatten(tree)[0]
        return torch.linalg.vector_norm(torch.stack([
            torch.linalg.vector_norm(x, dtype=torch.float32)
            for x in leaves]))
    from repro_torch import sharding
    from repro_torch.training.fsdp import with_cuts
    # per leaf category (cut on data, on model): its sum of squares
    sums, dev = {}, None
    for _, x, c in with_cuts(tree, cuts):
        key = (c.data is not None, c.model is not None)
        sq = torch.square(torch.linalg.vector_norm(x, dtype=torch.float32))
        sums[key] = sums.get(key, 0.0) + sq
        dev = x.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    part = {k: sums.get(k, zero) for k in
            ((True, True), (True, False), (False, True), (False, False))}
    ctx = sharding.current()
    over_data = torch.stack([part[True, True], part[True, False]])
    if ctx.data_size > 1:
        over_data = sharding.all_reduce_sum(over_data, "data")
    over_model = torch.stack([over_data[0], part[False, True]])
    if ctx.model_size > 1:
        over_model = sharding.all_reduce_sum(over_model, "model")
    return torch.sqrt(over_model.sum() + over_data[1] + part[False, False])


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: OptState,
                 lr_scale, cuts=None):
    """Returns (new_params, new_state, grad_norm).  On a rank's part of a
    sharded tree ``cuts`` is its ``training.fsdp.plan``: only the norm
    that clips reads across ranks; the update is elementwise."""
    gnorm = global_norm(grads, cuts)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=gnorm.device)

    def upd_slice(p, g, m, v, decay: bool):
        g = g.float() * clip
        m32 = m.float() * cfg.b1 + g * (1 - cfg.b1)
        v32 = v.float() * cfg.b2 + torch.square(g) * (1 - cfg.b2)
        update = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
        if decay:  # decoupled weight decay on matrices only
            update = update + cfg.weight_decay * p.float()
        new_p = p.float() - lr * update
        return new_p.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    def upd(p, g, m, v):
        new = tuple(torch.empty_like(t) for t in (p, m, v))
        flat = [t.reshape(-1) for t in (p, g, m, v)]
        for lo in range(0, p.numel(), CHUNK):
            for out, val in zip(new, upd_slice(
                    *(t[lo: lo + CHUNK] for t in flat), p.dim() >= 2)):
                out.view(-1)[lo: lo + CHUNK] = val
        return new

    flat_p, spec = tree_flatten(params)
    flat_g = tree_flatten(grads)[0]
    flat_m = tree_flatten(state.m)[0]
    flat_v = tree_flatten(state.v)[0]
    out = [upd(p, g, m, v) for p, g, m, v
           in zip(flat_p, flat_g, flat_m, flat_v)]
    new_p = tree_unflatten([o[0] for o in out], spec)
    new_m = tree_unflatten([o[1] for o in out], spec)
    new_v = tree_unflatten([o[2] for o in out], spec)
    return new_p, OptState(step, new_m, new_v), gnorm
