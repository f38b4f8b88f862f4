"""Training step: CE loss (+ router aux) and the AdamW update, a copy of
the JAX package's ``repro.training.train_step``.

Gradients come from ``torch.autograd.grad`` over the params tree: each
leaf is made ``requires_grad`` for the step only, through a detached
alias, so the caller's tree is never marked.  A leaf the loss never reads
(DeepSeek-V3's ``mtp`` head: the loss does not call
:func:`repro_torch.models.model.forward_mtp`, as in the JAX package) gets a
zero gradient, as ``jax.grad`` gives it.  The step runs eagerly.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward_train
from repro_torch.training.optimizer import AdamWConfig, OptState, adamw_update


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B,S,V) f32, labels (B,S) int -> scalar mean NLL."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    inputs = dict(batch)
    tokens = inputs.pop("tokens")
    labels = inputs.pop("labels")
    logits, aux = forward_train(cfg, params, {"tokens": tokens, **inputs})
    ce = cross_entropy(logits, labels)
    loss = ce + aux
    metrics = {"ce": ce, "router_aux": aux}
    return loss, metrics


def grads_of(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    """(loss, metrics, grads): ``loss_fn`` and its gradient with respect to
    every leaf of ``params``, as a tree of the same structure."""
    leaves, spec = tree_flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, tree_unflatten(live, spec), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(grads, spec)


def train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, params,
               opt_state: OptState, batch: Dict[str, torch.Tensor],
               lr_scale):
    """One optimizer step; returns (params, opt_state, metrics)."""
    loss, metrics, grads = grads_of(cfg, params, batch)
    params, opt_state, gnorm = adamw_update(opt_cfg, params, grads,
                                            opt_state, lr_scale)
    metrics = dict(metrics, loss=loss, grad_norm=gnorm)
    return params, opt_state, metrics


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig):
    return functools.partial(train_step, cfg, opt_cfg)
