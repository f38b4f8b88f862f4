"""Training step: CE loss (+ router aux) and the AdamW update, a copy of
the JAX package's ``repro.training.train_step``.

Gradients come from ``torch.autograd.grad`` over the params tree: each
leaf is made ``requires_grad`` for the step only, through a detached
alias, so the caller's tree is never marked.  A leaf the loss never reads
(DeepSeek-V3's ``mtp`` head: the loss does not call
:func:`repro_torch.models.model.forward_mtp`, as in the JAX package) gets a
zero gradient, as ``jax.grad`` gives it.  The step runs eagerly.

On a (data, model) mesh of ranks :class:`ShardedStep` runs the JAX
package's production layout, TP on "model" and FSDP on "data"
(``training.fsdp``), as one process per rank.
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


def _shapes(tree) -> Dict[str, tuple]:
    from repro_torch.launch.specs import map_with_path
    out = {}
    map_with_path(lambda path, t: out.__setitem__(path, tuple(t.shape)), tree)
    return out


@functools.lru_cache(maxsize=16)
def _whole_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    from repro_torch.models import init_params
    return _shapes(init_params(cfg, torch.Generator().manual_seed(0),
                               device="meta"))


def train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, params,
               opt_state: OptState, batch: Dict[str, torch.Tensor],
               lr_scale):
    """One optimizer step on one device; returns (params, opt_state,
    metrics).  A rank's part of a sharded tree raises: it runs only in
    the step of ``make_train_step(..., mesh=)``."""
    if _shapes(params) != _whole_shapes(cfg):
        raise RuntimeError(
            f"{cfg.name}: the param tree is not the whole model's (a rank's "
            f"part of a sharded tree?): a sharded tree trains only in the "
            f"step of make_train_step(cfg, opt_cfg, mesh=...)")
    loss, metrics, grads = grads_of(cfg, params, batch)
    params, opt_state, gnorm = adamw_update(opt_cfg, params, grads,
                                            opt_state, lr_scale)
    metrics = dict(metrics, loss=loss, grad_norm=gnorm)
    return params, opt_state, metrics


class ShardedStep:
    """The train step of one rank of a (data, model) mesh
    (``training.fsdp``): it takes this rank's part of the params and of
    the AdamW state (:meth:`shard` cuts them from whole trees) and the
    global batch, of which it runs its data rank's rows.  The loss is the
    mean of the data ranks' local means: the "data" gathers' backward
    reduce-scatters each cut leaf's gradient over the data width, and the
    gradients of leaves whole on "data" are averaged in one all-reduce.
    The clipping norm counts each element once (``global_norm`` with the
    cuts).  The metrics are the means over "data"."""

    def __init__(self, cfg: ModelConfig, opt_cfg: AdamWConfig, mesh):
        from repro_torch.models import init_params
        from repro_torch.training import fsdp
        self.cfg, self.opt_cfg, self.mesh = cfg, opt_cfg, mesh
        whole = init_params(cfg, torch.Generator().manual_seed(0),
                            device="meta")
        self.cuts = fsdp.plan(cfg, whole, mesh)
        self.dims = fsdp.data_dims(self.cuts)

    def shard(self, params, device=None):
        """This rank's part of the whole tree ``params``."""
        from repro_torch.training import fsdp
        return fsdp.shard(params, self.cuts, self.mesh, device)

    def grads(self, params, batch: Dict[str, torch.Tensor]):
        """(loss, metrics, grads) of this rank's part: the gradient of
        the global loss with respect to each of its leaves, and the
        metrics' means over "data".  Runs inside the mesh's context."""
        from repro_torch import sharding
        from repro_torch.training import fsdp
        loss, metrics, grads = grads_of(self.cfg, params,
                                        fsdp.local_batch(batch, self.mesh))
        grads = fsdp.sync_replicated(grads, self.cuts, self.mesh)
        keys = sorted(metrics)
        values = torch.stack([loss] + [metrics[k] for k in keys])
        if self.mesh.data > 1:
            values = sharding.data_all_reduce_mean(values)
        return values[0], dict(zip(keys, values[1:])), grads

    def __call__(self, params, opt_state: OptState,
                 batch: Dict[str, torch.Tensor], lr_scale):
        with self.mesh.install(self.dims):
            loss, metrics, grads = self.grads(params, batch)
            params, opt_state, gnorm = adamw_update(
                self.opt_cfg, params, grads, opt_state, lr_scale,
                cuts=self.cuts)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh=None):
    """The train step: on one device (``mesh`` None, :func:`train_step`),
    or the :class:`ShardedStep` of this rank of ``mesh``
    (``training.fsdp.train_mesh`` over a ``meshserve.world`` world, or
    the dry run's ``recording_mesh``)."""
    if mesh is None:
        return functools.partial(train_step, cfg, opt_cfg)
    return ShardedStep(cfg, opt_cfg, mesh)
