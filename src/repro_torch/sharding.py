"""Mesh/sharding context shared across the model and serving layers.

The JAX package's model code is mesh-agnostic: GSPMD turns its sharding
constraints into collectives.  PyTorch has no GSPMD, so the port runs
explicit Megatron-style tensor parallelism (TP), one process per rank:
the model calls :func:`reduce` after a row-parallel product and
:func:`gather` where each rank holds one slice of a dimension (the
vocab-sharded head), and this module knows the ranks they run over.  An
engine installs a context with :func:`use_mesh` around its dispatches.
The model calls the helpers only where its weights' shapes show a shard
(fewer heads, ``w_down`` rows or vocab rows than the config's), so with
no context installed (``model_size == 1``) both raise: a rank's partial
without its ranks' sum is a wrong answer, never a result.  Whole weights
run on one device with no context and no collective.

The context holds the model axis as a process group, with this process's
rank in it and its size, and, where a batch dimension is split across
processes (the MoE tests' ``("data", "model")`` grid), the batch group.
:func:`spec` keeps the JAX package's logical-axis rules:

  batch  — data-parallel batch dim        -> the batch axes, or None
  model  — tensor/expert parallel dim     -> the model axis
  seq    — sequence dim between TP blocks -> the model axis

Every reduction runs in f32 on every backend (cast, reduce, cast back):
gloo, which the CPU tests and the one-card phases run on, reduces bf16 on
the CPU but is not relied on to do so on CUDA tensors, and an f32 sum of
the partials is what one device's f32 accumulator would give before its
own rounding.  Nothing here moves a tensor to the host.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass
class ShardCtx:
    #: process group of the model (tensor/expert parallel) axis, or None
    model_group: object = None
    #: this process's rank within ``model_group`` and the group's size
    model_rank: int = 0
    model_size: int = 1
    #: process group over which the batch dim is split (None: whole)
    batch_group: object = None
    batch_size: int = 1
    batch_axes: Tuple[str, ...] = ()
    model_axis: Optional[str] = None
    #: MoE dispatch strategy: "a2a" (tokens shard over the model axis,
    #: two all-to-alls), "psum" (each model shard computes its local
    #: experts on all tokens, partials all-reduced) or "auto" (the JAX
    #: package's rule per call site)
    moe_strategy: str = "auto"


_CTX = ShardCtx()


def current() -> ShardCtx:
    return _CTX


@contextlib.contextmanager
def use_mesh(model_group=None, *, batch_group=None, batch_axes=("data",),
             model_axis: Optional[str] = "model",
             moe_strategy: str = "auto"):
    """Install the TP context: ``model_group`` is the process group of
    this rank's model axis (None, or a group of one, runs whole)."""
    import torch.distributed as dist
    global _CTX
    prev = _CTX
    m_size = dist.get_world_size(model_group) if model_group is not None \
        else 1
    b_size = dist.get_world_size(batch_group) if batch_group is not None \
        else 1
    _CTX = ShardCtx(
        model_group=model_group if m_size > 1 else None,
        model_rank=dist.get_rank(model_group) if m_size > 1 else 0,
        model_size=m_size,
        batch_group=batch_group if b_size > 1 else None,
        batch_size=b_size,
        batch_axes=tuple(batch_axes) if b_size > 1 else (),
        model_axis=model_axis if m_size > 1 else None,
        moe_strategy=moe_strategy)
    try:
        yield _CTX
    finally:
        _CTX = prev


def spec(*logical) -> Tuple:
    """Translate logical axis names into the partition-spec tuple of the
    active context (the JAX package's ``spec``, as a plain tuple)."""
    ctx = _CTX
    out = []
    for ax in logical:
        if ax is None:
            out.append(None)
        elif ax == "batch":
            out.append(ctx.batch_axes if ctx.batch_axes else None)
        elif ax in ("model", "seq"):
            out.append(ctx.model_axis)
        else:
            raise ValueError(f"unknown logical axis {ax!r}")
    return tuple(out)


# ---------------------------------------------------------------------------
# TP helpers the model calls
# ---------------------------------------------------------------------------


def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist
    y = x.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def _model_group(what: str):
    group = _CTX.model_group
    if group is None:
        raise RuntimeError(
            f"{what} of a sharded tensor with no mesh installed: run a "
            f"sharded param tree inside sharding.use_mesh over its model "
            f"axis's process group")
    return group


def reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum the model ranks' partials (after a row-parallel product).
    Raises where no mesh is installed (see the module docstring)."""
    return _all_reduce_f32(x, _model_group("the reduce"))


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the batch group's ranks (the MoE aux loss's ``pmean``)."""
    ctx = _CTX
    if ctx.batch_group is None:
        return x
    return _all_reduce_f32(x, ctx.batch_group) / ctx.batch_size


def gather(x: torch.Tensor, dim: int, full: int) -> torch.Tensor:
    """Each model rank holds the ``rank``-th of ``model_size`` equal
    slices of dim ``dim`` (of size ``full``): every rank gets the whole
    tensor.  Built on all-reduce (each rank writes its slice into a zero
    buffer), which every backend runs on every device; the sum of one
    value and zeros is exact.  Raises where no mesh is installed."""
    group = _model_group("the gather")
    ctx = _CTX
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = full
    buf = torch.zeros(shape, dtype=torch.float32, device=x.device)
    buf.narrow(dim, ctx.model_rank * n, n).copy_(x)
    import torch.distributed as dist
    dist.all_reduce(buf, group=group)
    return buf.to(x.dtype)
