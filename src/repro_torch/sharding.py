"""Mesh/sharding context shared across the model, serving and training
layers.

The JAX package's model code is mesh-agnostic: GSPMD turns its sharding
constraints into collectives, and ``jax.grad`` differentiates through
them.  PyTorch has no GSPMD, so the port runs explicit Megatron-style
tensor parallelism (TP), one process per rank: the model calls
:func:`reduce` after a row-parallel product, :func:`copy_in` before a
column-parallel one, and :func:`gather` where each rank holds one slice of
a dimension (the vocab-sharded head), and this module knows the ranks
they run over.  An engine installs a context with :func:`use_mesh` around
its dispatches.  The model calls the helpers only where its weights'
shapes show a shard (fewer heads, ``w_down`` rows or vocab rows than the
config's), so with no context installed (``model_size == 1``) they raise:
a rank's partial without its ranks' sum is a wrong answer, never a
result.  Whole weights run on one device with no context and no
collective.

Every collective is a ``torch.autograd.Function`` with the backward that
explicit TP needs, so ``forward_train`` differentiates through a sharded
tree (``repro_torch.training.fsdp``):

  reduce      all-reduce forward, identity backward (the sum is
              replicated: every rank's gradient of it is whole);
  copy_in     identity forward, all-reduce of the gradient backward (a
              replicated tensor entering a rank's part of a product: each
              rank's gradient of it is a partial);
  gather      the vocab-sharded head's all-gather forward, the rank's own
              slice of the gradient backward;
  all_to_all  MoE's exchange forward, the reverse exchange backward;
  batch_mean  the mean over the batch group forward and backward (the
              MoE aux loss's ``pmean``);
  gather_data FSDP's all-gather of a leaf's "data" cut forward, the
              reduce-scatter of its gradient over the data width backward
              (the loss is the mean of the data ranks' local means).

Under sequence parallelism (``REPRO_SEQ_PARALLEL=1``: the residual
stream between modules holds this model rank's S / tp rows, see
``repro_torch.models.model``) three more ops run over "model" on the
sequence dim (dim 1), each built on the all-gather and f32
reduce-scatter FSDP uses:

  seq_gather  all-gather forward, reduce-scatter of the gradient
              backward: it replaces a module's entry ``copy_in`` (each
              rank's gradient of the gathered rows is a partial); with
              ``whole`` (a module every rank runs whole, the same
              gradient on each) the backward takes the rank's rows;
  seq_scatter f32 reduce-scatter of the ranks' partials forward (then
              the cast), all-gather backward: it replaces a module's
              closing ``reduce``;
  seq_split   the rank's rows of a tensor every rank holds whole
              forward, all-gather backward: the exit of a module every
              rank runs whole, and the whole embedding's.

A reduce-scatter and an all-gather put on a ring the wire bytes of the
all-reduce they replace (in f32; the gather moves the model's dtype).
:func:`module_in` and :func:`module_out` pick a module boundary's op
from whether the module's weights are cut and whether the sequence is.

Under ``torch.no_grad`` (serving) each is its forward alone, the calls of
the serving path.

The context holds the model axis as a process group, with this process's
rank in it and its size; where a batch dimension is split across
processes, the batch group; and in training the "data" group with the
tree of each leaf's data-cut dim (:func:`use_mesh`'s ``fsdp``).
:func:`spec` keeps the JAX package's logical-axis rules:

  batch  — data-parallel batch dim        -> the batch axes, or None
  model  — tensor/expert parallel dim     -> the model axis
  seq    — sequence dim between TP blocks -> the model axis (the
           residual's rows under ``REPRO_SEQ_PARALLEL=1``)

:func:`record_mesh` installs a recording mesh instead, for the dry run's
per-rank program: the axis sizes of the production mesh, rank 0 on each,
and no process group.  On meta tensors each collective returns its
result's shape and records (kind, result bytes, group size) with
``repro_torch.core.opcount`` (inside a counted loop, once per trip); on
any other tensor it raises.

Every reduction runs in f32 on every backend (cast, reduce, cast back):
gloo, which the CPU tests and the one-card phases run on, reduces bf16 on
the CPU but is not relied on to do so on CUDA tensors, and an f32 sum of
the partials is what one device's f32 accumulator would give before its
own rounding.  gloo runs only all-reduce and broadcast on CUDA tensors, so
there an all-gather is an all-reduce of zero-padded slices and a
reduce-scatter an all-reduce and the rank's slice (exact either way; the
recorder and the counts name the collective they stand for).  Nothing
here moves a tensor to the host.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import opcount


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
    #: FSDP: the "data" group, this rank in it, its size, and the tree of
    #: each param leaf's data-cut dim (None: whole on "data")
    data_group: object = None
    data_rank: int = 0
    data_size: int = 1
    fsdp: Any = None
    #: the recording mesh of the dry run: its log of the collectives
    #: recorded where no ``opcount.Counter`` is active, (kind, result
    #: bytes, group size) -> calls (None: collectives run)
    recorder: Optional[Dict[Tuple[str, int, int], float]] = None


_CTX = ShardCtx()


def current() -> ShardCtx:
    return _CTX


@contextlib.contextmanager
def _installed(ctx: ShardCtx):
    global _CTX
    prev = _CTX
    _CTX = ctx
    try:
        yield _CTX
    finally:
        _CTX = prev


def use_mesh(model_group=None, *, batch_group=None, batch_axes=("data",),
             model_axis: Optional[str] = "model",
             moe_strategy: str = "auto", data_group=None, fsdp=None):
    """Install the TP context: ``model_group`` is the process group of
    this rank's model axis (None, or a group of one, runs whole).  In
    training ``data_group`` is the "data" axis's group and ``fsdp`` the
    tree of each param leaf's data-cut dim."""
    import torch.distributed as dist

    def size(g):
        return dist.get_world_size(g) if g is not None else 1

    m_size, b_size, d_size = size(model_group), size(batch_group), \
        size(data_group)
    return _installed(ShardCtx(
        model_group=model_group if m_size > 1 else None,
        model_rank=dist.get_rank(model_group) if m_size > 1 else 0,
        model_size=m_size,
        batch_group=batch_group if b_size > 1 else None,
        batch_size=b_size,
        batch_axes=tuple(batch_axes) if b_size > 1 else (),
        model_axis=model_axis if m_size > 1 else None,
        moe_strategy=moe_strategy,
        data_group=data_group if d_size > 1 else None,
        data_rank=dist.get_rank(data_group) if d_size > 1 else 0,
        data_size=d_size,
        fsdp=fsdp if d_size > 1 else None))


def record_mesh(*, model: int, data: int, fsdp=None,
                moe_strategy: str = "auto", batch: bool = True):
    """Install a recording mesh of ``data`` x ``model`` ranks (the batch
    split over "data" unless ``batch`` is False: a serving step, whose
    MoE aux loss no caller reads), this process as rank 0 of each axis,
    with no process group: every collective of this module, on meta
    tensors, returns its result's shape and is recorded (see the module
    docstring)."""
    b_size = data if batch else 1
    return _installed(ShardCtx(
        model_rank=0, model_size=model,
        batch_size=b_size, batch_axes=("data",) if b_size > 1 else (),
        model_axis="model" if model > 1 else None,
        moe_strategy=moe_strategy, data_rank=0, data_size=data,
        fsdp=fsdp if data > 1 else None,
        recorder={}))


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
# one collective: run it, or record it
# ---------------------------------------------------------------------------

#: per axis: the context's (group, size, rank) fields
_AXES = {"model": ("model_group", "model_size", "model_rank"),
         "batch": ("batch_group", "batch_size", None),
         "data": ("data_group", "data_size", "data_rank")}


def model_sharded(what: str) -> ShardCtx:
    """The context, where a model axis is installed (a process group or
    the recording mesh); else raise: a sharded tree ran with no mesh."""
    ctx = _CTX
    if ctx.model_group is None and not (ctx.recorder is not None
                                        and ctx.model_size > 1):
        raise RuntimeError(
            f"{what} of a sharded tensor with no mesh installed: run a "
            f"sharded param tree inside sharding.use_mesh over its model "
            f"axis's process group")
    return ctx


def _axis(axis: str, what: str):
    """(group, size, rank) of ``axis`` in the context."""
    ctx = model_sharded(what) if axis == "model" else _CTX
    g, n, r = _AXES[axis]
    group, size = getattr(ctx, g), getattr(ctx, n)
    if group is None and ctx.recorder is None:
        raise RuntimeError(f"{what}: no {axis} group installed")
    return group, size, getattr(ctx, r) if r else 0


def _native(x: torch.Tensor, group) -> bool:
    """Whether the group's backend runs every collective on ``x``'s
    device (gloo runs only all-reduce and broadcast on CUDA tensors)."""
    import torch.distributed as dist
    return not x.is_cuda or dist.get_backend(group) != "gloo"


def _dist_op(name: str, older: str):
    """``torch.distributed``'s ``name``, or its older name where this
    version predates it."""
    import torch.distributed as dist
    return getattr(dist, name, None) or getattr(dist, older)


def _issue(kind: str, axis: str, x: torch.Tensor, shape, dtype, run,
           what: str) -> torch.Tensor:
    """Run one collective (``run(group, size, rank)``), or under the
    recording mesh record it and return a meta result of ``shape``."""
    group, n, rank = _axis(axis, what)
    rec = _CTX.recorder
    if rec is None:
        return run(group, n, rank)
    if not x.is_meta:
        raise RuntimeError(
            f"{what}: the recording mesh traces meta tensors only, got a "
            f"tensor on {x.device}")
    out = torch.empty(tuple(shape), dtype=dtype, device="meta")
    opcount.collective(kind, out.numel() * out.element_size(), n, rec)
    return out


def _all_reduce_f32(x: torch.Tensor, axis: str, what: str) -> torch.Tensor:
    def run(group, n, rank):
        import torch.distributed as dist
        y = x.to(torch.float32, copy=True).contiguous()
        dist.all_reduce(y, group=group)
        return y
    return _issue("all-reduce", axis, x, x.shape, torch.float32, run,
                  what).to(x.dtype)


def _all_gather(x: torch.Tensor, dim: int, axis: str, what: str
                ) -> torch.Tensor:
    """Each rank's equal slice of ``dim``, concatenated in rank order."""
    dim = dim % x.dim()

    def run(group, n, rank):
        import torch.distributed as dist
        shape = list(x.shape)
        shape[dim] *= n
        if _native(x, group):
            y = x.movedim(dim, 0).contiguous()
            buf = torch.empty((n * y.shape[0],) + tuple(y.shape[1:]),
                              dtype=x.dtype, device=x.device)
            _dist_op("all_gather_single", "all_gather_into_tensor")(
                buf, y, group=group)
            return buf.movedim(0, dim)
        buf = torch.zeros(shape, dtype=torch.float32, device=x.device)
        buf.narrow(dim, rank * x.shape[dim], x.shape[dim]).copy_(x)
        dist.all_reduce(buf, group=group)
        return buf.to(x.dtype)

    _, n, _ = _axis(axis, what)
    shape = list(x.shape)
    shape[dim] *= n
    return _issue("all-gather", axis, x, shape, x.dtype, run, what)


def _reduce_scatter_f32(x: torch.Tensor, dim: int, axis: str, what: str,
                        scale: float = 1.0) -> torch.Tensor:
    """The sum over the ranks of ``x`` (f32) times ``scale``, and this
    rank's equal slice of ``dim`` of it, in ``x``'s dtype."""
    dim = dim % x.dim()

    def run(group, n, rank):
        import torch.distributed as dist
        k = x.shape[dim] // n
        y = x.to(torch.float32).movedim(dim, 0).contiguous()
        if _native(x, group):
            out = torch.empty((k,) + tuple(y.shape[1:]), dtype=torch.float32,
                              device=x.device)
            _dist_op("reduce_scatter_single", "reduce_scatter_tensor")(
                out, y, group=group)
        else:
            dist.all_reduce(y, group=group)
            out = y.narrow(0, rank * k, k)
        return out.movedim(0, dim)

    _, n, _ = _axis(axis, what)
    shape = list(x.shape)
    shape[dim] //= n
    return (_issue("reduce-scatter", axis, x, shape, torch.float32, run,
                   what) * scale).to(x.dtype)


def _all_to_all(x: torch.Tensor, what: str) -> torch.Tensor:
    def run(group, n, rank):
        import torch.distributed as dist
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out
    return _issue("all-to-all", "model", x, x.shape, x.dtype, run, what)


# ---------------------------------------------------------------------------
# the differentiable collectives
# ---------------------------------------------------------------------------


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce_f32(x, "model", "the reduce")

    @staticmethod
    def backward(ctx, g):
        return g


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, "model", "copy_in's backward")


class _BatchMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.n = _CTX.batch_size
        return _all_reduce_f32(x, "batch", "the batch mean") / ctx.n

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, "batch",
                               "the batch mean's backward") / ctx.n


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.rank = _CTX.model_rank
        return _all_gather(x, dim, "model", "the gather")

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_gather(x, 1, "model", "the sequence gather")

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_f32(g, 1, "model",
                                   "the sequence gather's backward")


class _SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _reduce_scatter_f32(x, 1, "model", "the sequence scatter")

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, 1, "model", "the sequence scatter's backward")


class _SeqSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        n = x.shape[dim] // _CTX.model_size
        return x.narrow(dim, _CTX.model_rank * n, n)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, "model",
                           "the sequence split's backward"), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_to_all(x, "the all-to-all")

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, "the all-to-all's backward")


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.n = dim, _CTX.data_size
        return _all_gather(x, dim, "data", "the FSDP gather")

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_f32(g, ctx.dim, "data",
                                   "the FSDP gather's backward",
                                   1.0 / ctx.n), None


def reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum the model ranks' partials (after a row-parallel product).
    Raises where no mesh is installed (see the module docstring)."""
    model_sharded("the reduce")
    return _Reduce.apply(x)


def copy_in(x: torch.Tensor) -> torch.Tensor:
    """``x``, which every model rank holds whole, entering this rank's
    part of a column-parallel product: the identity, whose backward sums
    the ranks' gradients.  Raises where no mesh is installed."""
    model_sharded("copy_in")
    return _CopyIn.apply(x)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the batch group's ranks (the MoE aux loss's ``pmean``)."""
    if _CTX.batch_size == 1:
        return x
    return _BatchMean.apply(x)


def gather(x: torch.Tensor, dim: int, full: int) -> torch.Tensor:
    """Each model rank holds the ``rank``-th of ``model_size`` equal
    slices of dim ``dim`` (of size ``full``): every rank gets the whole
    tensor.  Raises where no mesh is installed."""
    ctx = model_sharded("the gather")
    if x.shape[dim] * ctx.model_size != full:
        raise ValueError(f"{ctx.model_size} slices of {x.shape[dim]} are "
                         f"not {full}")
    return _Gather.apply(x, dim % x.dim())


def seq_gather(x: torch.Tensor, whole: bool = False) -> torch.Tensor:
    """The whole sequence (dim 1) of which each model rank holds its
    equal block of rows, in rank order.  The backward reduce-scatters the
    ranks' partial gradients; with ``whole`` (the rows enter a
    computation every rank runs whole, so each holds the whole gradient)
    it takes the rank's rows of it instead."""
    model_sharded("the sequence gather")
    if whole:
        return _Gather.apply(x, 1)
    return _SeqGather.apply(x)


def seq_scatter(x: torch.Tensor) -> torch.Tensor:
    """The sum of the model ranks' partials ``x`` (B, S, ...), f32, and
    this rank's block of S / tp rows of it, in ``x``'s dtype."""
    ctx = model_sharded("the sequence scatter")
    if x.shape[1] % ctx.model_size:
        raise ValueError(f"{x.shape[1]} rows do not divide "
                         f"{ctx.model_size} model ranks")
    return _SeqScatter.apply(x)


def seq_split(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This model rank's block of dim ``dim`` of ``x``, which every rank
    holds whole (no communication forward; the gradient's blocks are
    gathered backward)."""
    ctx = model_sharded("the sequence split")
    if x.shape[dim] % ctx.model_size:
        raise ValueError(f"{x.shape[dim]} rows do not divide "
                         f"{ctx.model_size} model ranks")
    return _SeqSplit.apply(x, dim % x.dim())


def module_in(x: torch.Tensor, sharded: bool, seq: bool) -> torch.Tensor:
    """A module's input ``x`` at its entry: where the sequence is cut
    (``seq``) the gathered rows (a module whose weights are not cut runs
    whole, see :func:`seq_gather`), else ``copy_in`` where the weights
    are cut, else ``x``."""
    if seq:
        return seq_gather(x, whole=not sharded)
    return copy_in(x) if sharded else x


def module_out(y: torch.Tensor, sharded: bool, seq: bool) -> torch.Tensor:
    """A module's output ``y`` at its exit: where the sequence is cut the
    rank's rows of the ranks' sum (:func:`seq_scatter`), or of the whole
    output every rank computed (:func:`seq_split`); else the
    ``reduce`` of a cut module's partials, or ``y``."""
    if seq:
        return seq_scatter(y) if sharded else seq_split(y)
    return reduce(y) if sharded else y


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """MoE's exchange over the model group: rank ``r`` sends its ``j``-th
    of ``model_size`` equal row blocks to rank ``j`` and receives rank
    ``j``'s ``r``-th in block ``j``."""
    model_sharded("the all-to-all")
    return _AllToAll.apply(x)


def gather_data(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole leaf of which each "data" rank holds an equal slice of
    ``dim`` (FSDP)."""
    return _GatherData.apply(x, dim % x.dim())


def unshard(tree, dims):
    """``tree`` with every leaf whose ``dims`` entry is an int gathered
    over "data" along it (``dims``: a tree of the same structure, or
    None: nothing is cut)."""
    if dims is None:
        return tree
    if isinstance(tree, dict):
        return {k: unshard(v, dims[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(unshard(v, d) for v, d in zip(tree, dims))
    return gather_data(tree, dims)


def data_all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the "data" ranks (f32; no gradient): the step's
    data-replicated gradients and its metrics."""
    return _all_reduce_f32(x, "data", "the data mean") / _CTX.data_size


def all_reduce_sum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The f32 sum over ``axis`` ("model" or "data"; no gradient): the
    global norm's partial sums."""
    return _all_reduce_f32(x, axis, f"the {axis} sum")
