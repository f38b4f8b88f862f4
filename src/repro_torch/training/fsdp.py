"""The sharded train step's layout: TP on "model", FSDP on "data".

The JAX package lowers ``train_step`` under the production layout
(``repro.launch.specs.param_pspecs(mode="train")``: TP on "model" plus
FSDP on "data") and GSPMD turns it into one program for every device.
The port runs that layout as one process per rank of a (data, model)
world, rank ``d * model + m``:

* **TP** on the model axis cuts each leaf by the rule table serving uses
  (``meshserve/pool.py::PARAM_RULES``: a rank computes whole heads,
  channel blocks or experts), and the model's explicit collectives
  (``repro_torch.sharding``) differentiate through it.  Where the query
  heads do not divide the model width the head-bound modules (attention,
  MLA, the mLSTM) run whole on every model rank, with the same gradient
  on each, and every other leaf is still cut where its dim divides;
* **FSDP** on the data axis then cuts each leaf of the rank's TP part,
  and its AdamW moments, in ``data`` equal slices along the dim that
  ``launch/specs.py::param_pspecs(mode="train")`` gives "data".  A leaf
  the pspec does not cut on "data" stays whole there; so does one whose
  "data" dim the TP rule already cut, or whose part does not divide, or
  a stacked leaf whose "data" dim is the repeat dim;
* the batch is cut over "data" along its batch dim (``input_specs``'s
  dim 0), where it divides the data width; else every data rank runs
  the whole batch.

:func:`plan` gives every leaf its :class:`Cut`; :func:`shard` cuts a
whole tree (real or meta) to one rank's part.  ``forward_train`` gathers
each repeat's leaves over "data" inside the checkpointed body and the
leaves outside the stack before the embedding; the gather's backward
reduce-scatters the gradient over the data width.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import sharding
from repro_torch.launch.specs import map_with_path, param_pspecs


class Cut(NamedTuple):
    """One leaf's cut on a rank: ``model`` is (dim, the indices this model
    rank keeps) or None (whole on "model"); ``data`` the dim cut in equal
    slices over "data" after it, or None."""
    model: Optional[Tuple[int, Tuple[int, ...]]]
    data: Optional[int]


@dataclass(frozen=True)
class TrainMesh:
    """A rank's place in a (data, model) world: the axis sizes, its rank
    on each, and their process groups (None on an axis of one, and on the
    recording mesh of the dry run)."""
    data: int
    model: int
    data_rank: int = 0
    model_rank: int = 0
    data_group: object = None
    model_group: object = None
    #: the dry run's recording mesh: no process group, rank 0
    recording: bool = False
    #: the production mesh's pod axis folds into "data" (the pspecs'
    #: ("pod", "data"))
    multi_pod: bool = False
    #: MoE dispatch (``sharding.ShardCtx.moe_strategy``)
    moe_strategy: str = "auto"

    @property
    def size(self) -> int:
        return self.data * self.model

    def install(self, fsdp):
        """The sharding context of a step on this mesh, with ``fsdp`` the
        tree of each leaf's data-cut dim."""
        if self.recording:
            return sharding.record_mesh(model=self.model, data=self.data,
                                        fsdp=fsdp,
                                        moe_strategy=self.moe_strategy)
        if self.size == 1:
            return contextlib.nullcontext()
        return sharding.use_mesh(self.model_group,
                                 batch_group=self.data_group,
                                 data_group=self.data_group, fsdp=fsdp,
                                 moe_strategy=self.moe_strategy)


def train_mesh(data: int, model: int) -> TrainMesh:
    """This process's place in the initialized world of ``data * model``
    ranks, rank ``d * model + m``.  Every rank creates the model groups,
    then the data groups, in the same order."""
    from repro_torch.meshserve.topology import active_world, group_of
    dist = active_world()
    world = dist.get_world_size() if dist is not None else 1
    if world != data * model:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks; the world has {world}")
    rank = dist.get_rank() if dist is not None else 0
    model_groups = [group_of([d * model + m for m in range(model)])
                    for d in range(data)]
    data_groups = [group_of([d * model + m for d in range(data)])
                   for m in range(model)]
    d, m = divmod(rank, model)
    return TrainMesh(data, model, d, m, data_groups[m], model_groups[d])


def recording_mesh(data: int, model: int, multi_pod: bool = False
                   ) -> TrainMesh:
    """Rank 0 of a (data, model) mesh that records its collectives (the
    dry run's per-rank program)."""
    return TrainMesh(data, model, recording=True, multi_pod=multi_pod)


def _stacked(path: str) -> bool:
    return path.startswith("segments/") or path.startswith(
        "encoder/segments/")


def _data_dim(spec) -> Optional[int]:
    for i, ax in enumerate(spec):
        if ax is not None and "data" in (ax if isinstance(ax, tuple)
                                         else (ax,)):
            return i
    return None


def plan(cfg, params, mesh: TrainMesh):
    """Every leaf's :class:`Cut` on this rank, from the whole tree
    ``params`` (meta tensors will do)."""
    from repro_torch.meshserve.pool import head_split, kept, param_rule
    tp, dp = mesh.model, mesh.data
    split = head_split(cfg, tp)
    specs = param_pspecs(cfg, params, mode="train", multi_pod=mesh.multi_pod,
                         model_n=tp) if dp > 1 else None

    def cut(path, leaf):
        model = None
        rule = param_rule(cfg, path)
        if rule is not None:
            dim = rule[0] % leaf.dim()
            idx = kept(rule, leaf.shape[dim], tp, mesh.model_rank, split,
                       unit=cfg.head_dim)
            if idx is not None:
                model = (dim, tuple(idx))
        data = _data_dim(_at(specs, path)) if specs is not None else None
        if data is not None and (
                (model is not None and model[0] == data)
                or leaf.shape[data] % dp or (_stacked(path) and data == 0)):
            data = None
        return Cut(model, data)

    return map_with_path(cut, params)


def data_dims(cuts):
    """The tree of each leaf's data-cut dim (``sharding.use_mesh``'s
    ``fsdp``)."""
    return map_with_path(lambda _, c: c.data, cuts)


def _leaf(t: torch.Tensor, c: Cut, mesh: TrainMesh, device) -> torch.Tensor:
    if c.model is not None:
        dim, idx = c.model
        lo = idx[0]
        if idx == tuple(range(lo, lo + len(idx))):
            t = t.narrow(dim, lo, len(idx))
        else:
            t = t.index_select(dim, torch.as_tensor(idx, device=t.device))
    if c.data is not None:
        k = t.shape[c.data] // mesh.data
        t = t.narrow(c.data, mesh.data_rank * k, k)
    return t.to(device, copy=True).contiguous()


def shard(params, cuts, mesh: TrainMesh, device=None):
    """This rank's part of the whole tree ``params`` (a new tree on
    ``device``, default the leaves' own; the input is untouched)."""
    def take(path, t):
        return _leaf(t, _at(cuts, path), mesh,
                     t.device if device is None else device)
    return map_with_path(take, params)


def _at(tree, path: str):
    for key in path.split("/"):
        tree = tree[int(key)] if isinstance(tree, list) else tree[key]
    return tree


def local_batch(batch: Dict[str, torch.Tensor], mesh: TrainMesh
                ) -> Dict[str, torch.Tensor]:
    """This data rank's rows of every input (dim 0, the batch dim of
    ``input_specs``), where the batch divides the data width."""
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if mesh.data > 1 and B % mesh.data == 0:
            n = B // mesh.data
            v = v.narrow(0, mesh.data_rank * n, n)
        out[k] = v
    return out


def with_cuts(tree, cuts) -> list:
    """(path, leaf, its :class:`Cut`) for every leaf of ``tree``, matched
    by path (the trees' key orders may differ)."""
    out = []
    map_with_path(lambda path, t: out.append((path, t, _at(cuts, path))),
                  tree)
    return out


def sync_replicated(grads, cuts, mesh: TrainMesh):
    """The mean over "data" of the gradients of leaves whole on "data"
    (each data rank holds its batch's), in one f32 all-reduce; the cut
    leaves' gradients came reduce-scattered from the gathers'
    backward."""
    if mesh.data == 1:
        return grads
    whole = [(p, g) for p, g, c in with_cuts(grads, cuts) if c.data is None]
    if not whole:
        return grads
    flat = sharding.data_all_reduce_mean(
        torch.cat([g.reshape(-1).float() for _, g in whole]))
    synced, lo = {}, 0
    for p, g in whole:
        synced[p] = flat[lo: lo + g.numel()].reshape(g.shape).to(g.dtype)
        lo += g.numel()
    return map_with_path(lambda p, g: synced.get(p, g), grads)


def leaf_bytes(tree) -> int:
    """Bytes of every tensor leaf of a nested dict/list/tuple tree."""
    if isinstance(tree, dict):
        return sum(leaf_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(leaf_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0

