"""Mesh carving: the ranks of one world become per-instance TP slices.

An AcceLLM *instance* is n accelerators under tensor parallelism (paper
§4.2.3: 4 accelerators, TP=4, one full model replica per instance).  The
JAX package carves one process's device list into one-axis ``("model",)``
meshes.  PyTorch has no single-controller mesh, so the port runs one
process per rank (``torch.distributed``) and carves the *ranks* of the
world into disjoint consecutive slices, one :class:`MeshSlice` per
instance.  Every rank runs the same program (SPMD) and builds every
engine: the engines of slices that hold it compute, the others keep only
their host bookkeeping (``repro_torch.serving.engine``).  Slices may be
heterogeneous: the paper's eval mixes H100 and Ascend 910B2 pods, which
become slices of different widths priced by different ``InstanceSpec``s.

:func:`carve_slices` creates the process groups the slices need on every
rank, in the same order: each slice's TP group, and once per world a
two-rank group for every pair of ranks, over which a cross-slice copy
broadcasts (``repro_torch.meshserve.collectives``).  With no initialized
world it carves over an explicit ``world`` size and creates no group, so
the layout rules can be checked in one process.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from itertools import combinations
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.device import Device, resolve_device


class MeshError(RuntimeError):
    """Raised when the world cannot back the requested slice shapes."""


#: process groups of the current world, keyed by their sorted ranks and
#: created once per world (every rank creates them in the same order)
_GROUPS: Dict[Tuple[int, ...], object] = {}
_GROUPS_OF: List[object] = [None]


def active_world():
    """``torch.distributed`` where a world is initialized, else None."""
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def group_of(ranks: Sequence[int]):
    """The process group over ``ranks`` (None where no world is up or the
    group would hold one rank).  Every rank of the world must ask for the
    same groups in the same order the first time."""
    dist = active_world()
    key = tuple(sorted(ranks))
    if dist is None or len(key) < 2:
        return None
    world = dist.group.WORLD
    if _GROUPS_OF[0] is not world:       # a new world: forget the old one
        _GROUPS.clear()
        _GROUPS_OF[0] = world
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(key))
    return _GROUPS[key]


def this_rank() -> int:
    """This process's rank in the world (0 with no world)."""
    dist = active_world()
    return dist.get_rank() if dist is not None else 0


@dataclass(frozen=True, eq=False)
class MeshSlice:
    """One instance's ranks: a one-axis ``("model",)`` TP slice."""

    index: int
    ranks: Tuple[int, ...]
    #: the device this process runs the slice's shards on
    device: torch.device
    #: the slice's TP process group (None with no world, or at width 1)
    group: object = field(default=None, repr=False)
    #: this process's rank in the world
    rank: int = 0

    @property
    def tp(self) -> int:
        return len(self.ranks)

    @property
    def devices(self) -> Tuple[int, ...]:
        """The slice's members: ranks of the world, one device each."""
        return self.ranks

    @property
    def lead(self) -> int:
        return self.ranks[0]

    @property
    def holds(self) -> bool:
        """Whether this process is one of the slice's ranks."""
        return self.rank in self.ranks

    @property
    def model_rank(self) -> int:
        return self.ranks.index(self.rank)

    def model_axis_for(self, cfg) -> Optional[str]:
        """The JAX package's gate of this config's sharding constraints:
        ``None`` when the head count does not divide the slice.  It
        switches no slice off: every leaf whose own dim divides is still
        cut (``meshserve.pool``), and only the head-bound modules stay
        whole (``pool.head_split`` is None)."""
        return "model" if cfg.num_heads % self.tp == 0 else None


def carve_slices(shapes: Union[int, Sequence[int]],
                 n_instances: Optional[int] = None, *,
                 world: Optional[int] = None, device: Device = "cuda"
                 ) -> Tuple[MeshSlice, ...]:
    """Carve the ranks ``0 .. world - 1`` (default: the initialized
    world's, else one) into consecutive disjoint slices.  ``shapes`` is one
    TP width applied to every instance (then ``n_instances`` is required)
    or an explicit per-instance width list (heterogeneous pods).
    ``device`` is where this process runs its shards: the card unless the
    caller asks for the CPU (a bare ``"cuda"`` means the current one)."""
    if isinstance(shapes, int):
        if n_instances is None:
            raise MeshError("carve_slices(tp_int) needs n_instances")
        widths: List[int] = [shapes] * n_instances
    else:
        widths = [int(w) for w in shapes]
    if any(w < 1 for w in widths):
        raise MeshError(f"slice widths must be >= 1, got {widths}")
    dist = active_world()
    if world is None:
        world = dist.get_world_size() if dist is not None else 1
    need = sum(widths)
    if need > world:
        raise MeshError(
            f"the slices need {need} ranks (widths {widths}) but the world "
            f"has {world}: start {need} processes, one per card "
            f"(repro_torch.launch.serve --mesh-tp starts them)")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dist is not None:
        # every pair of ranks, once per world, then each slice's TP group
        for pair in combinations(range(dist.get_world_size()), 2):
            group_of(pair)
    out, lo = [], 0
    for i, w in enumerate(widths):
        ranks = tuple(range(lo, lo + w))
        out.append(MeshSlice(index=i, ranks=ranks, device=dev,
                             group=group_of(ranks), rank=this_rank()))
        lo += w
    return tuple(out)
