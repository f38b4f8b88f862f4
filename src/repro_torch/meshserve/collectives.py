"""Cross-slice redundancy transfers, counted.

``MirrorSync``, ``StreamState`` and the Splitwise handoff move KV state
between *instances*.  When the instances live on disjoint mesh slices
the bytes ride the collectives between the slices' ranks; the port's
code never moves a tensor to the host itself.  The functions here are
the one place that movement happens, and every hop is counted in
:data:`STATS`: as device-to-device where the backend keeps it on the
device (NCCL on CUDA tensors; gloo on host tensors, whose device is the
host), and as a host copy where it does not (gloo on CUDA tensors, which
stages every collective through host memory).  So ``host_copies == 0``
is the fast path's contract, and a world that breaks it says so.

A store's state is spread over its slice's ranks (:class:`Holders`):
each cut leaf lists, per rank, the global indices of its cut dim that
the rank holds (its KV heads, its block of a recurrent state's channels
or heads, as ``meshserve.pool.shard_store`` cut them), and every other
leaf is whole on every rank.  A pull plans, for every destination rank
and every cut leaf, which source rank supplies each index it holds
(itself where it holds that index on the source slice too, else the
first source rank that does), and takes the whole leaves from itself,
else from the source's first rank; then it moves each (source,
destination) pair's rows as ONE ``broadcast`` in the pair's two-rank
group: the leaves packed as bytes, so a copy is one collective per pair
whatever the dtype.  ``broadcast`` is the collective every
backend runs on every device (gloo has no ``send``/``recv`` on CUDA
tensors, and NCCL puts one rank on one card).  Every rank runs every
pull in the same order (SPMD); a rank outside both slices does nothing.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.meshserve.topology import active_world, group_of, this_rank


@dataclass
class TransferStats:
    """Counters over the cross-slice transfers this process took part in
    since the last reset."""

    d2d_copies: int = 0      #: hops that stayed device-to-device
    d2d_bytes: int = 0       #: payload bytes of those hops
    host_copies: int = 0     #: hops that went through the host
    host_bytes: int = 0      #: payload bytes of those hops

    def reset(self) -> None:
        self.d2d_copies = 0
        self.d2d_bytes = 0
        self.host_copies = 0
        self.host_bytes = 0


#: the transfer counter: one per process
STATS = TransferStats()

#: a state leaf's path in its store: (segment, layer part, key)
Path = Tuple[int, str, str]
#: a cut leaf's layout: per model rank, the global indices of the cut dim
#: it holds, in local order (a ``range`` for a block)
Layout = Tuple[Sequence[int], ...]


@dataclass(frozen=True)
class Holders:
    """Where a store's state lives: its ranks, and per cut leaf its
    (negative) cut dim and :data:`Layout`; a leaf not in ``cuts`` is whole
    on every rank."""

    ranks: Tuple[int, ...]
    cuts: Mapping[Path, Tuple[int, Layout]] = field(default_factory=dict)


def whole_holders() -> Holders:
    """A whole store that every rank of the world builds (one rank with
    no world)."""
    dist = active_world()
    return Holders(tuple(range(dist.get_world_size() if dist else 1)))


@dataclass
class SliceChunk:
    """One streamed layer-part leaf of a sharded store: this rank's view
    of it (None where this rank holds none of the store) and where the
    rest lives."""

    tensor: Optional[torch.Tensor]
    holders: Holders


#: one copy item: (destination view or None, source view or None, the
#: leaf's path in both stores, or None for a leaf whole everywhere)
Item = Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[Path]]

#: a cut's plan key: (the destination's layout, the source's), either
#: None where that side holds the leaf whole on every rank
Kind = Tuple[Optional[Layout], Optional[Layout]]

#: one pair's move: (src rank, dst rank, per kind the dst positions it
#: fills and the src positions they come from, whether the pair also
#: moves the whole leaves)
Move = Tuple[int, int, Dict[Kind, Tuple[List[int], List[int]]], bool]


def _units(layout: Optional[Layout], other: Optional[Layout], i: int
           ) -> Sequence[int]:
    """The indices model rank ``i`` holds: its part of ``layout``, or,
    where it holds the leaf whole, every index the other side's ranks
    hold between them (the whole dim)."""
    if layout is not None:
        return layout[i]
    return sorted(set().union(*map(set, other)))


@functools.lru_cache(maxsize=256)
def _plan(dst: Tuple[int, ...], src: Tuple[int, ...],
          kinds: Tuple[Kind, ...]) -> List[Move]:
    """The moves of a pull between the ranks ``dst`` and ``src``: every
    destination rank fills each index it holds of each cut from itself
    where it holds that index on the source slice too, else from the
    first source rank that does, and takes the whole leaves from itself,
    else from the source's first rank."""
    at = {kind: {r: {u: p for p, u in enumerate(_units(kind[1], kind[0], i))}
                 for i, r in enumerate(src)} for kind in kinds}
    out = []
    for i, d in enumerate(dst):
        by_src: Dict[int, Dict[Kind, Tuple[List[int], List[int]]]] = {}
        for kind in kinds:
            held = at[kind]
            for p, u in enumerate(_units(kind[0], kind[1], i)):
                s = d if d in held and u in held[d] else next(
                    r for r in src if u in held[r])
                dp, sp = by_src.setdefault(s, {}).setdefault(kind, ([], []))
                dp.append(p)
                sp.append(held[s][u])
        whole_from = d if d in src else src[0]
        by_src.setdefault(whole_from, {})
        for s in sorted(by_src):
            out.append((s, d, by_src[s], s == whole_from))
    return out


def _pick(view: torch.Tensor, axis: Optional[int], pos: List[int]):
    if axis is None or _all(view, axis, pos):
        return view
    return view.index_select(axis, torch.as_tensor(pos, device=view.device))


def _put(view: torch.Tensor, axis: Optional[int], pos: List[int],
         part: torch.Tensor) -> None:
    if axis is None or _all(view, axis, pos):
        view.copy_(part)
    else:
        view.index_copy_(axis, torch.as_tensor(pos, device=view.device),
                         part)


def _all(view: torch.Tensor, axis: int, pos: List[int]) -> bool:
    """Whether ``pos`` is every index of ``view``'s ``axis``, in order."""
    return pos == list(range(view.shape[axis]))


def _shape(view: torch.Tensor, axis: Optional[int], n: int):
    shape = list(view.shape)
    if axis is not None:
        shape[axis] = n
    return shape


def pull(items: Sequence[Item], dst: Holders, src: Holders) -> None:
    """Copy each item's source rows into its destination view across the
    two stores' ranks (see the module docstring).  ``items`` are the same
    leaves, in the same order, on every rank."""
    import torch.distributed as dist
    me = this_rank()
    cuts = []                         # per item: None, or (axis, kind)
    for _, _, path in items:
        dc, sc = dst.cuts.get(path), src.cuts.get(path)
        cut = dc or sc
        cuts.append(None if cut is None else (
            cut[0], (dc and dc[1], sc and sc[1])))
    kinds = tuple(dict.fromkeys(c[1] for c in cuts if c is not None))
    for s, d, pos, whole in _plan(dst.ranks, src.ranks, kinds):
        if me not in (s, d):
            continue
        # (dst view, src view, axis, dst positions, src positions) of
        # every leaf this pair moves
        moves = []
        for (dv, sv, _), cut in zip(items, cuts):
            if cut is None:
                if whole:
                    moves.append((dv, sv, None, [], []))
            elif cut[1] in pos:
                dp, sp = pos[cut[1]]
                moves.append((dv, sv, cut[0], dp, sp))
        if not moves:
            continue
        if s == d:                       # held on this rank: a local copy
            for dv, sv, ax, dp, sp in moves:
                _put(dv, ax, dp, _pick(sv, ax, sp))
            continue
        if me == s:
            buf = torch.cat([_pick(sv, ax, sp).contiguous().view(-1)
                             .view(torch.uint8)
                             for _, sv, ax, _, sp in moves])
        else:
            shapes = [(dv, ax, dp, _shape(dv, ax, len(dp)))
                      for dv, _, ax, dp, _ in moves]
            n = sum(int(torch.Size(sh).numel()) * dv.element_size()
                    for dv, _, _, sh in shapes)
            buf = torch.empty((n,), dtype=torch.uint8,
                              device=moves[0][0].device)
        group = group_of((s, d))
        dist.broadcast(buf, src=s, group=group)
        if _through_host(buf, group):
            STATS.host_copies += 1
            STATS.host_bytes += int(buf.numel())
        else:
            STATS.d2d_copies += 1
            STATS.d2d_bytes += int(buf.numel())
        if me == d:
            off = 0
            for dv, ax, dp, sh in shapes:
                nb = int(torch.Size(sh).numel()) * dv.element_size()
                part = buf[off: off + nb].view(dv.dtype).view(sh)
                _put(dv, ax, dp, part)
                off += nb


def _through_host(buf: torch.Tensor, group) -> bool:
    """Whether the group's backend ran this collective through the host:
    a CUDA tensor on a backend that does not run NCCL for CUDA (gloo)."""
    import torch.distributed as dist
    return buf.is_cuda and "nccl" not in str(dist.get_backend(group))


def same_devices(a, b) -> bool:
    """Whether two stores (or tensors) live on the same devices: the gate
    between the local copies and the cross-slice pulls.  A store built on
    a mesh slice never counts as local to another store."""
    ha, hb = getattr(a, "holders", None), getattr(b, "holders", None)
    if ha is not None or hb is not None:
        return ha is not None and ha == hb
    return _device_of(a) == _device_of(b)


def _device_of(x) -> Optional[torch.device]:
    if isinstance(x, torch.Tensor):
        return x.device
    return getattr(x, "device", None)
