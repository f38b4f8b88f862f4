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

A store's state is spread over its slice's ranks: each rank holds whole
KV heads of the head-sharded leaves (:class:`Holders`), and every other
leaf whole.  A pull plans, for every destination rank, which source rank
supplies each KV head it holds (itself where it holds the head on the
source slice too, else the first source rank that does), then moves each
(source, destination) pair's rows as ONE ``broadcast`` in the pair's
two-rank group: the leaves packed as bytes, so a copy is one collective
per pair whatever the dtype.  ``broadcast`` is the collective every
backend runs on every device (gloo has no ``send``/``recv`` on CUDA
tensors, and NCCL puts one rank on one card).  Every rank runs every
pull in the same order (SPMD); a rank outside both slices does nothing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

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


@dataclass(frozen=True)
class Holders:
    """Where a store's state lives: its ranks and, per rank, the global
    KV heads of its head-sharded leaves, in local order (a head may repeat
    where a rank's query heads each read their own copy)."""

    ranks: Tuple[int, ...]
    heads: Tuple[Tuple[int, ...], ...]

    @classmethod
    def everywhere(cls, world: int, kv_heads: int) -> "Holders":
        """A whole store built on every rank (an unsharded engine)."""
        whole = tuple(range(kv_heads))
        return cls(tuple(range(world)), (whole,) * world)

    def heads_of(self, rank: int) -> Tuple[int, ...]:
        return self.heads[self.ranks.index(rank)]


def whole_holders(kv_heads: int) -> Holders:
    """A whole store that every rank of the world builds (one rank with
    no world)."""
    dist = active_world()
    return Holders.everywhere(dist.get_world_size() if dist else 1,
                              kv_heads)


@dataclass
class SliceChunk:
    """One streamed layer-part leaf of a sharded store: this rank's view
    of it (None where this rank holds none of the store) and where the
    rest lives."""

    tensor: Optional[torch.Tensor]
    holders: Holders


#: one copy item: (destination view or None, source view or None, the
#: KV-head axis of both views, or None for a leaf held whole)
Item = Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[int]]


def _plan(dst: Holders, src: Holders
          ) -> List[Tuple[int, int, List[int], List[int], bool]]:
    """``(src rank, dst rank, dst positions, src positions, whole)``
    per pair that moves anything: the destination's local head positions
    it fills from that source, the source's local positions they come
    from, and whether the pair also moves the whole (unsharded) leaves."""
    out = []
    for d in dst.ranks:
        want = dst.heads_of(d)
        by_src: Dict[int, Tuple[List[int], List[int]]] = {}
        for p, h in enumerate(want):
            s = d if d in src.ranks and h in src.heads_of(d) else next(
                r for r in src.ranks if h in src.heads_of(r))
            dp, sp = by_src.setdefault(s, ([], []))
            dp.append(p)
            sp.append(src.heads_of(s).index(h))
        whole_from = d if d in src.ranks else src.ranks[0]
        by_src.setdefault(whole_from, ([], []))
        for s in sorted(by_src):
            dp, sp = by_src[s]
            out.append((s, d, dp, sp, s == whole_from))
    return out


def _pick(view: torch.Tensor, axis: Optional[int], pos: List[int]):
    if axis is None:
        return view
    return view.index_select(axis, torch.as_tensor(pos, device=view.device))


def _put(view: torch.Tensor, axis: Optional[int], pos: List[int],
         part: torch.Tensor) -> None:
    if axis is None:
        view.copy_(part)
    else:
        view.index_copy_(axis, torch.as_tensor(pos, device=view.device),
                         part)


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
    for s, d, dp, sp, whole in _plan(dst, src):
        if me not in (s, d):
            continue
        moves = [(dv, sv, ax) for dv, sv, ax in items
                 if ax is not None or whole]
        if not any(ax is None or dp for _, _, ax in moves):
            continue
        if s == d:                       # held on this rank: a local copy
            for dv, sv, ax in moves:
                if ax is None or dp:
                    _put(dv, ax, dp, _pick(sv, ax, sp))
            continue
        if me == s:
            parts = [_pick(sv, ax, sp).contiguous().view(-1).view(torch.uint8)
                     for dv, sv, ax in moves if ax is None or dp]
            buf = torch.cat(parts)
        else:
            shapes = [(dv, ax, _shape(dv, ax, len(dp))) for dv, _, ax in moves
                      if ax is None or dp]
            n = sum(int(torch.Size(sh).numel()) * dv.element_size()
                    for dv, _, sh in shapes)
            buf = torch.empty((n,), dtype=torch.uint8, device=next(
                dv for dv, _, _ in moves).device)
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
            for dv, ax, sh in shapes:
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
