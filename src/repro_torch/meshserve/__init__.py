"""Mesh serving: tensor-parallel instances on ``torch.distributed``, with
the redundancy bytes moved between their slices by collectives.

One pod of instances becomes one world of ranks, one process each (one
per card): :func:`carve_slices` cuts the ranks into per-instance TP
slices, :func:`shard_params` / :func:`shard_store` give each rank its part
of an engine's replica and KV pool, and the :mod:`collectives` move
mirror and stream bytes between slices (counted by :data:`STATS`).
:class:`MeshPlacement` bundles the slices with the heterogeneous
``InstanceSpec``s that price them on both backends, and
:func:`repro_torch.meshserve.world.spawn` starts a world.
"""
from repro_torch.meshserve.collectives import (STATS, TransferStats,
                                               same_devices)
from repro_torch.meshserve.placement import MeshPlacement
from repro_torch.meshserve.pool import shard_params, shard_store
from repro_torch.meshserve.topology import MeshError, MeshSlice, carve_slices

__all__ = [
    "MeshError", "MeshPlacement", "MeshSlice", "STATS", "TransferStats",
    "carve_slices", "same_devices", "shard_params", "shard_store",
]
