"""The production mesh as a plain description.

The JAX package builds a ``jax.sharding.Mesh`` over forced host devices;
the port has no single-controller mesh object, and its dry run only
needs the mesh's axis names and sizes to divide each leaf's bytes.  So
``make_production_mesh`` returns a :class:`ProductionMesh`, which touches
no device and starts no process group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class ProductionMesh:
    """Axis names and sizes; ``shape`` maps each name to its size, as a
    JAX ``Mesh``'s does."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n

    @property
    def tag(self) -> str:
        """``16x16`` or ``2x16x16``, the dry-run records' ``mesh``."""
        return "x".join(str(s) for s in self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    """Single pod: (data=16, model=16) = 256 chips.
    Multi-pod: (pod=2, data=16, model=16) = 512 chips."""
    if multi_pod:
        return ProductionMesh(("pod", "data", "model"), (2, 16, 16))
    return ProductionMesh(("data", "model"), (16, 16))


def batch_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)
