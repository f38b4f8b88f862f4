"""MeshPlacement: the pod layout a LiveCluster serves on.

Couples the carved :class:`repro_torch.meshserve.topology.MeshSlice`s with
the per-instance :class:`repro_torch.sim.devices.InstanceSpec`s that price
them: ONE object answers both "which ranks run instance i" (live backend)
and "what hardware is instance i" (the spec the policy views expose and
the simulator prices with).  Heterogeneous pods (the paper's H100 vs
Ascend 910B2 eval) are specs of different widths: each instance's slice
takes ``spec.n_devices`` ranks of the world.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from repro_torch.core.device import Device
from repro_torch.meshserve.topology import MeshSlice, carve_slices
from repro_torch.sim.devices import H100, InstanceSpec


@dataclass(frozen=True)
class MeshPlacement:
    slices: Tuple[MeshSlice, ...]
    specs: Tuple[InstanceSpec, ...]

    def __post_init__(self):
        if len(self.slices) != len(self.specs):
            raise ValueError(
                f"{len(self.slices)} slices vs {len(self.specs)} specs")

    @property
    def n_instances(self) -> int:
        return len(self.slices)

    def slice_for(self, idx: int) -> Optional[MeshSlice]:
        """Instance ``idx``'s slice; ``None`` past the carved pod (an
        autoscaled join lands unsharded: every rank builds it whole)."""
        return self.slices[idx] if idx < len(self.slices) else None

    def spec_for(self, idx: int) -> Optional[InstanceSpec]:
        return self.specs[idx] if idx < len(self.specs) else None

    @classmethod
    def carve(cls, n_instances: int, tp: int = 1, *,
              specs: Optional[Sequence[InstanceSpec]] = None,
              world: Optional[int] = None,
              device: Device = "cuda") -> "MeshPlacement":
        """Carve the world into ``n_instances`` slices.  With ``specs``
        each instance's width is its spec's ``n_devices`` (heterogeneous
        pods); otherwise every slice is ``tp`` wide and priced as an
        H100-class instance of that width."""
        if specs is not None:
            specs = tuple(specs)
            if len(specs) != n_instances:
                raise ValueError(
                    f"{len(specs)} specs for {n_instances} instances")
            widths = [s.n_devices for s in specs]
        else:
            widths = [tp] * n_instances
            specs = tuple(InstanceSpec(H100, n_devices=tp)
                          for _ in range(n_instances))
        return cls(slices=carve_slices(widths, world=world, device=device),
                   specs=specs)
