"""Accelerator device models (paper Table 1 + the TPU of the JAX package).

A copy of the JAX package's ``repro.sim.devices``, held against it by
``tests/test_torch_sim.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class DeviceSpec:
    name: str
    fp16_tflops: float        # peak dense fp16/bf16
    hbm_gb: float
    hbm_bw_gbps: float        # GB/s
    link_gbps: float          # inter-device / inter-instance GB/s
    # achievable fractions (calibration knobs; defaults follow common MFU /
    # bandwidth-utilization figures for serving workloads)
    compute_eff: float = 0.55
    bw_eff: float = 0.80


# Paper Table 1
H100 = DeviceSpec("H100", fp16_tflops=989.0, hbm_gb=80.0,
                  hbm_bw_gbps=3350.0, link_gbps=900.0)
ASCEND_910B2 = DeviceSpec("910B2", fp16_tflops=400.0, hbm_gb=64.0,
                          hbm_bw_gbps=1800.0, link_gbps=392.0)
# The JAX package's deployment target (a device model, kept as the JAX
# package has it)
TPU_V5E = DeviceSpec("v5e", fp16_tflops=197.0, hbm_gb=16.0,
                     hbm_bw_gbps=819.0, link_gbps=50.0)

DEVICES = {d.name: d for d in (H100, ASCEND_910B2, TPU_V5E)}


@dataclass(frozen=True)
class InstanceSpec:
    """An AcceLLM instance: n accelerators under tensor parallelism
    (paper §4.2.3: 4 accelerators, TP=4, full model replica per instance)."""

    device: DeviceSpec
    n_devices: int = 4
    #: fixed host-side cost per decode *dispatch* (kernel launch + the
    #: host round-trip that reads the sampled tokens back), in seconds.
    #: A fused multi-step DecodePlan pays it once per plan, not per
    #: token — the amortization the live engine's ``decode_multi`` scan
    #: realizes.  0 keeps the seed cost model (pure roofline).
    dispatch_s: float = 0.0
    #: per-link bandwidths of the mesh slice backing this instance
    #: (mesh serving): *intra*-slice is the NVLink/ICI-class fabric
    #: the TP collectives ride; *inter*-slice is the network link that
    #: carries MirrorSync / StreamState traffic between instances.
    #: ``None`` falls back to the device's ``link_gbps`` for both, so
    #: the seed cost model is unchanged unless a spec says otherwise.
    #: This is the ONE home of link pricing — benchmarks and the sim
    #: must read bandwidths from here, never hardcode them.
    intra_link_gbps: Optional[float] = None
    inter_link_gbps: Optional[float] = None

    @property
    def tflops(self) -> float:
        return self.device.fp16_tflops * self.n_devices * self.device.compute_eff

    @property
    def hbm_bytes(self) -> float:
        return self.device.hbm_gb * 1e9 * self.n_devices

    @property
    def hbm_bw(self) -> float:
        return self.device.hbm_bw_gbps * 1e9 * self.n_devices * self.device.bw_eff

    @property
    def intra_link_bw(self) -> float:
        """Bytes/s across devices WITHIN this instance's mesh slice."""
        g = (self.intra_link_gbps if self.intra_link_gbps is not None
             else self.device.link_gbps)
        return g * 1e9

    @property
    def inter_link_bw(self) -> float:
        """Bytes/s between this instance's slice and another's."""
        g = (self.inter_link_gbps if self.inter_link_gbps is not None
             else self.device.link_gbps)
        return g * 1e9

    @property
    def link_bw(self) -> float:
        """Instance-to-instance bandwidth (mirror/stream traffic rides
        the inter-slice link)."""
        return self.inter_link_bw
