"""Scale layer: array-backed scheduler state + vectorized policy kernels.

  state    — ArrayClusterState: numpy struct-of-arrays over the sim's
             request/instance accounting, kept coherent by observing
             container wrappers; serves the ClusterView/InstanceView
             protocols so every kernel runs unchanged
  kernels  — accellm-vec / vllm-vec / splitwise-vec / ulb-vec: the hot
             route/pair/rebalance loops as argmin/argmax over instance
             arrays, bit-identical to their scalar kernels

Imports are lazy (PEP 562): ``repro_torch.scheduling.registry`` pulls
``kernels`` in at its bottom to self-register the vectorized names, and
``kernels`` imports scheduling submodules — a top-level import here
would close that loop while either side is still initializing.

A copy of the JAX package's ``repro.scale`` (host-only: Python and numpy).
"""
from __future__ import annotations

_EXPORTS = {
    "ArrayClusterState": "repro_torch.scale.state",
    "ArrayClusterView": "repro_torch.scale.state",
    "ArrayInstanceView": "repro_torch.scale.state",
    "VectorAcceLLMScheduler": "repro_torch.scale.kernels",
    "VectorVLLMScheduler": "repro_torch.scale.kernels",
    "VectorSplitwiseScheduler": "repro_torch.scale.kernels",
    "VectorULBScheduler": "repro_torch.scale.kernels",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
