"""Discrete-event cluster simulator of the port: the paper's evaluation
method (§5.1), pricing every step plan with an analytic model of the
device (``H100``, ``ASCEND_910B2`` and ``TPU_V5E`` are device models,
not measurements).  A copy of the JAX package's ``repro.sim``, held
against it by ``tests/test_torch_sim.py``; host-only (Python and numpy).

The prefix cache (``Simulator(prefix_cache=True)``) and the array-backed
cluster state of vectorized kernels wait for their slices of the port
and raise ``NotImplementedError``.
"""
from repro_torch.sim.cluster import Policy, SimInstance, Simulator
from repro_torch.sim.devices import (ASCEND_910B2, DEVICES, H100, TPU_V5E,
                                     InstanceSpec)
from repro_torch.sim.metrics import Summary, summarize
from repro_torch.sim.perf import PerfModel
from repro_torch.sim.policies import (AcceLLMPolicy, SarathiPolicy,
                                      SplitwisePolicy, ULBPolicy, VLLMPolicy)
from repro_torch.sim.workload import WORKLOADS, SimRequest, make_workload

__all__ = [
    "Simulator", "SimInstance", "Policy", "PerfModel", "InstanceSpec",
    "H100", "ASCEND_910B2", "TPU_V5E", "DEVICES", "Summary", "summarize",
    "AcceLLMPolicy", "SarathiPolicy", "SplitwisePolicy", "ULBPolicy",
    "VLLMPolicy", "WORKLOADS",
    "SimRequest", "make_workload",
]
