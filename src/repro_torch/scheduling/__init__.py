"""Backend-agnostic AcceLLM scheduling: one policy kernel, one live
executor on the port's engines.

A copy of the JAX package's ``repro.scheduling``, held against it by
``tests/test_torch_scheduling.py`` and ``tests/test_torch_cluster.py``
(equal decision traces, stats and tokens).

  views      — ClusterView / InstanceView protocols (state the policy sees)
  actions    — declarative actions the policy emits
  base       — the SchedulerPolicy interface
  accellm    — the paper's policy kernel (§4.1–§4.2)
  baselines  — vLLM / Sarathi / Splitwise kernels
  ulb        — the Universal Load Balancing kernel
  registry   — name -> policy factory for ``repro_torch.api``
  live       — executor over the port's InstanceEngines

Where the copies' comments speak of the simulator, they describe the JAX
package's second executor, which the port does not have yet.
"""
from repro_torch.scheduling.accellm import AcceLLMScheduler
from repro_torch.scheduling.actions import (Action, Decode, EvictReplica,
                                            MirrorSync, Prefill,
                                            PromoteReplica, StreamState)
from repro_torch.scheduling.base import MAX_PREFILL_BATCH, SchedulerPolicy
from repro_torch.scheduling.baselines import (SarathiScheduler,
                                              SplitwiseScheduler,
                                              VLLMScheduler)
from repro_torch.scheduling.live import LiveCluster, Placement
from repro_torch.scheduling.registry import (get_policy, policy_names,
                                             register_policy)
from repro_torch.scheduling.views import (ClusterView, InstanceView,
                                          RequestView)

__all__ = [
    "Action", "Prefill", "Decode", "StreamState", "MirrorSync",
    "PromoteReplica", "EvictReplica",
    "ClusterView", "InstanceView", "RequestView",
    "SchedulerPolicy", "MAX_PREFILL_BATCH",
    "AcceLLMScheduler", "VLLMScheduler", "SplitwiseScheduler",
    "SarathiScheduler",
    "LiveCluster", "Placement",
    "get_policy", "policy_names", "register_policy",
]
