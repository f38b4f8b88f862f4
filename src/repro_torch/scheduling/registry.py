"""Policy registry: name -> SchedulerPolicy factory.

A copy of the JAX package's registry.  ``repro_torch.api.serve`` and the
launchers resolve ``--policy accellm|vllm|splitwise|sarathi|ulb`` here,
and the vectorized variants ``accellm-vec|vllm-vec|splitwise-vec|ulb-vec``
of ``repro_torch.scale``; registering a new policy makes it available to
both the live cluster and the simulator front-ends.
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, List

from repro_torch.scheduling.accellm import AcceLLMScheduler
from repro_torch.scheduling.base import SchedulerPolicy
from repro_torch.scheduling.baselines import (SarathiScheduler,
                                              SplitwiseScheduler,
                                              VLLMScheduler)

_REGISTRY: Dict[str, Callable[..., SchedulerPolicy]] = {}


def register_policy(name: str, factory: Callable[..., SchedulerPolicy]):
    if name in _REGISTRY:
        raise ValueError(f"policy {name!r} already registered")
    _REGISTRY[name] = factory


def get_policy(name: str, **kwargs) -> SchedulerPolicy:
    return policy_factory(name)(**kwargs)


def policy_factory(name: str) -> Callable[..., SchedulerPolicy]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown policy {name!r}; "
                       f"known: {', '.join(policy_names())}") from None


def policy_accepts(name: str, param: str) -> bool:
    """Whether the policy's factory takes a keyword named ``param``
    (used to forward optional spec fields like ``redundancy`` without
    special-casing policy names)."""
    try:
        sig = inspect.signature(policy_factory(name))
    except (TypeError, ValueError):
        return False
    p = sig.parameters.get(param)
    return (p is not None and p.kind in (p.POSITIONAL_OR_KEYWORD,
                                         p.KEYWORD_ONLY)) \
        or any(q.kind is q.VAR_KEYWORD for q in sig.parameters.values())


def policy_names() -> List[str]:
    return sorted(_REGISTRY)


register_policy("accellm", AcceLLMScheduler)
register_policy("vllm", VLLMScheduler)
register_policy("splitwise", SplitwiseScheduler)
register_policy("sarathi", SarathiScheduler)

# The ULB kernel and the vectorized variants (repro_torch.scale) are
# imported at the bottom so the base names above are registered even while
# those modules are mid-import (scale.kernels itself imports this package).
from repro_torch.scheduling.ulb import ULBScheduler  # noqa: E402
from repro_torch.scale.kernels import (  # noqa: E402
    VectorAcceLLMScheduler, VectorSplitwiseScheduler, VectorULBScheduler,
    VectorVLLMScheduler)

register_policy("ulb", ULBScheduler)
register_policy("accellm-vec", VectorAcceLLMScheduler)
register_policy("vllm-vec", VectorVLLMScheduler)
register_policy("splitwise-vec", VectorSplitwiseScheduler)
register_policy("ulb-vec", VectorULBScheduler)
