"""Policy registry: name -> SchedulerPolicy factory.

A copy of the JAX package's registry.  ``repro_torch.api.serve`` resolves
``accellm|vllm|splitwise|sarathi|ulb`` here.  The four ``-vec`` names of
the JAX package need its vectorized scale layer; until the port's scale
slice lands they raise a ``KeyError`` that names it.
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, List

from repro_torch.scheduling.accellm import AcceLLMScheduler
from repro_torch.scheduling.base import SchedulerPolicy
from repro_torch.scheduling.baselines import (SarathiScheduler,
                                              SplitwiseScheduler,
                                              VLLMScheduler)
from repro_torch.scheduling.ulb import ULBScheduler

_REGISTRY: Dict[str, Callable[..., SchedulerPolicy]] = {}

#: the JAX package's vectorized variants (``repro.scale``); they wait for
#: the port's scale slice
SCALE_SLICE_POLICIES = ("accellm-vec", "vllm-vec", "splitwise-vec",
                        "ulb-vec")


def register_policy(name: str, factory: Callable[..., SchedulerPolicy]):
    if name in _REGISTRY:
        raise ValueError(f"policy {name!r} already registered")
    _REGISTRY[name] = factory


def get_policy(name: str, **kwargs) -> SchedulerPolicy:
    return policy_factory(name)(**kwargs)


def policy_factory(name: str) -> Callable[..., SchedulerPolicy]:
    if name in SCALE_SLICE_POLICIES:
        raise KeyError(f"policy {name!r} needs the vectorized scale layer, "
                       f"which waits for the scale slice of the port")
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

register_policy("ulb", ULBScheduler)
