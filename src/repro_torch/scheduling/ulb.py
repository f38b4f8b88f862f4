"""Universal Load Balancing (ULB) scheduling kernel.

The Universal Load Balancing principle (PAPERS.md): route every new
request to the server with the least *outstanding work*, where work is
measured in the system's actual service units — not the queue length or
the resident count, both of which mispredict completion time when
requests are heterogeneous.  For LLM serving the natural unit is the
token: an instance's outstanding work is

    prefill_backlog_tokens  +  Σ decode_remaining

i.e. every prompt token still to prefill plus every token its resident
decodes have yet to generate.  This prices a queue of short prompts
below one long prompt and a batch of nearly-finished decodes below a
batch of fresh ones — exactly the distinctions ``decode_load() +
prefill_backlog()`` (vLLM-style least-connections) cannot make.

The kernel is deliberately minimal: no pairs, no redundancy, no KV
movement — the same execution mechanics as vLLM continuous batching,
differing *only* in the routing score, so the AcceLLM-vs-ULB shootout
(benchmarks/bench_scale.py) isolates the value of the routing signal
itself.  ``decode_remaining`` uses declared ``max_new_tokens`` as the
work estimate; real deployments would substitute a length predictor —
the principle is the same with any unbiased estimate.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.scheduling.base import SchedulerPolicy
from repro_torch.scheduling.views import (ClusterView, InstanceView,
                                          RequestView, usable)


def outstanding_tokens(view: InstanceView) -> int:
    """The ULB work score: prompt tokens still to prefill + decode
    tokens still to generate on ``view``."""
    return (view.prefill_backlog_tokens()
            + sum(view.decode_remaining().values()))


class ULBScheduler(SchedulerPolicy):
    name = "ulb"

    def route(self, cluster: ClusterView, req: RequestView) -> Optional[int]:
        insts = [v for v in cluster.instances() if usable(v)]
        ok = [v for v in insts if v.can_admit(req)]
        pool = ok or [v for v in insts if v.can_queue()] or insts
        if not pool:
            return None
        # least outstanding work in tokens; index breaks ties for
        # determinism across backends
        target = min(pool, key=lambda v: (outstanding_tokens(v),
                                          v.index)).index
        self._note("route", req.rid, target)
        return target
