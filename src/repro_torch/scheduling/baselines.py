"""Baseline scheduling kernels from the paper's evaluation (§5.2) and
related work (§2), expressed over the shared policy API so they run on
both the live-engine executor and the simulator.

  VLLMScheduler      — independent instances, continuous batching that
                       co-schedules prefill with decode (the TBT spike of
                       paper Fig. 5 / 16).
  SarathiScheduler   — chunked prefill: bounded prompt tokens per
                       iteration, trading TTFT for TBT.
  SplitwiseScheduler — static disaggregation: dedicated prefill
                       instances; post-prefill KV transfer to a decode
                       instance is on the critical path (Fig. 1 Case B).
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.scheduling.actions import Action, StreamState
from repro_torch.scheduling.base import (ROLE_DECODE, ROLE_IDLE, ROLE_PREFILL,
                                         SchedulerPolicy)
from repro_torch.scheduling.views import ClusterView, RequestView, usable


class VLLMScheduler(SchedulerPolicy):
    name = "vllm"

    def route(self, cluster: ClusterView, req: RequestView) -> Optional[int]:
        # dead/draining instances never take new work (repro.fleet)
        insts = [v for v in cluster.instances() if usable(v)]
        ok = [v for v in insts if v.can_admit(req)]
        pool = ok or [v for v in insts if v.can_queue()] or insts
        if not pool:
            return None
        # least loaded instance with memory headroom
        target = min(pool, key=lambda v: (v.decode_load()
                                          + v.prefill_backlog(),
                                          v.index)).index
        self._note("route", req.rid, target)
        return target


class SarathiScheduler(VLLMScheduler):
    """Chunked prefill: the kernel only declares the per-iteration
    prompt-token budget (``chunk_tokens``); the step planner
    (:mod:`repro_torch.stepplan`) spends it — splitting prompts into resumable
    chunks co-scheduled with decode — identically on both backends, so
    a prompt longer than the budget actually chunks on real hardware
    instead of banking admission credit."""
    name = "sarathi"

    def __init__(self, chunk_tokens: int = 512):
        self.chunk_tokens = chunk_tokens


class SplitwiseScheduler(SchedulerPolicy):
    name = "splitwise"
    #: static disaggregation never co-schedules phases on one instance
    allow_mixed = False

    def __init__(self, n_prefill: int = 1):
        self.n_prefill = n_prefill

    def route(self, cluster: ClusterView, req: RequestView) -> Optional[int]:
        prefillers = [v for v in cluster.instances()[: self.n_prefill]
                      if usable(v)]
        if not prefillers:
            return None          # every prefill instance is down/cordoned
        target = min(prefillers,
                     key=lambda v: (v.prefill_backlog_tokens(),
                                    v.index)).index
        self._note("route", req.rid, target)
        return target

    def choose_roles(self, cluster: ClusterView, instance: int) -> str:
        inst = cluster.instances()[instance]
        if instance < self.n_prefill:
            return ROLE_PREFILL if inst.prefill_backlog() else ROLE_IDLE
        return ROLE_DECODE if inst.decode_load() else ROLE_IDLE

    def choose_decode_target(self, cluster: ClusterView, req: RequestView
                             ) -> Optional[int]:
        decoders = [v for v in cluster.instances()[self.n_prefill:]
                    if usable(v)]
        if not decoders:
            return None          # decode tier down: stay on the prefiller
        # least-loaded decoder, memory headroom as the tiebreaker
        target = min(decoders,
                     key=lambda v: (v.decode_load() - v.mem_free() * 1e-18,
                                    v.index)).index
        self._note("target", req.rid, target)
        return target

    def place_after_prefill(self, cluster: ClusterView, instance: int,
                            req: RequestView) -> List[Action]:
        dst = self.choose_decode_target(cluster, req)
        if dst is None or dst == instance:
            return []
        # whole-state KV transfer on the request's critical path
        return [StreamState(req.rid, src=instance, dst=dst)]
