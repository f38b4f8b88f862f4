"""The backend-agnostic scheduling policy interface.

A ``SchedulerPolicy`` is the single home of a serving system's *decisions*
— routing, role selection, post-prefill placement, rebalancing, eviction —
expressed over :mod:`repro_torch.scheduling.views` and emitted as declarative
:mod:`repro_torch.scheduling.actions`.  Executors supply the mechanics:

  * ``repro_torch.scheduling.live.LiveCluster`` drives real ``InstanceEngine``s
    on the iteration clock,
  * the adapters in ``repro.sim.policies`` drive the discrete-event
    simulator with its analytic cost model.

Adding a new policy = subclassing this in one file; it then runs on both
backends and is selectable by name through ``repro_torch.scheduling.registry``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.scheduling.actions import Action
from repro_torch.scheduling.views import ClusterView, InstanceView, RequestView

#: Shared admission cap: max prompts batched into one prefill iteration.
MAX_PREFILL_BATCH = 4

# Roles an instance can take for one scheduling iteration.
ROLE_PREFILL = "prefill"   # exclusive prefill (never co-batched with decode)
ROLE_DECODE = "decode"
ROLE_MIXED = "mixed"       # vLLM-style prefill+decode co-batching
ROLE_IDLE = "idle"


class SchedulerPolicy:
    name = "base"
    #: Policy requires the AcceLLM pair structure (even instance count).
    requires_pairs = False
    #: Live executor: return unplaced requests to the global queue each
    #: iteration (policies that re-route every step) instead of leaving
    #: them in the per-instance backlog.
    requeue_unplaced = False
    #: May prefill and decode be co-scheduled on one instance in one
    #: iteration?  The step planner (repro_torch.stepplan) enforces this: with
    #: ``False`` it raises instead of building a MixedPlan — the home of
    #: the AcceLLM §4.2.3 invariant.
    allow_mixed = True
    #: Per-iteration prompt-token budget for chunked prefill
    #: (Sarathi-style); ``None`` disables chunking.  Consumed by the
    #: step planner, which keeps the resumable chunk cursors.
    chunk_tokens: Optional[int] = None
    #: optional decision log (golden-trace consistency tests; the
    #: vectorized-kernel equivalence proof in tests/test_scale.py).
    #: Assign a list to start recording.
    trace: Optional[list] = None

    def _note(self, *entry):
        if self.trace is not None:
            self.trace.append(entry)

    # -- routing ------------------------------------------------------------
    def admissions_per_step(self, cluster: ClusterView) -> int:
        """How many queued requests the live executor may route per
        iteration."""
        return len(cluster.instances())

    def route(self, cluster: ClusterView, req: RequestView) -> Optional[int]:
        """Target instance index for a new request, or None to keep it
        queued."""
        raise NotImplementedError

    # -- roles --------------------------------------------------------------
    def choose_roles(self, cluster: ClusterView, instance: int) -> str:
        """Role of ``instance`` for this iteration."""
        inst = cluster.instances()[instance]
        if inst.prefill_backlog():
            return ROLE_MIXED
        return ROLE_DECODE if inst.decode_load() else ROLE_IDLE

    def prefill_batch(self, cluster: ClusterView, instance: int,
                      pending: Sequence[RequestView]) -> int:
        """How many of ``pending`` (FIFO) to prefill this iteration."""
        inst = cluster.instances()[instance]
        n = 0
        for req in pending:
            if n >= MAX_PREFILL_BATCH or not inst.can_admit(req, taking=n):
                break
            n += 1
        return n

    # -- placement / redundancy --------------------------------------------
    def place_after_prefill(self, cluster: ClusterView, instance: int,
                            req: RequestView) -> List[Action]:
        """Where the freshly prefilled ``req`` should live (StreamState
        actions); empty means it stays on the prefilling instance."""
        return []

    def sync(self, cluster: ClusterView) -> List[Action]:
        """Per-iteration replica maintenance (MirrorSync actions)."""
        return []

    # -- fleet events -------------------------------------------------------
    def warm_on_join(self, cluster: ClusterView, instance: int
                     ) -> List[Action]:
        """Warm a freshly joined ``instance`` before new arrivals route
        to it (StreamState actions — e.g. re-establishing replicas of
        resident requests).  Baselines have nothing to warm with."""
        return []

    # -- balancing / memory pressure ---------------------------------------
    def rebalance(self, cluster: ClusterView, pair_index: int
                  ) -> List[Action]:
        """Re-split a pair's decode work (PromoteReplica actions,
        preceded by catch-up MirrorSyncs for any lagging replica)."""
        return []

    def evict(self, cluster: ClusterView,
              instances: Sequence[InstanceView], need: int = 1
              ) -> List[Action]:
        """Free memory on ``instances`` (EvictReplica actions)."""
        return []
