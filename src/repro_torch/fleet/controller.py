"""Fleet controller: one failover/scale decision layer, two executors.

The controller owns everything about a fleet event that is *not*
backend mechanics: pacing the schedule against the executor's clock
(:meth:`FleetController.due`), deciding which of a dead instance's
requests survive (:meth:`plan_failover`), and keeping the decision
trace + counters both backends must agree on (golden-trace fleet
tests compare ``controller.trace`` entry for entry, the same contract
``AcceLLMScheduler.trace`` carries for scheduling decisions).

The failover contract:

  * a resident primary whose replica lives on a usable instance is
    **promoted** there — the AcceLLM payoff: the warm copy becomes the
    primary via the existing ``PromoteReplica`` role-flip machinery,
    paying only the unsynced tail (``Promotion.lost_lines`` decode
    tokens are rolled back and re-generated, never the prompt);
  * a resident primary with no usable replica is **re-queued**: its
    lifecycle resets to ``QUEUED`` and the whole prompt re-prefills —
    what every baseline kernel pays for each resident request;
  * replicas *of other instances' primaries* hosted on the dead
    instance are dropped (the primary survives unmirrored until the
    kernel re-establishes redundancy).

Re-queued requests keep their original ``arrival`` stamp, so the
re-prefill shows up as the TTFT/SLO damage it really is, and they are
never re-submitted — each rid stays single-counted in
``sim.metrics.summarize`` / ``workloads.metrics.slo_summary``.

A copy of the JAX package's ``repro.fleet.controller``, held against it by
``tests/test_torch_fleet.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from repro_torch.fleet.events import FleetEvent, FleetSchedule
from repro_torch.serving.request import Phase


@dataclass(frozen=True)
class Promotion:
    """Promote the replica of ``rid`` (on ``dst``) to primary after
    ``src`` died; the replica was synced to ``synced`` of the primary's
    ``lines``."""
    rid: int
    src: int
    dst: int
    synced: int
    lines: int

    @property
    def lost_lines(self) -> int:
        """Decode tokens beyond the replica's synced mark — rolled back
        and re-generated on the promoted copy."""
        return max(0, self.lines - self.synced)


@dataclass
class FailoverPlan:
    """What survives instance ``dead``: deterministic (rid-sorted), so
    both executors apply the identical plan in the identical order."""
    dead: int
    promotions: List[Promotion] = field(default_factory=list)
    requeues: List[int] = field(default_factory=list)
    dropped_replicas: List[int] = field(default_factory=list)


class FleetController:
    """Paces a :class:`FleetSchedule` against an executor's clock and
    records the fleet decisions both backends must share."""

    STATS = ("kills", "joins", "drains", "promotions", "requeues",
             "requeue_backlog", "reprefill_tokens", "lost_lines",
             "lost_decode_tokens", "warm_streams",
             "degrades", "recoveries", "hedges", "sheds", "aborts")

    def __init__(self, schedule: Optional[FleetSchedule] = None,
                 seed: int = 0):
        self.schedule = schedule
        self.events: List[FleetEvent] = (
            schedule.stream(seed) if schedule is not None else [])
        self._next = 0
        #: decision log, compared entry-for-entry live-vs-sim
        self.trace: List[tuple] = []
        self.stats = {k: 0 for k in self.STATS}

    def note(self, *entry):
        self.trace.append(entry)

    def due(self, now: float) -> List[FleetEvent]:
        """Events whose time has come on the caller's clock (consumed —
        each event fires exactly once)."""
        out: List[FleetEvent] = []
        while self._next < len(self.events) \
                and self.events[self._next].t <= now:
            out.append(self.events[self._next])
            self._next += 1
        return out

    def exhausted(self) -> bool:
        return self._next >= len(self.events)

    def drain_all(self) -> List[FleetEvent]:
        """Hand the whole remaining stream to an event-heap executor
        (the simulator schedules fleet events as heap entries instead of
        polling :meth:`due` each iteration); marks them consumed."""
        out = self.events[self._next:]
        self._next = len(self.events)
        return out

    def next_time(self) -> Optional[float]:
        """Time of the next unfired event (None when exhausted) — the
        executors' fused-decode bound: a multi-iteration scan must not
        run past a fleet event."""
        if self._next >= len(self.events):
            return None
        return self.events[self._next].t

    # -- the shared failover decision ---------------------------------------
    def plan_failover(self, cluster_view, dead: int) -> FailoverPlan:
        """Split instance ``dead``'s resident requests into promotions
        (usable replica exists) and re-queues (state truly lost), from
        the same :class:`~repro_torch.scheduling.views.ClusterView` protocol
        the scheduling kernels read — so live engines and the simulator
        produce the identical plan."""
        insts = cluster_view.instances()
        plan = FailoverPlan(dead=dead)
        dead_lines = insts[dead].request_lines()
        synced_of: dict = {}
        for rid, (primary, replica) in sorted(
                cluster_view.placements().items()):
            if primary == dead:
                target = None
                if replica is not None and replica != dead:
                    rv = insts[replica]
                    if rv.alive() and not rv.draining():
                        target = replica
                if target is None:
                    plan.requeues.append(rid)
                    continue
                if target not in synced_of:
                    synced_of[target] = insts[target].replica_synced()
                lines = dead_lines.get(rid, 0)
                plan.promotions.append(Promotion(
                    rid=rid, src=dead, dst=target,
                    synced=synced_of[target].get(rid, 0), lines=lines))
            elif replica == dead:
                plan.dropped_replicas.append(rid)
        return plan


# ---------------------------------------------------------------------------
# request lifecycle helpers shared by both executors
# ---------------------------------------------------------------------------


def reset_for_reprefill(req) -> int:
    """Roll a request all the way back to un-prefilled (its state died
    with its instance); returns the prompt tokens that must re-run.
    The original ``arrival`` stamp is kept on purpose: the re-prefill
    is TTFT/SLO damage, not a fresh request."""
    req.phase = Phase.QUEUED
    req.generated = 0
    req.output_tokens.clear()
    req.token_times.clear()
    req.first_token_time = None
    return req.prompt_len


def rollback_tokens(req, lost: int):
    """Roll a promoted request back to its replica's synced line: the
    last ``lost`` decode tokens were never mirrored and re-generate on
    the promoted copy."""
    if lost <= 0:
        return
    req.generated = max(0, req.generated - lost)
    del req.output_tokens[len(req.output_tokens) - min(
        lost, len(req.output_tokens)):]
    del req.token_times[len(req.token_times) - min(
        lost, len(req.token_times)):]
