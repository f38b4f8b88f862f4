"""Discrete-event cluster simulator (paper §5.1).

Instances execute *step plans* (:mod:`repro_torch.stepplan`): a policy
adapter compiles each iteration's scheduling actions into the same plan objects
the live executor runs, and the event loop prices every one through the
single cost entry point ``PerfModel.plan_time(plan)``.  The event loop
keeps a heap of (time, event); a ``Policy`` decides routing, batching,
KV movement and balancing — adapters in ``repro_torch.sim.policies``
reproduce the paper's systems (AcceLLM / Splitwise / vLLM / Sarathi).

A copy of the JAX package's ``repro.sim.cluster``, held against it by
``tests/test_torch_sim.py``.
"""
from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.kvstore import SimStore
from repro_torch.scheduling.views import step_health
from repro_torch.serving.request import Phase
from repro_torch.sim.perf import PerfModel
from repro_torch.sim.workload import SimRequest
from repro_torch.stepplan import (DecodePlan, MixedPlan, PrefillPlan, StepPlan,
                                  decode_part, prefill_part)
from repro_torch.workloads import ModeledSecondsClock, TimelinePoint
from repro_torch.workloads.spec import RequestSource

@dataclass
class SimInstance:
    iid: int
    perf: PerfModel
    max_batch: int
    block_lines: int = 16
    decode_batch: Dict[int, SimRequest] = field(default_factory=dict)
    replicas: Dict[int, SimRequest] = field(default_factory=dict)
    prefill_queue: List[SimRequest] = field(default_factory=list)
    busy: bool = False
    #: fleet state (repro_torch.fleet): dead instances stay in the list so
    #: indices remain stable; ``epoch`` bumps on kill so in-flight
    #: ``inst_done`` events from a previous life are ignored
    alive: bool = True
    draining: bool = False
    epoch: int = 0
    #: partial failure (repro_torch.fleet.DegradeInstance): compute iterations
    #: on this instance are priced ``degrade_factor`` x slow and its
    #: transfers ``link_degrade`` x slow until a RecoverInstance lands
    degrade_factor: float = 1.0
    link_degrade: float = 1.0
    #: health EWMA the scheduling views expose (1.0 = nominal) — the
    #: same ``step_health`` arithmetic the live executor runs
    health: float = 1.0
    #: sparse replica lag marks: rid -> synced line.  The sim prices the
    #: mirror inside the decode step, so replicas are current (and
    #: absent from this dict) unless a fleet event or an injected lag
    #: says otherwise; ``replica_synced`` falls back to ``total_len``.
    synced_marks: Dict[int, int] = field(default_factory=dict)
    # peak memory tracking (paper Fig. 9)
    peak_state_bytes: float = 0.0
    busy_time: float = 0.0
    # current running iteration: (StepPlan, decode-batch snapshot,
    # start time)
    _running: Optional[Tuple[StepPlan, tuple, float]] = None
    #: block-table accounting ledger (repro_torch.kvstore) — the same
    #: arithmetic the live PagedStore runs; (re)built in __post_init__
    store: Optional[SimStore] = None

    def __post_init__(self):
        if self.store is None:
            self.store = SimStore(self.perf.line_costs,
                                  self.perf.kv_capacity_bytes,
                                  block_lines=self.block_lines)

    def synced_store(self) -> SimStore:
        """The ledger, reconciled to the current resident sets.  The
        simulator mutates ``decode_batch``/``replicas`` at event
        granularity (and consistency tests drive them directly), so
        membership and line counts are re-derived on read; the byte and
        block arithmetic is the shared ``BlockLedger``'s."""
        resident = {rid: r.total_len for rid, r in self.decode_batch.items()}
        for rid, r in self.replicas.items():
            resident.setdefault(rid, r.total_len)
        return self.store.reconcile(resident)

    def state_bytes(self) -> float:
        # direct line-exact sum (== the ledger's used_bytes, same
        # LineCosts): byte reads are hot (note_peak per event, can_admit
        # per routing decision) and need no ledger reconcile
        costs = self.store.costs
        return (sum(costs.bytes_at(r.total_len)
                    for r in self.decode_batch.values())
                + sum(costs.bytes_at(r.total_len)
                      for r in self.replicas.values()))

    def mem_free(self) -> float:
        return self.perf.kv_capacity_bytes - self.state_bytes()

    def free_blocks(self) -> int:
        return self.synced_store().free_blocks()

    def note_peak(self):
        self.peak_state_bytes = max(self.peak_state_bytes, self.state_bytes())


class Policy:
    """Hooks the simulator calls; see repro_torch.sim.policies."""

    name = "base"

    def bind(self, sim: "Simulator"):
        self.sim = sim

    def route(self, req: SimRequest) -> Optional[SimInstance]:
        raise NotImplementedError

    def next_plan(self, inst: SimInstance) -> Optional[StepPlan]:
        """The instance's next iteration as a step plan (or None to
        idle).  The event loop prices it via ``perf.plan_time``."""
        raise NotImplementedError

    def on_prefill_done(self, inst: SimInstance, reqs: List[SimRequest]):
        raise NotImplementedError

    def on_decode_done(self, inst: SimInstance,
                       finished: List[SimRequest]):
        """Called after each decode iteration with the requests that
        finished in it (explicitly, so policies can release per-request
        resources without scanning global history)."""
        pass

    def on_fleet_event(self, ev, ctrl):
        """Apply a :mod:`repro_torch.fleet` event (kill / join / drain /
        degrade / recover).  ``ctrl`` is the run's ``FleetController`` —
        the policy applies the controller's failover plan to its own
        bookkeeping."""
        raise NotImplementedError(
            f"policy {self.name} has no fleet support")

    def abort_request(self, rid: int) -> Optional[SimRequest]:
        """Tear down every trace of ``rid`` (queue entry, decode
        residency, replica, planner cursor); returns the
        request record if it was found, None otherwise."""
        raise NotImplementedError(
            f"policy {self.name} has no abort support")

    def shed_overdue(self, inst: SimInstance, now: float,
                     deadline: float) -> List[SimRequest]:
        """Remove (and return) backlogged requests on ``inst`` whose
        queue wait already exceeds ``deadline`` — deadline-aware
        admission shedding.  Only not-yet-started requests may shed."""
        return []

    def settle_drains(self, ctrl):
        """Retire draining instances whose residents have completed
        (called by the event loop after each event when a fleet is
        active)."""
        pass


class Simulator:
    def __init__(self, policy: Policy, perf, n_instances: int,
                 max_batch: int = 64, block_lines: int = 16,
                 prefix_cache: bool = False,
                 timeline_stride: int = 1,
                 max_queue: Optional[int] = None,
                 shed_deadline: Optional[float] = None):
        if prefix_cache:
            raise NotImplementedError(
                "the prefix cache waits for the prefix-cache slice of the "
                "port")
        # ``perf`` is one PerfModel for a homogeneous pod, or a sequence
        # of n_instances models for a heterogeneous one (e.g. H100-class
        # and 910B2-class slices scheduled by the same kernel)
        if isinstance(perf, (list, tuple)):
            if len(perf) != n_instances:
                raise ValueError(
                    f"{len(perf)} perf models for {n_instances} instances")
            perfs = list(perf)
        else:
            perfs = [perf] * n_instances
        # default model: fleet joins past the pod land on this hardware
        self.perf = perfs[0] if perfs else perf
        # remembered so fleet joins build replacement instances with the
        # original shape (mirrors LiveCluster._engine_kwargs)
        self.max_batch = max_batch
        self.block_lines = block_lines
        self.fleet = None            # FleetController of the active run
        self.instances = [SimInstance(i, perfs[i], max_batch, block_lines)
                          for i in range(n_instances)]
        self.policy = policy
        policy.bind(self)
        self.clock = ModeledSecondsClock()
        self._heap: List[tuple] = []
        #: pending arrival times (min-heap), maintained incrementally so
        #: fused-decode horizon checks never rescan the event heap
        self._arrivals: List[float] = []
        self._seq = itertools.count()
        self._kicking: set = set()   # re-entrancy guard for kick()
        self.finished: List[SimRequest] = []
        self.dropped: List[SimRequest] = []
        self.submitted: List[SimRequest] = []   # every request offered
        # admission control: a bounded cluster-wide backlog plus
        # deadline-aware shedding (a request whose queue wait already
        # blew the TTFT budget is rejected, not served late)
        self.max_queue = max_queue
        self.shed_deadline = shed_deadline
        self.shed: List[SimRequest] = []        # admission-control rejects
        self.aborted: List[SimRequest] = []     # cancelled mid-flight
        self.timeline: List[TimelinePoint] = []
        #: sample the timeline every N events (1 = every event).  At
        #: 10^6-request scale a per-event list OOMs the report; metrics
        #: that read the timeline interpolate across the stride.
        self.timeline_stride = max(1, timeline_stride)
        self._ticks = 0
        # wall-clock spent inside the scheduling policy (routing, plan
        # compilation, completion hooks) — the scheduler-μs/iteration
        # metric.  A depth counter keeps nested calls (kick() re-entered
        # from inside next_plan via decode handoffs) from double-counting.
        self.sched_time_s = 0.0
        self.n_iterations = 0
        self._sched_depth = 0
        self._sched_t0 = 0.0
        # closed-loop pump (set by run() when the source demands it)
        self._pump: Optional[Iterator] = None
        self._pump_target = 0
        self._pump_issued = 0

    @property
    def now(self) -> float:
        return self.clock.now

    @now.setter
    def now(self, t: float):
        self.clock.now = t

    @property
    def sched_us_per_iter(self) -> float:
        """Mean scheduler wall-μs per completed instance iteration."""
        return self.sched_time_s * 1e6 / max(1, self.n_iterations)

    # -- scheduler timing ---------------------------------------------------------
    def _sched_begin(self):
        self._sched_depth += 1
        if self._sched_depth == 1:
            self._sched_t0 = time.perf_counter()

    def _sched_end(self):
        self._sched_depth -= 1
        if self._sched_depth == 0:
            self.sched_time_s += time.perf_counter() - self._sched_t0

    # -- event helpers ---------------------------------------------------------
    def push(self, time: float, kind: str, data=None):
        heapq.heappush(self._heap, (time, next(self._seq), kind, data))
        if kind == "arrival":
            heapq.heappush(self._arrivals, time)

    def next_arrival(self) -> Optional[float]:
        """Earliest arrival still strictly in the future (None if no
        arrival is pending) — the fused-decode span bound."""
        while self._arrivals and self._arrivals[0] < self.now:
            heapq.heappop(self._arrivals)
        return self._arrivals[0] if self._arrivals else None

    def kick(self, inst: SimInstance):
        """Start the next iteration on an idle instance."""
        if inst.busy or not inst.alive:
            return
        if inst.iid in self._kicking:
            return
        self._kicking.add(inst.iid)
        self._sched_begin()
        try:
            if self.shed_deadline is not None and inst.prefill_queue:
                for r in self.policy.shed_overdue(inst, self.now,
                                                  self.shed_deadline):
                    self._shed(r)
            plan = self.policy.next_plan(inst)
        finally:
            self._sched_end()
            self._kicking.discard(inst.iid)
        if plan is None:
            # an idle kick still observes the instance: health keeps
            # converging toward the current degrade factor, so a fully
            # hedged-away straggler that later recovers decays back
            # under the hedge threshold (the live executor updates
            # every alive instance once per step; events are the sim's
            # step boundary) instead of freezing sick and suppressing
            # its pair's rebalance forever
            inst.health = step_health(inst.health, inst.degrade_factor)
            return
        # ONE cost entry point for every iteration shape: the plan the
        # adapter compiled is priced as-is, on the hardware of the
        # instance that runs it.  A degraded instance
        # (repro_torch.fleet.DegradeInstance) runs the identical plan
        # degrade_factor x slow, and its health EWMA tracks the slowdown
        # one iteration at a time — the signal hedging kernels read.
        dur = inst.perf.plan_time(plan)
        if inst.degrade_factor != 1.0:
            dur *= inst.degrade_factor
        inst.health = step_health(inst.health, inst.degrade_factor)
        inst.busy = True
        inst.busy_time += dur
        inst._running = (plan, tuple(inst.decode_batch), self.now)
        self.push(self.now + dur, "inst_done", (inst.iid, inst.epoch))

    # -- admission control / abort ------------------------------------------------
    def _shed(self, req: SimRequest):
        """Admission-control reject: terminal, counted (Phase.SHED stays
        in ``submitted`` so slo_summary scores it as a miss)."""
        req.phase = Phase.SHED
        self.shed.append(req)
        if self.fleet is not None:
            self.fleet.note("shed", req.rid)
            self.fleet.stats["sheds"] += 1

    def backlog_depth(self) -> int:
        """Cluster-wide admission backlog (requests routed but not yet
        prefilled) — what ``max_queue`` bounds."""
        return sum(len(i.prefill_queue) for i in self.instances)

    def abort(self, rid: int) -> Optional[SimRequest]:
        """First-class cancel: tear down ``rid``'s serving state
        everywhere via the policy, stamp it ``Phase.ABORTED``."""
        self._sched_begin()
        try:
            req = self.policy.abort_request(rid)
        finally:
            self._sched_end()
        if req is not None:
            self.aborted.append(req)
            if self.fleet is not None:
                self.fleet.note("abort", rid)
                self.fleet.stats["aborts"] += 1
        return req

    # -- event handlers -----------------------------------------------------------
    def _handle_arrival(self, req: SimRequest):
        if (self.max_queue is not None
                and self.backlog_depth() >= self.max_queue):
            self._shed(req)
            return
        self._sched_begin()
        try:
            inst = self.policy.route(req)
        finally:
            self._sched_end()
        if inst is None:
            self.dropped.append(req)
            return
        inst.prefill_queue.append(req)
        self.kick(inst)

    def _handle_done(self, data):
        iid, epoch = data if isinstance(data, tuple) else (data, 0)
        inst = self.instances[iid]
        if not inst.alive or epoch != inst.epoch or inst._running is None:
            return      # the iteration died with its instance (fleet kill)
        plan, batch_snapshot, started = inst._running
        inst.busy = False
        inst._running = None
        self.n_iterations += 1
        pf = prefill_part(plan)
        dc = decode_part(plan)
        if pf is not None:
            # only items whose final chunk ran complete their prefill
            # (they left the queue when the plan was compiled); partial
            # chunks keep their request queued — the planner's cursor
            # resumes it next iteration
            # an aborted request's in-flight chunk still burns the time
            # it was priced at, but its completion is void
            reqs = [it.req for it in pf.items
                    if it.completes and it.req.phase is not Phase.ABORTED]
            for r in reqs:
                r.first_token_time = self.now
                r.token_times.append(self.now)
                r.generated += 1
            self._sched_begin()
            try:
                self.policy.on_prefill_done(inst, reqs)
            finally:
                self._sched_end()
        if dc is not None:
            # a fused plan IS dc.steps decode iterations: each request
            # in the snapshot advances once per step until done.  Token
            # times spread evenly across the span's modeled duration, so
            # per-token TBT/SLO metrics stay comparable to the live
            # executor (which stamps one iteration apart) instead of
            # bunching at plan completion.
            steps = max(1, dc.steps)
            per_step = (self.now - started) / steps
            finished_now: List[SimRequest] = []
            for j in range(steps):
                t_j = started + per_step * (j + 1)
                for rid in batch_snapshot:
                    r = inst.decode_batch.get(rid)
                    if r is None:
                        continue
                    r.generated += 1
                    r.token_times.append(t_j)
                    if r.done:
                        r.finish_time = t_j
                        self.finished.append(r)
                        finished_now.append(r)
                        del inst.decode_batch[rid]
            self._sched_begin()
            try:
                self.policy.on_decode_done(inst, finished_now)
            finally:
                self._sched_end()
        inst.note_peak()
        self.kick(inst)

    def _handle_join(self, data):
        iid, req = data
        inst = self.instances[iid]
        if req.phase is Phase.ABORTED:
            return      # cancelled while its KV transfer was in flight
        if not inst.alive or inst.draining:
            # the decode target died/cordoned while the KV transfer was
            # in flight: the state is lost, the request re-prefills
            from repro_torch.fleet import reset_for_reprefill
            if self.fleet is not None:
                self.fleet.note("requeue", req.rid)
                self.fleet.stats["requeues"] += 1
                self.fleet.stats["lost_decode_tokens"] += req.generated
                self.fleet.stats["reprefill_tokens"] += \
                    reset_for_reprefill(req)
            else:
                reset_for_reprefill(req)
            self.push(self.now, "arrival", req)
            return
        inst.decode_batch[req.rid] = req
        inst.note_peak()
        self.kick(inst)

    # -- observability -----------------------------------------------------------
    def _sample_timeline(self):
        self._ticks += 1
        if (self._ticks - 1) % self.timeline_stride:
            return
        running = [i._running[0] if i.busy and i._running else None
                   for i in self.instances]
        n_prefill = sum(1 for p in running
                        if isinstance(p, (PrefillPlan, MixedPlan)))
        n_decode = sum(1 for p in running if isinstance(p, DecodePlan))
        self.timeline.append(TimelinePoint(
            t=self.now,
            queue_depth=sum(len(i.prefill_queue) for i in self.instances),
            n_prefill=n_prefill, n_decode=n_decode,
            n_idle=len(self.instances) - n_prefill - n_decode))

    # -- closed-loop refill -------------------------------------------------------
    def _pump_refill(self):
        while (self._pump is not None
               and self._pump_issued - len(self.finished) - len(self.dropped)
               - len(self.shed) - len(self.aborted)
               < self._pump_target):
            r = next(self._pump, None)
            if r is None:
                self._pump = None
                return
            r.arrival = self.now
            self._pump_issued += 1
            self.submitted.append(r)
            self.push(self.now, "arrival", r)

    # -- main loop ---------------------------------------------------------------
    def run(self, requests: Optional[List[SimRequest]] = None,
            horizon: float = float("inf"),
            source: Optional[RequestSource] = None,
            fleet=None):
        """Run to completion (or ``horizon``).

        ``requests`` is the classic pre-materialized list; ``source`` is a
        :class:`repro_torch.workloads.RequestSource` — open-loop sources feed
        the event heap directly (one traffic time unit == one modeled
        second), closed-loop sources keep ``source.concurrency`` requests
        in flight, issuing the next on each completion.

        ``fleet`` is a :class:`repro_torch.fleet.FleetController`: its event
        stream (kills / joins / drains, in modeled seconds) lands on the
        same heap and dispatches through ``policy.on_fleet_event``.
        """
        if fleet is not None:
            self.fleet = fleet
            for ev in fleet.drain_all():
                self.push(ev.t, "fleet", ev)
        if source is not None:
            if source.concurrency:
                self._pump = iter(source)
                self._pump_target = source.concurrency
                self._pump_refill()
            else:
                requests = list(source)
        for r in (requests or []):
            self.submitted.append(r)
            self.push(r.arrival, "arrival", r)
        while self._heap:
            t, _, kind, data = heapq.heappop(self._heap)
            if t > horizon:
                break
            self.now = t
            if kind == "arrival":
                # keep the arrival mirror-heap drained even when no
                # fusing policy ever asks for next_arrival()
                if self._arrivals and self._arrivals[0] <= t:
                    heapq.heappop(self._arrivals)
                self._handle_arrival(data)
            elif kind == "inst_done":
                self._handle_done(data)
            elif kind == "join_decode":
                self._handle_join(data)
            elif kind == "abort":
                self.abort(data)
            elif kind == "fleet":
                self.policy.on_fleet_event(data, self.fleet)
            if self.fleet is not None and any(i.draining
                                              for i in self.instances):
                self.policy.settle_drains(self.fleet)
            self._sample_timeline()
            if self._pump is not None:
                self._pump_refill()
        return self.finished
