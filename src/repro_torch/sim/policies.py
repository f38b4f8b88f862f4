"""Simulator adapters for the shared scheduling kernels.

The serving systems of the paper's evaluation (§5.2) plus one from its
related work (§2) are *decided* by the backend-agnostic kernels in
``repro_torch.scheduling`` — the same objects that drive the port's live
engines through ``repro_torch.scheduling.live`` — and *executed* here
against the discrete-event simulator's analytic cost model:

  VLLMPolicy      — vLLM-style: independent instances, continuous batching
                    that co-schedules prefill with decode (prefill
                    prioritized). No KV movement. TBT spikes when prompts
                    land mid-decode (paper Fig. 5 / 16).
  SplitwisePolicy — Splitwise-style static disaggregation: n_p dedicated
                    prefill instances, rest decode-only; post-prefill KV
                    transfer to a decode instance is on the request's
                    critical path (Fig. 1 Case B).
  SarathiPolicy   — Sarathi-Serve-style chunked prefill: prompts split into
                    fixed-size chunks co-scheduled with decode, bounding
                    (not eliminating) the TBT spike — trades TTFT for TBT.
  AcceLLMPolicy   — the paper's system: instance pairs, dynamic roles,
                    per-layer-overlapped KV streaming, redundant KV copies,
                    count+state-bytes decode balancing, replica eviction
                    under memory pressure.

Each adapter owns only simulator mechanics (event pushes, busy-state
handling); routing, role selection, placement, rebalancing and eviction
decisions are delegated to its kernel, iteration *shapes* to the shared
step planner (``repro_torch.stepplan`` — the same bucketing, chunking and
no-mixing rules the live executor compiles under), and iteration *costs*
to the single entry point ``PerfModel.plan_time``.

A copy of the JAX package's ``repro.sim.policies``, held against it by
``tests/test_torch_sim.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.fleet import (DegradeInstance, Drain, FleetController,
                               JoinInstance, KillInstance, RecoverInstance,
                               reset_for_reprefill, rollback_tokens)
from repro_torch.scheduling.accellm import AcceLLMScheduler
from repro_torch.scheduling.actions import (Action, Decode, EvictReplica,
                                            MirrorSync, Prefill,
                                            PromoteReplica, StreamState)
from repro_torch.scheduling.base import MAX_PREFILL_BATCH, SchedulerPolicy
from repro_torch.scheduling.baselines import (SarathiScheduler,
                                              SplitwiseScheduler,
                                              VLLMScheduler)
from repro_torch.scheduling.ulb import ULBScheduler
from repro_torch.sim.cluster import Policy, SimInstance, Simulator
from repro_torch.sim.workload import SimRequest
from repro_torch.stepplan import (DecodePlan, Planner, StepPlan, TransferPlan,
                                  prefill_part)

__all__ = ["AcceLLMPolicy", "VLLMPolicy", "SplitwisePolicy", "SarathiPolicy",
           "ULBPolicy", "SimInstanceView", "SimClusterView",
           "MAX_PREFILL_BATCH"]


def sim_prefix_key(inst: SimInstance, req) -> list:
    """The simulator's radix key for a request's shareable prompt head.

    The sim is token-free, so the alphabet is ``(prefix_id, pos)``
    pairs: two requests collide on exactly the chunks where their
    declared shared prefix overlaps — the same hit lengths the live
    engine computes over real token ids (group tokens are identical
    across a prefix group there)."""
    if (inst.prefix_cache is None
            or getattr(req, "prefix_id", None) is None):
        return []
    from repro_torch.prefixcache import aligned_hit_lines
    n = aligned_hit_lines(req.prefix_len, req.prompt_len,
                          inst.block_lines)
    return [(req.prefix_id, j) for j in range(n)]


# ---------------------------------------------------------------------------
# Views: the simulator's cost model behind the scheduling protocols
# ---------------------------------------------------------------------------


class SimInstanceView:
    """InstanceView over a SimInstance (see repro_torch.scheduling.views)."""

    def __init__(self, inst: SimInstance,
                 placement: Dict[int, Tuple[int, Optional[int]]],
                 planner: Optional[Planner] = None):
        self._i = inst
        self._placement = placement
        self._planner = planner

    @property
    def index(self) -> int:
        return self._i.iid

    # -- fleet state ---------------------------------------------------------
    def alive(self) -> bool:
        return self._i.alive

    def draining(self) -> bool:
        return self._i.draining

    def health(self) -> float:
        # EWMA slowdown (1.0 = nominal), updated by the event loop with
        # the shared step_health arithmetic (see scheduling.views)
        return self._i.health

    # -- capacity ------------------------------------------------------------
    def free_slots(self) -> int:
        return max(0, self._i.max_batch - len(self._i.decode_batch))

    def mem_free(self) -> float:
        return self._i.mem_free()

    def free_blocks(self) -> int:
        return self._i.free_blocks()

    def block_lines(self) -> int:
        return self._i.block_lines

    def spec(self):
        # the hardware this SimInstance is priced on (heterogeneous
        # pods carry a different InstanceSpec per instance)
        return self._i.perf.inst

    def primary_bytes(self) -> float:
        costs = self._i.store.costs
        return sum(costs.bytes_at(r.total_len)
                   for r in self._i.decode_batch.values())

    def replica_bytes(self) -> float:
        costs = self._i.store.costs
        return sum(costs.bytes_at(r.total_len)
                   for r in self._i.replicas.values())

    def can_admit(self, req, taking: int = 0) -> bool:
        fits = self._i.mem_free() >= self._i.perf.kv_bytes(req.prompt_len)
        return fits and len(self._i.decode_batch) + taking < self._i.max_batch

    def can_hold_primary(self, req, resident: bool = False) -> bool:
        # the simulator's decode batch is elastic; memory pressure is
        # handled by eviction rather than refusing placement
        return True

    def can_hold_replica(self, req, resident: bool = False) -> bool:
        return self._i.mem_free() >= self._i.perf.kv_bytes(req.total_len)

    def can_queue(self) -> bool:
        return True

    # -- load ----------------------------------------------------------------
    def decode_load(self) -> int:
        return len(self._i.decode_batch)

    def prefill_backlog(self) -> int:
        return len(self._i.prefill_queue)

    def prefill_backlog_tokens(self) -> int:
        # planner feedback, same as the live view: prompts mid-chunk
        # count only their remaining (cursor-adjusted) tokens, and a
        # stamped prefix-cache hit starts the count past the hit
        cursor = self._planner.cursor if self._planner else (lambda rid: 0)
        return sum(r.prompt_len - max(cursor(r.rid),
                                      getattr(r, "prefix_hit", 0) or 0)
                   for r in self._i.prefill_queue)

    def decode_weights(self) -> Dict[int, float]:
        return {rid: self._i.perf.kv_bytes(r.total_len)
                for rid, r in self._i.decode_batch.items()}

    def replica_weights(self) -> Dict[int, float]:
        return {rid: self._i.perf.kv_bytes(r.total_len)
                for rid, r in self._i.replicas.items()}

    def decode_remaining(self) -> Dict[int, int]:
        return {rid: r.max_new_tokens - r.generated
                for rid, r in self._i.decode_batch.items()}

    # -- mirror ledger --------------------------------------------------------
    def request_lines(self) -> Dict[int, int]:
        return {rid: r.total_len for rid, r in self._i.decode_batch.items()}

    def replica_synced(self) -> Dict[int, int]:
        # the simulator executes the mirror inside the decode-step cost,
        # so a replica is current as of its request's last decode —
        # unless a sparse lag mark says a sync was skipped (fleet races,
        # partial-sync injection in tests)
        return {rid: self._i.synced_marks.get(rid, r.total_len)
                for rid, r in self._i.replicas.items()}

    # -- prefix cache ---------------------------------------------------------
    def shared_blocks(self) -> int:
        return self._i.synced_store().ledger.shared_blocks_count()

    def prefix_hit_tokens(self, req) -> int:
        cache = self._i.prefix_cache
        if cache is None:
            return 0
        key = sim_prefix_key(self._i, req)
        if not key:
            return 0
        return len(cache.peek_blocks(key)) * self._i.block_lines


class SimClusterView:
    """ClusterView over a Simulator (see repro_torch.scheduling.views)."""

    def __init__(self, sim: Simulator,
                 placement: Dict[int, Tuple[int, Optional[int]]],
                 planner: Optional[Planner] = None):
        self._views = [SimInstanceView(i, placement, planner)
                       for i in sim.instances]
        self._placement = placement

    def instances(self):
        return self._views

    def pairs(self):
        return [(self._views[i], self._views[i + 1])
                for i in range(0, len(self._views) - 1, 2)]

    def placements(self) -> Dict[int, Tuple[int, Optional[int]]]:
        return self._placement


class KernelPolicy(Policy):
    """Base adapter: binds a scheduling kernel + the shared step planner
    to the simulator."""

    kernel: SchedulerPolicy
    #: rid -> (primary iid, replica iid or None); empty for policies
    #: without redundancy
    placement: Dict[int, Tuple[int, Optional[int]]]

    def __init__(self, kernel: SchedulerPolicy, fuse_decode_steps: int = 1):
        self.kernel = kernel
        self.placement = {}
        #: array-backed cluster state (repro_torch.scale), attached at
        #: bind time when the kernel declares ``vectorized = True``
        self.arrays = None
        #: same configuration rule as the live executor: the kernel
        #: declares mixing/chunking, the planner shapes iterations
        self.planner = Planner.for_policy(kernel)
        #: fused decode ceiling (mirrors LiveCluster(fuse_decode_steps=)):
        #: idle decode instances compile up-to-N-step DecodePlans, priced
        #: with one amortized dispatch by plan_time; the planner's
        #: mirror/backlog/remaining-budget gates apply per instance,
        #: spans are capped at the next pending arrival (_fuse_horizon),
        #: and event-driven instances keep independent clocks so no
        #: cluster-wide uniformity cap is needed
        self.planner.max_fuse_steps = max(1, fuse_decode_steps)

    @property
    def name(self):  # type: ignore[override]
        return self.kernel.name

    def bind(self, sim: Simulator):
        super().bind(sim)
        if getattr(self.kernel, "vectorized", False):
            # lazy import: repro_torch.sim must stay importable without the
            # scale layer in the loop (no cycle at module load)
            from repro_torch.scale.state import ArrayClusterState
            self.arrays = ArrayClusterState(sim, self.placement,
                                            self.planner)
            # the adapter's ledger becomes the observed dict so every
            # placement write lands in the replica arrays
            self.placement = self.arrays.placement

    def view(self) -> SimClusterView:
        if self.arrays is not None:
            return self.arrays.cluster_view()
        return SimClusterView(self.sim, self.placement, self.planner)

    def _inst_view(self, inst: SimInstance) -> SimInstanceView:
        """A single instance's view, from the persistent array views
        when attached (pair-local admission/eviction decisions)."""
        if self.arrays is not None:
            return self.arrays.cluster_view().instances()[inst.iid]
        return SimInstanceView(inst, self.placement, self.planner)

    def note_decode_advance(self, inst, rids, steps):
        if self.arrays is not None:
            self.arrays.note_decode_advance(inst, rids, steps)

    def route(self, req: SimRequest) -> Optional[SimInstance]:
        idx = self.kernel.route(self.view(), req)
        return None if idx is None else self.sim.instances[idx]

    # -- plan helpers ---------------------------------------------------------
    def _fuse_horizon(self, inst: SimInstance) -> Optional[int]:
        """Decode iterations until the next pending arrival, in units of
        this instance's current single-step time — the sim analogue of
        the live executor's arrival-horizon cap, so a fused span never
        runs (much) past an admission point on either backend.  None
        when no arrival is scheduled."""
        nxt = self.sim.next_arrival()
        if nxt is None:
            return None
        if self.arrays is not None:
            lens, _ = self._inst_view(inst).decode_plan_stats()
            lengths = tuple(sorted(lens))
        else:
            lengths = tuple(sorted(r.total_len
                                   for r in inst.decode_batch.values()))
        t1 = inst.perf.plan_time(DecodePlan(
            inst.iid, lengths=lengths, block_lines=inst.block_lines))
        if t1 <= 0:
            return None
        return max(1, int((nxt - self.sim.now) / t1))

    def _compile(self, inst: SimInstance,
                 actions: List[Action]) -> Optional[StepPlan]:
        if self.planner.max_fuse_steps > 1:
            self.planner.fuse_horizon = self._fuse_horizon(inst)
        plans = self.planner.compile(actions, self.view())
        if not plans:
            return None
        plan = plans[0]
        # requests whose prefill completes within this plan leave the
        # queue NOW (they are executing, not waiting — backlog views and
        # queue-depth timelines must not count them, matching the live
        # executor); prompts mid-chunk stay queued with their cursor
        pf = prefill_part(plan)
        if pf is not None:
            done_rids = set(pf.completed_rids())
            if done_rids:
                inst.prefill_queue = [r for r in inst.prefill_queue
                                      if r.rid not in done_rids]
        return plan

    def _queue_split(self, inst: SimInstance):
        """Split the prefill queue into prompts mid-chunk (they resume
        unconditionally) and fresh candidates (admission-gated)."""
        in_prog = [r for r in inst.prefill_queue
                   if self.planner.cursor(r.rid) > 0]
        fresh = [r for r in inst.prefill_queue
                 if self.planner.cursor(r.rid) == 0]
        return in_prog, fresh

    def _prefill_actions(self, inst: SimInstance, reqs) -> List[Action]:
        for r in reqs:
            self._prefix_stamp(inst, r)
        return [Prefill(r.rid, inst.iid, r.prompt_len, req=r) for r in reqs]

    # -- prefix cache ---------------------------------------------------------
    def _prefix_stamp(self, inst: SimInstance, r: SimRequest):
        """Consult the instance's prefix index once, when the prefill is
        first scheduled (same stamp point as the live executor): the
        planner then prices the PrefillItem at its unique suffix, and
        the pinned run survives eviction until :meth:`_note_prefilled`
        adopts it.  Idempotent across re-planning."""
        cache = inst.prefix_cache
        if cache is None or getattr(r, "prefix_hit", None) is not None:
            return
        key = sim_prefix_key(inst, r)
        blocks = cache.lookup_pin(r.rid, key) if key else []
        if blocks:
            inst.hit_runs[r.rid] = blocks
        r.prefix_hit = len(blocks) * inst.block_lines

    def _note_prefilled(self, inst: SimInstance, r: SimRequest):
        """Prefill of ``r`` completed on ``inst``: adopt the pinned hit
        run as the resident table's shared head and index the new
        prompt's shareable head — mirror of the live engine's
        first-chunk adoption + ``_prefix_insert``.

        A request that was handed off after prefill (Splitwise-style:
        never resident here) still seeds the cache: its head blocks are
        allocated, retained by the index, and the unique suffix is
        returned to the pool at once — the live engine's
        release-after-stream, where the cache alone keeps the prompt
        head alive on the prefill instance."""
        cache = inst.prefix_cache
        if cache is None:
            return
        run = inst.hit_runs.pop(r.rid, None)
        resident = r.rid in inst.decode_batch or r.rid in inst.replicas
        if resident and (getattr(r, "prefix_hit", None) or 0) and run:
            inst.shared_runs[r.rid] = run
        cache.unpin(r.rid)
        key = sim_prefix_key(inst, r)
        if not key:
            return
        led = inst.synced_store().ledger
        k = len(key) // inst.block_lines
        if resident:
            cache.insert(key, led.tables[r.rid][:k])
        elif r.rid not in led.tables:
            led.alloc(r.rid, r.total_len, shared=run)
            cache.insert(key, led.tables[r.rid][:k])
            led.free(r.rid)

    # -- fleet mechanics (repro_torch.fleet) ----------------------------------
    def on_fleet_event(self, ev, ctrl: FleetController):
        if isinstance(ev, KillInstance):
            self._fleet_kill(ev.instance, ctrl)
        elif isinstance(ev, JoinInstance):
            self._fleet_join(ev.instance, ctrl)
        elif isinstance(ev, Drain):
            self._fleet_drain(ev.instance, ctrl)
        elif isinstance(ev, DegradeInstance):
            self._fleet_degrade(ev.instance, ev.factor, ev.link_factor, ctrl)
        elif isinstance(ev, RecoverInstance):
            self._fleet_recover(ev.instance, ctrl)
        else:
            raise ValueError(f"unknown fleet event {ev!r}")

    def _fleet_degrade(self, iid: int, factor: float, link_factor: float,
                       ctrl: FleetController):
        """Partial failure: the instance keeps serving, just slower.  No
        state moves here — the health EWMA surfaces the slowdown to the
        kernels, and hedging kernels react to it."""
        inst = self.sim.instances[iid]
        if not inst.alive:
            return
        inst.degrade_factor = float(factor)
        inst.link_degrade = float(link_factor)
        ctrl.note("degrade", iid, float(factor), float(link_factor))
        ctrl.stats["degrades"] += 1
        # observe immediately if idle: health starts converging to the
        # new factor without waiting for the next arrival/completion
        self.sim.kick(inst)

    def _fleet_recover(self, iid: int, ctrl: FleetController):
        inst = self.sim.instances[iid]
        if not inst.alive:
            return
        inst.degrade_factor = 1.0
        inst.link_degrade = 1.0
        ctrl.note("recover", iid)
        ctrl.stats["recoveries"] += 1
        self.sim.kick(inst)

    # -- abort lifecycle / deadline shedding ----------------------------------
    def abort_request(self, rid: int) -> Optional[SimRequest]:
        """First-class cancel: remove every trace of ``rid`` — queue
        entry, decode residency, replica + lag marks, prefix pins,
        planner cursor, placement — on every instance.  The ledgers
        reconcile to the shrunken resident sets on next read, so the
        blocks are freed with zero leakage."""
        from repro_torch.serving.request import Phase
        found: Optional[SimRequest] = None
        for inst in self.sim.instances:
            for r in list(inst.prefill_queue):
                if r.rid == rid:
                    inst.prefill_queue = [q for q in inst.prefill_queue
                                          if q.rid != rid]
                    found = r
            r = inst.decode_batch.pop(rid, None)
            if r is not None:
                found = r
            r = inst.replicas.pop(rid, None)
            if r is not None:
                found = found or r
            inst.synced_marks.pop(rid, None)
            inst.hit_runs.pop(rid, None)
            inst.shared_runs.pop(rid, None)
            if inst.prefix_cache is not None:
                inst.prefix_cache.unpin(rid)
        self.placement.pop(rid, None)
        self.planner.forget(rid)
        if found is not None:
            found.phase = Phase.ABORTED
        return found

    def shed_overdue(self, inst: SimInstance, now: float,
                     deadline: float) -> List[SimRequest]:
        """Deadline-aware admission: a backlogged request whose queue
        wait already exceeds ``deadline`` will blow TTFT no matter what
        — reject it now instead of serving it late.  Prompts mid-chunk
        (planner cursor > 0) are executing, not waiting: never shed."""
        overdue = [r for r in inst.prefill_queue
                   if now - r.arrival > deadline
                   and self.planner.cursor(r.rid) == 0]
        if not overdue:
            return []
        gone = {r.rid for r in overdue}
        inst.prefill_queue = [r for r in inst.prefill_queue
                              if r.rid not in gone]
        for r in overdue:
            inst.hit_runs.pop(r.rid, None)
            if inst.prefix_cache is not None:
                inst.prefix_cache.unpin(r.rid)
        return overdue

    def _rebind_topology(self):
        """Membership changed (join appended an instance / revived an
        index): adapters with a static topology recompute it here."""
        pass

    def _fleet_kill(self, iid: int, ctrl: FleetController):
        """Same contract (and trace order) as ``LiveCluster.fleet_kill``:
        promote onto warm replicas, re-queue what is truly lost, drop
        orphaned replicas, re-route the prefill backlog."""
        sim = self.sim
        inst = sim.instances[iid]
        if not inst.alive:
            return
        ctrl.note("kill", iid)
        ctrl.stats["kills"] += 1
        # the in-flight iteration dies with the instance: prompts whose
        # final chunk was executing left the queue at compile time —
        # recover them so they re-queue like the rest of the backlog
        if inst._running is not None:
            pf = prefill_part(inst._running[0])
            if pf is not None:
                inst.prefill_queue[:0] = [it.req for it in pf.items
                                          if it.completes]
            inst._running = None
            inst.busy = False
        inst.epoch += 1          # stale inst_done events are ignored
        plan = ctrl.plan_failover(self.view(), iid)
        # 1. promotions: the warm replica takes over at its synced line
        for pr in plan.promotions:
            r = inst.decode_batch.pop(pr.rid)
            dst = sim.instances[pr.dst]
            if pr.lost_lines:
                rollback_tokens(r, pr.lost_lines)
                ctrl.stats["lost_lines"] += pr.lost_lines
            dst.decode_batch[pr.rid] = r
            dst.replicas.pop(pr.rid, None)
            dst.synced_marks.pop(pr.rid, None)
            self.placement[pr.rid] = (pr.dst, None)
            ctrl.note("promote", pr.rid, pr.src, pr.dst, pr.lost_lines)
            ctrl.stats["promotions"] += 1
            dst.note_peak()
        # 2. truly lost state: re-enters the heap as an arrival NOW
        # (never re-appended to sim.submitted — each rid stays
        # single-counted in the metrics)
        def _requeue_resident(rid: int, r: SimRequest):
            ctrl.note("requeue", rid)
            ctrl.stats["requeues"] += 1
            ctrl.stats["lost_decode_tokens"] += r.generated
            ctrl.stats["reprefill_tokens"] += reset_for_reprefill(r)
            r.prefix_hit = None     # re-stamps wherever it re-routes
            self.planner.forget(rid)
            old = self.placement.pop(rid, (None, None))
            if old[1] is not None and old[1] != iid:
                sim.instances[old[1]].replicas.pop(rid, None)
                sim.instances[old[1]].synced_marks.pop(rid, None)
            sim.push(sim.now, "arrival", r)

        for rid in plan.requeues:
            _requeue_resident(rid, inst.decode_batch.pop(rid))
        # residents invisible to the placement ledger (the baseline
        # adapters never maintain one — the live executor tracks
        # placements for every policy): same fate, rid order
        for rid in sorted(inst.decode_batch):
            _requeue_resident(rid, inst.decode_batch.pop(rid))
        # 3. replicas this instance hosted for surviving primaries
        for rid in plan.dropped_replicas:
            pl = self.placement.get(rid)
            if pl:
                self.placement[rid] = (pl[0], None)
            ctrl.note("drop_replica", rid)
        # 4. routed-but-unstarted prompts re-route (no tokens re-run);
        # 5. prompts mid-chunk lose their partial prefill work
        fresh = [r for r in inst.prefill_queue
                 if self.planner.cursor(r.rid) == 0]
        mid = [r for r in inst.prefill_queue
               if self.planner.cursor(r.rid) > 0]
        for r in fresh:
            ctrl.note("requeue", r.rid)
            ctrl.stats["requeue_backlog"] += 1
            r.prefix_hit = None
            sim.push(sim.now, "arrival", r)
        for r in mid:
            ctrl.note("requeue", r.rid)
            ctrl.stats["requeues"] += 1
            ctrl.stats["reprefill_tokens"] += self.planner.cursor(r.rid)
            self.planner.forget(r.rid)
            reset_for_reprefill(r)
            r.prefix_hit = None
            sim.push(sim.now, "arrival", r)
        inst.prefill_queue = []
        inst.replicas.clear()
        inst.synced_marks.clear()
        # the prefix cache dies with the HBM it indexed (rejoin at this
        # rank starts cold) — same teardown as the live executor
        inst.hit_runs.clear()
        inst.shared_runs.clear()
        if inst.prefix_cache is not None:
            inst.prefix_cache.release_all()
        inst.alive = False
        inst.draining = False
        for other in sim.instances:
            sim.kick(other)

    def _fleet_join(self, iid: Optional[int], ctrl: FleetController):
        sim = self.sim
        if iid is not None and iid < len(sim.instances):
            inst = sim.instances[iid]
            if inst.alive:
                return           # join of a live index: no-op
            # replacement hardware at the same rank (state died at kill)
            inst.alive = True
            inst.draining = False
        else:
            inst = SimInstance(len(sim.instances), sim.perf, sim.max_batch,
                               sim.block_lines)
            if sim.prefix_cache:
                inst.enable_prefix_cache(sim.prefix_cache_blocks)
            sim.instances.append(inst)
        ctrl.note("join", inst.iid)
        ctrl.stats["joins"] += 1
        self._rebind_topology()
        # warm scale-up: the kernel mirrors resident requests onto the
        # joined instance before any new arrival routes there
        for act in self.kernel.warm_on_join(self.view(), inst.iid):
            if not isinstance(act, StreamState) or not act.as_replica:
                continue
            r = sim.instances[act.src].decode_batch.get(act.rid)
            if r is None:
                continue
            inst.replicas[act.rid] = r
            self.placement[act.rid] = (act.src, inst.iid)
            ctrl.stats["warm_streams"] += 1
        inst.note_peak()
        sim.kick(inst)

    def _fleet_drain(self, iid: int, ctrl: FleetController):
        inst = self.sim.instances[iid]
        if not inst.alive or inst.draining:
            return
        inst.draining = True
        ctrl.note("drain", iid)
        ctrl.stats["drains"] += 1
        self.settle_drains(ctrl)

    def settle_drains(self, ctrl: FleetController):
        for inst in self.sim.instances:
            if not (inst.draining and inst.alive):
                continue
            if inst.busy or inst.decode_batch or inst.prefill_queue:
                continue
            # only replicas remain: surrender the copies and retire
            for rid in list(inst.replicas):
                pl = self.placement.get(rid)
                if pl and pl[1] == inst.iid:
                    self.placement[rid] = (pl[0], None)
            inst.replicas.clear()
            inst.synced_marks.clear()
            inst.alive = False
            inst.draining = False
            ctrl.note("drained", inst.iid)


# ---------------------------------------------------------------------------
# vLLM
# ---------------------------------------------------------------------------


class VLLMPolicy(KernelPolicy):

    def __init__(self, kernel: Optional[SchedulerPolicy] = None,
                 fuse_decode_steps: int = 1):
        super().__init__(kernel or VLLMScheduler(),
                         fuse_decode_steps=fuse_decode_steps)

    def next_plan(self, inst):
        actions: List[Action] = []
        in_prog, fresh = self._queue_split(inst)
        take = list(in_prog)
        if fresh:
            n = self.kernel.prefill_batch(self.view(), inst.iid, fresh)
            take += fresh[:n]
        actions += self._prefill_actions(inst, take)
        if inst.decode_batch:
            # co-batched prefill+decode iteration (the TBT spike)
            actions.append(Decode(inst.iid))
        return self._compile(inst, actions)

    def on_prefill_done(self, inst, reqs):
        for r in reqs:
            if r.done:
                r.finish_time = self.sim.now
                self.sim.finished.append(r)
            else:
                inst.decode_batch[r.rid] = r
            self._note_prefilled(inst, r)
        inst.note_peak()


# ---------------------------------------------------------------------------
# Sarathi-Serve (chunked prefill — related-work baseline)
# ---------------------------------------------------------------------------


class SarathiPolicy(VLLMPolicy):
    """Chunked prefill now lives in the shared step planner: the
    per-iteration ``chunk_tokens`` budget is spent across the queue
    (in-progress prompts first, cursors resumed against the ledger) and
    the resulting MixedPlan is priced by ``PerfModel.plan_time`` — the
    old ``_chunk_work`` side-channel and per-adapter cost override are
    gone, and the identical planner drives the live engines."""

    def __init__(self, chunk_tokens: int = 512, fuse_decode_steps: int = 1):
        super().__init__(SarathiScheduler(chunk_tokens),
                         fuse_decode_steps=fuse_decode_steps)
        self.chunk_tokens = chunk_tokens


# ---------------------------------------------------------------------------
# ULB (Universal Load Balancing — PAPERS.md competitor)
# ---------------------------------------------------------------------------


class ULBPolicy(VLLMPolicy):
    """Least-outstanding-work routing over vLLM-style continuous
    batching: same execution mechanics as :class:`VLLMPolicy`, different
    routing kernel (``repro_torch.scheduling.ulb``)."""

    def __init__(self, kernel: Optional[ULBScheduler] = None,
                 fuse_decode_steps: int = 1):
        super().__init__(kernel or ULBScheduler(),
                         fuse_decode_steps=fuse_decode_steps)


# ---------------------------------------------------------------------------
# Splitwise
# ---------------------------------------------------------------------------


class SplitwisePolicy(KernelPolicy):

    def __init__(self, n_prefill: int,
                 kernel: Optional[SplitwiseScheduler] = None,
                 fuse_decode_steps: int = 1):
        super().__init__(kernel or SplitwiseScheduler(n_prefill),
                         fuse_decode_steps=fuse_decode_steps)
        self.n_prefill = n_prefill

    def bind(self, sim):
        super().bind(sim)
        self._rebind_topology()

    def _rebind_topology(self):
        self.prefill_insts = self.sim.instances[: self.n_prefill]
        self.decode_insts = self.sim.instances[self.n_prefill:]

    def next_plan(self, inst):
        if inst in self.prefill_insts:
            if inst.prefill_queue:
                take = inst.prefill_queue[:MAX_PREFILL_BATCH]
                return self._compile(inst, self._prefill_actions(inst, take))
            return None
        if inst.decode_batch:
            return self._compile(inst, [Decode(inst.iid)])
        return None

    def on_prefill_done(self, inst, reqs):
        # KV transfer to the decode instance is on the critical path:
        # priced as an un-overlapped whole-state TransferPlan
        for r in reqs:
            if r.done:
                r.finish_time = self.sim.now
                self.sim.finished.append(r)
                self._note_prefilled(inst, r)
                continue
            actions = self.kernel.place_after_prefill(self.view(), inst.iid,
                                                      r)
            act = (actions[0] if actions
                   else StreamState(r.rid, src=inst.iid, dst=inst.iid))
            dt = inst.perf.plan_time(TransferPlan(
                inst.iid, act, lines=r.prompt_len, overlap_layers=False))
            # a browned-out link (DegradeInstance.link_factor) stretches
            # the un-overlapped KV handoff
            dt *= inst.link_degrade
            # the request leaves for its decode instance: the prefill
            # instance's cache still indexes the prompt head it computed
            self._note_prefilled(inst, r)
            self.sim.push(self.sim.now + dt, "join_decode", (act.dst, r))


# ---------------------------------------------------------------------------
# AcceLLM
# ---------------------------------------------------------------------------


class AcceLLMPolicy(KernelPolicy):

    def __init__(self, redundancy: bool = True,
                 kernel: Optional[AcceLLMScheduler] = None,
                 fuse_decode_steps: int = 1):
        super().__init__(kernel or AcceLLMScheduler(redundancy=redundancy),
                         fuse_decode_steps=fuse_decode_steps)

    @property
    def redundancy(self) -> bool:
        return self.kernel.redundancy

    def bind(self, sim):
        super().bind(sim)
        if len(sim.instances) % 2 != 0:
            raise ValueError(
                f"{self.name} organizes instances in pairs: got "
                f"{len(sim.instances)} instances (need an even count)")
        self._rebind_topology()

    def _rebind_topology(self):
        # pairs over floor(n/2): a join may append an odd instance,
        # which stays unpaired (partner() -> None) until its mate joins
        insts = self.sim.instances
        self.pairs = [(insts[i], insts[i + 1])
                      for i in range(0, len(insts) - 1, 2)]
        self.pair_of = {}
        for pa, pb in self.pairs:
            self.pair_of[pa.iid] = (pa, pb)
            self.pair_of[pb.iid] = (pa, pb)

    def partner(self, inst: SimInstance) -> Optional[SimInstance]:
        pair = self.pair_of.get(inst.iid)
        if pair is None:
            return None
        pa, pb = pair
        return pb if inst is pa else pa

    # -- dynamic roles ---------------------------------------------------------
    def next_plan(self, inst):
        if inst.prefill_queue:
            view = self._inst_view(inst)
            take = []
            for r in inst.prefill_queue:
                if (len(take) >= MAX_PREFILL_BATCH
                        or not view.can_admit(r, taking=len(take))):
                    break
                take.append(r)
            if not take:
                self._evict_replica(inst)  # memory pressure (§4.2.5)
                if inst.prefill_queue and view.can_admit(
                        inst.prefill_queue[0]):
                    take = [inst.prefill_queue[0]]
            if take:
                # before flipping to prefill, hand this side's decode work
                # to the partner via replica promotion (zero cost) so token
                # generation never stalls — the crux of §4.1.1/Fig. 6.
                # (never a MixedPlan: the planner would refuse, §4.2.3)
                self._handoff_decodes(inst)
                return self._compile(inst, self._prefill_actions(inst, take))
        if inst.decode_batch:
            # the DecodePlan carries the mirrored-request count, so the
            # per-step replica sync bound (Fig. 10) is priced centrally
            # by PerfModel.plan_time, not by an adapter override
            return self._compile(inst, [Decode(inst.iid)])
        return None

    def _handoff_decodes(self, inst):
        partner = self.partner(inst)
        if partner is None or not partner.alive or partner.draining:
            return
        if (partner.busy and partner._running
                and not isinstance(partner._running[0], DecodePlan)):
            return
        for rid in list(inst.decode_batch):
            pl = self.placement.get(rid, (None, None))
            if pl[1] != partner.iid:
                continue  # no replica on partner: this request must stall
            if rid in partner.synced_marks:
                continue  # stale replica cannot take the primary role
            r = inst.decode_batch.pop(rid)
            partner.decode_batch[rid] = r
            partner.replicas.pop(rid, None)
            inst.replicas[rid] = r
            self.placement[rid] = (partner.iid, inst.iid)
        self.sim.kick(partner)

    # -- placement: per-layer streamed during prefill (§4.2.4) -----------------
    def on_prefill_done(self, inst, reqs):
        partner = self.partner(inst)
        for r in reqs:
            if r.done:
                r.finish_time = self.sim.now
                self.sim.finished.append(r)
                continue
            # transfer already overlapped with prefill: the request joins
            # its primary's decode batch now, per the kernel's decision
            actions = self.kernel.place_after_prefill(self.view(), inst.iid,
                                                      r)
            dst_iid, rep_iid = inst.iid, None
            for act in actions:
                if not isinstance(act, StreamState):
                    continue
                if act.as_replica:
                    rep_iid = act.dst
                else:
                    dst_iid = act.dst
                    if act.retain_replica:
                        rep_iid = act.src
            dst = self.sim.instances[dst_iid]
            dst.decode_batch[r.rid] = r
            if rep_iid is not None:
                self.sim.instances[rep_iid].replicas[r.rid] = r
            self.placement[r.rid] = (dst_iid, rep_iid)
            self._note_prefilled(inst, r)
            # the copy landing on the OTHER instance adopts ITS cache's
            # resident head, if any (the live engine's import_stream
            # peek): a shared-prefix replica holds only its unique
            # suffix in new pool blocks
            for iid in {dst_iid, rep_iid} - {inst.iid, None}:
                other = self.sim.instances[iid]
                key = sim_prefix_key(other, r)
                if key and other.prefix_cache is not None:
                    run2 = other.prefix_cache.peek_blocks(key)
                    if run2:
                        other.shared_runs[r.rid] = run2
            dst.note_peak()
            if rep_iid is not None:
                self.sim.instances[rep_iid].note_peak()
        if partner is not None:
            self.sim.kick(partner)

    def on_decode_done(self, inst, finished):
        # drop replicas of exactly the requests that finished this
        # iteration (tracked explicitly — scanning a suffix of the global
        # finished list leaked replicas on bursty completions)
        for r in finished:
            pl = self.placement.pop(r.rid, None)
            if pl and pl[1] is not None:
                self.sim.instances[pl[1]].replicas.pop(r.rid, None)
                self.sim.instances[pl[1]].synced_marks.pop(r.rid, None)
        self._rebalance(inst)

    # -- load balancing by count + state bytes (§4.1.3) -------------------------
    def _rebalance(self, inst):
        pair = self.pair_of.get(inst.iid)
        if pair is None:
            return
        pa, pb = pair
        if pa.busy and pb.busy:
            return
        if (pa.busy or pb.busy) and not self._hedge_pending(pa, pb):
            # regular balancing waits for a fully idle pair; a pending
            # straggler hedge must not — the hedge window IS the window
            # in which the sick side is grinding a slow iteration.
            # Moving a request off a busy instance is safe under the
            # snapshot semantics of _handle_done (same as abort): the
            # in-flight iteration simply stops crediting it tokens, and
            # it resumes on the healthy side's next kick.
            return
        actions = self.kernel.rebalance(self.view(), inst.iid // 2)
        for act in actions:
            if isinstance(act, MirrorSync):
                # catch-up delta ahead of a promotion: the stale replica
                # absorbs the lines it was missing and is current again
                self.sim.instances[act.replica].synced_marks.pop(
                    act.rid, None)
                continue
            assert isinstance(act, PromoteReplica)
            src = self.sim.instances[act.src]
            dst = self.sim.instances[act.dst]
            r = src.decode_batch.pop(act.rid)
            dst.decode_batch[act.rid] = r
            # zero-cost: dst already held the (now current) replica
            dst.replicas.pop(act.rid, None)
            dst.synced_marks.pop(act.rid, None)
            src.replicas[act.rid] = r
            self.placement[act.rid] = (act.dst, act.src)
            if act.hedge and self.sim.fleet is not None:
                self.sim.fleet.stats["hedges"] += 1
        if actions:
            self.sim.kick(pa)
            self.sim.kick(pb)

    def _hedge_pending(self, pa, pb) -> bool:
        """Exactly one pair side's health EWMA is over the kernel's
        hedge threshold — the only situation in which the kernel would
        emit hedge flips rather than regular balancing moves."""
        thr = getattr(self.kernel, "hedge_threshold", None)
        if thr is None or not getattr(self.kernel, "hedging", False):
            return False
        return max(pa.health, pb.health) >= thr > min(pa.health, pb.health)

    # -- graceful degradation (§4.2.5) ----------------------------------------
    def _evict_replica(self, inst):
        view = self._inst_view(inst)
        for act in self.kernel.evict(self.view(), [view]):
            assert isinstance(act, EvictReplica)
            self.sim.instances[act.instance].replicas.pop(act.rid, None)
            pl = self.placement.get(act.rid)
            if pl:
                self.placement[act.rid] = (pl[0], None)
