"""Live-engine executor: drives the port's ``InstanceEngine``s under any
``SchedulerPolicy``.

A copy of the JAX package's ``repro.scheduling.live`` on the port's
engine, held against it by ``tests/test_torch_cluster.py`` (equal kernel
decision traces, stats and tokens at temperature 0).  The executor owns
the mechanics (engines, slots, the iteration clock, placement
bookkeeping) and asks the policy kernel for every decision, applying the
declarative actions it returns.  Every engine runs on ``device`` and
shares the one ``params`` tree.

The clock is the scheduling iteration (one decode step per active
instance per iteration); latency metrics are reported in iterations.

Fleet events (kills, joins, drains, degradation; ``repro_torch.fleet``)
apply between scheduling iterations.  ``prefix_cache=True`` gives every
engine a radix prefix cache: a request is stamped with its hit when it is
admitted, and prefills only its suffix.

With ``mesh`` (a :class:`repro_torch.meshserve.MeshPlacement`) each
instance runs on its own slice of the world's ranks, one process per
rank, every rank running this same cluster (SPMD): the engines of other
slices are shadows there, and each plan's tokens reach every rank, so
every rank makes the same decisions.  Mirror and stream bytes cross the
slices through ``repro_torch.meshserve.collectives``; the views expose
each slice's ``InstanceSpec``.  A join past the carved pod lands
unsharded: every rank builds it whole.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple, Union

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import Device
from repro_torch.core.tracing import Tracer, span, traced
from repro_torch.scheduling.actions import (AbortRequest, Action, Decode,
                                            EvictReplica, MirrorSync, Prefill,
                                            PromoteReplica, StreamState)
from repro_torch.scheduling.base import (ROLE_IDLE, ROLE_MIXED, ROLE_PREFILL,
                                         SchedulerPolicy)
from repro_torch.scheduling.views import step_health
from repro_torch.serving.engine import InstanceEngine
from repro_torch.serving.request import Phase, Request
from repro_torch.stepplan import (Planner, PrefillPlan, decode_part,
                                  prefill_part)
from repro_torch.workloads import IterationClock, TimelinePoint
from repro_torch.workloads.spec import RequestSource

if TYPE_CHECKING:             # runtime import stays lazy: repro_torch.fleet
    from repro_torch.fleet import FleetController  # imports this package


@dataclass
class Placement:
    """Where a request's state lives: (instance index, slot)."""
    primary: Tuple[int, int]
    replica: Optional[Tuple[int, int]] = None


class LiveInstanceView:
    """InstanceView over one live engine (see
    repro_torch.scheduling.views)."""

    def __init__(self, cluster: "LiveCluster", index: int):
        self._c = cluster
        self._eng = cluster.engines[index]
        self._index = index

    @property
    def index(self) -> int:
        return self._index

    # -- fleet state ---------------------------------------------------------
    def alive(self) -> bool:
        return self._c.alive[self._index]

    def draining(self) -> bool:
        return self._c.draining[self._index]

    def health(self) -> float:
        return self._c.health[self._index]

    # -- capacity ------------------------------------------------------------
    def free_slots(self) -> int:
        return len(self._eng.free_slots())

    def mem_free(self) -> float:
        # single source of truth: the engine's PagedStore ledger (which
        # counts primaries AND replicas, line-exact)
        return self._eng.store.free_bytes()

    def free_blocks(self) -> int:
        return self._eng.store.free_blocks()

    def block_lines(self) -> int:
        return self._eng.store.block_lines

    def spec(self):
        # hardware identity of this instance's mesh slice (None when
        # the cluster runs unplaced / the instance joined past the pod)
        specs = self._c.instance_specs
        return specs[self._index] if self._index < len(specs) else None

    def primary_bytes(self) -> float:
        store = self._eng.store
        return sum(store.used_bytes_of(req.rid)
                   for req in self._eng.slot_req.values())

    def replica_bytes(self) -> float:
        store = self._eng.store
        return sum(store.used_bytes_of(store.slot_rid[s])
                   for s in self._eng.replica_of)

    def can_admit(self, req, taking: int = 0) -> bool:
        return self.free_slots() > taking

    def can_hold_primary(self, req, resident: bool = False) -> bool:
        return resident or self.free_slots() > 0

    def can_hold_replica(self, req, resident: bool = False) -> bool:
        return resident or self.free_slots() > 0

    def can_queue(self) -> bool:
        return False

    # -- load ----------------------------------------------------------------
    def decode_load(self) -> int:
        return len(self._eng.slot_req)

    def prefill_backlog(self) -> int:
        # in-progress chunked prompts count: they still demand prefill
        # iterations (the policy keeps the instance in a prefill role)
        return (len(self._c._pending[self._index])
                + len(self._c._chunking[self._index]))

    def prefill_backlog_tokens(self) -> int:
        # planner feedback: chunk cursors shrink the remaining backlog,
        # and a stamped prefix-cache hit starts the count past the hit
        planner = self._c.planner
        return (sum(req.prompt_len - (req.prefix_hit or 0)
                    for req, _ in self._c._pending[self._index])
                + sum(req.prompt_len - max(planner.cursor(req.rid),
                                           req.prefix_hit or 0)
                      for req in self._c._chunking[self._index]))

    def decode_weights(self) -> Dict[int, float]:
        # decode_read_bytes == ledger bytes at the request's lines
        store = self._eng.store
        return {req.rid: store.used_bytes_of(req.rid)
                for req in self._eng.slot_req.values()
                if req.phase is Phase.DECODE}

    def replica_weights(self) -> Dict[int, float]:
        store = self._eng.store
        return {store.slot_rid[s]: store.used_bytes_of(store.slot_rid[s])
                for s in self._eng.replica_of}

    def decode_remaining(self) -> Dict[int, int]:
        return {req.rid: req.max_new_tokens - req.generated
                for req in self._eng.slot_req.values()}

    # -- mirror ledger --------------------------------------------------------
    def request_lines(self) -> Dict[int, int]:
        store = self._eng.store
        return {req.rid: store.lines(req.rid)
                for req in self._eng.slot_req.values()}

    def replica_synced(self) -> Dict[int, int]:
        store = self._eng.store
        return {store.slot_rid[s]: store.synced_line(store.slot_rid[s])
                for s in self._eng.replica_of}

    # -- prefix cache ---------------------------------------------------------
    def shared_blocks(self) -> int:
        return self._eng.store.ledger.shared_blocks_count()

    def prefix_hit_tokens(self, req) -> int:
        eng = self._eng
        if eng.prefix_cache is None:
            return 0
        key = eng._prefix_key(req)
        if not key:
            return 0
        return len(eng.prefix_cache.peek_blocks(key)) * eng.store.block_lines


class LiveClusterView:
    """ClusterView over a LiveCluster (see repro_torch.scheduling.views)."""

    def __init__(self, cluster: "LiveCluster"):
        self._c = cluster
        self._views = [LiveInstanceView(cluster, i)
                       for i in range(len(cluster.engines))]

    def instances(self):
        return self._views

    def pairs(self):
        return [(self._views[i], self._views[i + 1])
                for i in range(0, len(self._views) - 1, 2)]

    def placements(self) -> Dict[int, Tuple[int, Optional[int]]]:
        return {rid: (pl.primary[0],
                      pl.replica[0] if pl.replica is not None else None)
                for rid, pl in self._c.placements.items()}


class LiveCluster:
    """Policy-driven orchestrator over real InstanceEngines."""

    def __init__(self, cfg: ModelConfig, params, n_instances: int,
                 num_slots: int, kv_capacity: int,
                 policy: Union[SchedulerPolicy, str], *,
                 temperature: float = 0.0, eos_token: Optional[int] = None,
                 block_lines: Optional[int] = None,
                 fuse_decode_steps: int = 1,
                 prefix_cache: bool = False,
                 prefix_cache_blocks: Optional[int] = None,
                 fleet: Optional["FleetController"] = None,
                 mesh=None, timeline_stride: int = 1,
                 max_queue: Optional[int] = None,
                 shed_deadline: Optional[float] = None,
                 degrade_dispatch_s: float = 0.0,
                 device: Device = "cuda",
                 tracer: Optional[Tracer] = None):
        if isinstance(policy, str):
            from repro_torch.scheduling.registry import get_policy
            policy = get_policy(policy)
        if policy.requires_pairs and n_instances % 2 != 0:
            raise ValueError(
                f"{policy.name} organizes instances in pairs: got "
                f"{n_instances} instances (need an even count)")
        self.cfg = cfg
        self.policy = policy
        self._params = params
        #: spans, counters and request stamps of the serving step
        #: (``repro_torch.core.tracing``), shared with every engine and
        #: store; None records nothing
        self.tracer = tracer
        #: pod layout (repro_torch.meshserve.MeshPlacement): one slice of
        #: the world's ranks per instance, and the (possibly
        #: heterogeneous) InstanceSpecs the views expose.  ``None`` runs
        #: every engine whole on ``device``.
        self.mesh = mesh
        if mesh is not None and mesh.n_instances != n_instances:
            raise ValueError(
                f"mesh placement has {mesh.n_instances} slices for "
                f"{n_instances} instances")
        #: per-instance hardware spec visible through the policy views
        #: (``InstanceView.spec()``); None where nothing was declared
        self.instance_specs: List[Optional[object]] = [
            mesh.spec_for(i) if mesh is not None else None
            for i in range(n_instances)]
        # join events build replacement engines with the original shape,
        # on the cluster's device
        self._engine_kwargs = dict(
            num_slots=num_slots, kv_capacity=kv_capacity,
            temperature=temperature, eos_token=eos_token,
            block_lines=block_lines, prefix_cache=prefix_cache,
            prefix_cache_blocks=prefix_cache_blocks, device=device,
            tracer=tracer)
        self.engines = [
            InstanceEngine(cfg, params, instance_id=i,
                           mesh=mesh.slice_for(i) if mesh is not None
                           else None, **self._engine_kwargs)
            for i in range(n_instances)
        ]
        #: fleet state per instance index (repro_torch.fleet); dead
        #: engines stay in the list so indices remain stable
        self.alive: List[bool] = [True] * n_instances
        self.draining: List[bool] = [False] * n_instances
        #: partial-failure state (repro_torch.fleet DegradeInstance):
        #: modeled compute slowdown factor (1.0 = nominal) and link
        #: slowdown for transfers touching this instance
        self.degrade: List[float] = [1.0] * n_instances
        self.link_degrade: List[float] = [1.0] * n_instances
        #: health EWMA the policy views expose — THE shared arithmetic
        #: (repro_torch.scheduling.views.step_health), updated once per
        #: scheduling iteration for every alive instance, as in the JAX
        #: package, so hedging decisions replay identically
        self.health: List[float] = [1.0] * n_instances
        #: optional calibrated injection: each decode dispatch on a
        #: degraded instance sleeps (factor - 1) * this many wall seconds,
        #: making the slowdown physically observable.  0.0 (default)
        #: keeps the tests and the golden traces timing-free.
        self.degrade_dispatch_s = degrade_dispatch_s
        #: admission control: reject new arrivals once the backlog holds
        #: this many requests (None = unbounded), and shed queued
        #: requests whose wait already exceeds this many iterations
        #: (None = never) — a request that cannot meet its TTFT deadline
        #: is refused early instead of serving dead-on-arrival work
        self.max_queue = max_queue
        self.shed_deadline = shed_deadline
        self.shed: List[Request] = []
        self.aborted: List[Request] = []
        self.fleet = fleet
        self.queue: List[Tuple[Request, Optional[dict]]] = []
        self._pending: List[List[Tuple[Request, Optional[dict]]]] = [
            [] for _ in range(n_instances)]
        #: shared step planner: buckets/chunks prefill work and enforces
        #: the policy's phase-mixing contract (§4.2.3).  No max_bucket
        #: clamp — plans must match the simulator's bit for bit; the
        #: engine clamps scratch to its cache window at execution time.
        self.planner = Planner.for_policy(policy)
        # the live executor runs plans, it never prices them: skip the
        # per-iteration decode ledger summaries unless a trace wants them
        self.planner.decode_details = False
        #: fused decode ceiling: >1 lets idle open-loop stretches run up
        #: to N decode iterations as one jitted scan (the planner still
        #: keeps mirror-bound decode at one step per MirrorSync)
        self.planner.max_fuse_steps = max(1, fuse_decode_steps)
        #: iterations until the next source arrival (set by run();
        #: fusing never runs past an admission point)
        self._arrival_horizon: Optional[int] = None
        #: run() is pumping a closed-loop source (refills fire on
        #: completions, which bound fusing when EOS makes them
        #: unforeseeable)
        self._closed_loop = False
        if not self.engines[0].supports_chunked_prefill:
            # recurrent/enc-dec/modality stacks cannot resume a prompt
            # mid-chunk (state continuation is not implemented): the
            # chunk budget degrades to a whole-prompt admission
            # throttle instead of crashing mid-serve
            self.planner.chunk_execution = False
        #: per-instance requests mid-chunked-prefill (slot held, cursor
        #: tracked by the planner)
        self._chunking: List[List[Request]] = [[] for _ in range(n_instances)]
        self._extras: Dict[int, Optional[dict]] = {}
        self.placements: Dict[int, Placement] = {}
        self._reqs: Dict[int, Request] = {}
        self.clock = IterationClock()
        self.finished: List[Request] = []
        self._submitted: List[Request] = []
        self.undelivered = 0     # source requests never admitted (max_steps)
        self.timeline: List[TimelinePoint] = []
        #: sample the timeline every N scheduling iterations (1 = every
        #: iteration) — same knob as the simulator's, so a million-step
        #: replay keeps O(n/stride) observability memory
        self.timeline_stride = max(1, timeline_stride)
        #: wall-clock seconds spent in scheduling decisions (policy +
        #: planner), excluding engine execution — the live counterpart
        #: of ``Simulator.sched_time_s``
        self.sched_time_s = 0.0
        self.n_iterations = 0
        self._sched_t0: Optional[float] = None
        self.stats = {"prefills": 0, "decode_steps": 0, "rebalances": 0,
                      "replica_promotions": 0, "replica_evictions": 0,
                      "mirror_syncs": 0, "mirror_bytes": 0.0,
                      "stream_bytes": 0.0, "evicted_blocks": 0,
                      "prefix_hits": 0, "prefix_hit_tokens": 0,
                      "stream_skipped_lines": 0,
                      "sheds": 0, "aborts": 0, "hedges": 0,
                      "pressure_aborts": 0}

    @property
    def now(self) -> float:
        return self.clock.now

    @property
    def sched_us_per_iter(self) -> float:
        """Mean scheduler overhead per iteration, microseconds."""
        return self.sched_time_s * 1e6 / max(1, self.n_iterations)

    def _sched_begin(self):
        if self.tracer is not None:
            self.tracer.begin("cluster.schedule")
        self._sched_t0 = time.perf_counter()

    def _sched_end(self):
        if self._sched_t0 is not None:
            self.sched_time_s += time.perf_counter() - self._sched_t0
            self._sched_t0 = None
            if self.tracer is not None:
                self.tracer.end("cluster.schedule")

    # -- submission -----------------------------------------------------------
    def submit(self, req: Request, extra: Optional[dict] = None, *,
               stamp_arrival: bool = True):
        """Enqueue a request.  Open-loop sources pass
        ``stamp_arrival=False`` to preserve the traffic layer's arrival
        time (which may fall between scheduling iterations)."""
        if stamp_arrival:
            req.arrival = self.now
        if self.tracer is not None:
            self.tracer.stamp(req.rid, "submit")
        if extra is None:
            extra = req.extra
        if any(r.rid == req.rid for r in self._submitted
               if r.finish_time is None
               and r.phase not in (Phase.SHED, Phase.ABORTED)):
            # placements/_reqs are keyed by rid; mixing source streams
            # (rids 0,1,...) with hand-built Requests (global counter)
            # must fail loudly, not corrupt another live request's state
            raise ValueError(f"request id {req.rid} is already in flight")
        self._submitted.append(req)
        if self.max_queue is not None \
                and self.backlog_depth() >= self.max_queue:
            # bounded admission: a full backlog sheds the arrival at the
            # door (a deliberate, counted SLO miss — not a silent drop)
            self._shed(req)
            return
        self.queue.append((req, extra))

    def backlog_depth(self) -> int:
        """Requests accepted but not yet fully prefilled — the admission
        queue the ``max_queue`` bound applies to.  Mid-chunk prompts
        count (the simulator keeps them in ``prefill_queue`` until the
        final chunk, so both backends bound the same quantity)."""
        return (len(self.queue) + sum(len(p) for p in self._pending)
                + sum(len(c) for c in self._chunking))

    def _shed(self, req: Request):
        req.phase = Phase.SHED
        self.shed.append(req)
        self._extras.pop(req.rid, None)
        self.stats["sheds"] += 1
        ctrl = self._fleet_ctrl()
        ctrl.note("shed", req.rid)
        ctrl.stats["sheds"] += 1

    def _shed_overdue(self):
        """Deadline-aware shedding: queued requests whose wait already
        exceeds ``shed_deadline`` iterations cannot meet their TTFT SLO
        — refuse them now rather than burn prefill compute on
        dead-on-arrival work.  Requests mid-chunk are executing and are
        never shed."""
        deadline = self.shed_deadline
        keep: List[Tuple[Request, Optional[dict]]] = []
        for req, extra in self.queue:
            if self.now - req.arrival > deadline:
                self._shed(req)
            else:
                keep.append((req, extra))
        self.queue = keep
        for idx, pending in enumerate(self._pending):
            if not pending:
                continue
            keep = []
            for req, extra in pending:
                if (self.now - req.arrival > deadline
                        and self.planner.cursor(req.rid) == 0):
                    if req.prefix_hit is not None:
                        self.engines[idx].prefix_abandon(req)
                    self._shed(req)
                else:
                    keep.append((req, extra))
            self._pending[idx] = keep

    # -- abort lifecycle ------------------------------------------------------
    def abort(self, rid: int) -> Optional[Request]:
        """Cancel ``rid`` wherever it is in its lifecycle — queued,
        routed, mid prefill chunk, or decoding — and tear down all of
        its serving state: ledger blocks freed, prefix pin dropped,
        replica released on the mirror, planner cursor forgotten.  The
        request record survives with ``Phase.ABORTED`` so metrics count
        it.  Returns the request, or None if ``rid`` is unknown."""
        found: Optional[Request] = None
        keep: List[Tuple[Request, Optional[dict]]] = []
        for req, extra in self.queue:
            if req.rid == rid:
                found = req
            else:
                keep.append((req, extra))
        self.queue = keep
        for idx, pending in enumerate(self._pending):
            keep = []
            for req, extra in pending:
                if req.rid == rid:
                    found = req
                    if req.prefix_hit is not None:
                        self.engines[idx].prefix_abandon(req)
                else:
                    keep.append((req, extra))
            self._pending[idx] = keep
        for idx, chunking in enumerate(self._chunking):
            for req in list(chunking):
                if req.rid != rid:
                    continue
                found = req
                chunking.remove(req)
                eng = self.engines[idx]
                for slot, r in list(eng.prefilling.items()):
                    if r.rid == rid:
                        eng.release(slot)
                if req.prefix_hit is not None:
                    eng.prefix_abandon(req)
        pl = self.placements.pop(rid, None)
        if pl is not None:
            p_idx, p_slot = pl.primary
            eng = self.engines[p_idx]
            req = eng.slot_req.get(p_slot)
            if req is not None and req.rid == rid:
                found = req
                eng.release(p_slot)
            if pl.replica is not None:
                r_idx, r_slot = pl.replica
                self.engines[r_idx].release(r_slot)
        found = self._reqs.pop(rid, found) or found
        self._extras.pop(rid, None)
        self.planner.forget(rid)
        if found is not None:
            found.phase = Phase.ABORTED
            self.aborted.append(found)
            self.stats["aborts"] += 1
            ctrl = self._fleet_ctrl()
            ctrl.note("abort", rid)
            ctrl.stats["aborts"] += 1
        return found

    # -- decode fusing --------------------------------------------------------
    def _fuse_budget(self) -> int:
        """Iterations of decode the planner may fuse this step: only
        idle open-loop stretches qualify — no queued/pending/mid-chunk
        prefill work anywhere (a role could flip), capped by the arrival
        horizon and by the shortest remaining token budget (so a fused
        block ends exactly when its first request completes and
        finish-time stamps stay iteration-exact).  Per-instance
        mirror-bound exclusion lives in ``Planner._fuse_steps``."""
        n = self.planner.max_fuse_steps
        if n <= 1:
            return 1
        if self.queue or any(self._pending) or any(self._chunking):
            return 1
        # one shared iteration clock: if ANY request is mirrored, every
        # instance stays at one step per iteration — otherwise a clean
        # instance would fuse ahead while its mirror-bound pair ticks
        # per-step, and the two would disagree about what "now" means
        if any(pl.replica is not None for pl in self.placements.values()):
            return 1
        # closed-loop refills fire on completions; the budget cap makes
        # those predictable EXCEPT when an eos_token can end a request
        # mid-span — then a fused block would idle the freed slot until
        # span end, delaying the replacement request vs per-step decode
        if self._closed_loop and self.engines[0].eos_token is not None:
            return 1
        if self._arrival_horizon is not None:
            n = min(n, self._arrival_horizon)
        if self.fleet is not None:
            # a fused span must not scan past a scheduled fleet event
            nxt = self.fleet.next_time()
            if nxt is not None:
                n = min(n, max(1, math.ceil(nxt - self.now)))
        rem = [r.max_new_tokens - r.generated
               for r in self._reqs.values() if r.phase is Phase.DECODE]
        if rem:
            n = min(n, min(rem))
        return max(1, n)

    # -- one scheduling iteration ---------------------------------------------
    @traced("cluster.step")
    def step(self):
        self.clock.tick()
        # fleet events apply between scheduler iterations: the view the
        # policy reads below already reflects kills/joins/drains
        if self.fleet is not None:
            for ev in self.fleet.due(self.now):
                self._apply_fleet_event(ev)
        if any(self.draining):
            self._settle_drains()
        # health EWMA: one update per alive instance per iteration, the
        # same cadence the simulator uses, so hedging decisions gated on
        # health replay bit-identically on both backends
        for i in range(len(self.engines)):
            if self.alive[i]:
                self.health[i] = step_health(self.health[i],
                                             self.degrade[i])
        if self.shed_deadline is not None:
            self._shed_overdue()
        if self.planner.max_fuse_steps > 1:
            self.planner.fuse_horizon = self._fuse_budget()
        view = LiveClusterView(self)

        # scheduling decisions (routing, roles, admission, plan compile)
        # are timed; engine execution below is not — the same split the
        # simulator's sched_us_per_iter uses
        self._sched_begin()

        # 1. routing: policy assigns queued requests to instances
        admitted = 0
        limit = self.policy.admissions_per_step(view)
        while self.queue and admitted < limit:
            req, extra = self.queue[0]
            target = self.policy.route(view, req)
            if target is None:
                break
            self.queue.pop(0)
            self._pending[target].append((req, extra))
            admitted += 1

        # 2. roles -> declarative step actions; the planner compiles them
        # into per-instance plans (bucketing, chunk cursors, and the
        # §4.2.3 no-mixing invariant all live there, not here)
        roles = {i: (self.policy.choose_roles(view, i) if self.alive[i]
                     else ROLE_IDLE)
                 for i in range(len(self.engines))}
        actions: List[Action] = []
        taken_now: Dict[int, List[Tuple[Request, Optional[dict]]]] = {}
        for idx, eng in enumerate(self.engines):
            if not self.alive[idx]:
                continue
            pf_actions: List[Action] = []
            if roles[idx] in (ROLE_PREFILL, ROLE_MIXED):
                for req in self._chunking[idx]:
                    pf_actions.append(Prefill(req.rid, idx, req.prompt_len,
                                              req=req))
                if self._pending[idx]:
                    n = self.policy.prefill_batch(
                        view, idx, [r for r, _ in self._pending[idx]])
                    for _ in range(n):
                        if not self._pending[idx]:
                            break
                        req, extra = self._pending[idx][0]
                        # everyone admitted this iteration takes a slot
                        # at execution, so capacity is free MINUS the
                        # batch so far; an eviction can free one and a
                        # prefix-cache pin can wall off a slot region
                        # mid-loop, so re-count every admission rather
                        # than trusting n
                        taken = len(taken_now.get(idx, ()))
                        if len(eng.free_slots()) <= taken:
                            for act in self.policy.evict(
                                    view, [view.instances()[idx]]):
                                self._apply(act)
                        if len(eng.free_slots()) <= taken:
                            break
                        hit = 0
                        if eng.prefix_cache is not None:
                            hit = eng.prefix_stamp(req)
                            if hit and len(eng.free_slots()) <= taken:
                                # the pin froze the last free slot's
                                # region: admit without the hit instead
                                # of overcommitting the batch
                                eng.prefix_abandon(req)
                                hit = 0
                        if hit:
                            self.stats["prefix_hits"] += 1
                            self.stats["prefix_hit_tokens"] += hit
                        self._pending[idx].pop(0)
                        taken_now.setdefault(idx, []).append((req, extra))
                        self._extras[req.rid] = extra
                        pf_actions.append(Prefill(req.rid, idx,
                                                  req.prompt_len, req=req))
            actions.extend(pf_actions)
            # an instance only forgoes decode when it actually prefills
            # under an exclusive-prefill role (§4.2.3); the decode batch
            # membership is resolved at execution time — a request
            # streamed in after prefill decodes this same iteration
            if roles[idx] != ROLE_PREFILL or not pf_actions:
                actions.append(Decode(idx))
        plans = self.planner.compile(actions, view)
        self._sched_end()

        # chunk budget may not have reached every admitted request this
        # iteration: return the unplanned ones to the head of the backlog
        planned_rids = set()
        for plan in plans:
            pf = prefill_part(plan)
            if pf is not None:
                planned_rids.update(it.rid for it in pf.items)
        for idx, taken in taken_now.items():
            unplanned = [(r, e) for r, e in taken
                         if r.rid not in planned_rids]
            if unplanned:
                self._pending[idx][:0] = unplanned

        # 3. execute the plans in the executor's phase order: all
        # prefills, then post-prefill placement, then all decodes — so a
        # request streamed to its decode primary still joins that
        # instance's decode batch within the same iteration
        prefilled = set()
        decoded = set()
        newly: List[Tuple[int, Request]] = []
        for plan in plans:
            pf = prefill_part(plan)
            if pf is not None:
                with span(self.tracer, "cluster.prefill"):
                    self._execute_prefill(pf, newly, prefilled)

        # 4. post-prefill placement (§4.1.2 streaming / Splitwise
        # transfer), wrapped into transfer plans
        for idx, req in newly:
            self._sched_begin()
            try:
                acts = self.policy.place_after_prefill(view, idx, req)
            finally:
                self._sched_end()
            self._apply_transfers(acts, view)

        ran_steps = 1
        for plan in plans:
            dc = decode_part(plan)
            if dc is None or not self.engines[dc.instance].slot_req:
                continue
            eng = self.engines[dc.instance]
            # graceful-degradation ladder (§4.2.5) before the step can
            # allocate: evict replicas, then abort least-progress work
            with span(self.tracer, "cluster.relieve"):
                self._relieve_pressure(dc.instance, view)
            if not eng.slot_req:
                continue
            if self.degrade_dispatch_s > 0.0 \
                    and self.degrade[dc.instance] > 1.0:
                # calibrated physical injection: a degraded instance's
                # dispatch really takes (factor - 1) x the knob longer
                time.sleep((self.degrade[dc.instance] - 1.0)
                           * self.degrade_dispatch_s)
            live = {s: eng.slot_req[s] for s in eng.active_slots()}
            out = eng.decode_multi(dc)
            if out:
                # account the span actually executed: EOS can end a
                # fused block before dc.steps (the budget cap cannot
                # foresee a sampled eos_token)
                ran = max(len(toks) for toks in out.values())
                self.stats["decode_steps"] += ran
                ran_steps = max(ran_steps, ran)
                decoded.add(dc.instance)
            for slot, toks in out.items():
                req = live[slot]
                for j in range(len(toks)):
                    req.token_times.append(self.now + j)
                if req.phase is Phase.DONE and self.tracer is not None:
                    self.tracer.stamp(req.rid, "done")
                if (dc.steps > 1 and req.phase is Phase.DONE
                        and req.finish_time is None):
                    # died mid-span (EOS): stamp the iteration it really
                    # finished, not the end of the fused block
                    req.finish_time = self.now + len(toks) - 1
                    self.finished.append(req)
        if ran_steps > 1:
            # a fused block IS ran_steps scheduling iterations: advance
            # the clock so latencies stay comparable to per-step decode
            self.clock.tick(ran_steps - 1)

        # 5. release placements of finished requests
        with span(self.tracer, "cluster.release"):
            self._release_finished()

        # 6. mirror newly generated lines into replicas (§4.1.2)
        self._sched_begin()
        try:
            sync_acts = self.policy.sync(view)
        finally:
            self._sched_end()
        self._apply_transfers(sync_acts, view)

        # 7. pair-level load balancing via replica promotion (§4.1.3)
        if self.policy.requires_pairs:
            for pair_index in range(len(self.engines) // 2):
                self._sched_begin()
                try:
                    acts = self.policy.rebalance(view, pair_index)
                finally:
                    self._sched_end()
                self._apply_transfers(acts, view)
                if acts:
                    self.stats["rebalances"] += 1

        # 8. policies that re-route every iteration reclaim their backlog
        if self.policy.requeue_unplaced:
            stranded = [item for pending in self._pending for item in pending]
            if stranded:
                # a stamped hit is instance-local: releasing the backlog
                # for re-routing must drop the pin (it re-stamps wherever
                # it lands next iteration)
                for idx, pending in enumerate(self._pending):
                    for req, _ in pending:
                        if req.prefix_hit is not None:
                            self.engines[idx].prefix_abandon(req)
                    pending.clear()
                self.queue[:0] = stranded

        # 9. observability: queue depth + per-phase utilization this iteration
        # (a fused block IS ran_steps scheduling iterations: the one
        # scheduling pass amortizes over all of them)
        self.n_iterations += ran_steps
        if (self.n_iterations - 1) % self.timeline_stride >= ran_steps:
            return
        n = len(self.engines)
        busy = prefilled | decoded
        self.timeline.append(TimelinePoint(
            t=self.now,
            # mid-chunk prompts count as queued (the simulator keeps
            # them in prefill_queue until the final chunk, so the two
            # backends report comparable queue depths under chunking)
            queue_depth=(len(self.queue) + sum(len(p) for p in self._pending)
                         + sum(len(c) for c in self._chunking)),
            n_prefill=len(prefilled),
            n_decode=len(decoded - prefilled),
            n_idle=n - len(busy)))

    # -- fleet mechanics (repro_torch.fleet) ---------------------------------
    def _fleet_ctrl(self) -> "FleetController":
        if self.fleet is None:
            # direct-driven fleet ops (tests, interactive kills) still
            # need the shared decision planner + trace/stats home
            from repro_torch.fleet import FleetController
            self.fleet = FleetController()
        return self.fleet

    def _apply_fleet_event(self, ev):
        from repro_torch.fleet import (DegradeInstance, Drain, JoinInstance,
                                 KillInstance, RecoverInstance)
        if isinstance(ev, KillInstance):
            self.fleet_kill(ev.instance)
        elif isinstance(ev, JoinInstance):
            self.fleet_join(ev.instance)
        elif isinstance(ev, Drain):
            self.fleet_drain(ev.instance)
        elif isinstance(ev, DegradeInstance):
            self.fleet_degrade(ev.instance, ev.factor, ev.link_factor)
        elif isinstance(ev, RecoverInstance):
            self.fleet_recover(ev.instance)
        else:
            raise ValueError(f"unknown fleet event {ev!r}")

    def fleet_degrade(self, instance: int, factor: float = 4.0,
                      link_factor: float = 1.0):
        """Partial failure: the instance keeps serving but ``factor``x
        slower (thermal throttling, a flapping NIC, a noisy neighbor).
        Nothing is torn down — the health EWMA drifts up and hedging
        kernels route decode around it."""
        if instance >= len(self.engines) or not self.alive[instance]:
            return
        self.degrade[instance] = float(factor)
        self.link_degrade[instance] = float(link_factor)
        ctrl = self._fleet_ctrl()
        ctrl.note("degrade", instance, float(factor), float(link_factor))
        ctrl.stats["degrades"] += 1

    def fleet_recover(self, instance: int):
        """The degraded instance returns to nominal speed; its health
        EWMA decays back under the hedge threshold over the next
        iterations."""
        if instance >= len(self.engines) or not self.alive[instance]:
            return
        self.degrade[instance] = 1.0
        self.link_degrade[instance] = 1.0
        ctrl = self._fleet_ctrl()
        ctrl.note("recover", instance)
        ctrl.stats["recoveries"] += 1

    def fleet_kill(self, instance: int):
        """Abrupt instance failure: every resident byte is gone.  The
        shared controller plans what survives — primaries with a warm
        replica flip roles via the existing promotion machinery (rolled
        back to the replica's synced line); everything else re-queues
        for a full re-prefill."""
        if instance >= len(self.engines) or not self.alive[instance]:
            return
        from repro_torch.fleet import reset_for_reprefill, rollback_tokens
        ctrl = self._fleet_ctrl()
        ctrl.note("kill", instance)
        ctrl.stats["kills"] += 1
        plan = ctrl.plan_failover(LiveClusterView(self), instance)
        dead = self.engines[instance]
        # 1. promotions: the warm replica takes over at its synced line;
        # the unsynced tail of decode tokens re-generates there
        for pr in plan.promotions:
            pl = self.placements[pr.rid]
            r_idx, r_slot = pl.replica
            req = self._reqs[pr.rid]
            if pr.lost_lines:
                rollback_tokens(req, pr.lost_lines)
                ctrl.stats["lost_lines"] += pr.lost_lines
            self.engines[r_idx].promote_replica(r_slot, req)
            pl.primary = (r_idx, r_slot)
            pl.replica = None
            ctrl.note("promote", pr.rid, pr.src, pr.dst, pr.lost_lines)
            ctrl.stats["promotions"] += 1
            self.stats["replica_promotions"] += 1
        # 2. truly lost state: back to the queue head, full re-prefill
        # (original arrival stamp kept — the TTFT damage is the metric)
        requeued: List[Tuple[Request, Optional[dict]]] = []
        for rid in plan.requeues:
            req = self._reqs.pop(rid)
            ctrl.note("requeue", rid)
            ctrl.stats["requeues"] += 1
            ctrl.stats["lost_decode_tokens"] += req.generated
            ctrl.stats["reprefill_tokens"] += reset_for_reprefill(req)
            self.planner.forget(rid)
            del self.placements[rid]
            requeued.append((req, self._extras.pop(rid, req.extra)))
        # 3. replicas this instance hosted for surviving primaries
        for rid in plan.dropped_replicas:
            self.placements[rid].replica = None
            ctrl.note("drop_replica", rid)
        # 4. routed-but-unprefilled backlog re-routes (no tokens re-run)
        for req, extra in self._pending[instance]:
            ctrl.note("requeue", req.rid)
            ctrl.stats["requeue_backlog"] += 1
            requeued.append((req, extra))
        self._pending[instance] = []
        # 5. prompts mid-chunk lose their partial prefill work
        for req in self._chunking[instance]:
            ctrl.note("requeue", req.rid)
            ctrl.stats["requeues"] += 1
            ctrl.stats["reprefill_tokens"] += self.planner.cursor(req.rid)
            self.planner.forget(req.rid)
            reset_for_reprefill(req)
            requeued.append((req, self._extras.pop(req.rid, req.extra)))
        self._chunking[instance] = []
        # a stamped hit referred to the dead instance's cache; the
        # re-prefill starts clean and re-stamps wherever it lands
        for req, _ in requeued:
            if req.prefix_hit is not None:
                dead.prefix_abandon(req)
        self.queue[:0] = requeued
        # 6. teardown: free every slot; the dead engine object stays in
        # the list so instance indices remain stable.  The prefix cache
        # dies with the HBM it indexed — a rejoin at this rank starts
        # cold.
        for slot in (list(dead.slot_req) + list(dead.replica_of)
                     + list(dead.prefilling)):
            dead.release(slot)
        if dead.prefix_cache is not None:
            dead.prefix_cache.release_all()
        self.alive[instance] = False
        self.draining[instance] = False
        # partial-failure state dies with the instance: replacement
        # hardware at this rank starts nominal
        self.degrade[instance] = 1.0
        self.link_degrade[instance] = 1.0
        self.health[instance] = 1.0

    def fleet_join(self, instance: Optional[int] = None) -> int:
        """Register a fresh instance (revive a dead index, or append a
        new one with ``None``), then let the kernel warm it with
        replicas of resident requests BEFORE any new arrival routes
        there."""
        ctrl = self._fleet_ctrl()
        if instance is not None and instance < len(self.engines):
            if self.alive[instance]:
                return instance           # join of a live index: no-op
            idx = instance
            # replacement hardware at the same rank: the torn-down
            # engine (every slot freed at kill) is the fresh instance
            self.alive[idx] = True
            self.draining[idx] = False
            self.degrade[idx] = 1.0
            self.link_degrade[idx] = 1.0
            self.health[idx] = 1.0
        else:
            idx = len(self.engines)
            # an autoscaled join: a fresh engine of the original shape on
            # the cluster's device, sharing the one params tree; past the
            # carved pod it lands unsharded
            sl = self.mesh.slice_for(idx) if self.mesh is not None else None
            self.engines.append(
                InstanceEngine(self.cfg, self._params, instance_id=idx,
                               mesh=sl, **self._engine_kwargs))
            self.instance_specs.append(
                self.mesh.spec_for(idx) if self.mesh is not None else None)
            self._pending.append([])
            self._chunking.append([])
            self.alive.append(True)
            self.draining.append(False)
            self.degrade.append(1.0)
            self.link_degrade.append(1.0)
            self.health.append(1.0)
        ctrl.note("join", idx)
        ctrl.stats["joins"] += 1
        view = LiveClusterView(self)
        acts = self.policy.warm_on_join(view, idx)
        if acts:
            self._apply_transfers(acts, view)
            ctrl.stats["warm_streams"] += len(acts)
        return idx

    def fleet_drain(self, instance: int):
        """Cordon: no new work routes here (``draining`` in the views);
        the instance leaves the fleet once its residents complete."""
        if instance >= len(self.engines) or not self.alive[instance] \
                or self.draining[instance]:
            return
        ctrl = self._fleet_ctrl()
        self.draining[instance] = True
        ctrl.note("drain", instance)
        ctrl.stats["drains"] += 1
        self._settle_drains()

    def _settle_drains(self):
        for idx, draining in enumerate(self.draining):
            if not (draining and self.alive[idx]):
                continue
            eng = self.engines[idx]
            if eng.slot_req or eng.prefilling or self._pending[idx] \
                    or self._chunking[idx]:
                continue
            # only replicas remain: the primaries live elsewhere, so the
            # copies are surrendered and the instance leaves the fleet
            for slot in list(eng.replica_of):
                rid = eng.store.slot_rid[slot]
                eng.release(slot)
                pl = self.placements.get(rid)
                if pl is not None and pl.replica is not None \
                        and pl.replica[0] == idx:
                    pl.replica = None
            self.alive[idx] = False
            self.draining[idx] = False
            self._fleet_ctrl().note("drained", idx)

    # -- plan execution -------------------------------------------------------
    def _execute_prefill(self, pf: PrefillPlan,
                         newly: List[Tuple[int, Request]], prefilled: set):
        eng = self.engines[pf.instance]
        completed = eng.prefill_batch(pf, extras=self._extras)
        # chunk bookkeeping: items still mid-prompt hold their slots
        self._chunking[pf.instance] = [it.req for it in pf.items
                                       if it.rid not in completed]
        prefilled.add(pf.instance)
        for it in pf.items:
            slot = completed.get(it.rid)
            if slot is None:
                continue
            req = it.req
            self._extras.pop(req.rid, None)
            # engines may complete ahead of the cursor (whole-prompt
            # degrade for non-chunkable prompts): drop any stale cursor
            self.planner.forget(req.rid)
            req.first_token_time = self.now
            req.token_times.append(self.now)
            self.placements[req.rid] = Placement(primary=(pf.instance, slot))
            self._reqs[req.rid] = req
            self.stats["prefills"] += 1
            if req.done:          # degenerate max_new_tokens == 1
                req.phase = Phase.DONE
                eng.release(slot)
                if self.tracer is not None:
                    self.tracer.stamp(req.rid, "done")
                continue
            newly.append((pf.instance, req))

    def _apply_transfers(self, acts: List[Action], view):
        """Execute policy-emitted movement actions.  The live backend
        moves real bytes, so it applies the actions directly; only the
        simulator needs them wrapped into priced ``TransferPlan``s
        (``Planner._wrap_transfer``) — wrapping here would rebuild the
        per-request ledger dicts every mirror step for a result the
        executor never reads."""
        for act in acts:
            self._apply(act)

    # -- action interpreter ---------------------------------------------------
    def _apply(self, act: Action):
        if isinstance(act, StreamState):
            self._apply_stream(act)
        elif isinstance(act, MirrorSync):
            self._apply_mirror(act)
        elif isinstance(act, PromoteReplica):
            self._apply_promote(act)
        elif isinstance(act, EvictReplica):
            self._apply_evict(act)
        elif isinstance(act, AbortRequest):
            self.abort(act.rid)
        else:
            raise ValueError(f"live executor cannot apply {act!r}")

    @traced("kv.stream")
    def _apply_stream(self, act: StreamState):
        pl = self.placements.get(act.rid)
        if pl is None or pl.primary[0] != act.src:
            return
        if not self.alive[act.dst] or self.draining[act.dst]:
            return                       # destination left the fleet
        src_idx, src_slot = pl.primary
        src = self.engines[src_idx]
        dst = self.engines[act.dst]
        with span(self.tracer, "kv.stream.slot"):
            free = dst.free_slots()
        if not free:
            return                       # capacity raced away; stay put
        dst_slot = free[0]
        req = src.slot_req[src_slot]
        # per-layer streamed transfer (§4.2.4): the state moves one
        # layer chunk at a time — the unit a mesh overlaps with prefill
        chunks, length, last_tok, lines = src.export_stream(src_slot)
        if act.as_replica:
            # primary stays at src; dst hosts a redundant copy
            dst.import_stream(dst_slot, chunks, length, last_tok, lines,
                              req, as_replica_of=(src.instance_id, src_slot))
            pl.replica = (act.dst, dst_slot)
        else:
            dst.import_stream(dst_slot, chunks, length, last_tok, lines, req)
            if act.retain_replica:
                src.demote_to_replica(src_slot,
                                      of=(dst.instance_id, dst_slot))
                pl.replica = (src_idx, src_slot)
            else:
                src.release(src_slot)
            pl.primary = (act.dst, dst_slot)
        # head lines already resident in dst's prefix cache are adopted,
        # not moved: charge only the unique suffix (planner prices the
        # same subtraction via StreamState.skip_lines)
        skip = min(lines, dst.store.shared_head_lines(act.rid))
        self.stats["stream_skipped_lines"] += skip
        self.stats["stream_bytes"] += (src.store.costs.bytes_at(lines)
                                       - skip * src.store.costs.line_bytes)

    @traced("kv.mirror")
    def _apply_mirror(self, act: MirrorSync):
        pl = self.placements.get(act.rid)
        if pl is None or pl.replica is None:
            return
        p_idx, p_slot = pl.primary
        r_idx, r_slot = pl.replica
        src = self.engines[p_idx]
        if p_slot not in src.slot_req:
            return
        moved = self.engines[r_idx].sync_replica_from(
            src, p_slot, r_slot, from_line=act.from_line,
            to_line=act.to_line)
        self.stats["mirror_syncs"] += 1
        self.stats["mirror_bytes"] += moved

    @traced("kv.promote")
    def _apply_promote(self, act: PromoteReplica):
        pl = self.placements.get(act.rid)
        if pl is None or pl.replica is None or pl.primary[0] != act.src:
            return
        p_idx, p_slot = pl.primary
        r_idx, r_slot = pl.replica
        src = self.engines[p_idx]
        dst = self.engines[r_idx]
        req = src.slot_req[p_slot]
        # executor backstop for the kernel's catch-up contract: a stale
        # replica must absorb the unsynced tail before taking the
        # primary role — promotion itself moves no bytes
        if dst.store.synced_line(req.rid) < src.store.lines(req.rid):
            moved = dst.sync_replica_from(src, p_slot, r_slot)
            self.stats["mirror_syncs"] += 1
            self.stats["mirror_bytes"] += moved
        # zero-cost migration: promote replica, demote primary
        dst.promote_replica(r_slot, req)
        src.demote_to_replica(p_slot, of=(dst.instance_id, r_slot))
        pl.primary = (r_idx, r_slot)
        pl.replica = (p_idx, p_slot)
        self.stats["replica_promotions"] += 1
        if act.hedge:
            # straggler hedge, not a load-balance flip: counted apart so
            # reports can tell redundancy-as-insurance from rebalancing
            self.stats["hedges"] += 1
            if self.fleet is not None:
                self.fleet.stats["hedges"] += 1

    def _relieve_pressure(self, idx: int, view):
        """KV-pressure relief ladder (AcceLLM §4.2.5): before a decode
        step, make sure the block pool can absorb one new line per
        resident primary.  Rung 1 drops replicas hosted here (redundancy
        is insurance, not an entitlement); rung 2 aborts the
        least-progressed primaries — a deliberate, counted casualty
        instead of an allocation failure mid-step."""
        eng = self.engines[idx]
        store = eng.store

        def shortfall() -> int:
            need = sum(1 for req in eng.slot_req.values()
                       if store.lines(req.rid) % store.block_lines == 0)
            return need - store.free_blocks()

        if shortfall() <= 0:
            return
        iv = view.instances()[idx]
        while shortfall() > 0 and eng.replica_of:
            before = len(eng.replica_of)
            for act in self.policy.evict(view, [iv]):
                self._apply(act)
            if len(eng.replica_of) == before:
                # the policy won't name a victim: drop the heaviest
                # replica directly rather than fail the decode step
                slot = max(eng.replica_of,
                           key=lambda s: store.used_bytes_of(
                               store.slot_rid[s]))
                rid = store.slot_rid[slot]
                freed = eng.release(slot)
                pl = self.placements.get(rid)
                if pl is not None and pl.replica is not None \
                        and pl.replica[0] == idx:
                    pl.replica = None
                self.stats["replica_evictions"] += 1
                self.stats["evicted_blocks"] += freed
        while shortfall() > 0 and len(eng.slot_req) > 1:
            victim = min(eng.slot_req.values(),
                         key=lambda r: (r.generated, r.rid))
            self.abort(victim.rid)
            self.stats["pressure_aborts"] += 1

    def _apply_evict(self, act: EvictReplica):
        pl = self.placements.get(act.rid)
        if pl is None or pl.replica is None or pl.replica[0] != act.instance:
            return
        r_idx, r_slot = pl.replica
        freed = self.engines[r_idx].release(r_slot)
        pl.replica = None
        self.stats["replica_evictions"] += 1
        self.stats["evicted_blocks"] += freed

    # -- bookkeeping ----------------------------------------------------------
    def _release_finished(self):
        for rid, pl in list(self.placements.items()):
            p_idx, p_slot = pl.primary
            req = self.engines[p_idx].slot_req.get(p_slot)
            if req is None or req.rid != rid:     # finished & released
                if pl.replica is not None:
                    r_idx, r_slot = pl.replica
                    self.engines[r_idx].release(r_slot)
                del self.placements[rid]
                self._reqs.pop(rid, None)

    # -- driver ---------------------------------------------------------------
    def pending(self) -> int:
        live = len(self.queue) + len(self.placements)
        live += sum(len(p) for p in self._pending)
        live += sum(len(c) for c in self._chunking)
        return live

    def run(self, max_steps: int = 10_000,
            source: Optional[RequestSource] = None) -> List[Request]:
        """Drive the cluster to completion.

        Without a ``source`` this is the classic closed-batch driver over
        previously :meth:`submit`-ted requests.  With a ``source`` the
        lifecycle is **open-loop**: each iteration first admits every
        request whose arrival stamp is due on the iteration clock (one
        traffic time unit == one iteration), idling through gaps between
        arrivals.  Closed-loop sources (``source.concurrency`` set)
        instead keep that many requests in flight, issuing the next one
        the moment a previous one finishes.
        """
        it = iter(source) if source is not None else None
        concurrency = source.concurrency if source is not None else None
        self._closed_loop = bool(concurrency)
        exhausted = it is None
        next_req: Optional[Request] = None
        issued = 0
        steps = 0
        while steps < max_steps:
            if it is not None and not exhausted:
                if concurrency:
                    # closed loop: top in-flight back up to `concurrency`
                    # (shed and aborted requests are terminal, not in
                    # flight — they must not wedge the pump)
                    while (len(self._submitted) - len(self.finished)
                           - len(self.shed) - len(self.aborted)
                           < concurrency):
                        req = next(it, None)
                        if req is None:
                            exhausted = True
                            break
                        self.submit(req)
                        issued += 1
                else:
                    # open loop: admit everything due by the current clock
                    while True:
                        if next_req is None:
                            next_req = next(it, None)
                            if next_req is None:
                                exhausted = True
                                break
                        if next_req.arrival > self.now:
                            break
                        self.submit(next_req, stamp_arrival=False)
                        issued += 1
                        next_req = None
                    # fusing may not run past the next admission point
                    self._arrival_horizon = (
                        None if next_req is None
                        else max(1, math.ceil(next_req.arrival - self.now)))
            if exhausted and not self.pending():
                break
            self.step()
            # stamp finish times for anything that completed this iteration
            # (including requests that finish in their very first step)
            for req in self._submitted:
                if req.phase is Phase.DONE and req.finish_time is None:
                    req.finish_time = self.now
                    self.finished.append(req)
            steps += 1
        if not exhausted:
            # max_steps elapsed with traffic still in the source: count the
            # requests that were never even offered, so reports can't claim
            # a healthy run over a silently truncated stream.  Count on a
            # token-free replay of the stream (same spec + seed, no cfg)
            # rather than draining `it`, which would materialize prompt
            # arrays and modality extras just to throw them away.
            total = sum(1 for _ in source.spec.source(seed=source.seed))
            self.undelivered += total - issued
        return self.finished
