"""Array-backed cluster state: the simulator's hot-path accounting as a
numpy struct-of-arrays (ROADMAP "Beat the scheduler at scale").

The dict-backed views in ``repro_torch.sim.policies`` recompute every
byte sum and per-request mapping with interpreted Python on every
scheduling decision — O(residents) attribute walks per ``mem_free()``, per
``decode_weights()``, per ``request_lines()``.  At production arrival
rates the scheduler, not the accelerator, becomes the bottleneck.

``ArrayClusterState`` keeps the same quantities as incremental arrays:

  * **global request arrays** indexed by rid — ``req_prompt``,
    ``req_gen``, ``req_max_new`` (int64) and ``req_replica`` (int32, -1
    = unmirrored) mirror each ``SimRequest``'s fields and the adapter's
    placement ledger.  They are synced when a request enters a container
    and advanced in bulk by the simulator's decode hook, so a per-token
    loop never touches them one rid at a time.
  * **per-instance role caches** — the rid-sorted member array of each
    decode batch / replica set, its length vector
    (``req_prompt[rids] + req_gen[rids]``), and the byte aggregates
    derived from it.  Membership changes mark the cache dirty (rebuilt
    once, in C, at the next read); token growth only bumps a version
    counter and re-vectorizes the length vector.

Coherence is by *interception*, not by convention: at attach time every
``SimInstance.decode_batch`` / ``replicas`` / ``prefill_queue`` is
wrapped in an observing container, and ``SimInstance.__setattr__``
re-wraps rebinds (``inst.prefill_queue = [...]`` in the fleet paths), so
the ~30 existing mutation sites in ``repro_torch.sim`` keep working
unchanged and cannot silently desynchronize the arrays.

**Bit-identical by construction**: every byte quantity here is an exact
integer (``LineCosts.line_bytes`` and ``fixed_bytes`` are integral, see
``repro_torch.core.kvbytes``), and all sums stay far below 2**53 — so
float64 aggregates computed as ``line_bytes * lens.sum() + fixed * n``
equal the scalar views' per-request Python sums *exactly*, and every argmin /
argmax in ``repro_torch.scale.kernels`` reproduces the dict-backed
kernels' decisions bit for bit (the golden equivalence of
tests/test_scale.py, and of tests/test_torch_scale.py for this copy of
the JAX package's ``repro.scale.state``).

Scope: the array state is a **simulator** accelerator — it is attached
by ``KernelPolicy.bind`` when the kernel declares ``vectorized = True``.
On the live backend the vector kernels fall back to their scalar
superclass paths (``getattr(cluster, "arrays", None) is None``).
Chunked-prefill kernels (Sarathi) are not vectorized: the queue-token
aggregate assumes whole-prompt prefills (no resumable cursors).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.sim.cluster import SimInstance, Simulator
from repro_torch.sim.policies import SimClusterView, SimInstanceView
from repro_torch.stepplan import Planner

__all__ = ["ArrayClusterState", "ArrayClusterView", "ArrayInstanceView"]


# ---------------------------------------------------------------------------
# Observing containers: existing mutation sites keep the arrays coherent
# ---------------------------------------------------------------------------


class _ObsDict(dict):
    """A decode-batch / replica dict that reports membership changes."""

    __slots__ = ("_rec", "_role")

    def __init__(self, data, rec: "_InstRec", role: str):
        super().__init__(data)
        self._rec = rec
        self._role = role
        for rid, r in data.items():
            rec.state._sync_req(rid, r)
        rec.touch(role)

    def __setitem__(self, rid, r):
        super().__setitem__(rid, r)
        self._rec.state._sync_req(rid, r)
        self._rec.touch(self._role)

    def __delitem__(self, rid):
        super().__delitem__(rid)
        self._rec.touch(self._role)

    def pop(self, rid, *default):
        out = super().pop(rid, *default)
        self._rec.touch(self._role)
        return out

    def popitem(self):
        out = super().popitem()
        self._rec.touch(self._role)
        return out

    def clear(self):
        super().clear()
        self._rec.touch(self._role)

    def update(self, *a, **kw):
        super().update(*a, **kw)
        for rid, r in self.items():
            self._rec.state._sync_req(rid, r)
        self._rec.touch(self._role)

    def setdefault(self, rid, default=None):
        out = super().setdefault(rid, default)
        if out is default:
            self._rec.state._sync_req(rid, default)
        self._rec.touch(self._role)
        return out


class _ObsList(list):
    """A prefill queue that maintains its token aggregate.  ``append``
    (the per-arrival hot path) accounts incrementally; every other
    mutator just marks the aggregate dirty for a full recount at the
    next read — queue surgery is rare (fleet kills, compile dequeues)."""

    __slots__ = ("_rec",)

    def __init__(self, data, rec: "_InstRec"):
        super().__init__(data)
        self._rec = rec
        rec.q_dirty = True

    def append(self, r):
        super().append(r)
        rec = self._rec
        if not rec.q_dirty:
            rec.q_tokens += r.prompt_len - (getattr(r, "prefix_hit", 0) or 0)

    def _dirty(self):
        self._rec.q_dirty = True

    def extend(self, it):
        super().extend(it)
        self._dirty()

    def insert(self, i, r):
        super().insert(i, r)
        self._dirty()

    def pop(self, *a):
        out = super().pop(*a)
        self._dirty()
        return out

    def remove(self, r):
        super().remove(r)
        self._dirty()

    def clear(self):
        super().clear()
        self._dirty()

    def __setitem__(self, i, v):
        super().__setitem__(i, v)
        self._dirty()

    def __delitem__(self, i):
        super().__delitem__(i)
        self._dirty()

    def __iadd__(self, it):
        out = super().__iadd__(it)
        self._dirty()
        return out

    def sort(self, *a, **kw):
        super().sort(*a, **kw)
        self._dirty()

    def reverse(self):
        super().reverse()
        self._dirty()


class _ObsPlacement(dict):
    """The adapter's placement ledger, mirroring each rid's replica
    instance into ``req_replica`` (for vectorized mirrored counts)."""

    __slots__ = ("_state",)

    def __init__(self, data, state: "ArrayClusterState"):
        super().__init__(data)
        self._state = state
        for rid, pl in data.items():
            state._sync_replica(rid, pl[1])

    def __setitem__(self, rid, pl):
        super().__setitem__(rid, pl)
        self._state._sync_replica(rid, pl[1])

    def __delitem__(self, rid):
        super().__delitem__(rid)
        self._state._sync_replica(rid, None)

    def pop(self, rid, *default):
        out = super().pop(rid, *default)
        self._state._sync_replica(rid, None)
        return out

    def clear(self):
        for rid in self:
            self._state._sync_replica(rid, None)
        super().clear()

    def update(self, *a, **kw):
        super().update(*a, **kw)
        for rid, pl in self.items():
            self._state._sync_replica(rid, pl[1])


# ---------------------------------------------------------------------------
# Per-instance record: rid-sorted member caches + byte aggregates
# ---------------------------------------------------------------------------

_EMPTY_I64 = np.empty(0, dtype=np.int64)
_EMPTY_F64 = np.empty(0, dtype=np.float64)


class _RoleCache:
    """One role's (decode batch / replica set) cached columns.

    Validity is layered so the per-iteration decode hook never forces a
    recompute: ``mem_key`` bumps on membership rebuilds, ``key`` on any
    content change (keys the derived ``weights``), ``stale`` forces a
    full value recompute at next read, ``vecs_stale`` marks only the
    length *vector* outdated while the byte aggregates were maintained
    incrementally (the replica-side advance path), and ``agg_gen`` is
    the global value-change version the cache was computed against."""

    __slots__ = ("rids", "lens", "bytes", "rem", "key", "mem_key",
                 "agg_gen", "adv_gen", "stale", "vecs_stale",
                 "weights", "weights_key", "mirrored", "mirrored_key")

    def __init__(self):
        self.rids = _EMPTY_I64
        self.lens = _EMPTY_I64
        self.bytes = 0.0
        self.rem = 0
        self.key = 0
        self.mem_key = 0
        self.agg_gen = -1
        self.adv_gen = -1
        self.stale = True
        self.vecs_stale = False
        self.weights = _EMPTY_F64
        self.weights_key = -1
        self.mirrored = 0
        self.mirrored_key = (-1, -1)


class _InstRec:
    """Array-state record for one ``SimInstance``."""

    __slots__ = ("state", "inst", "line_bytes", "fixed_bytes", "capacity",
                 "max_batch", "prim_dirty", "rep_dirty", "prim", "rep",
                 "q_dirty", "q_tokens", "prim_muts", "muts_at_plan")

    def __init__(self, state: "ArrayClusterState", inst: SimInstance):
        self.state = state
        self.inst = inst
        costs = inst.store.costs
        self.line_bytes = float(costs.line_bytes)
        self.fixed_bytes = float(costs.fixed_bytes)
        self.capacity = float(inst.perf.kv_capacity_bytes)
        self.max_batch = inst.max_batch
        self.prim_dirty = True
        self.rep_dirty = True
        self.prim = _RoleCache()
        self.rep = _RoleCache()
        self.q_dirty = True
        self.q_tokens = 0
        # monotonic decode-batch mutation counter + its value when the
        # running plan's lengths were read: equality at decode-done
        # means membership never changed across the span, so the span's
        # survivors are exactly the cached rid array (no per-rid filter)
        self.prim_muts = 0
        self.muts_at_plan = -1

    def touch(self, role: str):
        if role == "prim":
            self.prim_dirty = True
            self.prim_muts += 1
        else:
            self.rep_dirty = True

    # -- cache refresh -------------------------------------------------------
    def _refresh(self, role: str) -> _RoleCache:
        """Aggregates (bytes / rem) current on return; the length vector
        may still be ``vecs_stale`` (use :meth:`_vectors` when it is
        read).  The fast path — nothing changed, or only incremental
        advance updates were applied — is a few flag compares.

        Primaries stay current through :meth:`advance_prim`'s exact
        incremental updates; replica sets (whose lengths grow when their
        *primaries* decode elsewhere) are invalidated wholesale by the
        global advance counter and re-gathered on read — replica reads
        are far rarer than decode events, so lazy loses nothing."""
        state = self.state
        if role == "prim":
            cache, d, dirty = self.prim, self.inst.decode_batch, \
                self.prim_dirty
        else:
            cache, d, dirty = self.rep, self.inst.replicas, self.rep_dirty
            if cache.adv_gen != state.adv_version:
                cache.stale = True
        if dirty:
            n = len(d)
            cache.rids = (np.sort(np.fromiter(d.keys(), np.int64, n))
                          if n else _EMPTY_I64)
            cache.mem_key += 1
            cache.stale = True
            if role == "prim":
                self.prim_dirty = False
            else:
                self.rep_dirty = False
        if cache.stale or cache.agg_gen != state.gen_version:
            rids = cache.rids
            if len(rids):
                lens = state.req_prompt[rids] + state.req_gen[rids]
                cache.lens = lens
                # exact: integral line_bytes x integer line total, < 2**53
                cache.bytes = (self.line_bytes * float(lens.sum())
                               + self.fixed_bytes * len(rids))
                if role == "prim":
                    cache.rem = int(state.req_max_new[rids].sum()
                                    - state.req_gen[rids].sum())
            else:
                cache.lens = _EMPTY_I64
                cache.bytes = 0.0
                cache.rem = 0
            cache.agg_gen = state.gen_version
            cache.adv_gen = state.adv_version
            cache.stale = False
            cache.vecs_stale = False
            cache.key += 1
        return cache

    def _vectors(self, role: str) -> _RoleCache:
        """Like :meth:`_refresh` but with the length vector current too
        (re-gathered only if an incremental advance skipped it)."""
        cache = self._refresh(role)
        if cache.vecs_stale:
            rids = cache.rids
            cache.lens = ((self.state.req_prompt[rids]
                           + self.state.req_gen[rids])
                          if len(rids) else _EMPTY_I64)
            cache.vecs_stale = False
            cache.key += 1
        return cache

    # -- incremental decode-advance updates -----------------------------------
    def advance_prim(self, n_advanced: int, steps: int):
        """Every resident request generated ``steps`` tokens: O(1) byte
        and remaining-token updates plus one vectorized length add —
        exact integer arithmetic, so the values equal a recompute bit
        for bit.  Bails to a lazy recompute when the cache isn't clean
        or a mid-span join means not every member advanced."""
        cache = self.prim
        if self.prim_dirty or cache.stale \
                or cache.agg_gen != self.state.gen_version:
            return
        if n_advanced != len(cache.rids):
            cache.stale = True
            return
        cache.lens += steps          # private array, never aliased out
        cache.bytes += self.line_bytes * (steps * n_advanced)
        cache.rem -= steps * n_advanced
        cache.key += 1

    def role_weights(self, role: str) -> Tuple[np.ndarray, np.ndarray]:
        """(rid-sorted members, per-request state bytes) — the
        ``decode_weights`` / ``replica_weights`` columns."""
        cache = self._vectors(role)
        if cache.weights_key != cache.key:
            cache.weights = (self.line_bytes * cache.lens.astype(np.float64)
                             + self.fixed_bytes)
            cache.weights_key = cache.key
        return cache.rids, cache.weights

    def mirrored_count(self) -> int:
        cache = self._refresh("prim")
        key = (cache.mem_key, self.state.place_version)
        if cache.mirrored_key != key:
            cache.mirrored = (int((self.state.req_replica[cache.rids] >= 0)
                                  .sum()) if len(cache.rids) else 0)
            cache.mirrored_key = key
        return cache.mirrored

    def backlog_tokens(self) -> int:
        if self.q_dirty:
            self.q_tokens = sum(
                r.prompt_len - (getattr(r, "prefix_hit", 0) or 0)
                for r in self.inst.prefill_queue)
            self.q_dirty = False
        return self.q_tokens

    # -- aggregate reads -----------------------------------------------------
    def state_bytes(self) -> float:
        # same fp expression as SimInstance.state_bytes: prim sum + rep
        # sum (both exact integers in float64)
        return self._refresh("prim").bytes + self._refresh("rep").bytes

    def mem_free(self) -> float:
        return self.capacity - self.state_bytes()


# ---------------------------------------------------------------------------
# The cluster state
# ---------------------------------------------------------------------------


class ArrayClusterState:
    """Struct-of-arrays accounting over a :class:`Simulator`, attached by
    ``KernelPolicy.bind`` for ``vectorized`` kernels.  One instance per
    adapter; owns the observable wrappers, the global request arrays and
    the per-instance records, and serves the persistent array views."""

    _TRACKED = ("decode_batch", "replicas", "prefill_queue")

    def __init__(self, sim: Simulator, placement: Dict[int, Tuple[int,
                 Optional[int]]], planner: Optional[Planner] = None):
        self.sim = sim
        self.planner = planner
        cap = 1024
        self.req_prompt = np.zeros(cap, dtype=np.int64)
        self.req_gen = np.zeros(cap, dtype=np.int64)
        self.req_max_new = np.zeros(cap, dtype=np.int64)
        self.req_replica = np.full(cap, -1, dtype=np.int32)
        self.gen_version = 0
        self.adv_version = 0
        self.place_version = 0
        self.fleet_version = 0
        self._usable = np.empty(0, dtype=bool)
        self._usable_version = -1
        self._n_synced = -1
        self.recs: List[_InstRec] = []
        self.placement = _ObsPlacement(placement, self)
        self._view = ArrayClusterView(self)
        for inst in sim.instances:
            self._attach(inst)

    # -- request-array maintenance -------------------------------------------
    def _grow(self, rid: int):
        cap = len(self.req_prompt)
        while cap <= rid:
            cap *= 2
        for name in ("req_prompt", "req_gen", "req_max_new"):
            old = getattr(self, name)
            new = np.zeros(cap, dtype=np.int64)
            new[:len(old)] = old
            setattr(self, name, new)
        old = self.req_replica
        new = np.full(cap, -1, dtype=np.int32)
        new[:len(old)] = old
        self.req_replica = new

    def _sync_req(self, rid: int, r):
        if r is None:
            return
        if rid >= len(self.req_prompt):
            self._grow(rid)
        p, g, m = r.prompt_len, r.generated, r.max_new_tokens
        if (self.req_prompt[rid] != p or self.req_gen[rid] != g
                or self.req_max_new[rid] != m):
            self.req_prompt[rid] = p
            self.req_gen[rid] = g
            self.req_max_new[rid] = m
            # a value actually changed out of band (prefill completion,
            # rollback): conservative global invalidation — this is
            # per-request-rare; the per-iteration path goes through
            # note_decode_advance's targeted updates instead
            self.gen_version += 1

    def _sync_replica(self, rid: int, replica: Optional[int]):
        if rid >= len(self.req_prompt):
            self._grow(rid)
        self.req_replica[rid] = -1 if replica is None else replica
        self.place_version += 1

    def note_decode_advance(self, inst: SimInstance, rids, steps: int):
        """Simulator hook: every rid in ``rids`` (still resident on
        ``inst`` after a decode span) generated exactly ``steps`` tokens.
        One vectorized add replaces per-token bookkeeping, and the
        affected caches — this instance's primaries plus the replica
        sets mirroring them — are updated *incrementally*, so the
        per-iteration path never bumps the global version (no
        cluster-wide recompute churn).  Finished requests left their
        containers through the observable wrappers and need no update."""
        iid = inst.iid
        if iid >= len(self.recs) or self.recs[iid] is None:
            # first sight of a joined instance: _attach syncs req_gen to
            # the already-advanced r.generated, so skip the increment
            self._ensure(inst)
            return
        rec = self.recs[iid]
        if rec.muts_at_plan == rec.prim_muts and not rec.prim_dirty:
            # membership untouched since the plan read its lengths: the
            # survivors ARE the cached rid array — no per-rid filter
            a = rec.prim.rids
            n = len(a)
            if not n:
                return
        else:
            d = inst.decode_batch
            survivors = [rid for rid in rids if rid in d]
            n = len(survivors)
            if not n:
                return
            if max(survivors) >= len(self.req_prompt):
                self._grow(max(survivors))
            a = np.asarray(survivors, dtype=np.int64)
        self.req_gen[a] += steps
        rec.advance_prim(n, steps)
        # replica sets mirroring the advanced primaries grew too: one
        # counter bump lazily invalidates every rep aggregate — readers
        # re-gather on demand, the per-iteration hook stays O(1)+add
        self.adv_version += 1

    # -- instance attach ------------------------------------------------------
    def _attach(self, inst: SimInstance):
        iid = inst.iid
        while len(self.recs) <= iid:
            self.recs.append(None)
        rec = _InstRec(self, inst)
        self.recs[iid] = rec
        # mark BEFORE wrapping: __setattr__ consults _arrays
        inst.__dict__["_arrays"] = self
        object.__setattr__(inst, "decode_batch",
                           _ObsDict(inst.decode_batch, rec, "prim"))
        object.__setattr__(inst, "replicas",
                           _ObsDict(inst.replicas, rec, "rep"))
        object.__setattr__(inst, "prefill_queue",
                           _ObsList(inst.prefill_queue, rec))
        self.fleet_version += 1

    def _ensure(self, inst: SimInstance) -> _InstRec:
        iid = inst.iid
        if iid >= len(self.recs) or self.recs[iid] is None:
            self._attach(inst)
        return self.recs[iid]

    def on_setattr(self, inst: SimInstance, name: str, value):
        """``SimInstance.__setattr__`` interception: rebinds of tracked
        containers re-wrap (fleet kill does ``inst.prefill_queue = []``,
        compile filters the queue by rebinding); fleet-state flips dirty
        the usable mask.  Any other attribute write falls straight
        through — this runs on every ``SimInstance`` setattr."""
        if name == "decode_batch":
            return _ObsDict(value, self._ensure(inst), "prim")
        if name == "replicas":
            return _ObsDict(value, self._ensure(inst), "rep")
        if name == "prefill_queue":
            return _ObsList(value, self._ensure(inst))
        if name == "alive" or name == "draining":
            self.fleet_version += 1
        return value

    # -- cluster-wide vectors --------------------------------------------------
    def _sync_instances(self):
        n = len(self.sim.instances)
        if n != self._n_synced:
            for inst in self.sim.instances:
                self._ensure(inst)
            self._n_synced = n

    def usable_mask(self) -> np.ndarray:
        self._sync_instances()
        if self._usable_version != self.fleet_version or \
                len(self._usable) != len(self.sim.instances):
            self._usable = np.fromiter(
                (i.alive and not i.draining for i in self.sim.instances),
                dtype=bool, count=len(self.sim.instances))
            self._usable_version = self.fleet_version
        return self._usable

    def mem_free_vec(self) -> np.ndarray:
        self._sync_instances()
        return np.fromiter((rec.mem_free() for rec in self.recs),
                           dtype=np.float64, count=len(self.recs))

    def health_vec(self) -> np.ndarray:
        """Per-instance health EWMA (``InstanceView.health``,
        vectorized).  Read straight off the instances — health mutates
        every iteration, so caching would only add invalidation
        traffic."""
        self._sync_instances()
        return np.fromiter((rec.inst.health for rec in self.recs),
                           dtype=np.float64, count=len(self.recs))

    def decode_counts(self) -> np.ndarray:
        self._sync_instances()
        return np.fromiter((len(rec.inst.decode_batch) for rec in self.recs),
                           dtype=np.int64, count=len(self.recs))

    def backlog_counts(self) -> np.ndarray:
        self._sync_instances()
        return np.fromiter((len(rec.inst.prefill_queue) for rec in self.recs),
                           dtype=np.int64, count=len(self.recs))

    def backlog_tokens_vec(self) -> np.ndarray:
        self._sync_instances()
        return np.fromiter((rec.backlog_tokens() for rec in self.recs),
                           dtype=np.int64, count=len(self.recs))

    def rem_sum_vec(self) -> np.ndarray:
        """Per-instance outstanding decode tokens (ULB's work term)."""
        self._sync_instances()
        return np.fromiter((rec._refresh("prim").rem for rec in self.recs),
                           dtype=np.int64, count=len(self.recs))

    def admit_mask(self, req, taking: int = 0) -> np.ndarray:
        """Vector ``can_admit``: the same byte/slot test every scalar
        view runs, over all instances at once."""
        self._sync_instances()
        n = len(self.recs)
        memf = self.mem_free_vec()
        need = np.fromiter(
            (rec.line_bytes * req.prompt_len + rec.fixed_bytes
             for rec in self.recs), dtype=np.float64, count=n)
        slots = np.fromiter(
            (len(rec.inst.decode_batch) + taking < rec.max_batch
             for rec in self.recs), dtype=bool, count=n)
        return (memf >= need) & slots

    # -- per-instance scalar reads (pair-local decisions) ----------------------
    def usable(self, i: int) -> bool:
        inst = self.sim.instances[i]
        return inst.alive and not inst.draining

    def decode_count(self, i: int) -> int:
        return len(self.sim.instances[i].decode_batch)

    def mem_free(self, i: int) -> float:
        return self.recs[i].mem_free()

    def can_admit(self, i: int, req, taking: int = 0) -> bool:
        rec = self.recs[i]
        fits = rec.mem_free() >= (rec.line_bytes * req.prompt_len
                                  + rec.fixed_bytes)
        return fits and len(rec.inst.decode_batch) + taking < rec.max_batch

    def can_hold_replica(self, i: int, req) -> bool:
        rec = self.recs[i]
        return rec.mem_free() >= (rec.line_bytes * req.total_len
                                  + rec.fixed_bytes)

    def is_primary(self, i: int, rid: int) -> bool:
        return rid in self.sim.instances[i].decode_batch

    def cluster_view(self) -> "ArrayClusterView":
        self._sync_instances()
        return self._view


# ---------------------------------------------------------------------------
# Protocol views over the arrays
# ---------------------------------------------------------------------------


class ArrayInstanceView(SimInstanceView):
    """InstanceView answering from the array state.  Scalar kernels (and
    the rare Mapping-returning protocol calls) still work — dicts are
    materialized from the cached arrays in C — while the hot aggregate
    reads (``mem_free``, ``can_admit``, backlog/byte totals) are O(1)
    against the incremental caches."""

    def __init__(self, state: ArrayClusterState, inst: SimInstance,
                 rec: _InstRec):
        super().__init__(inst, state.placement, state.planner)
        self._state = state
        self._rec = rec

    # -- aggregate fast paths --------------------------------------------------
    def mem_free(self) -> float:
        return self._rec.mem_free()

    def primary_bytes(self) -> float:
        return self._rec._refresh("prim").bytes

    def replica_bytes(self) -> float:
        return self._rec._refresh("rep").bytes

    def can_admit(self, req, taking: int = 0) -> bool:
        return self._state.can_admit(self._i.iid, req, taking)

    def can_hold_replica(self, req, resident: bool = False) -> bool:
        return self._state.can_hold_replica(self._i.iid, req)

    def prefill_backlog_tokens(self) -> int:
        # the aggregate assumes whole-prompt prefills; with resumable
        # chunk cursors live (Sarathi) fall back to the exact scalar sum
        if self._planner is not None and self._planner._cursors:
            return super().prefill_backlog_tokens()
        return self._rec.backlog_tokens()

    # -- vectorized Mapping materialization ------------------------------------
    def decode_weights(self) -> Dict[int, float]:
        rids, w = self._rec.role_weights("prim")
        return dict(zip(rids.tolist(), w.tolist()))

    def replica_weights(self) -> Dict[int, float]:
        rids, w = self._rec.role_weights("rep")
        return dict(zip(rids.tolist(), w.tolist()))

    def decode_remaining(self) -> Dict[int, int]:
        cache = self._rec._refresh("prim")
        rids = cache.rids
        if not len(rids):
            return {}
        rem = self._state.req_max_new[rids] - self._state.req_gen[rids]
        return dict(zip(rids.tolist(), rem.tolist()))

    def request_lines(self) -> Dict[int, int]:
        cache = self._rec._vectors("prim")
        return dict(zip(cache.rids.tolist(), cache.lens.tolist()))

    # -- planner fast path -----------------------------------------------------
    def decode_plan_stats(self) -> Tuple[Tuple[int, ...], int]:
        """(rid-ordered lengths, mirrored count) for ``DecodePlan`` —
        exactly ``sorted(request_lines().items())`` + the placements
        scan, without building either dict (consumed by
        ``Planner._decode_plan``)."""
        rec = self._rec
        cache = rec._vectors("prim")
        # stamp the mutation counter: if it is unchanged when this
        # plan's decode span completes, the cached rid array IS the
        # span's survivor set (note_decode_advance's fast path)
        rec.muts_at_plan = rec.prim_muts
        if not len(cache.rids):
            return (), 0
        return tuple(cache.lens.tolist()), self._rec.mirrored_count()


class ArrayClusterView(SimClusterView):
    """Persistent ClusterView over the array state.  ``arrays`` is the
    marker the vectorized kernels dispatch on."""

    def __init__(self, state: ArrayClusterState):
        # deliberately NOT calling super().__init__: views are persistent
        self.arrays = state
        self._state = state
        self._placement = state.placement
        self._views: List[ArrayInstanceView] = []
        self._pairs: List[Tuple[ArrayInstanceView, ArrayInstanceView]] = []

    def instances(self):
        state = self._state
        if len(self._views) != len(state.sim.instances):
            state._sync_instances()
            self._views = [ArrayInstanceView(state, rec.inst, rec)
                           for rec in state.recs]
            self._pairs = [(self._views[i], self._views[i + 1])
                           for i in range(0, len(self._views) - 1, 2)]
        return self._views

    def pairs(self):
        self.instances()
        return self._pairs

    def placements(self) -> Dict[int, Tuple[int, Optional[int]]]:
        return self._state.placement
