"""Vectorized scheduling kernels over the array-backed cluster state.

Each class subclasses its dict-backed kernel and overrides exactly the
hot decision loops — routing, pair selection, rebalance item building,
eviction victim ranking — with argmin/argmax over per-instance arrays
(``repro_torch.scale.state``).  Everything else (role rules, action
construction, mirror bookkeeping, fleet warm-up) is inherited, so the
vectorized variants stay decision-compatible by sharing the code that
defines the decisions.

**Bit identity, not approximation**: every array expression reproduces
the scalar kernel's comparison key exactly — byte quantities are exact
integers in float64 (see ``repro_torch.scale.state``), Splitwise's
``decode_load - mem_free*1e-18`` tiebreak is evaluated with the same
IEEE operations elementwise, and ``np.argmin``/``np.argmax`` return the
*first* extremum, which is precisely Python ``min``/``max`` semantics
under the scalar kernels' ``(key, index)`` tuples.  The golden tests in
``tests/test_scale.py`` assert identical decision traces against the
scalar kernels, event for event.

Backends: the array state only exists on the simulator (attached by
``KernelPolicy.bind``).  On the live executor ``getattr(cluster,
"arrays", None)`` is None and every override falls back to its scalar
superclass — one kernel name runs on both backends, like every other
policy in the registry.

The sim-only shortcuts the vector paths exploit (and the scalar sim
views define): ``can_queue()`` is always True (elastic backlog) and
``can_hold_primary()`` is always True (memory pressure handled by
eviction) — so AcceLLM pair eligibility reduces to "has a usable side"
and the placement swap never re-checks primary headroom.

A copy of the JAX package's ``repro.scale.kernels``, held against it and
against the scalar kernels by ``tests/test_torch_scale.py``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.balancer import Item, partition, should_rebalance_agg
from repro_torch.scheduling.accellm import AcceLLMScheduler
from repro_torch.scheduling.actions import (Action, EvictReplica, MirrorSync,
                                            PromoteReplica, StreamState)
from repro_torch.scheduling.baselines import (SplitwiseScheduler,
                                              VLLMScheduler)
from repro_torch.scheduling.ulb import ULBScheduler
from repro_torch.scheduling.views import (ClusterView, InstanceView,
                                          RequestView)

__all__ = ["VectorAcceLLMScheduler", "VectorVLLMScheduler",
           "VectorSplitwiseScheduler", "VectorULBScheduler"]


class VectorVLLMScheduler(VLLMScheduler):
    name = "vllm-vec"
    vectorized = True

    def route(self, cluster: ClusterView, req: RequestView) -> Optional[int]:
        st = getattr(cluster, "arrays", None)
        if st is None:
            return super().route(cluster, req)
        u = st.usable_mask()
        if not u.any():
            return None
        pool = u & st.admit_mask(req)
        if not pool.any():
            pool = u          # sim instances always queue (can_queue True)
        key = (st.decode_counts() + st.backlog_counts()).astype(np.float64)
        key[~pool] = np.inf
        target = int(np.argmin(key))   # first min == (key, index) order
        self._note("route", req.rid, target)
        return target


class VectorULBScheduler(ULBScheduler):
    name = "ulb-vec"
    vectorized = True

    def route(self, cluster: ClusterView, req: RequestView) -> Optional[int]:
        st = getattr(cluster, "arrays", None)
        if st is None:
            return super().route(cluster, req)
        u = st.usable_mask()
        if not u.any():
            return None
        pool = u & st.admit_mask(req)
        if not pool.any():
            pool = u
        # outstanding work in tokens: prompt tokens still to prefill +
        # decode tokens still to generate (exact integer sums)
        work = (st.backlog_tokens_vec() + st.rem_sum_vec()) \
            .astype(np.float64)
        work[~pool] = np.inf
        target = int(np.argmin(work))
        self._note("route", req.rid, target)
        return target


class VectorSplitwiseScheduler(SplitwiseScheduler):
    name = "splitwise-vec"
    vectorized = True

    def route(self, cluster: ClusterView, req: RequestView) -> Optional[int]:
        st = getattr(cluster, "arrays", None)
        if st is None:
            return super().route(cluster, req)
        mask = st.usable_mask()[: self.n_prefill]
        if not mask.any():
            return None
        key = st.backlog_tokens_vec()[: self.n_prefill] \
            .astype(np.float64)
        key[~mask] = np.inf
        target = int(np.argmin(key))
        self._note("route", req.rid, target)
        return target

    def choose_decode_target(self, cluster: ClusterView, req: RequestView
                             ) -> Optional[int]:
        st = getattr(cluster, "arrays", None)
        if st is None:
            return super().choose_decode_target(cluster, req)
        mask = st.usable_mask()[self.n_prefill:]
        if not mask.any():
            return None
        # the scalar kernel's exact float key, elementwise
        key = (st.decode_counts()[self.n_prefill:].astype(np.float64)
               - st.mem_free_vec()[self.n_prefill:] * 1e-18)
        key[~mask] = np.inf
        target = int(np.argmin(key)) + self.n_prefill
        self._note("target", req.rid, target)
        return target


class VectorAcceLLMScheduler(AcceLLMScheduler):
    name = "accellm-vec"
    vectorized = True

    # -- routing (§4.2.2) ---------------------------------------------------
    def route(self, cluster: ClusterView, req: RequestView) -> Optional[int]:
        st = getattr(cluster, "arrays", None)
        if st is None:
            return super().route(cluster, req)
        u = st.usable_mask()
        n_paired = (len(u) // 2) * 2
        if not n_paired:
            return None
        u2 = u[:n_paired].reshape(-1, 2)
        # _pair_can_accept over sim views reduces to "a usable side":
        # can_queue is unconditionally True there
        elig = u2.any(axis=1)
        if not elig.any():
            return None
        memf2 = st.mem_free_vec()[:n_paired].reshape(-1, 2)
        score = (memf2 * u2).sum(axis=1)   # dead side adds +0.0 — exact
        if self.hedging:
            # same arithmetic as the scalar _pair_score: free memory
            # over the pair's worst health (exactly /1.0 when nominal)
            h2 = st.health_vec()[:n_paired].reshape(-1, 2)
            score = score / h2.max(axis=1)
        score[~elig] = -np.inf
        pi = int(np.argmax(score))         # first max == Python max order
        side = self._vec_choose_side(st, pi, req)
        if side is None:
            return None
        target = 2 * pi + side
        self._note("route", req.rid, target)
        return target

    def _vec_choose_side(self, st, pi: int, req) -> Optional[int]:
        """``choose_prefill_side`` against the arrays — same branch
        structure, O(1) reads (including the victim probe's trace
        notes, which the scalar path also emits)."""
        iids = (2 * pi, 2 * pi + 1)
        live = [s for s in (0, 1) if st.usable(iids[s])]
        if not live:
            return None
        open_sides = [s for s in live if st.can_admit(iids[s], req)]
        if not open_sides:
            victims = self._vec_eviction_victims(
                st, [iids[s] for s in live], need=1)
            if victims:
                open_sides = [s for s in live
                              if iids[s] == victims[0].instance]
            else:
                open_sides = live      # sim can_queue: every live side
        if self.hedging:
            # scalar _prefill_cost over the arrays: (load+1) * health
            h = st.health_vec()
            return min(open_sides,
                       key=lambda s: ((st.decode_count(iids[s]) + 1)
                                      * float(h[iids[s]]), s))
        return min(open_sides,
                   key=lambda s: (float(st.decode_count(iids[s])), s))

    # -- graceful degradation (§4.2.5) --------------------------------------
    def evict(self, cluster: ClusterView,
              instances: Sequence[InstanceView], need: int = 1
              ) -> List[EvictReplica]:
        st = getattr(cluster, "arrays", None)
        if st is None:
            return super().evict(cluster, instances, need)
        return self._vec_eviction_victims(
            st, [v.index for v in instances], need)

    def _vec_eviction_victims(self, st, iids, need: int = 1
                              ) -> List[EvictReplica]:
        st._sync_instances()
        rids_all, w_all, inst_all = [], [], []
        for i in iids:
            rids, w = st.recs[i].role_weights("rep")
            if len(rids):
                rids_all.append(rids)
                w_all.append(w)
                inst_all.append(np.full(len(rids), i, dtype=np.int64))
        if not rids_all:
            return []
        rids = np.concatenate(rids_all)
        w = np.concatenate(w_all)
        insts = np.concatenate(inst_all)
        # scalar sort key (-weight, rid): lexsort orders by its LAST key
        # first; byte weights are exact integers so negation is exact
        order = np.lexsort((rids, -w))[:need]
        victims = [EvictReplica(rid=int(rids[k]), instance=int(insts[k]))
                   for k in order]
        for v in victims:
            self._note("evict", v.rid, v.instance)
        return victims

    # -- placement (§4.1.2) -------------------------------------------------
    def place_after_prefill(self, cluster: ClusterView, instance: int,
                            req: RequestView) -> List[Action]:
        st = getattr(cluster, "arrays", None)
        if st is None:
            return super().place_after_prefill(cluster, instance, req)
        views = cluster.instances()
        pi = instance // 2
        iids = (2 * pi, 2 * pi + 1)
        if iids[1] >= len(views):
            return super().place_after_prefill(cluster, instance, req)
        side = 0 if iids[0] == instance else 1

        def load(s: int) -> int:
            # exclude the request being placed if already resident
            i = iids[s]
            return st.decode_count(i) - (1 if st.is_primary(i, req.rid)
                                         else 0)

        dst, rep = 1 - side, side
        if not st.usable(iids[dst]):
            dst, rep = side, 1 - side
        elif load(dst) > load(rep) + self.swap_margin:
            dst, rep = side, 1 - side
        # (the scalar path re-checks can_hold_primary on a swap — that
        # is unconditionally True on sim views, so no test here)

        replica: Optional[int] = None
        if self.redundancy and st.usable(iids[rep]) \
                and st.can_hold_replica(iids[rep], req):
            replica = iids[rep]

        actions: List[Action] = []
        if dst != side:
            actions.append(StreamState(
                req.rid, src=iids[side], dst=iids[dst],
                retain_replica=replica is not None,
                skip_lines=views[iids[dst]].prefix_hit_tokens(req)))
        elif replica is not None:
            actions.append(StreamState(
                req.rid, src=iids[side], dst=replica, as_replica=True,
                skip_lines=views[iids[rep]].prefix_hit_tokens(req)))
        self._note("place", req.rid, iids[dst], replica)
        return actions

    # -- balancing by count + state bytes (§4.1.3) --------------------------
    def rebalance(self, cluster: ClusterView, pair_index: int
                  ) -> List[Action]:
        st = getattr(cluster, "arrays", None)
        if st is None:
            return super().rebalance(cluster, pair_index)
        st._sync_instances()
        iids = (2 * pair_index, 2 * pair_index + 1)
        if not (st.usable(iids[0]) and st.usable(iids[1])):
            return []
        # straggler hedging gates the regular rebalance exactly as in
        # the scalar kernel — the O(1) health test runs first, and the
        # hedge path itself (rare) reuses the scalar implementation so
        # the decisions stay bit-identical
        hedge = self._maybe_hedge(cluster, cluster.pairs()[pair_index])
        if hedge is not None:
            return hedge
        # trigger test from the cached per-side aggregates — the common
        # case (balanced pair) never materializes a single Item
        if not should_rebalance_agg(
                st.decode_count(iids[0]), st.decode_count(iids[1]),
                st.recs[iids[0]]._refresh("prim").bytes,
                st.recs[iids[1]]._refresh("prim").bytes):
            return []
        items = []
        for s in (0, 1):
            partner_idx = iids[1 - s]
            rids, w = st.recs[iids[s]].role_weights("prim")
            if not len(rids):
                continue
            movable = st.req_replica[rids] == partner_idx
            for rid, weight, mv in zip(rids.tolist(), w.tolist(),
                                       movable.tolist()):
                items.append(Item(rid=rid, weight=weight, home=s,
                                  movable=mv))
        _, _, moves = partition(items)
        views = cluster.instances()
        synced_of: dict = {}     # side -> replica_synced(), built once
        lines_of: dict = {}
        actions: List[Action] = []
        promoted = []
        for rid, src, dst in sorted(moves):
            if dst not in synced_of:
                synced_of[dst] = views[iids[dst]].replica_synced()
            synced = synced_of[dst].get(rid, 0)
            if src not in lines_of:
                lines_of[src] = views[iids[src]].request_lines()
            lines = lines_of[src].get(rid, synced)
            if synced < lines:
                actions.append(MirrorSync(rid, iids[src], iids[dst],
                                          from_line=synced, to_line=lines))
            actions.append(PromoteReplica(rid, src=iids[src],
                                          dst=iids[dst]))
            promoted.append((rid, iids[src], iids[dst]))
        if promoted:
            self._note("rebalance", tuple(promoted))
        return actions
