"""The AcceLLM scheduling kernel (paper §4.1–§4.2) — one implementation
shared by the live-engine executor and the simulator adapter.

Decisions made here, and only here:

  * routing (§4.2.2): new requests go to the pair with the most free
    memory; inside the pair, the less decode-loaded side prefills,
  * dynamic roles (§4.2.3): prefill and decode are never co-scheduled on
    one instance in one iteration,
  * placement (§4.1.2): after prefill the state streams to the partner
    (which becomes the primary decoder) while the prefilling side retains
    its copy as the replica — unless the partner is already markedly more
    loaded, in which case the roles invert,
  * mirroring (§4.1.2): newly generated KV lines sync into replicas,
  * balancing (§4.1.3): decode batches re-split by count + state bytes via
    zero-cost replica promotion,
  * eviction (§4.2.5): under memory pressure the replica freeing the most
    bytes (the longest request's) is dropped first.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from repro_torch.core.balancer import Item, partition, should_rebalance
from repro_torch.scheduling.actions import (Action, EvictReplica, MirrorSync,
                                            PromoteReplica, StreamState)
from repro_torch.scheduling.base import (ROLE_DECODE, ROLE_IDLE, ROLE_PREFILL,
                                         SchedulerPolicy)
from repro_torch.scheduling.views import (ClusterView, InstanceView,
                                          RequestView, usable)

PairView = Tuple[InstanceView, InstanceView]


class AcceLLMScheduler(SchedulerPolicy):
    name = "accellm"
    requires_pairs = True
    requeue_unplaced = True
    #: §4.2.3: prefill and decode are never co-scheduled on one
    #: instance — the step planner raises on any mixed plan.
    allow_mixed = False

    def __init__(self, redundancy: bool = True, swap_margin: int = 1,
                 hedging: bool = True, hedge_threshold: float = 1.5):
        self.redundancy = redundancy
        #: the partner only loses the primary role when it is more than
        #: ``swap_margin`` requests ahead of the prefilling side
        self.swap_margin = swap_margin
        #: straggler hedging: when one pair side's health EWMA crosses
        #: ``hedge_threshold`` (1.0 = nominal speed) and the other side
        #: holds synced mirrors, decode routes to the mirrors via
        #: zero-cost role flips — the paper's redundancy cashed in as a
        #: tail-latency hedge.  Requires ``redundancy``.
        self.hedging = hedging
        self.hedge_threshold = hedge_threshold
        # decision log: inherited ``trace``/``_note`` (SchedulerPolicy)

    # -- routing (§4.2.2) ---------------------------------------------------
    def admissions_per_step(self, cluster: ClusterView) -> int:
        return 1

    def route(self, cluster: ClusterView, req: RequestView) -> Optional[int]:
        eligible = [p for p in cluster.pairs() if self._pair_can_accept(p, req)]
        if not eligible:
            return None
        pair = max(eligible, key=self._pair_score)
        side = self.choose_prefill_side(pair, req)
        if side is None:
            return None
        target = pair[side].index
        self._note("route", req.rid, target)
        return target

    def _pair_score(self, pair: PairView) -> float:
        """Pair attractiveness for new admissions: free memory, scaled
        down by the pair's worst health EWMA when hedging is on.  At
        nominal health the division is by exactly 1.0, so the ranking
        (and every golden trace without degradations) is unchanged; a
        pair nursing a straggler stops soaking up new work just because
        hedging freed its memory."""
        free = sum(v.mem_free() for v in pair if usable(v))
        if not self.hedging:
            return float(free)
        return free / max(self._health(pair[0]), self._health(pair[1]))

    def _prefill_cost(self, view: InstanceView) -> float:
        """Prefill-side preference: decode load, stretched by health
        when hedging is on — a straggler only wins the prefill role if
        preempting the healthy side's decode would cost more than
        running the prompt ``health``x slow.  ``(load+1) * 1.0`` is
        monotone in load, so nominal-health decisions are identical."""
        load = view.decode_load()
        if not self.hedging:
            return float(load)
        return (load + 1) * self._health(view)

    def _pair_can_accept(self, pair: PairView, req: RequestView) -> bool:
        sides = [v for v in pair if usable(v)]
        if not sides:
            return False
        if any(v.can_admit(req) for v in sides):
            return True
        # memory pressure: a replica can be evicted to make room (§4.2.5)
        if any(v.replica_weights() for v in sides):
            return True
        return any(v.can_queue() for v in sides)

    # -- dynamic roles (§4.2.3) ---------------------------------------------
    def choose_prefill_side(self, pair: PairView, req: RequestView
                            ) -> Optional[int]:
        live_sides = [s for s in (0, 1) if usable(pair[s])]
        if not live_sides:
            return None
        open_sides = [s for s in live_sides if pair[s].can_admit(req)]
        if not open_sides:
            victims = self._eviction_victims(
                [pair[s] for s in live_sides], need=1)
            if victims:
                open_sides = [s for s in live_sides
                              if pair[s].index == victims[0].instance]
            elif any(pair[s].can_queue() for s in live_sides):
                open_sides = [s for s in live_sides if pair[s].can_queue()]
            else:
                return None
        return min(open_sides, key=lambda s: (self._prefill_cost(pair[s]), s))

    def choose_roles(self, cluster: ClusterView, instance: int) -> str:
        inst = cluster.instances()[instance]
        if inst.prefill_backlog():
            return ROLE_PREFILL          # never co-scheduled with decode
        return ROLE_DECODE if inst.decode_load() else ROLE_IDLE

    def prefill_batch(self, cluster: ClusterView, instance: int,
                      pending: Sequence[RequestView]) -> int:
        inst = cluster.instances()[instance]
        if pending and not inst.can_admit(pending[0]) \
                and inst.replica_weights():
            # memory pressure (§4.2.5): admit one request anyway — the
            # executor frees its slot by evicting this instance's most
            # expensive replica first
            return 1
        return super().prefill_batch(cluster, instance, pending)

    # -- placement (§4.1.2) -------------------------------------------------
    def place_after_prefill(self, cluster: ClusterView, instance: int,
                            req: RequestView) -> List[Action]:
        pair = next(p for p in cluster.pairs()
                    if instance in (p[0].index, p[1].index))
        side = 0 if pair[0].index == instance else 1

        def load(s: int) -> int:
            # exclude the request being placed (backends differ on whether
            # it is already counted as resident at this point)
            v = pair[s]
            return v.decode_load() - (1 if req.rid in v.decode_weights()
                                      else 0)

        dst, rep = 1 - side, side
        if not usable(pair[dst]):
            # partner down/draining: the request stays where it
            # prefilled and serves unmirrored until the fleet recovers
            dst, rep = side, 1 - side
        elif load(dst) > load(rep) + self.swap_margin:
            dst, rep = side, 1 - side
        if dst != side and not pair[dst].can_hold_primary(req):
            dst, rep = side, 1 - side

        replica: Optional[int] = None
        if self.redundancy and usable(pair[rep]) \
                and pair[rep].can_hold_replica(req, resident=(rep == side)):
            replica = pair[rep].index

        def _hit(view) -> int:
            # lines the destination's prefix cache already holds never
            # cross the wire: the stream (and its pricing on both
            # backends) covers only the unique suffix.  getattr: bare
            # test doubles predate the prefix-cache view fields.
            peek = getattr(view, "prefix_hit_tokens", None)
            return peek(req) if peek is not None else 0

        actions: List[Action] = []
        if dst != side:
            actions.append(StreamState(req.rid, src=pair[side].index,
                                       dst=pair[dst].index,
                                       retain_replica=replica is not None,
                                       skip_lines=_hit(pair[dst])))
        elif replica is not None:
            actions.append(StreamState(req.rid, src=pair[side].index,
                                       dst=replica, as_replica=True,
                                       skip_lines=_hit(pair[rep])))
        self._note("place", req.rid, pair[dst].index, replica)
        return actions

    # -- mirroring (§4.1.2) -------------------------------------------------
    def sync(self, cluster: ClusterView) -> List[Action]:
        """Delta mirror maintenance: for every (primary, replica) pair,
        emit a MirrorSync bounded to exactly the lines the replica is
        missing — the ledger's ``replica_synced`` mark up to the
        primary's ``request_lines``.  Replicas that are already current
        produce no action (and no traffic)."""
        if not self.redundancy:
            return []
        insts = cluster.instances()
        lines_of: dict = {}      # instance -> request_lines(), built once
        synced_of: dict = {}
        actions: List[Action] = []
        for rid, (primary, replica) in sorted(cluster.placements().items()):
            if replica is None:
                continue
            if primary not in lines_of:
                lines_of[primary] = insts[primary].request_lines()
            lines = lines_of[primary].get(rid)
            if lines is None:       # primary not decoding (e.g. finished)
                continue
            if replica not in synced_of:
                synced_of[replica] = insts[replica].replica_synced()
            synced = synced_of[replica].get(rid, 0)
            if synced >= lines:
                continue
            actions.append(MirrorSync(rid, primary, replica,
                                      from_line=synced, to_line=lines))
        return actions

    # -- fleet: warm scale-up (repro.fleet) ---------------------------------
    def warm_on_join(self, cluster: ClusterView, instance: int
                     ) -> List[Action]:
        """A joined instance warms up by hosting replicas of its
        partner's unmirrored primaries (StreamState as_replica) before
        any new arrival routes to it — redundancy is re-established
        first, then the rebalancer can shift load via promotion."""
        if not self.redundancy:
            return []
        pair = next((p for p in cluster.pairs()
                     if instance in (p[0].index, p[1].index)), None)
        if pair is None:
            return []            # unpaired appendee: nothing to warm from
        joined = pair[0] if pair[0].index == instance else pair[1]
        partner = pair[1] if pair[0].index == instance else pair[0]
        if not usable(partner):
            return []
        placements = cluster.placements()
        budget = joined.free_slots()
        actions: List[Action] = []
        for rid in sorted(partner.decode_weights()):
            if budget <= 0:
                break
            if placements.get(rid, (None, None))[1] is not None:
                continue         # already mirrored somewhere
            actions.append(StreamState(rid, src=partner.index,
                                       dst=instance, as_replica=True))
            self._note("warm", rid, partner.index, instance)
            budget -= 1
        return actions

    # -- straggler hedging (redundancy as a tail hedge) ----------------------
    @staticmethod
    def _health(view: InstanceView) -> float:
        # getattr: bare test doubles predate the health view method
        h = getattr(view, "health", None)
        return h() if h is not None else 1.0

    def _maybe_hedge(self, cluster: ClusterView, pair: PairView
                     ) -> Optional[List[Action]]:
        """Health-gated pair balancing.  Returns None when both sides
        are nominal (the regular count+bytes rebalance applies); with a
        straggler in the pair it returns the hedge actions — every
        primary on the sick side whose mirror lives on the healthy side
        flips roles there (catch-up delta first if the mirror lags) —
        and the regular rebalance is suppressed so load balancing never
        migrates work back onto the straggler."""
        if not (self.hedging and self.redundancy):
            return None
        h0, h1 = self._health(pair[0]), self._health(pair[1])
        if max(h0, h1) < self.hedge_threshold:
            return None
        if min(h0, h1) >= self.hedge_threshold:
            return []            # both degraded: no healthy side to hedge to
        sick = 0 if h0 > h1 else 1
        well = 1 - sick
        placements = cluster.placements()
        synced = pair[well].replica_synced()
        lines = pair[sick].request_lines()
        actions: List[Action] = []
        hedged = []
        for rid in sorted(pair[sick].decode_weights()):
            if placements.get(rid, (None, None))[1] != pair[well].index:
                continue         # no mirror on the healthy side: must stall
            s = synced.get(rid, 0)
            ln = lines.get(rid, s)
            if s < ln:
                actions.append(MirrorSync(rid, pair[sick].index,
                                          pair[well].index,
                                          from_line=s, to_line=ln))
            actions.append(PromoteReplica(rid, src=pair[sick].index,
                                          dst=pair[well].index, hedge=True))
            hedged.append((rid, pair[sick].index, pair[well].index))
        if hedged:
            self._note("hedge", tuple(hedged))
        return actions

    # -- balancing by count + state bytes (§4.1.3) --------------------------
    def rebalance(self, cluster: ClusterView, pair_index: int
                  ) -> List[Action]:
        pair = cluster.pairs()[pair_index]
        if not (usable(pair[0]) and usable(pair[1])):
            # promotion shifts work between the sides; with one side
            # dead or cordoned there is nothing to balance against
            return []
        hedge = self._maybe_hedge(cluster, pair)
        if hedge is not None:
            return hedge
        placements = cluster.placements()
        items = []
        for side, view in enumerate(pair):
            partner_idx = pair[1 - side].index
            for rid, weight in sorted(view.decode_weights().items()):
                replica = placements.get(rid, (None, None))[1]
                items.append(Item(rid=rid, weight=weight, home=side,
                                  movable=replica == partner_idx))
        if not should_rebalance(items):
            return []
        _, _, moves = partition(items)
        actions: List[Action] = []
        promoted = []
        for rid, src, dst in sorted(moves):
            # a replica may only take the primary role at the primary's
            # line count: if its synced mark lags (a sync was skipped or
            # raced a fleet event), emit the catch-up delta FIRST —
            # serving from a stale copy would corrupt the request
            synced = pair[dst].replica_synced().get(rid, 0)
            lines = pair[src].request_lines().get(rid, synced)
            if synced < lines:
                actions.append(MirrorSync(rid, pair[src].index,
                                          pair[dst].index,
                                          from_line=synced, to_line=lines))
            actions.append(PromoteReplica(rid, src=pair[src].index,
                                          dst=pair[dst].index))
            promoted.append((rid, pair[src].index, pair[dst].index))
        if promoted:
            self._note("rebalance", tuple(promoted))
        return actions

    # -- graceful degradation (§4.2.5) --------------------------------------
    def evict(self, cluster: ClusterView,
              instances: Sequence[InstanceView], need: int = 1
              ) -> List[Action]:
        return self._eviction_victims(instances, need)

    def _eviction_victims(self, instances: Sequence[InstanceView],
                          need: int = 1) -> List[EvictReplica]:
        candidates = [(weight, rid, view.index)
                      for view in instances
                      for rid, weight in view.replica_weights().items()]
        # most bytes freed first (the longest request's replica); ties
        # break toward the lowest rid for determinism across backends
        candidates.sort(key=lambda c: (-c[0], c[1]))
        victims = [EvictReplica(rid=rid, instance=idx)
                   for _, rid, idx in candidates[:need]]
        for v in victims:
            self._note("evict", v.rid, v.instance)
        return victims
