"""Backend-agnostic read-only views of cluster state.

These Protocols are the *only* state a ``SchedulerPolicy`` may consult, so
the same decision kernel runs over live JAX engines and over the
discrete-event simulator.  Both backends answer from the same ledger
arithmetic (``repro_torch.kvstore``: the live engine's ``PagedStore``, the
simulator's ``SimStore``, both priced by ``LineCosts`` over
``repro_torch.core.kvbytes``): ``mem_free``/``decode_weights`` are state
**bytes**, ``free_blocks`` is block-pool headroom, and
``request_lines``/``replica_synced`` expose the per-request line clocks a
delta ``MirrorSync`` is bounded by — so rankings and deltas agree whenever
both backends describe the same requests at the same lengths.
"""
from __future__ import annotations

from typing import Mapping, Optional, Protocol, Sequence, Tuple, runtime_checkable


@runtime_checkable
class RequestView(Protocol):
    """What a policy may know about a request (live ``Request`` and
    ``SimRequest`` both satisfy this structurally)."""
    rid: int
    prompt_len: int

    @property
    def total_len(self) -> int: ...


@runtime_checkable
class InstanceView(Protocol):
    """One serving instance, as the policy sees it."""

    @property
    def index(self) -> int:
        """Global instance index (engine ``instance_id`` / sim ``iid``)."""
        ...

    # -- fleet state --------------------------------------------------------
    def alive(self) -> bool:
        """Whether this instance is serving at all.  Dead instances stay
        in the view sequence (indices are stable across fleet events);
        every kernel decision must skip them."""
        ...

    def draining(self) -> bool:
        """Instance is alive but cordoned: it finishes resident work and
        accepts no new routing, placement or promotion (graceful
        scale-down; see repro.fleet)."""
        ...

    def health(self) -> float:
        """Observed slowdown of this instance: an EWMA of its
        per-iteration step latency, normalized so 1.0 is nominal speed
        and ``k`` means steps are running ~``k``x slow.  Both backends
        update it with the same arithmetic
        (``health += HEALTH_ALPHA * (slowdown - health)``, once per
        scheduling iteration while alive), so golden traces that branch
        on health agree.  Kernels that hedge stragglers read this; the
        health-blind baselines never call it."""
        ...

    # -- capacity -----------------------------------------------------------
    def free_slots(self) -> int:
        """Free request slots (live) or residual batch slack (sim)."""
        ...

    def mem_free(self) -> float:
        """Free serving-state bytes under this backend's accounting."""
        ...

    def free_blocks(self) -> int:
        """Free KV blocks in this instance's pool — the block-granular
        headroom for admission, replica budgeting and eviction.  Both
        backends answer with the same ``repro_torch.kvstore.BlockLedger``
        arithmetic, but pool *size* follows each backend's capacity
        model (live: slots x cache window; sim: modeled HBM), so
        policies should compare headroom within a backend, not across
        them."""
        ...

    def block_lines(self) -> int:
        """KV lines per pool block on this instance — the gather/DMA
        granularity of the paged decode path; the cost model rounds a
        request's resident lines up to it."""
        ...

    def spec(self):
        """Hardware identity of this instance
        (``repro.sim.devices.InstanceSpec`` or None when undeclared).
        Pods may be heterogeneous — H100-class and 910B2-class slices in
        one cluster — so policies that weigh transfer or decode cost
        against hardware should read per-instance ``intra_link_gbps`` /
        ``inter_link_gbps`` / ``n_devices`` here rather than assume one
        device model."""
        ...

    def decode_remaining(self) -> Mapping[int, int]:
        """Remaining token budget per resident decode request — the
        planner's fused-span cap (a fused block never runs past the
        iteration its first request completes)."""
        ...

    def primary_bytes(self) -> float:
        """Ledger bytes of resident decode primaries."""
        ...

    def replica_bytes(self) -> float:
        """Ledger bytes of resident replicas (real memory — counted, not
        ignored, under pressure accounting)."""
        ...

    def can_admit(self, req: RequestView, taking: int = 0) -> bool:
        """Can this instance accept a new prefill, with ``taking`` requests
        already earmarked this iteration?"""
        ...

    def can_hold_primary(self, req: RequestView, resident: bool = False
                         ) -> bool:
        """Can it host ``req`` as a decode primary?  ``resident`` means the
        state is already materialized here (no new capacity needed)."""
        ...

    def can_hold_replica(self, req: RequestView, resident: bool = False
                         ) -> bool:
        """Can it hold a redundant copy of ``req``'s state?"""
        ...

    def can_queue(self) -> bool:
        """Whether admission may overflow into a backlog on this instance
        (the simulator queues; live engines must have a slot)."""
        ...

    # -- load ---------------------------------------------------------------
    def decode_load(self) -> int:
        """Number of resident decode primaries."""
        ...

    def prefill_backlog(self) -> int:
        """Requests routed here but not yet prefilled."""
        ...

    def prefill_backlog_tokens(self) -> int:
        """Total prompt tokens awaiting prefill here."""
        ...

    def decode_weights(self) -> Mapping[int, float]:
        """rid -> state bytes read per decode step (balancer weight)."""
        ...

    def replica_weights(self) -> Mapping[int, float]:
        """rid -> bytes freed if this instance's replica of rid is
        evicted."""
        ...

    # -- mirror ledger --------------------------------------------------------
    def request_lines(self) -> Mapping[int, int]:
        """rid -> KV lines materialized here for resident decode
        primaries (the ``to_line`` of a delta MirrorSync)."""
        ...

    def replica_synced(self) -> Mapping[int, int]:
        """rid -> line up to which this instance's replica of rid has
        been mirrored (the ``from_line`` of a delta MirrorSync)."""
        ...

    # -- prefix cache ---------------------------------------------------------
    def shared_blocks(self) -> int:
        """Distinct pool blocks referenced by more than one holder
        (tables and/or the prefix cache) on this instance — each one is
        HBM the refcounted sharing avoided duplicating."""
        ...

    def prefix_hit_tokens(self, req: RequestView) -> int:
        """Block-aligned prompt-head tokens of ``req`` resident in this
        instance's prefix cache right now (0 without a cache).  A pure
        peek: no LRU touch, no pin — policies use it to pick placements
        (e.g. a replica destination whose cache already holds the
        prefix) before the executor stamps the real hit."""
        ...


#: EWMA smoothing for :meth:`InstanceView.health` — shared by both
#: backends so the health signal (and every decision gated on it) is
#: bit-identical live vs sim.  One degraded iteration at the default
#: ``DegradeInstance.factor`` of 4.0 moves health from 1.0 to 2.5;
#: recovery decays it back under the hedge threshold within two.
HEALTH_ALPHA = 0.5


def step_health(health: float, slowdown: float) -> float:
    """One EWMA update of an instance's health toward its current
    slowdown factor — THE health arithmetic, called by both executors."""
    return health + HEALTH_ALPHA * (slowdown - health)


def usable(view: InstanceView) -> bool:
    """May new work land on this instance?  The single aliveness gate
    every kernel routes/places/promotes through: alive and not
    draining."""
    return view.alive() and not view.draining()


@runtime_checkable
class ClusterView(Protocol):
    """The whole cluster, as the policy sees it."""

    def instances(self) -> Sequence[InstanceView]: ...

    def pairs(self) -> Sequence[Tuple[InstanceView, InstanceView]]:
        """AcceLLM pair structure: (instances[2k], instances[2k+1])."""
        ...

    def placements(self) -> Mapping[int, Tuple[int, Optional[int]]]:
        """rid -> (primary instance index, replica instance index or
        None), for every request currently resident."""
        ...
