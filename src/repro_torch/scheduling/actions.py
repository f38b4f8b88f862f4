"""Declarative scheduling actions (the policy -> executor contract).

A ``SchedulerPolicy`` never mutates engines or simulator state directly: it
*describes* what should happen as a list of actions, and each backend's
executor (``repro_torch.scheduling.live`` for real JAX engines, the adapters in
``repro.sim.policies`` for the discrete-event simulator) interprets them
with its own mechanics and cost model.  Instance references are the global
instance index, which is the same numbering on both backends
(``InstanceEngine.instance_id`` / ``SimInstance.iid``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union


@dataclass(frozen=True)
class Prefill:
    """Run the prompt of ``rid`` on ``instance``.  Carries the prompt
    length (and, for executors, the request record itself) so the step
    planner can bucket and chunk the work without backend lookups."""
    rid: int
    instance: int
    prompt_len: int = 0
    #: backend request record (live ``Request`` / ``SimRequest``);
    #: excluded from action equality.
    req: object = field(default=None, compare=False, repr=False)


@dataclass(frozen=True)
class Decode:
    """Run one decode iteration over ``instance``'s resident batch."""
    instance: int


@dataclass(frozen=True)
class StreamState:
    """Move or copy a request's serving state between instances
    (AcceLLM §4.1.2 KV streaming).  Executors move it as *per-layer
    chunks* (``PagedStore.stream_slot``), the granularity a real mesh
    overlaps with prefill compute — only the last layer's worth is
    exposed latency (§4.2.4).

    ``as_replica``      — the copy lands on ``dst`` as a *replica*; the
                          primary stays at ``src``.
    ``retain_replica``  — the primary moves to ``dst`` and ``src`` keeps
                          its copy as the replica.
    Neither flag set    — plain primary migration (Splitwise-style
                          post-prefill KV transfer); ``src`` releases.
    """
    rid: int
    src: int
    dst: int
    as_replica: bool = False
    retain_replica: bool = False
    #: head lines already resident in ``dst``'s prefix cache: the stream
    #: (and its pricing) covers only the unique suffix — a shared-prefix
    #: replica costs almost no extra transfer or HBM
    skip_lines: int = 0


@dataclass(frozen=True)
class MirrorSync:
    """Mirror KV lines ``[from_line, to_line)`` of ``rid`` from its
    primary into its replica (AcceLLM §4.1.2: "newly computed KV cache
    lines are transferred back").  Delta semantics: executors copy ONLY
    those lines (plus the constant-size recurrent state) — one line per
    decode step in steady state, O(1) in sequence length, not
    O(kv_capacity).  ``None`` bounds mean "from the replica's synced
    mark" / "to the primary's current lines", resolved against the
    executor's ledger."""
    rid: int
    primary: int
    replica: int
    from_line: Optional[int] = None
    to_line: Optional[int] = None


@dataclass(frozen=True)
class PromoteReplica:
    """Zero-cost role flip (AcceLLM §4.1.3): the replica of ``rid`` on
    ``dst`` becomes the primary; the old primary on ``src`` becomes the
    replica.  ``hedge`` marks a straggler hedge — the flip was taken
    because ``src``'s health EWMA crossed the hedging threshold, not for
    load balance; executors count these separately."""
    rid: int
    src: int
    dst: int
    hedge: bool = False


@dataclass(frozen=True)
class EvictReplica:
    """Drop the replica of ``rid`` held on ``instance``, returning its
    blocks to the instance's pool (graceful degradation, AcceLLM
    §4.2.5)."""
    rid: int
    instance: int


@dataclass(frozen=True)
class AbortRequest:
    """Cancel ``rid`` wherever it is in its lifecycle — queued, mid
    prefill chunk, or decoding.  Executors tear down *all* of its
    serving state: ledger ``free`` of its blocks, prefix-cache unpin,
    replica drop on the mirror, and planner cursor cleanup.  The request
    record survives with ``Phase.ABORTED`` so metrics count it."""
    rid: int


Action = Union[Prefill, Decode, StreamState, MirrorSync, PromoteReplica,
               EvictReplica, AbortRequest]
