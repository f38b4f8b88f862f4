"""Step plans: the backend-agnostic unit of batch execution.

A *step plan* describes what one scheduling iteration executes on one
instance — the layer between the policy's declarative actions
(:mod:`repro_torch.scheduling.actions`) and the backends.  The shared
:class:`repro_torch.stepplan.Planner` compiles actions into plans; the live
executor *runs* them (``InstanceEngine.prefill_batch`` / ``decode``) and
the simulator *prices* them through the single cost entry point
``PerfModel.plan_time(plan)``.  Because both backends consume the
identical plan objects, live-vs-sim iteration semantics are comparable
by construction — the same way the traffic layer made time comparable
and the KV store made bytes comparable.

Plan vocabulary:

* :class:`PrefillPlan` — a batched prefill iteration: one or more
  :class:`PrefillItem` chunks, prompt lengths padded to power-of-two
  buckets (``bucket_len``) so the live engine compiles one kernel per
  bucket shape instead of one per distinct prompt length.  Items may be
  *chunks* of a prompt (Sarathi-style intra-prompt chunking) with
  resumable cursors over the KV ledger.
* :class:`DecodePlan` — one decode iteration over the instance's
  resident batch; carries the per-request line counts (the cost model's
  input) and the number of mirrored requests (whose per-step replica
  sync may bound the step, paper Fig. 10).
* :class:`MixedPlan` — prefill and decode co-scheduled in one iteration.
  Only baselines that deliberately mix (vLLM / Sarathi) may produce
  these; the planner *rejects* them for the AcceLLM policy — the §4.2.3
  invariant lives in one place instead of three executors.
* :class:`TransferPlan` — a state-movement action (``StreamState`` /
  ``MirrorSync`` / ``PromoteReplica`` / ``EvictReplica``) wrapped with
  the line count the cost model needs to price it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Optional, Tuple, Union

if TYPE_CHECKING:  # runtime import would cycle: scheduling -> live -> here
    from repro_torch.scheduling.actions import Action


class PlanError(RuntimeError):
    """Raised when actions cannot be compiled into a legal plan (e.g.
    prefill+decode mixing under a policy that forbids it, §4.2.3)."""


def bucket_len(n: int, floor: int = 16, cap: Optional[int] = None) -> int:
    """Smallest power-of-two >= ``n`` (>= ``floor``), clamped to ``cap``.

    This is the padded shape a live backend compiles for: a stream of
    arbitrary prompt lengths maps onto O(log(max_len)) compiled kernels
    instead of one per distinct length."""
    b = max(1, floor)
    while b < n:
        b <<= 1
    if cap is not None:
        b = min(b, cap)
    return b


@dataclass(frozen=True)
class PrefillItem:
    """One request's share of a prefill iteration: prompt tokens
    ``[start, end)``.  ``start == 0 and end == prompt_len`` is a whole
    prompt; anything else is a resumable chunk whose cursor the planner
    tracks against the KV ledger."""
    rid: int
    prompt_len: int
    start: int
    end: int
    #: the backend's request record (live ``Request`` / ``SimRequest``);
    #: carried for executors, excluded from plan equality.
    req: object = field(default=None, compare=False, repr=False)

    @property
    def tokens(self) -> int:
        return self.end - self.start

    @property
    def completes(self) -> bool:
        """Whether this item finishes its request's prefill."""
        return self.end >= self.prompt_len


@dataclass(frozen=True)
class PrefillPlan:
    instance: int
    items: Tuple[PrefillItem, ...]
    #: padded token length of the batched whole-prompt path (power of
    #: two; the jit cache key on the live backend).
    bucket_len: int
    #: the per-iteration prompt-token budget that produced the items
    #: (None = unchunked).
    chunk_tokens: Optional[int] = None

    @property
    def total_tokens(self) -> int:
        return sum(it.tokens for it in self.items)

    def completed_rids(self) -> Tuple[int, ...]:
        return tuple(it.rid for it in self.items if it.completes)


@dataclass(frozen=True)
class DecodePlan:
    instance: int
    #: resident primaries' KV line counts (sorted by rid) — the decode
    #: cost model's input on the sim backend.
    lengths: Tuple[int, ...] = ()
    #: how many of those primaries have a replica to mirror into; their
    #: per-step sync traffic may bound the step (Fig. 10).
    mirrored: int = 0
    #: fused decode iterations this plan executes as one dispatch
    #: (``Planner`` decides; mirror-bound decode keeps ``steps == 1`` so
    #: every generated line syncs to its replica the same iteration).
    #: The live engine runs them as a single jitted ``lax.scan``; the
    #: cost model amortizes the per-dispatch overhead across them.
    steps: int = 1
    #: KV-pool block granularity (lines/block) of the executing
    #: instance: the paged gather reads whole blocks, so the cost model
    #: rounds each request's lines up to it (0 = price exact lines).
    block_lines: int = 0


@dataclass(frozen=True)
class MixedPlan:
    """Prefill co-scheduled with decode (vLLM / Sarathi baselines only —
    the planner refuses to build these for policies with
    ``allow_mixed = False``)."""
    instance: int
    prefill: PrefillPlan
    decode: Optional[DecodePlan] = None


@dataclass(frozen=True)
class TransferPlan:
    """A state-movement action plus the ledger quantities that price it:
    ``lines`` is the whole-state line count for a ``StreamState`` (or
    the delta line count for a ``MirrorSync``)."""
    instance: int
    action: "Action" = field(compare=False)
    lines: int = 0
    #: per-layer streamed transfer (§4.2.4): only the last layer's worth
    #: is exposed latency.
    overlap_layers: bool = False
    #: which fabric the bytes ride (repro.meshserve): ``"inter"`` is the
    #: instance-to-instance network link (mirror/stream between mesh
    #: slices); ``"intra"`` is the NVLink/ICI-class link within one
    #: slice.  The cost model picks the matching ``InstanceSpec``
    #: bandwidth; every transfer the planner emits today is inter-slice.
    link: str = "inter"


StepPlan = Union[PrefillPlan, DecodePlan, MixedPlan, TransferPlan]


def prefill_part(plan: StepPlan) -> Optional[PrefillPlan]:
    """The prefill work inside ``plan``, unwrapping MixedPlan."""
    if isinstance(plan, MixedPlan):
        return plan.prefill
    return plan if isinstance(plan, PrefillPlan) else None


def decode_part(plan: StepPlan) -> Optional[DecodePlan]:
    """The decode work inside ``plan``, unwrapping MixedPlan."""
    if isinstance(plan, MixedPlan):
        return plan.decode
    return plan if isinstance(plan, DecodePlan) else None
