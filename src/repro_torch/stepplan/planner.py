"""The shared step planner: scheduling actions -> execution plans.

``Planner.compile(actions, view)`` groups one iteration's declarative
actions into per-instance :mod:`repro_torch.stepplan.plans` objects.  Both
backends run one planner instance per executor, configured from the same
policy kernel (``Planner.for_policy``), so an iteration's shape — what
is batched, how prompts are bucketed and chunked, whether prefill may
co-schedule with decode — is decided in exactly one place:

* **Bucketing** — whole-prompt items share a power-of-two
  ``bucket_len`` (the live backend's jit cache key; the sim prices real
  token counts).
* **Chunking** — with ``chunk_tokens`` set (Sarathi), the per-iteration
  prompt-token budget is spent across the prefill actions in order,
  in-progress prompts first; cursors are tracked here and resumed on the
  next compile, so a prompt longer than the budget spans iterations on
  *either* backend.
* **The §4.2.3 invariant** — a policy with ``allow_mixed = False``
  (AcceLLM, Splitwise) can never see prefill and decode co-scheduled on
  one instance: compile raises :class:`PlanError` instead of producing a
  :class:`MixedPlan`.

Transfer actions (``StreamState`` / ``MirrorSync`` / ``PromoteReplica``
/ ``EvictReplica``) are wrapped into :class:`TransferPlan` with the line
counts the cost model needs, resolved against the view's ledger.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

from repro_torch.stepplan.plans import (DecodePlan, MixedPlan, PlanError,
                                        PrefillItem, PrefillPlan, StepPlan,
                                        TransferPlan, bucket_len)

if TYPE_CHECKING:  # runtime import would cycle: scheduling -> live -> here
    from repro_torch.scheduling.actions import Action, Prefill


class Planner:
    def __init__(self, allow_mixed: bool = True,
                 chunk_tokens: Optional[int] = None,
                 bucket_floor: int = 16,
                 max_bucket: Optional[int] = None):
        if chunk_tokens is not None and chunk_tokens <= 0:
            raise ValueError(f"chunk_tokens must be positive: {chunk_tokens}")
        self.allow_mixed = allow_mixed
        self.chunk_tokens = chunk_tokens
        self.bucket_floor = bucket_floor
        self.max_bucket = max_bucket
        #: False when the executor cannot resume prompts mid-chunk
        #: (recurrent stacks): the chunk budget then throttles how many
        #: WHOLE prompts are planned per iteration instead of splitting
        #: them, so Sarathi's bounded-work-per-iteration contract
        #: survives on every backend.
        self.chunk_execution = True
        #: False for executors that never price plans (the live
        #: backend): DecodePlan lengths/mirrored are ledger-dict builds
        #: per instance per iteration, wasted when nothing reads them.
        #: Tracing re-enables them regardless (golden-trace equality).
        self.decode_details = True
        #: fused decode ceiling: how many decode iterations one
        #: DecodePlan may execute as a single dispatch.  1 disables
        #: fusing (seed semantics); the executor raises it for idle
        #: open-loop stretches.
        self.max_fuse_steps = 1
        #: per-iteration fuse bound set by the executor before compile
        #: (iterations until the next arrival / scheduling point; None =
        #: unbounded).  Fusing never crosses a scheduling decision.
        self.fuse_horizon: Optional[int] = None
        #: rid -> prompt tokens already prefilled (resumable chunk
        #: cursors; entries exist only while a prompt is mid-chunk).
        self._cursors: Dict[int, int] = {}
        #: optional normalized plan log (golden-trace consistency tests)
        self.trace: Optional[list] = None

    @classmethod
    def for_policy(cls, policy, max_bucket: Optional[int] = None) -> "Planner":
        """Configure a planner from a ``SchedulerPolicy`` kernel: the
        kernel declares whether it mixes phases (``allow_mixed``) and its
        chunk budget (``chunk_tokens``)."""
        return cls(allow_mixed=getattr(policy, "allow_mixed", True),
                   chunk_tokens=getattr(policy, "chunk_tokens", None),
                   max_bucket=max_bucket)

    # -- cursor feedback ------------------------------------------------------
    def cursor(self, rid: int) -> int:
        """Prompt tokens of ``rid`` already planned (0 = not started or
        finished).  Executor views report chunk progress through this,
        so policy kernels see planner feedback (backlog tokens shrink as
        chunks land)."""
        return self._cursors.get(rid, 0)

    def forget(self, rid: int):
        """Drop the chunk cursor of an abandoned request."""
        self._cursors.pop(rid, None)

    # -- compilation ----------------------------------------------------------
    def compile(self, actions: Sequence["Action"], view) -> List[StepPlan]:
        """Group one iteration's actions into per-instance plans.

        Prefill/Decode actions merge into PrefillPlan / DecodePlan /
        MixedPlan per instance (first-seen instance order); transfer
        actions are wrapped in order after them."""
        from repro_torch.scheduling.actions import Decode, Prefill
        prefills: Dict[int, List["Prefill"]] = {}
        decodes = set()
        order: List[int] = []
        transfers: List["Action"] = []
        for act in actions:
            if isinstance(act, Prefill):
                if act.instance not in prefills and act.instance not in decodes:
                    order.append(act.instance)
                prefills.setdefault(act.instance, []).append(act)
            elif isinstance(act, Decode):
                if act.instance not in prefills and act.instance not in decodes:
                    order.append(act.instance)
                decodes.add(act.instance)
            else:
                transfers.append(act)

        plans: List[StepPlan] = []
        for idx in order:
            pplan = None
            acts = prefills.get(idx, [])
            items = self._plan_items(acts)
            if items:
                bucket = bucket_len(
                    max((it.prompt_len for it in items if it.completes
                         and it.start == 0), default=0),
                    floor=self.bucket_floor, cap=self.max_bucket)
                pplan = PrefillPlan(idx, tuple(items), bucket,
                                    self.chunk_tokens)
            dplan = self._decode_plan(idx, view) if idx in decodes else None
            if pplan is not None and dplan is not None:
                if not self.allow_mixed:
                    raise PlanError(
                        f"instance {idx}: prefill and decode co-scheduled in "
                        f"one iteration, but this policy forbids mixing "
                        f"(AcceLLM §4.2.3: prefill and decode are never "
                        f"co-scheduled on one instance)")
                plan: StepPlan = MixedPlan(idx, pplan, dplan)
            else:
                plan = pplan if pplan is not None else dplan
            if plan is not None:
                plans.append(plan)
                self._note(plan)
        for act in transfers:
            plans.append(self._wrap_transfer(act, view))
        return plans

    # -- chunking (resumable cursors) -----------------------------------------
    @staticmethod
    def _hit(act: "Prefill") -> int:
        """Prefix-cache hit stamped on the request at action creation:
        the prefill starts past it — chunk cursors are seeded there and
        whole-prompt items price only the suffix.  Both backends stamp
        before compile, so plans (and golden traces) agree."""
        return int(getattr(act.req, "prefix_hit", 0) or 0)

    def _plan_items(self, acts: Sequence["Prefill"]) -> List[PrefillItem]:
        items: List[PrefillItem] = []
        if self.chunk_tokens is None:
            for act in acts:
                items.append(PrefillItem(act.rid, act.prompt_len,
                                         self._hit(act),
                                         act.prompt_len, req=act.req))
            return items
        budget = self.chunk_tokens
        for act in acts:
            if budget <= 0:
                break
            if not self.chunk_execution:
                # whole-prompt throttle: always admit the first prompt
                # (so oversized prompts cannot starve), further ones
                # only while the budget lasts (engines without chunk
                # resume have no prefix cache either: start stays 0)
                if items and act.prompt_len > budget:
                    break
                items.append(PrefillItem(act.rid, act.prompt_len, 0,
                                         act.prompt_len, req=act.req))
                budget -= act.prompt_len
                continue
            cur = self._cursors.get(act.rid, self._hit(act))
            take = min(max(act.prompt_len - cur, 0), budget)
            if take <= 0 and cur >= act.prompt_len:
                continue
            end = cur + take
            items.append(PrefillItem(act.rid, act.prompt_len, cur, end,
                                     req=act.req))
            budget -= take
            if end >= act.prompt_len:
                self._cursors.pop(act.rid, None)
            else:
                self._cursors[act.rid] = end
        return items

    # -- decode stats from the view ledger ------------------------------------
    def _decode_plan(self, idx: int, view) -> DecodePlan:
        # the per-iteration ledger summaries are skipped whenever they
        # can't be consumed: executor doesn't price plans, no trace, and
        # fusing is off — statically (max_fuse_steps) or for THIS
        # iteration (the executor's fuse_horizon says a scheduling
        # point is due next tick anyway)
        horizon = (self.fuse_horizon if self.fuse_horizon is not None
                   else self.max_fuse_steps)
        fusing = self.max_fuse_steps > 1 and horizon > 1
        if not self.decode_details and self.trace is None and not fusing:
            return DecodePlan(idx)
        inst = view.instances()[idx]
        bl = inst.block_lines() if hasattr(inst, "block_lines") else 0
        stats = getattr(inst, "decode_plan_stats", None)
        if stats is not None:
            # array-backed views (repro.scale) serve the rid-ordered
            # length tuple + mirrored count straight from their caches —
            # same values as the dict walk below, no dicts built
            lengths, mirrored = stats()
            if not lengths:
                return DecodePlan(idx, block_lines=bl)
            return DecodePlan(idx, lengths, mirrored,
                              steps=self._fuse_steps(inst, mirrored),
                              block_lines=bl)
        lines = inst.request_lines()
        if not lines:
            # membership is resolved at execution time (a request may
            # stream in post-prefill, within the iteration); an empty
            # plan prices to zero on the sim side
            return DecodePlan(idx, block_lines=bl)
        placements = view.placements()
        mirrored = sum(1 for rid in lines
                       if placements.get(rid, (None, None))[1] is not None)
        lengths = tuple(l for _, l in sorted(lines.items()))
        return DecodePlan(idx, lengths, mirrored,
                          steps=self._fuse_steps(inst, mirrored),
                          block_lines=bl)

    def _fuse_steps(self, inst, mirrored: int) -> int:
        """How many decode iterations this instance may run as one fused
        dispatch.  Mirror-bound decode (any resident request with a
        replica) keeps ``steps == 1``: its per-step ``MirrorSync`` is a
        scheduling point the fused scan must not run past.  So does a
        non-empty prefill backlog — the instance's role can flip next
        iteration.  Otherwise the executor's ``fuse_horizon`` (time to
        the next arrival) and the residents' shortest remaining token
        budget cap the span, so a fused block never runs past the
        iteration its first request completes."""
        n = min(self.max_fuse_steps,
                self.fuse_horizon if self.fuse_horizon is not None
                else self.max_fuse_steps)
        if n <= 1 or mirrored or inst.prefill_backlog():
            return 1
        if hasattr(inst, "decode_remaining"):
            rem = inst.decode_remaining()
            if rem:
                n = min(n, max(1, min(rem.values())))
        # floor to a power of two: `steps` is a static shape of the live
        # backend's jitted scan, so arbitrary horizon values would each
        # compile a fresh kernel (flooring never overruns a scheduling
        # point, it only ends the span early)
        return 1 << (n.bit_length() - 1)

    # -- transfer wrapping ----------------------------------------------------
    def _wrap_transfer(self, act: "Action", view) -> TransferPlan:
        from repro_torch.scheduling.actions import (EvictReplica, MirrorSync,
                                                    PromoteReplica, StreamState)
        if isinstance(act, StreamState):
            lines = view.instances()[act.src].request_lines().get(act.rid, 0)
            # lines already resident in the destination's prefix cache
            # don't move: a shared-prefix replica streams its unique
            # suffix only
            lines = max(0, lines - getattr(act, "skip_lines", 0))
            return TransferPlan(act.src, act, lines=lines,
                                overlap_layers=True)
        if isinstance(act, MirrorSync):
            lo, hi = act.from_line, act.to_line
            if hi is None:
                hi = view.instances()[act.primary].request_lines().get(
                    act.rid, 0)
            if lo is None:
                lo = view.instances()[act.replica].replica_synced().get(
                    act.rid, 0)
            return TransferPlan(act.primary, act, lines=max(0, hi - lo))
        if isinstance(act, (PromoteReplica, EvictReplica)):
            inst = act.src if isinstance(act, PromoteReplica) else act.instance
            return TransferPlan(inst, act, lines=0)
        raise PlanError(f"cannot wrap action {act!r} into a transfer plan")

    # -- trace ----------------------------------------------------------------
    def _note(self, plan: StepPlan):
        if self.trace is None:
            return
        if isinstance(plan, DecodePlan) and not plan.lengths:
            return      # empty decode: a no-op placeholder, not work
        self.trace.append(_normalize(plan))


def _normalize(plan: StepPlan):
    """Backend-independent plan descriptor for golden-trace equality."""
    if isinstance(plan, MixedPlan):
        if plan.decode is None or not plan.decode.lengths:
            # nothing was resident to co-batch: this iteration IS a
            # prefill (the empty decode part only lets the live executor
            # run the same-iteration join)
            return _normalize(plan.prefill)
        return ("mixed", plan.instance, _normalize(plan.prefill)[2:],
                _normalize(plan.decode)[2:])
    if isinstance(plan, PrefillPlan):
        return ("prefill", plan.instance,
                tuple((it.rid, it.start, it.end) for it in plan.items),
                plan.bucket_len)
    if isinstance(plan, DecodePlan):
        # block_lines is a pricing detail, not iteration shape: excluded
        return ("decode", plan.instance, plan.lengths, plan.mirrored,
                plan.steps)
    return ("transfer", plan.instance, type(plan.action).__name__, plan.lines)
