"""Step plans: the unit of batch execution an engine runs.

A copy of the JAX package's plan records that the engine consumes:

* :class:`PrefillPlan` — a batched prefill iteration of one or more
  :class:`PrefillItem` chunks, prompt lengths padded to power-of-two
  buckets (:func:`bucket_len`) so the engine sees O(log max_len) shapes;
* :class:`DecodePlan` — one (possibly fused) decode iteration over the
  instance's resident batch.

The planner that compiles policy actions into plans comes with the
cluster slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


def bucket_len(n: int, floor: int = 16, cap: Optional[int] = None) -> int:
    """Smallest power-of-two >= ``n`` (>= ``floor``), clamped to ``cap``."""
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
    prompt; anything else is a resumable chunk."""
    rid: int
    prompt_len: int
    start: int
    end: int
    #: the request record; carried for executors, excluded from equality
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
    #: padded token length of the batched whole-prompt path (power of two)
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
    #: resident primaries' KV line counts (sorted by rid)
    lengths: Tuple[int, ...] = ()
    #: how many of those primaries have a replica to mirror into
    mirrored: int = 0
    #: fused decode iterations this plan executes as one dispatch
    steps: int = 1
    #: KV-pool block granularity (lines/block) of the executing instance
    block_lines: int = 0
