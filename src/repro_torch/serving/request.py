"""Request lifecycle + latency bookkeeping (TTFT / TBT / JCT — AcceLLM §3.4)."""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import List, Optional

_ids = itertools.count()


class Phase(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"
    #: rejected by admission control (queue bound / deadline shed) —
    #: terminal, never served; counts as an SLO miss, not a silent drop
    SHED = "shed"
    #: cancelled mid-flight by an ``AbortRequest`` — terminal; all
    #: serving state (blocks, replicas, planner cursors) is torn down
    ABORTED = "aborted"


@dataclass
class Request:
    prompt_len: int
    max_new_tokens: int
    arrival: float = 0.0
    rid: int = field(default_factory=lambda: next(_ids))
    prompt_tokens: Optional[object] = None      # (1, prompt_len) token ids
    extra: Optional[dict] = None                # modality payload (vision/audio)
    #: shared-prefix identity from the workload layer: requests with the
    #: same prefix_id open with the same first prefix_len tokens (system
    #: prompt / conversation history).  None = no declared sharing.
    prefix_id: Optional[int] = None
    prefix_len: int = 0
    #: block-aligned prefix-cache hit, stamped once when the prefill is
    #: first scheduled (both backends stamp at action creation so the
    #: planner prices the same suffix); None = not yet consulted
    prefix_hit: Optional[int] = None
    phase: Phase = Phase.QUEUED
    generated: int = 0
    output_tokens: List[int] = field(default_factory=list)
    # timing
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    token_times: List[float] = field(default_factory=list)

    # -- serving state size (bytes of KV/SSM state at current length) -------
    @property
    def total_len(self) -> int:
        return self.prompt_len + self.generated

    @property
    def done(self) -> bool:
        return self.generated >= self.max_new_tokens

    # -- metrics -------------------------------------------------------------
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival

    def jct(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival

    def tbts(self) -> List[float]:
        return [b - a for a, b in zip(self.token_times, self.token_times[1:])]
