"""Simulator-side view of the shared traffic layer.

The workload kernel itself lives in :mod:`repro_torch.workloads` (arrival
processes × length models × the Table-2 ranges); this module keeps the
simulator's historical entry points as thin adapters over it:

* :class:`SimRequest` — the shared request record
  (:class:`repro_torch.serving.request.Request`) under its simulator
  constructor signature (``decode_len`` aliasing ``max_new_tokens``).
  Metric guards (``ttft()``/``jct()`` returning ``None`` while
  unfinished) are inherited from the shared record.
* :func:`make_workload` — the paper's Poisson × Table-2 stream, now
  generated by a :class:`repro_torch.workloads.WorkloadSpec` (draw-for-draw
  identical to the pre-refactor generator for any seed).

A copy of the JAX package's ``repro.sim.workload``, held against it by
``tests/test_torch_sim.py``.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.serving.request import Request
from repro_torch.workloads import TABLE2, table2_spec

#: legacy alias for the paper's Table 2 ranges
WORKLOADS = TABLE2


class SimRequest(Request):
    """The shared request record, constructible the way simulator code
    always has: ``SimRequest(rid=, arrival=, prompt_len=, decode_len=)``."""

    def __init__(self, rid: Optional[int] = None, arrival: float = 0.0,
                 prompt_len: int = 0, decode_len: int = 0, **kwargs):
        super().__init__(prompt_len=prompt_len, max_new_tokens=decode_len,
                         arrival=arrival, **kwargs)
        if rid is not None:
            self.rid = rid

    @property
    def decode_len(self) -> int:
        return self.max_new_tokens


def make_workload(name: str, rate: float, duration: float,
                  seed: int = 0) -> List[SimRequest]:
    """Poisson arrivals at ``rate`` req/s for ``duration`` seconds with
    uniform prompt/decode lengths per the paper's Table 2."""
    return [SimRequest(rid=r.rid, arrival=r.arrival,
                       prompt_len=r.prompt_len, decode_len=r.max_new_tokens)
            for r in table2_spec(name, rate=rate, duration=duration).source(
                seed=seed)]
