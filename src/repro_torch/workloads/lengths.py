"""Length models: *how big* each request is (prompt and decode tokens).

``TABLE2`` holds the paper's Table 2 ranges; ``TableLengths`` is the
single implementation of its uniform sampling (previously duplicated
between ``repro.api.sample_requests`` and ``repro.sim.workload``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

#: name -> ((prompt lo, hi), (decode lo, hi)) — paper Table 2
TABLE2 = {
    "light": ((20, 500), (20, 500)),
    "mixed": ((20, 1000), (20, 1000)),
    "heavy": ((500, 1000), (500, 1000)),
}


class LengthModel:
    """Base class; ``sample`` draws (prompt_len, decode_len) for the
    ``i``-th request of the stream."""

    def sample(self, rng: np.random.Generator, i: int) -> Tuple[int, int]:
        raise NotImplementedError


@dataclass(frozen=True)
class TableLengths(LengthModel):
    """Uniform prompt/decode lengths per the paper's Table 2, optionally
    scaled down (``scale`` < 1) for CPU-sized live engines."""
    workload: str = "mixed"
    scale: float = 1.0
    min_prompt: int = 4
    min_decode: int = 2

    def sample(self, rng, i):
        (plo, phi), (dlo, dhi) = TABLE2[self.workload]
        plen = max(self.min_prompt, int(rng.integers(plo, phi + 1) * self.scale))
        dlen = max(self.min_decode, int(rng.integers(dlo, dhi + 1) * self.scale))
        return plen, dlen


@dataclass(frozen=True)
class UniformLengths(LengthModel):
    """Uniform lengths over explicit inclusive ranges."""
    prompt: Tuple[int, int]
    decode: Tuple[int, int]

    def sample(self, rng, i):
        return (int(rng.integers(self.prompt[0], self.prompt[1] + 1)),
                int(rng.integers(self.decode[0], self.decode[1] + 1)))


@dataclass(frozen=True)
class LognormalLengths(LengthModel):
    """Heavy-tailed lengths (production traces are closer to lognormal
    than to Table 2's uniform ranges — e.g. BurstGPT / Azure traces)."""
    prompt_median: float
    decode_median: float
    prompt_sigma: float = 0.8
    decode_sigma: float = 0.8
    max_prompt: int = 8192
    max_decode: int = 8192

    def sample(self, rng, i):
        plen = int(np.exp(rng.normal(np.log(self.prompt_median),
                                     self.prompt_sigma)))
        dlen = int(np.exp(rng.normal(np.log(self.decode_median),
                                     self.decode_sigma)))
        return (min(max(1, plen), self.max_prompt),
                min(max(1, dlen), self.max_decode))


@dataclass(frozen=True)
class TraceLengths(LengthModel):
    """Replays recorded (prompt_len, decode_len) pairs by stream index."""
    pairs: Sequence[Tuple[int, int]]

    def sample(self, rng, i):
        plen, dlen = self.pairs[i]
        return int(plen), int(dlen)


@dataclass(frozen=True)
class TraceFileLengths(LengthModel):
    """Streams (prompt_len, decode_len) pairs off a JSONL trace file
    (``load_trace(path, stream=True)``) with a forward-only cursor:
    ``RequestSource`` samples indices 0, 1, 2, ... in order, so each line
    is read exactly when needed and the trace never lives in memory.  A
    rewind (a fresh source re-iterating from index 0) re-opens the file."""
    path: str

    def __post_init__(self):
        object.__setattr__(self, "_fh", None)
        object.__setattr__(self, "_next", 0)

    def _reopen(self):
        fh = self.__dict__.get("_fh")
        if fh is not None:
            fh.close()
        object.__setattr__(self, "_fh", open(self.path))
        object.__setattr__(self, "_next", 0)

    def sample(self, rng, i):
        import json
        if self.__dict__.get("_fh") is None or i < self._next:
            self._reopen()
        fh = self._fh
        rec = None
        while self._next <= i:
            line = fh.readline()
            if not line:
                raise IndexError(
                    f"trace {self.path!r} has no record {i}")
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            object.__setattr__(self, "_next", self._next + 1)
        return int(rec["prompt_len"]), int(rec["decode_len"])
