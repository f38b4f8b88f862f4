"""Arrival processes: *when* requests hit the cluster.

Every process yields monotonically non-decreasing arrival times in
abstract **time units**; the consuming backend decides what a unit means
(one scheduling iteration for the live executor, one modeled second for
the discrete-event simulator).  All draws come from the caller-supplied
``numpy`` Generator, so a seeded :class:`repro_torch.workloads.RequestSource`
produces the identical stream on both backends.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np


class ArrivalProcess:
    """Base class; subclasses implement :meth:`times`."""

    #: for closed-loop processes: the number of requests kept in flight;
    #: open-loop (timed) processes leave this ``None``
    concurrency: Optional[int] = None

    def times(self, rng: np.random.Generator) -> Iterator[float]:
        raise NotImplementedError


@dataclass(frozen=True)
class Batch(ArrivalProcess):
    """``n`` requests all arriving at ``at`` — the legacy submit-everything
    -up-front pattern, kept as a degenerate arrival process so old callers
    run through the same lifecycle."""
    n: int
    at: float = 0.0

    def times(self, rng):
        for _ in range(self.n):
            yield self.at


@dataclass(frozen=True)
class Poisson(ArrivalProcess):
    """Memoryless arrivals at ``rate`` requests per time unit for
    ``duration`` units (the paper's §5.1 workload driver)."""
    rate: float
    duration: float

    def times(self, rng):
        t = 0.0
        while True:
            t += rng.exponential(1.0 / self.rate)
            if t >= self.duration:
                return
            yield t


@dataclass(frozen=True)
class Bursty(ArrivalProcess):
    """Markov-modulated on-off Poisson (MMPP): exponential ON phases at
    ``rate_on`` alternating with exponential OFF phases at ``rate_off``.
    The classic bursty-traffic model load balancers are judged under."""
    rate_on: float
    duration: float
    rate_off: float = 0.0
    mean_on: float = 1.0
    mean_off: float = 1.0

    def times(self, rng):
        t, on = 0.0, True
        phase_end = rng.exponential(self.mean_on)
        while t < self.duration:
            rate = self.rate_on if on else self.rate_off
            if rate > 0.0:
                gap = rng.exponential(1.0 / rate)
                # memorylessness makes racing the phase boundary exact
                if t + gap < phase_end:
                    t += gap
                    if t >= self.duration:
                        return
                    yield t
                    continue
            t = phase_end
            on = not on
            phase_end = t + rng.exponential(
                self.mean_on if on else self.mean_off)


@dataclass(frozen=True)
class DiurnalRamp(ArrivalProcess):
    """Non-homogeneous Poisson whose rate ramps sinusoidally from ``low``
    (at t=0) up to ``peak`` (at period/2) and back, via thinning."""
    low: float
    peak: float
    period: float
    duration: float

    def rate_at(self, t: float) -> float:
        frac = 0.5 - 0.5 * math.cos(2.0 * math.pi * t / self.period)
        return self.low + (self.peak - self.low) * frac

    def times(self, rng):
        t = 0.0
        while True:
            t += rng.exponential(1.0 / self.peak)
            if t >= self.duration:
                return
            if rng.random() * self.peak <= self.rate_at(t):
                yield t


@dataclass(frozen=True)
class ClosedLoop(ArrivalProcess):
    """``k`` synthetic users, each firing its next request the moment the
    previous one finishes.  Arrival stamps are assigned at issue time by
    the executor, so :meth:`times` yields placeholders."""
    k: int
    n_requests: int

    @property
    def concurrency(self) -> int:  # type: ignore[override]
        return self.k

    def times(self, rng):
        for _ in range(self.n_requests):
            yield 0.0


@dataclass(frozen=True)
class TraceReplay(ArrivalProcess):
    """Replays recorded arrival instants (see
    :func:`repro_torch.workloads.load_trace`); pairs with ``TraceLengths`` so a
    saved stream round-trips exactly."""
    arrivals: Sequence[float]

    def times(self, rng):
        last = 0.0
        for t in self.arrivals:
            if t < last:
                raise ValueError("trace arrivals must be non-decreasing")
            last = t
            yield t


@dataclass(frozen=True)
class TraceFileReplay(ArrivalProcess):
    """Streams arrival instants straight off a JSONL trace file
    (``load_trace(path, stream=True)``): each :meth:`times` call re-opens
    the file and yields one record at a time, so a million-request trace
    never materializes in memory.  Pairs with ``TraceFileLengths``."""
    path: str

    def times(self, rng):
        import json
        last = 0.0
        with open(self.path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                t = float(json.loads(line)["arrival"])
                if t < last:
                    raise ValueError("trace arrivals must be non-decreasing")
                last = t
                yield t
