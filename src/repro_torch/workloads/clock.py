"""Clock abstraction: one traffic stream, two notions of time.

Arrival processes emit times in abstract units; each executor advances a
``Clock`` in its own currency and admits requests whose arrival stamp is
due.  The live executor ticks one **scheduling iteration** at a time; the
simulator jumps its clock to each event's **modeled second**.
"""
from __future__ import annotations


class Clock:
    """Monotonic backend time; ``unit`` labels reported latencies."""

    unit = "units"

    def __init__(self, now: float = 0.0):
        self.now = now

    def tick(self, dt: float = 1.0) -> float:
        self.now += dt
        return self.now

    def advance_to(self, t: float) -> float:
        if t > self.now:
            self.now = t
        return self.now

    def __repr__(self):
        return f"{type(self).__name__}(now={self.now:.3f} {self.unit})"


class IterationClock(Clock):
    """Live executor time: one tick per scheduling iteration."""

    unit = "iters"


class ModeledSecondsClock(Clock):
    """Simulator time: modeled wall seconds from the analytic PerfModel."""

    unit = "s"
