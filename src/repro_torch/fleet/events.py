"""Fleet events: *when* instances die, join, or drain.

The fleet analogue of :mod:`repro_torch.workloads.arrivals` — a
:class:`FleetSchedule` yields monotonically non-decreasing fleet events
in abstract **time units** (one scheduling iteration on the live
executor, one modeled second in the simulator), drawn from a seeded
``numpy`` Generator so the identical event stream hits both backends.
Schedules come in the same three shapes as traffic: fixed instants
(:class:`FixedFleet`), a seeded stochastic process
(:class:`PoissonFailures` — exponential inter-failure gaps, the MTBF
model), and JSONL trace replay (:func:`load_fleet_trace`).

A copy of the JAX package's ``repro.fleet.events``, held against it by
``tests/test_torch_fleet.py``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np


@dataclass(frozen=True)
class KillInstance:
    """Instance ``instance`` fails abruptly at ``t``: every byte of its
    serving state (primaries, replicas, prefill backlog) is lost."""
    t: float
    instance: int
    kind = "kill"


@dataclass(frozen=True)
class JoinInstance:
    """A fresh instance comes up at ``t``.  ``instance`` names a dead
    index to revive (replacement hardware at the same rank); ``None``
    appends a brand-new index — warm autoscaling."""
    t: float
    instance: Optional[int] = None
    kind = "join"


@dataclass(frozen=True)
class Drain:
    """Instance ``instance`` stops taking new work at ``t`` and leaves
    the fleet once its resident requests complete — graceful scale-down
    (the k8s cordon+drain shape)."""
    t: float
    instance: int
    kind = "drain"


@dataclass(frozen=True)
class DegradeInstance:
    """Instance ``instance`` turns into a straggler at ``t`` — still
    alive, still correct, just slow (thermal throttle, a noisy
    neighbor, a browned-out link).  ``factor`` scales its compute step
    times and ``link_factor`` its transfer times until a matching
    :class:`RecoverInstance` lands."""
    t: float
    instance: int
    factor: float = 4.0
    link_factor: float = 1.0
    kind = "degrade"


@dataclass(frozen=True)
class RecoverInstance:
    """Instance ``instance`` returns to full speed at ``t``."""
    t: float
    instance: int
    kind = "recover"


FleetEvent = Union[KillInstance, JoinInstance, Drain, DegradeInstance,
                   RecoverInstance]


class FleetSchedule:
    """Base class; subclasses implement :meth:`events`."""

    def events(self, rng: np.random.Generator) -> Iterator[FleetEvent]:
        raise NotImplementedError

    def stream(self, seed: int = 0) -> List[FleetEvent]:
        """The full event list for one run, time-sorted (stable, so
        same-instant events keep their emission order)."""
        evs = list(self.events(np.random.default_rng(seed)))
        return sorted(evs, key=lambda e: e.t)

    def describe(self) -> str:
        return f"fleet schedule: {self!r}"


@dataclass(frozen=True)
class FixedFleet(FleetSchedule):
    """A literal event list — the fleet analogue of ``TraceReplay``, and
    the deterministic form every other schedule reduces to via
    :meth:`FleetSchedule.stream`."""
    fleet_events: Tuple[FleetEvent, ...] = ()

    def events(self, rng):
        yield from self.fleet_events


@dataclass(frozen=True)
class PoissonFailures(FleetSchedule):
    """Seeded memoryless failures: exponential gaps with mean ``mtbf``
    over ``duration`` time units, each killing a uniformly chosen
    instance.  With ``recovery`` set, replacement hardware revives the
    same index ``recovery`` units after each kill (the kill/join churn
    of a preemptible fleet)."""
    mtbf: float
    duration: float
    n_instances: int
    recovery: Optional[float] = None

    def events(self, rng):
        t = 0.0
        while True:
            t += rng.exponential(self.mtbf)
            if t >= self.duration:
                return
            victim = int(rng.integers(self.n_instances))
            yield KillInstance(t, victim)
            if self.recovery is not None:
                yield JoinInstance(t + self.recovery, victim)


@dataclass(frozen=True)
class PoissonDegradations(FleetSchedule):
    """Seeded memoryless *partial* failures — the straggler analogue of
    :class:`PoissonFailures`.  Exponential gaps with mean ``mtbf`` over
    ``duration`` time units, each degrading a uniformly chosen instance
    by ``factor`` (and its links by ``link_factor``); with ``recovery``
    set the instance returns to full speed ``recovery`` units later."""
    mtbf: float
    duration: float
    n_instances: int
    recovery: Optional[float] = None
    factor: float = 4.0
    link_factor: float = 1.0

    def events(self, rng):
        t = 0.0
        while True:
            t += rng.exponential(self.mtbf)
            if t >= self.duration:
                return
            victim = int(rng.integers(self.n_instances))
            yield DegradeInstance(t, victim, self.factor, self.link_factor)
            if self.recovery is not None:
                yield RecoverInstance(t + self.recovery, victim)


# ---------------------------------------------------------------------------
# JSONL trace round-trip (mirrors repro_torch.workloads.spec.save_trace)
# ---------------------------------------------------------------------------


def save_fleet_trace(path, events: Sequence[FleetEvent]) -> int:
    """Write a fleet event stream as JSONL ({t, event, instance} per
    line); returns the number of records written."""
    n = 0
    with open(path, "w") as fh:
        for ev in events:
            rec = {"t": ev.t, "event": ev.kind, "instance": ev.instance}
            if ev.kind == "degrade":
                rec["factor"] = ev.factor
                rec["link_factor"] = ev.link_factor
            fh.write(json.dumps(rec) + "\n")
            n += 1
    return n


def _parse_fleet_record(rec) -> FleetEvent:
    kinds = {"kill": KillInstance, "join": JoinInstance, "drain": Drain,
             "degrade": DegradeInstance, "recover": RecoverInstance}
    cls = kinds[rec["event"]]
    instance = rec.get("instance")
    if instance is not None:
        instance = int(instance)
    elif cls is not JoinInstance:
        raise ValueError(f"{rec['event']} event needs an instance")
    if cls is DegradeInstance:
        return cls(float(rec["t"]), instance,
                   float(rec.get("factor", 4.0)),
                   float(rec.get("link_factor", 1.0)))
    return cls(float(rec["t"]), instance)


@dataclass(frozen=True)
class FleetTraceReplay(FleetSchedule):
    """Streams fleet events straight off a JSONL trace file
    (``load_fleet_trace(path, stream=True)``) — the fleet analogue of
    ``TraceFileReplay``: each :meth:`events` call re-opens the file and
    yields one record at a time, never holding the trace in memory."""
    path: str

    def events(self, rng):
        with open(self.path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                yield _parse_fleet_record(json.loads(line))


def load_fleet_trace(path, stream: bool = False):
    """Read a JSONL fleet trace back into a replayable schedule.  With
    ``stream=True`` the schedule replays lazily off the file
    (:class:`FleetTraceReplay`) instead of materializing an event tuple."""
    if stream:
        return FleetTraceReplay(str(path))
    events: List[FleetEvent] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            events.append(_parse_fleet_record(json.loads(line)))
    return FixedFleet(tuple(events))
