"""Fleet layer: one deterministic event schedule, two executors.

``FleetSchedule`` (fixed / Poisson-MTBF / JSONL replay) yields the
identical kill/join/drain stream for the live cluster's iteration clock
and the simulator's modeled seconds; ``FleetController`` paces it,
plans failover from the shared scheduling views, and records the
decision trace both backends must agree on.

A copy of the JAX package's ``repro.fleet``, held against it by
``tests/test_torch_fleet.py``.
"""
from repro_torch.fleet.controller import (FailoverPlan, FleetController,
                                          Promotion, reset_for_reprefill,
                                          rollback_tokens)
from repro_torch.fleet.events import (DegradeInstance, Drain, FixedFleet,
                                      FleetEvent, FleetSchedule,
                                      FleetTraceReplay, JoinInstance,
                                      KillInstance, PoissonDegradations,
                                      PoissonFailures, RecoverInstance,
                                      load_fleet_trace, save_fleet_trace)

__all__ = [
    "KillInstance", "JoinInstance", "Drain", "DegradeInstance",
    "RecoverInstance", "FleetEvent",
    "FleetSchedule", "FixedFleet", "FleetTraceReplay", "PoissonFailures",
    "PoissonDegradations",
    "save_fleet_trace", "load_fleet_trace",
    "FleetController", "FailoverPlan", "Promotion",
    "reset_for_reprefill", "rollback_tokens",
]
