"""Backend-agnostic traffic layer: one workload kernel, two clocks.

A copy of the JAX package's ``repro.workloads``, held against it by
``tests/test_torch_scheduling.py``.  ``WorkloadSpec`` (arrival process ×
length model × modality extras) produces a deterministic
``RequestSource`` that the live executor
(``repro_torch.scheduling.live``) consumes; ``Clock`` maps the stream's
abstract time units onto scheduling iterations.  ``SLO`` /
``slo_summary`` score the output on attainment and goodput.

One divergence by design: ``RequestSource`` draws prompt tokens with
numpy where the JAX package draws them with ``jax.random``, so token
ids differ between the packages while every other field of a stream
(rid, arrival, lengths, prefix groups) is identical.
"""
from repro_torch.workloads.arrivals import (ArrivalProcess, Batch, Bursty,
                                            ClosedLoop, DiurnalRamp, Poisson,
                                            TraceFileReplay, TraceReplay)
from repro_torch.workloads.clock import (Clock, IterationClock,
                                         ModeledSecondsClock)
from repro_torch.workloads.lengths import (TABLE2, LengthModel,
                                           LognormalLengths, TableLengths,
                                           TraceFileLengths, TraceLengths,
                                           UniformLengths)
from repro_torch.workloads.metrics import (SLO, SLOSummary, TimelinePoint,
                                           queue_depth_stats, slo_summary,
                                           utilization)
from repro_torch.workloads.spec import (PrefixReuse, RequestSource,
                                        WorkloadSpec, default_extras,
                                        load_trace, save_trace, table2_spec)

__all__ = [
    "ArrivalProcess", "Batch", "Poisson", "Bursty", "DiurnalRamp",
    "ClosedLoop", "TraceReplay", "TraceFileReplay",
    "LengthModel", "TableLengths", "UniformLengths", "LognormalLengths",
    "TraceLengths", "TraceFileLengths", "TABLE2",
    "Clock", "IterationClock", "ModeledSecondsClock",
    "SLO", "SLOSummary", "TimelinePoint", "slo_summary", "utilization",
    "queue_depth_stats",
    "WorkloadSpec", "RequestSource", "PrefixReuse", "default_extras",
    "save_trace", "load_trace", "table2_spec",
]
