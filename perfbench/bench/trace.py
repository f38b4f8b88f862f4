"""The device trace of a window, from ``torch.profiler`` (CUPTI), reduced
to what the per-layer metrics read.

The profiler records the device's activities and the runtime calls that
launched them, CUDA activity only: recording every host operator as well
doubles a step's host time and would skew every host-clock metric of the
traced run.  The harness's spans (``bench.probes``) bracket their calls
with sentinel runtime calls, and the runtime numbers every call in call
order (its correlation id, which its activity carries), so a span's
activities are those whose launch lies between its two sentinels, and the
sentinels' own timestamps put the span on the trace's clock.

* ``busy_s``: the union of every device activity's interval (kernels,
  copies, sets), so overlapping work counts once;
* ``by_range``: device seconds of the activities each kind of span
  launched (a kernel launched inside ``bench.flash``, itself inside
  ``bench.prefill``, counts for both);
* ``device_ops``: device seconds by activity name, the largest first;
* ``idle_gaps``: the longest stretches with nothing on the device, each
  named by the innermost span the host was in at its middle.

The sums by name follow ``chip_smoke.py``'s ``_kernel_times`` and
``_breakdown`` (the same profiler); the union and the attribution are
added.
"""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

SENTINEL = "cudaStreamQuery"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    #: None where the sentinels did not match the spans' marks
    by_range: Optional[Dict[str, float]]
    launches_by_range: Dict[str, int]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    n_device_events: int
    n_launch_events: int
    reduce_s: float = 0.0


def profiler(device):
    """The card's activities; a CPU rehearsal records host operators
    instead, and finds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == "cuda"
    return profile(activities=[ProfilerActivity.CUDA if cuda
                               else ProfilerActivity.CPU])


def union(intervals: List[Tuple[int, int]]
          ) -> Tuple[int, List[Tuple[int, int]]]:
    """Total length of the union of (start, end) intervals and the merged
    intervals in order."""
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return sum(e - s for s, e in merged), merged


class _Intervals:
    """Sorted, non-overlapping (lo, hi) intervals of one kind of span."""

    def __init__(self, spans: List[Tuple[int, int]]):
        self.spans = sorted(spans)
        self.heads = [lo for lo, _ in self.spans]

    def find(self, x: int):
        i = bisect.bisect_right(self.heads, x) - 1
        if i >= 0 and self.spans[i][1] >= x:
            return self.spans[i]
        return None


def spans_of(marks: List[str], sentinels: List[Tuple[int, int]]):
    """Per span name, its (first, last) correlation ids and (start, end)
    times, from the marks and the sentinel calls in call order; None where
    they do not pair up."""
    if len(marks) != len(sentinels):
        return None
    corr: Dict[str, List[Tuple[int, int]]] = {}
    times: Dict[str, List[Tuple[int, int]]] = {}
    open_: Dict[str, List[Tuple[int, int]]] = {}
    for label, (c, t) in zip(marks, sentinels):
        name = label[1:]
        if label[0] == "+":
            open_.setdefault(name, []).append((c, t))
        else:
            if not open_.get(name):
                return None
            c0, t0 = open_[name].pop()
            corr.setdefault(name, []).append((c0, c))
            times.setdefault(name, []).append((t0, t))
    if any(open_.values()):
        return None
    return corr, times


def reduce(prof, window_s: float, marks: List[str], top: int = 10) -> Trace:
    """``marks``: the spans' sentinel labels in call order
    (``Probes.marks``)."""
    from torch.autograd import DeviceType
    t0 = time.perf_counter()
    device, launches, sentinels = [], {}, []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            device.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                           name, ev.correlation_id()))
        elif name.startswith("cu") and ev.correlation_id():
            # a runtime or driver call (cudaLaunchKernel, cuLaunchKernel,
            # cudaMemcpyAsync, ...): its correlation id is its activity's
            launches[ev.correlation_id()] = ev.start_ns()
            if name == SENTINEL:
                sentinels.append((ev.correlation_id(), ev.start_ns()))
    sentinels.sort()
    paired = spans_of(marks, sentinels)
    kinds, clock = {}, {}
    if paired is not None:
        kinds = {k: _Intervals(v) for k, v in paired[0].items()}
        clock = {k: _Intervals(v) for k, v in paired[1].items()}
    busy_ns, merged = union([(s, e) for s, e, _, _ in device])
    by_range = {k: 0.0 for k in kinds}
    count = {k: 0 for k in kinds}
    by_name: Dict[str, float] = {}
    for s, e, name, corr in device:
        dur = (e - s) / 1e9
        by_name[name] = by_name.get(name, 0.0) + dur
        for k, iv in kinds.items():
            if iv.find(corr) is not None:
                by_range[k] += dur
                count[k] += 1
    gaps = []
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = (e0 + s1) // 2
        host, best = "outside the harness's spans", None
        for k, iv in clock.items():
            hit = iv.find(mid)
            if hit is not None and (best is None or hit[1] - hit[0] < best):
                best, host = hit[1] - hit[0], k
        gaps.append((host, (s1 - e0) / 1e9))
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return Trace(window_s=window_s, busy_s=busy_ns / 1e9,
                 by_range=by_range if paired is not None else None,
                 launches_by_range=count, device_ops=ops,
                 idle_gaps=gaps[:top], n_device_events=len(device),
                 n_launch_events=len(launches),
                 reduce_s=time.perf_counter() - t0)
