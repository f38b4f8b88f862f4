"""The program's own spans, counters and request stamps
(``repro_torch.core.tracing``), read beside the harness's records.

A run with the program's ``Tracer`` attached (``perfbench/program_trace.py``)
marks every edge of a program span with the harness's sentinel
(``Probes._sentinel``: ``cudaStreamQuery`` and a label in
``Probes.marks``), so ``bench.trace.reduce`` pairs program spans exactly
as it pairs ``bench.*`` spans: device time and launches by program span,
and idle gaps named by the innermost one.  Each marked edge also has a
``perf_counter_ns`` reading taken just before its sentinel; the pairs fit
``to_trace_ns``, the linear map from the host's clock to the trace's,
which puts the GC pauses (recorded on the host's clock only) on the
trace.

What the readers below return, each None where its run holds nothing to
read (no tracer, no device trace):

* ``ttft_wait_ms.latency``: median over the window's requests with a
  first token of their ``prefill`` stamp minus the pump's due time;
* ``ttft_prefill_ms.latency``: median of ``first`` minus ``prefill``;
* ``ttft_lag_ms.latency``: median of the end of the ``cluster.step``
  span that holds ``first`` minus ``first``; the three telescope to the
  end of that step minus the due time, which is the pump's TTFT up to
  the few microseconds between the span's end and the pump's clock;
* ``decode_launch_ms.latency``, ``decode_sync_ms.latency``: host ms of
  the window's ``engine.decode.launch`` and ``engine.decode.sync`` spans
  over the window's ``engine.decode`` spans;
* ``device_ops_per_decode.latency``: device activities launched inside
  ``engine.decode`` spans over the spans marked (the traced window);
* ``host_syncs_per_step.latency``: the window's change of the ``d2h.*``
  counters over the window's ``cluster.step`` spans;
* ``step_unspanned_ms.latency``: mean over the window's steps of the
  ``cluster.step`` span's host ms less its direct children's.

The window is the run's ``[start, end)`` on the host clock: a step
belongs to it when it starts in it, and so do the spans it holds.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from bench import stats
from bench.trace import SENTINEL, union

#: the label of time inside no program span
OUTSIDE = "outside the program's spans"
#: the label of time inside an interpreter garbage collection
GC = "gc"
#: runtime calls that block the host until the device has caught up
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize", "cudaMemcpy")


@dataclass
class Device:
    """What the program's readers take from the profiler's events: the
    sentinels (correlation id, start ns) in call order, the merged busy
    intervals (ns) and the blocking runtime calls (correlation id,
    name)."""
    sentinels: List[Tuple[int, int]]
    busy: List[Tuple[int, int]]
    blocking: List[Tuple[int, str]]

    @classmethod
    def of(cls, prof) -> "Device":
        from torch.autograd import DeviceType
        sentinels, device, blocking = [], [], []
        for ev in prof.profiler.kineto_results.events():
            name = ev.name()
            if ev.device_type() == DeviceType.CUDA:
                device.append((ev.start_ns(),
                               ev.start_ns() + ev.duration_ns()))
            elif ev.correlation_id():
                if name == SENTINEL:
                    sentinels.append((ev.correlation_id(), ev.start_ns()))
                elif name in BLOCKING:
                    blocking.append((ev.correlation_id(), name))
        sentinels.sort()
        return cls(sentinels, union(device)[1], sorted(blocking))


@dataclass
class Program:
    """A run's tracer and what the harness saw of it."""
    tracer: object
    #: (label, perf_counter_ns right before its sentinel call, and right
    #: after it) of every marked edge, in call order
    edges: List[Tuple[str, int, int]] = field(default_factory=list)
    #: the tracer's counters when the window opened and when it closed
    counters0: Dict[str, int] = field(default_factory=dict)
    counters1: Dict[str, int] = field(default_factory=dict)
    #: the window's GC pauses, (start, end) perf_counter_ns
    gc: List[Tuple[int, int]] = field(default_factory=list)
    #: the profiler's events, in a traced run on the card
    device: Optional[Device] = None
    #: every label of ``Probes.marks``, the harness's and the program's
    marks: List[str] = field(default_factory=list)


# -- spans on the host clock --------------------------------------------------
def bounds(run) -> Tuple[float, float]:
    """The window in ns: from its start to its end, or to the end of the
    step that straddles its end, so that a step's spans go with it."""
    lo, hi = run.start * 1e9, run.end * 1e9
    last = max((t1 for n, _, t0, t1 in run.program.tracer.spans
                if n == "cluster.step" and lo <= t0 < hi), default=hi)
    return lo, max(hi, last)


def window_spans(run, name: str) -> List[Tuple[str, int, int, int]]:
    lo, hi = bounds(run)
    return [s for s in run.program.tracer.spans
            if s[0] == name and lo <= s[2] < hi]


def _plan_mean_ms(run, part: str) -> Optional[float]:
    if getattr(run, "program", None) is None:
        return None
    plans = window_spans(run, "engine.decode")
    if not plans:
        return None
    return sum(t1 - t0 for _, _, t0, t1 in window_spans(run, part)) \
        / len(plans) / 1e6


def step_children_ns(spans) -> List[Tuple[int, int, int]]:
    """Per ``cluster.step`` span: (start, end, host ns of its direct
    children).  A span follows all it holds in the tracer's list."""
    out, kids = [], {}
    for name, depth, t0, t1 in spans:
        if name == "cluster.step":
            out.append((t0, t1, kids.get(depth + 1, 0)))
        for d in [d for d in kids if d > depth]:
            del kids[d]
        kids[depth] = kids.get(depth, 0) + (t1 - t0)
    return out


def ttft_parts(run, sent=None
               ) -> List[Tuple[int, float, float, float, float]]:
    """(rid, wait, prefill, lag, the pump's TTFT) in seconds for each
    request of ``sent`` (the window's by default) with a first token."""
    tr = run.program.tracer
    ends = sorted((t1, t0) for n, _, t0, t1 in tr.spans
                  if n == "cluster.step")
    heads = [t1 for t1, _ in ends]
    out = []
    for s in (run.window_requests() if sent is None else sent):
        st = tr.stamps.get(s.req.rid, {})
        first_wall = run.pump.first_wall(s)
        if "first" not in st or first_wall is None:
            continue
        i = bisect.bisect_left(heads, st["first"])
        if i == len(ends) or ends[i][1] > st["first"]:
            continue
        wait = st["prefill"] / 1e9 - s.due
        prefill = (st["first"] - st["prefill"]) / 1e9
        lag = (ends[i][0] - st["first"]) / 1e9
        out.append((s.req.rid, wait, prefill, lag, first_wall - s.due))
    return out


def _median_part_ms(run, k: int) -> Optional[float]:
    if getattr(run, "program", None) is None:
        return None
    return stats.percentile([1e3 * p[k] for p in ttft_parts(run)], 50)


# -- the readers --------------------------------------------------------------
def ttft_wait_ms(run) -> Optional[float]:
    return _median_part_ms(run, 1)


def ttft_prefill_ms(run) -> Optional[float]:
    return _median_part_ms(run, 2)


def ttft_lag_ms(run) -> Optional[float]:
    return _median_part_ms(run, 3)


def decode_launch_ms(run) -> Optional[float]:
    return _plan_mean_ms(run, "engine.decode.launch")


def decode_sync_ms(run) -> Optional[float]:
    return _plan_mean_ms(run, "engine.decode.sync")


def device_ops_per_decode(run) -> Optional[float]:
    prog = getattr(run, "program", None)
    if prog is None or run.trace is None or run.trace.by_range is None:
        return None
    plans = prog.marks.count("+engine.decode")
    ops = run.trace.launches_by_range.get("engine.decode", 0)
    return ops / plans if plans and ops else None


def host_syncs_per_step(run) -> Optional[float]:
    prog = getattr(run, "program", None)
    if prog is None:
        return None
    steps = window_spans(run, "cluster.step")
    if not steps:
        return None
    d = sum(v - prog.counters0.get(k, 0) for k, v in prog.counters1.items()
            if k.startswith("d2h."))
    return d / len(steps)


def step_unspanned_ms(run) -> Optional[float]:
    if getattr(run, "program", None) is None:
        return None
    lo, hi = run.start * 1e9, run.end * 1e9
    steps = [(t1 - t0 - kids) for t0, t1, kids
             in step_children_ns(run.program.tracer.spans)
             if lo <= t0 < hi]
    if not steps:
        return None
    return sum(steps) / len(steps) / 1e6


#: name -> (unit, reader) of each per-layer metric the program gives
METRICS = {
    "ttft_wait_ms.latency": ("ms", ttft_wait_ms),
    "ttft_prefill_ms.latency": ("ms", ttft_prefill_ms),
    "ttft_lag_ms.latency": ("ms", ttft_lag_ms),
    "decode_launch_ms.latency": ("ms", decode_launch_ms),
    "decode_sync_ms.latency": ("ms", decode_sync_ms),
    "device_ops_per_decode.latency": ("ops/plan", device_ops_per_decode),
    "host_syncs_per_step.latency": ("syncs/step", host_syncs_per_step),
    "step_unspanned_ms.latency": ("ms", step_unspanned_ms),
}


# -- one clock with the device trace ------------------------------------------
def program_edges(prog: Program) -> List[Tuple[str, int, int, int]]:
    """(label, perf_counter_ns before and after its sentinel call, the
    sentinel's trace ns) of each marked program edge; empty where the
    sentinels do not pair with the marks."""
    dev = prog.device
    if dev is None or len(dev.sentinels) != len(prog.marks):
        return []
    mine = [(lab, t) for lab, (_, t) in zip(prog.marks, dev.sentinels)
            if not lab[1:].startswith("bench.")]
    if [lab for lab, _ in mine] != [lab for lab, *_ in prog.edges]:
        return []
    return [(lab, h0, h1, t) for (lab, t), (_, h0, h1)
            in zip(mine, prog.edges)]


def fit(prog: Program
        ) -> Optional[Tuple[float, float, List[float], List[float]]]:
    """``to_trace_ns(x) = a + b * x`` by least squares over the program's
    edges, each at the host's reading before its sentinel call: (a, b,
    each edge's residual in ns, and how far its sentinel lies outside
    its two readings mapped to the trace, each sorted); None without two
    edges.  A thread preempted between the reading and the call has a
    large residual and readings as far apart."""
    edges = program_edges(prog)
    if len(edges) < 2:
        return None
    n = len(edges)
    mx = sum(h for _, h, _, _ in edges) / n
    my = sum(t for *_, t in edges) / n
    sxx = sum((h - mx) ** 2 for _, h, _, _ in edges)
    b = sum((h - mx) * (t - my) for _, h, _, t in edges) / sxx
    a = my - b * mx
    return (a, b, sorted(abs(t - (a + b * h0)) for _, h0, _, t in edges),
            sorted(max(0.0, a + b * h0 - t, t - (a + b * h1))
                   for _, h0, h1, t in edges))


def _overlaps(pieces, segments):
    """Each (lo, hi, label) where a (lo, hi) piece meets a (lo, hi,
    label) segment; both sorted, neither overlapping itself."""
    j = 0
    for lo, hi in pieces:
        while j < len(segments) and segments[j][1] <= lo:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < hi:
            s0, s1, label = segments[k]
            if min(hi, s1) > max(lo, s0):
                yield max(lo, s0), min(hi, s1), label
            k += 1


def _cut(pieces, holes):
    """``pieces`` less ``holes`` (both sorted (lo, hi) lists, neither
    overlapping itself), and what the holes took."""
    keep, taken, j = [], [], 0
    for lo, hi in pieces:
        while j < len(holes) and holes[j][1] <= lo:
            j += 1
        k = j
        while k < len(holes) and holes[k][0] < hi and lo < hi:
            h0, h1 = holes[k]
            if h0 > lo:
                keep.append((lo, h0))
            taken.append((max(lo, h0), min(hi, h1)))
            lo = max(lo, h1)
            k += 1
        if lo < hi:
            keep.append((lo, hi))
    return keep, taken


def _idle(run):
    """The window's device-idle pieces on the trace's clock, GC pauses
    cut out, beside the innermost program span open on the host at each
    time: (a, b, idle pieces, GC pieces, (lo, hi, label) segments,
    (lo, hi) spans of time inside any ``cluster.step``); None without
    a clock fit."""
    prog = getattr(run, "program", None)
    f = fit(prog) if prog is not None else None
    edges = program_edges(prog) if f is not None else []
    if not edges:
        return None
    a, b = f[:2]
    w0, w1 = a + b * run.start * 1e9, a + b * run.end * 1e9
    idle, t = [], w0
    for lo, hi in prog.device.busy:
        if hi <= t:
            continue
        if lo >= w1:
            break
        if lo > t:
            idle.append((t, lo))
        t = max(t, hi)
    if t < w1:
        idle.append((t, w1))
    gc = [(a + b * g0, a + b * g1) for g0, g1 in prog.gc]
    idle, in_gc = _cut(idle, gc)
    segments, steps, stack, prev = [], [], [], w0
    for label, *_, t in edges:
        if t > prev:
            segments.append((prev, t, stack[-1] if stack else OUTSIDE))
            if "cluster.step" in stack:
                steps.append((prev, t, "in cluster.step"))
        prev = max(prev, t)
        if label[0] == "+":
            stack.append(label[1:])
        else:
            stack.pop()
    segments.append((prev, max(prev, w1), OUTSIDE))
    return a, b, idle, in_gc, segments, steps


def idle_by_span(run) -> Optional[Dict[str, float]]:
    """Device-idle seconds of the window ``[start, end)`` by the
    innermost program span open on the host (on the trace's clock, from
    each edge's own sentinel), GC pauses apart, and the idle seconds
    inside any ``cluster.step`` under ``"in cluster.step"``."""
    got = _idle(run)
    if got is None:
        return None
    _, _, idle, in_gc, segments, steps = got
    out: Dict[str, float] = {GC: float(sum(h - l for l, h in in_gc))}
    for lo, hi, label in [*_overlaps(idle, segments), *_overlaps(idle, steps)]:
        out[label] = out.get(label, 0.0) + hi - lo
    return {k: v / 1e9 for k, v in sorted(out.items(), key=lambda kv: -kv[1])}


def outside_gaps(run, top: int = 3) -> Optional[List[Dict[str, float]]]:
    """The ``top`` longest device-idle pieces of the window with no
    program span open, each placed on the host's clock: its seconds, its
    start from the window's start, the requests in flight at its middle,
    the time from the pump's last step end before its middle to its
    start, and from its end to the pump's next step start after its
    middle (None where there is none)."""
    got = _idle(run)
    if got is None:
        return None
    a, b, idle, _, segments, _ = got
    pieces = sorted(((lo, hi) for lo, hi, label
                     in _overlaps(idle, segments) if label == OUTSIDE),
                    key=lambda p: p[0] - p[1])
    pump, out = run.pump, []
    for lo, hi in pieces[:top]:
        h0, h1 = (lo - a) / b / 1e9, (hi - a) / b / 1e9
        mid = (h0 + h1) / 2
        i = bisect.bisect_right(pump.ends_wall, mid)
        j = bisect.bisect_left(pump.starts_wall, mid)
        out.append({
            "s": (hi - lo) / 1e9, "from_window_start_s": h0 - run.start,
            "in_flight": pump.in_flight([mid])[0],
            "since_step_end_s": h0 - pump.ends_wall[i - 1] if i else None,
            "to_step_start_s": (pump.starts_wall[j] - h1
                                if j < len(pump.starts_wall) else None)})
    return out


def blocking_by_span(prog: Program) -> Optional[Dict[str, Dict[str, int]]]:
    """The blocking runtime calls of the traced window by the innermost
    program span that made them (by correlation id)."""
    dev = prog.device
    if dev is None or len(dev.sentinels) != len(prog.marks):
        return None
    out: Dict[str, Dict[str, int]] = {}
    stack: List[str] = []
    marks = [(c, lab) for lab, (c, _) in zip(prog.marks, dev.sentinels)
             if not lab[1:].startswith("bench.")]
    i = 0
    for corr, name in dev.blocking:
        while i < len(marks) and marks[i][0] < corr:
            lab = marks[i][1]
            if lab[0] == "+":
                stack.append(lab[1:])
            else:
                stack.pop()
            i += 1
        where = out.setdefault(stack[-1] if stack else OUTSIDE, {})
        where[name] = where.get(name, 0) + 1
    return out


def summary(run) -> Dict:
    """The info line's ``program`` entry: the counters' window change,
    spans a step and their host ms by name, the clock fit, blocking
    calls by span, and each window request's TTFT parts."""
    prog = run.program
    lo, hi = bounds(run)
    inside = [s for s in prog.tracer.spans if lo <= s[2] < hi]
    steps = sum(1 for s in inside if s[0] == "cluster.step")
    by_name: Dict[str, List[float]] = {}
    for name, _, t0, t1 in inside:
        v = by_name.setdefault(name, [0, 0.0])
        v[0] += 1
        v[1] += (t1 - t0) / 1e6
    f = fit(prog)
    parts = ttft_parts(run)
    every = ttft_parts(run, list(run.pump.sent.values()))
    return {
        "counters": {k: v - prog.counters0.get(k, 0)
                     for k, v in sorted(prog.counters1.items())},
        "steps": steps,
        "spans_per_step": len(inside) / steps if steps else None,
        "host_ms_by_span": {k: {"n": n, "ms": ms}
                            for k, (n, ms) in sorted(by_name.items())},
        "gc_pauses": len(prog.gc),
        "fit": None if f is None else {
            "offset_ns": f[0], "slope": f[1], "edges": len(f[2]),
            "residual_us": {f"p{q}": stats.percentile(f[2], q) / 1e3
                            for q in (50, 99, 100)},
            "outside_readings_us": {
                f"p{q}": stats.percentile(f[3], q) / 1e3
                for q in (50, 99, 100)}},
        "blocking_by_span": blocking_by_span(prog),
        "ttft_parts_ms": [[rid] + [1e3 * x for x in p]
                          for rid, *p in parts],
        # over every request with a first token, warm-up's too
        "ttft_parts_checked": len(every),
        "ttft_parts_worst_gap_ms": max(
            (1e3 * abs(w + p + g - t) for _, w, p, g, t in every),
            default=None),
    }
