"""Runs one cell of the benchmark as ``perfbench/run.py`` does, with the
program's own tracer (``repro_torch.core.tracing.Tracer``) attached to the
cluster, and prints the same result line with the program's per-layer
metrics (``bench/spans.py``) added and its spans summed up under
``info.program``.

    python3 perfbench/program_trace.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

It takes ``run.py``'s arguments; ``run.py`` on the same seed is the run
without the tracer.  The run itself is ``run.run``, untouched: for its
length this module hands the tracer to ``build_cluster``, marks each span
edge with the harness's sentinel while the trace records, reads the
tracer's counters at the window's edges (where ``Host`` opens and
closes), keeps the GC pauses of the window on the host's clock, and keeps
the profiler's sentinels and busy intervals beside the reduced trace.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import contextlib  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run as R  # noqa: E402


class _GcClock:
    """The window's garbage collections as (start, end) perf_counter_ns;
    the callback reads the clock and nothing else."""

    def __init__(self, out):
        self.out, self._t = out, None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter_ns()
        elif self._t is not None:
            self.out.append((self._t, time.perf_counter_ns()))
            self._t = None


@contextlib.contextmanager
def attached(tracer):
    """``run.run`` with ``tracer`` on its cluster; yields the ``Program``
    record the readers read, and a dict that holds the run's ``Run`` once
    it is built."""
    import torch
    import repro_torch.api as api
    from bench import host, probes, record, trace
    from bench.spans import Device, Program

    prog, got = Program(tracer), {}
    gc_clock = _GcClock(prog.gc)
    plain = {"build": api.build_cluster, "install": probes.Probes.install,
             "open": host.Host.open, "close": host.Host.close,
             "reduce": trace.reduce, "run": record.Run}

    def mark(label):
        # ``Probes._sentinel``, with the host's clock read right before
        # and right after the runtime call: nothing that allocates (and
        # so may collect) lies between the readings and the call
        p = got.get("probes")
        if p is not None and p.recording:
            query = torch.cuda.current_stream().query
            t0 = time.perf_counter_ns()
            query()
            t1 = time.perf_counter_ns()
            p.marks.append(label)
            prog.edges.append((label, t0, t1))

    def build_cluster(spec, cfg=None, params=None):
        return plain["build"](spec, cfg=cfg, params=params, tracer=tracer)

    def install(self, cluster):
        got["probes"] = self
        prog.marks = self.marks
        return plain["install"](self, cluster)

    def open_(self):
        plain["open"](self)
        prog.counters0 = dict(tracer.counters)
        gc.callbacks.append(gc_clock)

    def close(self):
        gc.callbacks.remove(gc_clock)
        prog.counters1 = dict(tracer.counters)
        plain["close"](self)

    def reduce(prof, *a, **kw):
        prog.device = Device.of(prof)
        return plain["reduce"](prof, *a, **kw)

    def make_run(*a, **kw):
        got["run"] = plain["run"](*a, **kw)
        got["run"].program = prog
        return got["run"]

    tracer.mark = mark
    patches = [(record, "Run", make_run),
               (api, "build_cluster", build_cluster),
               (probes.Probes, "install", install),
               (host.Host, "open", open_), (host.Host, "close", close),
               (trace, "reduce", reduce)]
    saved = [(owner, attr, getattr(owner, attr))
             for owner, attr, _ in patches]
    for owner, attr, f in patches:
        setattr(owner, attr, f)
    try:
        yield prog, got
    finally:
        for owner, attr, f in saved:
            setattr(owner, attr, f)
        if gc_clock in gc.callbacks:
            gc.callbacks.remove(gc_clock)


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t0: float) -> dict:
    """``run.run`` of ``cell`` with the program's tracer: the program's
    metrics join a traced run's, and ``info`` gains the spans summed up
    under ``program``."""
    from bench import spans
    from repro_torch.core.tracing import Tracer
    with attached(Tracer()) as (_, got):
        out = R.run(cell, seed, seconds, trace, device, t0)
    rec = got["run"]
    if trace:
        for name, (unit, read) in spans.METRICS.items():
            v = read(rec)
            if v is not None:
                out["metrics"][name] = {"value": v, "unit": unit}
    out["info"]["program"] = spans.summary(rec)
    if "trace" in out["info"]:
        out["info"]["trace"]["idle_by_span"] = spans.idle_by_span(rec)
        out["info"]["trace"]["outside_gaps"] = spans.outside_gaps(rec)
    return out


def main(argv=None) -> int:
    args = R.parse(argv)
    R.setup_paths()
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    from bench import spec
    cell = spec.load(args.workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); the "
              f"benchmark does not run on the CPU", file=sys.stderr)
        return 2
    out = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", _T0)
    if R.forbidden_modules():
        print("the run loaded JAX or the JAX package", file=sys.stderr)
        return 3
    return R.emit(out)


if __name__ == "__main__":
    sys.exit(main())
