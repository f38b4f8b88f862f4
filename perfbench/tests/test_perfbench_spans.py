"""The program's tracer read beside the harness (``program_trace.py``,
``bench/spans.py``), on the CPU: a tiny traced run with the tracer gives
every program metric that needs no device trace, and its three TTFT parts
add up to the pump's TTFT.  The sentinel pairing, the clock fit, the idle
attribution and the placing of the idle outside every span are checked on
a made-up trace."""
import time
from types import SimpleNamespace

import pytest

import program_trace as PT
from bench import spans as S
from bench.trace import spans_of
from conftest import tiny_cell

OPEN = "starcoder2-3b.code-completion"
SEED = 2**31 + 77
#: the readers that need the device trace (None on the CPU)
DEVICE = {"device_ops_per_decode.latency"}


def _cell():
    """The tiny cell at a rate the CPU serves, so that the window's
    requests get their first tokens inside it."""
    cell = tiny_cell(OPEN)
    cell.traffic = dict(cell.traffic, arrival={"kind": "poisson",
                                               "rate": 2.0},
                        warm_seconds=1.0)
    return cell


@pytest.fixture(scope="module")
def traced():
    return PT.run(_cell(), SEED, 4.0, True, "cpu", time.perf_counter())


def test_a_traced_run_gives_the_program_metrics(traced):
    m = traced["metrics"]
    for name, (unit, _) in S.METRICS.items():
        if name in DEVICE:
            assert name not in m
            continue
        assert m[name]["unit"] == unit and m[name]["value"] >= 0, name
    # the tracer changes no token the reference is held to
    gap = traced["check"]["widest_gap"]
    assert gap["value"] <= gap["limit"]
    prog = traced["info"]["program"]
    assert prog["steps"] > 0 and prog["spans_per_step"] >= 5
    assert prog["counters"]["d2h.decode"] > 0
    assert prog["host_ms_by_span"]["engine.decode"]["n"] \
        == prog["counters"]["d2h.decode"]
    # no device trace on the CPU: nothing on its clock
    assert prog["fit"] is None and traced["info"]["trace"]["idle_by_span"] \
        is None
    # the launch and the sync are parts of a decode plan
    ms = prog["host_ms_by_span"]
    assert ms["engine.decode.launch"]["ms"] + ms["engine.decode.sync"]["ms"] \
        <= ms["engine.decode"]["ms"]


def test_the_ttft_parts_add_up_to_the_pumps(traced):
    prog = traced["info"]["program"]
    parts = prog["ttft_parts_ms"]
    assert len(parts) >= 2
    for rid, wait, prefill, lag, ttft in parts:
        assert wait >= 0 and prefill >= 0 and lag >= 0
        assert abs(wait + prefill + lag - ttft) < 1.0, rid
    assert prog["ttft_parts_checked"] > len(parts)
    assert prog["ttft_parts_worst_gap_ms"] < 1.0


def test_spans_of_pairs_interleaved_harness_and_program_marks():
    marks = ["+bench.step", "+cluster.step", "+bench.decode",
             "+engine.decode", "-engine.decode", "-bench.decode",
             "+kv.mirror", "+bench.mirror", "-bench.mirror", "-kv.mirror",
             "-cluster.step", "-bench.step"]
    sentinels = [(10 + i, 1000 * i) for i in range(len(marks))]
    corr, times = spans_of(marks, sentinels)
    assert corr["cluster.step"] == [(11, 20)]
    assert corr["engine.decode"] == [(13, 14)]
    assert corr["bench.decode"] == [(12, 15)]
    assert corr["kv.mirror"] == [(16, 19)]
    assert times["bench.step"] == [(0, 11000)]
    assert spans_of(marks[:-1], sentinels[:-1]) is None


def _made_up(a=5_000.0, b=1.0 + 2e-6, gc=((26_000, 27_000),)):
    """A window of 0..100 us on the host; the trace's clock is
    ``a + b * host``.  One step holds a decode plan with its launch and
    sync, and a mirror; the device is busy in three stretches."""
    labels = ["+cluster.step", "+engine.decode", "+engine.decode.launch",
              "-engine.decode.launch", "+engine.decode.sync",
              "-engine.decode.sync", "-engine.decode", "+kv.mirror",
              "-kv.mirror", "-cluster.step"]
    host = [10_000, 12_000, 12_500, 20_000, 20_500, 40_000, 41_000,
            50_000, 60_000, 90_000]
    to_trace = [round(a + b * h) for h in host]
    marks = ["+bench.step"] + labels + ["-bench.step"]
    sent = ([(10, round(a + b * 9_000))]
            + [(20 + 10 * i, t) for i, t in enumerate(to_trace)]
            + [(200, round(a + b * 95_000))])
    busy = [(round(a + b * lo), round(a + b * hi)) for lo, hi in
            ((0, 11_000), (21_000, 30_000), (52_000, 58_000))]
    prog = S.Program(tracer=SimpleNamespace(spans=[], stamps={}),
                     edges=[(lab, h, h + 200) for lab, h in zip(labels, host)],
                     marks=marks,
                     gc=list(gc),
                     device=S.Device(sentinels=sent, busy=busy,
                                     blocking=[(65, "cudaStreamSynchronize"),
                                               (300, "cudaMemcpy")]))
    # the pump's steps: one around the marked step, the next after the
    # window; nothing in flight
    pump = SimpleNamespace(starts_wall=[9.5e-6, 104e-6],
                           ends_wall=[90.5e-6],
                           in_flight=lambda times: [0] * len(times))
    return SimpleNamespace(program=prog, pump=pump, start=0.0,
                           end=100e-6), prog


def test_the_clock_fit_and_the_idle_by_span():
    run, prog = _made_up()
    a, b, residuals, outside = S.fit(prog)
    assert a == pytest.approx(5_000.0, abs=1.0)
    assert b == pytest.approx(1.0, abs=1e-4) and residuals[-1] < 1.0
    assert outside[-1] < 1.0
    # a sentinel 500 ns late, its thread held between the readings
    _, late = _made_up()
    c, t = late.device.sentinels[3]
    late.device.sentinels[3] = (c, t + 500)
    assert S.fit(late)[2][-1] > 400 and S.fit(late)[3][-1] > 150
    late.edges[2] = late.edges[2][:2] + (late.edges[2][2] + 600,)
    assert S.fit(late)[3][-1] < 100
    idle = S.idle_by_span(run)
    us = {k: round(v * 1e6, 1) for k, v in idle.items()}
    # idle: 11-21 us, 30-52 us, 58-100 us of the host's window; the GC
    # pause (26-27 us) falls in busy time
    assert us == {S.OUTSIDE: 10.0, "cluster.step": 1.0 + 9.0 + 30.0,
                  "engine.decode.launch": 7.5,
                  "engine.decode.sync": 0.5 + 10.0,
                  "engine.decode": 0.5 + 0.5 + 1.0, "kv.mirror": 2.0 + 2.0,
                  S.GC: 0.0, "in cluster.step": 10.0 + 22.0 + 32.0}
    assert sum(v for k, v in us.items() if k != "in cluster.step") \
        == pytest.approx(10 + 22 + 42)


def test_the_idle_outside_every_span_is_placed_on_the_host_clock():
    run, _ = _made_up()
    (gap,) = S.outside_gaps(run)
    us = {k: None if v is None else round(v * 1e6, 1)
          for k, v in gap.items() if k != "in_flight"}
    # 90-100 us: after the step's last edge, to the window's end
    assert us == {"s": 10.0, "from_window_start_s": 90.0,
                  "since_step_end_s": -0.5, "to_step_start_s": 4.0}
    assert gap["in_flight"] == 0
    run.pump.starts_wall = run.pump.starts_wall[:1]
    assert S.outside_gaps(run)[0]["to_step_start_s"] is None


def test_gc_pauses_take_their_idle():
    run, _ = _made_up(gc=((70_000, 75_000),))
    us = {k: round(v * 1e6, 1) for k, v in S.idle_by_span(run).items()}
    assert us[S.GC] == 5.0 and us["cluster.step"] == 1.0 + 9.0 + 25.0
    assert us["in cluster.step"] == 64.0 - 5.0


def test_blocking_calls_by_innermost_span():
    _, prog = _made_up()
    assert S.blocking_by_span(prog) == {
        "engine.decode.sync": {"cudaStreamSynchronize": 1},
        S.OUTSIDE: {"cudaMemcpy": 1}}


def test_unpaired_marks_read_as_nothing():
    run, prog = _made_up()
    prog.marks = prog.marks[:-1]
    assert S.fit(prog) is None and S.idle_by_span(run) is None
    assert S.outside_gaps(run) is None
    assert S.blocking_by_span(prog) is None
