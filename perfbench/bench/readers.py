"""Arithmetic the metric readers share; each reader in ``metrics/`` is a
few lines over these.  A reader returns None where its run holds nothing
to read, and the harness then leaves the metric out of the line."""
from __future__ import annotations

from typing import Optional

import flops
from bench import stats
from bench.probes import FLASH, PAGED, PREFILL  # noqa: F401  (readers)


def mean_ms(calls) -> Optional[float]:
    if not calls:
        return None
    return 1e3 * sum(c.end - c.start for c in calls) / len(calls)


def p95(values) -> Optional[float]:
    return stats.percentile(values, 95)


def prefill_flops(run) -> float:
    return sum(flops.prefill_model_flops(run.shape, n, off)
               for c in run.in_window(run.probes.prefills)
               for n, off in c.work)


def decode_flops(run) -> float:
    return sum(flops.decode_model_flops(run.shape, before, steps)
               for c in run.in_window(run.probes.decodes)
               for before, steps in c.work)


def device_s(run, name: str) -> Optional[float]:
    """Device seconds of the kernels launched inside the ``name`` ranges
    of the traced window; None without a trace or without such kernels."""
    if run.trace is None or run.trace.by_range is None:
        return None
    s = run.trace.by_range.get(name, 0.0)
    return s if s > 0 else None


def share(bound_s: float, measured_s: Optional[float]) -> Optional[float]:
    """``bound_s`` over ``measured_s``, in percent."""
    if measured_s is None or bound_s <= 0:
        return None
    return 100.0 * bound_s / measured_s


def flash_bound_s(run) -> float:
    """Per prefill call (one launch a layer over its batch), the bound of
    the attention its items need."""
    total = 0.0
    for c in run.in_window(run.probes.prefills):
        works = [flops.flash_work(run.shape, n, off) for n, off in c.work]
        total += flops.bound_s(sum(w[0] for w in works),
                               sum(w[1] for w in works))
    return total


def paged_bound_s(run) -> float:
    """Per decode step of each decode call (one launch a layer over the
    rows still emitting), the bound of the attention those rows need."""
    total = 0.0
    for c in run.in_window(run.probes.decodes):
        steps = max((s for _, s in c.work), default=0)
        for j in range(steps):
            works = [flops.paged_decode_work(run.shape, before + j + 1)
                     for before, s in c.work if s > j]
            total += flops.bound_s(sum(w[0] for w in works),
                                   sum(w[1] for w in works))
    return total


def prefill_tokens(run) -> int:
    return sum(n for c in run.in_window(run.probes.prefills)
               for n, _ in c.work)



# -- readers that more than one metric file names ---------------------------
def ttft_p50(run) -> Optional[float]:
    return stats.percentile(run.ttfts_ms(), 50)


def ttft_p95(run) -> Optional[float]:
    return p95(run.ttfts_ms())


def tbt_p50(run) -> Optional[float]:
    return stats.percentile(run.tbts_ms(), 50)


def tbt_p90(run) -> Optional[float]:
    return stats.percentile(run.tbts_ms(), 90)


def tbt_p95(run) -> Optional[float]:
    return p95(run.tbts_ms())


def window_mfu(run) -> Optional[float]:
    """Model FLOPs of every plan of the window (prefill and decode) over
    the window's seconds, as a share of the bf16 peak: the whole step's
    share, beside the kernels' rooflines."""
    work = decode_flops(run) + prefill_flops(run)
    if not work:
        return None
    return 100.0 * work / run.seconds / flops.PEAK_BF16_FLOPS


def iter_ms(run) -> Optional[float]:
    """Host time of the window's cluster steps over their count."""
    steps = run.steps()
    if not steps:
        return None
    return 1e3 * sum(e - s for s, e in steps) / len(steps)


def sched_us_per_iter(run) -> Optional[float]:
    """Change of LiveCluster's scheduling time (policy and planner) over
    the window, per scheduling iteration."""
    n = run.sched1[1] - run.sched0[1]
    if n <= 0:
        return None
    return 1e6 * (run.sched1[0] - run.sched0[0]) / n


def decode_step_ms(run) -> Optional[float]:
    """Host time of each decode plan of the window (it ends in the
    engine's own host sync), averaged."""
    return mean_ms(run.in_window(run.probes.decodes))


def idle_share(run) -> Optional[float]:
    """Share of the traced window with nothing running on the device."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
