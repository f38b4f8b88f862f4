"""SLO-centric serving metrics shared by both backends.

TTFT / TBT / JCT percentiles say how fast the cluster is; operators buy
capacity against **SLO attainment** (what fraction of requests met their
latency targets) and **goodput** (how many SLO-compliant requests per
time unit) — the axes the paper's §5 comparisons are really about.  All
functions operate on the shared request record
(:class:`repro_torch.serving.request.Request` or its simulator adapter), in
whatever time unit the backend's :class:`repro_torch.workloads.Clock` reports.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence


@dataclass(frozen=True)
class SLO:
    """Latency targets, in the backend's clock units; ``inf`` = don't care."""
    ttft: float = float("inf")
    tbt: float = float("inf")
    jct: float = float("inf")

    def met_by(self, req) -> bool:
        """True iff ``req`` finished inside every configured target."""
        if req.finish_time is None or req.first_token_time is None:
            return False
        if req.ttft() > self.ttft or req.jct() > self.jct:
            return False
        tbts = req.tbts()
        return not tbts or max(tbts) <= self.tbt


@dataclass
class SLOSummary:
    n_submitted: int
    n_finished: int
    n_unfinished: int
    #: fraction of *submitted* requests meeting every target (unfinished,
    #: shed and aborted requests all count as misses — an overloaded run
    #: that refuses work at the door must not look healthy because the
    #: refusals never completed: a shed request IS an SLO miss)
    attainment: float
    attainment_ttft: float      # fraction of finished meeting the TTFT target
    attainment_tbt: float       # fraction of finished meeting the TBT target
    goodput: float              # SLO-compliant requests per time unit
    unit: str = "units"
    #: admission control refused these (bounded queue / deadline shed)
    n_shed: int = 0
    #: torn down mid-flight (client cancel or KV-pressure abort)
    n_aborted: int = 0

    def describe(self) -> str:
        extra = ""
        if self.n_shed or self.n_aborted:
            extra = f", {self.n_shed} shed, {self.n_aborted} aborted"
        return (f"SLO attainment={self.attainment:.1%} "
                f"(ttft={self.attainment_ttft:.1%}, "
                f"tbt={self.attainment_tbt:.1%}); "
                f"goodput={self.goodput:.3f} req/{self.unit} "
                f"[{self.n_finished} finished, "
                f"{self.n_unfinished} unfinished{extra}]")


def slo_summary(requests: Iterable, slo: SLO, duration: float,
                unit: str = "units") -> SLOSummary:
    """Score a request set (finished or not) against ``slo`` over the run's
    ``duration`` in backend clock units."""
    from repro_torch.serving.request import Phase
    reqs = list(requests)
    finished = [r for r in reqs if r.finish_time is not None]
    n_shed = sum(1 for r in reqs if r.phase is Phase.SHED)
    n_aborted = sum(1 for r in reqs if r.phase is Phase.ABORTED)
    unfinished = len(reqs) - len(finished) - n_shed - n_aborted
    good = ok_ttft = ok_tbt = 0
    for r in finished:
        ttft, tbts = r.ttft(), r.tbts()
        t_ok = ttft is not None and ttft <= slo.ttft
        b_ok = not tbts or max(tbts) <= slo.tbt
        ok_ttft += t_ok
        ok_tbt += b_ok
        good += t_ok and b_ok and r.jct() <= slo.jct
    n = len(reqs)
    nf = len(finished)
    return SLOSummary(
        n_submitted=n, n_finished=nf, n_unfinished=unfinished,
        attainment=good / n if n else math.nan,
        attainment_ttft=ok_ttft / nf if nf else math.nan,
        attainment_tbt=ok_tbt / nf if nf else math.nan,
        goodput=good / duration if duration > 0 else math.nan,
        unit=unit, n_shed=n_shed, n_aborted=n_aborted,
    )


@dataclass(frozen=True)
class TimelinePoint:
    """One observation of cluster state (sampled per iteration on the live
    executor, per event on the simulator)."""
    t: float
    queue_depth: int        # routed-but-not-yet-prefilled + unrouted
    n_prefill: int          # instances running a prefill (or mixed) batch
    n_decode: int           # instances running a decode step
    n_idle: int


def utilization(timeline: Sequence[TimelinePoint],
                n_instances: int) -> Dict[str, float]:
    """Mean fraction of instances in each phase across the timeline."""
    if not timeline or n_instances <= 0:
        return {"prefill": math.nan, "decode": math.nan, "idle": math.nan}
    n = len(timeline) * n_instances
    return {
        "prefill": sum(p.n_prefill for p in timeline) / n,
        "decode": sum(p.n_decode for p in timeline) / n,
        "idle": sum(p.n_idle for p in timeline) / n,
    }


def queue_depth_stats(timeline: Sequence[TimelinePoint]) -> Dict[str, float]:
    if not timeline:
        return {"mean": math.nan, "peak": math.nan}
    depths: List[int] = [p.queue_depth for p in timeline]
    return {"mean": sum(depths) / len(depths), "peak": float(max(depths))}
