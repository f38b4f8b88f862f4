"""Metric aggregation: TTFT / TBT / JCT / cost-efficiency (paper §3.4),
plus the SLO axes (attainment / goodput) from the shared traffic layer.

A copy of the JAX package's ``repro.sim.metrics``, held against it by
``tests/test_torch_sim.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np

from repro_torch.workloads.metrics import SLO, slo_summary


@dataclass
class Summary:
    n_finished: int
    ttft_p50: float
    ttft_p99: float
    tbt_mean: float
    tbt_p99: float
    tbt_worst: float
    jct_p50: float
    jct_p99: float
    tokens_per_inst_s: float
    duration: float
    n_unfinished: int = 0
    slo_attainment: float = float("nan")
    goodput: float = float("nan")
    #: mean wall-clock scheduler overhead per iteration (µs) — filled
    #: from ``Simulator.sched_us_per_iter`` / the live cluster's
    #: counterpart when the caller passes it; nan when untimed
    sched_us_per_iter: float = float("nan")

    def row(self) -> str:
        return (f"{self.n_finished},{self.ttft_p50:.4f},{self.ttft_p99:.4f},"
                f"{self.tbt_mean:.5f},{self.tbt_p99:.5f},{self.tbt_worst:.5f},"
                f"{self.jct_p50:.3f},{self.jct_p99:.3f},"
                f"{self.tokens_per_inst_s:.2f},{self.n_unfinished},"
                f"{self.slo_attainment:.4f},{self.goodput:.3f}")

    HEADER = ("finished,ttft_p50,ttft_p99,tbt_mean,tbt_p99,tbt_worst,"
              "jct_p50,jct_p99,tok_per_inst_s,unfinished,slo_attainment,"
              "goodput")


def summarize(requests: Iterable, n_instances: int, duration: float,
              slo: Optional[SLO] = None,
              sched_us_per_iter: float = float("nan")) -> Summary:
    """Aggregate latency metrics over a request set.

    Unfinished requests (no ``finish_time``) are counted into
    ``n_unfinished`` and excluded from the percentiles rather than
    crashing the aggregation — an overloaded open-loop run is a result,
    not an error.  With ``slo`` set, ``slo_attainment``/``goodput`` score
    the whole submitted set (unfinished = missed)."""
    reqs = list(requests)
    finished = [r for r in reqs if r.finish_time is not None]
    n_unfinished = len(reqs) - len(finished)
    if slo is not None:
        s = slo_summary(reqs, slo, duration)
        slo_attainment, goodput = s.attainment, s.goodput
    else:
        slo_attainment = goodput = float("nan")
    if not finished:
        return Summary(0, *([float("nan")] * 7), 0.0, duration,
                       n_unfinished=n_unfinished,
                       slo_attainment=slo_attainment, goodput=goodput,
                       sched_us_per_iter=sched_us_per_iter)
    ttfts = np.array([r.ttft() for r in finished])
    jcts = np.array([r.jct() for r in finished])
    all_tbts = [np.asarray(r.tbts()) for r in finished
                if len(r.token_times) > 1]
    # no [0.0] sentinel: a run with no inter-token gaps has no TBT at all
    tbts = np.concatenate(all_tbts) if all_tbts else np.array([float("nan")])
    tokens = sum(r.generated for r in finished)
    return Summary(
        n_finished=len(finished),
        ttft_p50=float(np.percentile(ttfts, 50)),
        ttft_p99=float(np.percentile(ttfts, 99)),
        tbt_mean=float(tbts.mean()),
        tbt_p99=float(np.percentile(tbts, 99)),
        tbt_worst=float(tbts.max()),
        jct_p50=float(np.percentile(jcts, 50)),
        jct_p99=float(np.percentile(jcts, 99)),
        tokens_per_inst_s=tokens / (n_instances * duration),
        duration=duration,
        n_unfinished=n_unfinished,
        slo_attainment=slo_attainment,
        goodput=goodput,
        sched_us_per_iter=sched_us_per_iter,
    )
