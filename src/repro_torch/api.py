"""Unified serving entry point: ``repro_torch.api.serve(ServeSpec(...))``.

A copy of the JAX package's ``repro.api`` on the port.  It builds the
model (random weights from ``spec.seed`` on ``spec.device``), resolves
the scheduling policy by name from ``repro_torch.scheduling.registry``
(accellm, or the vllm / splitwise / sarathi / ulb baselines) and drives
a :class:`repro_torch.workloads.WorkloadSpec` traffic stream through
:class:`repro_torch.scheduling.live.LiveCluster`.  The lifecycle is
open-loop: requests arrive over time on the iteration clock (or
closed-loop for ``ClosedLoop`` specs); latency metrics are reported in
scheduling iterations, alongside SLO attainment and goodput when the
spec carries an :class:`repro_torch.workloads.SLO`.

The cluster runs on the card unless the spec asks for another device
(``device="cpu"``).  A fleet schedule (``repro_torch.fleet``) injects
kills, joins, drains and stragglers on the iteration clock.  Mesh
placement and the prefix cache wait for their slices of the port and
raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.fleet import FleetController, FleetSchedule
from repro_torch.models import init_params
from repro_torch.scheduling.live import LiveCluster
from repro_torch.scheduling.registry import get_policy, policy_accepts
from repro_torch.serving.request import Request
from repro_torch.workloads import (SLO, Batch, SLOSummary, TableLengths,
                                   WorkloadSpec, queue_depth_stats,
                                   slo_summary, utilization)


@dataclass
class ServeSpec:
    """Everything needed to stand up a live serving cluster."""
    arch: str = "phi3-medium-14b"
    policy: str = "accellm"
    policy_kwargs: Dict = field(default_factory=dict)
    n_instances: int = 4
    num_slots: int = 8
    kv_capacity: int = 256
    #: KV lines per block in the paged store's ledger (None: largest
    #: divisor of kv_capacity <= 16)
    block_lines: Optional[int] = None
    #: fused decode ceiling: idle open-loop stretches run up to N decode
    #: iterations as one fused dispatch (1 = per-step decode)
    fuse_decode_steps: int = 1
    #: refcounted radix prefix cache on every engine (the JAX package's
    #: repro.prefixcache); waits for the prefix-cache slice of the port
    prefix_cache: bool = False
    #: cache retention cap in pool blocks (None: half of each engine's
    #: block pool)
    prefix_cache_blocks: Optional[int] = None
    redundancy: bool = True            # forwarded to redundancy-aware policies
    #: straggler hedging (forwarded to hedging-aware policies): decode
    #: routes to synced mirrors when an instance's health EWMA crosses
    #: the kernel's threshold
    hedging: bool = True
    #: bounded admission queue: arrivals are shed at the door once the
    #: backlog holds this many requests (None = unbounded)
    max_queue: Optional[int] = None
    #: deadline-aware shedding: queued requests waiting longer than this
    #: many iterations are refused (None = never); pair with ``slo.ttft``
    shed_deadline: Optional[float] = None
    reduced: bool = True               # CPU-sized variant of the architecture
    temperature: float = 0.0
    eos_token: Optional[int] = None
    seed: int = 0
    max_steps: int = 2000
    #: first-class traffic description; when None, a legacy batch-at-t=0
    #: spec is built from (workload, n_requests, request_scale) below
    traffic: Optional[WorkloadSpec] = None
    #: latency targets in iterations; enables attainment/goodput reporting
    slo: Optional[SLO] = None
    #: fleet fault-injection schedule (repro_torch.fleet): kills / joins /
    #: drains applied between scheduler iterations on the iteration
    #: clock; the same schedule drives the simulator in modeled seconds
    fleet: Optional[FleetSchedule] = None
    #: tensor-parallel width per instance (the JAX package's
    #: repro.meshserve); waits for the mesh slice of the port
    mesh_tp: Optional[int] = None
    #: heterogeneous pod: one InstanceSpec per instance; waits for the
    #: mesh slice of the port
    mesh_specs: Optional[Sequence] = None
    #: sample the observability timeline every N scheduling iterations
    #: (1 = every iteration); long replays keep O(n/stride) memory
    timeline_stride: int = 1
    # legacy request sampling (used when `traffic` is not given)
    workload: str = "mixed"
    n_requests: int = 16
    request_scale: float = 0.05
    #: where every engine runs: the card unless the caller asks for the
    #: CPU
    device: str = "cuda"

    def resolve_traffic(self) -> WorkloadSpec:
        if self.traffic is not None:
            return self.traffic
        return WorkloadSpec(arrival=Batch(self.n_requests),
                            lengths=TableLengths(self.workload,
                                                 scale=self.request_scale),
                            name=self.workload)


@dataclass
class ServeReport:
    """Outcome of a serve() run; latencies are in scheduling iterations."""
    spec: ServeSpec
    cluster: LiveCluster
    finished: List[Request]
    n_submitted: int

    @property
    def stats(self) -> Dict[str, int]:
        return self.cluster.stats

    @property
    def fleet_stats(self) -> Optional[Dict[str, int]]:
        """Failover/scale counters from the run's FleetController (None
        when no fleet event fired)."""
        return self.cluster.fleet.stats if self.cluster.fleet else None

    @property
    def all_finished(self) -> bool:
        """Every submitted request reached a terminal state and the
        source was fully delivered.  Shed/aborted requests are terminal
        — a degraded run *completes*; whether it was healthy is the SLO
        summary's question (sheds count as misses there)."""
        return (len(self.finished) + self.n_shed + self.n_aborted
                == self.n_submitted and self.n_undelivered == 0)

    @property
    def n_unfinished(self) -> int:
        return (self.n_submitted - len(self.finished)
                - self.n_shed - self.n_aborted)

    @property
    def n_shed(self) -> int:
        """Requests refused by admission control (queue bound or
        deadline) — deliberate, counted SLO misses."""
        return len(self.cluster.shed)

    @property
    def n_aborted(self) -> int:
        """Requests torn down mid-flight (client aborts + KV-pressure
        aborts)."""
        return len(self.cluster.aborted)

    @property
    def n_undelivered(self) -> int:
        """Source requests never admitted because max_steps elapsed."""
        return self.cluster.undelivered

    @property
    def duration(self) -> float:
        return self.cluster.now

    @property
    def timeline(self):
        return self.cluster.timeline

    @property
    def sched_us_per_iter(self) -> float:
        """Mean wall-clock scheduler overhead per iteration (µs) —
        policy + planner decisions, excluding engine execution."""
        return self.cluster.sched_us_per_iter

    def ttfts(self) -> np.ndarray:
        return np.array([r.ttft() for r in self.finished])

    def jcts(self) -> np.ndarray:
        return np.array([r.jct() for r in self.finished])

    def tbts(self) -> np.ndarray:
        # no sentinel: an empty array must stay empty or it drags down
        # mean/worst TBT for single-token runs
        return np.array([t for r in self.finished for t in r.tbts()])

    def slo(self, slo: Optional[SLO] = None) -> SLOSummary:
        """Score the run against ``slo`` (default: the spec's)."""
        slo = slo or self.spec.slo or SLO()
        return slo_summary(self.cluster._submitted, slo,
                           duration=self.duration,
                           unit=self.cluster.clock.unit)

    def goodput(self, slo: Optional[SLO] = None) -> float:
        return self.slo(slo).goodput

    def utilization(self) -> Dict[str, float]:
        return utilization(self.timeline, len(self.cluster.engines))

    def queue_depth(self) -> Dict[str, float]:
        return queue_depth_stats(self.timeline)

    def describe(self) -> str:
        lines = [f"finished {len(self.finished)}/{self.n_submitted}"
                 + (f" ({self.n_unfinished} unfinished)"
                    if self.n_unfinished else "")
                 + (f" ({self.n_shed} shed)" if self.n_shed else "")
                 + (f" ({self.n_aborted} aborted)"
                    if self.n_aborted else "")
                 + (f" [{self.n_undelivered} never delivered — raise "
                    f"max_steps]" if self.n_undelivered else "")]
        if self.finished:
            ttfts, jcts, tbts = self.ttfts(), self.jcts(), self.tbts()
            lines.append(f"TTFT (iters): p50={np.percentile(ttfts, 50):.1f} "
                         f"p99={np.percentile(ttfts, 99):.1f}")
            if tbts.size:
                lines.append(f"TBT  (iters): mean={tbts.mean():.2f} "
                             f"worst={tbts.max():.1f}")
            lines.append(f"JCT  (iters): p50={np.percentile(jcts, 50):.1f} "
                         f"p99={np.percentile(jcts, 99):.1f}")
        if self.spec.slo is not None:
            lines.append(self.slo().describe())
        util = self.utilization()
        qd = self.queue_depth()
        if self.timeline:
            lines.append(
                f"util: prefill={util['prefill']:.1%} "
                f"decode={util['decode']:.1%} idle={util['idle']:.1%}; "
                f"queue depth mean={qd['mean']:.1f} peak={qd['peak']:.0f}")
        lines.append(f"stats: {self.stats}")
        if self.fleet_stats is not None:
            fs = {k: v for k, v in self.fleet_stats.items() if v}
            lines.append(f"fleet: {fs or 'no events fired'}")
        return "\n".join(lines)


def build_cluster(spec: ServeSpec, cfg=None, params=None) -> LiveCluster:
    """Resolve config, params and policy, and return a ready cluster.
    Without ``params`` the weights are drawn by ``init_params`` from a
    ``torch.Generator`` seeded by ``spec.seed`` on ``spec.device``."""
    if spec.mesh_tp is not None or spec.mesh_specs is not None:
        raise NotImplementedError(
            "mesh placement waits for the mesh slice of the port")
    if spec.prefix_cache:
        raise NotImplementedError(
            "the prefix cache waits for the prefix-cache slice of the port")
    device = resolve_device(spec.device)
    if cfg is None:
        cfg = get_config(spec.arch)
        if spec.reduced:
            cfg = cfg.reduced()
    if params is None:
        params = init_params(
            cfg, torch.Generator(device=device).manual_seed(spec.seed),
            device=device)
    kwargs = dict(spec.policy_kwargs)
    if policy_accepts(spec.policy, "redundancy"):
        kwargs.setdefault("redundancy", spec.redundancy)
    if policy_accepts(spec.policy, "hedging"):
        kwargs.setdefault("hedging", spec.hedging)
    policy = get_policy(spec.policy, **kwargs)
    fleet = (FleetController(spec.fleet, seed=spec.seed)
             if spec.fleet is not None else None)
    return LiveCluster(cfg, params, spec.n_instances, spec.num_slots,
                       spec.kv_capacity, policy,
                       temperature=spec.temperature,
                       eos_token=spec.eos_token,
                       block_lines=spec.block_lines,
                       fuse_decode_steps=spec.fuse_decode_steps,
                       fleet=fleet,
                       timeline_stride=spec.timeline_stride,
                       max_queue=spec.max_queue,
                       shed_deadline=spec.shed_deadline,
                       device=device)


def serve(spec: ServeSpec,
          requests: Optional[Sequence[Union[Request,
                                            Tuple[Request, Optional[dict]]]]]
          = None, cfg=None, params=None) -> ServeReport:
    """Build the cluster, run the traffic to completion, and report.

    With explicit ``requests`` they are submitted up front (closed batch,
    the legacy contract).  Otherwise the spec's
    :class:`~repro_torch.workloads.WorkloadSpec` drives the cluster open-loop:
    the request stream is pulled against the iteration clock as arrivals
    come due."""
    cluster = build_cluster(spec, cfg=cfg, params=params)
    if requests is not None:
        for item in requests:
            req, extra = item if isinstance(item, tuple) else (item, None)
            cluster.submit(req, extra)
        finished = cluster.run(max_steps=spec.max_steps)
    else:
        source = spec.resolve_traffic().source(seed=spec.seed,
                                               cfg=cluster.cfg)
        finished = cluster.run(max_steps=spec.max_steps, source=source)
    return ServeReport(spec=spec, cluster=cluster, finished=finished,
                       n_submitted=len(cluster._submitted))
