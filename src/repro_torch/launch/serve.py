"""Serving launcher: drive a live-engine cluster under any registered
scheduling policy through the ``repro_torch.api.serve`` facade.

A copy of the JAX package's ``repro.launch.serve`` on the port, with the
same flags plus ``--device``: the engines run on the card unless
``--device cpu`` asks for the CPU.  Reduced configs by default;
``--full-config`` serves the published widths.

Traffic comes from the shared workload layer (``repro_torch.workloads``):
the default is the legacy batch-at-t=0 request set, but ``--arrival
poisson`` / ``bursty`` / ``diurnal`` run the cluster open-loop with
requests arriving over time on the iteration clock, and ``--arrival
closed`` keeps ``--concurrency`` requests in flight.
``--slo-ttft/--slo-tbt`` add SLO attainment and goodput to the report;
``--fleet-*`` and ``--degrade-*`` inject kills, rejoins and stragglers.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \
      --instances 2 --requests 6 --device cpu \
      [--policy accellm|vllm|splitwise|sarathi|ulb] \
      [--no-redundancy] [--workload mixed] [--arrival poisson --rate 0.5 \
      --duration 60] [--slo-ttft 20 --slo-tbt 4] [--fleet-mtbf 20] \
      [--prefix-cache --prefix-reuse 0.8]

Every registered policy name is accepted, including the ``-vec``
variants (``accellm-vec`` / ``vllm-vec`` / ``splitwise-vec`` /
``ulb-vec``): on live engines those fall back to the identical scalar
decision path, so they are interchangeable with the originals.
``--mesh-tp N`` serves every instance tensor-parallel on N ranks, still
as one command: it starts ``--instances`` x N processes (one per card on
the GPU, over NCCL; gloo processes with ``--device cpu``), each of which
runs the same cluster (``repro_torch.meshserve.world.spawn``).  Rank 0's
report is printed once every rank's report agrees with it.  A host with
fewer cards than ranks raises ``MeshError``.
"""
from __future__ import annotations

import argparse

from repro_torch.api import ServeSpec, serve
from repro_torch.configs import list_archs
from repro_torch.fleet import (FixedFleet, PoissonDegradations,
                               PoissonFailures, load_fleet_trace)
from repro_torch.scheduling.registry import policy_names
from repro_torch.workloads import (SLO, TABLE2, Batch, Bursty, ClosedLoop,
                                   DiurnalRamp, Poisson, PrefixReuse,
                                   TableLengths, WorkloadSpec)


def build_arrival(args):
    if args.arrival == "batch":
        return Batch(args.requests)
    if args.arrival == "poisson":
        return Poisson(rate=args.rate, duration=args.duration)
    if args.arrival == "bursty":
        return Bursty(rate_on=args.rate, duration=args.duration,
                      mean_on=args.mean_on, mean_off=args.mean_off)
    if args.arrival == "diurnal":
        return DiurnalRamp(low=args.rate / 4.0, peak=args.rate,
                           period=args.duration, duration=args.duration)
    if args.arrival == "closed":
        return ClosedLoop(k=args.concurrency, n_requests=args.requests)
    raise ValueError(args.arrival)


def build_fleet(args):
    """Fleet fault-injection schedule from the CLI flags (repro_torch.fleet):
    a recorded JSONL trace replays exactly; an MTBF draws seeded
    Poisson failures across the serve window, and ``--degrade-mtbf``
    adds seeded partial failures (stragglers).  When both are given the
    two streams are pre-drawn with the run's seed and merged into one
    deterministic schedule."""
    if args.fleet_trace:
        return load_fleet_trace(args.fleet_trace)
    schedules = []
    if args.fleet_mtbf:
        schedules.append(PoissonFailures(mtbf=args.fleet_mtbf,
                                         duration=args.duration,
                                         n_instances=args.instances,
                                         recovery=args.fleet_recovery))
    if args.degrade_mtbf:
        schedules.append(PoissonDegradations(
            mtbf=args.degrade_mtbf, duration=args.duration,
            n_instances=args.instances, recovery=args.degrade_recovery,
            factor=args.degrade_factor))
    if not schedules:
        return None
    if len(schedules) == 1:
        return schedules[0]
    merged = sorted((ev for s in schedules for ev in s.stream(args.seed)),
                    key=lambda e: e.t)
    return FixedFleet(fleet_events=tuple(merged))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-medium-14b", choices=list_archs())
    ap.add_argument("--policy", default="accellm", choices=policy_names(),
                    help="scheduling policy (shared kernel; the same names "
                         "drive the simulator)")
    ap.add_argument("--instances", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--kv-capacity", type=int, default=256)
    ap.add_argument("--block-lines", type=int, default=None,
                    help="KV lines per block in the paged store "
                         "(default: largest divisor of kv-capacity <= 16)")
    ap.add_argument("--fuse-steps", type=int, default=1,
                    help="fused decode ceiling: idle open-loop stretches "
                         "run up to N decode iterations as one dispatch")
    ap.add_argument("--workload", default="mixed", choices=list(TABLE2))
    ap.add_argument("--scale", type=float, default=0.05,
                    help="length scale for CPU-sized engines")
    ap.add_argument("--arrival", default="batch",
                    choices=["batch", "poisson", "bursty", "diurnal",
                             "closed"])
    ap.add_argument("--rate", type=float, default=0.5,
                    help="arrivals per iteration (open-loop modes)")
    ap.add_argument("--duration", type=float, default=60.0,
                    help="arrival window in iterations (open-loop modes)")
    ap.add_argument("--mean-on", type=float, default=8.0)
    ap.add_argument("--mean-off", type=float, default=8.0)
    ap.add_argument("--concurrency", type=int, default=4,
                    help="in-flight requests for --arrival closed")
    ap.add_argument("--slo-ttft", type=float, default=None,
                    help="TTFT target in iterations")
    ap.add_argument("--slo-tbt", type=float, default=None,
                    help="per-token TBT target in iterations")
    ap.add_argument("--fleet-mtbf", type=float, default=None,
                    help="mean iterations between instance failures "
                         "(seeded Poisson fault injection)")
    ap.add_argument("--fleet-recovery", type=float, default=None,
                    help="iterations until a killed instance rejoins "
                         "(default: never)")
    ap.add_argument("--fleet-trace", default=None,
                    help="JSONL fleet trace to replay "
                         "(repro_torch.fleet.save_fleet_trace)")
    ap.add_argument("--degrade-mtbf", type=float, default=None,
                    help="mean iterations between partial failures "
                         "(seeded Poisson straggler injection)")
    ap.add_argument("--degrade-factor", type=float, default=4.0,
                    help="slowdown factor of a degraded instance")
    ap.add_argument("--degrade-recovery", type=float, default=None,
                    help="iterations until a degraded instance returns "
                         "to full speed (default: never)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded admission: shed arrivals once the "
                         "backlog holds this many requests")
    ap.add_argument("--shed-deadline", type=float, default=None,
                    help="shed queued requests waiting longer than this "
                         "many iterations (deadline-aware admission)")
    ap.add_argument("--no-hedging", action="store_true",
                    help="disable straggler hedging in hedging-aware "
                         "policies (decode stays on degraded instances)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="refcounted radix prefix cache on every engine: "
                         "shared prompt heads prefill once and dedup in "
                         "the KV pool")
    ap.add_argument("--prefix-cache-blocks", type=int, default=None,
                    help="cache retention cap in pool blocks "
                         "(default: half of each engine's block pool)")
    ap.add_argument("--prefix-reuse", type=float, default=0.0,
                    help="probability a request shares a pooled prompt "
                         "prefix (enables prefix-reuse traffic when > 0)")
    ap.add_argument("--prefix-pool", type=int, default=4,
                    help="number of shared prefix groups (system prompts)")
    ap.add_argument("--prefix-len", type=int, default=64,
                    help="declared shared-prefix length in tokens")
    ap.add_argument("--mesh-tp", type=int, default=None,
                    help="tensor-parallel width per instance: starts "
                         "instances x N processes, one per rank "
                         "(repro_torch.meshserve)")
    ap.add_argument("--device", default="cuda",
                    help="where every engine runs: the card unless "
                         "'cpu' is asked for")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-steps", type=int, default=2000)
    ap.add_argument("--no-redundancy", action="store_true")
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (non-reduced) architecture")
    args = ap.parse_args(argv)

    reuse = (PrefixReuse(pool=args.prefix_pool, reuse=args.prefix_reuse,
                         prefix_len=args.prefix_len)
             if args.prefix_reuse > 0 else None)
    traffic = WorkloadSpec(
        arrival=build_arrival(args),
        lengths=TableLengths(args.workload, scale=args.scale),
        name=args.workload, prefix_reuse=reuse)
    slo = None
    if args.slo_ttft is not None or args.slo_tbt is not None:
        slo = SLO(ttft=args.slo_ttft if args.slo_ttft is not None
                  else float("inf"),
                  tbt=args.slo_tbt if args.slo_tbt is not None
                  else float("inf"))
    spec = ServeSpec(
        arch=args.arch, policy=args.policy, n_instances=args.instances,
        num_slots=args.slots, kv_capacity=args.kv_capacity,
        block_lines=args.block_lines, fuse_decode_steps=args.fuse_steps,
        prefix_cache=args.prefix_cache,
        prefix_cache_blocks=args.prefix_cache_blocks,
        redundancy=not args.no_redundancy, hedging=not args.no_hedging,
        max_queue=args.max_queue, shed_deadline=args.shed_deadline,
        reduced=not args.full_config,
        seed=args.seed, max_steps=args.max_steps, traffic=traffic, slo=slo,
        fleet=build_fleet(args), mesh_tp=args.mesh_tp, device=args.device)
    print(f"serving {args.arch} on {args.instances} instances "
          f"with policy={args.policy}, redundancy={spec.redundancy}, "
          f"device={args.device}"
          + (", prefix_cache=on" if args.prefix_cache else "")
          + (f", mesh_tp={args.mesh_tp}" if args.mesh_tp else ""))
    print(traffic.describe())
    if args.mesh_tp is None:
        report = serve(spec)
        print(report.describe())
        return 0 if report.all_finished else 1
    from repro_torch.meshserve.world import spawn
    world = args.instances * args.mesh_tp
    print(f"mesh slices: {args.instances} x tp {args.mesh_tp} over {world} "
          f"processes")
    reports = spawn("repro_torch.launch.serve:serve_rank", world,
                    device=args.device, args=(spec,))
    text, finished = reports[0]
    for r, (other, _) in enumerate(reports):
        if other != text:
            raise RuntimeError(f"rank {r}'s report differs from rank 0's:"
                               f"\n{other}\n---\n{text}")
    print(text)
    return 0 if finished else 1


def serve_rank(rank: int, world: int, spec: ServeSpec):
    """One rank of a ``--mesh-tp`` serve: its report text and whether
    every request finished."""
    report = serve(spec)
    return report.describe(), report.all_finished


if __name__ == "__main__":
    raise SystemExit(main())
