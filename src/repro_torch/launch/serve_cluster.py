"""End to end: one traffic description, two clocks; the port's
counterpart of the JAX package's ``examples/serve_cluster.py``.

A single :class:`repro_torch.workloads.WorkloadSpec` (bursty MMPP
arrivals with uniform lengths) drives both backends with no per-backend
workload code:

* **live**: requests arrive over time on the scheduling-iteration clock
  (open loop) through ``repro_torch.api.serve``: pairs, dynamic roles,
  redundant KV and load balancing on real engines (reduced configs), and
  the report prints SLO attainment and goodput beside TTFT/TBT/JCT;
* **sim**: the identical spec (same seed, same request stream) runs on
  the discrete-event simulator in modeled seconds.

Run: PYTHONPATH=src python -m repro_torch.launch.serve_cluster
        [--arch phi3-medium-14b] [--instances 4] [--policy accellm]
        [--duration 40] [--seed 0] [--prefix-reuse 0.6] [--device cpu]

``--prefix-reuse p`` adds a pool of shared system prompts to the traffic
and turns the prefix cache on in both backends: repeated prompt heads
prefill once and share pool blocks, and the reports show the hits (priced
alike on live engines and the simulator).
"""
from __future__ import annotations

import argparse
from typing import Optional

from repro_torch.api import ServeSpec, serve
from repro_torch.configs import get_config, list_archs
from repro_torch.scheduling.registry import policy_names
from repro_torch.sim import H100, InstanceSpec, PerfModel, Simulator, summarize
from repro_torch.sim.policies import AcceLLMPolicy
from repro_torch.workloads import (SLO, Bursty, PrefixReuse, UniformLengths,
                                   WorkloadSpec)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-medium-14b", choices=list_archs())
    ap.add_argument("--instances", type=int, default=4)
    ap.add_argument("--policy", default="accellm", choices=policy_names())
    ap.add_argument("--duration", type=float, default=40.0,
                    help="arrival window in traffic time units")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-redundancy", action="store_true")
    ap.add_argument("--prefix-reuse", type=float, default=0.0,
                    help="shared-prefix probability; > 0 enables the "
                         "prefix cache on both backends")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # the one workload description both backends consume
    traffic = WorkloadSpec(
        arrival=Bursty(rate_on=0.8, duration=args.duration,
                       mean_on=6.0, mean_off=6.0),
        lengths=UniformLengths(prompt=(8, 48), decode=(4, 16)),
        name="bursty-demo",
        prefix_reuse=(PrefixReuse(pool=3, reuse=args.prefix_reuse,
                                  prefix_len=16)
                      if args.prefix_reuse > 0 else None))
    use_cache = args.prefix_reuse > 0
    slo = SLO(ttft=12.0, tbt=4.0)

    # -- live backend: open loop on the iteration clock ----------------------
    spec = ServeSpec(arch=args.arch, policy=args.policy,
                     n_instances=args.instances, num_slots=8,
                     kv_capacity=256, redundancy=not args.no_redundancy,
                     prefix_cache=use_cache,
                     seed=args.seed, max_steps=800, traffic=traffic, slo=slo,
                     device=args.device)
    print(f"live: {traffic.describe()}")
    report = serve(spec)
    if not report.all_finished:
        raise SystemExit("not all requests completed")
    print(f"finished {len(report.finished)}/{report.n_submitted} requests on "
          f"{args.instances} instances with policy={args.policy}")
    print(report.describe())
    if use_cache:
        print(f"live prefix cache: {report.stats['prefix_hits']} hits, "
              f"{report.stats['prefix_hit_tokens']} prefill tokens saved, "
              f"{report.stats['stream_skipped_lines']} replica lines "
              f"skipped")

    # -- simulator backend: the identical spec, modeled seconds --------------
    sim = Simulator(AcceLLMPolicy(redundancy=not args.no_redundancy),
                    PerfModel(get_config(args.arch), InstanceSpec(H100, 4)),
                    n_instances=args.instances, prefix_cache=use_cache)
    done = sim.run(source=traffic.source(seed=args.seed),
                   horizon=args.duration * 10)
    s = summarize(sim.submitted, args.instances,
                  max(sim.now, args.duration), slo=SLO(ttft=2.0, tbt=0.5))
    print(f"\nsim: same spec, same seed -> {len(done)} finished in modeled "
          f"seconds")
    print(f"sim: ttft_p50={s.ttft_p50:.3f}s tbt_mean={s.tbt_mean * 1e3:.1f}ms"
          f" jct_p50={s.jct_p50:.2f}s slo_attainment={s.slo_attainment:.1%}"
          f" goodput={s.goodput:.2f}req/s")
    if use_cache:
        hits = sum(i.prefix_cache.stats["hits"] for i in sim.instances
                   if i.prefix_cache is not None)
        saved = sum(i.prefix_cache.stats["hit_tokens"]
                    for i in sim.instances if i.prefix_cache is not None)
        print(f"sim prefix cache: {hits} hits, {saved} prefill tokens "
              f"saved (same aligned-hit rule as the live engines)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
