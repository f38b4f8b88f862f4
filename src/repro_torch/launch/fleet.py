"""Fleet orchestration dry-run: render a ``ServeSpec`` (with its fleet
schedule) as the Kubernetes-shaped rollout a real deployment would
execute — one pod per serving instance, readiness gating, and the
fault-injection timeline as pod deletes / creates / cordons.

No cluster is contacted and no k8s client is imported: the output is a
plain JSON plan (manifests + timeline) suitable for inspection, diffing
in CI, or piping into ``kubectl apply -f -`` pod-by-pod on a real fleet.
The timeline is the *same* event stream (``FleetSchedule.stream``) the
live executor and the simulator consume, so what the orchestrator would
do to pods is exactly what the backends inject as
``KillInstance``/``JoinInstance``/``Drain``.

A copy of the JAX package's ``repro.launch.fleet`` on the port.  The
timeline and the pod names, labels and probes are the same; each pod asks
for one H100 (``nvidia.com/gpu``) on a GKE H100 node pool and runs the
port's launcher, where the JAX package's asks for a TPU v5e slice.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.fleet --arch phi3-medium-14b \
      --instances 4 [--fleet-mtbf 200 --duration 600] \
      [--fleet-trace trace.jsonl] [--out plan.json]
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional

from repro_torch.api import ServeSpec
from repro_torch.configs import get_config, list_archs
from repro_torch.fleet import (DegradeInstance, Drain, FleetSchedule,
                               JoinInstance, KillInstance, PoissonFailures,
                               RecoverInstance, load_fleet_trace)
from repro_torch.scheduling.registry import policy_names

#: accelerator asked of the node pool; the dry-run never allocates one
DEFAULT_ACCELERATOR = "nvidia-h100-80gb"


def pod_name(spec: ServeSpec, instance: int) -> str:
    return f"repro-{spec.policy}-{spec.arch}-{instance}".replace("_", "-")


def pod_spec(spec: ServeSpec, instance: int) -> dict:
    """Kubernetes Pod manifest for one serving instance.

    Pairing is surfaced as a label (``repro/pair``) so affinity rules
    can keep AcceLLM pair partners in distinct failure domains — a
    replica on the same rack as its primary defeats the failover story.
    """
    cfg = get_config(spec.arch)
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": pod_name(spec, instance),
            "labels": {
                "app": "repro-serve",
                "repro/policy": spec.policy,
                "repro/arch": spec.arch,
                "repro/instance": str(instance),
                "repro/pair": str(instance // 2),
            },
        },
        "spec": {
            "restartPolicy": "Never",   # the fleet layer owns recovery
            "containers": [{
                "name": "engine",
                "image": "repro-serve:latest",
                "args": ["python", "-m", "repro_torch.launch.serve",
                         "--arch", spec.arch,
                         "--policy", spec.policy,
                         "--instances", str(spec.n_instances),
                         "--slots", str(spec.num_slots),
                         "--kv-capacity", str(spec.kv_capacity)],
                "env": [
                    {"name": "REPRO_INSTANCE_ID", "value": str(instance)},
                    {"name": "REPRO_N_INSTANCES",
                     "value": str(spec.n_instances)},
                ],
                "resources": {"limits": {
                    "nvidia.com/gpu": 1,
                }},
                # an instance is routable only once its engine answers:
                # the warm-up (weights + first compile) stays off the
                # serving path, the same contract as warm_on_join
                "readinessProbe": {
                    "httpGet": {"path": "/healthz", "port": 8000},
                    "initialDelaySeconds": 30,
                    "periodSeconds": 5,
                },
            }],
            "nodeSelector": {
                "cloud.google.com/gke-accelerator": DEFAULT_ACCELERATOR,
            },
        },
        # sizing note for whoever reads the plan; stripped by kubectl
        "x-repro": {"params": int(cfg.param_count())},
    }


def fleet_manifest(spec: ServeSpec) -> List[dict]:
    return [pod_spec(spec, i) for i in range(spec.n_instances)]


def fleet_timeline(spec: ServeSpec, schedule: Optional[FleetSchedule],
                   seed: int = 0) -> List[dict]:
    """The orchestration steps, in order: initial rollout + readiness,
    then each fleet event as the pod operation it corresponds to, then
    teardown.  ``t`` is in the executor's clock units (iterations live,
    modeled seconds in the sim)."""
    steps: List[dict] = [
        {"t": 0.0, "op": "apply", "pods": [pod_name(spec, i)
                                           for i in range(spec.n_instances)]},
        {"t": 0.0, "op": "wait-ready",
         "pods": [pod_name(spec, i) for i in range(spec.n_instances)]},
    ]
    n = spec.n_instances
    for ev in (schedule.stream(seed) if schedule is not None else []):
        if isinstance(ev, KillInstance):
            steps.append({"t": ev.t, "op": "delete",
                          "pod": pod_name(spec, ev.instance),
                          "grace_period": 0})      # abrupt: SIGKILL
        elif isinstance(ev, JoinInstance):
            idx = ev.instance if ev.instance is not None else n
            n = max(n, idx + 1)
            steps.append({"t": ev.t, "op": "apply",
                          "pod": pod_name(spec, idx)})
            steps.append({"t": ev.t, "op": "wait-ready",
                          "pod": pod_name(spec, idx)})
        elif isinstance(ev, Drain):
            steps.append({"t": ev.t, "op": "cordon",
                          "pod": pod_name(spec, ev.instance)})
        elif isinstance(ev, DegradeInstance):
            # partial failure: the pod keeps serving — annotate it so
            # dashboards and affinity rules can see the straggler; the
            # scheduler-level response (hedging) happens in-band
            steps.append({"t": ev.t, "op": "annotate",
                          "pod": pod_name(spec, ev.instance),
                          "annotations": {
                              "repro/degraded": "true",
                              "repro/degrade-factor": str(ev.factor),
                              "repro/link-factor": str(ev.link_factor)}})
        elif isinstance(ev, RecoverInstance):
            steps.append({"t": ev.t, "op": "annotate",
                          "pod": pod_name(spec, ev.instance),
                          "annotations": {"repro/degraded": "false"}})
        else:
            raise ValueError(f"unknown fleet event {ev!r}")
    steps.append({"t": None, "op": "teardown",
                  "selector": "app=repro-serve"})
    return steps


def dry_run(spec: ServeSpec, schedule: Optional[FleetSchedule] = None,
            seed: int = 0) -> dict:
    """The full orchestration plan: manifests + timeline."""
    schedule = schedule if schedule is not None else spec.fleet
    return {
        "arch": spec.arch,
        "policy": spec.policy,
        "n_instances": spec.n_instances,
        "manifests": fleet_manifest(spec),
        "timeline": fleet_timeline(spec, schedule, seed=seed),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-medium-14b", choices=list_archs())
    ap.add_argument("--policy", default="accellm", choices=policy_names())
    ap.add_argument("--instances", type=int, default=4)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--kv-capacity", type=int, default=256)
    ap.add_argument("--fleet-mtbf", type=float, default=None,
                    help="mean time between failures (seeded Poisson)")
    ap.add_argument("--fleet-recovery", type=float, default=None,
                    help="time until a killed instance rejoins")
    ap.add_argument("--duration", type=float, default=600.0,
                    help="fault-injection window for --fleet-mtbf")
    ap.add_argument("--fleet-trace", default=None,
                    help="JSONL fleet trace to replay")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="write the JSON plan here instead of stdout")
    args = ap.parse_args(argv)

    schedule: Optional[FleetSchedule] = None
    if args.fleet_trace:
        schedule = load_fleet_trace(args.fleet_trace)
    elif args.fleet_mtbf:
        schedule = PoissonFailures(mtbf=args.fleet_mtbf,
                                   duration=args.duration,
                                   n_instances=args.instances,
                                   recovery=args.fleet_recovery)
    spec = ServeSpec(arch=args.arch, policy=args.policy,
                     n_instances=args.instances, num_slots=args.slots,
                     kv_capacity=args.kv_capacity, fleet=schedule)
    plan = dry_run(spec, seed=args.seed)
    text = json.dumps(plan, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"wrote {args.out}: {len(plan['manifests'])} pods, "
              f"{len(plan['timeline'])} timeline steps")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
