"""Seconds of chip_smoke.py's phases from one or more checkouts, on one
card, each phase of each checkout run in a process of its own.

    python3 phase_times.py [--phase NAME ...] DIR [DIR ...]

runs each named phase (default ``serve-xlstm``) of ``DIR/chip_smoke.py``
against ``DIR/src`` for each ``DIR`` in turn, with TF32 off as
chip_smoke.py runs it, and prints the card's name and power limit, then
one JSON line per run: the checkout, the phase, its seconds and the
kernel counts it returned.  The phases:

  serve-xlstm     phase 20 (``phase_xlstm``): no kernel, no build step;
  deepseek        phases 17-18 (``phase_deepseek``: serve-deepseek, then
                  cluster-deepseek and its chunked serve; no kernel);
  cluster-prefix  phase 9 (``phase_cluster_prefix``) on the cluster
                  phase's weights (``build_cluster`` of its spec draws
                  them); builds the checkout's kernels first, untimed;
  train-mesh      phase 33 (``phase_train_mesh``; no kernel);
  cluster-fleet   phase 8 (``phase_cluster_fleet``) after the cluster
                  phase's serve and its rerun of the first 30 steps on
                  the same weights, untimed (what phase 8 is held to);
                  builds the checkout's kernels first, untimed;
  mesh-partial    phase 34 (``phase_mesh_partial``: four processes on
                  the card); builds the checkout's kernels first,
                  untimed;
  mesh-engine     phases 28-29 (``phase_mesh``: mesh-engine with its
                  sequence-parallel serve where the checkout has one,
                  then mesh-cluster) after the serve phase's six requests
                  on one engine (what phase 28 is held to); builds the
                  checkout's kernels first, untimed.

A checkout whose chip_smoke.py lacks a phase prints ``"seconds": null``
for it.  To compare a change with its parent, unpack the parent into a
directory that ``.gitignore`` lists and pass the two in the order parent,
change, change, parent.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

PHASES = ("serve-xlstm", "deepseek", "cluster-prefix", "train-mesh",
          "cluster-fleet", "mesh-partial", "mesh-engine")


def _one(root: Path, phase: str) -> dict:
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"checkout": str(root), "phase": phase, "seconds": None}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    if phase == "serve-xlstm":
        run = lambda: chip_smoke.phase_xlstm(torch, dev, np)
    elif phase == "deepseek":
        run = lambda: chip_smoke.phase_deepseek(torch, dev, np)
    elif phase == "cluster-prefix":
        from repro_torch.api import build_cluster
        from repro_torch.kernels import build
        build.build_all()
        cluster = build_cluster(chip_smoke._cluster_spec(
            traffic=chip_smoke._light(120.0)))
        params = cluster.engines[0].params
        del cluster
        run = lambda: chip_smoke.phase_cluster_prefix(torch, params, {})
    elif phase == "cluster-fleet":
        measured = _cluster_serve(torch, chip_smoke)
        params = measured.pop("params")
        run = lambda: chip_smoke.phase_cluster_fleet(torch, params, measured)
    elif phase == "mesh-partial" and hasattr(chip_smoke,
                                             "phase_mesh_partial"):
        from repro_torch.kernels import build
        build.build_all()
        run = lambda: chip_smoke.phase_mesh_partial(torch, np, card)
    elif phase == "train-mesh" and hasattr(chip_smoke, "phase_train_mesh"):
        run = lambda: chip_smoke.phase_train_mesh(torch, np, card)
    elif phase == "mesh-engine":
        from repro_torch.configs import get_config
        from repro_torch.kernels import build
        from repro_torch.models import init_params
        build.build_all()
        cfg = get_config("starcoder2-3b")
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
        six = []
        _, per_step, _ = chip_smoke._serve_six(torch, np, cfg, params, dev,
                                               "serve", keep=six)
        del params
        chip_smoke._free(torch)
        run = lambda: chip_smoke.phase_mesh(torch, np, six, per_step[8],
                                            card)
    else:
        return out
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["counts"] = run()
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    return out


def _cluster_serve(torch, chip_smoke):
    """What phase 8 of either checkout is held to, untimed: the cluster
    phase's serve of its stream, then its rerun of the first scheduling
    steps on the same weights (``measured["rerun"]``); the weights under
    ``"params"``."""
    from repro_torch.api import build_cluster
    from repro_torch.kernels import build
    build.build_all()
    spec = chip_smoke._cluster_spec(traffic=chip_smoke._light(120.0))
    cluster = build_cluster(spec)
    cluster.run(max_steps=spec.max_steps, source=spec.traffic.source(
        seed=spec.seed, cfg=cluster.cfg))
    params = cluster.engines[0].params
    measured = {"spec": spec, "requests": list(cluster._submitted),
                "iterations": cluster.n_iterations, "params": params}
    again = build_cluster(spec, params=params)
    again.run(max_steps=chip_smoke.CLUSTER_WINDOW[1],
              source=spec.traffic.source(seed=spec.seed, cfg=again.cfg))
    measured["rerun"] = list(again._submitted)
    del cluster, again
    torch.cuda.synchronize()
    return measured


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--one":
        print(json.dumps(_one(Path(argv[1]).resolve(), argv[2])),
              flush=True)
        return 0
    phases = []
    while len(argv) >= 2 and argv[0] == "--phase":
        if argv[1] not in PHASES:
            print(f"phase_times: unknown phase {argv[1]!r}; one of "
                  f"{PHASES}", file=sys.stderr)
            return 2
        phases.append(argv[1])
        argv = argv[2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    print(smi.splitlines()[0].strip(), flush=True)
    for phase in phases or ["serve-xlstm"]:
        for root in argv:
            subprocess.run([sys.executable, __file__, "--one", root, phase],
                           check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
