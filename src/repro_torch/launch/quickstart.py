"""Quickstart: load an architecture, run prefill and a few decode steps,
and show the AcceLLM redundancy primitives on one pair of instances, then
serve a small batch through ``repro_torch.api.serve``: the port's
counterpart of the JAX package's ``examples/quickstart.py``.

Run: PYTHONPATH=src python -m repro_torch.launch.quickstart
     [--arch starcoder2-3b] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.api import ServeSpec, serve
from repro_torch.configs import get_config, list_archs
from repro_torch.core.device import resolve_device
from repro_torch.core.kvbytes import state_bytes_at
from repro_torch.models import init_params
from repro_torch.serving import InstanceEngine, Request
from repro_torch.workloads import Poisson, TableLengths, WorkloadSpec


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b", choices=list_archs())
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg_full = get_config(args.arch)
    cfg = cfg_full.reduced()     # a small variant of the same family
    print(f"arch={cfg_full.name} family={cfg_full.family} "
          f"params={cfg_full.param_count() / 1e9:.1f}B "
          f"(running reduced {cfg.num_layers}L/{cfg.d_model}d on {dev})")
    print(f"serving state at len 1024: "
          f"{state_bytes_at(cfg_full, 1024) / 1e6:.1f} MB/request")

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    a = InstanceEngine(cfg, params, num_slots=4, kv_capacity=128,
                       instance_id=0, device=dev)
    b = InstanceEngine(cfg, params, num_slots=4, kv_capacity=128,
                       instance_id=1, device=dev)

    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 16),
                                               dtype=np.int32)
    req = Request(prompt_len=16, max_new_tokens=8, prompt_tokens=prompt)
    slot = a.prefill_request(req)
    print(f"prefilled rid={req.rid} on instance 0 slot {slot}; "
          f"first token: {req.output_tokens[0]}")

    # AcceLLM §4.1.2: stream state to the partner, keep a redundant copy
    b.import_slot(0, a.export_slot(slot), req)
    a.demote_to_replica(slot, of=(1, 0))
    print("state streamed to instance 1 (primary); instance 0 keeps replica")

    for _ in range(4):
        b.decode()
        a.sync_replica_from(b, 0, slot)   # mirror new KV lines back
    print(f"decoded on instance 1: tokens={req.output_tokens}")

    # zero-cost migration back (role flip): replica promotion
    a.promote_replica(slot, req)
    b.demote_to_replica(0, of=(0, slot))
    for _ in range(req.max_new_tokens - req.generated):
        a.decode()
    print(f"finished on instance 0 after zero-cost migration: "
          f"tokens={req.output_tokens}")
    if len(req.output_tokens) != req.max_new_tokens:
        raise SystemExit(f"{len(req.output_tokens)} tokens, not "
                         f"{req.max_new_tokens}")

    # the same mechanism end to end: one pair under the full AcceLLM
    # policy through the serving facade, fed by the traffic layer
    # (Poisson arrivals on the iteration clock, Table 2 lengths scaled
    # down for small engines)
    traffic = WorkloadSpec(arrival=Poisson(rate=0.5, duration=8.0),
                           lengths=TableLengths("light", scale=0.05),
                           name="quickstart")
    spec = ServeSpec(arch=args.arch, policy="accellm", n_instances=2,
                     num_slots=4, kv_capacity=128, traffic=traffic,
                     max_steps=200, device=str(dev))
    report = serve(spec, cfg=cfg, params=params)
    print(f"facade run (open loop): finished {len(report.finished)}/"
          f"{report.n_submitted}, stats={report.stats}")
    if not report.all_finished:
        raise SystemExit("not every request finished")
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
