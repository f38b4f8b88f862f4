"""Dry run: trace every (arch x input shape x production mesh) on the meta
device at full width, with its per-chip footprint and its FLOPs.

The counterpart of the JAX package's ``repro.launch.dryrun``, which lowers
and compiles one SPMD program per combination on forced host devices.
PyTorch has no GSPMD and no HLO, so here:

* **build** (``build_meta``): every input at full width on the meta
  device, which allocates nothing: the params, the AdamW state for train
  shapes (bf16 moments above 100e9 parameters), the serving state
  (``long_context`` for ``long_500k``) and the batch of ``input_specs``,
  each leaf beside its partition spec;
* **trace**: the step on those tensors under
  :class:`repro_torch.core.opcount.Counter`: ``prefill`` for prefill
  shapes, ``decode_step`` with a (B,) clock for decode shapes, and the
  train step (forward with remat, backward, ``adamw_update``) for train
  shapes.  The kernel wrappers credit their own operation counts on meta
  and the loops over the sequence their trip counts;
* **per-chip memory** comes from the specs: a leaf's per-chip bytes are
  its bytes over the product of the sizes of the mesh axes its spec
  names.  ``argument_size_in_bytes`` counts params, optimizer state,
  inputs and state; ``output_size_in_bytes`` the sampled tokens and the
  state, or the params, optimizer state and metrics; and
  ``alias_size_in_bytes`` what the JAX package donates (the params and
  optimizer state, or the state).  ``fits_h100`` is argument + output -
  alias <= one H100's 80 GB.  There is no counterpart of XLA's temp bytes
  without a per-rank program, so the record has no such key;
* **FLOPs**: ``flops_global`` is the traced step's global count, and
  ``flops`` that figure over the chip count (the even split), which
  ``roofline.analysis.analyze`` multiplies back.  Remat's recompute is
  counted (``forward_train`` really recomputes); compute that GSPMD would
  replicate on every chip is not.

The trace file ``results/trace_{arch}_{shape}_{mesh}.json`` holds the
FLOPs by aten op and by credited kernel or loop: the counterpart of the
saved HLO.  Nothing here needs or asks for a card.

Run: PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
     [--shape S] [--mesh single|multi|both] [--out FILE] [--no-trace]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict

import torch

from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (input_specs, map_with_path,
                                      param_pspecs, pick_layout,
                                      state_pspecs)
from repro_torch.models import decode_step, init_params, init_state, prefill
from repro_torch.core.opcount import Counter
from repro_torch.sim.devices import H100
from repro_torch.training import AdamWConfig, init_opt_state, train_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results")
META = torch.device("meta")


def chip_bytes(tree, specs, mesh) -> int:
    """Per-chip bytes of ``tree`` under ``specs`` (a tree of the same
    structure): each leaf's bytes over the sizes of the axes it names."""
    sizes = mesh.shape
    total = 0

    def add(ps, leaf):
        nonlocal total
        spec = _at_path(specs, ps)
        div = 1
        for ax in spec:
            for name in (ax if isinstance(ax, tuple) else (ax,)):
                if name is not None:
                    div *= sizes[name]
        total += leaf.numel() * leaf.element_size() // div

    map_with_path(add, tree)
    return total


def _at_path(tree, path: str):
    for key in path.split("/") if path else ():
        tree = tree[int(key)] if isinstance(tree, list) else tree[key]
    return tree


def build_meta(arch: str, shape_name: str, multi_pod: bool) -> Dict[str, Any]:
    """Every input of the step on the meta device with its specs, and the
    step itself: ``{"mesh", "step": callable, "args": [(tree, specs)],
    "outs": [(tree, specs)], "alias": [(tree, specs)]}``; the step fills
    ``outs`` in."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    long_ctx = shape_name == "long_500k"
    mesh = make_production_mesh(multi_pod=multi_pod)
    layout = pick_layout(cfg, shape)
    mode = "train" if shape.kind == "train" else "serve"
    params = init_params(cfg, torch.Generator().manual_seed(0), device=META)
    p_specs = param_pspecs(cfg, params, mode=mode, multi_pod=multi_pod,
                           layout=layout)
    batch, in_specs = input_specs(cfg, shape, multi_pod, layout=layout)
    built: Dict[str, Any] = {"mesh": mesh,
                             "args": [(params, p_specs), (batch, in_specs)],
                             "outs": [], "alias": []}
    if shape.kind == "train":
        # bf16 moments for the huge MoE/hybrid archs, as in the JAX package
        big = cfg.param_count() > 100e9
        opt_cfg = AdamWConfig(state_dtype="bfloat16" if big else "float32")
        opt = init_opt_state(opt_cfg, params)
        opt_specs = {"step": (), "m": p_specs, "v": p_specs}
        opt_tree = {"step": opt.step, "m": opt.m, "v": opt.v}
        lr = torch.ones((), dtype=torch.float32, device=META)
        built["args"] += [(opt_tree, opt_specs), ({"lr": lr}, {"lr": ()})]
        built["alias"] += [(params, p_specs), (opt_tree, opt_specs)]

        def step():
            new_p, new_opt, metrics = train_step(cfg, opt_cfg, params, opt,
                                                 batch, lr)
            built["outs"] += [
                (new_p, p_specs),
                ({"step": new_opt.step, "m": new_opt.m, "v": new_opt.v},
                 opt_specs),
                (metrics, {k: () for k in metrics})]
    else:
        state = init_state(cfg, shape.global_batch, shape.seq_len,
                           long_context=long_ctx, device=META)
        s_specs = state_pspecs(cfg, state, shape, long_context=long_ctx,
                               multi_pod=multi_pod)
        built["args"].append((state, s_specs))
        built["alias"].append((state, s_specs))
        tok_spec = (in_specs["tokens"][0],)

        def step():
            with torch.no_grad():
                if shape.kind == "prefill":
                    logits, st = prefill(cfg, params, batch, state,
                                         long_context=long_ctx)
                else:
                    logits, st = decode_step(cfg, params, batch["tokens"],
                                             state, batch["t"],
                                             long_context=long_ctx)
                tokens = torch.argmax(logits, -1).to(torch.int32)
            built["outs"] += [({"tokens": tokens}, {"tokens": tok_spec}),
                              (st, s_specs)]
    built["step"] = step
    return built


def _sum_bytes(pairs, mesh) -> int:
    return sum(chip_bytes(tree, specs, mesh) for tree, specs in pairs)


def run_one(arch: str, shape_name: str, multi_pod: bool,
            save_trace: bool = True) -> dict:
    t0 = time.time()
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": make_production_mesh(multi_pod=multi_pod).tag, "ok": False,
        "layout": pick_layout(get_config(arch), INPUT_SHAPES[shape_name])}
    try:
        built = build_meta(arch, shape_name, multi_pod)
        mesh = built["mesh"]
        with Counter() as counter:
            built["step"]()
        arg = _sum_bytes(built["args"], mesh)
        out = _sum_bytes(built["outs"], mesh)
        alias = _sum_bytes(built["alias"], mesh)
        flops_global = counter.total()
        rec.update(
            ok=True, lower_s=round(time.time() - t0, 1),
            argument_size_in_bytes=arg, output_size_in_bytes=out,
            alias_size_in_bytes=alias,
            flops=flops_global / mesh.size, flops_global=flops_global,
            fits_h100=arg + out - alias <= H100.hbm_gb * 1e9)
        if save_trace:
            os.makedirs(RESULTS_DIR, exist_ok=True)
            tag = f"{arch}_{shape_name}_{rec['mesh']}"
            with open(os.path.join(RESULTS_DIR, f"trace_{tag}.json"),
                      "w") as f:
                json.dump({"flops_global": flops_global,
                           "traced_by_op": counter.by_op(),
                           "credited": counter.credited}, f, indent=1)
        print(f"[OK] {arch} {shape_name} {rec['mesh']} "
              f"lower={rec['lower_s']}s flops={flops_global:.3e} "
              f"argument={arg / 1e9:.2f}GB/chip fits_h100={rec['fits_h100']}",
              flush=True)
    except Exception as e:  # noqa: BLE001 — a failure here is a finding
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[FAIL] {arch} {shape_name} {rec['mesh']}: {rec['error']}",
              flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-trace", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    t0 = time.time()
    records = [run_one(arch, shape, mp, save_trace=not args.no_trace)
               for arch in archs for shape in shapes for mp in meshes]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    n_ok = sum(r["ok"] for r in records)
    print(f"\n{n_ok}/{len(records)} combinations traced in "
          f"{time.time() - t0:.1f} s")
    return 0 if n_ok == len(records) else 1


if __name__ == "__main__":
    raise SystemExit(main())
