"""Dry run: trace every (arch x input shape x production mesh) on the meta
device at full width: its per-chip footprint, and one rank's program with
its FLOPs, its collectives and its peak of live bytes.

The counterpart of the JAX package's ``repro.launch.dryrun``, which lowers
and compiles one SPMD program per combination on forced host devices and
reads its partitioned HLO.  PyTorch has no GSPMD and no HLO, so here:

* **the global step** (``build_meta``): every input at full width on the
  meta device, which allocates nothing: the params, the AdamW state for
  train shapes (bf16 moments above 100e9 parameters), the serving state
  (``long_context`` for ``long_500k``) and the batch of ``input_specs``,
  each leaf beside its partition spec; traced under
  :class:`repro_torch.core.opcount.Counter` (``prefill``, ``decode_step``
  with a (B,) clock, or the train step: forward with remat, backward,
  ``adamw_update``) for ``flops_global``.  The kernel wrappers credit
  their own operation counts on meta and the loops over the sequence
  their trip counts;
* **per-chip memory** comes from the specs: a leaf's per-chip bytes are
  its bytes over the product of the sizes of the mesh axes its spec
  names.  ``argument_size_in_bytes`` counts params, optimizer state,
  inputs and state; ``output_size_in_bytes`` the sampled tokens and the
  state, or the params, optimizer state and metrics; and
  ``alias_size_in_bytes`` what the JAX package donates (the params and
  optimizer state, or the state).  ``fits_h100`` is argument + output -
  alias <= one H100's 80 GB;
* **one rank's program** (:func:`rank_program`): rank 0 of the mesh
  (data 16, or 32 with the pod axis, x model 16) with its params,
  optimizer state, batch and state at per-rank shapes (the rule table's
  TP cut, the "data" cut of ``training.fsdp``, the batch over "data"),
  and its step: ``training.ShardedStep`` on the recording mesh for train
  shapes, ``prefill``/``decode_step`` with the model axis recorded for
  the others.  Its record: ``flops``, the rank's own count, so compute a
  rank repeats (where the heads do not divide 16 every model rank
  computes every head of the attention, while its FFN, experts and vocab
  are cut) counts, and ``flops * chips >= flops_global``;
  ``collective_by_kind``, the wire bytes a chip puts on its links per
  kind (``roofline.analysis._wire_bytes`` of each recorded collective's
  result bytes and group size) and ``collective_calls``;
  ``rank_argument_size_in_bytes``, its arguments' bytes; and
  ``peak_live_bytes_above_arguments``, the peak of the bytes the trace
  allocated and held (``torch.distributed._tools.mem_tracker.MemTracker``
  on meta), the counterpart of XLA's temp bytes.  Remat's recompute is
  counted (``forward_train`` really recomputes); a loop's skipped trips
  are credited their FLOPs and collectives, never their memory.

The trace file ``results/trace_{arch}_{shape}_{mesh}.json`` holds the
global FLOPs by aten op and by credited kernel or loop, and the rank's
with its collectives: the counterpart of the saved HLO.  Nothing here
needs or asks for a card.

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
from torch.distributed._tools.mem_tracker import MemTracker

from repro_torch import sharding
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (input_specs, map_with_path,
                                      param_pspecs, pick_layout,
                                      state_pspecs)
from repro_torch.meshserve.pool import local_state
from repro_torch.meshserve.topology import MeshSlice
from repro_torch.models import decode_step, init_params, init_state, prefill
from repro_torch.core.opcount import Counter
from repro_torch.roofline.analysis import _wire_bytes
from repro_torch.sim.devices import H100
from repro_torch.training import AdamWConfig, fsdp, init_opt_state, train_step
from repro_torch.training.train_step import make_train_step

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


def _local_meta(batch: Dict[str, torch.Tensor]):
    return {k: torch.empty(v.shape, dtype=v.dtype, device=META)
            for k, v in batch.items()}


def rank_program(cfg, batch: Dict[str, torch.Tensor], *, data: int,
                 model: int, kind: str = "train", opt_cfg=None,
                 multi_pod: bool = False, seq_len: int = 0,
                 long_ctx: bool = False) -> Dict[str, Any]:
    """One rank's step of a (``data`` x ``model``) mesh on the meta
    device, traced: rank 0's params, optimizer state (train), batch and
    serving state (prefill, decode) at per-rank shapes, and its step
    (``training.ShardedStep`` on the recording mesh, or ``prefill`` /
    ``decode_step`` with the model axis recorded).  Returns the
    ``Counter``, its collectives, the per-rank argument bytes and the
    peak of the trace's live bytes above its arguments."""
    whole = init_params(cfg, torch.Generator().manual_seed(0), device=META)
    batch = _local_meta(batch)
    if kind == "train":
        mesh = fsdp.recording_mesh(data, model, multi_pod)
        step_fn = make_train_step(cfg, opt_cfg, mesh)
        params = step_fn.shard(whole)
        opt = init_opt_state(opt_cfg, params)
        lr = torch.ones((), dtype=torch.float32, device=META)
        args = [params, opt.m, opt.v, batch]

        def step():
            step_fn(params, opt, batch, lr)
    else:
        serve = fsdp.recording_mesh(1, model)
        params = fsdp.shard(whole, fsdp.plan(cfg, whole, serve), serve)
        batch = fsdp.local_batch(batch, fsdp.recording_mesh(data, model))
        sl = MeshSlice(index=0, ranks=tuple(range(model)), device=META)
        state = local_state(cfg, sl, batch["tokens"].shape[0], seq_len,
                            long_context=long_ctx)
        args = [params, batch, state]

        def step():
            with torch.no_grad(), sharding.record_mesh(
                    model=model, data=data, batch=False):
                if kind == "prefill":
                    prefill(cfg, params, batch, state, long_context=long_ctx)
                else:
                    decode_step(cfg, params, batch["tokens"], state,
                                batch["t"], long_context=long_ctx)
    del whole
    tracker = MemTracker()
    with Counter() as counter, tracker:
        step()
    peak = tracker.get_tracker_snapshot("peak").get(META, {}).get("Total", 0)
    return {"counter": counter, "collectives": dict(counter.collectives),
            "argument_bytes": sum(fsdp.leaf_bytes(a) for a in args),
            "peak_live_bytes": int(peak)}


def collective_by_kind(calls) -> Dict[str, float]:
    """Wire bytes a chip puts on the links per kind
    (``roofline.analysis._wire_bytes``) of a recording's collectives."""
    out: Dict[str, float] = {}
    for (kind, nbytes, n), times in calls.items():
        out[kind] = out.get(kind, 0.0) + times * _wire_bytes(kind, nbytes, n)
    return out


def build_meta(arch: str, shape_name: str, multi_pod: bool) -> Dict[str, Any]:
    """Every input of the global step on the meta device with its specs,
    and the step itself: ``{"mesh", "step": callable, "args": [(tree,
    specs)], "outs": [(tree, specs)], "alias": [(tree, specs)]}``; the
    step fills ``outs`` in.  The per-rank program is
    :func:`rank_program`'s."""
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
    built: Dict[str, Any] = {"mesh": mesh, "batch": batch,
                             "args": [(params, p_specs), (batch, in_specs)],
                             "outs": [], "alias": []}
    if shape.kind == "train":
        opt_cfg = _opt_cfg(cfg)
        built["opt_cfg"] = opt_cfg
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


def _opt_cfg(cfg) -> AdamWConfig:
    # bf16 moments for the huge MoE/hybrid archs, as in the JAX package
    big = cfg.param_count() > 100e9
    return AdamWConfig(state_dtype="bfloat16" if big else "float32")


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
        cfg, shape = get_config(arch), INPUT_SHAPES[shape_name]
        built = build_meta(arch, shape_name, multi_pod)
        mesh = built["mesh"]
        with Counter() as counter:
            built["step"]()
        arg = _sum_bytes(built["args"], mesh)
        out = _sum_bytes(built["outs"], mesh)
        alias = _sum_bytes(built["alias"], mesh)
        flops_global = counter.total()
        sizes = mesh.shape
        data = sizes["data"] * sizes.get("pod", 1)
        if rec["layout"] == "fsdp":
            # pure FSDP: no model axis; every chip is a data rank
            data, model = mesh.size, 1
        else:
            model = sizes["model"]
        rank = rank_program(
            cfg, built["batch"], data=data, model=model, kind=shape.kind,
            opt_cfg=built.get("opt_cfg"), multi_pod=multi_pod,
            seq_len=shape.seq_len, long_ctx=shape_name == "long_500k")
        rc = rank["counter"]
        rec.update(
            ok=True, lower_s=round(time.time() - t0, 1),
            argument_size_in_bytes=arg, output_size_in_bytes=out,
            alias_size_in_bytes=alias,
            rank_argument_size_in_bytes=rank["argument_bytes"],
            peak_live_bytes_above_arguments=rank["peak_live_bytes"],
            flops=rc.total(), flops_global=flops_global,
            collective_by_kind=collective_by_kind(rank["collectives"]),
            collective_calls={k: sum(n for (kk, _, _), n in
                                     rank["collectives"].items() if kk == k)
                              for k in sorted({k[0] for k in
                                               rank["collectives"]})},
            fits_h100=arg + out - alias <= H100.hbm_gb * 1e9)
        if save_trace:
            os.makedirs(RESULTS_DIR, exist_ok=True)
            tag = f"{arch}_{shape_name}_{rec['mesh']}"
            with open(os.path.join(RESULTS_DIR, f"trace_{tag}.json"),
                      "w") as f:
                json.dump({"flops_global": flops_global,
                           "traced_by_op": counter.by_op(),
                           "credited": counter.credited,
                           "rank": {"flops": rc.total(),
                                    "traced_by_op": rc.by_op(),
                                    "credited": rc.credited,
                                    "collectives": [
                                        [k, b, n, c] for (k, b, n), c in
                                        rank["collectives"].items()]}},
                          f, indent=1)
        coll = sum(rec["collective_by_kind"].values())
        print(f"[OK] {arch} {shape_name} {rec['mesh']} "
              f"lower={rec['lower_s']}s flops/chip={rc.total():.3e} "
              f"(global {flops_global:.3e}) collective={coll / 1e9:.2f}"
              f"GB/chip argument={arg / 1e9:.2f}GB/chip "
              f"fits_h100={rec['fits_h100']}", flush=True)
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
