#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and the CUDA toolkit (``nvcc``), builds the
port's kernels from ``src/repro_torch/csrc``, and runs five phases, each
of which exits non-zero on failure:

1. build — compile every kernel (one ``nvcc`` per source, in parallel);
2. kernels — each CUDA kernel against its plain PyTorch version at the
   main path's shapes plus a ragged shape, in bf16 (tolerance 2e-2 max
   abs) and f32 (1e-4), and timed beside its plain version, its roofline
   bound and, where one PyTorch call computes the same function, that
   call;
3. serve — full-width starcoder2-3b in bf16 (random weights from a seed)
   behind one ``InstanceEngine``: six greedy requests admitted by
   ``prefill_batch`` and decoded by ``decode_multi(steps=8)``; every
   request must finish, every logit be finite, both kernels must have
   launched and neither plain version run;
4. consistency — in f32 at full width, decode logits through the paged
   kernel against a fresh prefill (through the prefill kernel) over the
   prompt plus the generated tokens, within 1e-3 * max|logit|;
5. redundancy — a replica on a second engine follows a request by mirror
   syncs, then takes over by promotion; its tokens must equal a run with
   no handoff.

TF32 is off for matmuls and cuDNN.  The last two lines of standard output
are the kernel summary and the device line, each one JSON object.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters, flush=None):
    """Mean device ms of ``fn`` over ``iters`` launches, each timed with
    CUDA events after an optional L2 flush (the flush is not timed)."""
    import torch
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def phase_kernels(torch, flash_mod, paged_mod, flush):
    """Kernel vs plain on the card; returns the per-kernel records."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1)
    tol = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # -- prefill attention ---------------------------------------------------
    flash_cases = [  # (B, S, H, KVH, hd, window, what)
        (8, 512, 24, 2, 128, 4096, "main path: bucket 512, batch 8"),
        (2, 200, 24, 2, 128, None, "ragged Sq = Skv = 200"),
        (2, 256, 4, 1, 64, 64, "hd 64 (reduced config), window 64"),
    ]
    flash_err = 0.0
    for B, S, H, KVH, hd, window, what in flash_cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (randn((B, S, H, hd), dtype), randn((B, S, KVH, hd), dtype),
                       randn((B, S, KVH, hd), dtype))
            out = flash_mod.flash_attention_cuda(q, k, v, causal=True,
                                                 window=window)
            exp = flash_mod.flash_attention_torch(q, k, v, causal=True,
                                                  window=window)
            torch.cuda.synchronize()
            err = max_err(out, exp)
            log(f"kernels: flash_attention {what} {str(dtype)[6:]}: "
                f"max_abs_err {err:.3e} (tol {tol[dtype]:.0e})")
            check(err <= tol[dtype], f"flash_attention {what} {dtype}: "
                  f"error {err} above {tol[dtype]}")
            flash_err = max(flash_err, err)
    B, S, H, KVH, hd = 8, 512, 24, 2, 128
    q, k, v = (randn((B, S, H, hd), torch.bfloat16),
               randn((B, S, KVH, hd), torch.bfloat16),
               randn((B, S, KVH, hd), torch.bfloat16))
    f_ms = time_ms(lambda: flash_mod.flash_attention_cuda(
        q, k, v, causal=True, window=4096), 20, flush)
    f_plain = time_ms(lambda: flash_mod.flash_attention_torch(
        q, k, v, causal=True, window=4096), 5, flush)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    f_lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20, flush)
    pairs = S * (S + 1) // 2                     # window 4096 > S hides none
    f_flops = 4 * B * H * hd * pairs
    f_bytes = 2 * (2 * B * S * H * hd + 2 * B * S * KVH * hd)
    f_bound, f_by = _bound(f_bytes, f_flops, "bfloat16")

    # -- paged decode attention ----------------------------------------------
    bl, mb, slots = 16, 32, 8
    paged_cases = [  # (lengths, H, KVH, hd, what)
        ([116, 144, 216, 272, 400, 512], 24, 2, 128,
         "main path: 6 requests mid-decode"),
        ([0, 1, 17, 255, 511, 512], 24, 2, 128, "lengths 0, 1 and ragged"),
        ([0, 1, 17, 255, 511, 600], 24, 2, 128,
         "out-of-pool entries, length past the table"),
        ([3, 40, 129], 4, 1, 64, "hd 64 (reduced config)"),
    ]
    paged_err = 0.0

    def paged_inputs(lengths, H, KVH, hd, dtype):
        nb = slots * mb
        qq = randn((len(lengths), H, hd), dtype)
        kp, vp = randn((nb, bl, KVH, hd), dtype), randn((nb, bl, KVH, hd), dtype)
        perm = torch.randperm(nb, generator=gen, device=dev)[:len(lengths) * mb]
        tables = perm.reshape(len(lengths), mb).to(torch.int32)
        if max(lengths) > mb * bl:  # the shared contract for bad tables
            tables[3, 2], tables[4, 0], tables[5, 31] = -1, nb, nb + 7
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        return qq, kp, vp, tables, lens

    for lengths, H_, KVH_, hd_, what in paged_cases:
        for dtype in (torch.bfloat16, torch.float32):
            args = paged_inputs(lengths, H_, KVH_, hd_, dtype)
            out = paged_mod.paged_decode_attention_cuda(*args)
            exp = paged_mod.paged_decode_attention_torch(*args)
            torch.cuda.synchronize()
            err = max_err(out, exp)
            log(f"kernels: paged_decode_attention {what} {str(dtype)[6:]}: "
                f"max_abs_err {err:.3e} (tol {tol[dtype]:.0e})")
            check(err <= tol[dtype], f"paged_decode_attention {what} "
                  f"{dtype}: error {err} above {tol[dtype]}")
            if lengths[0] == 0:
                check(float(out[0].abs().max()) == 0.0,
                      "paged_decode_attention: a length-0 row must give 0")
            paged_err = max(paged_err, err)
    lengths = paged_cases[0][0]
    args = paged_inputs(lengths, 24, 2, 128, torch.bfloat16)
    p_ms = time_ms(lambda: paged_mod.paged_decode_attention_cuda(*args), 50,
                   flush)
    p_plain = time_ms(lambda: paged_mod.paged_decode_attention_torch(*args),
                      20, flush)
    Bp = len(lengths)
    p_bytes = (2 * (2 * Bp * 24 * 128)              # q in, out
               + 2 * 2 * sum(lengths) * 2 * 128     # live K and V lines
               + 4 * Bp * mb + 4 * Bp)              # tables, lengths
    p_flops = 4 * 24 * 128 * sum(lengths)
    p_bound, p_by = _bound(p_bytes, p_flops, "bfloat16")

    records = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:119",
         "launches": 0, "max_abs_err": flash_err, "ms": f_ms,
         "plain_ms": f_plain, "bound_ms": f_bound, "bound_by": f_by,
         "library_ms": f_lib},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:233",
         "launches": 0, "max_abs_err": paged_err, "ms": p_ms,
         "plain_ms": p_plain, "bound_ms": p_bound, "bound_by": p_by,
         "library_ms": None},
    ]
    for r in records:
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms (scaled_dot_product_attention)")
        log(f"kernels: {r['name']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), library {lib}")
    log("kernels: " + json.dumps([r["name"] for r in records]))
    return records


def _wall_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _device_profile(torch, fn):
    """{kernel name: (device ms, launches)} over one call of ``fn``, from
    torch.profiler's CUPTI trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        out[ev.key] = (us / 1e3, ev.count)
    return out


def _breakdown(wall_ms, kernels, top=6):
    device_ms = sum(ms for ms, _ in kernels.values())
    ranked = sorted(((ms, n, name) for name, (ms, n) in kernels.items()),
                    reverse=True)[:top]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms,
            "top": [(name, ms, n) for ms, n, name in ranked]}


def _bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from "
              f"a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import build, read_counts, reset_counts
    from repro_torch.kernels import decode_attention as paged_mod
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.models import (decode_step_paged, init_params,
                                    init_state, prefill)
    from repro_torch.serving import InstanceEngine, Request
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving import sampling as sampling_mod
    from repro_torch.stepplan import PrefillItem, PrefillPlan, bucket_len

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("chip_smoke: TF32 off (torch.backends.cuda.matmul.allow_tf32 = "
        "False, torch.backends.cudnn.allow_tf32 = False)")
    log(f"chip_smoke: python {sys.version.split()[0]}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0].strip())
    dev = torch.device("cuda")
    # a 64 MiB write between timed launches evicts the 50 MB L2
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    # -- 1. build --------------------------------------------------------------
    t0 = time.perf_counter()
    info = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(info)}")
    for name, i in info.items():
        for line in i["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")

    # -- 2. kernels ------------------------------------------------------------
    kernels = phase_kernels(torch, flash_mod, paged_mod, flush)

    # -- 3. serve ----------------------------------------------------------------
    cfg = get_config("starcoder2-3b")
    log(f"serve: {cfg.name} full width: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}, hd "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    rng = np.random.default_rng(0)

    def request(plen, new):
        return Request(prompt_len=plen, max_new_tokens=new,
                       prompt_tokens=rng.integers(0, cfg.vocab_size,
                                                  (1, plen), dtype=np.int32))

    def engine(**kw):
        kw.setdefault("num_slots", 8)
        kw.setdefault("kv_capacity", 512)
        return InstanceEngine(cfg, params, block_lines=16, device=dev, **kw)

    def admit(eng, reqs):
        items = tuple(PrefillItem(r.rid, r.prompt_len, 0, r.prompt_len, req=r)
                      for r in reqs)
        bucket = bucket_len(max(r.prompt_len for r in reqs),
                            cap=eng.kv_capacity)
        return eng.prefill_batch(PrefillPlan(eng.instance_id, items, bucket))

    # warm-up: cuBLAS handles, allocator pools, kernel libraries
    warm = engine()
    admit(warm, [request(64, 9), request(100, 9)])
    while warm.slot_req:
        warm.decode_multi(steps=8)
    del warm

    finite = []
    plain_sample = sampling_mod.sample_slots

    def watched_sample(logits, *a, **kw):
        finite.append(torch.isfinite(logits).all())
        return plain_sample(logits, *a, **kw)

    sampling_mod.sample_slots = watched_sample
    engine_mod.sample_slots = watched_sample
    prompts = [100, 128, 200, 256, 384, 500]
    reqs = [request(n, 32) for n in prompts]
    eng = engine()
    pending = list(reqs)
    prefill_s = decode_s = 0.0
    decode_steps = 0
    torch.cuda.synchronize()
    reset_counts()
    while pending or eng.slot_req:
        free = eng.free_slots()
        if pending and free:
            batch, pending = pending[:len(free)], pending[len(free):]
            t0 = time.perf_counter()
            admit(eng, batch)
            torch.cuda.synchronize()
            prefill_s += time.perf_counter() - t0
        else:
            t0 = time.perf_counter()
            out = eng.decode_multi(steps=8)
            decode_s += time.perf_counter() - t0
            decode_steps += max(len(t) for t in out.values()) if out else 0
    torch.cuda.synchronize()
    counts = read_counts()
    sampling_mod.sample_slots = plain_sample
    engine_mod.sample_slots = plain_sample
    check(all(len(r.output_tokens) == 32 for r in reqs),
          f"serve: output lengths {[len(r.output_tokens) for r in reqs]}")
    check(bool(torch.stack(finite).all()), "serve: non-finite logits")
    for name, c in counts.items():
        check(c["launches"] > 0, f"serve: {name} kernel never launched")
        check(c["plain_calls"] == 0, f"serve: {name} plain version ran "
              f"{c['plain_calls']} times on the main path")
    for r in kernels:
        r["launches"] = counts[r["name"]]["launches"]
    log(f"serve: 6 requests x 32 tokens done; prefill {sum(prompts)} tokens "
        f"in {prefill_s * 1e3:.1f} ms = "
        f"{sum(prompts) / prefill_s:.0f} tokens/s; {decode_steps} "
        f"decode steps in {decode_s * 1e3:.1f} ms; host_syncs "
        f"{eng.host_syncs}; launches {counts}")

    per_step = {}
    for n in (1, 4, 8):
        e = engine()
        admit(e, [request(256, 33) for _ in range(n)])
        e.decode_multi(steps=8)                     # warm this shape
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.decode_multi(steps=8)
        e.decode_multi(steps=8)
        per_step[n] = (time.perf_counter() - t0) / 16 * 1e3
        check(e.batch_size == n, f"serve: {n}-slot timing lost a request")
        del e
    log("serve: decode ms per step (256-token prompts, steps=8): "
        + ", ".join(f"{n} active {v:.3f}" for n, v in per_step.items()))

    # where the time goes: one 8 x 256 prefill plan, then one fused decode
    # plan (steps=8) over those 8 requests; host wall clock unprofiled,
    # device time per kernel from a second, profiled run
    def fresh_plan():
        e = engine()
        batch = [request(256, 33) for _ in range(8)]
        return e, lambda: admit(e, batch)

    e, run = fresh_plan()
    run()                                                 # warm this shape
    e, run = fresh_plan()
    wall = _wall_ms(torch, run)
    e, run = fresh_plan()
    breakdown = {"prefill 8x256": _breakdown(wall, _device_profile(torch,
                                                                   run))}
    e.decode_multi(steps=8)
    wall = _wall_ms(torch, lambda: e.decode_multi(steps=8))
    breakdown["decode 8 active x 8 steps"] = _breakdown(
        wall, _device_profile(torch, lambda: e.decode_multi(steps=8)))
    del e
    for what, b in breakdown.items():
        if b["device_ms"] == 0:
            log(f"serve: {what}: profiler saw no device time; device busy "
                f"share not measured")
            continue
        log(f"serve: {what}: wall {b['wall_ms']:.3f} ms, device busy "
            f"{b['device_ms']:.3f} ms, idle share {1 - b['busy_share']:.3f}")
        for name, ms, n in b["top"]:
            log(f"serve:   {ms:9.3f} ms {n:6d} x {name[:90]}")

    # -- 4. consistency (f32, full width) ----------------------------------------
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = _tree_map(lambda t: t.float(), params)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 200),
                                          dtype=np.int32), device=dev)
    state = init_state(cfg32, 1, 256, device=dev)
    logits, state = prefill(cfg32, params32, {"tokens": prompt}, state)
    tables = torch.arange(256 // 16, dtype=torch.int32, device=dev)[None]
    slots = torch.zeros((1,), dtype=torch.int32, device=dev)
    gen_toks, dec_logits = [], {}
    for step in range(1, 17):
        tok = logits.argmax(-1).to(torch.int32)
        gen_toks.append(tok)
        t = torch.full((1,), 200 + step - 1, dtype=torch.int32, device=dev)
        logits, state = decode_step_paged(cfg32, params32, tok[:, None], state,
                                          t, slots, tables, 16)
        if step in (1, 8, 16):
            dec_logits[step] = logits
    for step, dl in dec_logits.items():
        toks = torch.cat([prompt, torch.stack(gen_toks[:step], dim=1)], dim=1)
        fresh = init_state(cfg32, 1, 256, device=dev)
        pl, _ = prefill(cfg32, params32, {"tokens": toks}, fresh)
        err = max_err(dl, pl)
        scale = float(pl.abs().max())
        log(f"consistency: step {step}: max |decode - prefill| {err:.3e}, "
            f"max |logit| {scale:.3f}, ratio {err / scale:.3e} (limit 1e-3)")
        check(err <= 1e-3 * scale, f"consistency: step {step} differs by "
              f"{err} against max logit {scale}")
    del params32, state

    # -- 5. redundancy -----------------------------------------------------------
    red_prompt = rng.integers(0, cfg.vocab_size, (1, 300), dtype=np.int32)

    def red_request():
        return Request(prompt_len=300, max_new_tokens=24,
                       prompt_tokens=red_prompt.copy())

    control = engine(num_slots=2)
    req_c = red_request()
    control.prefill_request(req_c)
    while control.slot_req:
        control.decode()
    a, b = engine(num_slots=2), engine(num_slots=2, instance_id=1)
    req = red_request()
    sa = a.prefill_request(req)
    sb = 1 - sa
    b.import_slot(sb, a.export_slot(sa), req, as_replica_of=(0, sa))
    line = b.store.costs.mirror_bytes(1)
    moved = []
    for _ in range(8):
        a.decode()
        moved.append(b.sync_replica_from(a, sa, sb))
    check(all(m == line for m in moved),
          f"redundancy: syncs moved {moved}, expected {line} each")
    a.demote_to_replica(sa, (1, sb))
    b.promote_replica(sb, req)
    while b.slot_req:
        b.decode()
    check(req.output_tokens == req_c.output_tokens,
          "redundancy: tokens after promotion differ from the control run")
    log(f"redundancy: 8 mirror syncs of {line:.0f} bytes each, promotion "
        f"on the replica engine; {len(req.output_tokens)} tokens equal the "
        f"control run")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


if __name__ == "__main__":
    sys.exit(main())
