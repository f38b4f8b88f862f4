#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and the CUDA toolkit (``nvcc``), builds the
port's kernels from ``src/repro_torch/csrc``, and runs eight phases, each
of which exits non-zero on failure:

1. build — compile every kernel (one ``nvcc`` per source, in parallel);
2. kernels — each CUDA kernel against its plain PyTorch version at the
   main paths' shapes plus a ragged shape, and timed beside its plain
   version, its roofline bound and, where one PyTorch call computes the
   same function, that call: prefill attention (tile edges, a chunk
   resume with q_offset) and paged decode attention in bf16 (tolerance
   2e-2 max abs) and f32 (1e-4), the latter at B 1 and larger, G 12, 4,
   1 and 20, 16- and 32-line blocks, lengths 0 and on each side of a
   span edge, and bad tables; dense decode attention at Jamba's heads
   in bf16 and f32 likewise, with lengths on each side of a split
   boundary; the selective scan in f32 (1e-4 relative) at d_in 16384
   for S = 512, a ragged S = 300 and S = 1, at a ragged C with N 8 and
   16 at B 2, and S = 0 (h_final equals h0); its bound counts its
   exponentials at the SFU rate;
3. serve — full-width starcoder2-3b in bf16 (random weights from a seed)
   behind one ``InstanceEngine``: six greedy requests admitted by
   ``prefill_batch`` and decoded by ``decode_multi(steps=8)``; every
   request must finish, every logit be finite, the prefill and paged
   decode kernels must have launched and no plain version run;
4. consistency — in f32 at full width, decode logits through the paged
   kernel against a fresh prefill (through the prefill kernel) over the
   prompt plus the generated tokens, within 1e-3 * max|logit|;
5. redundancy — a replica on a second engine follows a request by mirror
   syncs, then takes over by promotion; its tokens must equal a run with
   no handoff;
6. serve-hybrid — Jamba-1.5-Large at full width, depth cut to its first
   5 layers (4 mamba, MoE on 1 and 3, attention at 4; ~48 GB in bf16):
   six greedy requests (prompts 100 to 1000, 32 tokens each) through
   ``prefill_batch`` (one prompt at a time) and ``decode_multi(steps=8)``
   (dense decode over all 8 slots); every request must finish, every
   logit be finite, the scan, prefill and dense decode kernels must have
   launched and no plain version run; decode ms per step and a profiled
   breakdown;
7. redundancy-hybrid — mirror syncs of one KV line plus the whole
   recurrent state each, then promotion; tokens equal a control run;
8. consistency-hybrid — in f32 on Jamba's first 3 layers (mamba; mamba +
   MoE; mamba) with capacity factor 8: decode logits after 1, 8 and 16
   steps against a fresh prefill within 1e-3 * max|logit|, and each
   mamba layer's ssm state within 1e-4 relative.

The starcoder2 weights are freed before the Jamba phases, and the bf16
Jamba weights before the f32 ones.  TF32 is off for matmuls and cuDNN.
The last two lines of standard output are the kernel summary and the
device line, each one JSON object.
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
SFU_OPS_PER_CLOCK_PER_SM = 16  # exp2 and the like, compute capability 9.0


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters, flush=None, spin=True):
    """Mean device ms of ``fn`` over ``iters`` launches, each timed with
    CUDA events after an optional L2 flush (the flush is not timed).  With
    ``spin``, a 0.2 ms spin on the card after the flush keeps it busy while
    the host enqueues the call, so the events time the device's work and
    not the wrapper's Python."""
    import torch
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        if spin:
            torch.cuda._sleep(400_000)
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
    flash_cases = [  # (B, Sq, Skv, H, KVH, hd, window, q_offset, what)
        (8, 512, 512, 24, 2, 128, 4096, 0, "main path: bucket 512, batch 8"),
        (2, 200, 200, 24, 2, 128, None, 0, "ragged Sq = Skv = 200"),
        (2, 256, 256, 4, 1, 64, 64, 0, "hd 64 (reduced config), window 64"),
        (2, 48, 128, 24, 2, 128, 32, 80,
         "chunk resume: 48 rows at offset 80, 128 keys, window 32"),
        (2, 300, 300, 24, 2, 128, None, 0, "Sq = 300, no multiple of 128"),
    ]
    flash_err = 0.0
    for B, Sq, Skv, H, KVH, hd, window, q_offset, what in flash_cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (randn((B, Sq, H, hd), dtype),
                       randn((B, Skv, KVH, hd), dtype),
                       randn((B, Skv, KVH, hd), dtype))
            out = flash_mod.flash_attention_cuda(q, k, v, causal=True,
                                                 window=window,
                                                 q_offset=q_offset)
            exp = flash_mod.flash_attention_torch(q, k, v, causal=True,
                                                  window=window,
                                                  q_offset=q_offset)
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
    # (lengths as a function of the case's span of lines per split, H, KVH,
    # hd, block_lines, what); W = 512 lines per table, as on the serve path
    W = 512
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    paged_cases = [
        (lambda s: [116, 144, 216, 272, 400, 512], 24, 2, 128, 16,
         "main path: 6 requests mid-decode"),
        (lambda s: [0, 1, 17, 255, 511, 512], 24, 2, 128, 16,
         "lengths 0, 1 and ragged"),
        (lambda s: [0, 1, 17, 255, 511, 600], 24, 2, 128, 16,
         "out-of-pool entries, length past the table"),
        (lambda s: [3, 40, 129], 4, 1, 64, 16, "hd 64 (reduced config)"),
        (lambda s: [s], 24, 2, 128, 16, "B 1, G 12, length on the span edge"),
        (lambda s: [s + 1], 24, 2, 128, 32,
         "B 1, G 12, 32-line blocks, one past the span edge"),
        (lambda s: [0, 1, s, s + 1, 300, W], 8, 2, 128, 32,
         "G 4, 32-line blocks, span edges"),
        (lambda s: [1, s, s + 1, W], 2, 2, 128, 16, "G 1, span edges"),
        (lambda s: [1, s - 1, s + 1, 300, W, 0], 40, 2, 128, 16,
         "G 20 (two head groups), span edges"),
    ]
    paged_err = 0.0

    def paged_inputs(lengths, H, KVH, hd, bl, dtype):
        mb, nb = W // bl, 8 * (W // bl)
        qq = randn((len(lengths), H, hd), dtype)
        kp, vp = randn((nb, bl, KVH, hd), dtype), randn((nb, bl, KVH, hd), dtype)
        perm = torch.randperm(nb, generator=gen, device=dev)[:len(lengths) * mb]
        tables = perm.reshape(len(lengths), mb).to(torch.int32)
        if max(lengths) > W:  # the shared contract for bad tables
            tables[3, 2], tables[4, 0], tables[5, mb - 1] = -1, nb, nb + 7
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        return qq, kp, vp, tables, lens

    for lengths_of, H_, KVH_, hd_, bl_, what in paged_cases:
        splits, span = paged_mod.split_plan(
            len(lengths_of(0)), KVH_, H_ // KVH_, W, sms,
            paged_mod.PAGED_HEADS_PER_BLOCK)
        lengths = lengths_of(span)
        for dtype in (torch.bfloat16, torch.float32):
            args = paged_inputs(lengths, H_, KVH_, hd_, bl_, dtype)
            out = paged_mod.paged_decode_attention_cuda(*args)
            exp = paged_mod.paged_decode_attention_torch(*args)
            torch.cuda.synchronize()
            err = max_err(out, exp)
            log(f"kernels: paged_decode_attention {what} (lengths {lengths}, "
                f"{splits} splits of {span} lines) {str(dtype)[6:]}: "
                f"max_abs_err {err:.3e} (tol {tol[dtype]:.0e})")
            check(err <= tol[dtype], f"paged_decode_attention {what} "
                  f"{dtype}: error {err} above {tol[dtype]}")
            for b, n in enumerate(lengths):
                if n == 0:
                    check(float(out[b].abs().max()) == 0.0,
                          "paged_decode_attention: a length-0 row must give 0")
            paged_err = max(paged_err, err)
    lengths = paged_cases[0][0](0)
    mb = W // 16
    args = paged_inputs(lengths, 24, 2, 128, 16, torch.bfloat16)
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


# the port's own kernel functions, listed in a breakdown even below its top
PORT_KERNEL_FUNCTIONS = ("flash_fwd_kernel", "paged_kernel", "split_kernel",
                         "merge_kernel", "mamba_scan_kernel")


def _breakdown(wall_ms, kernels, top=6):
    """Device time and busy share of a run, its ``top`` kernels by device
    time and, below them, any of the port's own kernels."""
    device_ms = sum(ms for ms, _ in kernels.values())
    ranked = sorted(((ms, n, name) for name, (ms, n) in kernels.items()),
                    reverse=True)
    shown = ranked[:top] + [r for r in ranked[top:]
                            if any(f in r[2] for f in PORT_KERNEL_FUNCTIONS)]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms,
            "top": [(name, ms, n) for ms, n, name in shown]}


def _bound(nbytes, flops, dtype_name, sfu_ms=0.0):
    """(least ms, what bounds it): the bytes at the memory rate against the
    operations, the flops at the peak rate of their type or ``sfu_ms`` for
    the work only the special-function units do, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / PEAK_FLOPS[dtype_name] * 1e3, sfu_ms)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sfu_ms(n, sms):
    """Least ms for ``n`` exponentials on the special-function units: 16
    per clock per SM (CUDA C Programming Guide, arithmetic instruction
    throughput, compute capability 9.0) at the card's max SM clock."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    return n / (SFU_OPS_PER_CLOCK_PER_SM * sms * mhz * 1e6) * 1e3


def phase_hybrid_kernels(torch, dense_mod, scan_mod, flush):
    """The hybrid path's two kernels against their plain versions on the
    card; returns their records."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(2)
    tol = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # -- selective scan (f32): Jamba's d_in 16384, d_state 16 ----------------
    def scan_inputs(B, S, C, N):
        return (randn((B, S, C)),
                torch.nn.functional.softplus(randn((B, S, C)) - 1.0),
                randn((B, S, N)), randn((B, S, N)),
                -torch.exp(randn((C, N)) * 0.5), randn((C,)),
                randn((B, C, N)) * 0.1)

    scan_err = 0.0
    for B, S, C, N, what in (
            (1, 512, 16384, 16, "main path: 512-token prompt"),
            (1, 300, 16384, 16, "ragged S = 300"),
            (2, 1, 16384, 16, "S = 1, B 2"),
            (2, 300, 1000, 16, "ragged C = 1000, B 2"),
            (2, 512, 1003, 8, "N 8, C = 1003 (4-byte copies), B 2")):
        args = scan_inputs(B, S, C, N)
        y, h = scan_mod.mamba_scan_cuda(*args)
        y_p, h_p = scan_mod.mamba_scan_torch(*args)
        torch.cuda.synchronize()
        for name, a, b in (("y", y, y_p), ("h_final", h, h_p)):
            err = max_err(a, b)
            rel = err / float(b.abs().max())
            log(f"kernels: mamba_scan {what} {name}: max_abs_err {err:.3e}, "
                f"relative {rel:.3e} (tol 1e-4 relative)")
            check(rel <= 1e-4, f"mamba_scan {what} {name}: relative error "
                  f"{rel} above 1e-4")
            scan_err = max(scan_err, err)
    args = scan_inputs(2, 0, 1000, 16)
    y, h = scan_mod.mamba_scan_cuda(*args)
    torch.cuda.synchronize()
    check(tuple(y.shape) == (2, 0, 1000) and torch.equal(h, args[-1]),
          "mamba_scan S = 0: y must be empty and h_final equal h0")
    log("kernels: mamba_scan S = 0, C = 1000, B 2: y empty, h_final == h0")
    B, S, C, N = 1, 512, 16384, 16
    args = scan_inputs(B, S, C, N)
    s_ms = time_ms(lambda: scan_mod.mamba_scan_cuda(*args), 50, flush)
    s_plain = time_ms(lambda: scan_mod.mamba_scan_torch(*args), 3, flush)
    s_bytes = 4 * (3 * B * S * C + 2 * B * S * N + C * N + C + 2 * B * C * N)
    s_flops = B * S * C * (6 * N + 3)        # per step: 6 per state + 3
    s_exps = B * S * C * N                   # one exp per state update
    s_bound, s_by = _bound(s_bytes, s_flops, "float32",
                           _sfu_ms(s_exps, sms))

    # -- dense decode attention: Jamba's 64/8 heads, hd 128, 1024 lines ------
    W, H, KVH, hd = 1024, 64, 8, 128
    splits, chunk = dense_mod.split_plan(8, KVH, H // KVH, W, sms)
    dense_cases = [  # (lengths, what)
        ([116, 272, 316, 528, 716, 1016, 1, 1],
         "main path: 6 requests mid-decode, 2 idle slots"),
        ([0, 1, 63, 65, 255, 513, 1000, 1024],
         "ragged lengths, one empty row, one full row"),
        ([0, 1, chunk - 1, chunk, chunk + 1, 2 * chunk + 1, W - 1, W],
         f"one off each side of the {chunk}-line split boundary"),
    ]
    log(f"kernels: decode_attention at 8 rows, {KVH} KV heads, W {W}: "
        f"{splits} splits of {chunk} lines, {8 * KVH * splits} split blocks "
        f"on {sms} SMs")
    check(8 * KVH * splits >= 2 * sms, "decode_attention: fewer than two "
          "split blocks per SM at the timed shape")

    def dense_inputs(lengths, dtype):
        Bd = len(lengths)
        return (randn((Bd, 1, H, hd), dtype), randn((Bd, W, KVH, hd), dtype),
                randn((Bd, W, KVH, hd), dtype),
                torch.tensor(lengths, dtype=torch.int32, device=dev))

    dense_err = 0.0
    for lengths, what in dense_cases:
        for dtype in (torch.bfloat16, torch.float32):
            dargs = dense_inputs(lengths, dtype)
            out = dense_mod.decode_attention_cuda(*dargs)
            exp = dense_mod.decode_attention_torch(*dargs)
            torch.cuda.synchronize()
            err = max_err(out, exp)
            log(f"kernels: decode_attention {what} {str(dtype)[6:]}: "
                f"max_abs_err {err:.3e} (tol {tol[dtype]:.0e})")
            check(err <= tol[dtype], f"decode_attention {what} {dtype}: "
                  f"error {err} above {tol[dtype]}")
            if lengths[0] == 0:
                check(float(out[0].abs().max()) == 0.0,
                      "decode_attention: a length-0 row must give 0")
            dense_err = max(dense_err, err)
    lengths = dense_cases[0][0]
    q, kc, vc, lens = dense_inputs(lengths, torch.bfloat16)
    d_ms = time_ms(lambda: dense_mod.decode_attention_cuda(q, kc, vc, lens),
                   50, flush)
    d_plain = time_ms(lambda: dense_mod.decode_attention_torch(q, kc, vc,
                                                               lens), 20,
                      flush)
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    mask = (torch.arange(W, device=dev)[None] < lens[:, None])[:, None, None]
    d_lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), 50, flush)
    Bd = len(lengths)
    d_bytes = (2 * (2 * Bd * H * hd)               # q in, out
               + 2 * 2 * sum(lengths) * KVH * hd   # live K and V lines
               + 4 * Bd)                           # lengths
    d_flops = 4 * H * hd * sum(lengths)
    d_bound, d_by = _bound(d_bytes, d_flops, "bfloat16")

    records = [
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:120",
         "launches": 0, "max_abs_err": dense_err, "ms": d_ms,
         "plain_ms": d_plain, "bound_ms": d_bound, "bound_by": d_by,
         "library_ms": d_lib},
        {"name": "mamba_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/mamba_scan.cu",
         "replaces": "src/repro/kernels/mamba_scan.py:84",
         "launches": 0, "max_abs_err": scan_err, "ms": s_ms,
         "plain_ms": s_plain, "bound_ms": s_bound, "bound_by": s_by,
         "library_ms": None},
    ]
    log(f"kernels: mamba_scan timed at B 1, S 512, C 16384, N 16: "
        f"{s_bytes / 1e6:.1f} MB ({_bound(s_bytes, 0, 'float32')[0]:.4f} ms), "
        f"{s_flops:.3e} flops ({_bound(0, s_flops, 'float32')[0]:.4f} ms), "
        f"{s_exps:.3e} exps ({_sfu_ms(s_exps, sms):.4f} ms on the SFUs); "
        f"decode_attention at lengths {lengths}, W {W}")
    return records


def _log_records(records, lib_name):
    for r in records:
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms ({lib_name})")
        log(f"kernels: {r['name']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), library {lib}")


def _watch_logits(torch, sampling_mod, engine_mod):
    """Patch the engine's sampler to record whether every logit it sees is
    finite; returns (flags, restore)."""
    finite = []
    plain_sample = sampling_mod.sample_slots

    def watched_sample(logits, *a, **kw):
        finite.append(torch.isfinite(logits).all())
        return plain_sample(logits, *a, **kw)

    def restore():
        sampling_mod.sample_slots = plain_sample
        engine_mod.sample_slots = plain_sample

    sampling_mod.sample_slots = watched_sample
    engine_mod.sample_slots = watched_sample
    return finite, restore


def _print_breakdown(breakdown, phase):
    for what, b in breakdown.items():
        if b["device_ms"] == 0:
            log(f"{phase}: {what}: profiler saw no device time; device busy "
                f"share not measured")
            continue
        log(f"{phase}: {what}: wall {b['wall_ms']:.3f} ms, device busy "
            f"{b['device_ms']:.3f} ms, idle share {1 - b['busy_share']:.3f}")
        for name, ms, n in b["top"]:
            log(f"{phase}:   {ms:9.3f} ms {n:6d} x {name[:90]}")


def _check_path_counts(counts, path_kernels, phase):
    for name, c in counts.items():
        if name in path_kernels:
            check(c["launches"] > 0, f"{phase}: {name} kernel never launched")
        check(c["plain_calls"] == 0, f"{phase}: {name} plain version ran "
              f"{c['plain_calls']} times on the main path")


def phase_dense(torch, dev, np):
    """Phases 3-5 on full-width starcoder2-3b; returns the serve phase's
    kernel counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.models import (decode_step_paged, init_params,
                                    init_state, prefill)
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving import sampling as sampling_mod

    # -- 3. serve ----------------------------------------------------------------
    cfg = get_config("starcoder2-3b")
    log(f"serve: {cfg.name} full width: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}, hd "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    rng, request, engine, admit = _serving(cfg, params, dev, np, 0, 512)

    finite, restore = _watch_logits(torch, sampling_mod, engine_mod)
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
    restore()
    check(all(len(r.output_tokens) == 32 for r in reqs),
          f"serve: output lengths {[len(r.output_tokens) for r in reqs]}")
    check(bool(torch.stack(finite).all()), "serve: non-finite logits")
    _check_path_counts(counts, ("flash_attention", "paged_decode_attention"),
                       "serve")
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
    del e, run
    _print_breakdown(breakdown, "serve")

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
    _redundancy("redundancy", engine, rng.integers(
        0, cfg.vocab_size, (1, 300), dtype=np.int32), same_slot=False)
    return counts


def _serving(cfg, params, dev, np, seed, kv_capacity):
    """(rng, request, engine, admit): the helpers of one model's serve
    phases, after a warm-up (cuBLAS handles, allocator pools, kernel
    libraries)."""
    from repro_torch.serving import InstanceEngine, Request
    from repro_torch.stepplan import PrefillItem, PrefillPlan, bucket_len
    rng = np.random.default_rng(seed)

    def request(plen, new):
        return Request(prompt_len=plen, max_new_tokens=new,
                       prompt_tokens=rng.integers(0, cfg.vocab_size,
                                                  (1, plen), dtype=np.int32))

    def engine(**kw):
        kw.setdefault("num_slots", 8)
        kw.setdefault("kv_capacity", kv_capacity)
        return InstanceEngine(cfg, params, block_lines=16, device=dev, **kw)

    def admit(eng, reqs):
        items = tuple(PrefillItem(r.rid, r.prompt_len, 0, r.prompt_len, req=r)
                      for r in reqs)
        bucket = bucket_len(max(r.prompt_len for r in reqs),
                            cap=eng.kv_capacity)
        return eng.prefill_batch(PrefillPlan(eng.instance_id, items, bucket))

    warm = engine()
    admit(warm, [request(64, 9), request(100, 9)])
    while warm.slot_req:
        warm.decode_multi(steps=8)
    return rng, request, engine, admit


def _redundancy(phase, engine, prompt, same_slot):
    """A replica on a second 2-slot engine follows a request by mirror
    syncs, then takes over by promotion; its tokens must equal a run with
    no handoff.  Each sync must move ``mirror_bytes(1)``: one KV line plus
    the whole recurrent state.  With ``same_slot`` the request sits in
    slot 0 of every engine: dense decode runs every slot's row and MoE
    capacity ranks rows in order, so only the first row never loses its
    capacity to an idle row."""
    from repro_torch.serving import Request

    def red_request():
        return Request(prompt_len=prompt.shape[1], max_new_tokens=24,
                       prompt_tokens=prompt.copy())

    control = engine(num_slots=2)
    req_c = red_request()
    sc = control.prefill_request(req_c)
    while control.slot_req:
        control.decode()
    a, b = engine(num_slots=2), engine(num_slots=2, instance_id=1)
    req = red_request()
    sa = a.prefill_request(req)
    if same_slot:
        check(sa == sc == 0, f"{phase}: the request must sit in slot 0")
    sb = sa if same_slot else 1 - sa
    b.import_slot(sb, a.export_slot(sa), req, as_replica_of=(0, sa))
    costs = b.store.costs
    line = costs.mirror_bytes(1)
    moved = []
    for _ in range(8):
        a.decode()
        moved.append(b.sync_replica_from(a, sa, sb))
    check(all(m == line for m in moved),
          f"{phase}: syncs moved {moved}, expected {line} each")
    a.demote_to_replica(sa, (1, sb))
    b.promote_replica(sb, req)
    while b.slot_req:
        b.decode()
    check(req.output_tokens == req_c.output_tokens,
          f"{phase}: tokens after promotion differ from the control run")
    log(f"{phase}: 8 mirror syncs of {line:.0f} bytes each (one KV line of "
        f"{costs.line_bytes:.0f} bytes plus the whole recurrent state of "
        f"{costs.recurrent_bytes} bytes), promotion on the replica engine; "
        f"{len(req.output_tokens)} tokens equal the control run")


def _depth_cut(cfg, n, **kw):
    return dataclasses.replace(cfg, num_layers=n,
                               block_pattern=cfg.block_pattern[:n], **kw)


def _weight_bytes(params):
    return sum(t.numel() * t.element_size() for t in _leaves(params))


def phase_hybrid(torch, dev, np):
    """Phases 6-7 on Jamba-1.5-Large at full width, depth cut to its first
    5 layers, in bf16; returns the serve phase's kernel counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.models import init_params
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving import sampling as sampling_mod

    # -- 6. serve-hybrid ---------------------------------------------------------
    cfg = _depth_cut(get_config("jamba-1.5-large-398b"), 5)
    mc, moe = cfg.mamba, cfg.moe
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    log(f"serve-hybrid: {cfg.name} full width, depth cut to layers 0-4 "
        f"{cfg.block_pattern} (MoE on {[i for i in range(5) if cfg.layer_is_moe(i)]}): "
        f"d_model {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}, "
        f"hd {cfg.head_dim}, d_ff {cfg.d_ff}, {moe.num_experts} experts "
        f"top-{moe.top_k} d_ff {moe.expert_d_ff}, d_state {mc.d_state}, "
        f"d_conv {mc.d_conv}, expand {mc.expand}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}; param_count {cfg.param_count()}, weights "
        f"{_weight_bytes(params) / 1e9:.3f} GB drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    rng, request, engine, admit = _serving(cfg, params, dev, np, 1, 1024)

    finite, restore = _watch_logits(torch, sampling_mod, engine_mod)
    prompts = [100, 256, 300, 512, 700, 1000]
    reqs = [request(n, 32) for n in prompts]
    eng = engine()
    check(not (eng.supports_paged_decode or eng.supports_chunked_prefill),
          "serve-hybrid: a hybrid engine must not page or chunk")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    admit(eng, reqs)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    decode_steps = 0
    t0 = time.perf_counter()
    while eng.slot_req:
        out = eng.decode_multi(steps=8)
        decode_steps += max(len(t) for t in out.values()) if out else 0
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    counts = read_counts()
    restore()
    check(all(len(r.output_tokens) == 32 for r in reqs),
          f"serve-hybrid: output lengths "
          f"{[len(r.output_tokens) for r in reqs]}")
    check(bool(torch.stack(finite).all()), "serve-hybrid: non-finite logits")
    _check_path_counts(counts, ("mamba_scan", "flash_attention",
                                "decode_attention"), "serve-hybrid")
    log(f"serve-hybrid: 6 requests x 32 tokens done; prefill {sum(prompts)} "
        f"tokens in {prefill_s * 1e3:.1f} ms = "
        f"{sum(prompts) / prefill_s:.0f} tokens/s; {decode_steps} decode "
        f"steps in {decode_s * 1e3:.1f} ms; host_syncs {eng.host_syncs}; "
        f"launches {counts}")
    del eng

    per_step = {}
    for n in (1, 4, 8):
        e = engine()
        admit(e, [request(256, 33) for _ in range(n)])
        e.decode_multi(steps=4)                     # warm this shape
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.decode_multi(steps=8)
        torch.cuda.synchronize()
        per_step[n] = (time.perf_counter() - t0) / 8 * 1e3
        check(e.batch_size == n, f"serve-hybrid: {n}-slot timing lost a "
              f"request")
        del e
    log("serve-hybrid: decode ms per step (256-token prompts, 8 slots "
        "decoded densely): "
        + ", ".join(f"{n} active {v:.3f}" for n, v in per_step.items()))

    # where the time goes: one 512-token prefill, then 8 active x 8 steps
    e = engine()
    admit(e, [request(512, 2)])                      # warm this shape
    e = engine()
    one = [request(512, 40)]
    wall = _wall_ms(torch, lambda: admit(e, one))
    e = engine()
    one = [request(512, 40)]
    breakdown = {"prefill 1x512": _breakdown(
        wall, _device_profile(torch, lambda: admit(e, one)))}
    admit(e, [request(256, 40) for _ in range(7)])
    e.decode_multi(steps=2)
    wall = _wall_ms(torch, lambda: e.decode_multi(steps=8))
    breakdown["decode 8 active x 8 steps"] = _breakdown(
        wall, _device_profile(torch, lambda: e.decode_multi(steps=8)))
    del e
    _print_breakdown(breakdown, "serve-hybrid")

    # -- 7. redundancy-hybrid ----------------------------------------------------
    _redundancy("redundancy-hybrid", engine, rng.integers(
        0, cfg.vocab_size, (1, 300), dtype=np.int32), same_slot=True)
    return counts


def phase_consistency_hybrid(torch, dev, np):
    """Phase 8: f32 decode against a fresh prefill on Jamba's first 3
    layers (mamba; mamba + MoE; mamba) at full width, capacity factor 8
    (= experts / top-k, so no token drops)."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, init_state, prefill
    full = get_config("jamba-1.5-large-398b")
    cfg = _depth_cut(full, 3, dtype="float32", moe=dataclasses.replace(
        full.moe, capacity_factor=8.0))
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(3),
                         device=dev)
    torch.cuda.synchronize()
    log(f"consistency-hybrid: {cfg.block_pattern} in f32, capacity factor "
        f"8.0: weights {_weight_bytes(params) / 1e9:.3f} GB drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(2)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 200),
                                          dtype=np.int32), device=dev)

    def ssm_states(state):
        return [v["ssm"].clone() for seg in state["layers"]
                for v in seg.values()]

    state = init_state(cfg, 1, 256, device=dev)
    logits, state = prefill(cfg, params, {"tokens": prompt}, state)
    gen_toks, dec = [], {}
    for step in range(1, 17):
        tok = logits.argmax(-1).to(torch.int32)
        gen_toks.append(tok)
        logits, state = decode_step(cfg, params, tok[:, None], state,
                                    torch.tensor(200 + step - 1, device=dev))
        if step in (1, 8, 16):
            dec[step] = (logits, ssm_states(state))
    for step, (dl, dssm) in dec.items():
        toks = torch.cat([prompt, torch.stack(gen_toks[:step], dim=1)], dim=1)
        pl, pst = prefill(cfg, params, {"tokens": toks},
                          init_state(cfg, 1, 256, device=dev))
        err = max_err(dl, pl)
        scale = float(pl.abs().max())
        rels = [max_err(a, b) / float(b.abs().max())
                for a, b in zip(dssm, ssm_states(pst))]
        log(f"consistency-hybrid: step {step}: max |decode - prefill| "
            f"{err:.3e}, max |logit| {scale:.3f}, ratio {err / scale:.3e} "
            f"(limit 1e-3); ssm state relative errors "
            f"{', '.join(f'{r:.3e}' for r in rels)} (limit 1e-4)")
        check(err <= 1e-3 * scale, f"consistency-hybrid: step {step} logits "
              f"differ by {err} against max logit {scale}")
        check(max(rels) <= 1e-4, f"consistency-hybrid: step {step} ssm "
              f"states differ by {rels} relative")


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

    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as decode_mod
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import mamba_scan as scan_mod

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
    # a 64 MiB read between timed launches evicts the 50 MB L2 and leaves
    # it clean (a write would leave ~50 MB of dirty lines for the timed
    # launch to write back)
    scratch = torch.zeros(8 << 20, dtype=torch.int64, device=dev)

    def flush():
        scratch.sum()

    # -- 1. build --------------------------------------------------------------
    t0 = time.perf_counter()
    info = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(info)}")
    for name, i in info.items():
        for line in i["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")

    # -- 2. kernels ------------------------------------------------------------
    kernels = phase_kernels(torch, flash_mod, decode_mod, flush)
    kernels += phase_hybrid_kernels(torch, decode_mod, scan_mod, flush)
    _log_records(kernels, "scaled_dot_product_attention")
    log("kernels: " + json.dumps([r["name"] for r in kernels]))

    # -- 3-5. starcoder2-3b: serve, consistency, redundancy -----------------------
    paths = {"serve": phase_dense(torch, dev, np)}
    _free(torch)
    # -- 6-7. Jamba, depth-cut, bf16: serve-hybrid, redundancy-hybrid -------------
    paths["serve-hybrid"] = phase_hybrid(torch, dev, np)
    _free(torch)
    # -- 8. consistency-hybrid (f32) ---------------------------------------------
    phase_consistency_hybrid(torch, dev, np)
    _free(torch)

    for r in kernels:
        r["launches_by_path"] = {p: c[r["name"]]["launches"]
                                 for p, c in paths.items()}
        r["launches"] = sum(r["launches_by_path"].values())
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _free(torch):
    """Return the last phase's weights to the card before the next."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    log(f"chip_smoke: {torch.cuda.memory_allocated() / 1e9:.3f} GB still "
        f"allocated, peak so far {torch.cuda.max_memory_allocated() / 1e9:.3f}"
        f" GB")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


if __name__ == "__main__":
    sys.exit(main())
