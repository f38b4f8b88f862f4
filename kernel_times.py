#!/usr/bin/env python3
"""Time the port's four kernels under three clocks, so that two versions
of the kernels can be compared with one clock.

Run on one NVIDIA GPU from the repository root:

    python3 kernel_times.py [--src CHECKOUT] [--label NAME]

The kernels and their wrappers come from ``CHECKOUT/src/repro_torch``
(default: this checkout), built there; the timing code is this file's and
``chip_smoke.py``'s, whatever ``--src`` names.  To compare two versions,
run it once per checkout on one card, back to back, in the order A, B,
B, A, since times vary more between machines and hours than within one
sitting.

Every kernel is timed at ``chip_smoke.py``'s timed shapes, and
``scaled_dot_product_attention`` beside the two attention kernels that
have one PyTorch call for the same function.  The clocks:

* ``launch``: CUDA events around the call, right after a 64 MiB write
  that evicts the L2.  The card is idle when the call is enqueued, so the
  wrapper's Python between the events is timed too, and the call writes
  back the write's dirty lines.
* ``device``: CUDA events around the call, after a 64 MiB read and a
  0.2 ms spin on the card, so the card is busy while the host enqueues
  the call; ``chip_smoke.py`` times its kernels so.
* ``cupti``: the summed device durations of the call's kernels, from
  torch.profiler, after a 64 MiB read: no host time and no gap between a
  call's kernels.  It is also given per kernel, so the dense kernel's
  split and merge passes show apart.

It prints the card's name and power limit, each library's ptxas register
and spill lines, a digest of each kernel function's SASS
(``cuobjdump -sass`` with addresses and encodings stripped, so equal
digests mean the same instructions), and one JSON line per timing.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import chip_smoke

ITERS = 50
CUPTI_CALLS = 20


def _emit(label, **rec):
    print(json.dumps({"label": label, **rec}), flush=True)


def _sass_digests(cuobjdump, lib):
    """{kernel function: sha256[:12] of its instructions}."""
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and name is not None:
            funcs[name].append(m.group(1))
    return {n: hashlib.sha256("\n".join(ins).encode()).hexdigest()[:12]
            for n, ins in funcs.items()}


def _cupti_ms(torch, fn, flush, skip):
    """({kernel name: device ms per call}, total device ms per call) over
    :data:`CUPTI_CALLS` calls of ``fn``, kernels named in ``skip`` left
    out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CUPTI_CALLS):
            flush()
            fn()
        torch.cuda.synchronize()
    per = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.key in skip:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        per[ev.key] = us / 1e3 / CUPTI_CALLS
    return per, sum(per.values())


def _flush_kernels(torch, flush):
    """Names of the kernels that ``flush`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flush()
        torch.cuda.synchronize()
    return {ev.key for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA}


def _cases(torch, flash_mod, decode_mod, scan_mod):
    """(name, fn) at chip_smoke.py's timed shapes, inputs from seeds."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    bf = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # prefill: B 8, S 512, 24/2 heads, hd 128, causal
    q, k, v = (randn((8, 512, 24, 128), bf), randn((8, 512, 2, 128), bf),
               randn((8, 512, 2, 128), bf))
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    # paged decode: 6 requests, 16-line blocks, 32 per table
    lens_p = [116, 144, 216, 272, 400, 512]
    nb = 8 * 32
    qp = randn((6, 24, 128), bf)
    kp, vp = randn((nb, 16, 2, 128), bf), randn((nb, 16, 2, 128), bf)
    tables = torch.randperm(nb, generator=gen, device=dev)[:6 * 32]
    tables = tables.reshape(6, 32).to(torch.int32)
    lp = torch.tensor(lens_p, dtype=torch.int32, device=dev)
    # dense decode: 8 rows, W 1024, 64/8 heads, hd 128
    lens_d = [116, 272, 316, 528, 716, 1016, 1, 1]
    qd = randn((8, 1, 64, 128), bf)
    kd, vd = randn((8, 1024, 8, 128), bf), randn((8, 1024, 8, 128), bf)
    ld = torch.tensor(lens_d, dtype=torch.int32, device=dev)
    qdt, kdt, vdt = qd.transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2)
    mask = (torch.arange(1024, device=dev)[None] < ld[:, None])[:, None, None]
    # selective scan: B 1, S 512, C 16384, N 16, f32
    scan = (randn((1, 512, 16384)),
            torch.nn.functional.softplus(randn((1, 512, 16384)) - 1.0),
            randn((1, 512, 16)), randn((1, 512, 16)),
            -torch.exp(randn((16384, 16)) * 0.5), randn((16384,)),
            randn((1, 16384, 16)) * 0.1)
    return [
        ("flash_attention", lambda: flash_mod.flash_attention_cuda(
            q, k, v, causal=True, window=4096)),
        ("flash_attention:sdpa", lambda: sdpa(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)),
        ("paged_decode_attention", lambda: decode_mod.
         paged_decode_attention_cuda(qp, kp, vp, tables, lp)),
        ("decode_attention", lambda: decode_mod.decode_attention_cuda(
            qd, kd, vd, ld)),
        ("decode_attention:sdpa", lambda: sdpa(qdt, kdt, vdt, attn_mask=mask,
                                               enable_gqa=True)),
        ("mamba_scan", lambda: scan_mod.mamba_scan_cuda(*scan)),
    ]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(chip_smoke.ROOT),
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--label", default=None, help="tag of every JSON line")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    label = args.label or src.name
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (src / "src" / "repro_torch").is_dir():
        print(f"kernel_times: no src/repro_torch under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as decode_mod
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import mamba_scan as scan_mod
    if not Path(build.__file__).resolve().is_relative_to(src):
        print(f"kernel_times: imported {build.__file__}, not the package "
              f"under {src}", file=sys.stderr)
        return 2

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0].strip(), flush=True)
    info = build.build_all()
    cuobjdump = str(Path(build.nvcc_path()).parent / "cuobjdump")
    for name in sorted(info):
        regs = [ln.strip() for ln in info[name]["ptxas"].splitlines()
                if "registers" in ln or "spill" in ln]
        _emit(label, ptxas=name, lines=regs)
        if os.access(cuobjdump, os.X_OK):
            _emit(label, sass=name,
                  digests=_sass_digests(cuobjdump, build.lib_path(name)))

    scratch = torch.zeros(8 << 20, dtype=torch.int64, device="cuda")

    def read_flush():
        scratch.sum()

    def write_flush():
        scratch.zero_()

    skip = _flush_kernels(torch, read_flush)
    for name, fn in _cases(torch, flash_mod, decode_mod, scan_mod):
        launch = chip_smoke.time_ms(fn, ITERS, write_flush, spin=False)
        device = chip_smoke.time_ms(fn, ITERS, read_flush, spin=True)
        per, cupti = _cupti_ms(torch, fn, read_flush, skip)
        _emit(label, kernel=name, launch_ms=launch, device_ms=device,
              cupti_ms=cupti, cupti_by_kernel=per)
    return 0


if __name__ == "__main__":
    sys.exit(main())
