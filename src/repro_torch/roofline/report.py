"""Roofline report: reads the dry run's records and prints the roofline
table (the JAX package's), then each record's per-chip footprint.

The collective column is the per-rank program's wire bytes at the link
rate (``analysis.analyze``); it reads "n/a" for a record without them.

Usage: PYTHONPATH=src python -m repro_torch.roofline.report
       [--results DIR] [--dryrun FILE] [--mesh 16x16|2x16x16] [--json OUT]
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.roofline.analysis import analyze


def fmt_s(t: float) -> str:
    if t >= 1.0:
        return f"{t:7.2f}s "
    if t >= 1e-3:
        return f"{t * 1e3:7.2f}ms"
    return f"{t * 1e6:7.1f}us"


def one_liner(r) -> str:
    hints = {
        "compute": "raise tensor-core utilization / cut redundant FLOPs "
                   "(remat & masked-block waste)",
        "memory": "cut HBM traffic: fuse, shrink f32 temps, chunkwise scan",
        "collective": "reshard to remove all-gathers / overlap NVLink and "
                      "InfiniBand collectives with compute",
    }
    return hints[r.dominant]


def chips_of(mesh: str) -> int:
    n = 1
    for s in mesh.split("x"):
        n *= int(s)
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="results")
    ap.add_argument("--dryrun", default="torch_dryrun.json")
    ap.add_argument("--mesh", default="16x16",
                    help="the records' mesh to report (16x16 or 2x16x16)")
    ap.add_argument("--json", default=None, help="also dump terms as json")
    args = ap.parse_args(argv)

    with open(os.path.join(args.results, args.dryrun)) as f:
        records = [r for r in json.load(f) if r["mesh"] == args.mesh]

    rows, out_json = [], []
    for rec in records:
        if not rec.get("ok"):
            rows.append((rec["arch"], rec["shape"], "FAILED", "", "", "", "",
                         "", ""))
            continue
        cfg = get_config(rec["arch"])
        shape = INPUT_SHAPES[rec["shape"]]
        r = analyze(rec, cfg, shape, chips=chips_of(rec["mesh"]))
        rows.append((
            r.arch, r.shape, fmt_s(r.t_compute), fmt_s(r.t_memory),
            fmt_s(r.t_collective) if "collective_by_kind" in rec else "n/a",
            r.dominant, f"{r.model_flops:.2e}", f"{r.useful_ratio:.2f}",
            one_liner(r)))
        out_json.append({
            "arch": r.arch, "shape": r.shape, "mesh": r.mesh,
            "t_compute": r.t_compute, "t_memory": r.t_memory,
            "t_collective": r.t_collective, "dominant": r.dominant,
            "model_flops": r.model_flops,
            "hlo_flops_global": r.hlo_flops_global,
            "useful_ratio": r.useful_ratio,
            "collective_by_kind": r.collective_by_kind,
            "argument_gb": rec["argument_size_in_bytes"] / 1e9,
            "peak_live_gb": rec.get("peak_live_bytes_above_arguments",
                                    0) / 1e9,
            "fits_h100": rec["fits_h100"], "lower_s": rec["lower_s"],
        })

    print("| arch | shape | compute | memory | collective | dominant | "
          "MODEL_FLOPS | useful | next lever |")
    print("|---|---|---|---|---|---|---|---|---|")
    for row in rows:
        print("| " + " | ".join(str(c) for c in row) + " |")

    print("\n| arch | shape | argument GB/chip | output GB/chip | "
          "alias GB/chip | fits_h100 | lower_s |")
    print("|---|---|---|---|---|---|---|")
    for rec in records:
        if rec.get("ok"):
            print(f"| {rec['arch']} | {rec['shape']} | "
                  f"{rec['argument_size_in_bytes'] / 1e9:.2f} | "
                  f"{rec['output_size_in_bytes'] / 1e9:.2f} | "
                  f"{rec['alias_size_in_bytes'] / 1e9:.2f} | "
                  f"{rec['fits_h100']} | {rec['lower_s']} |")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(out_json, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
