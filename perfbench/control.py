"""Readings that set a cell's limit: the program's widest gap over many
seeds (the lower reading) and the float8 control's over the same samples
(the upper reading), in one process so set-up is paid once a seed and the
kernels are built once.

    python3 perfbench/control.py --workload starcoder2-3b.code-completion \
        --seconds 20 --seeds 11 12 13 ... --out results/control.json

Each seed is a whole run at the cell's own size and load (a shorter
window), then the reference and the control over its sample.  The
benchmark's own runs never read the control.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import run as R


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--out", type=Path)
    a = p.parse_args(argv)
    R.setup_paths()
    import torch
    from bench import spec
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    cell = spec.load(a.workload)
    rows = []
    for seed in a.seeds:
        out = R.run(cell, seed, a.seconds, False, "cuda",
                    time.perf_counter(), control=True)
        info = out["info"]
        rows.append({"seed": seed,
                     "widest_gap": out["check"]["widest_gap"]["value"],
                     "control_gap": info["control_gap"],
                     "tokens": out["check"]["tokens_compared"]["value"],
                     "per_request_gap": info["per_request_gap"],
                     "compared": info["compared"],
                     "correct": out["correct"]})
        print(json.dumps(rows[-1]), flush=True)
    res = {"workload": a.workload, "seconds": a.seconds,
           "lower": max(r["widest_gap"] for r in rows),
           "upper": min(r["control_gap"] for r in rows
                        if r["control_gap"] is not None),
           "rows": rows}
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(res, indent=2) + "\n")
    print(json.dumps({k: res[k] for k in ("workload", "lower", "upper")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
