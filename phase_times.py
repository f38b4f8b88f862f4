"""Seconds of chip_smoke.py's serve-xlstm phase (phase 20) from one or
more checkouts, on one card, each run in its own process.

    python3 phase_times.py DIR [DIR ...]

runs ``phase_xlstm`` of ``DIR/chip_smoke.py`` against ``DIR/src`` for each
``DIR`` in turn, with TF32 off as chip_smoke.py runs it, and prints the
card's name and power limit, then one JSON line per run: the checkout, the
phase's seconds and the kernel counts it returned.  The phase builds no
kernel (the xLSTM stacks reach none), so a run needs no build step.  To
compare a change with its parent, unpack the parent into a directory that
``.gitignore`` lists and pass the two in the order parent, change, change,
parent.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path


def _one(root: Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    counts = chip_smoke.phase_xlstm(torch, dev, np)
    torch.cuda.synchronize()
    return {"checkout": str(root), "phase": "serve-xlstm",
            "seconds": time.perf_counter() - t0, "counts": counts}


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(_one(Path(argv[1]).resolve())), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    print(smi.splitlines()[0].strip(), flush=True)
    for root in argv:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
