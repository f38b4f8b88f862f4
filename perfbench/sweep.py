"""The knee sweep of an open-loop cell: runs the cell's traffic at each of
increasing rates, on several seeds, on the chip, and finds the highest
rate the system sustains.

    python3 perfbench/sweep.py --workload starcoder2-3b.code-completion \
        --rates 1 1.25 1.5 1.75 2 --seeds 11 12 13 --seconds 75 --warm 40 \
        --out results/sweep.json
    python3 perfbench/sweep.py --apply results/sweep.json --share 0.4

Every run is ``run.run`` on a copy of the cell whose traffic carries the
swept rate, all in one process, so the kernels load once; the committed
traffic file is read, never changed, until ``--apply``.  A run's in-flight
count (requests due and not yet finished, waiting or decoding) is read at
every second of its window.  The run grows where the mean count over the
window's last third exceeds the mean over its first third by more than
max(3, 25% of the window's mean): a window several request lifetimes long
averages the count's swing in a steady run well under that.  A rate is
sustained where its median seed does not grow; the sweep stops after the
first rate that is not.  The knee is the highest rate sustained with
every lower rate of the sweep, and ``--apply`` writes ``--share`` (0.8 by
default) x the knee into the cell's traffic file, with the sweep's table
beside it, so that later cells can take their rates from the same knee.
"""
import argparse
import copy
import json
import statistics
import sys
import time
from pathlib import Path

import run as R

HERE = Path(__file__).resolve().parent
#: growth over the window that a steady run does not reach: this share of
#: its mean in-flight count, and at least ``FLOOR`` requests
GROWTH, FLOOR = 0.25, 3.0


def grows(in_flight) -> bool:
    """Whether the in-flight count, read once a second, grows from the
    window's first third to its last."""
    n = len(in_flight) // 3
    if n == 0:
        raise ValueError("a window of under three readings")
    first = statistics.fmean(in_flight[:n])
    last = statistics.fmean(in_flight[-n:])
    return last - first > max(FLOOR, GROWTH * statistics.fmean(in_flight))


def one(cell, rate: float, seed: int, seconds: float,
        warm: float) -> dict:
    import torch
    c = copy.deepcopy(cell)
    c.traffic["arrival"]["rate"] = rate
    c.traffic["warm_seconds"] = warm
    out = R.run(c, seed, seconds, False, "cuda", time.perf_counter())
    torch.cuda.empty_cache()
    info = out["info"]
    flight = info["in_flight_per_s"]
    return {"rate": rate, "seed": seed, "grows": grows(flight),
            "in_flight_mean": statistics.fmean(flight),
            "in_flight_thirds": [
                statistics.fmean(flight[i * len(flight) // 3:
                                        (i + 1) * len(flight) // 3])
                for i in range(3)],
            "ttft_p50_ms": info["tails_ms"]["ttft_p50"],
            "ttft_p95_ms": info["tails_ms"]["ttft_p95"],
            "tbt_p95_ms": info["tails_ms"]["tbt_p95"],
            "tpot_p50_ms": info["tpot_ms"]["p50"],
            "output_tokens_per_s": info["output_tokens_per_s"],
            "ttft_samples": info["ttft_samples"],
            "attempted": out["attempted"], "correct": out["correct"],
            "widest_gap": out["check"]["widest_gap"]["value"],
            "device": out["device"]["kind"],
            "power_limit_w": out.get("power_limit_w")}


def sustained(rows) -> bool:
    return statistics.median(1.0 if r["grows"] else 0.0 for r in rows) < 0.5


def knee(rows) -> float:
    best = None
    for rate in sorted({r["rate"] for r in rows}):
        if not sustained([r for r in rows if r["rate"] == rate]):
            break
        best = rate
    if best is None:
        raise RuntimeError("the backlog grows at every rate of the sweep")
    return best


def apply(path: Path, share: float = 0.8) -> None:
    res = json.loads(path.read_text())
    cell = json.loads((HERE / "cells" / f"{res['workload']}.json")
                      .read_text())
    tpath = HERE / "traffic" / f"{cell['traffic']}.json"
    traffic = json.loads(tpath.read_text())
    traffic["arrival"]["rate"] = round(share * res["knee"], 3)
    traffic["knee"] = {k: res[k] for k in ("knee", "seconds",
                                           "warm_seconds", "seeds", "rule",
                                           "rows")}
    tpath.write_text(json.dumps(traffic, indent=2) + "\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload")
    p.add_argument("--rates", type=float, nargs="+")
    p.add_argument("--seeds", type=int, nargs="+", default=[7, 8, 9])
    p.add_argument("--seconds", type=float, default=90.0)
    p.add_argument("--warm", type=float, default=40.0,
                   help="seconds of the same traffic before each window")
    p.add_argument("--out", type=Path)
    p.add_argument("--apply", type=Path)
    p.add_argument("--share", type=float, default=0.8,
                   help="the cell's rate as a share of the knee")
    a = p.parse_args(argv)
    if a.apply:
        apply(a.apply, a.share)
        return 0
    R.setup_paths()
    import torch
    from bench import spec
    if not torch.cuda.is_available():
        print("the sweep runs on the card", file=sys.stderr)
        return 2
    cell = spec.load(a.workload)
    rows = []
    for rate in sorted(a.rates):
        at = []
        for seed in a.seeds:
            at.append(one(cell, rate, seed, a.seconds, a.warm))
            print(json.dumps(at[-1]), flush=True)
        rows += at
        if not sustained(at):
            break
    res = {"workload": a.workload, "seeds": a.seeds, "seconds": a.seconds,
           "warm_seconds": a.warm,
           "rule": f"grows: last third's mean in-flight count - first "
                   f"third's > max({FLOOR:g}, {GROWTH:g} x the mean); "
                   f"sustained: the median seed does not grow",
           "knee": knee(rows), "rows": rows}
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(res, indent=2) + "\n")
    print(json.dumps({"knee": res["knee"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
