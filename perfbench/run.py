"""Runs one cell of the benchmark of ``repro_torch`` once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for.  In order: build the port's kernels into the checkout's build
directory (later runs load them from there), draw the weights on the card
from the seed, build the cluster through
``repro_torch.api.build_cluster``, warm it with the cell's own traffic,
drive it with the wall-clock pump for ``--seconds``, check what it served
against the plain reference, and print one JSON line.  With ``--trace 0``
the line holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics from a profiled window.  Without a card it exits with
an error; it never runs on the CPU.
"""
import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "perfbench"
#: build and kernel caches, at fixed paths inside the checkout
CACHE = ROOT / "build" / "perfbench-cache"
#: top-level modules a run must not have loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: seconds the closed loop's warm stretch may take to reach every
#: client's first token
WARM_TIMEOUT = 120.0


def setup_paths() -> None:
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    for p in (str(ROOT / "src"), str(HERE)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def port_config(f: dict):
    """The port's ``ModelConfig`` with the configuration file's sizes."""
    import dataclasses
    from repro_torch.configs import get_config
    if f.get("norm_type", "rms_norm") != "rms_norm" or f.get("use_bias"):
        raise ValueError("the port runs RMS norms and no biases")
    if f.get("scale_emb", 1) != 1:
        raise ValueError("the port does not scale its embedding")
    L = f["num_hidden_layers"]
    return dataclasses.replace(
        get_config(f["arch"]), num_layers=L, d_model=f["hidden_size"],
        num_heads=f["num_attention_heads"],
        num_kv_heads=f["num_key_value_heads"], head_dim=f["head_dim"],
        d_ff=f["intermediate_size"], vocab_size=f["vocab_size"],
        rope_theta=f["rope_theta"], sliding_window=f.get("sliding_window"),
        rms_norm_eps=f.get("rms_norm_eps", f.get("norm_epsilon")),
        activation="swiglu" if f["hidden_act"] == "silu" else "gelu",
        tie_embeddings=f["tie_word_embeddings"],
        residual_scale=(f["scale_depth"] / math.sqrt(L)
                        if "scale_depth" in f else 1.0),
        logit_scale=(f["dim_model_base"] / f["hidden_size"]
                     if "dim_model_base" in f else 1.0),
        dtype=f["torch_dtype"], block_pattern=("attn",) * L)


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t0: float, control: bool = False) -> dict:
    """One run of ``cell``; returns the result line as a dict (with the
    numbers compared under ``check``).  With ``control`` the float8
    control reads the same sample afterwards (``control_gap``, beside the
    served tokens' ``widest_gap``); the benchmark's own runs never do."""
    import torch
    from bench import check as chk
    from bench import stats
    from bench import spec
    from bench import trace as tr
    from bench import traffic as T
    from bench.host import Host
    from bench import weights as W
    from bench.probes import Probes
    from bench.pump import Pump, request_factory
    from bench.record import Run
    from flops import Shape
    from repro_torch import kernels
    from repro_torch.api import ServeSpec, build_cluster
    from repro_torch.configs import get_config
    from repro_torch.serving.request import Phase

    f, dep = cell.config, cell.config["deployment"]
    cuda = device == "cuda"
    cfg = port_config(f)
    if cuda and cfg != get_config(f["arch"]):
        raise ValueError(f"{cell.config_name}: the file's sizes are not the "
                         f"port's {f['arch']!r}")
    if cuda:
        from repro_torch.kernels import build
        build.build_all()
    power = power_limit_w() if cuda else None
    w = W.draw(f, seed, device)
    cluster = build_cluster(ServeSpec(
        arch=f["arch"], policy=dep["policy"], n_instances=dep["instances"],
        num_slots=dep["slots"], kv_capacity=dep["kv_capacity"],
        block_lines=dep["block_lines"],
        fuse_decode_steps=dep["fuse_decode_steps"],
        temperature=dep["temperature"], eos_token=dep["eos_token"],
        reduced=False, seed=0, device=device), cfg=cfg,
        params=W.port_tree(f, w))

    traffic = cell.traffic
    closed = traffic["arrival"]["kind"] == "closed"
    if closed:
        clients = T.window_traffic(traffic, seed, seconds)
        every = [a for c in clients for a in c]
    else:
        warm = T.warm_traffic(traffic, seed)
        window = T.window_traffic(traffic, seed, seconds)
        every = warm + window
        for i, a in enumerate(every):
            a.index = i
    ids = T.prompt_ids(seed, [a.prompt_len for a in every], f["vocab_size"])
    prompts = {a.index: p for a, p in zip(every, ids)}

    kernels.reset_counts()
    probes = Probes(spans_on=trace).install(cluster)
    pump = Pump(cluster, request_factory(prompts))
    prof = tr.profiler(device) if trace else None
    if prof is not None:
        with tr.profiler(device):     # CUPTI's first start is slow
            torch.ones(1, device=device).add_(1)
    edge = {}
    pauses = GcPauses()
    host = Host()

    def open_window():
        if cuda:
            torch.cuda.synchronize()
        edge["stats0"] = dict(cluster.stats)
        edge["sched0"] = (cluster.sched_time_s, cluster.n_iterations)
        host.open()
        pauses.install()
        if prof is not None:
            prof.start()
            probes.recording = cuda
            edge["prof0"] = time.perf_counter()

    if closed:
        start = pump.closed_loop(clients, seconds, open_window,
                                 WARM_TIMEOUT)
    else:
        pump.open_loop(warm, pump.clock(), traffic["warm_seconds"],
                       window=False)
        open_window()
        start = pump.clock()
        pump.open_loop(window, start, seconds, window=True)
    if cuda:
        torch.cuda.synchronize()
    t_stop = time.perf_counter()
    pauses.remove()
    host.close()
    probes.recording = False
    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    counts = kernels.read_counts()

    rec = Run(cell=cell, seed=seed, seconds=seconds, start=start,
              end=start + seconds, setup_s=start - t0, pump=pump,
              probes=probes, shape=Shape.of(f),
              stats0=edge["stats0"], stats1=dict(cluster.stats),
              sched0=edge["sched0"],
              sched1=(cluster.sched_time_s, cluster.n_iterations))
    if prof is not None:
        rec.trace = tr.reduce(prof, t_stop - edge["prof0"], probes.marks)
        del prof
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = spec.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    reqs = rec.window_requests()
    if closed:
        reqs = [s for s in pump.sent.values()
                if s.window or s.req.phase is not Phase.DONE]
    failed = sum(1 for s in reqs
                 if s.req.phase in (Phase.SHED, Phase.ABORTED))
    for flag, name in (("promoted", "bench.promote"),
                       ("streamed", "bench.stream"),
                       ("mirrored", "bench.mirror")):
        for rid in set(probes.moves.get(name, ())):
            setattr(pump.sent[rid], flag, True)
    # the finished requests; in a closed loop whose requests outlast the
    # window, every request with tokens served so far
    cands = [s for s in pump.sent.values()
             if (len(s.req.output_tokens) >= 2 if closed
                 else s.req.phase is Phase.DONE)]
    chosen = chk.choose(cands, seed, cell.check["sample"])

    # the program's state goes before the reference runs
    probes.remove()
    pump.cluster = None
    del cluster
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    widest, n_tok, per = (chk.served_gaps(f, w, chosen, device) if chosen
                          else (math.inf, 0, []))
    t_ref = time.perf_counter() - t_ref
    checks = {"widest_gap": {"value": widest,
                             "limit": cell.check["gap_limit"]},
              "tokens_compared": {"value": n_tok,
                                  "limit": cell.check["min_tokens"]}}
    correct = (widest <= cell.check["gap_limit"]
               and n_tok >= cell.check["min_tokens"])
    if cuda:
        plain = sum(c["plain_calls"] for c in counts.values())
        checks["plain_calls"] = {"value": plain, "limit": 0}
        correct = correct and plain == 0
    ctrl = None
    if control and chosen:
        ctrl = chk.control_gap(f, w, chosen, device)

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(reqs),
           "failed": failed, "metrics": metrics, "device": dev}
    if rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        out["breakdown"] = {
            "device_ops": [list(x) for x in rec.trace.device_ops],
            "idle_gaps": [list(x) for x in rec.trace.idle_gaps]}
    out["power_limit_w"] = power
    ttft, tbt = rec.ttfts_ms(), rec.tbts_ms()
    out["info"] = {
        "tails_ms": {f"{k}_p{q}": stats.percentile(v, q)
                     for k, v in (("ttft", ttft), ("tbt", tbt))
                     for q in (50, 90, 95, 99)},
        "ttft_samples": len(ttft), "tbt_samples": len(tbt),
        "backlog": pump.in_flight([rec.start + q * seconds
                                   for q in (0.25, 0.5, 0.75, 1.0)]),
        "in_flight_per_s": pump.in_flight(
            [rec.start + k for k in range(1, int(seconds) + 1)]),
        "tpot_ms": {f"p{q}": stats.percentile(rec.tpots_ms(), q)
                    for q in (50, 90)},
        "gc_pauses": pauses.summary(),
        "host": host.summary(torch.get_num_threads()),
        "tbt_zero_share": (sum(1 for g in tbt if g == 0) / len(tbt)
                           if tbt else None),
        "tbt_mean_ms": sum(tbt) / len(tbt) if tbt else None,
        "output_tokens_per_s": stats.rate(rec.output_tokens(), seconds),
        "steps": len(rec.steps()), "iterations": rec.sched1[1] - rec.sched0[1],
        "sent": len(pump.sent), "done": len(cands) if not closed else None,
        "stats": {k: rec.delta(k) for k in rec.stats1 if rec.delta(k)},
        "compared": [[s.req.rid, s.req.prompt_len, len(s.req.output_tokens),
                      s.promoted, s.streamed, s.mirrored] for s in chosen],
        "per_request_gap": per, "reference_s": t_ref, "control_gap": ctrl,
        "launches": {k: c["launches"] for k, c in counts.items()}}
    if rec.trace is not None:
        out["info"]["trace"] = {
            "reduce_s": rec.trace.reduce_s,
            "launch_events": rec.trace.n_launch_events,
            "by_range": rec.trace.by_range,
            "launches_by_range": rec.trace.launches_by_range,
            "device_events": rec.trace.n_device_events}
    out["check"] = checks
    return out


class GcPauses:
    """The interpreter's garbage collections inside the window: how many
    of each generation, and the seconds they held the host."""

    def __init__(self):
        self.n = [0, 0, 0]
        self.seconds = [0.0, 0.0, 0.0]
        self._t = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            g = info["generation"]
            self.n[g] += 1
            self.seconds[g] += time.perf_counter() - self._t
            self._t = None

    def install(self):
        gc.callbacks.append(self)

    def remove(self):
        if self in gc.callbacks:
            gc.callbacks.remove(self)

    def summary(self) -> dict:
        return {"collections": self.n, "seconds": self.seconds}


def emit(out: dict) -> int:
    """The compared numbers as the last lines on standard error, then
    the result as the last line on standard output."""
    print("info " + json.dumps(out.pop("info")), file=sys.stderr)
    for name, c in out["check"].items():
        rel = ">=" if name == "tokens_compared" else "<="
        print(f"check {name} {c['value']} {rel} {c['limit']}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    setup_paths()
    # one thread for the host's tensor and array work: the host paces the
    # served path, and idle worker threads only contend for its cores
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    from bench import spec
    cell = spec.load(args.workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this "
              f"machine has {n}. The benchmark does not run on the CPU.",
              file=sys.stderr)
        return 2
    out = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", _T0)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}; nothing it runs may load "
              f"JAX or the JAX package", file=sys.stderr)
        return 3
    return emit(out)


if __name__ == "__main__":
    sys.exit(main())
