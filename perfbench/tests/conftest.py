"""Shared set-up of the benchmark's CPU tests: the harness's folders on
the path, and a cell of either configuration cut to a size the CPU runs
in seconds (its files are the real cell's with smaller numbers)."""
import copy
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for p in (str(ROOT / "src"), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = dict(num_hidden_layers=2, hidden_size=256, num_attention_heads=4,
            head_dim=64, intermediate_size=256, vocab_size=512,
            torch_dtype="float32")


def with_held() -> dict:
    """``BENCHMARK.json`` with the entries of each cell held out of it
    (``held/<cell>.json``) put back, so that the tests still drive the
    held cells' paths."""
    import json
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for f in sorted((HERE / "held").glob("*.json")):
        h = json.loads(f.read_text())
        bench["configs"].append(h["config"])
        bench["workloads"].append(h["workload"])
        bench["end_to_end"] += h["end_to_end"]
        bench["per_layer"] += h["per_layer"]
    return bench


def tiny_config(name: str) -> dict:
    """The configuration file ``name`` at the tiny size, in float32."""
    import json
    f = json.loads((HERE / "configs" / f"{name}.json").read_text())
    f.update(TINY)
    f["num_key_value_heads"] = min(f["num_key_value_heads"], 4)
    if f.get("sliding_window"):
        f["sliding_window"] = 64
    f["deployment"].update(slots=4, kv_capacity=64, block_lines=8)
    return f


def tiny_cell(name: str, gap_limit: float = 1e-3):
    """A real cell with its configuration and traffic cut to the tiny
    size: open loop at 20 req/s after 2 s of warm-up, or 8 closed-loop
    clients."""
    from bench import spec
    cell = spec.load(name, benchmark=with_held())
    cell.config = tiny_config(cell.config_name)
    if cell.traffic["arrival"]["kind"] == "closed":
        cell.traffic = {"arrival": {"kind": "closed", "clients": 8,
                                    "per_client": 60},
                        "lengths": {"kind": "uniform", "prompt": [8, 30],
                                    "output": [8, 20]}}
    else:
        cell.traffic = {"arrival": {"kind": "poisson", "rate": 20.0},
                        "lengths": {"kind": "uniform", "prompt": [8, 40],
                                    "output": [4, 8]},
                        "warm_seconds": 2.0}
    cell.check = dict(cell.check, gap_limit=gap_limit, min_tokens=8)
    return cell


@pytest.fixture
def cuda():
    """Skips a test that needs the card, deciding at run time."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels have no "
                    "CPU mode)")
    return torch.device("cuda")
