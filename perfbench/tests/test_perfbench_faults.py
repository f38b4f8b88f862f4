"""The run as the benchmark drives it, on the CPU at a tiny size (past
the look for a card), with the served path broken underneath: each fault
a serving cell can have makes ``correct`` come out false, and the sound
path comes out true.  Also: without a card the benchmark prints no
result and exits with an error."""
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

import run as R
from conftest import HERE, ROOT, tiny_cell

OPEN = "starcoder2-3b.code-completion"
CLOSED = "minicpm-2b.chat-heavy-closed"


def _drive(name, seed=2**31 + 55, trace=False):
    return R.run(tiny_cell(name), seed, 2.5, trace, "cpu",
                 time.perf_counter())


def _stale_state(monkeypatch):
    """A decode step that hands back its state unchanged: it computes on
    a copy of the cache, so its new lines never land."""
    from repro_torch.models import model as M
    plain = M.decode_step_paged

    def clone(t):
        if isinstance(t, dict):
            return {k: clone(v) for k, v in t.items()}
        if isinstance(t, list):
            return [clone(v) for v in t]
        return t.clone()

    def step(cfg, params, tokens, state, *a, **kw):
        logits, _ = plain(cfg, params, tokens, clone(state), *a, **kw)
        return logits, state
    monkeypatch.setattr(M, "decode_step_paged", step)


def _half_batch(monkeypatch):
    """A decode step that leaves out the second half of its batch: those
    rows get the first half's logits."""
    from repro_torch.models import model as M
    plain = M.decode_step_paged

    def step(*a, **kw):
        logits, state = plain(*a, **kw)
        h = logits.shape[0] // 2
        if h:
            logits = logits.clone()
            logits[logits.shape[0] - h:] = logits[:h]
        return logits, state
    monkeypatch.setattr(M, "decode_step_paged", step)


def _no_exchange(monkeypatch):
    """The exchange between the two instances left out: mirror syncs copy
    nothing and streams deliver zeros."""
    from repro_torch.kvstore.paged import PagedStore
    plain_import = PagedStore.import_chunk

    def copy_lines(self, src, src_slot, dst_slot, from_line, to_line):
        return float(max(0, to_line - from_line) * self.costs.line_bytes)

    def import_chunk(self, slot, path, chunk):
        return plain_import(self, slot, path, torch.zeros_like(chunk))
    monkeypatch.setattr(PagedStore, "copy_lines", copy_lines)
    monkeypatch.setattr(PagedStore, "import_chunk", import_chunk)


def _altered_token(monkeypatch):
    """Every sampled token altered where it is produced."""
    from repro_torch.serving import engine, sampling
    plain = sampling.sample_slots

    def sample_slots(logits, *a, **kw):
        return (plain(logits, *a, **kw) + 1) % logits.shape[-1]
    monkeypatch.setattr(sampling, "sample_slots", sample_slots)
    monkeypatch.setattr(engine, "sample_slots", sample_slots)


FAULTS = {"state_unchanged": _stale_state, "half_batch": _half_batch,
          "no_exchange": _no_exchange, "altered_token": _altered_token}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", [OPEN, CLOSED])
def test_the_sound_path_is_correct(name, trace):
    """Untraced, the line holds the cell's end-to-end metrics; traced, its
    per-layer metrics that a CPU run can read (no device trace)."""
    out = _drive(name, trace=trace)
    assert out["correct"], out["check"]
    assert out["check"]["widest_gap"]["value"] <= 1e-3
    cell = tiny_cell(name)
    want = {m["name"] for m in (cell.per_layer if trace
                                else cell.end_to_end)}
    assert set(out["metrics"]) <= want
    assert "setup_s" in out["metrics"] or trace
    # the judged medians are the info line's, the statistics their
    # bounds were measured on
    for metric, tail in (("tbt_p50_ms", "tbt_p50"), ("ttft_p50_ms",
                                                     "ttft_p50")):
        if metric in out["metrics"]:
            assert out["metrics"][metric]["value"] == \
                out["info"]["tails_ms"][tail]
    assert not trace or {"iter_ms.latency", "iter_ms.throughput"} & set(
        out["metrics"])


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", [OPEN, CLOSED])
def test_a_fault_makes_the_run_incorrect(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _drive(name)
    assert not out["correct"], out["check"]


def test_without_a_card_there_is_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                        OPEN, "--seed", "1", "--seconds", "1", "--trace",
                        "0"], capture_output=True, text=True, cwd=ROOT,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "does not run on the CPU" in p.stderr


def test_without_the_program_there_is_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, a run fails."""
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        OPEN, "--seed", "1", "--seconds", "1", "--trace",
                        "0"], capture_output=True, text=True, cwd=tmp_path,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    json.loads((tmp_path / "BENCHMARK.json").read_text())
