"""The port's roofline and its operation counter held against the JAX
package's and against their own formulas.

``analytic_bytes``, ``_scan_state_bytes`` and ``model_flops`` equal the
JAX package's for every arch x input shape x layout; ``analyze`` with no
HLO: each term times the port's H100 constant equals the JAX package's
term times its v5e constant (both are the same FLOPs and bytes).  Each
kernel wrapper's meta branch: the output's shape and dtype, launch and
plain counters untouched, and the credited FLOPs equal to the kernel's
formula at two shapes.  ``steps`` off meta is the plain loop.  The report
prints both tables from a records file, and the collective column from a
record's per-rank collectives (``tests/test_torch_dryrun.py`` holds
``analyze``'s collective term for every config's train step).
"""
import json

import numpy as np
import pytest
import torch

import repro.configs as rcfg
from repro.roofline import analysis as ra
import repro_torch.configs as tcfg
from repro_torch.kernels import read_counts, reset_counts
from repro_torch.kernels import decode_attention as dmod
from repro_torch.kernels import flash_attention as fmod
from repro_torch.kernels import mamba_scan as smod
from repro_torch.roofline import analysis as ta
from repro_torch.core import opcount as count
from repro_torch.roofline import report
from repro_torch.sim.devices import H100, TPU_V5E

ARCHS = tcfg.list_archs(include_extra=True)
SHAPES = list(rcfg.INPUT_SHAPES)


def test_constants():
    assert ta.PEAK_FLOPS == 989e12 == H100.fp16_tflops * 1e12
    assert ta.HBM_BW == 3350e9 == H100.hbm_bw_gbps * 1e9
    assert ta.LINK_BW == 50e9
    assert (ra.PEAK_FLOPS, ra.HBM_BW) == (TPU_V5E.fp16_tflops * 1e12,
                                          TPU_V5E.hbm_bw_gbps * 1e9)
    assert ta._DTYPE_BYTES == ra._DTYPE_BYTES
    assert ta.ACT_IO_FACTOR == ra.ACT_IO_FACTOR


@pytest.mark.parametrize("n", [1, 2, 16, 512])
@pytest.mark.parametrize("kind", ["all-gather", "all-reduce",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_wire_bytes_match_reference(kind, n):
    assert ta._wire_bytes(kind, 12_345, n) == ra._wire_bytes(kind, 12_345, n)


@pytest.mark.parametrize("layout", ["tp", "fsdp"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_terms_match_reference(arch, shape, layout):
    cfg_r, cfg = rcfg.get_config(arch), tcfg.get_config(arch)
    shp_r, shp = rcfg.INPUT_SHAPES[shape], tcfg.INPUT_SHAPES[shape]
    for chips in (256, 512):
        assert ta.analytic_bytes(cfg, shp, chips, layout) == \
            ra.analytic_bytes(cfg_r, shp_r, chips, layout)
        assert ta._scan_state_bytes(cfg, shp, chips) == \
            ra._scan_state_bytes(cfg_r, shp_r, chips)
    assert ta.model_flops(cfg, shp) == ra.model_flops(cfg_r, shp_r)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_analyze_without_hlo_matches_reference(arch, shape):
    rec = {"arch": arch, "shape": shape, "mesh": "16x16", "layout": "tp",
           "flops": 1.2345e15}
    got = ta.analyze(rec, tcfg.get_config(arch), tcfg.INPUT_SHAPES[shape])
    want = ra.analyze(rec, None, rcfg.get_config(arch),
                      rcfg.INPUT_SHAPES[shape])
    assert np.isclose(got.t_compute * ta.PEAK_FLOPS,
                      want.t_compute * ra.PEAK_FLOPS, rtol=1e-12)
    assert np.isclose(got.t_memory * ta.HBM_BW, want.t_memory * ra.HBM_BW,
                      rtol=1e-12)
    assert got.t_collective == want.t_collective == 0.0
    assert got.collective_by_kind == want.collective_by_kind == {}
    assert got.model_flops == want.model_flops
    assert got.hlo_flops_global == want.hlo_flops_global
    assert got.useful_ratio == want.useful_ratio
    assert got.dominant == ("compute" if got.t_compute > got.t_memory
                            else "memory")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 1, 5, 40])
@pytest.mark.parametrize("sq,skv,q_offset", [(7, 7, 0), (9, 20, 11),
                                             (33, 33, 0)])
def test_visible_pairs_count_the_mask(sq, skv, q_offset, window, causal):
    qp = q_offset + np.arange(sq)[:, None]
    kp = np.arange(skv)[None]
    mask = np.ones((sq, skv), bool)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= qp - kp < window
    assert fmod.visible_pairs(sq, skv, causal=causal, window=window,
                              q_offset=q_offset) == int(mask.sum())


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _wrapper_cases():
    def flash(B, S, H, KVH, hd, window):
        q, k = _meta((B, S, H, hd)), _meta((B, S, KVH, hd))
        return ("kernel:flash_attention",
                lambda: fmod.flash_attention_cuda(q, k, k, window=window),
                (q.shape, q.dtype),
                4 * B * H * hd * fmod.visible_pairs(S, S, window=window))

    def dense(B, W, H, KVH, hd):
        q, kc = _meta((B, 1, H, hd)), _meta((B, W, KVH, hd))
        lens = _meta((B,), torch.int32)
        return ("kernel:decode_attention",
                lambda: dmod.decode_attention_cuda(q, kc, kc, lens),
                (q.shape, q.dtype), 4 * H * hd * B * W)

    def paged(B, H, KVH, hd, bl, mb):
        q, pool = _meta((B, H, hd)), _meta((B * mb, bl, KVH, hd))
        tables, lens = _meta((B, mb), torch.int32), _meta((B,), torch.int32)
        return ("kernel:paged_decode_attention",
                lambda: dmod.paged_decode_attention_cuda(q, pool, pool,
                                                         tables, lens),
                (q.shape, q.dtype), 4 * H * hd * B * mb * bl)

    def scan(B, S, C, N):
        f32 = torch.float32
        args = (_meta((B, S, C), f32), _meta((B, S, C), f32),
                _meta((B, S, N), f32), _meta((B, S, N), f32),
                _meta((C, N), f32), _meta((C,), f32), _meta((B, C, N), f32))
        return ("kernel:mamba_scan",
                lambda: smod.mamba_scan_cuda(*args)[0],
                ((B, S, C), f32), B * S * C * (6 * N + 3))

    return {
        "flash-minicpm-long": lambda: flash(2, 12_288, 36, 36, 64, 8_192),
        "flash-gqa": lambda: flash(1, 300, 24, 2, 128, None),
        "dense-ring-8192": lambda: dense(2, 8_192, 36, 36, 64),
        "dense-jamba": lambda: dense(8, 1_024, 64, 8, 128),
        "paged-main": lambda: paged(6, 24, 2, 128, 16, 32),
        "paged-minicpm": lambda: paged(3, 36, 36, 64, 32, 8),
        "scan-jamba": lambda: scan(1, 512, 16_384, 16),
        "scan-small": lambda: scan(2, 7, 100, 8),
    }


@pytest.mark.parametrize("case", list(_wrapper_cases()))
def test_wrapper_meta_branch_credits_its_formula(case):
    name, call, (shape, dtype), flops = _wrapper_cases()[case]()
    reset_counts()
    with count.Counter() as counter:
        out = call()
    assert out.is_meta and tuple(out.shape) == tuple(shape)
    assert out.dtype == dtype
    assert counter.credited == {name: float(flops)}
    assert counter.traced == 0
    for c in read_counts().values():
        assert c == {"launches": 0, "plain_calls": 0}


def test_wrapper_meta_branch_still_refuses_grad():
    q = _meta((1, 64, 4, 64)).requires_grad_(True)
    with pytest.raises(RuntimeError, match="grad"):
        fmod.flash_attention_cuda(q, q.detach(), q.detach())


def test_steps_off_meta_is_the_plain_loop():
    x = torch.arange(5.0, requires_grad=True)
    calls = []

    def body(i, carry, x):
        calls.append(i)
        return carry + x[i], carry * 2

    with count.Counter() as counter:
        carry, outs = count.steps("test", 5, body, torch.zeros(()), x)
    assert calls == [0, 1, 2, 3, 4]
    assert float(carry.detach()) == 10.0
    assert [float(o.detach()) for o in outs] == [0, 0, 2, 6, 12]
    assert counter.credited == {}


def test_steps_on_meta_runs_the_steady_trip_once():
    """Trips 0 (no grad on the carry), 1 (steady) and the last run, and
    trip 2 once more in the replay that measures it; trips 2-8 are
    credited their forward and backward matmuls."""
    w = torch.empty((8, 8), device="meta", requires_grad=True)
    calls = []

    def body(i, h, w):
        calls.append(i)
        return h @ w, h

    with count.Counter() as counter:
        h, outs = count.steps("mm", 10, body, torch.empty((3, 8),
                                                          device="meta"), w)
        torch.autograd.grad(h.sum() + sum(o.sum() for o in outs[1:]), w)
    assert calls == [0, 1, 2, 9]
    assert len(outs) == 10
    fwd = 2 * 3 * 8 * 8
    assert counter.credited == {"loop:mm": 7 * 3 * fwd}
    # traced: trips 0 (fwd + grad of w), 1 and 9 (fwd + both grads)
    assert counter.traced == 2 * fwd + 2 * 3 * fwd


def _records(tmp_path):
    recs = [{"arch": "minicpm-2b", "shape": "decode_32k", "mesh": "16x16",
             "ok": True, "layout": "tp", "lower_s": 0.5,
             "argument_size_in_bytes": 97.5e9, "output_size_in_bytes": 97e9,
             "alias_size_in_bytes": 96.9e9, "flops": 8.77e9,
             "flops_global": 2.244e12, "fits_h100": False},
            {"arch": "xlstm-1.3b", "shape": "train_4k", "mesh": "16x16",
             "ok": False, "layout": "tp", "error": "E: x"},
            {"arch": "minicpm-2b", "shape": "decode_32k", "mesh": "2x16x16",
             "ok": True, "layout": "tp", "lower_s": 0.5,
             "argument_size_in_bytes": 1, "output_size_in_bytes": 1,
             "alias_size_in_bytes": 1, "flops": 1.0, "flops_global": 512.0,
             "fits_h100": True}]
    (tmp_path / "dry.json").write_text(json.dumps(recs))


def test_report_prints_both_tables(tmp_path, capsys):
    _records(tmp_path)
    out_json = tmp_path / "terms.json"
    assert report.main(["--results", str(tmp_path), "--dryrun", "dry.json",
                        "--json", str(out_json)]) == 0
    text = capsys.readouterr().out
    assert "| minicpm-2b | decode_32k |" in text
    assert "| xlstm-1.3b | train_4k | FAILED |" in text
    assert "| n/a |" in text
    assert "| minicpm-2b | decode_32k | 97.50 | 97.00 | 96.90 | False | " \
           "0.5 |" in text
    terms = json.loads(out_json.read_text())
    assert len(terms) == 1 and terms[0]["mesh"] == "16x16"
    assert terms[0]["hlo_flops_global"] == 8.77e9 * 256


def test_report_prints_the_collective_column(tmp_path, capsys):
    rec = {"arch": "minicpm-2b", "shape": "train_4k", "mesh": "16x16",
           "ok": True, "layout": "tp", "lower_s": 1.0,
           "argument_size_in_bytes": 2e9, "output_size_in_bytes": 2e9,
           "alias_size_in_bytes": 2e9, "flops": 1e12, "flops_global": 1e14,
           "fits_h100": True, "peak_live_bytes_above_arguments": 5e9,
           "collective_by_kind": {"all-gather": 25e9, "all-reduce": 25e9}}
    (tmp_path / "dry.json").write_text(json.dumps([rec]))
    out_json = tmp_path / "terms.json"
    assert report.main(["--results", str(tmp_path), "--dryrun", "dry.json",
                        "--json", str(out_json)]) == 0
    text = capsys.readouterr().out
    # 50 GB on the wire at 50 GB/s: one second, the dominant term
    assert "| minicpm-2b | train_4k |" in text and "|    1.00s  |" in text
    assert "| collective |" in text.split("\n")[2]
    terms = json.loads(out_json.read_text())
    assert terms[0]["t_collective"] == 1.0
    assert terms[0]["dominant"] == "collective"
