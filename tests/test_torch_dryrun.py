"""The dry run on the meta device: its FLOPs and its per-chip footprint.

*FLOP exactness.*  At reduced widths the FLOPs a step counts on meta
tensors (``FlopCounterMode``, the kernels' credits and the loops' trip
counts) must equal ``FlopCounterMode``'s count of the same step run in
full on CPU tensors, for the steps that reach no kernel: MLA prefill and
decode, xLSTM prefill (chunkwise and stepwise) and decode, the train step
(forward with remat, backward, AdamW) of the dense, MLA, hybrid and xLSTM
families, and the chunked attention's block loops (a 2,560-token MLA
prefill, and the attention alone with its gradient at small chunks).

*Full width.*  One serving shape per family on the single mesh, on meta:
the record is ``ok``, and its argument, output and alias bytes equal the
per-chip bytes the JAX package's own specs imply for its own trees
(``jax.eval_shape``), so ``fits_h100`` is what the specs imply.  Then the
CLI with its trace file, and the two launchers that stand for the JAX
package's examples.

*The per-rank program.*  One rank's FLOPs times the chips are at least
the global step's, and equal where every leaf cuts (reduced minicpm-2b
at data 2 x model 2) and above where a rank repeats compute (the
sLSTM recurrence); every reduced config's train step on the 16 x 16
recording mesh issues collectives, which ``roofline.analysis.analyze``
prices as its collective term; the recording mesh raises on a tensor
off meta, and a collective inside a counted loop is recorded once per
trip, replay or not.  (``tests/test_torch_train_mesh.py`` holds the
recorded collectives against a real gloo world's.)  Where the heads do
not divide the model width (starcoder2-3b's 24 at 16) a rank keeps its
attention whole and every other leaf cut where its dim divides: its
argument bytes are the sum of those cuts, below the whole model's, and
its FLOPs repeat the attention's only.
"""
import json
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.configs as rcfg
import repro.models as rm
from repro.launch import specs as rspecs
import repro_torch.configs as tcfg
from repro_torch.kernels import read_counts, reset_counts
from repro_torch.launch import dryrun, quickstart, serve_cluster
from repro_torch.models import (decode_step, init_params, init_state,
                                prefill)
from repro_torch.models.attention import flash_attention
from repro_torch.core.opcount import Counter
from repro_torch.training import AdamWConfig, init_opt_state, train_step


def _meta_like(tree):
    if isinstance(tree, dict):
        return {k: _meta_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_meta_like(v) for v in tree]
    return torch.empty_like(tree, device="meta")


def _count(cfg, params, kind, S, dev, B=2):
    """FLOPs of one step of ``kind`` at (B, S) on ``dev``."""
    if dev == "meta":
        params = _meta_like(params)
    toks = torch.zeros((B, S), dtype=torch.int32, device=dev)
    if kind == "train":
        opt_cfg = AdamWConfig()
        batch = {"tokens": toks, "labels": toks.clone()}
        with Counter() as c:
            train_step(cfg, opt_cfg, params, init_opt_state(opt_cfg, params),
                       batch, torch.ones((), device=dev))
        return c
    state = init_state(cfg, B, S + 8, device=dev)
    with torch.no_grad(), Counter() as c:
        if kind == "prefill":
            prefill(cfg, params, {"tokens": toks}, state)
        else:
            decode_step(cfg, params, toks[:, :1], state,
                        torch.full((B,), 5, dtype=torch.int32, device=dev))
    return c


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU steps run faster on one intra-op thread than on threads
    that other test processes contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reduced():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = tcfg.get_config(arch).reduced()
            cache[arch] = (cfg, init_params(
                cfg, torch.Generator().manual_seed(0), device="cpu"))
        return cache[arch]

    return get


@pytest.mark.parametrize("arch,kind,S,loops", [
    ("deepseek-v3-671b", "prefill", 256, ()),
    ("deepseek-v3-671b", "decode", 256, ()),
    ("xlstm-1.3b", "prefill", 256, ("mlstm_chunks", "slstm_steps")),
    ("xlstm-1.3b", "prefill", 100, ("mlstm_steps", "slstm_steps")),
    ("xlstm-1.3b", "decode", 256, ()),
    ("minicpm-2b", "train", 256, ()),
    ("deepseek-v3-671b", "train", 256, ()),
    ("jamba-1.5-large-398b", "train", 256, ("ssm_steps",)),
    ("xlstm-1.3b", "train", 256, ("mlstm_chunks", "slstm_steps")),
    ("deepseek-v3-671b", "prefill", 2560, ("kv_blocks",)),
])
def test_meta_flops_equal_a_full_cpu_run(reduced, arch, kind, S, loops):
    cfg, params = reduced(arch)
    reset_counts()
    full = _count(cfg, params, kind, S, "cpu")
    meta = _count(cfg, params, kind, S, "meta")
    for name, c in read_counts().items():     # these steps reach no kernel
        assert c == {"launches": 0, "plain_calls": 0}, name
    assert full.credited == {}
    assert meta.total() == full.total() > 0
    credited = {name.rsplit(".", 1)[-1] for name in meta.credited}
    assert credited == set(loops)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 100),
                                           (False, None)])
def test_chunked_attention_loops_count_exactly(causal, window):
    """The model-level chunked attention with its gradient, at chunks
    small enough that both block loops reach their steady trips."""
    gen = torch.Generator().manual_seed(0)
    qkv = [torch.randn((1, 512, h, 16), generator=gen) for h in (4, 2, 2)]

    def run(dev):
        q, k, v = (t.to(dev).requires_grad_(True) for t in qkv)
        with Counter() as c:
            out = flash_attention(q, k, v, causal=causal, scale=0.25,
                                  window=window, q_chunk=16, kv_chunk=32)
            torch.autograd.grad(out.sum(), [q, k, v])
        return c

    full, meta = run("cpu"), run("meta")
    assert meta.total() == full.total() > 0
    assert set(meta.credited) == {"loop:attention.kv_blocks",
                                  "loop:attention.q_blocks"}


_MESH = {"data": 16, "model": 16}


def _ref_chip_bytes(tree, specs):
    """Per-chip bytes of a JAX shape tree under its PartitionSpecs."""
    leaves = jax.tree_util.tree_leaves(tree)
    specs = jax.tree_util.tree_leaves(specs,
                                      is_leaf=lambda x: isinstance(x, P))
    total = 0
    for leaf, spec in zip(leaves, specs):
        div = 1
        for ax in spec:
            for name in (ax if isinstance(ax, tuple) else (ax,)):
                if name is not None:
                    div *= _MESH[name]
        total += math.prod(leaf.shape) * leaf.dtype.itemsize // div
    return total


@pytest.mark.parametrize("arch,shape", [
    ("minicpm-2b", "long_500k"), ("deepseek-v3-671b", "long_500k"),
    ("jamba-1.5-large-398b", "long_500k"), ("xlstm-1.3b", "decode_32k"),
    ("internvl2-1b", "prefill_32k"), ("seamless-m4t-large-v2",
                                      "prefill_32k")])
def test_full_width_dry_run_per_family(arch, shape):
    rec = dryrun.run_one(arch, shape, False, save_trace=False)
    print(f"{arch} {shape}: lower_s {rec.get('lower_s')}")
    assert rec["ok"], rec.get("traceback")
    assert rec["mesh"] == "16x16" and rec["layout"] == "tp"
    # one rank's program: compute a rank repeats counts
    assert rec["flops"] * 256 >= rec["flops_global"] > 0
    assert rec["peak_live_bytes_above_arguments"] > 0
    # the bytes the JAX package's specs imply for its own trees
    cfg = rcfg.get_config(arch)
    shp, long_ctx = rcfg.INPUT_SHAPES[shape], shape == "long_500k"
    params = jax.eval_shape(lambda k: rm.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    state = jax.eval_shape(lambda: rm.init_state(
        cfg, shp.global_batch, shp.seq_len, long_ctx))
    sds, in_specs = rspecs.input_specs(cfg, shp)
    s_bytes = _ref_chip_bytes(state, rspecs.state_pspecs(
        cfg, state, shp, long_context=long_ctx))
    tok_bytes = _ref_chip_bytes(
        jax.ShapeDtypeStruct((shp.global_batch,), np.int32),
        P(in_specs["tokens"][0]))
    arg = (_ref_chip_bytes(params, rspecs.param_pspecs(cfg, params,
                                                      mode="serve"))
           + _ref_chip_bytes(sds, in_specs) + s_bytes)
    assert rec["argument_size_in_bytes"] == arg
    assert rec["output_size_in_bytes"] == tok_bytes + s_bytes
    assert rec["alias_size_in_bytes"] == s_bytes
    assert rec["fits_h100"] == (arg + tok_bytes <= 80e9)


def test_cli_writes_records_and_trace(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "starcoder2-3b", "--shape", "decode_32k",
                        "--mesh", "both", "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    assert recs[0]["flops_global"] == recs[1]["flops_global"]
    assert recs[1]["flops"] * 2 == recs[0]["flops"]
    # the multi-pod mesh halves the batch-sharded bytes, never adds any
    assert recs[1]["argument_size_in_bytes"] <= \
        recs[0]["argument_size_in_bytes"]
    trace = json.loads((tmp_path / "trace_starcoder2-3b_decode_32k_16x16"
                        ".json").read_text())
    assert set(trace["credited"]) == {"kernel:decode_attention"}
    assert trace["flops_global"] == sum(trace["traced_by_op"].values()) \
        + sum(trace["credited"].values())
    assert "2/2 combinations traced" in capsys.readouterr().out


def test_dry_run_records_a_failure(monkeypatch):
    def refuse(*args, **kwargs):
        raise RuntimeError("no state")

    monkeypatch.setattr(dryrun, "init_state", refuse)
    rec = dryrun.run_one("starcoder2-3b", "decode_32k", False,
                         save_trace=False)
    assert rec["ok"] is False
    assert rec["error"] == "RuntimeError: no state"
    assert "Traceback" in rec["traceback"]


def test_quickstart_on_the_cpu(capsys):
    assert quickstart.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.rstrip().endswith("OK")


def test_serve_cluster_on_the_cpu(capsys):
    assert serve_cluster.main(["--arch", "starcoder2-3b", "--instances", "2",
                               "--duration", "10", "--prefix-reuse", "0.6",
                               "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "live prefix cache:" in out and "sim: same spec" in out


# ---------------------------------------------------------------------------
# the per-rank program
# ---------------------------------------------------------------------------


def _train_batch(cfg, B, S):
    toks = torch.zeros((B, S), dtype=torch.int32, device="meta")
    batch = {"tokens": toks, "labels": toks}
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        batch["patch_embeds"] = torch.empty(
            (B, cfg.frontend.num_prefix_tokens, cfg.frontend.embed_dim),
            device="meta")
    elif cfg.is_encoder_decoder:
        batch["frames"] = torch.empty(
            (B, cfg.encoder.max_source_positions, cfg.frontend.embed_dim),
            device="meta")
    return batch


def _global_flops(cfg, batch):
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="meta")
    opt_cfg = AdamWConfig()
    with Counter() as c:
        train_step(cfg, opt_cfg, params, init_opt_state(opt_cfg, params),
                   batch, torch.ones((), device="meta"))
    return c.total()


@pytest.mark.parametrize("arch,equal", [("minicpm-2b", True),
                                        ("xlstm-1.3b", False)])
def test_rank_flops_times_chips_cover_the_global_step(arch, equal):
    cfg = tcfg.get_config(arch).reduced()
    batch = _train_batch(cfg, 4, 32)
    rank = dryrun.rank_program(cfg, batch, data=2, model=2,
                               opt_cfg=AdamWConfig())
    flops, glob = rank["counter"].total(), _global_flops(cfg, batch)
    assert (flops * 4 == glob) if equal else (flops * 4 > glob)
    assert rank["peak_live_bytes"] > 0
    assert rank["argument_bytes"] > 0


@pytest.mark.parametrize("arch", tcfg.list_archs(include_extra=True))
def test_every_train_step_records_collectives(arch):
    """Every config's train step on the 16 x 16 recording mesh (reduced
    widths) records FSDP's and TP's collectives, and ``analyze`` prices
    them: ``t_collective > 0`` for every train shape."""
    from repro_torch.roofline import analysis
    cfg = tcfg.get_config(arch).reduced()
    rank = dryrun.rank_program(cfg, _train_batch(cfg, 16, 16), data=16,
                               model=16, opt_cfg=AdamWConfig())
    by_kind = dryrun.collective_by_kind(rank["collectives"])
    assert by_kind and all(v > 0 for v in by_kind.values())
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(by_kind)
    for name, shape in tcfg.INPUT_SHAPES.items():
        if shape.kind != "train":
            continue
        rec = {"arch": arch, "shape": name, "mesh": "16x16", "layout": "tp",
               "flops": rank["counter"].total(), "collective_by_kind": by_kind}
        r = analysis.analyze(rec, cfg, shape)
        assert r.t_collective == sum(by_kind.values()) / analysis.LINK_BW > 0
        assert r.collective_by_kind == by_kind


def test_recording_mesh_raises_off_meta():
    from repro_torch import sharding
    with sharding.record_mesh(model=2, data=2):
        with pytest.raises(RuntimeError, match="meta tensors only"):
            sharding.reduce(torch.ones(3))
        out = sharding.gather_data(torch.empty((3, 4), device="meta"), 1)
        assert out.shape == (3, 8) and out.is_meta


def test_collectives_in_a_loop_count_per_trip():
    """A reduce inside a counted loop of 9 trips, forward and backward:
    9 forward all-reduces and 8 backward (copy_in's: the first trip's
    input needs no gradient), none doubled by the replay thread."""
    from repro_torch import sharding
    from repro_torch.core import opcount
    w = torch.empty((8, 8), device="meta", requires_grad=True)

    def body(i, carry, w):
        return sharding.reduce(sharding.copy_in(carry) @ w), None

    with sharding.record_mesh(model=4, data=1) as ctx, Counter() as c:
        x, _ = opcount.steps("mm", 9, body,
                             torch.empty((2, 8), device="meta"), w)
        x.sum().backward()
    assert c.collectives == {("all-reduce", 2 * 8 * 4, 4): 17.0}
    assert ctx.recorder == {}


#: starcoder2-3b decode_32k on the 16 x 16 mesh: rank 0's argument bytes
#: while a config whose 24 heads do not divide 16 ran whole on every
#: model rank (the whole params, its batch rows and state)
WHOLE_MODEL_RANK_BYTES = 7_367_669_824


def test_rank_past_whole_heads_cuts_all_but_the_attention():
    from repro_torch.meshserve.pool import local_state, param_rule
    from repro_torch.meshserve.topology import MeshSlice
    from repro_torch.launch.specs import map_with_path
    from repro_torch.training import fsdp
    arch, shape_name = "starcoder2-3b", "decode_32k"
    cfg, shape = tcfg.get_config(arch), tcfg.INPUT_SHAPES[shape_name]
    assert cfg.num_heads % 16 and cfg.d_ff % 16 == cfg.vocab_size % 16 == 0
    rec = dryrun.run_one(arch, shape_name, False, save_trace=False)
    assert rec["ok"], rec.get("traceback")
    # the sum of the new cuts: a leaf whose rule is head-bound stays
    # whole, every other leaf with a rule is cut in 16
    whole = init_params(cfg, torch.Generator().manual_seed(0), device="meta")
    parts = {"whole": 0, "cut": 0}

    def add(path, t):
        rule = param_rule(cfg, path)
        cut = (rule is not None and rule[1] not in ("q", "kv", "h")
               and t.shape[rule[0]] % 16 == 0)
        parts["cut" if cut else "whole"] += (
            t.numel() * t.element_size() // (16 if cut else 1))

    map_with_path(add, whole)
    params_bytes = parts["whole"] + parts["cut"]
    B = shape.global_batch // 16
    batch = dryrun.build_meta(arch, shape_name, False)["batch"]
    local = fsdp.local_batch(batch, fsdp.recording_mesh(16, 16))
    sl = MeshSlice(index=0, ranks=tuple(range(16)), device=torch.device(
        "meta"))
    state = local_state(cfg, sl, B, shape.seq_len)
    rest = fsdp.leaf_bytes(local) + fsdp.leaf_bytes(state)
    assert rec["rank_argument_size_in_bytes"] == params_bytes + rest
    assert fsdp.leaf_bytes(whole) + rest == WHOLE_MODEL_RANK_BYTES
    assert rec["rank_argument_size_in_bytes"] < WHOLE_MODEL_RANK_BYTES
    # the attention is repeated on every model rank, the rest is not
    assert rec["flops_global"] <= rec["flops"] * 256 \
        < 16.0 * rec["flops_global"]
    assert {"all-reduce", "all-gather"} <= set(rec["collective_by_kind"])
