"""Sequence parallelism's gate and its per-rank program, with no world.

``REPRO_SEQ_PARALLEL=1`` cuts the decoder's residual stream over the
model ranks (``repro_torch.models.model._seq_shard_ok``).  Here, on the
dry run's recording mesh and the meta device:

* the gate equals the JAX package's on the same flag, model width and
  sequence length (its mesh from the forced CPU devices): off where the
  flag is unset or not "1", at tp 1, where S does not divide tp or
  S < tp; a flag set after import is read;
* it is set where the JAX package sets it and nowhere else: in
  ``forward_train``, ``prefill`` and ``prefill_batched`` on the decoder,
  never on the encoder, a chunk resume or a decode step;
* the per-rank train step of reduced starcoder2-3b (f32) at (data 2,
  model 2): each all-reduce of the residual becomes one reduce-scatter
  and one all-gather of equal wire bytes, remat adds one all-gather a
  checkpointed repeat (the recompute gathers the FFN's input again,
  where ``copy_in`` moved nothing), the norms' weights sum their
  gradients (one small all-reduce each), and the peak of live bytes
  falls.

The gloo worlds hold the flag's numbers against the flag off and the
JAX package (``test_torch_train_mesh.py``, ``test_torch_meshserve.py``,
``test_torch_meshserve_families.py``).
"""
import contextlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import sharding as rsharding
from repro.models import model as r_model
from repro_torch import sharding
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import rank_program
from repro_torch.meshserve.pool import local_state
from repro_torch.meshserve.topology import MeshSlice
from repro_torch.models import (decode_step, forward_train, init_params,
                                prefill, prefill_batched, prefill_chunk)
from repro_torch.models import model as t_model
from repro_torch.models.blocks import layer_specs, plan_segments
from repro_torch.roofline.analysis import _wire_bytes
from repro_torch.training import AdamWConfig, fsdp

META = torch.device("meta")
FLAG = "REPRO_SEQ_PARALLEL"


def _set_flag(monkeypatch, flag):
    if flag is None:
        monkeypatch.delenv(FLAG, raising=False)
    else:
        monkeypatch.setenv(FLAG, flag)


@pytest.mark.parametrize("flag,model,S", [
    (None, 2, 8), ("0", 2, 8), ("true", 2, 8), ("1", 2, 8), ("1", 1, 8),
    ("1", 2, 7), ("1", 4, 2), ("1", 4, 4), ("1", 4, 6)])
def test_gate_equals_reference(mesh8, monkeypatch, flag, model, S):
    _set_flag(monkeypatch, flag)
    ctx = (sharding.record_mesh(model=model, data=1) if model > 1
           else contextlib.nullcontext())
    with ctx:
        got = t_model._seq_shard_ok(S)
    mesh = Mesh(np.array(jax.devices()[:model]).reshape(1, model),
                ("data", "model"))
    with rsharding.use_mesh(mesh if model > 1 else None):
        want = r_model._seq_shard_ok(S)
    assert got is want
    assert got is (flag == "1" and model > 1 and S % model == 0
                   and S >= model)


def test_flag_set_after_import_is_read(monkeypatch):
    with sharding.record_mesh(model=2, data=1):
        monkeypatch.delenv(FLAG, raising=False)
        assert not t_model._seq_shard_ok(8)
        monkeypatch.setenv(FLAG, "1")
        assert t_model._seq_shard_ok(8)
        monkeypatch.setenv(FLAG, "0")
        assert not t_model._seq_shard_ok(8)


def _rank_tree(cfg, B, seq_len):
    """Model rank 0's params and serving state of a tp 2 slice, on meta."""
    whole = init_params(cfg, torch.Generator().manual_seed(0), device=META)
    serve = fsdp.recording_mesh(1, 2)
    params = fsdp.shard(whole, fsdp.plan(cfg, whole, serve), serve)
    sl = MeshSlice(index=0, ranks=(0, 1), device=META)
    return params, local_state(cfg, sl, B, seq_len)


@pytest.fixture
def stacks(monkeypatch):
    """Each ``apply_stack`` call's (seq_shard, rows of its input)."""
    seen = []
    plain = t_model.apply_stack

    def spy(cfg, segs, seg_params, x, states, ctx, **kw):
        seen.append((ctx.get("seq_shard", False), x.shape[1]))
        return plain(cfg, segs, seg_params, x, states, ctx, **kw)

    monkeypatch.setattr(t_model, "apply_stack", spy)
    return seen


def _meta_tokens(B, S):
    return torch.zeros((B, S), dtype=torch.int32, device=META)


@pytest.mark.parametrize("flag", ["1", None])
def test_cut_only_where_the_reference_cuts(monkeypatch, stacks, flag):
    """starcoder2-3b's entry points, and seamless-m4t's encoder beside
    its decoder, at tp 2 on the recording mesh: the decoder's S rows cut
    in half in the training forward and both prefills, never in a chunk
    resume or a decode step, never in the encoder."""
    _set_flag(monkeypatch, flag)
    on = flag == "1"
    cfg = get_config("starcoder2-3b").reduced()
    params, state = _rank_tree(cfg, 2, 32)
    B, S = 2, 8
    toks = _meta_tokens(B, S)
    with torch.no_grad(), sharding.record_mesh(model=2, data=1,
                                               batch=False):
        prefill(cfg, params, {"tokens": toks}, state)
        prefill_batched(cfg, params, toks, state,
                        torch.full((B,), S, device=META))
        prefill_chunk(cfg, params, toks, state, history=8)
        decode_step(cfg, params, toks[:, :1], state,
                    torch.full((B,), 16, dtype=torch.int32, device=META))
    with sharding.record_mesh(model=2, data=1, batch=False):
        forward_train(cfg, params, {"tokens": toks})
    cut = (on, S // 2 if on else S)
    assert stacks == [cut, cut, (False, S), (False, 1), cut]

    stacks.clear()
    cfg = get_config("seamless-m4t-large-v2").reduced()
    params, state = _rank_tree(cfg, B, 32)
    frames = torch.zeros((B, cfg.encoder.max_source_positions,
                          cfg.frontend.embed_dim), device=META)
    with torch.no_grad(), sharding.record_mesh(model=2, data=1,
                                               batch=False):
        prefill(cfg, params, {"tokens": toks, "frames": frames}, state)
    assert stacks == [(False, cfg.encoder.max_source_positions), cut]


def test_dry_run_replaces_boundary_all_reduces(monkeypatch):
    """Reduced starcoder2-3b (f32, 2 layers of one checkpointed repeat
    each) at (data 2, model 2), B 4, S 256: the recorded collectives and
    the peak of live bytes with the flag unset and set."""
    cfg = get_config("starcoder2-3b").reduced()
    B, S = 4, 256
    batch = {"tokens": torch.zeros((B, S), dtype=torch.int32),
             "labels": torch.zeros((B, S), dtype=torch.int32)}
    runs = {}
    for flag in (None, "1"):
        _set_flag(monkeypatch, flag)
        runs[flag] = rank_program(cfg, batch, data=2, model=2,
                                  opt_cfg=AdamWConfig())
    off, on = runs[None]["collectives"], runs["1"]["collectives"]
    resid = (B // 2) * S * cfg.d_model * 4
    ar, rs, ag = (("all-reduce", resid, 2), ("reduce-scatter", resid // 2, 2),
                  ("all-gather", resid, 2))
    n = off[ar]
    reps = sum(seg.repeats for seg in plan_segments(layer_specs(cfg)))
    assert n > 0 and ar not in on
    assert on[rs] - off.get(rs, 0) == n
    assert on[ag] - off.get(ag, 0) == n + reps
    assert (n * _wire_bytes(*rs) + n * _wire_bytes(*ag)
            == n * _wire_bytes(*ar))
    # what else changed: the norms' weight gradients, (d,) f32 each
    norms = ("all-reduce", cfg.d_model * 4, 2)
    changed = {k for k in set(off) | set(on)
               if off.get(k, 0) != on.get(k, 0)}
    assert changed == {ar, rs, ag, norms}
    assert on[norms] - off.get(norms, 0) == 2 * len(cfg.block_pattern) + 1
    assert runs["1"]["argument_bytes"] == runs[None]["argument_bytes"]
    assert runs["1"]["peak_live_bytes"] < runs[None]["peak_live_bytes"]
