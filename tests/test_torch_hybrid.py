"""The port's hybrid Mamba+MoE serving path held against the JAX package's
on the CPU.

Reduced jamba-1.5-large-398b in f32: two layers (mamba + MoE, attention +
MoE), d_model 256, 4 experts top-2.  The JAX package's random weights go
through numpy into the port (``params_from_numpy``), the same inputs
(numpy, seeded) go through both.  Tolerance 1e-4 max abs in f32 on
activations, logits and states: the packages sum in different orders and
the scan carries the rounding over every step.  Tokens, capacity drops,
``host_syncs`` and ledger bytes must be equal exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
import repro.models as rm
import repro.serving.engine as r_engine_mod
from repro.core import kvbytes as r_kvbytes
from repro.kvstore import LineCosts as RLineCosts
from repro.models import mamba as r_mamba
from repro.models import moe as r_moe
from repro.models.state import state_bytes as r_state_bytes
from repro.serving import InstanceEngine as REngine
from repro.serving import Request as RRequest
import repro_torch.configs as tcfg
import repro_torch.models as tm
import repro_torch.serving.engine as t_engine_mod
from repro_torch.bridge import params_from_numpy, state_from_numpy
from repro_torch.core import kvbytes as t_kvbytes
from repro_torch.kernels import read_counts, reset_counts
from repro_torch.kvstore import LineCosts as TLineCosts
from repro_torch.models import mamba as t_mamba
from repro_torch.models import moe as t_moe
from repro_torch.models.blocks import LayerSpec, check_supported
from repro_torch.models.state import state_bytes as t_state_bytes
from repro_torch.serving import InstanceEngine, Request

ARCH = "jamba-1.5-large-398b"
TOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _paths(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{path}/{i}")
    else:
        yield path, tree


def _leaves(tree):
    return [x for _, x in _paths(tree)]


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def _at0(tree):
    """Repeat 0 of every stacked leaf: numpy for JAX, views for torch."""
    if isinstance(tree, dict):
        return {k: _at0(v) for k, v in tree.items()}
    return tree[0]


@pytest.fixture(scope="module")
def setup():
    cfg_r = rcfg.get_config(ARCH).reduced()
    cfg_t = tcfg.get_config(ARCH).reduced()
    params_r = rm.init_params(jax.random.PRNGKey(0), cfg_r)
    params_t = params_from_numpy(_np_tree(params_r), device="cpu")
    return cfg_r, cfg_t, params_r, params_t


def _rng(seed):
    return np.random.default_rng(seed)


def _x(seed, shape):
    return _rng(seed).standard_normal(shape).astype(np.float32)


def _cut(cfg, n):
    return dataclasses.replace(cfg, num_layers=n,
                               block_pattern=cfg.block_pattern[:n])


# ---------------------------------------------------------------------------
# configuration and layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_config_equal_field_by_field(reduced):
    a, b = rcfg.get_config(ARCH), tcfg.get_config(ARCH)
    if reduced:
        a, b = a.reduced(), b.reduced()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(a.mamba) == dataclasses.asdict(b.mamba)
    assert dataclasses.asdict(a.moe) == dataclasses.asdict(b.moe)
    assert a.param_count() == b.param_count()
    assert (dataclasses.asdict(RLineCosts.from_config(a))
            == dataclasses.asdict(TLineCosts.from_config(b)))
    assert (r_kvbytes.state_bytes_at(a, 517)
            == t_kvbytes.state_bytes_at(b, 517))


def test_depth_cut_keeps_published_widths():
    """The card's cut: the first 5 layers of the pattern (4 mamba, MoE on
    1 and 3, attention at 4) at full width, about 48 GB in bf16; the
    3-layer f32 consistency cut about 53 GB."""
    full = tcfg.get_config(ARCH)
    five, three = _cut(full, 5), _cut(full, 3)
    assert five.block_pattern == ("mamba",) * 4 + ("attn",)
    assert [five.layer_is_moe(i) for i in range(5)] == [False, True, False,
                                                        True, False]
    assert (five.d_model, five.num_heads, five.num_kv_heads, five.head_dim,
            five.d_ff, five.vocab_size) == (8192, 64, 8, 128, 24576, 65536)
    assert 47e9 < 2 * five.param_count() < 49e9
    assert 52e9 < 4 * three.param_count() < 54e9
    assert five.param_count() == _cut(rcfg.get_config(ARCH), 5).param_count()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_layout_and_dtypes(dtype):
    """The port's own draw has the JAX package's tree, shapes and per-leaf
    dtypes (f32 for A_log, D, dt_b and the router), at its scales."""
    cfg_r = dataclasses.replace(rcfg.get_config(ARCH).reduced(), dtype=dtype)
    cfg_t = dataclasses.replace(tcfg.get_config(ARCH).reduced(), dtype=dtype)
    ref = list(_paths(_np_tree(rm.init_params(jax.random.PRNGKey(1),
                                              cfg_r))))
    own = list(_paths(tm.init_params(cfg_t, torch.Generator().manual_seed(1),
                                     device="cpu")))
    assert [p for p, _ in own] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(ref, own):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(b.dtype).split(".")[-1] == a.dtype.name, path
    leaf = dict(own)
    mixer = "/segments/0/p0/mixer"
    ffn = "/segments/0/p0/ffn"
    N = cfg_t.mamba.d_state
    assert torch.equal(leaf[f"{mixer}/A_log"][0, 0],
                       torch.log(torch.arange(1, N + 1).float()))
    assert float(leaf[f"{mixer}/dt_b"].float().mean()) == pytest.approx(-4.6)
    assert float(leaf[f"{mixer}/D"].float().min()) == 1.0
    d, f = cfg_t.d_model, cfg_t.moe.expert_d_ff
    assert abs(float(leaf[f"{ffn}/router"].std()) - d ** -0.5) < 5e-3
    assert abs(float(leaf[f"{ffn}/w_down"].float().std()) - f ** -0.5) < 5e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_layout_and_bytes(dtype):
    cfg_r = dataclasses.replace(rcfg.get_config(ARCH).reduced(), dtype=dtype)
    cfg_t = dataclasses.replace(tcfg.get_config(ARCH).reduced(), dtype=dtype)
    st_r = list(_paths(_np_tree(rm.init_state(cfg_r, 3, 32))))
    st_t = list(_paths(tm.init_state(cfg_t, 3, 32, device="cpu")))
    assert [p for p, _ in st_r] == [p for p, _ in st_t]
    for (path, a), (_, b) in zip(st_r, st_t):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(b.dtype).split(".")[-1] == a.dtype.name, path
    assert (r_state_bytes(rm.init_state(cfg_r, 3, 32))
            == t_state_bytes(tm.init_state(cfg_t, 3, 32, device="cpu")))


def test_bridge_keeps_f32_leaves_under_a_cast(setup):
    _, _, params_r, _ = setup
    out = params_from_numpy(_np_tree(params_r), device="cpu",
                            dtype=torch.bfloat16)
    mixer = out["segments"][0]["p0"]["mixer"]
    assert mixer["in_proj"].dtype == torch.bfloat16
    for key in ("A_log", "D", "dt_b"):
        assert mixer[key].dtype == torch.float32, key
    assert out["segments"][0]["p0"]["ffn"]["router"].dtype == torch.float32
    st = state_from_numpy(_np_tree(rm.init_state(
        rcfg.get_config(ARCH).reduced(), 2, 8)), device="cpu",
        dtype=torch.bfloat16)
    assert st["layers"][0]["p0"]["ssm"].dtype == torch.float32
    assert st["layers"][0]["p0"]["conv"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def test_mamba_forward_full_and_decode(setup):
    """Full mode from a nonzero state (the resume case), then three decode
    steps; outputs and the conv / ssm states after each."""
    cfg_r, cfg_t, params_r, params_t = setup
    p_r = _at0(params_r["segments"][0]["p0"]["mixer"])
    p_t = _at0(params_t["segments"][0]["p0"]["mixer"])
    B, S = 2, 13
    st_np = _np_tree(_at0(rm.init_state(cfg_r, B, 16)["layers"][0]["p0"]))
    st_np["ssm"] = _x(5, st_np["ssm"].shape) * 0.1
    st_r = {k: jnp.asarray(v) for k, v in st_np.items()}
    st_t = {k: torch.from_numpy(v.copy()) for k, v in st_np.items()}
    x = _x(6, (B, S, cfg_t.d_model))
    y_r, st_r = r_mamba.mamba_forward(cfg_r, p_r, jnp.asarray(x), mode="full",
                                      state=st_r, update_cache=True)
    y_t, st_t = t_mamba.mamba_forward(cfg_t, p_t, torch.from_numpy(x),
                                      mode="full", state=st_t,
                                      update_cache=True)
    assert _err(y_t, y_r) < TOL
    for k in ("conv", "ssm"):
        assert _err(st_t[k], st_r[k]) < TOL, k
    for step in range(3):
        xs = _x(10 + step, (B, 1, cfg_t.d_model))
        y_r, st_r = r_mamba.mamba_forward(cfg_r, p_r, jnp.asarray(xs),
                                          mode="decode", state=st_r)
        y_t, st_t = t_mamba.mamba_forward(cfg_t, p_t, torch.from_numpy(xs),
                                          mode="decode", state=st_t)
        assert _err(y_t, y_r) < TOL
        for k in ("conv", "ssm"):
            assert _err(st_t[k], st_r[k]) < TOL, k


def test_mamba_short_prompt_pads_conv_tail(setup):
    """A prompt shorter than d_conv leaves a left-padded conv window."""
    cfg_r, cfg_t, params_r, params_t = setup
    p_r = _at0(params_r["segments"][0]["p0"]["mixer"])
    p_t = _at0(params_t["segments"][0]["p0"]["mixer"])
    st = _np_tree(_at0(rm.init_state(cfg_r, 1, 8)["layers"][0]["p0"]))
    x = _x(7, (1, 2, cfg_t.d_model))
    _, st_r = r_mamba.mamba_forward(
        cfg_r, p_r, jnp.asarray(x), mode="full",
        state={k: jnp.asarray(v) for k, v in st.items()}, update_cache=True)
    _, st_t = t_mamba.mamba_forward(
        cfg_t, p_t, torch.from_numpy(x), mode="full",
        state={k: torch.from_numpy(v.copy()) for k, v in st.items()},
        update_cache=True)
    assert _err(st_t["conv"], st_r["conv"]) < TOL
    assert float(st_t["conv"][:, :2].abs().max()) == 0.0


def test_ranks_of_matches():
    e = _rng(8).integers(0, 5, (64,))
    r = r_moe._ranks_of(jnp.asarray(e), 5)
    t = t_moe._ranks_of(torch.from_numpy(e), 5)
    assert np.array_equal(t.numpy(), np.asarray(r))


@pytest.mark.parametrize("cf", [1.25, 1.0])
def test_moe_forward(setup, cf):
    """Routing, capacity drops, combine and the aux loss at Jamba's
    capacity factor and at 1.0.  At cf = 1.0 half the tokens are one
    repeated vector, so their experts overflow and drop (as the JAX
    package's ``test_moe`` forces it)."""
    cfg_r, cfg_t, params_r, params_t = setup
    cfg_r = dataclasses.replace(cfg_r, moe=dataclasses.replace(
        cfg_r.moe, capacity_factor=cf))
    cfg_t = dataclasses.replace(cfg_t, moe=dataclasses.replace(
        cfg_t.moe, capacity_factor=cf))
    p_r = _at0(params_r["segments"][0]["p0"]["ffn"])
    p_t = _at0(params_t["segments"][0]["p0"]["ffn"])
    x = _x(9, (2, 16, cfg_t.d_model))
    if cf == 1.0:
        x[:, :8] = x[0, 0]
    y_r, aux_r = r_moe.moe_forward(cfg_r, p_r, jnp.asarray(x))
    y_t, aux_t = t_moe.moe_forward(cfg_t, p_t, torch.from_numpy(x))
    assert _err(y_t, y_r) < TOL
    assert abs(float(aux_t) - float(aux_r)) < 1e-6
    m = cfg_t.moe
    _, eidx, _ = t_moe._route(torch.from_numpy(x).reshape(-1, x.shape[-1]),
                              p_t["router"], m.top_k)
    ranks = t_moe._ranks_of(eidx.reshape(-1), m.num_experts)
    C = t_moe._capacity(32, m.top_k, m.num_experts, cf)
    if cf == 1.0:
        assert int((ranks >= C).sum()) > 0, "no token dropped"


def test_moe_shared_and_dense_residual(setup):
    """The always-on shared expert (DeepSeek) and the dense residual MLP
    (Arctic) beside the routed path, on the reduced Jamba widths."""
    cfg_r, cfg_t, _, _ = setup
    extra = dict(num_shared_experts=1, shared_d_ff=128,
                 dense_residual_d_ff=96)
    cfg_r = dataclasses.replace(cfg_r, moe=dataclasses.replace(cfg_r.moe,
                                                               **extra))
    cfg_t = dataclasses.replace(cfg_t, moe=dataclasses.replace(cfg_t.moe,
                                                               **extra))
    p_r = r_moe.init_moe(jax.random.PRNGKey(3), cfg_r, jnp.float32)
    p_t = params_from_numpy(_np_tree(p_r), device="cpu")
    own = t_moe.init_moe(torch.Generator().manual_seed(3), cfg_t, 1,
                         torch.float32, "cpu")
    assert sorted(_at0(own)) == sorted(p_t)
    for (path, a), (_, b) in zip(_paths(_np_tree(p_r)), _paths(_at0(own))):
        assert tuple(a.shape) == tuple(b.shape), path
    x = _x(12, (1, 10, cfg_t.d_model))
    y_r, _ = r_moe.moe_forward(cfg_r, p_r, jnp.asarray(x))
    y_t, _ = t_moe.moe_forward(cfg_t, p_t, torch.from_numpy(x))
    assert _err(y_t, y_r) < TOL


def test_unported_blocks_raise():
    with pytest.raises(NotImplementedError, match="xLSTM"):
        check_supported(LayerSpec("mlstm", False, 0, False))
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        check_supported(LayerSpec("attn", False, 256, True))
    for fn in (t_moe._routed_psum, t_moe._routed_a2a):
        with pytest.raises(NotImplementedError, match="mesh"):
            fn()


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_prefill_and_dense_decode(setup):
    """Prefill two prompts, then four greedy dense decode steps at
    per-request clocks past the 16-line window (the attention ring
    wraps): logits, tokens and every state leaf."""
    cfg_r, cfg_t, params_r, params_t = setup
    toks = _rng(1).integers(0, cfg_t.vocab_size, (2, 14), dtype=np.int32)
    lr, st_r = rm.prefill(cfg_r, params_r, {"tokens": jnp.asarray(toks)},
                          rm.init_state(cfg_r, 2, 16))
    lt, st_t = tm.prefill(cfg_t, params_t, {"tokens": torch.from_numpy(toks)},
                          tm.init_state(cfg_t, 2, 16, device="cpu"))
    assert _err(lt, lr) < TOL
    for a, b in zip(_leaves(_np_tree(st_r)), _leaves(st_t)):
        assert _err(b, a) < TOL
    t = np.asarray([14, 14], np.int32)
    for _ in range(4):
        tok = np.array(lr.argmax(-1), np.int32)[:, None]
        assert np.array_equal(lt.argmax(-1).numpy()[:, None], tok)
        lr, st_r = rm.decode_step(cfg_r, params_r, jnp.asarray(tok), st_r,
                                  jnp.asarray(t))
        lt, st_t = tm.decode_step(cfg_t, params_t, torch.from_numpy(tok),
                                  st_t, torch.from_numpy(t))
        assert _err(lt, lr) < TOL
        t = t + 1
    for a, b in zip(_leaves(_np_tree(st_r)), _leaves(st_t)):
        assert _err(b, a) < TOL


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

# ragged; 12 + 10 > 16 = kv_capacity wraps the attention ring
SHAPES = [(5, 10), (12, 10), (9, 4)]


def _prompt(i, plen, vocab):
    return _rng(100 + i).integers(0, vocab, (1, plen), dtype=np.int32)


def _mk(cfg, i, plen, new=6):
    return Request(prompt_len=plen, max_new_tokens=new,
                   prompt_tokens=_prompt(i, plen, cfg.vocab_size))


def _mk_r(cfg, i, plen, new=6):
    return RRequest(prompt_len=plen, max_new_tokens=new,
                    prompt_tokens=_prompt(i, plen, cfg.vocab_size))


def _engine(cfg, params, **kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("kv_capacity", 16)
    return InstanceEngine(cfg, params, device="cpu", **kw)


def _logged(monkeypatch, module, log):
    plain = module.sample_slots

    def sample(logits, *a, **kw):
        log.append(np.asarray(logits, np.float32).copy())
        return plain(logits, *a, **kw)

    monkeypatch.setattr(module, "sample_slots", sample)


@pytest.mark.parametrize("steps", [1, 3])
def test_engine_matches_repro_engine(setup, monkeypatch, steps):
    cfg_r, cfg, params_r, params = setup
    logs_r, logs_t = [], []
    _logged(monkeypatch, r_engine_mod, logs_r)
    _logged(monkeypatch, t_engine_mod, logs_t)
    er = REngine(cfg_r, params_r, num_slots=4, kv_capacity=16)
    et = _engine(cfg, params)
    assert not (et.supports_paged_decode or et.supports_chunked_prefill)
    assert not et.use_paged_decode
    reqs_r = [_mk_r(cfg, i, p, n) for i, (p, n) in enumerate(SHAPES)]
    reqs_t = [_mk(cfg, i, p, n) for i, (p, n) in enumerate(SHAPES)]
    for rr, rt in zip(reqs_r, reqs_t):
        assert er.prefill_request(rr) == et.prefill_request(rt)
        assert er.used_bytes() == et.used_bytes()
        assert er.free_blocks() == et.free_blocks()
    while er.slot_req or et.slot_req:
        assert er.decode_multi(steps=steps) == et.decode_multi(steps=steps)
        assert er.host_syncs == et.host_syncs
        assert er.used_bytes() == et.used_bytes()
        assert er.free_blocks() == et.free_blocks()
    assert [r.output_tokens for r in reqs_r] == \
        [r.output_tokens for r in reqs_t]
    assert len(logs_r) == len(logs_t) > len(SHAPES)
    for a, b in zip(logs_r, logs_t):
        assert _err(b, a) < TOL


def test_hybrid_engine_runs_scan_and_dense_decode(setup):
    """Prefill goes through the scan and prefill attention, decode through
    the dense decode attention; the paged kernel never runs, and fused
    decode degrades to sequential steps with the same tokens."""
    _, cfg, _, params = setup

    def serve(steps):
        eng = _engine(cfg, params)
        reqs = [_mk(cfg, i, p, n) for i, (p, n) in enumerate(SHAPES)]
        for r in reqs:
            eng.prefill_request(r)
        while eng.slot_req:
            eng.decode_multi(steps=steps)
        return [r.output_tokens for r in reqs], eng.host_syncs

    reset_counts()
    seq, syncs_seq = serve(1)
    counts = read_counts()
    for name in ("mamba_scan", "flash_attention", "decode_attention"):
        assert counts[name]["plain_calls"] > 0, name
    assert counts["paged_decode_attention"]["plain_calls"] == 0
    fused, syncs_fused = serve(4)
    assert fused == seq and syncs_fused == syncs_seq


def test_prefill_single_sizes_scratch_to_window(setup):
    """A hybrid stack's prompt prefills into a scratch of the whole window
    (the JAX package's rule), so a reused slot holds no stale rows past
    the new prompt: its state equals the JAX engine's leaf by leaf."""
    cfg_r, cfg, params_r, params = setup
    er = REngine(cfg_r, params_r, num_slots=1, kv_capacity=64)
    et = _engine(cfg, params, num_slots=1, kv_capacity=64)
    for i, (plen, new) in enumerate([(30, 4), (3, 2)]):
        rr, rt = _mk_r(cfg, i, plen, new), _mk(cfg, i, plen, new)
        assert er.prefill_request(rr) == et.prefill_request(rt) == 0
        for a, b in zip(_leaves(_np_tree(er.state)), _leaves(et.state)):
            assert _err(b, a) < TOL
        k = et.state["layers"][1]["p0"]["k"]
        assert float(k[:, 0, plen:].abs().max()) == 0.0
        while er.slot_req:
            er.decode()
            et.decode()
        assert rr.output_tokens == rt.output_tokens


def test_mirror_sync_then_promote_matches_no_handoff(setup):
    """The request sits in slot 0 of every engine with two slots: dense
    decode runs every slot's row, and capacity ranks by row order, so only
    the first row never loses its capacity to an idle row."""
    _, cfg, _, params = setup
    plen, new = 9, 14                         # 9 + 14 > 16: the ring wraps

    control = _engine(cfg, params, num_slots=2)
    req_c = _mk(cfg, 3, plen, new)
    assert control.prefill_request(req_c) == 0
    while control.slot_req:
        control.decode()

    a = _engine(cfg, params, num_slots=2, instance_id=0)
    b = _engine(cfg, params, num_slots=2, instance_id=1)
    req = _mk(cfg, 3, plen, new)
    sa = a.prefill_request(req)
    assert sa == 0
    b.import_slot(0, a.export_slot(sa), req, as_replica_of=(0, sa))
    costs = b.store.costs
    assert costs.recurrent_bytes > 0
    for _ in range(6):
        a.decode()
        assert b.sync_replica_from(a, sa, 0) == costs.mirror_bytes(1)
        for x, y in zip(_leaves(a.store.extract_slot(sa)),
                        _leaves(b.store.extract_slot(0))):
            assert torch.equal(x, y)
    a.demote_to_replica(sa, (1, 0))
    b.promote_replica(0, req)
    while b.slot_req:
        b.decode()
    assert req.output_tokens == req_c.output_tokens
    assert b.used_bytes() == 0 and a.replica_of == {sa: (1, 0)}


def test_export_copies_recurrent_state(setup):
    _, cfg, _, params = setup
    a = _engine(cfg, params)
    slot = a.prefill_request(_mk(cfg, 4, 6, 4))
    exported = a.export_slot(slot)
    before = exported[0]["layers"][0]["p0"]["ssm"].clone()
    a.decode()
    assert torch.equal(exported[0]["layers"][0]["p0"]["ssm"], before)
    assert not torch.equal(a.state["layers"][0]["p0"]["ssm"][:, slot:
                                                            slot + 1],
                           before)
