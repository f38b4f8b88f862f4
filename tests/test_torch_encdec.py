"""The port's encoder-decoder stack (seamless-m4t-large-v2) held against the
JAX package's on the CPU.

Reduced seamless-m4t-large-v2 in f32: a 2-layer bidirectional encoder over
16 frames and a 2-layer decoder with cross attention, d_model 256, 4/4
heads, hd 64, sinusoidal positions.  The JAX package's random weights go
through numpy into the port (``params_from_numpy``); the same inputs
(numpy, seeded) go through both, frames included.  Tolerance 1e-4 max abs
in f32 on outputs, logits and states; tokens, host syncs, ledger bytes
(the static encoder memory and cross K/V included), traces and stats must
be equal exactly.

The encoder reaches the prefill kernel in its non-causal mode, the decoder
the prefill kernel causally and the dense decode kernel; cross attention
runs the plain chunked softmax, as in the JAX package.  No CUDA kernel can
run here: the autouse fixture checks that only plain versions ran, and
never the paged kernel or the scan, which are off this path.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as rapi
import repro.configs as rcfg
import repro.kvstore as rkv
import repro.models as rm
import repro.scheduling.registry as rreg
import repro.workloads as rwl
from repro.core import kvbytes as r_kvbytes
from repro.models import attention as r_attn
from repro.models import common as r_common
from repro.models import model as r_model
from repro.scheduling.live import LiveCluster as RLiveCluster
from repro.serving import InstanceEngine as REngine
from repro.serving import Request as RRequest
import repro_torch.api as tapi
import repro_torch.configs as tcfg
import repro_torch.kvstore as tkv
import repro_torch.launch.serve as tlserve
import repro_torch.models as tm
import repro_torch.scheduling.registry as treg
import repro_torch.workloads as twl
from repro_torch.bridge import params_from_numpy, state_from_numpy
from repro_torch.core import kvbytes as t_kvbytes
from repro_torch.kernels import read_counts, reset_counts
from repro_torch.models import attention as t_attn
from repro_torch.models import common as t_common
from repro_torch.models import model as t_model
from repro_torch.scheduling.live import LiveCluster
from repro_torch.serving import InstanceEngine, Request

ARCH = "seamless-m4t-large-v2"
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


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _frames(cfg, seed, batch=1):
    return _x(seed, (batch, cfg.encoder.max_source_positions,
                     cfg.frontend.embed_dim))


@pytest.fixture(scope="module")
def setup():
    cfg_r = rcfg.get_config(ARCH).reduced()
    cfg = tcfg.get_config(ARCH).reduced()
    params_r = rm.init_params(jax.random.PRNGKey(0), cfg_r)
    params = params_from_numpy(_np_tree(params_r), device="cpu")
    return cfg_r, cfg, params_r, params


@pytest.fixture(autouse=True)
def plain_kernels_only():
    """No CUDA kernel runs on the CPU: whatever this path reached ran as
    its plain version, and the paged kernel and the scan not at all."""
    reset_counts()
    yield
    counts = read_counts()
    for name, c in counts.items():
        assert c["launches"] == 0, name
    for name in ("paged_decode_attention", "mamba_scan"):
        assert counts[name]["plain_calls"] == 0, name


# ---------------------------------------------------------------------------
# configuration, costs, parameter tree, state
# ---------------------------------------------------------------------------


def test_line_costs_price_the_static_state():
    """A request's encoder memory and cross K/V are static bytes: 8.39 MB
    of ``enc_out`` plus 24 layers of cross K/V at full width; a decoder KV
    line is 98,304 B; nothing is recurrent."""
    for reduced in (False, True):
        a, b = rcfg.get_config(ARCH), tcfg.get_config(ARCH)
        if reduced:
            a, b = a.reduced(), b.reduced()
        ca, cb = rkv.LineCosts.from_config(a), tkv.LineCosts.from_config(b)
        assert dataclasses.asdict(ca) == dataclasses.asdict(cb)
        assert (r_kvbytes.state_bytes_at(a, 517)
                == t_kvbytes.state_bytes_at(b, 517))
    assert cb.recurrent_bytes == 0
    full = tkv.LineCosts.from_config(tcfg.get_config(ARCH))
    assert full.static_bytes == 411_041_792 == 4096 * 1024 * 2 \
        + 24 * 2 * 4096 * 16 * 64 * 2
    assert full.line_bytes == 98_304 and full.recurrent_bytes == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_tree_and_state_layout(dtype):
    """The port's own draw has the JAX package's tree (encoder, cross
    attention and its norm), shapes and dtypes, and so has its state
    (``enc_out`` and each decoder layer's ``xk``/``xv``)."""
    cfg_r = dataclasses.replace(rcfg.get_config(ARCH).reduced(), dtype=dtype)
    cfg_t = dataclasses.replace(tcfg.get_config(ARCH).reduced(), dtype=dtype)
    for ref, own in (
            (_np_tree(rm.init_params(jax.random.PRNGKey(1), cfg_r)),
             tm.init_params(cfg_t, torch.Generator().manual_seed(1),
                            device="cpu")),
            (_np_tree(rm.init_state(cfg_r, 3, 32)),
             tm.init_state(cfg_t, 3, 32, device="cpu"))):
        ref, own = list(_paths(ref)), list(_paths(own))
        assert [p for p, _ in own] == [p for p, _ in ref]
        for (path, a), (_, b) in zip(ref, own):
            assert tuple(a.shape) == tuple(b.shape), path
            assert str(b.dtype).split(".")[-1] == a.dtype.name, path
    own = dict(_paths(tm.init_state(cfg_t, 3, 32, device="cpu")))
    assert own["/enc_out"].shape == (3, 16, 256)
    assert own["/layers/0/p0/xk"].shape == (2, 3, 16, 4, 64)


def test_sinusoidal_positions_match_reference():
    """Within 1e-4 of the JAX package's at the reduced configs' positions.
    Over the full encoder's 4096 an f32 angle near 4095 carries rounding
    of ~2.4e-4 in either package, so there each is held to a float64
    embedding within 16 f32 roundings of its angle."""
    for positions, dim in ((np.arange(37), 256),
                           (np.array([[5], [30], [63]]), 1024),
                           (np.arange(4096), 1024)):
        want = r_common.sinusoidal_positions(jnp.asarray(positions), dim)
        got = t_common.sinusoidal_positions(torch.as_tensor(positions), dim)
        assert got.dtype == torch.float32
        assert tuple(got.shape) == tuple(want.shape)
        if positions.max() < 64:
            assert _err(got, want) < TOL
            continue
        half = dim // 2
        angle = positions[..., None] * np.exp(
            -np.log(10000.0) * np.arange(half) / half)
        exact = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
        limit = 16 * 2.0 ** -24 * np.maximum(
            np.concatenate([angle, angle], axis=-1), 1.0)
        for side in (got, want):
            assert (np.abs(np.asarray(side, np.float64) - exact)
                    <= limit).all()


# ---------------------------------------------------------------------------
# cross attention, the encoder, the model
# ---------------------------------------------------------------------------


def _r0(tree):
    """Repeat 0 of a JAX package's stacked leaves."""
    return jax.tree_util.tree_map(lambda a: a[0], tree)


def _t0(tree):
    """Repeat 0 of the port's stacked leaves (views)."""
    if isinstance(tree, dict):
        return {k: _t0(v) for k, v in tree.items()}
    return tree[0]


def test_cross_attn_precompute_then_cached(setup):
    """Prefill projects the encoder memory into the cross cache (in place
    in the port); decode reads the cache with no encoder memory."""
    cfg_r, cfg, params_r, params = setup
    p_r = _r0(params_r["segments"][0]["p0"]["cross"])
    p_t = _t0(params["segments"][0]["p0"]["cross"])
    enc = _x(1, (2, 16, cfg.d_model))
    st_r = _r0(rm.init_state(cfg_r, 2, 8)["layers"][0]["p0"])
    st_t = _t0(tm.init_state(cfg, 2, 8, device="cpu")["layers"][0]["p0"])
    x = _x(2, (2, 7, cfg.d_model))
    y_r, st_r = r_attn.cross_attn_forward(cfg_r, p_r, jnp.asarray(x),
                                          enc_out=jnp.asarray(enc),
                                          state=st_r, precompute=True)
    y_t, out = t_attn.cross_attn_forward(cfg, p_t, torch.from_numpy(x),
                                         enc_out=torch.from_numpy(enc),
                                         state=st_t, precompute=True)
    assert out is st_t
    assert _err(y_t, y_r) < TOL
    for key in ("xk", "xv"):
        assert _err(st_t[key], st_r[key]) < TOL
    x = _x(3, (2, 1, cfg.d_model))
    y_r, _ = r_attn.cross_attn_forward(cfg_r, p_r, jnp.asarray(x),
                                       enc_out=None, state=st_r)
    y_t, _ = t_attn.cross_attn_forward(cfg, p_t, torch.from_numpy(x),
                                       enc_out=None, state=st_t)
    assert _err(y_t, y_r) < TOL
    with pytest.raises(ValueError, match="frames"):
        t_attn.cross_attn_forward(cfg, p_t, torch.from_numpy(x),
                                  enc_out=torch.zeros((2, 9, cfg.d_model)),
                                  state=st_t, precompute=True)
    # a state with no cross cache gets one, as the JAX package adds it
    y_r, st_r = r_attn.cross_attn_forward(cfg_r, p_r, jnp.asarray(x),
                                          enc_out=jnp.asarray(enc), state={})
    y_t, st_t = t_attn.cross_attn_forward(cfg, p_t, torch.from_numpy(x),
                                          enc_out=torch.from_numpy(enc),
                                          state={})
    assert _err(y_t, y_r) < TOL
    for key in ("xk", "xv"):
        assert _err(st_t[key], st_r[key]) < TOL


def test_encode_matches_reference(setup):
    """The bidirectional encoder over 16 frames, through the prefill
    kernel's plain version with ``causal=False``."""
    cfg_r, cfg, params_r, params = setup
    frames = _frames(cfg, 4, batch=2)
    want = r_model._encode(cfg_r, params_r, jnp.asarray(frames))
    got = t_model._encode(cfg, params, torch.from_numpy(frames))
    assert _err(got, want) < TOL
    assert read_counts()["flash_attention"]["plain_calls"] \
        == cfg.num_layers


def test_prefill_and_decode_logits(setup):
    """Prefill two prompts over their frames, then four greedy decode
    steps: logits, tokens and every state leaf (``enc_out``, cross K/V,
    self-attention KV)."""
    cfg_r, cfg, params_r, params = setup
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 13),
                                              dtype=np.int32)
    frames = _frames(cfg, 5, batch=2)
    lr, st_r = rm.prefill(cfg_r, params_r, {"tokens": jnp.asarray(toks),
                                            "frames": jnp.asarray(frames)},
                          rm.init_state(cfg_r, 2, 32))
    lt, st_t = tm.prefill(cfg, params, {"tokens": torch.from_numpy(toks),
                                        "frames": torch.from_numpy(frames)},
                          tm.init_state(cfg, 2, 32, device="cpu"))
    assert _err(lt, lr) < TOL
    t = np.full(2, 13, np.int32)
    for _ in range(4):
        tok = np.array(lr.argmax(-1), np.int32)[:, None]
        assert np.array_equal(lt.argmax(-1).numpy()[:, None], tok)
        lr, st_r = rm.decode_step(cfg_r, params_r, jnp.asarray(tok), st_r,
                                  jnp.asarray(t))
        lt, st_t = tm.decode_step(cfg, params, torch.from_numpy(tok), st_t,
                                  torch.from_numpy(t))
        assert _err(lt, lr) < TOL
        t = t + 1
    ref, own = list(_paths(_np_tree(st_r))), list(_paths(st_t))
    assert [p for p, _ in own] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(ref, own):
        assert _err(b, a) < TOL, path
    counts = read_counts()
    assert counts["flash_attention"]["plain_calls"] == 2 * cfg.num_layers
    assert counts["decode_attention"]["plain_calls"] == 4 * cfg.num_layers
    with pytest.raises(ValueError, match="encoder memory"):
        tm.prefill(cfg, params, {"tokens": torch.from_numpy(toks),
                                 "frames": torch.zeros((2, 9, 256))},
                   tm.init_state(cfg, 2, 32, device="cpu"))


# ---------------------------------------------------------------------------
# the store: static leaves and the encoder memory
# ---------------------------------------------------------------------------


def _filled_stores(cfg_r, cfg, seed):
    """A JAX and a port store of 3 slots holding the same random state."""
    rs = rkv.PagedStore(cfg_r, 3, 32)
    ts = tkv.PagedStore(cfg, 3, 32, device="cpu")
    rng = np.random.default_rng(seed)
    state = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        _np_tree(rs.state))
    rs.state = jax.tree_util.tree_map(jnp.asarray, state)
    ts.state = state_from_numpy(state, device="cpu")
    return rs, ts


def _same(rs, ts):
    for (path, a), (_, b) in zip(_paths(_np_tree(rs.state)),
                                 _paths(ts.state)):
        assert _err(b, a) == 0.0, path


def test_store_static_leaves_and_encoder_memory(setup):
    """Extract, merge, stream, import and ``copy_lines`` on a store whose
    attention layers hold cross K/V: equal to the JAX package's store leaf
    by leaf, with equal bytes; the mirror moves no static byte."""
    cfg_r, cfg, _, _ = setup
    rs, ts = _filled_stores(cfg_r, cfg, 1)
    assert ts._paths == rs._paths
    assert {p[2]: p[3] for p in ts._paths} == {
        "k": "line", "v": "line", "xk": "static", "xv": "static"}
    # extract carries enc_out; merging rows [3, 9) copies static whole
    sub_r, sub_t = rs.extract_slot(1), ts.extract_slot(1)
    assert set(sub_t) == {"layers", "enc_out"}
    for a, b in zip(_leaves(_np_tree(sub_r)), _leaves(sub_t)):
        assert _err(b, a) == 0.0
    rs.merge_slot_rows(0, sub_r, 3, 9)
    ts.merge_slot_rows(0, sub_t, 3, 9)
    _same(rs, ts)
    # stream slot 2 of one store pair into slot 0 of another
    rd, td = _filled_stores(cfg_r, cfg, 2)
    chunks_r, chunks_t = list(rs.stream_slot(2)), list(ts.stream_slot(2))
    assert [p for p, _ in chunks_t] == [p for p, _ in chunks_r]
    assert chunks_t[-1][0] == ("enc_out",)
    for (path, a), (_, b) in zip(chunks_r, chunks_t):
        assert _err(b, a) == 0.0, path
        rd.import_chunk(0, path, a)
        td.import_chunk(0, path, b)
    _same(rd, td)
    # the mirror: rows of accounting lines [5, 9) only, no static leaf
    rd2, td2 = _filled_stores(cfg_r, cfg, 3)
    before = [x.clone() for x in _leaves(td2.state)]
    moved_r = rd2.copy_lines(rs, 1, 2, 5, 9)
    moved_t = td2.copy_lines(ts, 1, 2, 5, 9)
    assert moved_t == moved_r == 4 * td2.costs.line_bytes
    _same(rd2, td2)
    for (path, b), old in zip(_paths(td2.state), before):
        if path.endswith(("/xk", "/xv")) or path == "/enc_out":
            assert torch.equal(b, old), path
    # the ledger prices the fixed block: static bytes on every request
    for store in (rd2, td2):
        store.alloc(7, 1, lines=10)
    assert td2.used_bytes() == rd2.used_bytes() \
        == 10 * td2.costs.line_bytes + td2.costs.static_bytes
    assert td2.free_blocks() == rd2.free_blocks()


# ---------------------------------------------------------------------------
# the engine, the cluster, api.serve, the launcher, the bridge
# ---------------------------------------------------------------------------

SHAPES = [(5, 10), (12, 7), (9, 4)]


def _prompt(i, plen, vocab):
    return np.random.default_rng(100 + i).integers(0, vocab, (1, plen),
                                                   dtype=np.int32)


@pytest.mark.parametrize("steps", [1, 4])
def test_engine_matches_repro_engine(setup, steps):
    """Extras handed over as numpy: one prompt at a time over its frames
    into a scratch of the whole window, then dense decode over every slot,
    sequential and fused: tokens, host syncs and ledger bytes (static
    included) equal the JAX package's engine.  An enc-dec engine neither
    pages nor chunks, and a chunk item with extras raises."""
    cfg_r, cfg, params_r, params = setup
    er = REngine(cfg_r, params_r, num_slots=4, kv_capacity=16)
    et = InstanceEngine(cfg, params, num_slots=4, kv_capacity=16,
                        device="cpu")
    assert not (et.supports_paged_decode or et.supports_chunked_prefill)
    for i, (p, n) in enumerate(SHAPES):
        extra = {"frames": _frames(cfg, 30 + i)}
        rr = RRequest(prompt_len=p, max_new_tokens=n,
                      prompt_tokens=_prompt(i, p, cfg.vocab_size))
        rt = Request(prompt_len=p, max_new_tokens=n,
                     prompt_tokens=_prompt(i, p, cfg.vocab_size))
        assert er.prefill_request(rr, extra) == et.prefill_request(rt, extra)
        assert er.used_bytes() == et.used_bytes() > et.store.costs.static_bytes
        assert np.array_equal(er.lengths, et.lengths)
    while er.slot_req or et.slot_req:
        assert er.decode_multi(steps=steps) == et.decode_multi(steps=steps)
        assert er.host_syncs == et.host_syncs
        assert er.used_bytes() == et.used_bytes()
        assert er.free_blocks() == et.free_blocks()
    from repro_torch.stepplan import PrefillItem
    req = Request(prompt_len=6, max_new_tokens=2,
                  prompt_tokens=_prompt(9, 6, cfg.vocab_size),
                  extra={"frames": _frames(cfg, 39)})
    with pytest.raises(NotImplementedError, match="token-only"):
        et._prefill_chunk_item(PrefillItem(req.rid, 6, 2, 6, req=req),
                               req.extra)


class _Replay:
    """An open-loop source over fixed requests."""

    def __init__(self, reqs):
        self._reqs, self.concurrency = reqs, None

    def __iter__(self):
        return iter(self._reqs)


_STREAM = [(12, 6, 0.0), (20, 8, 0.0), (9, 5, 1.0), (16, 7, 2.0),
           (7, 9, 3.0), (14, 4, 5.0)]


def _record_streams(monkeypatch):
    """Count the lines each ``import_stream`` installs on the port."""
    seen = []
    plain = InstanceEngine.import_stream

    def stream(self, slot, chunks, length, last_tok, lines, req, **kw):
        seen.append(lines)
        return plain(self, slot, chunks, length, last_tok, lines, req, **kw)

    monkeypatch.setattr(InstanceEngine, "import_stream", stream)
    return seen


def test_cluster_matches_reference(setup, monkeypatch):
    """Two instances under accellm, each request carrying its frames as
    numpy: equal kernel and plan traces, stats and tokens.  Each stream
    moves the request's lines plus its static bytes, and the mirror only
    KV lines."""
    cfg_r, cfg, params_r, params = setup
    streams = _record_streams(monkeypatch)
    outs = []
    for mod, cls, reg, c, p in ((RRequest, RLiveCluster, rreg, cfg_r,
                                 params_r),
                                (Request, LiveCluster, treg, cfg, params)):
        kw = {"device": "cpu"} if cls is LiveCluster else {}
        cluster = cls(c, p, 2, 4, 32, reg.get_policy("accellm"), **kw)
        cluster.policy.trace = []
        cluster.planner.trace = []
        reqs = [mod(prompt_len=pl, max_new_tokens=n, rid=i, arrival=a,
                    prompt_tokens=_prompt(50 + i, pl, cfg.vocab_size),
                    extra={"frames": _frames(cfg, 60 + i)})
                for i, (pl, n, a) in enumerate(_STREAM)]
        cluster.run(max_steps=300, source=_Replay(reqs))
        outs.append({"stats": dict(cluster.stats),
                     "iterations": cluster.n_iterations,
                     "kernel_trace": cluster.policy.trace,
                     "plan_trace": cluster.planner.trace,
                     "tokens": [list(map(int, r.output_tokens))
                                for r in reqs],
                     "finished": sorted(r.rid for r in cluster.finished)})
    ref, port = outs
    assert port == ref
    st = port["stats"]
    assert len(port["finished"]) == len(_STREAM)
    costs = tkv.LineCosts.from_config(cfg)
    assert st["mirror_syncs"] > 0 and st["mirror_bytes"] > 0
    assert st["mirror_bytes"] % costs.line_bytes == 0
    assert streams and st["stream_bytes"] == \
        costs.line_bytes * sum(streams) + costs.static_bytes * len(streams)


def _traffic(mod):
    return mod.WorkloadSpec(arrival=mod.Poisson(rate=0.6, duration=7.0),
                            lengths=mod.TableLengths("light", scale=0.03),
                            name="parity")


def test_serve_open_loop_matches_reference(setup):
    """``api.serve`` open-loop, requests built by ``RequestSource`` with
    ``default_extras``: the frames and prompt tokens differ by design
    (numpy draws), so latencies, stats and the report's other token-free
    metrics are compared."""
    cfg_r, cfg, params_r, params = setup
    kw = dict(arch=ARCH, policy="accellm", n_instances=2, num_slots=4,
              kv_capacity=64, max_steps=400, seed=3)
    rep_r = rapi.serve(rapi.ServeSpec(traffic=_traffic(rwl), **kw),
                       cfg=cfg_r, params=params_r)
    rep_t = tapi.serve(tapi.ServeSpec(traffic=_traffic(twl), device="cpu",
                                      **kw), cfg=cfg, params=params)
    assert rep_t.all_finished and rep_r.all_finished
    assert rep_t.n_submitted == rep_r.n_submitted >= 3
    for f in ("ttfts", "tbts", "jcts"):
        assert np.array_equal(getattr(rep_t, f)(), getattr(rep_r, f)()), f
    assert rep_t.stats == rep_r.stats
    assert rep_t.duration == rep_r.duration
    assert all(set(r.extra) == {"frames"} for r in rep_t.finished)


def test_launch_serve_runs_on_the_cpu(capsys):
    rc = tlserve.main(["--arch", ARCH, "--instances", "2", "--requests",
                       "3", "--slots", "4", "--kv-capacity", "64",
                       "--scale", "0.02", "--max-steps", "300",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert f"serving {ARCH}" in out and "device=cpu" in out
    assert "stats:" in out


def test_bridge_carries_the_new_leaves(setup):
    """The encoder tree, cross attention and its norm, and the state's
    ``enc_out``/``xk``/``xv`` cross through numpy leaf by leaf, and take a
    cast to bf16 like every other model-dtype leaf."""
    cfg_r, _, params_r, params = setup
    ref = dict(_paths(_np_tree(params_r)))
    own = dict(_paths(params))
    assert own.keys() == ref.keys()
    new = [p for p in own if p.startswith("/encoder/") or "/cross" in p]
    assert any("/cross/" in p for p in new)
    assert any("/cross_norm" in p for p in new)
    assert "/encoder/final_norm" in new
    for p in new:
        assert np.array_equal(own[p].numpy(), ref[p]), p
    cast = params_from_numpy(_np_tree(params_r), device="cpu",
                             dtype=torch.bfloat16)
    assert {x.dtype for x in _leaves(cast)} == {torch.bfloat16}
    st = _np_tree(rm.init_state(cfg_r, 2, 8))
    st["enc_out"] = _x(8, st["enc_out"].shape)
    back = state_from_numpy(st, device="cpu", dtype=torch.bfloat16)
    assert back["enc_out"].dtype == torch.bfloat16
    assert torch.equal(back["enc_out"],
                       torch.from_numpy(st["enc_out"]).bfloat16())
    assert back["layers"][0]["p0"]["xk"].dtype == torch.bfloat16
