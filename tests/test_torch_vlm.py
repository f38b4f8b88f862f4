"""The port's vision-prefix stack (internvl2-1b) held against the JAX
package's on the CPU.

Reduced internvl2-1b in f32: 2 layers, d_model 256, 4/1 heads (G = 4), hd
64, tied embeddings, and an 8-patch vision prefix through the 2-layer
projector.  The JAX package's random weights go through numpy into the
port (``params_from_numpy``); the same inputs (numpy, seeded) go through
both, patches included.  Tolerance 1e-4 max abs in f32 on outputs, logits
and states; tokens, host syncs, ledger bytes, traces and stats must be
equal exactly.

A fault of the reference is pinned here, not fixed: the JAX package's
engine starts a vision request's decode clock at the prompt length S,
where its prefill wrote P + S rows at positions 0..P+S-1, so the first
decode step overwrites a patch row and attends to rows [0, S + 1) only.
The port's engine keeps that clock (tokens, ledger lines and mirror rows
stay equal to the reference's); its model is right at t = P + S, as the
reference's is.  ``ROADMAP.md`` (Queue 3, faults of the reference) has the
numbers.

The stack reaches the prefill kernel (causal, over patches plus prompt)
and the dense decode kernel.  No CUDA kernel can run here: the autouse
fixture checks that only plain versions ran, and never the paged kernel or
the scan, which are off this path.
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
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import read_counts, reset_counts
from repro_torch.models import model as t_model
from repro_torch.scheduling.live import LiveCluster
from repro_torch.serving import InstanceEngine, Request

ARCH = "internvl2-1b"
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


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _patches(cfg, seed, batch=1):
    return _x(seed, (batch, cfg.frontend.num_prefix_tokens,
                     cfg.frontend.embed_dim))


def _prompt(seed, plen, vocab, batch=1):
    return np.random.default_rng(seed).integers(0, vocab, (batch, plen),
                                                dtype=np.int32)


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
# the vision prefix and the model
# ---------------------------------------------------------------------------


def test_line_costs_and_param_tree():
    """KV lines only (24 layers x 2 KV heads x hd 64 at full width, no
    static or recurrent bytes); the port's own draw has the JAX package's
    tree, the projector ``proj.{w1, w2}`` in the model dtype included."""
    full = tkv.LineCosts.from_config(tcfg.get_config(ARCH))
    assert dataclasses.asdict(full) == dataclasses.asdict(
        rkv.LineCosts.from_config(rcfg.get_config(ARCH)))
    assert full.line_bytes == 24 * 2 * 2 * 64 * 2
    assert full.static_bytes == full.recurrent_bytes == 0
    for dtype in ("float32", "bfloat16"):
        cfg_r = dataclasses.replace(rcfg.get_config(ARCH).reduced(),
                                    dtype=dtype)
        cfg_t = dataclasses.replace(tcfg.get_config(ARCH).reduced(),
                                    dtype=dtype)
        ref = list(_paths(_np_tree(rm.init_params(jax.random.PRNGKey(1),
                                                  cfg_r))))
        own = list(_paths(tm.init_params(
            cfg_t, torch.Generator().manual_seed(1), device="cpu")))
        assert [p for p, _ in own] == [p for p, _ in ref]
        assert "/proj/w1" in dict(own) and "/lm_head" not in dict(own)
        for (path, a), (_, b) in zip(ref, own):
            assert tuple(a.shape) == tuple(b.shape), path
            assert str(b.dtype).split(".")[-1] == a.dtype.name, path


def test_embed_inputs_vision_prefix(setup):
    """The projected patches (in f32) lead the token embeddings; the
    positions cover P + S."""
    cfg_r, cfg, params_r, params = setup
    toks, pe = _prompt(1, 6, cfg.vocab_size, 2), _patches(cfg, 2, 2)
    x_r, pos_r = r_model._embed_inputs(
        cfg_r, params_r, {"tokens": jnp.asarray(toks),
                          "patch_embeds": jnp.asarray(pe)})
    x_t, pos_t = t_model._embed_inputs(
        cfg, params, {"tokens": torch.from_numpy(toks),
                      "patch_embeds": torch.from_numpy(pe)})
    assert tuple(x_t.shape) == (2, 8 + 6, cfg.d_model)
    assert _err(x_t, x_r) < TOL
    assert np.array_equal(pos_t.numpy(), np.asarray(pos_r))
    # a bf16 model: the projector still computes in f32, then casts
    p16 = params_from_numpy(_np_tree(params_r), device="cpu",
                            dtype=torch.bfloat16)
    x16, _ = t_model._embed_inputs(
        dataclasses.replace(cfg, dtype="bfloat16"), p16,
        {"tokens": torch.from_numpy(toks),
         "patch_embeds": torch.from_numpy(pe)})
    assert x16.dtype == torch.bfloat16
    assert _err(x16[:, :8].float(), x_t[:, :8]) < 5e-2


def _prefill_both(setup, toks, pe, window=32):
    cfg_r, cfg, params_r, params = setup
    lr, st_r = rm.prefill(cfg_r, params_r, {"tokens": jnp.asarray(toks),
                                            "patch_embeds": jnp.asarray(pe)},
                          rm.init_state(cfg_r, toks.shape[0], window))
    lt, st_t = tm.prefill(cfg, params, {"tokens": torch.from_numpy(toks),
                                        "patch_embeds": torch.from_numpy(pe)},
                          tm.init_state(cfg, toks.shape[0], window,
                                        device="cpu"))
    return lr, st_r, lt, st_t


def test_prefill_and_decode_logits(setup):
    """Prefill two prompts behind their patches (P + S = 21 rows), then
    four greedy decode steps at the clock P + S: logits, tokens and every
    state leaf."""
    cfg_r, cfg, params_r, params = setup
    toks, pe = _prompt(11, 13, cfg.vocab_size, 2), _patches(cfg, 5, 2)
    lr, st_r, lt, st_t = _prefill_both(setup, toks, pe)
    assert _err(lt, lr) < TOL
    t = np.full(2, 8 + 13, np.int32)
    for _ in range(4):
        tok = np.array(lr.argmax(-1), np.int32)[:, None]
        assert np.array_equal(lt.argmax(-1).numpy()[:, None], tok)
        lr, st_r = rm.decode_step(cfg_r, params_r, jnp.asarray(tok), st_r,
                                  jnp.asarray(t))
        lt, st_t = tm.decode_step(cfg, params, torch.from_numpy(tok), st_t,
                                  torch.from_numpy(t))
        assert _err(lt, lr) < TOL
        t = t + 1
    for (path, a), (_, b) in zip(_paths(_np_tree(st_r)), _paths(st_t)):
        assert _err(b, a) < TOL, path
    counts = read_counts()
    assert counts["flash_attention"]["plain_calls"] == cfg.num_layers
    assert counts["decode_attention"]["plain_calls"] == 4 * cfg.num_layers


# ---------------------------------------------------------------------------
# the reference's engine clock (a fault of the reference, pinned)
# ---------------------------------------------------------------------------


def _one_step(setup, t):
    """Prefill a 6-token prompt behind P = 8 patches, decode its greedy
    token at clock ``t``, and prefill prompt + token afresh: (decode
    logits, fresh logits) of each package."""
    cfg_r, cfg, params_r, params = setup
    toks, pe = _prompt(21, 6, cfg.vocab_size), _patches(cfg, 22)
    lr, st_r, lt, st_t = _prefill_both(setup, toks, pe)
    tok = np.array(lr.argmax(-1), np.int32)[:, None]
    dr, _ = rm.decode_step(cfg_r, params_r, jnp.asarray(tok), st_r,
                           jnp.asarray(np.full(1, t, np.int32)))
    dt, _ = tm.decode_step(cfg, params, torch.from_numpy(tok), st_t,
                           torch.from_numpy(np.full(1, t, np.int32)))
    fr, _, ft, _ = _prefill_both(setup, np.concatenate([toks, tok], 1), pe)
    return (dr, fr), (dt, ft)


def test_decode_at_prefix_clock_matches_prefill(setup):
    """At t = P + S the one-step decode equals a fresh prefill over prompt
    + token, in both packages; at the engine's t = S both packages give
    the same wrong logits (the reference's fault, reproduced)."""
    ref, port = _one_step(setup, 8 + 6)
    for dec, fresh in (ref, port):
        assert _err(dec, fresh) < TOL * float(np.abs(np.asarray(fresh)).max())
    assert _err(port[0], ref[0]) < TOL
    ref, port = _one_step(setup, 6)
    assert _err(port[0], ref[0]) < TOL
    scale = float(np.abs(np.asarray(ref[1])).max())
    assert _err(ref[0], ref[1]) > 0.1 * scale
    assert _err(port[0], port[1]) > 0.1 * scale


def test_engine_clock_equals_reference(setup):
    """Both engines start a vision request's decode clock at S, not P + S,
    and hold the same ledger lines."""
    cfg_r, cfg, params_r, params = setup
    er = REngine(cfg_r, params_r, num_slots=2, kv_capacity=32)
    et = InstanceEngine(cfg, params, num_slots=2, kv_capacity=32,
                        device="cpu")
    extra = {"patch_embeds": _patches(cfg, 22)}
    rr = RRequest(prompt_len=6, max_new_tokens=3,
                  prompt_tokens=_prompt(21, 6, cfg.vocab_size))
    rt = Request(prompt_len=6, max_new_tokens=3,
                 prompt_tokens=_prompt(21, 6, cfg.vocab_size))
    slot = er.prefill_request(rr, extra)
    assert et.prefill_request(rt, extra) == slot
    assert int(et.lengths[slot]) == int(er.lengths[slot]) == 6
    assert et.store.lines(rt.rid) == er.store.lines(rr.rid) == 7
    assert er.decode() == et.decode()


# ---------------------------------------------------------------------------
# the engine, the cluster, api.serve, the launcher
# ---------------------------------------------------------------------------

SHAPES = [(5, 10), (12, 7), (9, 4)]


@pytest.mark.parametrize("steps", [1, 4])
def test_engine_matches_repro_engine(setup, steps):
    """Patches handed over as numpy: one prompt at a time into a scratch
    of the whole window, then dense decode over every slot, sequential and
    fused: tokens, host syncs and ledger bytes equal the JAX package's
    engine.  A VLM engine neither pages nor chunks."""
    cfg_r, cfg, params_r, params = setup
    er = REngine(cfg_r, params_r, num_slots=4, kv_capacity=32)
    et = InstanceEngine(cfg, params, num_slots=4, kv_capacity=32,
                        device="cpu")
    assert not (et.supports_paged_decode or et.supports_chunked_prefill)
    for i, (p, n) in enumerate(SHAPES):
        extra = {"patch_embeds": _patches(cfg, 30 + i)}
        rr = RRequest(prompt_len=p, max_new_tokens=n,
                      prompt_tokens=_prompt(100 + i, p, cfg.vocab_size))
        rt = Request(prompt_len=p, max_new_tokens=n,
                     prompt_tokens=_prompt(100 + i, p, cfg.vocab_size))
        assert er.prefill_request(rr, extra) == et.prefill_request(rt, extra)
        assert er.used_bytes() == et.used_bytes() > 0
    while er.slot_req or et.slot_req:
        assert er.decode_multi(steps=steps) == et.decode_multi(steps=steps)
        assert er.host_syncs == et.host_syncs
        assert er.used_bytes() == et.used_bytes()
        assert er.free_blocks() == et.free_blocks()


def test_engine_takes_tensor_payload(setup):
    """The patches handed over as a tensor give the tokens that the same
    patches in numpy give."""
    _, cfg, _, params = setup
    patches = _patches(cfg, 30)
    toks = []
    for extra in ({"patch_embeds": patches},
                  {"patch_embeds": torch.from_numpy(patches)}):
        et = InstanceEngine(cfg, params, num_slots=2, kv_capacity=32,
                            device="cpu")
        rt = Request(prompt_len=5, max_new_tokens=4,
                     prompt_tokens=_prompt(100, 5, cfg.vocab_size))
        et.prefill_request(rt, extra)
        while et.slot_req:
            et.decode()
        toks.append(list(rt.output_tokens))
    assert toks[0] == toks[1] and len(toks[0]) == 4


class _Replay:
    """An open-loop source over fixed requests."""

    def __init__(self, reqs):
        self._reqs, self.concurrency = reqs, None

    def __iter__(self):
        return iter(self._reqs)


_STREAM = [(12, 6, 0.0), (20, 8, 0.0), (9, 5, 1.0), (16, 7, 2.0),
           (7, 9, 3.0), (14, 4, 5.0)]


def test_cluster_matches_reference(setup):
    """Two instances under accellm, each request carrying its patches as
    numpy: equal kernel and plan traces, stats and tokens."""
    cfg_r, cfg, params_r, params = setup
    outs = []
    for mod, cls, reg, c, p in ((RRequest, RLiveCluster, rreg, cfg_r,
                                 params_r),
                                (Request, LiveCluster, treg, cfg, params)):
        kw = {"device": "cpu"} if cls is LiveCluster else {}
        cluster = cls(c, p, 2, 4, 64, reg.get_policy("accellm"), **kw)
        cluster.policy.trace = []
        cluster.planner.trace = []
        reqs = [mod(prompt_len=pl, max_new_tokens=n, rid=i, arrival=a,
                    prompt_tokens=_prompt(50 + i, pl, cfg.vocab_size),
                    extra={"patch_embeds": _patches(cfg, 60 + i)})
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
    assert st["mirror_syncs"] > 0
    line = tkv.LineCosts.from_config(cfg).line_bytes
    assert st["mirror_bytes"] % line == 0 and st["stream_bytes"] % line == 0


def _traffic(mod):
    return mod.WorkloadSpec(arrival=mod.Poisson(rate=0.6, duration=7.0),
                            lengths=mod.TableLengths("light", scale=0.03),
                            name="parity")


def test_serve_open_loop_matches_reference(setup):
    """``api.serve`` open-loop, requests built by ``RequestSource`` with
    ``default_extras``: the patches and prompt tokens differ by design
    (numpy draws), so latencies and stats are compared."""
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
    assert all(r.extra["patch_embeds"].shape == (1, 8, cfg.d_model)
               for r in rep_t.finished)


def test_launch_serve_runs_on_the_cpu(capsys):
    rc = tlserve.main(["--arch", ARCH, "--instances", "2", "--requests",
                       "3", "--slots", "4", "--kv-capacity", "64",
                       "--scale", "0.02", "--max-steps", "300",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert f"serving {ARCH}" in out and "device=cpu" in out
    assert "stats:" in out
