"""The port's multi-head latent attention (deepseek-v3-671b) held against the
JAX package's on the CPU.

Reduced deepseek-v3-671b in f32: two layers (a dense FFN layer, then an
MoE layer with 4 experts top-2 and one shared expert), MLA with q/kv rank
64, qk nope 32 + rope 32, v 64.  The JAX package's random weights go
through numpy into the port (``params_from_numpy``), the same inputs
(numpy, seeded) go through both.  Tolerance 1e-4 max abs in f32 on
activations, logits and states (the packages sum in different orders);
tokens, host syncs, traces, stats, ledger and mirror/stream bytes must be
equal exactly.  MLA computes outside any kernel in both packages, so no
kernel of the port may launch or run its plain version on these paths.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
import repro.kvstore as rkv
import repro.models as rm
import repro.scheduling.registry as rreg
import repro.sim as rsim
import repro.workloads as rwl
from repro.core import kvbytes as r_kvbytes
from repro.kvstore.paged import _gather_rows
from repro.models import attention as r_attn
from repro.scheduling.live import LiveCluster as RLiveCluster
from repro.serving import InstanceEngine as REngine
from repro.serving import Request as RRequest
from repro.stepplan import PrefillItem as RPrefillItem
from repro.stepplan import PrefillPlan as RPrefillPlan
import repro_torch.configs as tcfg
import repro_torch.kvstore as tkv
import repro_torch.models as tm
import repro_torch.scheduling.registry as treg
import repro_torch.sim as tsim
import repro_torch.workloads as twl
from repro_torch.bridge import params_from_numpy
from repro_torch.core import kvbytes as t_kvbytes
from repro_torch.kernels import read_counts, reset_counts
from repro_torch.models import attention as t_attn
from repro_torch.models.attention import PagedDecode
from repro_torch.models.model import forward_mtp
from repro_torch.scheduling.live import LiveCluster
from repro_torch.serving import InstanceEngine, Request
from repro_torch.stepplan import PrefillItem, PrefillPlan

ARCH = "deepseek-v3-671b"
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
    if isinstance(tree, dict):
        return {k: _at0(v) for k, v in tree.items()}
    return tree[0]


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _cut(cfg, n, **kw):
    return dataclasses.replace(cfg, num_layers=n,
                               block_pattern=cfg.block_pattern[:n], **kw)


@pytest.fixture(scope="module")
def setup():
    cfg_r = rcfg.get_config(ARCH).reduced()
    cfg = tcfg.get_config(ARCH).reduced()
    params_r = rm.init_params(jax.random.PRNGKey(0), cfg_r)
    params = params_from_numpy(_np_tree(params_r), device="cpu")
    return cfg_r, cfg, params_r, params


@pytest.fixture(autouse=True)
def no_kernel_runs():
    """MLA never reaches a kernel of the port nor its plain version."""
    reset_counts()
    yield
    for name, c in read_counts().items():
        assert c == {"launches": 0, "plain_calls": 0}, name


# ---------------------------------------------------------------------------
# configuration, parameter tree, state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_config_equal_field_by_field(reduced):
    a, b = rcfg.get_config(ARCH), tcfg.get_config(ARCH)
    if reduced:
        a, b = a.reduced(), b.reduced()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(a.mla) == dataclasses.asdict(b.mla)
    assert dataclasses.asdict(a.moe) == dataclasses.asdict(b.moe)
    assert a.mla.qk_head_dim == b.mla.qk_head_dim
    assert a.param_count() == b.param_count()
    assert (dataclasses.asdict(rkv.LineCosts.from_config(a))
            == dataclasses.asdict(tkv.LineCosts.from_config(b)))
    assert (r_kvbytes.state_bytes_at(a, 517)
            == t_kvbytes.state_bytes_at(b, 517))


def test_depth_cut_keeps_published_widths():
    """The card's cuts: layers 0-3 (three dense layers, then the first
    256-expert MoE layer) with the MTP head, ~30.9 GB in bf16, a latent
    line of 4 x 1,152 bytes; and the f32 consistency cut of one dense and
    one MoE layer, ~57 GB."""
    full = tcfg.get_config(ARCH)
    four = _cut(full, 4)
    assert [four.layer_is_moe(i) for i in range(4)] == [False] * 3 + [True]
    assert (four.d_model, four.num_heads, four.d_ff, four.vocab_size,
            four.moe.num_experts, four.moe.top_k,
            four.moe.num_shared_experts) == (7168, 128, 2048, 129280, 256,
                                              8, 1)
    assert tkv.LineCosts.from_config(four).line_bytes == 4 * 1152 == 4608
    assert 30.0e9 < 2 * four.param_count() < 30.5e9
    two = _cut(full, 2, dtype="float32", moe=dataclasses.replace(
        full.moe, first_dense_layers=1, capacity_factor=32.0))
    assert [two.layer_is_moe(i) for i in range(2)] == [False, True]
    assert 55e9 < 4 * two.param_count() < 57e9
    assert four.param_count() == _cut(rcfg.get_config(ARCH), 4).param_count()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_tree_with_mtp(dtype):
    """With ``mtp_depth = 1`` forced on both sides the port draws the JAX
    package's tree (the ``mtp`` head included) with its shapes and
    dtypes, at its scales."""
    cfg_r = dataclasses.replace(rcfg.get_config(ARCH).reduced(), dtype=dtype,
                                mtp_depth=1)
    cfg_t = dataclasses.replace(tcfg.get_config(ARCH).reduced(), dtype=dtype,
                                mtp_depth=1)
    ref = list(_paths(_np_tree(rm.init_params(jax.random.PRNGKey(1),
                                              cfg_r))))
    own = list(_paths(tm.init_params(cfg_t, torch.Generator().manual_seed(1),
                                     device="cpu")))
    assert [p for p, _ in own] == [p for p, _ in ref]
    assert any(p.startswith("/mtp/layer/mixer/wkv_b") for p, _ in own)
    for (path, a), (_, b) in zip(ref, own):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(b.dtype).split(".")[-1] == a.dtype.name, path
    leaf = dict(own)
    m = cfg_t.mla
    assert abs(float(leaf["/segments/0/p0/mixer/wkv_b"].float().std())
               - m.kv_lora_rank ** -0.5) < 1e-2
    assert float(leaf["/mtp/norm"].float().min()) == 1.0
    assert (sum(int(np.prod(a.shape)) for _, a in ref)
            == sum(b.numel() for _, b in own))


def test_state_layout_and_bytes(setup):
    cfg_r, cfg, _, _ = setup
    st_r = list(_paths(_np_tree(rm.init_state(cfg_r, 3, 32))))
    st_t = list(_paths(tm.init_state(cfg, 3, 32, device="cpu")))
    assert [p for p, _ in st_r] == [p for p, _ in st_t]
    assert sorted({p.split("/")[-1] for p, _ in st_t}) == ["c_kv", "k_rope"]
    for (path, a), (_, b) in zip(st_r, st_t):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(b.dtype).split(".")[-1] == a.dtype.name, path
    store = tkv.PagedStore(cfg, 3, 32, device="cpu")
    assert {p[2]: p[3] for p in store._paths} == {"c_kv": "line",
                                                  "k_rope": "line"}


# ---------------------------------------------------------------------------
# the attention modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq,skv,kvh,hd,dv,causal,window,q_offset", [
    (24, 24, 4, 16, 8, True, None, 0),      # 3 q chunks x 3 kv chunks
    (16, 40, 4, 16, 16, True, None, 24),    # a resume: 24 cached rows
    (24, 24, 2, 16, 16, True, 10, 0),       # GQA (G = 2), windowed bands
    (8, 24, 4, 12, 20, False, None, 0),     # non-causal, dv > hd
])
def test_chunked_attention_matches_reference(sq, skv, kvh, hd, dv, causal,
                                             window, q_offset):
    """The plain chunked online softmax at 8-row q and kv chunks, so the
    bands, the block skip and the windowed lower bound all run."""
    q, k, v = (_x(1, (2, sq, 4, hd)), _x(2, (2, skv, kvh, hd)),
               _x(3, (2, skv, kvh, dv)))
    kw = dict(causal=causal, scale=hd ** -0.5, window=window,
              q_offset=q_offset, q_chunk=8, kv_chunk=8)
    want = r_attn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw)
    got = t_attn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), **kw)
    assert tuple(got.shape) == (2, sq, 4, dv)
    assert _err(got, want) < TOL


def test_mla_forward_full_history_decode(setup):
    """One layer's MLA: a 12-token prefill into a 24-line cache, a 6-token
    chunk resumed at history 12 (the latent rows expanded through
    ``wkv_b``), then three absorbed decode steps at per-request clocks;
    outputs and the latent cache after each."""
    cfg_r, cfg, params_r, params = setup
    p_r = jax.tree_util.tree_map(lambda a: a[0],
                                 params_r["segments"][0]["p0"]["mixer"])
    p_t = _at0(params["segments"][0]["p0"]["mixer"])
    st_r = jax.tree_util.tree_map(lambda a: a[0],
                                  rm.init_state(cfg_r, 2, 24)["layers"][0]
                                  ["p0"])
    st_t = _at0(tm.init_state(cfg, 2, 24, device="cpu")["layers"][0]["p0"])
    d = cfg.d_model

    ref = jax.jit(functools.partial(r_attn.mla_forward, cfg_r),
                  static_argnames=("mode", "history", "update_cache"))

    def both(x, **kw):
        nonlocal st_r
        pos = kw.pop("positions")
        y_r, st_r = ref(p_r, jnp.asarray(x), positions=jnp.asarray(pos),
                        state=st_r, update_cache=True,
                        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                               else v) for k, v in kw.items()})
        y_t, out = t_attn.mla_forward(cfg, p_t, torch.from_numpy(x),
                                      positions=torch.from_numpy(pos),
                                      state=st_t, update_cache=True,
                                      **{k: (torch.from_numpy(v) if
                                             isinstance(v, np.ndarray)
                                             else v) for k, v in kw.items()})
        assert out is st_t
        assert _err(y_t, y_r) < TOL
        for key in ("c_kv", "k_rope"):
            assert _err(st_t[key], st_r[key]) < TOL, key

    both(_x(4, (2, 12, d)), mode="full", positions=np.arange(12), t=0)
    both(_x(5, (2, 6, d)), mode="full", positions=12 + np.arange(6), t=12,
         history=12)
    t = np.asarray([18, 18], np.int32)
    for i in range(3):
        both(_x(6 + i, (2, 1, d)), mode="decode",
             positions=(t + i)[:, None], t=t + i)


def test_mla_paged_context_and_mtp_raise(setup):
    """MLA decodes through the absorbed dense path: a paged context is a
    caller's error, as the JAX package asserts.  The MTP head is a
    training loss: without one (the reduced config has ``mtp_depth`` 0)
    ``forward_mtp`` gives None, as the JAX package's does;
    ``tests/test_torch_training.py`` holds the head against it."""
    _, cfg, _, params = setup
    st = _at0(tm.init_state(cfg, 1, 16, device="cpu")["layers"][0]["p0"])
    paged = PagedDecode(torch.zeros(1, dtype=torch.int32),
                        torch.zeros((1, 1), dtype=torch.int32), 16)
    with pytest.raises(ValueError, match="absorbed"):
        t_attn.mla_forward(cfg, _at0(params["segments"][0]["p0"]["mixer"]),
                           torch.zeros((1, 1, cfg.d_model)), mode="decode",
                           positions=torch.zeros((1, 1), dtype=torch.int64),
                           state=st, t=torch.zeros(1, dtype=torch.int32),
                           paged=paged)
    assert forward_mtp(cfg, params, {"tokens": torch.zeros(
        (1, 4), dtype=torch.int32)}) is None


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_prefill_chunk_and_decode_logits(setup):
    """A 20-token prompt whole, and in chunks of 8, 8 and 4 (a resume at
    histories 8 and 16), then four greedy decode steps at per-request
    clocks: logits, tokens and the latent cache leaf by leaf."""
    cfg_r, cfg, params_r, params = setup
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 20),
                                              dtype=np.int32)
    lr, st_r = rm.prefill(cfg_r, params_r, {"tokens": jnp.asarray(toks)},
                          rm.init_state(cfg_r, 2, 32))
    lt, st_t = tm.prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
                          tm.init_state(cfg, 2, 32, device="cpu"))
    assert _err(lt, lr) < TOL
    st_c = tm.init_state(cfg, 2, 32, device="cpu")
    for lo, hi in ((0, 8), (8, 16), (16, 20)):
        lc, st_c = tm.prefill_chunk(cfg, params,
                                    torch.from_numpy(toks[:, lo:hi]), st_c,
                                    history=lo)
    assert _err(lc, lr) < TOL
    for a, b in zip(_leaves(st_c), _leaves(st_t)):
        assert _err(a, b) < TOL
    t = np.full(2, 20, np.int32)
    for _ in range(4):
        tok = np.array(lr.argmax(-1), np.int32)[:, None]
        assert np.array_equal(lt.argmax(-1).numpy()[:, None], tok)
        lr, st_r = rm.decode_step(cfg_r, params_r, jnp.asarray(tok), st_r,
                                  jnp.asarray(t))
        lt, st_t = tm.decode_step(cfg, params, torch.from_numpy(tok), st_t,
                                  torch.from_numpy(t))
        assert _err(lt, lr) < TOL
        t = t + 1
    for a, b in zip(_leaves(_np_tree(st_r)), _leaves(st_t)):
        assert _err(b, a) < TOL


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

# ragged; 13 + 5 > 16 = kv_capacity wraps the latent ring
SHAPES = [(7, 5), (13, 5), (3, 6), (9, 4)]


def _prompt(i, plen, vocab):
    return np.random.default_rng(100 + i).integers(0, vocab, (1, plen),
                                                   dtype=np.int32)


def test_engine_matches_repro_engine(setup):
    """A batched prefill plan (the padded bucketed path), then fused dense
    decode: tokens, host syncs and ledger bytes equal the JAX package's
    engine.  An MLA engine chunks and caches prefixes but never pages."""
    cfg_r, cfg, params_r, params = setup
    er = REngine(cfg_r, params_r, num_slots=4, kv_capacity=16)
    et = InstanceEngine(cfg, params, num_slots=4, kv_capacity=16,
                        device="cpu")
    assert et.supports_chunked_prefill and not et.supports_paged_decode
    assert not et.use_paged_decode
    reqs_r = [RRequest(prompt_len=p, max_new_tokens=n,
                       prompt_tokens=_prompt(i, p, cfg.vocab_size))
              for i, (p, n) in enumerate(SHAPES)]
    reqs_t = [Request(prompt_len=p, max_new_tokens=n,
                      prompt_tokens=_prompt(i, p, cfg.vocab_size))
              for i, (p, n) in enumerate(SHAPES)]

    def items(item_cls, reqs):
        return tuple(item_cls(r.rid, r.prompt_len, 0, r.prompt_len, req=r)
                     for r in reqs)

    done_r = er.prefill_batch(RPrefillPlan(0, items(RPrefillItem, reqs_r),
                                           16))
    done_t = et.prefill_batch(PrefillPlan(0, items(PrefillItem, reqs_t), 16))
    assert ([done_r[r.rid] for r in reqs_r]
            == [done_t[r.rid] for r in reqs_t])
    assert er.used_bytes() == et.used_bytes()
    while er.slot_req or et.slot_req:
        assert er.decode_multi(steps=3) == et.decode_multi(steps=3)
        assert er.host_syncs == et.host_syncs
        assert er.used_bytes() == et.used_bytes()
        assert er.free_blocks() == et.free_blocks()
    assert [r.output_tokens for r in reqs_r] == \
        [r.output_tokens for r in reqs_t]


# ---------------------------------------------------------------------------
# the live cluster: mirror, stream, chunk resume, prefix cache
# ---------------------------------------------------------------------------


def _reqs(mod, shapes, vocab, heads):
    """Requests of ``shapes`` (prompt, decode, arrival, prefix group) with
    numpy-seeded prompts; a group's members share its 16-token head."""
    out = []
    for i, (plen, new, arrival, group) in enumerate(shapes):
        toks = np.random.default_rng(500 + i).integers(0, vocab, (1, plen),
                                                       dtype=np.int32)
        kw = {}
        if group is not None:
            toks[0, :16] = heads[group]
            kw = dict(prefix_id=group, prefix_len=16)
        out.append(mod(prompt_len=plen, max_new_tokens=new, rid=i,
                       arrival=arrival, prompt_tokens=toks, **kw))
    return out


_STREAM = [(12, 6, 0.0, None), (20, 8, 0.0, 0), (9, 5, 1.0, None),
           (26, 7, 2.0, 0), (18, 9, 2.0, 1), (22, 4, 4.0, 1),
           (11, 6, 5.0, None), (24, 5, 6.0, 0)]


class _Replay:
    """An open-loop source over fixed requests."""

    def __init__(self, reqs):
        self._reqs, self.concurrency = reqs, None

    def __iter__(self):
        return iter(self._reqs)


@pytest.mark.parametrize("policy,policy_kwargs,prefix_cache", [
    ("accellm", {}, False), ("sarathi", {"chunk_tokens": 16}, False),
    ("accellm", {}, True)])
def test_cluster_matches_reference(setup, policy, policy_kwargs,
                                   prefix_cache):
    """Two instances behind each package's ``LiveCluster``: accellm's
    mirror syncs, promotions and streamed handoffs, sarathi's 16-token
    chunk resumes (latent rows expanded at ``history > 0``), and accellm
    with the prefix cache (latent rows gathered by ``copy_prefix``): equal
    kernel and plan traces, stats (mirror and stream bytes included) and
    tokens."""
    cfg_r, cfg, params_r, params = setup
    heads = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 16),
                                              dtype=np.int32)
    outs = []
    for mod, cls, reg, c, p in ((RRequest, RLiveCluster, rreg, cfg_r,
                                 params_r),
                                (Request, LiveCluster, treg, cfg, params)):
        kw = dict(prefix_cache=prefix_cache, block_lines=8)
        if cls is LiveCluster:
            kw["device"] = "cpu"
        cluster = cls(c, p, 2, 4, 48, reg.get_policy(policy, **policy_kwargs),
                      **kw)
        cluster.policy.trace = []
        cluster.planner.trace = []
        reqs = _reqs(mod, _STREAM, cfg.vocab_size, heads)
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
    assert len(port["finished"]) == len(_STREAM)
    st = port["stats"]
    if policy == "accellm":
        assert st["mirror_syncs"] > 0 and st["mirror_bytes"] > 0
        assert st["stream_bytes"] > 0
    if prefix_cache:
        assert st["prefix_hits"] > 0
    if policy == "sarathi":
        assert any(it[1] > 0 for e in port["plan_trace"]
                   if e[0] in ("prefill", "mixed")
                   for it in e[2][0 if e[0] == "mixed" else slice(None)])


def test_copy_prefix_on_latent_leaves_matches_reference_gather(setup):
    """``copy_prefix`` on the latent leaves (no head axis) moves the rows
    ``repro``'s ``_gather_rows`` moves on one pool, and prices a line at
    ``LineCosts.line_bytes``."""
    cfg_r, cfg, _, _ = setup
    store = tkv.PagedStore(cfg, num_slots=4, kv_capacity=32, block_lines=8,
                           device="cpu")
    store_r = rkv.PagedStore(cfg_r, num_slots=4, kv_capacity=32,
                             block_lines=8)
    rng = np.random.default_rng(0)
    before = {}
    for path in store._paths:
        i, pj, key, _ = path
        leaf = store.state["layers"][i][pj][key]
        assert leaf.dim() == 4, key          # (R, B, W, rank): no head axis
        before[path] = rng.standard_normal(tuple(leaf.shape)).astype(
            np.float32)
        leaf.copy_(torch.as_tensor(before[path]))
        store_r.state["layers"][i][pj][key] = jnp.asarray(before[path])
    blocks, dst, n = [5, 12, 9], 2, 20
    moved = store.copy_prefix(blocks, dst, n)
    assert moved == store_r.copy_prefix(blocks, dst, n) \
        == store.costs.line_bytes * n
    src_slots = np.asarray([blocks[j // 8] // 4 for j in range(n)])
    src_pos = np.asarray([(blocks[j // 8] % 4) * 8 + j % 8 for j in range(n)])
    for path in store._paths:
        i, pj, key, _ = path
        got = store.state["layers"][i][pj][key].numpy()
        assert np.array_equal(
            got, np.asarray(store_r.state["layers"][i][pj][key])), path
        want = _gather_rows(jnp.asarray(before[path]), dst, src_slots,
                            src_pos, np.arange(n))
        assert np.array_equal(got, np.asarray(want)), path


def test_mirror_copies_only_new_latent_lines(setup):
    """``copy_lines`` moves the latent rows of the new lines only, across
    the ring edge, and prices them as ``mirror_bytes``."""
    _, cfg, _, _ = setup
    a = tkv.PagedStore(cfg, 2, 16, device="cpu")
    b = tkv.PagedStore(cfg, 2, 16, device="cpu")
    for path in a._paths:
        leaf = a._leaf(a.state, path)
        leaf.copy_(torch.randn(leaf.shape, generator=torch.Generator()
                               .manual_seed(len(path[2]))))
    assert b.copy_lines(a, 0, 1, 15, 19) == a.costs.mirror_bytes(4)
    for path in a._paths:
        src, dst = a._leaf(a.state, path), b._leaf(b.state, path)
        rows = [14, 15, 0, 1]                # accounting lines 15..18
        assert torch.equal(dst[:, 1, rows], src[:, 0, rows])
        others = [r for r in range(16) if r not in rows]
        assert float(dst[:, 1, others].abs().max()) == 0.0
        assert float(dst[:, 0].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------


def _sim_summary(sim_mod, wl, cfgs, arch, n_devices):
    pol = sim_mod.AcceLLMPolicy()
    pol.kernel.trace = []
    perf = sim_mod.PerfModel(cfgs.get_config(arch),
                             sim_mod.InstanceSpec(sim_mod.H100, n_devices))
    sim = sim_mod.Simulator(pol, perf, n_instances=4)
    spec = wl.WorkloadSpec(
        arrival=wl.Bursty(rate_on=12.0, duration=10.0, rate_off=2.0,
                          mean_on=6.0, mean_off=4.0),
        lengths=wl.TableLengths(workload="mixed"), name="bursty")
    sim.run(source=spec.source(seed=0), horizon=500.0)
    summary = dataclasses.asdict(sim_mod.summarize(
        sim.submitted, n_instances=4, duration=sim.now))
    summary.pop("sched_us_per_iter")          # the host's wall clock
    return {"summary": {k: (None if isinstance(v, float) and np.isnan(v)
                            else v) for k, v in summary.items()},
            "trace": pol.kernel.trace, "now": sim.now,
            "kv_capacity_bytes": perf.kv_capacity_bytes,
            "line_costs": dataclasses.asdict(perf.line_costs)}


def test_simulator_summary_matches_reference():
    """deepseek-v3-671b at full width on 32 modeled H100s per instance (its
    weights need more than 16): the port's simulator gives the JAX
    package's summary and decision trace."""
    ref = _sim_summary(rsim, rwl, rcfg, ARCH, 32)
    port = _sim_summary(tsim, twl, tcfg, ARCH, 32)
    assert port == ref
    assert port["summary"]["n_finished"] > 0 and len(port["trace"]) > 20
