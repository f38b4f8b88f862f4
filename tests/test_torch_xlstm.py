"""The port's xLSTM stack (xlstm-1.3b) held against the JAX package's on the
CPU.

Reduced xlstm-1.3b in f32: two layers (an mLSTM block, then an sLSTM
block), d_model 256, 4 heads; the mLSTM's matrix memory is (4, 128, 128)
per request.  The JAX package's random weights go through numpy into the
port (``params_from_numpy``), the same inputs (numpy, seeded) go through
both.  Tolerance 1e-4 max abs in f32 on outputs, logits and states (the
recurrences carry the rounding over every step); tokens, host syncs,
traces, stats and mirror bytes must be equal exactly.  Both blocks
compute outside any kernel in both packages, so no kernel of the port may
launch or run its plain version on these paths.
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
from repro.models import xlstm as r_xlstm
from repro.scheduling.live import LiveCluster as RLiveCluster
from repro.serving import InstanceEngine as REngine
from repro.serving import Request as RRequest
import repro_torch.configs as tcfg
import repro_torch.kvstore as tkv
import repro_torch.models as tm
import repro_torch.scheduling.registry as treg
import repro_torch.sim as tsim
import repro_torch.workloads as twl
from repro_torch.bridge import params_from_numpy, state_from_numpy
from repro_torch.core import kvbytes as t_kvbytes
from repro_torch.kernels import read_counts, reset_counts
from repro_torch.models import xlstm as t_xlstm
from repro_torch.scheduling.live import LiveCluster
from repro_torch.serving import InstanceEngine, Request

ARCH = "xlstm-1.3b"
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


@pytest.fixture(scope="module")
def setup():
    cfg_r = rcfg.get_config(ARCH).reduced()
    cfg = tcfg.get_config(ARCH).reduced()
    params_r = rm.init_params(jax.random.PRNGKey(0), cfg_r)
    params = params_from_numpy(_np_tree(params_r), device="cpu")
    return cfg_r, cfg, params_r, params


@pytest.fixture(autouse=True)
def no_kernel_runs():
    """xLSTM never reaches a kernel of the port nor its plain version."""
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
    assert dataclasses.asdict(a.xlstm) == dataclasses.asdict(b.xlstm)
    assert a.block_pattern == b.block_pattern
    assert a.param_count() == b.param_count()
    assert (dataclasses.asdict(rkv.LineCosts.from_config(a))
            == dataclasses.asdict(tkv.LineCosts.from_config(b)))
    assert (r_kvbytes.state_bytes_at(a, 517)
            == t_kvbytes.state_bytes_at(b, 517))
    if not reduced:                      # xLSTM[7:1], no KV lines
        assert b.block_pattern.count("slstm") == 6 and b.num_layers == 48
        assert tkv.LineCosts.from_config(b).line_bytes == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_tree_and_state_layout(dtype):
    """The port's own draw has the JAX package's tree, shapes and per-leaf
    dtypes (the gate leaves in f32), at its scales; the state's leaves are
    all f32, as are the bridge's under a cast."""
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
    mixer = dict(_paths(tm.init_params(
        cfg_t, torch.Generator().manual_seed(1), device="cpu")))
    assert float(mixer["/segments/0/p0/mixer/b_f"].min()) == 3.0
    assert abs(float(mixer["/segments/0/p0/mixer/w_f"].std()) - 0.01) < 2e-3
    cast = params_from_numpy(_np_tree(rm.init_params(jax.random.PRNGKey(1),
                                                     cfg_r)), device="cpu",
                             dtype=torch.bfloat16)
    for key in ("w_i", "b_i", "w_f", "b_f", "w_o"):
        assert cast["segments"][0]["p0"]["mixer"][key].dtype == torch.float32
    assert cast["segments"][1]["p0"]["mixer"]["b"].dtype == torch.float32
    st = state_from_numpy(_np_tree(rm.init_state(cfg_r, 2, 8)), device="cpu",
                          dtype=torch.bfloat16)
    assert {x.dtype for x in _leaves(st)} == {torch.float32}
    store = tkv.PagedStore(cfg_t, 3, 32, device="cpu")
    assert {p[3] for p in store._paths} == {"recurrent"}


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------


def _block(params_r, params, j):
    """Layer ``j``'s mixer (each layer is a segment of its own here)."""
    return (jax.tree_util.tree_map(lambda a: a[0],
                                   params_r["segments"][j]["p0"]["mixer"]),
            _at0(params["segments"][j]["p0"]["mixer"]))


def _block_state(cfg_r, cfg, j, batch):
    st_r = jax.tree_util.tree_map(
        lambda a: a[0], rm.init_state(cfg_r, batch, 8)["layers"][j]["p0"])
    st_t = _at0(tm.init_state(cfg, batch, 8, device="cpu")["layers"][j]
                ["p0"])
    return st_r, st_t


@pytest.mark.parametrize("j,forward", [(0, "mlstm_forward"),
                                       (1, "slstm_forward")])
def test_block_full_then_decode(setup, j, forward):
    """Each block: a 128-token prefill (the mLSTM's chunkwise path: two
    64-token chunks), a 5-token one from that state (the stepwise path),
    then three decode steps; outputs and every state leaf after each."""
    cfg_r, cfg, params_r, params = setup
    p_r, p_t = _block(params_r, params, j)
    st_r, st_t = _block_state(cfg_r, cfg, j, 2)
    fr = jax.jit(functools.partial(getattr(r_xlstm, forward), cfg_r),
                 static_argnames=("mode", "update_cache"))
    ft = functools.partial(getattr(t_xlstm, forward), cfg)
    for i, (mode, S) in enumerate([("full", 128), ("full", 5), ("decode", 1),
                                   ("decode", 1), ("decode", 1)]):
        x = _x(20 + i, (2, S, cfg.d_model))
        y_r, st_r = fr(p_r, jnp.asarray(x), mode=mode, state=st_r,
                       update_cache=True)
        y_t, out = ft(p_t, torch.from_numpy(x), mode=mode, state=st_t,
                      update_cache=True)
        assert out is st_t
        assert _err(y_t, y_r) < TOL, (mode, S)
        for key in st_t:
            assert _err(st_t[key], st_r[key]) < TOL, (mode, S, key)


def test_mlstm_chunkwise_matches_stepwise(setup):
    """The chunkwise-parallel mLSTM over 192 tokens (three chunks) from a
    nonzero state equals the stabilized step-by-step recurrence: outputs
    and the carried (C, n, m)."""
    _, cfg, _, params = setup
    p_t = _at0(params["segments"][0]["p0"]["mixer"])
    x = torch.from_numpy(_x(30, (2, 192, cfg.d_model)))
    q, k, v, i_pre, f_pre, _, _ = t_xlstm._mlstm_qkvif(cfg, p_t, x)
    h, hd = cfg.num_heads, q.shape[-1]
    g = torch.Generator().manual_seed(0)
    carry0 = (torch.randn((2, h, hd, hd), generator=g) * 0.1,
              torch.randn((2, h, hd), generator=g) * 0.1,
              torch.randn((2, h), generator=g))
    carry_c, h_c = t_xlstm._mlstm_chunkwise(q, k, v, i_pre, f_pre, carry0,
                                            t_xlstm.MLSTM_CHUNK)
    carry, outs = carry0, []
    for s in range(192):
        carry, h_t = t_xlstm._mlstm_step(q[:, s], k[:, s], v[:, s],
                                         i_pre[:, s], f_pre[:, s], carry)
        outs.append(h_t)
    assert _err(h_c, torch.stack(outs, dim=1)) < TOL
    # the carried state is exp(-m)-scaled: compare C and n at one scale
    for a, b in ((carry_c[0] * torch.exp(carry_c[2])[..., None, None],
                  carry[0] * torch.exp(carry[2])[..., None, None]),
                 (carry_c[1] * torch.exp(carry_c[2])[..., None],
                  carry[1] * torch.exp(carry[2])[..., None])):
        assert _err(a, b) / float(b.abs().max()) < TOL
    assert _err(carry_c[2], carry[2]) < TOL


# ---------------------------------------------------------------------------
# the model and the engine
# ---------------------------------------------------------------------------


def test_prefill_and_decode_logits(setup):
    cfg_r, cfg, params_r, params = setup
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 13),
                                              dtype=np.int32)
    lr, st_r = rm.prefill(cfg_r, params_r, {"tokens": jnp.asarray(toks)},
                          rm.init_state(cfg_r, 2, 32))
    lt, st_t = tm.prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
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
    for a, b in zip(_leaves(_np_tree(st_r)), _leaves(st_t)):
        assert _err(b, a) < TOL


SHAPES = [(5, 10), (12, 7), (9, 4)]


def _prompt(i, plen, vocab):
    return np.random.default_rng(100 + i).integers(0, vocab, (1, plen),
                                                   dtype=np.int32)


@pytest.mark.parametrize("steps", [1, 4])
def test_engine_matches_repro_engine(setup, steps):
    """One prompt at a time, then dense decode over every slot, sequential
    and fused: tokens, host syncs and ledger bytes equal the JAX package's
    engine.  An xLSTM engine neither pages nor chunks."""
    cfg_r, cfg, params_r, params = setup
    er = REngine(cfg_r, params_r, num_slots=4, kv_capacity=16)
    et = InstanceEngine(cfg, params, num_slots=4, kv_capacity=16,
                        device="cpu")
    assert not (et.supports_paged_decode or et.supports_chunked_prefill)
    for i, (p, n) in enumerate(SHAPES):
        rr = RRequest(prompt_len=p, max_new_tokens=n,
                      prompt_tokens=_prompt(i, p, cfg.vocab_size))
        rt = Request(prompt_len=p, max_new_tokens=n,
                     prompt_tokens=_prompt(i, p, cfg.vocab_size))
        assert er.prefill_request(rr) == et.prefill_request(rt)
        assert er.used_bytes() == et.used_bytes() > 0
    while er.slot_req or et.slot_req:
        assert er.decode_multi(steps=steps) == et.decode_multi(steps=steps)
        assert er.host_syncs == et.host_syncs
        assert er.used_bytes() == et.used_bytes()
        assert er.free_blocks() == et.free_blocks()


def test_mirror_sync_moves_the_whole_recurrent_state(setup):
    """A replica follows a request by mirror syncs: each moves the whole
    recurrent state (no KV line) and leaves the replica's state equal to
    the primary's; after promotion the tokens equal a run with no
    handoff."""
    _, cfg, _, params = setup

    def engine(i=0):
        return InstanceEngine(cfg, params, num_slots=2, kv_capacity=16,
                              instance_id=i, device="cpu")

    def req():
        return Request(prompt_len=9, max_new_tokens=12,
                       prompt_tokens=_prompt(7, 9, cfg.vocab_size))

    control, req_c = engine(), req()
    assert control.prefill_request(req_c) == 0
    while control.slot_req:
        control.decode()
    a, b, r = engine(0), engine(1), req()
    sa = a.prefill_request(r)
    assert sa == 0
    b.import_slot(0, a.export_slot(sa), r, as_replica_of=(0, sa))
    costs = b.store.costs
    assert costs.line_bytes == 0 and costs.mirror_bytes(1) \
        == costs.recurrent_bytes > 0
    for _ in range(5):
        a.decode()
        assert b.sync_replica_from(a, sa, 0) == costs.recurrent_bytes
        for x, y in zip(_leaves(a.store.extract_slot(sa)),
                        _leaves(b.store.extract_slot(0))):
            assert torch.equal(x, y)
    a.demote_to_replica(sa, (1, 0))
    b.promote_replica(0, r)
    while b.slot_req:
        b.decode()
    assert r.output_tokens == req_c.output_tokens


# ---------------------------------------------------------------------------
# the live cluster and the simulator
# ---------------------------------------------------------------------------


class _Replay:
    """An open-loop source over fixed requests."""

    def __init__(self, reqs):
        self._reqs, self.concurrency = reqs, None

    def __iter__(self):
        return iter(self._reqs)


_STREAM = [(12, 6, 0.0), (20, 8, 0.0), (9, 5, 1.0), (16, 7, 2.0),
           (7, 9, 3.0), (14, 4, 5.0)]


def test_cluster_recurrent_mirror_matches_reference(setup):
    """Two instances under accellm: the recurrent states mirrored whole
    every step and streamed at handoff; equal kernel and plan traces,
    stats (mirror and stream bytes included) and tokens."""
    cfg_r, cfg, params_r, params = setup
    outs = []
    for mod, cls, reg, c, p in ((RRequest, RLiveCluster, rreg, cfg_r,
                                 params_r),
                                (Request, LiveCluster, treg, cfg, params)):
        kw = {"device": "cpu"} if cls is LiveCluster else {}
        cluster = cls(c, p, 2, 4, 32, reg.get_policy("accellm"), **kw)
        cluster.policy.trace = []
        cluster.planner.trace = []
        reqs = [mod(prompt_len=pl, max_new_tokens=n, rid=i, arrival=a,
                    prompt_tokens=_prompt(50 + i, pl, cfg.vocab_size))
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
    rec = tkv.LineCosts.from_config(cfg).recurrent_bytes
    assert st["mirror_bytes"] == st["mirror_syncs"] * rec


def test_simulator_summary_matches_reference():
    """xlstm-1.3b at full width on one modeled H100 per instance: the port's
    simulator gives the JAX package's summary and decision trace."""
    outs = []
    for sim_mod, wl, cfgs in ((rsim, rwl, rcfg), (tsim, twl, tcfg)):
        pol = sim_mod.AcceLLMPolicy()
        pol.kernel.trace = []
        perf = sim_mod.PerfModel(cfgs.get_config(ARCH),
                                 sim_mod.InstanceSpec(sim_mod.H100, 1))
        sim = sim_mod.Simulator(pol, perf, n_instances=4)
        spec = wl.WorkloadSpec(
            arrival=wl.Bursty(rate_on=12.0, duration=10.0, rate_off=2.0,
                              mean_on=6.0, mean_off=4.0),
            lengths=wl.TableLengths(workload="mixed"), name="bursty")
        sim.run(source=spec.source(seed=0), horizon=500.0)
        summary = dataclasses.asdict(sim_mod.summarize(
            sim.submitted, n_instances=4, duration=sim.now))
        summary.pop("sched_us_per_iter")          # the host's wall clock
        outs.append({"summary": {k: (None if isinstance(v, float)
                                     and np.isnan(v) else v)
                                 for k, v in summary.items()},
                     "trace": pol.kernel.trace, "now": sim.now,
                     "line_costs": dataclasses.asdict(perf.line_costs)})
    assert outs[1] == outs[0]
    assert outs[1]["summary"]["n_finished"] > 0
