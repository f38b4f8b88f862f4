"""The port's scale layer held against the JAX package's and against its
own scalar kernels.

``repro_torch.scale`` is a copy of ``repro.scale``: the array-backed
cluster state the simulator attaches for a kernel that declares
``vectorized = True``, and the four ``-vec`` kernels.  Case for case of
``tests/test_scale.py``, on the llama2-70b ``PerfModel`` and the reduced
starcoder2-3b (the JAX package's weights bridged through numpy):

* in the simulator, each ``-vec`` kernel makes the decisions of its
  scalar kernel and of ``repro``'s ``-vec`` kernel, event for event, with
  equal request outcomes, on the reference's bursty stream, and on a
  shared-prefix stream with the prefix cache on;
* on the live executor there is no array state, so each ``-vec`` kernel
  falls back to its scalar parent: equal traces to the scalar kernel and
  to ``repro``'s ``-vec`` under all four policies;
* the ULB kernel's routing rules and its live-vs-sim golden trace;
* the simulator's and the live cluster's timeline stride, and the
  ledger's O(1) used bytes.
"""
import jax
import numpy as np
import pytest

import repro.configs as rcfg
import repro.models as rm
import repro.scheduling.registry as rreg
import repro.sim as rsim
import repro.workloads as rwl
from repro.scheduling.live import LiveCluster as RLiveCluster
from repro.serving import Request as RRequest
import repro_torch.api as tapi
import repro_torch.configs as tcfg
import repro_torch.kvstore as tkv
import repro_torch.scale as tscale
import repro_torch.scheduling.registry as treg
import repro_torch.sim as tsim
import repro_torch.workloads as twl
from repro_torch.bridge import params_from_numpy
from repro_torch.scheduling.live import LiveCluster
from repro_torch.serving import Request
from repro_torch.sim.workload import SimRequest

# (simulator, workloads, configs, registry) per package
_REF = (rsim, rwl, rcfg, rreg)
_PORT = (tsim, twl, tcfg, treg)

_POLICIES = {
    "accellm": lambda s, k: s.AcceLLMPolicy(kernel=k),
    "vllm": lambda s, k: s.VLLMPolicy(kernel=k),
    "ulb": lambda s, k: s.ULBPolicy(kernel=k),
    "splitwise": lambda s, k: s.SplitwisePolicy(1, kernel=k),
}


def _kernel(reg, name):
    kw = {"n_prefill": 1} if name.startswith("splitwise") else {}
    return reg.get_policy(name, **kw)


def _spec(wl, reuse=False):
    return wl.WorkloadSpec(
        arrival=wl.Bursty(rate_on=12.0, duration=40.0, rate_off=2.0,
                          mean_on=6.0, mean_off=4.0),
        lengths=wl.TableLengths(workload="mixed"), name="bursty",
        prefix_reuse=(wl.PrefixReuse(pool=4, reuse=0.7, prefix_len=256)
                      if reuse else None))


def _simulate(pkg, policy, name, reuse=False, **kw):
    sim_mod, wl, cfgs, reg = pkg
    kernel = _kernel(reg, name)
    kernel.trace = []
    perf = sim_mod.PerfModel(cfgs.get_config("llama2-70b"),
                             sim_mod.InstanceSpec(sim_mod.H100, 4))
    sim = sim_mod.Simulator(_POLICIES[policy](sim_mod, kernel), perf,
                            n_instances=4, prefix_cache=reuse, **kw)
    sim.run(source=_spec(wl, reuse).source(seed=0), horizon=500.0)
    return kernel.trace, sim


def _fingerprint(sim):
    return [(r.rid, r.generated, r.finish_time)
            for r in sorted(sim.submitted, key=lambda r: r.rid)]


# ---------------------------------------------------------------------------
# the simulator: array-backed kernels == dict-backed kernels == repro's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", sorted(_POLICIES))
def test_vectorized_kernel_identical_decisions_sim(policy):
    tr_s, sim_s = _simulate(_PORT, policy, policy)
    tr_v, sim_v = _simulate(_PORT, policy, f"{policy}-vec")
    tr_r, sim_r = _simulate(_REF, policy, f"{policy}-vec")
    assert len(tr_s) > 50, "trace must exercise real scheduling"
    assert sim_v.policy.arrays is not None and sim_s.policy.arrays is None
    assert tr_v == tr_s
    assert tr_v == tr_r
    assert _fingerprint(sim_v) == _fingerprint(sim_s) == _fingerprint(sim_r)
    assert sim_v.n_iterations == sim_r.n_iterations


def test_vectorized_kernel_identical_decisions_sim_prefix_cache():
    """With the prefix cache on (stamps, adoption, shared runs in the
    array state's byte sums), accellm-vec still decides as accellm, and
    as the reference's accellm-vec."""
    tr_s, sim_s = _simulate(_PORT, "accellm", "accellm", reuse=True)
    tr_v, sim_v = _simulate(_PORT, "accellm", "accellm-vec", reuse=True)
    tr_r, sim_r = _simulate(_REF, "accellm", "accellm-vec", reuse=True)
    hits = sum(i.prefix_cache.stats["hits"] for i in sim_v.instances)
    assert hits > 0
    assert tr_v == tr_s == tr_r
    assert _fingerprint(sim_v) == _fingerprint(sim_s) == _fingerprint(sim_r)
    assert [i.prefix_cache.stats for i in sim_v.instances] == \
        [i.prefix_cache.stats for i in sim_r.instances]


def test_vectorized_kernel_reports_sched_speed():
    _, sim = _simulate(_PORT, "accellm", "accellm-vec")
    assert sim.n_iterations > 100
    assert sim.sched_us_per_iter > 0.0
    assert sim.instances[0].state_bytes() == \
        sim.policy.arrays.recs[0].state_bytes()


def test_scale_exports_and_registry():
    """The lazy exports of ``repro_torch.scale`` and the registry's names
    equal the reference's."""
    assert treg.policy_names() == rreg.policy_names()
    for name in ("ArrayClusterState", "ArrayClusterView", "ArrayInstanceView",
                 "VectorAcceLLMScheduler", "VectorVLLMScheduler",
                 "VectorSplitwiseScheduler", "VectorULBScheduler"):
        assert getattr(tscale, name).__name__ == name
    with pytest.raises(AttributeError):
        tscale.nope
    for name in treg.policy_names():
        assert getattr(_kernel(treg, name), "vectorized", False) == \
            name.endswith("-vec")


# ---------------------------------------------------------------------------
# the live executor: vec kernels fall back to their scalar parents
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def live_setup():
    cfg_r = rcfg.get_config("starcoder2-3b").reduced()
    cfg = tcfg.get_config("starcoder2-3b").reduced()
    params_r = rm.init_params(jax.random.PRNGKey(0), cfg_r)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, params_r),
                               device="cpu")
    return cfg_r, cfg, params_r, params


_LIVE = [(8, 4), (12, 6), (6, 5), (10, 3), (7, 6), (9, 4)]


def _toks(i, plen, vocab):
    return np.random.default_rng(900 + i).integers(0, vocab, (1, plen),
                                                   dtype=np.int32)


def _run_live(cluster_cls, req_cls, cfg, params, kernel, **kw):
    kernel.trace = []
    cluster = cluster_cls(cfg, params, 2, 8, 256, kernel, **kw)
    for i, (plen, dlen) in enumerate(_LIVE):
        cluster.submit(req_cls(prompt_len=plen, max_new_tokens=dlen, rid=i,
                               prompt_tokens=_toks(i, plen, cfg.vocab_size)))
        cluster.step()
    steps = 0
    while cluster.pending() and steps < 60:
        cluster.step()
        steps += 1
    assert not cluster.pending()
    return kernel.trace, cluster


@pytest.mark.parametrize("policy", sorted(_POLICIES))
def test_vectorized_kernel_identical_decisions_live(live_setup, policy):
    """On the live backend there is no array state, so the vectorized
    kernels take the scalar path: the port's ``-vec`` trace equals its
    scalar kernel's and the reference's ``-vec``, with equal tokens."""
    cfg_r, cfg, params_r, params = live_setup
    tr_s, cl_s = _run_live(LiveCluster, Request, cfg, params,
                           _kernel(treg, policy), device="cpu")
    tr_v, cl_v = _run_live(LiveCluster, Request, cfg, params,
                           _kernel(treg, f"{policy}-vec"), device="cpu")
    tr_r, cl_r = _run_live(RLiveCluster, RRequest, cfg_r, params_r,
                           _kernel(rreg, f"{policy}-vec"))
    assert tr_s, "live trace must not be empty"
    assert tr_v == tr_s == tr_r
    assert cl_v.n_iterations == cl_s.n_iterations == cl_r.n_iterations
    assert cl_v.stats == cl_r.stats
    assert [r.output_tokens for r in cl_v.finished] == \
        [list(map(int, r.output_tokens)) for r in cl_r.finished]
    assert cl_s.sched_us_per_iter > 0.0


# ---------------------------------------------------------------------------
# ULB: least outstanding work in tokens
# ---------------------------------------------------------------------------


class _FakeInst:
    def __init__(self, index, backlog, remaining, admit=True):
        self.index = index
        self._backlog = backlog
        self._remaining = remaining
        self._admit = admit

    def alive(self):
        return True

    def draining(self):
        return False

    def can_admit(self, req):
        return self._admit

    def can_queue(self):
        return True

    def prefill_backlog_tokens(self):
        return self._backlog

    def decode_remaining(self):
        return dict(enumerate(self._remaining))


class _FakeCluster:
    def __init__(self, insts):
        self._insts = insts

    def instances(self):
        return self._insts


class _FakeReq:
    rid = 77


@pytest.mark.parametrize("insts,want", [
    ([(0, 500, [10], True), (1, 0, [40, 50, 60], True)], 1),
    ([(0, 100, [20], True), (1, 0, [120], True)], 0),
    ([(0, 0, [5], False), (1, 0, [900], True)], 1),
], ids=["least_outstanding_work", "tie_breaks_by_index",
        "prefers_admittable"])
def test_ulb_routes_like_reference(insts, want):
    cluster = _FakeCluster([_FakeInst(*i) for i in insts])
    for name in ("ulb", "ulb-vec"):
        got = treg.get_policy(name).route(cluster, _FakeReq())
        assert got == rreg.get_policy(name).route(cluster, _FakeReq()) \
            == want


def test_ulb_runs_end_to_end_on_sim():
    trace, sim = _simulate(_PORT, "ulb", "ulb")
    assert {e[0] for e in trace} == {"route"}
    assert all(r.finish_time is not None for r in sim.submitted)


_ULB_SCRIPT = [("arrive", 8, 4), ("tick",), ("arrive", 12, 6), ("tick",),
               ("arrive", 6, 5), ("arrive", 10, 3), ("tick",),
               ("arrive", 7, 6), ("tick",)]


def test_golden_ulb_trace_live_vs_sim(live_setup):
    """The port's ULB kernel decides identically on its two backends."""
    _, cfg, _, params = live_setup
    kernel = treg.get_policy("ulb")
    kernel.trace = []
    cluster = LiveCluster(cfg, params, 2, 8, 256, kernel, device="cpu")
    rids = []
    for i, op in enumerate(_ULB_SCRIPT):
        if op[0] == "arrive":
            req = Request(prompt_len=op[1], max_new_tokens=op[2],
                          prompt_tokens=_toks(i, op[1], cfg.vocab_size))
            rids.append(req.rid)
            cluster.submit(req)
        cluster.step()
    extra = 0
    while cluster.pending() and extra < 60:
        cluster.step()
        extra += 1
    live_trace = kernel.trace

    kernel = treg.get_policy("ulb")
    kernel.trace = []
    perf = tsim.PerfModel(tcfg.get_config("llama2-70b"),
                          tsim.InstanceSpec(tsim.H100, 4))
    sim = tsim.Simulator(tsim.ULBPolicy(kernel=kernel), perf, n_instances=2)
    sim.kick = lambda inst: None
    pol = sim.policy

    def tick():
        for inst in sim.instances:
            done = []
            for rid, r in list(inst.decode_batch.items()):
                r.generated += 1
                if r.done:
                    del inst.decode_batch[rid]
                    done.append(r)
            pol.on_decode_done(inst, done)

    arrivals = iter(rids)
    for op in _ULB_SCRIPT:
        if op[0] == "arrive":
            r = SimRequest(rid=next(arrivals), arrival=0.0, prompt_len=op[1],
                           decode_len=op[2])
            inst = pol.route(r)
            r.generated = 1
            pol.on_prefill_done(inst, [r])
        tick()
    for _ in range(extra):
        tick()
    assert live_trace == kernel.trace
    assert {e[0] for e in live_trace} == {"route"}
    assert {e[2] for e in live_trace} == {0, 1}


# ---------------------------------------------------------------------------
# timeline stride, ledger bytes
# ---------------------------------------------------------------------------


def test_sim_timeline_stride_bounds_memory():
    def run(pkg, stride):
        _, sim = _simulate(pkg, "accellm", "accellm", timeline_stride=stride)
        return sim
    dense, strided = run(_PORT, 1), run(_PORT, 8)
    assert 0 < len(strided.timeline) < len(dense.timeline)
    assert len(strided.timeline) <= len(dense.timeline) // 8 + 1
    assert _fingerprint(strided) == _fingerprint(dense)
    assert strided.n_iterations == dense.n_iterations
    ref = run(_REF, 8)
    assert [tuple(vars(p).values()) for p in strided.timeline] == \
        [tuple(vars(p).values()) for p in ref.timeline]


def test_live_timeline_stride(live_setup):
    _, cfg, _, params = live_setup

    def run(stride):
        spec = tapi.ServeSpec(arch="starcoder2-3b", policy="accellm-vec",
                              n_instances=2, num_slots=6, kv_capacity=128,
                              n_requests=4, workload="light", max_steps=200,
                              timeline_stride=stride, device="cpu")
        return tapi.serve(spec, cfg=cfg, params=params)
    dense, strided = run(1), run(4)
    assert dense.all_finished and strided.all_finished
    assert 0 < len(strided.timeline) < len(dense.timeline)
    assert strided.sched_us_per_iter > 0.0
    assert strided.cluster.n_iterations == dense.cluster.n_iterations


def test_ledger_used_bytes_matches_per_request_sum():
    costs = tkv.LineCosts.from_config(tcfg.get_config("llama2-70b"))
    led = tkv.BlockLedger(costs=costs, num_blocks=64, block_lines=4)

    def explicit():
        return sum(costs.bytes_at(led.lines(r)) for r in led.resident())

    led.alloc(0, 6)
    led.alloc(1, 0)
    assert led.used_bytes() == explicit()
    led.append_line(0, 3)
    led.append_line(1, 9)
    assert led.used_bytes() == explicit()
    led.set_lines(1, 4)
    led.set_lines(0, 20)
    assert led.used_bytes() == explicit()
    led.free(0)
    assert led.used_bytes() == explicit()
    led.free(1)
    assert led.used_bytes() == 0.0
