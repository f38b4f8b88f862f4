"""The port's simulator held against the JAX package's.

``repro_torch.sim`` and ``repro_torch.kvstore.sim`` are copies of
``repro.sim`` and ``repro.kvstore.sim`` (Python and numpy only).  For the
same spec and seed both packages' ``Simulator`` must make the same
decisions (the kernel's trace), finish the same requests at the same
modeled times and summarise them identically, under every scalar policy,
with fused decode, and through kill / join / degrade schedules.  The cost
model (``PerfModel``) and the ledger (``SimStore``) must price alike.
Last, the JAX package's live-vs-sim golden trace
(``tests/test_scheduling.py``) holds between the port's two backends.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

import repro.configs as rcfg
import repro.fleet as rfleet
import repro.kvstore as rkv
import repro.sim as rsim
import repro.stepplan as rsp
import repro.workloads as rwl
from repro.scheduling.actions import MirrorSync as RMirrorSync
from repro.scheduling.actions import StreamState as RStreamState
import repro_torch.configs as tcfg
import repro_torch.fleet as tfleet
import repro_torch.kvstore as tkv
import repro_torch.models as tm
import repro_torch.sim as tsim
import repro_torch.stepplan as tsp
import repro_torch.workloads as twl
from repro_torch.scheduling import AcceLLMScheduler
from repro_torch.scheduling.actions import MirrorSync, StreamState
from repro_torch.scheduling.live import LiveCluster
from repro_torch.serving import Request

# (package, its workloads, its fleet, its configs)
_REF = (rsim, rwl, rfleet, rcfg)
_PORT = (tsim, twl, tfleet, tcfg)

_POLICIES = {
    "accellm": lambda s, kw: s.AcceLLMPolicy(**kw),
    "vllm": lambda s, kw: s.VLLMPolicy(**kw),
    "splitwise": lambda s, kw: s.SplitwisePolicy(1, **kw),
    "sarathi": lambda s, kw: s.SarathiPolicy(512, **kw),
    "ulb": lambda s, kw: s.ULBPolicy(**kw),
}


def _perf(pkg, arch="llama2-70b", n_devices=4):
    sim, _, _, cfgs = pkg
    return sim.PerfModel(cfgs.get_config(arch),
                         sim.InstanceSpec(sim.H100, n_devices))


def _traffic(wl, workload="mixed"):
    return wl.WorkloadSpec(
        arrival=wl.Bursty(rate_on=12.0, duration=30.0, rate_off=2.0,
                          mean_on=6.0, mean_off=4.0),
        lengths=wl.TableLengths(workload=workload), name="bursty")


def _simulate(pkg, policy, n_instances=4, fleet=None, seed=0,
              fuse_decode_steps=1, **sim_kw):
    sim_mod, wl, fm, _ = pkg
    pol = _POLICIES[policy](sim_mod,
                            {"fuse_decode_steps": fuse_decode_steps})
    pol.kernel.trace = []
    sim = sim_mod.Simulator(pol, _perf(pkg), n_instances=n_instances,
                            **sim_kw)
    ctrl = fm.FleetController(fleet(fm)) if fleet is not None else None
    sim.run(source=_traffic(wl).source(seed=seed), horizon=500.0,
            fleet=ctrl)
    summary = dataclasses.asdict(sim_mod.summarize(
        sim.submitted, n_instances=n_instances, duration=sim.now))
    summary.pop("sched_us_per_iter")          # the host's wall clock
    reqs = [(r.rid, r.phase.name, r.generated, r.first_token_time,
             r.finish_time, tuple(r.token_times))
            for r in sorted(sim.submitted, key=lambda r: r.rid)]
    return {"trace": pol.kernel.trace, "summary": summary,
            "requests": reqs, "now": sim.now,
            "peaks": [i.peak_state_bytes for i in sim.instances],
            "fleet_trace": ctrl.trace if ctrl else None,
            "fleet_stats": ctrl.stats if ctrl else None}


def _eq(a, b):
    """Equal, with NaN equal to NaN (empty percentiles)."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (np.isnan(a) and np.isnan(b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_eq(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_eq(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("policy", sorted(_POLICIES))
def test_simulator_matches_reference(policy):
    ref, port = _simulate(_REF, policy), _simulate(_PORT, policy)
    assert len(port["trace"]) > 20
    assert port["trace"] == ref["trace"]
    assert _eq(port["summary"], ref["summary"])
    assert port["requests"] == ref["requests"]
    assert port["now"] == ref["now"] and port["peaks"] == ref["peaks"]
    assert port["summary"]["n_finished"] == len(port["requests"])


@pytest.mark.parametrize("policy", ["accellm", "vllm"])
def test_fused_decode_simulator_matches_reference(policy):
    ref = _simulate(_REF, policy, fuse_decode_steps=8)
    port = _simulate(_PORT, policy, fuse_decode_steps=8)
    assert port["trace"] == ref["trace"]
    assert port["requests"] == ref["requests"]
    assert _eq(port["summary"], ref["summary"])


_CHAOS = lambda fm: fm.FixedFleet((
    fm.DegradeInstance(4.0, 1, 4.0), fm.KillInstance(10.0, 2),
    fm.RecoverInstance(14.0, 1), fm.JoinInstance(18.0, 2),
    fm.DegradeInstance(22.0, 0, 3.0), fm.RecoverInstance(30.0, 0)))
_KILL_JOIN = lambda fm: fm.FixedFleet((fm.KillInstance(2.0, 1),
                                       fm.JoinInstance(4.0, 1)))


@pytest.mark.parametrize("policy,fleet,kw", [
    ("accellm", _CHAOS, {"max_queue": 24}),
    ("vllm", _CHAOS, {}),
    ("splitwise", _KILL_JOIN, {}),
    ("accellm", _KILL_JOIN, {"shed_deadline": 5.0})],
    ids=["accellm-chaos", "vllm-chaos", "splitwise-kill-join",
         "accellm-kill-join-deadline"])
def test_fleet_simulator_matches_reference(policy, fleet, kw):
    ref = _simulate(_REF, policy, fleet=fleet, **kw)
    port = _simulate(_PORT, policy, fleet=fleet, **kw)
    assert port["fleet_stats"]["kills"] == 1
    assert port["fleet_trace"] == ref["fleet_trace"]
    assert port["fleet_stats"] == ref["fleet_stats"]
    assert port["trace"] == ref["trace"]
    assert port["requests"] == ref["requests"]
    assert _eq(port["summary"], ref["summary"])


def test_make_workload_matches_reference():
    for name in ("light", "mixed", "heavy"):
        a = rsim.make_workload(name, rate=6.0, duration=10.0, seed=4)
        b = tsim.make_workload(name, rate=6.0, duration=10.0, seed=4)
        assert ([(r.rid, r.arrival, r.prompt_len, r.decode_len) for r in b]
                == [(r.rid, r.arrival, r.prompt_len, r.decode_len)
                    for r in a])
    assert sorted(tsim.WORKLOADS) == sorted(rsim.WORKLOADS)


# ---------------------------------------------------------------------------
# the cost model and the ledger
# ---------------------------------------------------------------------------


def test_device_models_match_reference():
    for name, dev in rsim.DEVICES.items():
        assert dataclasses.asdict(tsim.DEVICES[name]) == \
            dataclasses.asdict(dev)
    spec_r = rsim.InstanceSpec(rsim.H100, 4, dispatch_s=0.02,
                               intra_link_gbps=450.0)
    spec_t = tsim.InstanceSpec(tsim.H100, 4, dispatch_s=0.02,
                               intra_link_gbps=450.0)
    for f in ("tflops", "hbm_bytes", "hbm_bw", "intra_link_bw",
              "inter_link_bw", "link_bw"):
        assert getattr(spec_t, f) == getattr(spec_r, f), f


def _plans(sp, actions):
    mirror, stream = actions
    return [
        sp.PrefillPlan(0, (sp.PrefillItem(1, 512, 0, 512),
                           sp.PrefillItem(2, 300, 0, 128)), 512),
        sp.PrefillPlan(0, (sp.PrefillItem(3, 900, 256, 512),), 512),
        sp.DecodePlan(0, lengths=(17, 300, 1000, 4096), block_lines=16),
        sp.DecodePlan(0, lengths=(17, 300), block_lines=16, steps=8,
                      mirrored=2),
        sp.MixedPlan(0, sp.PrefillPlan(0, (sp.PrefillItem(4, 200, 0, 200),),
                                       256),
                     sp.DecodePlan(0, lengths=(64, 65), block_lines=16)),
        sp.TransferPlan(0, mirror(5, 0, 1, 100, 108), lines=8),
        sp.TransferPlan(0, stream(6, 0, 1), lines=700,
                        overlap_layers=True),
        sp.TransferPlan(0, stream(6, 0, 1), lines=700, link="intra"),
    ]


@pytest.mark.parametrize("arch,n_devices,dispatch_s", [
    ("llama2-70b", 4, 0.0), ("llama2-70b", 4, 0.03),
    ("starcoder2-3b", 1, 0.0), ("arctic-480b", 16, 0.0),
    ("jamba-1.5-large-398b", 16, 0.0)])
def test_perf_model_matches_reference(arch, n_devices, dispatch_s):
    perfs = [pkg[0].PerfModel(pkg[3].get_config(arch),
                              pkg[0].InstanceSpec(pkg[0].H100, n_devices,
                                                  dispatch_s=dispatch_s,
                                                  intra_link_gbps=450.0))
             for pkg in (_REF, _PORT)]
    times = [[p.plan_time(plan) for plan in _plans(sp, acts)]
             for p, sp, acts in zip(perfs, (rsp, tsp),
                                    ((RMirrorSync, RStreamState),
                                     (MirrorSync, StreamState)))]
    assert times[1] == times[0]
    assert all(t >= 0 for t in times[1]) and times[1][0] > 0
    for f in ("weight_bytes", "active_weight_bytes", "kv_capacity_bytes"):
        assert getattr(perfs[1], f) == getattr(perfs[0], f), f
    for n in (1, 37, 4096):
        assert perfs[1].kv_bytes(n) == perfs[0].kv_bytes(n)
        assert perfs[1].prefill_time([n]) == perfs[0].prefill_time([n])
    assert (dataclasses.asdict(perfs[1].line_costs)
            == dataclasses.asdict(perfs[0].line_costs))


def test_sim_store_ledger_matches_reference():
    outs = []
    for pkg, kv in ((_REF, rkv), (_PORT, tkv)):
        perf = _perf(pkg)
        store = kv.SimStore(perf.line_costs, perf.kv_capacity_bytes,
                            block_lines=16)
        got = []
        for resident in ({1: 17, 2: 300, 3: 16}, {1: 18, 2: 301, 4: 900},
                         {4: 916}, {}):
            store.reconcile(resident)
            got.append((store.used_bytes(), store.free_bytes(),
                        store.free_blocks(),
                        {r: (store.lines(r), store.used_bytes_of(r))
                         for r in resident},
                        store.mirror_bytes_per_step(len(resident))))
        store.reconcile({7: 40})
        got.append(store.delta_since(7, 32))
        outs.append(got)
    assert outs[1] == outs[0]


def test_later_slices_raise():
    perf = _perf(_PORT)
    with pytest.raises(NotImplementedError, match="prefix-cache slice"):
        tsim.Simulator(tsim.AcceLLMPolicy(), perf, n_instances=2,
                       prefix_cache=True)
    kernel = AcceLLMScheduler()
    kernel.vectorized = True
    with pytest.raises(NotImplementedError, match="scale slice"):
        tsim.Simulator(tsim.AcceLLMPolicy(kernel=kernel), perf,
                       n_instances=2)


# ---------------------------------------------------------------------------
# the live-vs-sim golden trace on the port's two backends
# ---------------------------------------------------------------------------

# the JAX package's script (tests/test_scheduling.py)
_TRACE = [("arrive", 8, 4), ("tick",), ("arrive", 12, 6), ("arrive", 6, 5),
          ("tick",), ("arrive", 10, 3), ("tick",), ("arrive", 7, 6),
          ("arrive", 9, 4), ("tick",)]


@pytest.fixture(scope="module")
def port_model():
    cfg = tcfg.get_config("starcoder2-3b").reduced()
    params = tm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    return cfg, params


def _live_trace(cfg, params, n_instances):
    kernel = AcceLLMScheduler()
    kernel.trace = []
    cluster = LiveCluster(cfg, params, n_instances=n_instances, num_slots=8,
                          kv_capacity=256, policy=kernel, device="cpu")
    rng = np.random.default_rng(7)
    rids = []
    for op in _TRACE:
        if op[0] == "arrive":
            req = Request(prompt_len=op[1], max_new_tokens=op[2],
                          prompt_tokens=rng.integers(
                              0, cfg.vocab_size, (1, op[1]), dtype=np.int32))
            rids.append(req.rid)
            cluster.submit(req)
        cluster.step()
    steps = 0
    while cluster.pending() and steps < 50:
        cluster.step()
        steps += 1
    assert not cluster.pending()
    return kernel.trace, rids, steps


def _sim_trace(cfg, rids, extra_ticks, n_instances):
    """The JAX package's lock-step drive of the simulator adapter: the
    instance chosen for prefill skips decoding that tick, like the live
    executor's exclusive-prefill role."""
    kernel = AcceLLMScheduler()
    kernel.trace = []
    sim = tsim.Simulator(tsim.AcceLLMPolicy(kernel=kernel),
                         tsim.PerfModel(cfg, tsim.InstanceSpec(tsim.H100, 4)),
                         n_instances=n_instances)
    sim.kick = lambda inst: None
    pol = sim.policy

    def tick(skip_iid=None):
        finished = {}
        for inst in sim.instances:
            if inst.iid == skip_iid:
                continue
            done_here = []
            for rid, r in list(inst.decode_batch.items()):
                r.generated += 1
                if r.done:
                    del inst.decode_batch[rid]
                    done_here.append(r)
            finished[inst.iid] = done_here
        for inst in sim.instances:
            if inst.iid in finished:
                pol.on_decode_done(inst, finished[inst.iid])

    arrivals = iter(rids)
    for op in _TRACE:
        skip = None
        if op[0] == "arrive":
            r = tsim.SimRequest(rid=next(arrivals), arrival=0.0,
                                prompt_len=op[1], decode_len=op[2])
            inst = pol.route(r)
            r.generated = 1
            pol.on_prefill_done(inst, [r])
            skip = inst.iid
        tick(skip_iid=skip)
    for _ in range(extra_ticks):
        tick()
    return kernel.trace


@pytest.mark.parametrize("n_instances", [2, 4])
def test_golden_trace_live_vs_sim(port_model, n_instances):
    cfg, params = port_model
    live, rids, extra = _live_trace(cfg, params, n_instances)
    assert live == _sim_trace(cfg, rids, extra, n_instances)
    kinds = {e[0] for e in live}
    assert {"route", "place"} <= kinds
    if n_instances == 2:
        assert "rebalance" in kinds


def test_requests_are_not_shared_between_runs():
    """The simulator mutates the requests it is given: a deep copy keeps
    two policies' runs apart, as the JAX package's tests rely on."""
    reqs = tsim.make_workload("light", rate=5.0, duration=5.0, seed=2)
    done = []
    for policy in ("vllm", "accellm"):
        sim = tsim.Simulator(_POLICIES[policy](tsim, {}), _perf(_PORT),
                             n_instances=2)
        done.append(sim.run([copy.deepcopy(r) for r in reqs],
                            horizon=600.0))
    assert len(done[0]) == len(done[1]) == len(reqs)
    assert all(r.generated == 0 for r in reqs)
