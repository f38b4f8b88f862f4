"""The port's fleet layer held against the JAX package's on the CPU.

``repro_torch.fleet`` is a copy of ``repro.fleet``: the seeded event
streams, the JSONL traces and the failover planner must be equal.  The
port's ``LiveCluster`` runs the JAX package's fleet scripts
(``tests/test_fleet.py``'s mid-serve kill and warm rejoin,
``tests/test_degrade.py``'s straggler, abort and shed) on the reduced
starcoder2-3b in f32 with the JAX package's weights bridged through
numpy: the kernel decision trace, the fleet controller's trace and
counters and every request's tokens must equal ``repro``'s, and, within
the port, the live executor and the simulator adapter must agree on the
same script.  Then the drain, the baselines around a dead instance,
``api.serve`` with a fleet schedule and the two launchers.
"""
import heapq
import json

import jax
import numpy as np
import pytest

import repro.api as rapi
import repro.configs as rcfg
import repro.fleet as rfleet
import repro.launch.fleet as rlfleet
import repro.models as rm
import repro.sim as rsim
import repro.workloads as rwl
from repro.scheduling import AcceLLMScheduler as RAcceLLM
from repro.scheduling.live import LiveCluster as RLiveCluster
from repro.serving import Request as RRequest
import repro_torch.api as tapi
import repro_torch.configs as tcfg
import repro_torch.fleet as tfleet
import repro_torch.launch.fleet as tlfleet
import repro_torch.launch.serve as tlserve
import repro_torch.sim as tsim
import repro_torch.workloads as twl
from repro_torch.bridge import params_from_numpy
from repro_torch.scheduling import AcceLLMScheduler
from repro_torch.scheduling.live import LiveCluster
from repro_torch.scheduling.views import step_health
from repro_torch.serving import Request
from repro_torch.serving.request import Phase
from repro_torch.sim.policies import AcceLLMPolicy


@pytest.fixture(scope="module")
def setup():
    cfg_r = rcfg.get_config("starcoder2-3b").reduced()
    cfg = tcfg.get_config("starcoder2-3b").reduced()
    params_r = rm.init_params(jax.random.PRNGKey(0), cfg_r)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, params_r),
                               device="cpu")
    return cfg_r, cfg, params_r, params


def _toks(i, plen, vocab):
    return np.random.default_rng(700 + i).integers(0, vocab, (1, plen),
                                                   dtype=np.int32)


def _perf(mod, cfg):
    return mod.PerfModel(cfg, mod.InstanceSpec(mod.H100, 4))


# ---------------------------------------------------------------------------
# schedules, traces and the controller
# ---------------------------------------------------------------------------

_SCHEDULES = {
    "fixed": lambda m: m.FixedFleet((m.JoinInstance(9.0, 1),
                                     m.KillInstance(3.0, 1),
                                     m.Drain(3.0, 0))),
    "poisson_failures": lambda m: m.PoissonFailures(
        mtbf=5.0, duration=100.0, n_instances=4, recovery=2.0),
    "poisson_degradations": lambda m: m.PoissonDegradations(
        mtbf=5.0, duration=100.0, n_instances=4, recovery=3.0, factor=6.0),
}


def _events(stream):
    return [(type(e).__name__, vars(e)) for e in stream]


@pytest.mark.parametrize("name", sorted(_SCHEDULES))
def test_schedule_streams_match_reference(name):
    for seed in (0, 1, 7):
        ref = _SCHEDULES[name](rfleet).stream(seed=seed)
        port = _SCHEDULES[name](tfleet).stream(seed=seed)
        assert _events(port) == _events(ref)
        assert port
    assert type(port[0]).kind == type(ref[0]).kind


def test_fleet_trace_reads_back_across_packages(tmp_path):
    events = [(0, 1.5, 2), (1, 4.0, None), (1, 5.0, 2), (2, 9.0, 0),
              (3, 10.0, 1), (4, 12.0, 1)]

    def build(m):
        kinds = (m.KillInstance, m.JoinInstance, m.Drain,
                 lambda t, i: m.DegradeInstance(t, i, 3.0, 2.0),
                 m.RecoverInstance)
        return [kinds[k](t, i) for k, t, i in events]

    for writer, reader in ((tfleet, rfleet), (rfleet, tfleet)):
        path = tmp_path / f"{writer.__name__}.jsonl"
        assert writer.save_fleet_trace(path, build(writer)) == len(events)
        loaded = reader.load_fleet_trace(path)
        assert isinstance(loaded, reader.FixedFleet)
        assert _events(loaded.stream(seed=0)) == _events(build(reader))
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"t": 1.0, "event": "kill"}\n')
    with pytest.raises(ValueError):
        tfleet.load_fleet_trace(bad)


def test_controller_paces_and_drains():
    ctrl = tfleet.FleetController(tfleet.FixedFleet((
        tfleet.KillInstance(2.0, 0), tfleet.JoinInstance(5.0, 0),
        tfleet.Drain(9.0, 1))))
    assert ctrl.next_time() == 2.0 and ctrl.due(1.0) == []
    assert [e.t for e in ctrl.due(5.0)] == [2.0, 5.0]
    assert not ctrl.exhausted() and ctrl.next_time() == 9.0
    assert [e.t for e in ctrl.drain_all()] == [9.0]
    assert ctrl.exhausted() and ctrl.due(100.0) == []
    assert ctrl.STATS == rfleet.FleetController.STATS


def _resident(mod, sim, rid, primary, replica, gen=3, lag=0):
    r = mod.SimRequest(rid=rid, arrival=0.0, prompt_len=16, decode_len=8)
    r.generated = gen
    sim.instances[primary].decode_batch[rid] = r
    if replica is not None:
        sim.instances[replica].replicas[rid] = r
        if lag:
            sim.instances[replica].synced_marks[rid] = r.total_len - lag
    sim.policy.placement[rid] = (primary, replica)


@pytest.mark.parametrize("dead", [0, 1, 2])
def test_plan_failover_matches_reference(dead):
    """Equal decisions on equal views: promotions (with a lagging
    replica's lost lines), re-queues, dropped replicas, and a draining
    replica host that cannot take primaries."""
    plans = []
    for mod, fmod, cfgs in ((rsim, rfleet, rcfg), (tsim, tfleet, tcfg)):
        sim = mod.Simulator(mod.AcceLLMPolicy(),
                            _perf(mod, cfgs.get_config("llama2-70b")),
                            n_instances=4)
        _resident(mod, sim, 7, primary=1, replica=0)
        _resident(mod, sim, 3, primary=1, replica=None)
        _resident(mod, sim, 5, primary=0, replica=1, lag=2)
        _resident(mod, sim, 9, primary=2, replica=3, lag=1)
        _resident(mod, sim, 4, primary=3, replica=2)
        _resident(mod, sim, 6, primary=0, replica=2)
        sim.instances[3].draining = True
        plan = fmod.FleetController().plan_failover(sim.policy.view(), dead)
        plans.append((plan.dead, [vars(p) for p in plan.promotions],
                      [p.lost_lines for p in plan.promotions],
                      plan.requeues, plan.dropped_replicas))
    assert plans[1] == plans[0]


def test_lifecycle_helpers_match_reference():
    out = []
    for mod, fmod in ((rsim, rfleet), (tsim, tfleet)):
        r = mod.SimRequest(rid=0, arrival=2.5, prompt_len=10, decode_len=6)
        r.generated = 4
        r.token_times.extend([3.0, 3.1, 3.2, 3.3])
        r.output_tokens.extend([5, 6, 7, 8])
        r.first_token_time = 3.0
        fmod.rollback_tokens(r, 2)
        mid = (r.generated, list(r.token_times), list(r.output_tokens))
        n = fmod.reset_for_reprefill(r)
        out.append((mid, n, r.phase.name, r.generated, r.first_token_time,
                    r.arrival))
    assert out[1] == out[0]


# ---------------------------------------------------------------------------
# the golden fleet scripts: port vs repro, and live vs sim in the port
# ---------------------------------------------------------------------------

# the JAX package's scripts (tests/test_fleet.py, tests/test_degrade.py)
_FLEET_SCRIPT = [
    ("arrive", 8, 10), ("tick",), ("arrive", 12, 12), ("arrive", 6, 12),
    ("tick",), ("kill", 1), ("tick",), ("arrive", 9, 8), ("tick",),
    ("join", 1), ("tick",), ("tick",),
]
_CHAOS_SCRIPT = [
    ("arrive", 8, 14), ("tick",), ("arrive", 10, 14), ("tick",),
    ("arrive", 6, 12), ("tick",), ("tick",), ("degrade", 0, 4.0),
    ("tick",), ("tick",), ("abort", 1), ("tick",), ("recover", 0),
    ("tick",), ("tick",),
    ("arrive", 7, 6), ("arrive", 9, 6), ("arrive", 6, 6),
    ("tick",), ("tick",),
]
_MAX_QUEUE = 2


def _run_live(cluster, req_cls, script, vocab, step_every_op):
    """Drive one script through a live cluster, as the JAX package's
    harnesses do: the fleet script steps after every op, the chaos
    script only on ticks."""
    rids, reqs = [], []
    for i, op in enumerate(script):
        if op[0] == "arrive":
            req = req_cls(prompt_len=op[1], max_new_tokens=op[2],
                          rid=1000 + i,
                          prompt_tokens=_toks(i, op[1], vocab))
            rids.append(req.rid)
            reqs.append(req)
            cluster.submit(req)
        elif op[0] == "kill":
            cluster.fleet_kill(op[1])
        elif op[0] == "join":
            cluster.fleet_join(op[1])
        elif op[0] == "degrade":
            cluster.fleet_degrade(op[1], op[2])
        elif op[0] == "recover":
            cluster.fleet_recover(op[1])
        elif op[0] == "abort":
            cluster.abort(rids[op[1]])
        if step_every_op or op[0] == "tick":
            cluster.step()
    steps = 0
    while cluster.pending() and steps < 200:
        cluster.step()
        steps += 1
    assert not cluster.pending()
    return rids, reqs, steps


def _live_outcome(cluster, kernel, reqs):
    return {"kernel_trace": kernel.trace,
            "fleet_trace": cluster.fleet.trace,
            "fleet_stats": dict(cluster.fleet.stats),
            "stats": dict(cluster.stats),
            "tokens": [list(map(int, r.output_tokens)) for r in reqs],
            "phases": [r.phase.name for r in reqs],
            "iterations": cluster.n_iterations}


def _run_sim(rids, extra_steps, script, redundancy=True, chaos=False):
    """The JAX package's lock-step simulator drive of the same script, on
    the port's simulator adapter: fleet ops land through the adapter's
    hooks, re-queued requests drain from the event heap back to the
    front of the queue, the health EWMA advances once per step."""
    kernel = AcceLLMScheduler(redundancy=redundancy)
    kernel.trace = []
    sim = tsim.Simulator(AcceLLMPolicy(kernel=kernel),
                         _perf(tsim, tcfg.get_config("starcoder2-3b")
                               .reduced()), n_instances=2)
    sim.kick = lambda inst: None
    pol = sim.policy
    ctrl = tfleet.FleetController()
    if chaos:
        sim.fleet = ctrl
    queue = []

    def tick(skip_iid=None):
        finished = {}
        for inst in sim.instances:
            if not inst.alive or inst.iid == skip_iid:
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

    def step_once():
        if chaos:
            for inst in sim.instances:
                if inst.alive:
                    inst.health = step_health(inst.health,
                                              inst.degrade_factor)
        skip = None
        if queue:
            r = queue[0]
            inst = pol.route(r)
            if inst is not None:
                queue.pop(0)
                r.generated = 1
                pol.on_prefill_done(inst, [r])
                skip = inst.iid
        tick(skip_iid=skip)

    def drain_requeues():
        out = []
        while sim._heap:
            _, _, kind, data = heapq.heappop(sim._heap)
            if kind == "arrival":
                out.append(data)
        return out

    arrivals = iter(rids)
    for op in script:
        if op[0] == "arrive":
            r = tsim.SimRequest(rid=next(arrivals), arrival=0.0,
                                prompt_len=op[1], decode_len=op[2])
            if chaos and len(queue) >= _MAX_QUEUE:
                sim._shed(r)
                continue
            queue.append(r)
        elif op[0] == "kill":
            pol._fleet_kill(op[1], ctrl)
            queue[:0] = drain_requeues()
        elif op[0] == "join":
            pol._fleet_join(op[1], ctrl)
        elif op[0] == "degrade":
            pol._fleet_degrade(op[1], op[2], 1.0, ctrl)
        elif op[0] == "recover":
            pol._fleet_recover(op[1], ctrl)
        elif op[0] == "abort":
            rid = rids[op[1]]
            held = [r for r in queue if r.rid == rid]
            if held:
                queue.remove(held[0])
                held[0].phase = Phase.ABORTED
                sim.aborted.append(held[0])
                ctrl.note("abort", rid)
                ctrl.stats["aborts"] += 1
            else:
                sim.abort(rid)
        if not chaos or op[0] == "tick":
            step_once()
    for _ in range(extra_steps):
        step_once()
    return kernel.trace, ctrl, sim


def _both_live(setup, script, redundancy=True, **kw):
    cfg_r, cfg, params_r, params = setup
    chaos = "max_queue" in kw
    out = []
    for cls, kcls, req_cls, c, p, dev in (
            (RLiveCluster, RAcceLLM, RRequest, cfg_r, params_r, {}),
            (LiveCluster, AcceLLMScheduler, Request, cfg, params,
             {"device": "cpu"})):
        kernel = kcls(redundancy=redundancy)
        kernel.trace = []
        cluster = cls(c, p, n_instances=2, num_slots=8, kv_capacity=256,
                      policy=kernel, **kw, **dev)
        rids, reqs, steps = _run_live(cluster, req_cls, script,
                                      c.vocab_size, not chaos)
        out.append((cluster, kernel, rids, reqs, steps))
    return out


@pytest.mark.parametrize("redundancy", [True, False])
def test_golden_fleet_trace_matches_reference(setup, redundancy):
    (rc, rk, _, rreqs, _), (pc, pk, rids, reqs, steps) = _both_live(
        setup, _FLEET_SCRIPT, redundancy)
    got = _live_outcome(pc, pk, reqs)
    assert got == _live_outcome(rc, rk, rreqs)
    for r in reqs:
        assert len(r.output_tokens) == r.max_new_tokens
    # within the port: the simulator adapter makes the same decisions
    sim_trace, sim_ctrl, _ = _run_sim(rids, steps, _FLEET_SCRIPT,
                                      redundancy)
    assert pk.trace == sim_trace
    assert pc.fleet.trace == sim_ctrl.trace
    assert pc.fleet.stats == sim_ctrl.stats
    fs = got["fleet_stats"]
    assert {"kill", "join"} <= {e[0] for e in got["fleet_trace"]}
    if redundancy:
        assert fs["promotions"] > 0 and fs["requeues"] == 0
        assert fs["reprefill_tokens"] == 0 and fs["warm_streams"] > 0
        assert "warm" in {e[0] for e in pk.trace}
    else:
        assert fs["promotions"] == 0
        assert fs["requeues"] > 0 and fs["reprefill_tokens"] > 0


def test_golden_degrade_trace_matches_reference(setup):
    (rc, rk, _, rreqs, _), (pc, pk, rids, reqs, steps) = _both_live(
        setup, _CHAOS_SCRIPT, max_queue=_MAX_QUEUE)
    got = _live_outcome(pc, pk, reqs)
    assert got == _live_outcome(rc, rk, rreqs)
    sim_trace, sim_ctrl, sim = _run_sim(rids, steps, _CHAOS_SCRIPT,
                                        chaos=True)
    assert pk.trace == sim_trace
    assert pc.fleet.trace == sim_ctrl.trace
    assert pc.fleet.stats == sim_ctrl.stats
    fs = got["fleet_stats"]
    assert (fs["degrades"], fs["recoveries"], fs["aborts"],
            fs["sheds"]) == (1, 1, 1, 1)
    assert fs["hedges"] > 0 and "hedge" in {e[0] for e in pk.trace}
    assert [r.rid for r in pc.aborted] == [rids[1]]
    assert {r.rid for r in sim.aborted} == {rids[1]}
    for eng in pc.engines:
        assert eng.store.ledger.used_blocks() == 0
    for inst in sim.instances:
        assert inst.synced_store().ledger.used_blocks() == 0


def test_degrade_dispatch_sleeps_match_reference(setup, monkeypatch):
    """``degrade_dispatch_s``: on the chaos script's schedule each decode
    dispatch of the degraded instance sleeps (factor - 1) x the knob,
    after the pressure relief, in the port as in the JAX package (the
    sleeps recorded, not slept); the decisions and tokens stay equal
    across the packages, and the knob is off by default."""
    import sys
    import time
    sleeps = {"repro.scheduling.live": [],
              "repro_torch.scheduling.live": []}

    def fake_sleep(seconds):
        sleeps[sys._getframe(1).f_globals["__name__"]].append(seconds)

    monkeypatch.setattr(time, "sleep", fake_sleep)
    (rc, rk, _, rreqs, _), (pc, pk, _, reqs, _) = _both_live(
        setup, _CHAOS_SCRIPT, max_queue=_MAX_QUEUE, degrade_dispatch_s=0.25)
    got = _live_outcome(pc, pk, reqs)
    assert got == _live_outcome(rc, rk, rreqs)
    ref, port = sleeps.values()
    assert port == ref and port
    factor = next(e[2] for e in got["fleet_trace"] if e[0] == "degrade")
    assert set(port) == {(factor - 1.0) * 0.25}
    # off by default in both packages
    import inspect
    for cls in (RLiveCluster, LiveCluster):
        param = inspect.signature(cls).parameters["degrade_dispatch_s"]
        assert param.default == 0.0


# ---------------------------------------------------------------------------
# drain, dead-instance routing, joins, ServeSpec.fleet
# ---------------------------------------------------------------------------


def test_live_drain_settles_after_residents_finish(setup):
    _, cfg, _, params = setup
    cluster = LiveCluster(cfg, params, n_instances=2, num_slots=8,
                          kv_capacity=256, policy=AcceLLMScheduler(),
                          device="cpu")
    reqs = [Request(prompt_len=6 + i, max_new_tokens=4, rid=2000 + i,
                    prompt_tokens=_toks(20 + i, 6 + i, cfg.vocab_size))
            for i in range(2)]
    for r in reqs:
        cluster.submit(r)
    cluster.step()
    cluster.step()
    cluster.fleet_drain(1)
    assert cluster.draining[1]
    late = [Request(prompt_len=7, max_new_tokens=3, rid=2010 + i,
                    prompt_tokens=_toks(30 + i, 7, cfg.vocab_size))
            for i in range(2)]
    for r in late:
        cluster.submit(r)
    cluster.run(max_steps=120)
    for r in reqs + late:
        assert len(r.output_tokens) == r.max_new_tokens
    assert not cluster.alive[1] and not cluster.draining[1]
    assert ("drain", 1) in cluster.fleet.trace
    assert ("drained", 1) in cluster.fleet.trace
    assert not cluster.engines[1].slot_req


@pytest.mark.parametrize("policy", ["vllm", "splitwise"])
def test_baselines_route_around_dead_instance(setup, policy):
    cfg_r, cfg, params_r, params = setup
    victim = 0 if policy == "vllm" else 1
    outs = []
    for cls, req_cls, c, p, dev in (
            (RLiveCluster, RRequest, cfg_r, params_r, {}),
            (LiveCluster, Request, cfg, params, {"device": "cpu"})):
        cluster = cls(c, p, n_instances=2, num_slots=6, kv_capacity=128,
                      policy=policy, **dev)
        cluster.fleet_kill(victim)
        reqs = [req_cls(prompt_len=6 + i % 3, max_new_tokens=3 + i % 2,
                        rid=3000 + i,
                        prompt_tokens=_toks(40 + i, 6 + i % 3, c.vocab_size))
                for i in range(3)]
        for r in reqs:
            cluster.submit(r)
        done = cluster.run(max_steps=200)
        assert len(done) == 3
        assert not cluster.engines[victim].slot_req
        outs.append((cluster.fleet.trace, dict(cluster.fleet.stats),
                     dict(cluster.stats),
                     [list(map(int, r.output_tokens)) for r in reqs]))
    assert outs[1] == outs[0]
    assert outs[1][1]["kills"] == 1


def test_join_appends_engine_on_the_cluster_device(setup):
    _, cfg, _, params = setup
    cluster = LiveCluster(cfg, params, n_instances=2, num_slots=4,
                          kv_capacity=64, policy="vllm", device="cpu")
    assert cluster.fleet_join(0) == 0            # a live index: no-op
    idx = cluster.fleet_join(None)
    assert idx == 2 and len(cluster.engines) == 3
    assert cluster.alive == [True, True, True]
    eng = cluster.engines[2]
    assert eng.instance_id == 2 and eng.device.type == "cpu"
    assert cluster.fleet.stats["joins"] == 1
    req = Request(prompt_len=6, max_new_tokens=3, rid=3100,
                  prompt_tokens=_toks(50, 6, cfg.vocab_size))
    cluster.submit(req)
    cluster.run(max_steps=50)
    assert len(req.output_tokens) == 3


def _fleet_spec(api, wl, fm, **kw):
    return api.ServeSpec(
        arch="starcoder2-3b", policy="accellm", n_instances=2, num_slots=6,
        kv_capacity=128, max_steps=300, seed=2,
        traffic=wl.WorkloadSpec(arrival=wl.Poisson(rate=0.6, duration=10.0),
                                lengths=wl.TableLengths("light", scale=0.03),
                                name="fleet"),
        fleet=fm.FixedFleet((fm.KillInstance(6.0, 1),
                             fm.JoinInstance(12.0, 1))), **kw)


def test_serve_spec_fleet_matches_reference(setup):
    cfg_r, cfg, params_r, params = setup
    rep_r = rapi.serve(_fleet_spec(rapi, rwl, rfleet), cfg=cfg_r,
                       params=params_r)
    rep_t = tapi.serve(_fleet_spec(tapi, twl, tfleet, device="cpu"),
                       cfg=cfg, params=params)
    assert rep_t.all_finished and rep_r.all_finished
    assert rep_t.fleet_stats == rep_r.fleet_stats
    assert rep_t.fleet_stats["kills"] == rep_t.fleet_stats["joins"] == 1
    assert rep_t.cluster.fleet.trace == rep_r.cluster.fleet.trace
    assert rep_t.stats == rep_r.stats
    for f in ("ttfts", "tbts", "jcts"):
        assert np.array_equal(getattr(rep_t, f)(), getattr(rep_r, f)()), f
    assert "fleet:" in rep_t.describe()


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

# the port's pods ask for one H100 and run the port's launcher: the only
# fields of a manifest that differ from the JAX package's by design
_BY_DESIGN = {
    "image_args": ("repro.launch.serve", "repro_torch.launch.serve"),
    "limits": ({"google.com/tpu": 4}, {"nvidia.com/gpu": 1}),
    "node": ({"cloud.google.com/gke-tpu-accelerator": "tpu-v5e-4"},
             {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}),
}


def _as_port(plan):
    plan = json.loads(json.dumps(plan))
    for m in plan["manifests"]:
        c = m["spec"]["containers"][0]
        assert c["args"][2] == _BY_DESIGN["image_args"][0]
        c["args"][2] = _BY_DESIGN["image_args"][1]
        assert c["resources"]["limits"] == _BY_DESIGN["limits"][0]
        c["resources"]["limits"] = _BY_DESIGN["limits"][1]
        assert m["spec"]["nodeSelector"] == _BY_DESIGN["node"][0]
        m["spec"]["nodeSelector"] = _BY_DESIGN["node"][1]
    return plan


@pytest.mark.parametrize("schedule", ["fixed", "poisson_failures",
                                      "poisson_degradations"])
def test_launch_fleet_dry_run_matches_reference(schedule):
    plans = []
    for api, lf, fm in ((rapi, rlfleet, rfleet), (tapi, tlfleet, tfleet)):
        spec = api.ServeSpec(arch="starcoder2-3b", policy="accellm",
                             n_instances=4,
                             fleet=_SCHEDULES[schedule](fm))
        plans.append(json.loads(json.dumps(lf.dry_run(spec, seed=3))))
    assert plans[1]["timeline"] == plans[0]["timeline"]
    assert plans[1] == _as_port(plans[0])
    ops = {s["op"] for s in plans[1]["timeline"]}
    assert {"apply", "wait-ready", "teardown"} <= ops


def test_launch_fleet_main_writes_plan(tmp_path):
    out = tmp_path / "plan.json"
    assert tlfleet.main(["--arch", "starcoder2-3b", "--instances", "2",
                         "--fleet-mtbf", "50", "--fleet-recovery", "5",
                         "--duration", "200", "--out", str(out)]) == 0
    plan = json.loads(out.read_text())
    assert plan["n_instances"] == 2
    assert "delete" in {s["op"] for s in plan["timeline"]}


def test_launch_serve_runs_on_the_cpu(capsys):
    rc = tlserve.main(["--arch", "starcoder2-3b", "--instances", "2",
                       "--requests", "3", "--slots", "4",
                       "--kv-capacity", "64", "--scale", "0.02",
                       "--max-steps", "300", "--device", "cpu",
                       "--fleet-mtbf", "4", "--fleet-recovery", "3",
                       "--duration", "10"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "device=cpu" in out and "stats:" in out and "fleet:" in out


@pytest.mark.parametrize("flags,what", [
    (["--prefix-cache"], None),
    (["--prefix-cache-blocks", "8"], None),
    (["--mesh-tp", "1"], "mesh slice")])
def test_launch_serve_later_slices_raise(flags, what, capsys):
    """The prefix-cache flags serve since the prefix-cache slice, and
    ``--mesh-tp`` since the mesh slice: one gloo process per rank, whose
    report the launcher prints (tests/test_torch_meshserve.py holds it
    against the host cluster's at tp 2)."""
    argv = ["--arch", "starcoder2-3b", "--device", "cpu"] + flags
    assert tlserve.main(argv + ["--instances", "2", "--requests", "3",
                                "--slots", "4", "--kv-capacity", "64",
                                "--scale", "0.02"]) == 0
    out = capsys.readouterr().out
    assert "stats:" in out
    assert what is None or what in out
