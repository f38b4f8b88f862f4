"""The port's live cluster held against the JAX package's on the CPU.

The reduced starcoder2-3b in f32 (and, once, the reduced
jamba-1.5-large-398b): the JAX package's random weights go through numpy
into the port (``params_from_numpy``), and the same requests, with the
same numpy-seeded prompt tokens and request ids, go through both
``LiveCluster``s.  At temperature 0 the policy kernel's decision trace,
the planner's plan trace, the stats dict, every request's tokens and its
latency stamps must be equal exactly.  Chunked-prefill logits agree
within 1e-4 max abs (the packages sum in different orders).

* ``repro``'s golden trace (``tests/test_scheduling.py``) at 2 and 4
  instances under accellm;
* the baselines vllm, splitwise (streamed export/import), sarathi and
  ulb;
* sarathi's chunked prefill: equal to ``repro`` and to the unchunked run;
  ``prefill_chunk`` logits; a slot held mid-chunk is never handed out
  twice nor decoded;
* ``api.serve`` open-loop from a ``WorkloadSpec`` (tokens differ by
  design; the decisions do not depend on them), fused decode, bounded
  admission, deadline shedding and aborts;
* the hybrid stack under accellm (no chunk execution);
* entry points raise without a card unless given ``device="cpu"``, and
  the mesh and prefix-cache paths raise ``NotImplementedError``.
"""
import jax
import numpy as np
import pytest
import torch

import repro.api as rapi
import repro.configs as rcfg
import repro.models as rm
import repro.scheduling.registry as rreg
import repro.workloads as rwl
from repro.scheduling.live import LiveCluster as RLiveCluster
from repro.serving import InstanceEngine as REngine
from repro.serving import Request as RRequest
from repro.stepplan import PrefillItem as RPrefillItem
from repro.stepplan import PrefillPlan as RPrefillPlan
import repro_torch.api as tapi
import repro_torch.configs as tcfg
import repro_torch.models as tm
import repro_torch.scheduling.registry as treg
import repro_torch.workloads as twl
from repro_torch.bridge import params_from_numpy
from repro_torch.scheduling.live import LiveCluster
from repro_torch.serving import InstanceEngine, Request
from repro_torch.stepplan import PrefillItem, PrefillPlan

TOL = 1e-4


def _bridge(arch):
    cfg_r = rcfg.get_config(arch).reduced()
    cfg = tcfg.get_config(arch).reduced()
    params_r = rm.init_params(jax.random.PRNGKey(0), cfg_r)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, params_r),
                               device="cpu")
    return cfg_r, cfg, params_r, params


@pytest.fixture(scope="module")
def setup():
    return _bridge("starcoder2-3b")


def _toks(i, plen, vocab):
    return np.random.default_rng(500 + i).integers(0, vocab, (1, plen),
                                                   dtype=np.int32)


def _reqs(shapes, vocab, arrivals=None):
    """The same requests for both packages: (ref, port) lists."""
    out = ([], [])
    for i, (plen, new) in enumerate(shapes):
        arrival = 0.0 if arrivals is None else arrivals[i]
        for mod, lst in ((RRequest, out[0]), (Request, out[1])):
            lst.append(mod(prompt_len=plen, max_new_tokens=new, rid=i,
                           arrival=arrival,
                           prompt_tokens=_toks(i, plen, vocab)))
    return out


def _clusters(setup, policy, n_instances=2, num_slots=6, kv_capacity=64,
              policy_kwargs=None, trace=True, **kw):
    """(ref, port) clusters under their own copies of ``policy``, with the
    kernel's and the planner's traces switched on."""
    cfg_r, cfg, params_r, params = setup
    pols = (rreg.get_policy(policy, **(policy_kwargs or {})),
            treg.get_policy(policy, **(policy_kwargs or {})))
    ref = RLiveCluster(cfg_r, params_r, n_instances, num_slots, kv_capacity,
                       pols[0], **kw)
    port = LiveCluster(cfg, params, n_instances, num_slots, kv_capacity,
                       pols[1], device="cpu", **kw)
    for c in (ref, port):
        if trace:
            c.policy.trace = []
            c.planner.trace = []
    return ref, port


def _outcome(cluster, reqs):
    return {
        "stats": dict(cluster.stats),
        "now": cluster.now, "iterations": cluster.n_iterations,
        "kernel_trace": getattr(cluster.policy, "trace", None),
        "plan_trace": cluster.planner.trace,
        "tokens": [list(map(int, r.output_tokens)) for r in reqs],
        "stamps": [(r.phase.name, r.first_token_time, r.finish_time,
                    list(r.token_times)) for r in reqs],
        "timeline": [tuple(vars(p).values()) for p in cluster.timeline],
        "shed": sorted(r.rid for r in cluster.shed),
        "aborted": sorted(r.rid for r in cluster.aborted),
    }


def _run_both(setup, policy, shapes, max_steps=300, **kw):
    ref, port = _clusters(setup, policy, **kw)
    reqs = _reqs(shapes, ref.cfg.vocab_size)
    for c, rs in ((ref, reqs[0]), (port, reqs[1])):
        for r in rs:
            c.submit(r)
        c.run(max_steps=max_steps)
    return _outcome(ref, reqs[0]), _outcome(port, reqs[1])


# ---------------------------------------------------------------------------
# the golden trace of the JAX package's tests
# ---------------------------------------------------------------------------

# (prompt_len, decode_len) per arrival; interleaved with bare decode ticks
_TRACE = [("arrive", 8, 4), ("tick",), ("arrive", 12, 6), ("arrive", 6, 5),
          ("tick",), ("arrive", 10, 3), ("tick",), ("arrive", 7, 6),
          ("arrive", 9, 4), ("tick",)]


@pytest.mark.parametrize("n_instances", [2, 4])
def test_golden_trace_matches_reference(setup, n_instances):
    ref, port = _clusters(setup, "accellm", n_instances=n_instances,
                          num_slots=8, kv_capacity=256)
    shapes = [(op[1], op[2]) for op in _TRACE if op[0] == "arrive"]
    reqs = _reqs(shapes, ref.cfg.vocab_size)
    for c, rs in ((ref, reqs[0]), (port, reqs[1])):
        it = iter(rs)
        for op in _TRACE:
            if op[0] == "arrive":
                c.submit(next(it))
            c.step()
        for _ in range(50):
            if not c.pending():
                break
            c.step()
        assert not c.pending()
    out_r, out_t = _outcome(ref, reqs[0]), _outcome(port, reqs[1])
    assert out_t == out_r
    kinds = {e[0] for e in out_t["kernel_trace"]}
    assert {"route", "place"} <= kinds
    if n_instances == 2:
        assert "rebalance" in kinds
        assert out_t["stats"]["mirror_syncs"] > 0
    assert all(len(t) == n for t, (_, n) in zip(out_t["tokens"], shapes))


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------

_SHAPES = [(6 + (i % 3) * 4, 3 + (i % 3)) for i in range(5)]


@pytest.mark.parametrize("policy", ["vllm", "splitwise", "sarathi", "ulb"])
def test_baseline_policies_match_reference(setup, policy):
    out_r, out_t = _run_both(setup, policy, _SHAPES)
    assert out_t == out_r
    assert out_t["stats"]["prefills"] == len(_SHAPES)
    assert out_t["stats"]["mirror_syncs"] == 0
    if policy == "splitwise":
        # every prompt streams from the prefill instance to the decoder
        assert out_t["stats"]["stream_bytes"] > 0


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------

_LONG = [(21, 5), (9, 4), (30, 3)]


def test_sarathi_chunked_matches_reference_and_unchunked(setup):
    out_r, out_t = _run_both(setup, "sarathi", _LONG,
                             policy_kwargs={"chunk_tokens": 8})
    assert out_t == out_r
    resumed = [it for e in out_t["plan_trace"] if e[0] in ("prefill", "mixed")
               for it in e[2][0 if e[0] == "mixed" else slice(None)]
               if it[1] > 0]
    assert resumed, "no chunk resumed past its prompt's start"
    _, whole = _clusters(setup, "sarathi", policy_kwargs={"chunk_tokens": 512})
    reqs = _reqs(_LONG, whole.cfg.vocab_size)[1]
    for r in reqs:
        whole.submit(r)
    whole.run(max_steps=300)
    assert _outcome(whole, reqs)["tokens"] == out_t["tokens"]


def test_prefill_chunk_logits_match_reference(setup):
    cfg_r, cfg, params_r, params = setup
    toks = _toks(7, 29, cfg.vocab_size)
    st_r = rm.init_state(cfg_r, 1, 64)
    st_t = tm.init_state(cfg, 1, 64, device="cpu")
    for lo, hi in ((0, 8), (8, 16), (16, 29)):
        lr, st_r = rm.prefill_chunk(cfg_r, params_r, toks[:, lo:hi], st_r,
                                    history=lo)
        lt, st_t = tm.prefill_chunk(cfg, params, torch.as_tensor(
            toks[:, lo:hi]), st_t, history=lo)
        assert np.abs(np.asarray(lr) - lt.numpy()).max() <= TOL, (lo, hi)
    whole, _ = tm.prefill(cfg, params, {"tokens": torch.as_tensor(toks)},
                          tm.init_state(cfg, 1, 64, device="cpu"))
    assert (whole - lt).abs().max() <= TOL
    for seg_r, seg_t in zip(st_r["layers"], st_t["layers"]):
        for key in ("k", "v"):
            a = np.asarray(seg_r["p0"][key])[:, :, :29]
            b = seg_t["p0"][key][:, :, :29].numpy()
            assert np.abs(a - b).max() <= TOL


def test_held_slot_is_never_reissued_nor_decoded(setup):
    """A prompt mid-chunk holds its slot: ``free_slots`` skips it, decode
    never emits for it, and its chunks land like ``repro``'s."""
    cfg_r, cfg, params_r, params = setup
    eng_r = REngine(cfg_r, params_r, num_slots=2, kv_capacity=32)
    eng_t = InstanceEngine(cfg, params, num_slots=2, kv_capacity=32,
                           device="cpu")
    (a_r, b_r), (a_t, b_t) = _reqs([(20, 4), (6, 6)], cfg.vocab_size)
    out = []
    for eng, a, b, Item, Plan in ((eng_r, a_r, b_r, RPrefillItem,
                                   RPrefillPlan),
                                  (eng_t, a_t, b_t, PrefillItem,
                                   PrefillPlan)):
        done = eng.prefill_batch(Plan(0, (Item(b.rid, 6, 0, 6, req=b),), 16))
        held = eng.prefill_batch(Plan(0, (Item(a.rid, 20, 0, 8, req=a),), 16))
        assert held == {} and len(eng.prefilling) == 1
        slot = next(iter(eng.prefilling))
        assert slot not in eng.free_slots() and eng.free_slots() == []
        toks = eng.decode()
        assert slot not in toks and set(toks) == {done[b.rid]}
        eng.prefill_batch(Plan(0, (Item(a.rid, 20, 8, 16, req=a),), 16))
        assert eng.store.lines(a.rid) == 16
        fin = eng.prefill_batch(Plan(0, (Item(a.rid, 20, 16, 20, req=a),),
                                     16))
        assert fin == {a.rid: slot} and not eng.prefilling
        while eng.slot_req:
            eng.decode()
        # no prefix cache: a stamp is a 0-line hit, an abandon clears it
        out.append((a.output_tokens, b.output_tokens, eng.prefix_stamp(b),
                    b.prefix_hit, eng.prefix_abandon(b), b.prefix_hit))
    assert out[1] == out[0]
    assert out[1][2:] == (0, 0, None, None)


# ---------------------------------------------------------------------------
# api.serve, fusing, admission control, aborts
# ---------------------------------------------------------------------------


def _traffic(mod):
    return mod.WorkloadSpec(arrival=mod.Poisson(rate=0.6, duration=7.0),
                            lengths=mod.TableLengths("light", scale=0.03),
                            name="parity")


def test_serve_open_loop_matches_reference(setup):
    cfg_r, cfg, params_r, params = setup
    kw = dict(arch="starcoder2-3b", policy="accellm", n_instances=2,
              num_slots=6, kv_capacity=64, max_steps=400, seed=3)
    rep_r = rapi.serve(rapi.ServeSpec(traffic=_traffic(rwl), **kw),
                       cfg=cfg_r, params=params_r)
    rep_t = tapi.serve(tapi.ServeSpec(traffic=_traffic(twl), device="cpu",
                                      **kw), cfg=cfg, params=params)
    assert rep_t.all_finished and rep_r.all_finished
    assert rep_t.n_submitted == rep_r.n_submitted >= 4
    for f in ("ttfts", "tbts", "jcts"):
        assert np.array_equal(getattr(rep_t, f)(), getattr(rep_r, f)()), f
    assert rep_t.stats == rep_r.stats
    assert rep_t.duration == rep_r.duration
    assert rep_t.utilization() == rep_r.utilization()
    assert rep_t.queue_depth() == rep_r.queue_depth()
    assert rep_t.goodput(twl.SLO(ttft=4.0)) == \
        rep_r.goodput(rwl.SLO(ttft=4.0))
    assert rep_t.fleet_stats is None
    assert "stats:" in rep_t.describe()
    assert rep_t.stats["mirror_syncs"] > 0


class _Replay:
    """An open-loop source over fixed requests (what ``run`` reads of a
    ``RequestSource``), so both packages see the same prompt tokens."""

    def __init__(self, reqs):
        self._reqs, self.concurrency = reqs, None

    def __iter__(self):
        return iter(self._reqs)


def test_fused_decode_matches_reference(setup):
    ref, port = _clusters(setup, "accellm", fuse_decode_steps=4,
                          policy_kwargs={"redundancy": False})
    shapes = [(8, 12), (10, 9), (7, 14), (12, 6)]
    reqs = _reqs(shapes, ref.cfg.vocab_size, arrivals=[0.0, 0.0, 9.0, 20.0])
    for c, rs in ((ref, reqs[0]), (port, reqs[1])):
        c.run(max_steps=200, source=_Replay(rs))
    out_r, out_t = _outcome(ref, reqs[0]), _outcome(port, reqs[1])
    assert out_t == out_r
    assert any(e[0] == "decode" and e[4] > 1 for e in out_t["plan_trace"])
    assert out_t["iterations"] > len(
        [e for e in out_t["plan_trace"] if e[0] == "decode"])


@pytest.mark.parametrize("kw", [{"max_queue": 3}, {"shed_deadline": 2.0}],
                         ids=["max_queue", "shed_deadline"])
def test_admission_control_matches_reference(setup, kw):
    shapes = [(8 + i % 4, 4 + i % 3) for i in range(7)]
    out_r, out_t = _run_both(setup, "accellm", shapes, num_slots=2, **kw)
    assert out_t == out_r
    assert out_t["stats"]["sheds"] > 0
    assert out_t["stats"]["prefills"] + out_t["stats"]["sheds"] == len(shapes)


@pytest.mark.parametrize("policy,kw", [("accellm", {}),
                                       ("sarathi", {"chunk_tokens": 4})],
                         ids=["accellm", "sarathi"])
def test_abort_matches_reference(setup, policy, kw):
    ref, port = _clusters(setup, policy, num_slots=3, policy_kwargs=kw)
    shapes = [(14, 8), (9, 7), (12, 9), (10, 6)]
    reqs = _reqs(shapes, ref.cfg.vocab_size)
    phases = []
    for c, rs in ((ref, reqs[0]), (port, reqs[1])):
        for r in rs:
            c.submit(r)
        got = []
        for step, rid in ((2, 0), (1, 3), (1, 2), (0, 99)):
            for _ in range(step):
                c.step()
            found = c.abort(rid)
            got.append((rid, None if found is None else found.phase.name))
        c.run(max_steps=300)
        phases.append(got)
    assert phases[1] == phases[0]
    out_r, out_t = _outcome(ref, reqs[0]), _outcome(port, reqs[1])
    assert out_t == out_r
    assert out_t["stats"]["aborts"] == 3
    for eng in port.engines:
        assert not eng.slot_req and not eng.replica_of and not eng.prefilling
        assert eng.store.used_bytes() == 0


# ---------------------------------------------------------------------------
# the hybrid stack
# ---------------------------------------------------------------------------


def test_hybrid_accellm_matches_reference():
    setup = _bridge("jamba-1.5-large-398b")
    # one prompt length: the reference compiles its unpadded prefill per
    # length
    shapes = [(8, 4), (8, 5), (8, 3)]
    ref, port = _clusters(setup, "accellm", num_slots=4, kv_capacity=32)
    assert not ref.planner.chunk_execution
    assert not port.planner.chunk_execution
    reqs = _reqs(shapes, ref.cfg.vocab_size)
    for c, rs in ((ref, reqs[0]), (port, reqs[1])):
        for r in rs:
            c.submit(r)
        c.run(max_steps=100)
    out_r, out_t = _outcome(ref, reqs[0]), _outcome(port, reqs[1])
    assert out_t == out_r
    assert out_t["stats"]["mirror_syncs"] > 0
    # the degrade rule: a first chunk on a stack that cannot resume runs
    # the whole prompt at once
    eng = port.engines[0]
    req = _reqs([(9, 2)], ref.cfg.vocab_size)[1][0]
    req.rid = 77
    done = eng.prefill_batch(PrefillPlan(0, (PrefillItem(77, 9, 0, 4,
                                                         req=req),), 16))
    assert 77 in done and eng.store.lines(77) == 10


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_entry_points_refuse_cpu_fallback(setup, monkeypatch):
    _, cfg, _, params = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        LiveCluster(cfg, params, 2, 2, 16, "accellm")
    with pytest.raises(RuntimeError, match="cuda"):
        tapi.serve(tapi.ServeSpec(arch="starcoder2-3b", n_instances=2,
                                  n_requests=1))
    assert LiveCluster(cfg, params, 2, 2, 16, "accellm", device="cpu")


def test_later_slices_raise(setup):
    _, cfg, _, params = setup
    for kw, what in (({"mesh": object()}, "mesh"),
                     ({"prefix_cache": True}, "prefix")):
        with pytest.raises(NotImplementedError, match=what):
            LiveCluster(cfg, params, 2, 2, 16, "accellm", device="cpu", **kw)
        spec_kw = {"mesh_tp": 2} if what == "mesh" else {"prefix_cache": True}
        with pytest.raises(NotImplementedError, match=what):
            tapi.build_cluster(tapi.ServeSpec(device="cpu", **spec_kw),
                               cfg=cfg, params=params)
    # the fleet slice has landed: its paths run (tests/test_torch_fleet.py
    # holds them against the JAX package)
    cluster = LiveCluster(cfg, params, 2, 2, 16, "accellm", device="cpu")
    cluster.fleet_degrade(0)
    cluster.fleet_recover(0)
    cluster.fleet_kill(0)
    assert cluster.fleet_join(0) == 0 and cluster.alive == [True, True]
    cluster.fleet_drain(1)
    assert cluster.alive == [True, False]
    assert [e[0] for e in cluster.fleet.trace] == [
        "degrade", "recover", "kill", "join", "drain", "drained"]
    with pytest.raises(ValueError, match="unknown fleet event"):
        cluster._apply_fleet_event(None)
    with pytest.raises(KeyError, match="scale slice"):
        LiveCluster(cfg, params, 2, 2, 16, "accellm-vec", device="cpu")
