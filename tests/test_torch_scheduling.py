"""The port's copies of the JAX package's scheduling layers, on the CPU.

No model runs here: the balancer, the step planner, the policy registry
and the workload layer are plain Python, so each copy is held against its
original on the same inputs.

* ``partition`` / ``should_rebalance`` equal on drawn items;
* ``Planner`` plan traces equal for accellm, vllm and sarathi (chunks of
  8 tokens), with fusing on and off, against a shared fake view;
* ``RequestSource`` streams equal field by field without a config; with
  one, the port's numpy-drawn tokens lie in the vocabulary, are fixed by
  ``(seed, i)`` and share each prefix group's head;
* ``slo_summary``, ``utilization`` and ``queue_depth_stats`` equal;
* the registry's names equal the JAX package's, the four ``-vec`` names
  included.
"""
import dataclasses
import math

import numpy as np
import pytest
from _propcheck import given, settings, st

import repro.core.balancer as rbal
import repro.scheduling.actions as racts
import repro.scheduling.registry as rreg
import repro.stepplan.planner as rplanner
import repro.workloads as rwl
import repro.serving.request as rrequest
import repro_torch.configs as tcfg
from repro_torch.configs.base import FrontendStub
import repro_torch.core.balancer as tbal
import repro_torch.scheduling.actions as tacts
import repro_torch.scheduling.registry as treg
import repro_torch.stepplan.planner as tplanner
import repro_torch.workloads as twl
import repro_torch.serving.request as trequest
from repro.stepplan.plans import PlanError as RPlanError
from repro_torch.stepplan.plans import PlanError as TPlanError

# ---------------------------------------------------------------------------
# balancer
# ---------------------------------------------------------------------------

rows_strategy = st.lists(
    st.tuples(st.floats(min_value=1.0, max_value=1e9),
              st.integers(min_value=0, max_value=1),
              st.booleans()),
    min_size=0, max_size=40)


def _items(mod, rows):
    return [mod.Item(rid=i, weight=w, home=h, movable=m)
            for i, (w, h, m) in enumerate(rows)]


@given(rows_strategy)
@settings(max_examples=200, deadline=None)
def test_partition_matches_reference(rows):
    ref = rbal.partition(_items(rbal, rows))
    port = tbal.partition(_items(tbal, rows))
    assert port[0] == ref[0] and port[1] == ref[1]
    assert sorted(port[2]) == sorted(ref[2])


@given(rows_strategy, st.integers(min_value=1, max_value=4),
       st.floats(min_value=0.0, max_value=1.0))
@settings(max_examples=200, deadline=None)
def test_should_rebalance_matches_reference(rows, trigger, frac):
    assert (tbal.should_rebalance(_items(tbal, rows), trigger, frac)
            == rbal.should_rebalance(_items(rbal, rows), trigger, frac))
    assert tbal.imbalance(_items(tbal, rows)) == \
        rbal.imbalance(_items(rbal, rows))


# ---------------------------------------------------------------------------
# step planner
# ---------------------------------------------------------------------------


class _Inst:
    """The ledger quantities the planner reads from an instance view."""

    def __init__(self, lines, synced, backlog, remaining):
        self._lines, self._synced = lines, synced
        self._backlog, self._rem = backlog, remaining

    def request_lines(self):
        return dict(self._lines)

    def replica_synced(self):
        return dict(self._synced)

    def prefill_backlog(self):
        return self._backlog

    def decode_remaining(self):
        return dict(self._rem)

    def block_lines(self):
        return 16


class _View:
    def __init__(self, insts, placements):
        self._insts, self._pl = insts, placements

    def instances(self):
        return self._insts

    def placements(self):
        return dict(self._pl)


def _scenario(seed, n_iters=14, n_inst=2):
    """Per iteration: the view's ledger and the actions, as plain tuples
    both packages' records are built from."""
    rng = np.random.default_rng(seed)
    next_rid = 0
    out = []
    for _ in range(n_iters):
        acts = []
        for idx in range(n_inst):
            for _ in range(int(rng.integers(0, 3))):
                plen = int(rng.integers(3, 30))
                acts.append(("prefill", next_rid, idx, plen))
                next_rid += 1
            if rng.random() < 0.7:
                acts.append(("decode", idx))
        resident = {idx: {rid: int(rng.integers(1, 60))
                          for rid in range(int(rng.integers(0, 5)))}
                    for idx in range(n_inst)}
        for idx, lines in resident.items():
            for rid in lines:
                if rng.random() < 0.3:
                    acts.append(("mirror", 1000 * idx + rid, idx,
                                 (idx + 1) % n_inst))
        if rng.random() < 0.3:
            acts.append(("stream", 1000, 0, 1))
        ledger = [({1000 * idx + rid: n for rid, n in resident[idx].items()},
                   {1000 * ((idx + 1) % n_inst) + rid: n // 2
                    for rid, n in resident[(idx + 1) % n_inst].items()},
                   int(rng.random() < 0.3),
                   {1000 * idx + rid: int(rng.integers(1, 20))
                    for rid in resident[idx]})
                  for idx in range(n_inst)]
        mirrored = {1000 * idx + rid: (idx, (idx + 1) % n_inst
                                        if rng.random() < 0.15 else None)
                    for idx in range(n_inst) for rid in resident[idx]}
        out.append((acts, ledger, mirrored, int(rng.integers(1, 9))))
    return out


def _actions(mod, acts):
    out = []
    for a in acts:
        if a[0] == "prefill":
            out.append(mod.Prefill(a[1], a[2], a[3]))
        elif a[0] == "decode":
            out.append(mod.Decode(a[1]))
        elif a[0] == "mirror":
            out.append(mod.MirrorSync(a[1], a[2], a[3]))
        else:
            out.append(mod.StreamState(a[1], a[2], a[3]))
    return out


def _plan_run(planner_mod, acts_mod, reg_mod, PlanError, policy, kw, fuse,
              scenario):
    planner = planner_mod.Planner.for_policy(reg_mod.get_policy(policy, **kw))
    planner.trace = []
    planner.decode_details = False
    planner.max_fuse_steps = fuse
    chunking = {}       # rid -> (instance, prompt_len) of prompts mid-chunk
    log = []
    for acts, ledger, mirrored, horizon in scenario:
        if planner.chunk_tokens is not None:
            # in-progress prompts come first, as the live executor orders
            acts = [("prefill", rid, idx, plen)
                    for rid, (idx, plen) in sorted(chunking.items())] + \
                [a for a in acts if a[0] != "prefill"
                 or a[1] not in chunking]
        view = _View([_Inst(*lg) for lg in ledger], mirrored)
        planner.fuse_horizon = horizon
        if not planner.allow_mixed:
            # the exclusive-prefill role: an instance that prefills this
            # iteration does not decode; one mixed case stays to raise
            pf = {a[2] for a in acts if a[0] == "prefill"}
            acts = [a for a in acts if a[0] != "decode" or a[1] not in pf
                    or a[1] == 1]
        try:
            plans = planner.compile(_actions(acts_mod, acts), view)
        except PlanError as e:
            log.append(("PlanError", str(e)))
            acts = [a for a in acts if not (a[0] == "decode" and a[1] == 1)]
            plans = planner.compile(_actions(acts_mod, acts), view)
        log.append(tuple(planner_mod._normalize(p) for p in plans))
        for p in plans:
            pf = p.prefill if hasattr(p, "prefill") else p
            for it in getattr(pf, "items", ()):
                if it.completes:
                    chunking.pop(it.rid, None)
                else:
                    chunking[it.rid] = (pf.instance, it.prompt_len)
        log.append(tuple(sorted((rid, planner.cursor(rid))
                                for rid in chunking)))
    return planner.trace, log


@pytest.mark.parametrize("fuse", [1, 8], ids=["unfused", "fused"])
@pytest.mark.parametrize("policy,kw", [("accellm", {}), ("vllm", {}),
                                       ("sarathi", {"chunk_tokens": 8})],
                         ids=["accellm", "vllm", "sarathi"])
def test_planner_trace_matches_reference(policy, kw, fuse):
    scenario = _scenario(seed=len(policy) * 10 + fuse)
    ref = _plan_run(rplanner, racts, rreg, RPlanError, policy, kw, fuse,
                    scenario)
    port = _plan_run(tplanner, tacts, treg, TPlanError, policy, kw, fuse,
                     scenario)
    assert port == ref
    trace, log = ref
    # (steps of every decode, (rid, start, end) of every prefill item)
    steps = ([e[4] for e in trace if e[0] == "decode"]
             + [e[3][2] for e in trace if e[0] == "mixed"])
    items = [it for e in trace if e[0] in ("prefill", "mixed")
             for it in e[2][0 if e[0] == "mixed" else slice(None)]]
    assert steps and items
    if fuse > 1:
        assert max(steps) > 1
    if policy == "sarathi":
        assert any(start > 0 for _, start, _ in items)
    if policy == "accellm":
        assert any(e[0] == "PlanError" for e in log)


# ---------------------------------------------------------------------------
# workload layer
# ---------------------------------------------------------------------------


def _arrivals(mod):
    return {
        "batch": mod.Batch(6),
        "poisson": mod.Poisson(rate=0.8, duration=20.0),
        "bursty": mod.Bursty(rate_on=1.0, duration=12.0, mean_on=3.0,
                             mean_off=2.0),
        "diurnal": mod.DiurnalRamp(low=0.2, peak=1.5, period=10.0,
                                   duration=20.0),
        "closed": mod.ClosedLoop(k=3, n_requests=7),
    }


def _spec(mod, arrival, reuse):
    pr = (mod.PrefixReuse(pool=3, reuse=0.6, prefix_len=8, growth=2,
                          max_prefix=14) if reuse else None)
    return mod.WorkloadSpec(arrival=_arrivals(mod)[arrival],
                            lengths=mod.TableLengths("light", scale=0.1),
                            prefix_reuse=pr)


FIELDS = ("rid", "arrival", "prompt_len", "max_new_tokens", "prefix_id",
          "prefix_len")


@pytest.mark.parametrize("reuse", [False, True], ids=["unique", "prefix"])
@pytest.mark.parametrize("arrival", ["batch", "poisson", "bursty",
                                     "diurnal", "closed"])
def test_request_source_matches_reference(arrival, reuse):
    ref_src = _spec(rwl, arrival, reuse).source(seed=5)
    port_src = _spec(twl, arrival, reuse).source(seed=5)
    assert port_src.concurrency == ref_src.concurrency
    ref = [tuple(getattr(r, f) for f in FIELDS) for r in ref_src]
    port = [tuple(getattr(r, f) for f in FIELDS) for r in port_src]
    assert port == ref and len(port) >= 3
    if reuse:
        assert any(r[4] is not None for r in port)


def test_request_source_tokens_by_design():
    """With a config the port draws its own tokens (numpy, not
    jax.random): in the vocabulary, fixed by (seed, i), shared by each
    prefix group's members over the group's declared head."""
    cfg = tcfg.get_config("starcoder2-3b").reduced()
    spec = _spec(twl, "poisson", True)
    a = list(spec.source(seed=3, cfg=cfg))
    b = list(spec.source(seed=3, cfg=cfg))
    c = list(spec.source(seed=4, cfg=cfg))
    bare = list(spec.source(seed=3))
    assert [tuple(getattr(r, f) for f in FIELDS) for r in a] == \
        [tuple(getattr(r, f) for f in FIELDS) for r in bare]
    for r, r2 in zip(a, b):
        t = np.asarray(r.prompt_tokens)
        assert t.shape == (1, r.prompt_len) and t.dtype == np.int32
        assert t.min() >= 0 and t.max() < cfg.vocab_size
        assert np.array_equal(t, np.asarray(r2.prompt_tokens))
        assert r.extra is None
    assert any(not np.array_equal(np.asarray(r.prompt_tokens)[:, :4],
                                  np.asarray(r3.prompt_tokens)[:, :4])
               for r, r3 in zip(a, c))
    groups = {}
    for r in a:
        if r.prefix_id is not None and r.prefix_len > 0:
            groups.setdefault(r.prefix_id, []).append(r)
    assert any(len(g) > 1 for g in groups.values())
    for members in groups.values():
        n = min(r.prefix_len for r in members)
        heads = {tuple(np.asarray(r.prompt_tokens)[0, :n]) for r in members}
        assert len(heads) == 1


def test_default_extras_waits_for_the_encoder_slice():
    """The payloads arrived with the encoder-decoder slice: none for a
    text-only config; for a vision front end and for an enc-dec model, the
    JAX package's key, shape and dtype, drawn from (seed, 1000 + i)."""
    import jax
    import repro.configs as rcfg
    cfg = tcfg.get_config("starcoder2-3b").reduced()
    assert twl.default_extras(cfg, 0, 0) is None
    vision = dataclasses.replace(cfg, frontend=FrontendStub(
        kind="vision", num_prefix_tokens=8, embed_dim=cfg.d_model))
    for own, ref in ((vision, None),
                     (tcfg.get_config("internvl2-1b"),
                      rcfg.get_config("internvl2-1b")),
                     (tcfg.get_config("seamless-m4t-large-v2"),
                      rcfg.get_config("seamless-m4t-large-v2"))):
        got = twl.default_extras(own, 5, 3)
        want = np.random.default_rng([5, 1003]).standard_normal(
            next(iter(got.values())).shape, dtype=np.float32)
        assert np.array_equal(next(iter(got.values())), want)
        if ref is not None:
            exp = rwl.default_extras(ref, jax.random.PRNGKey(5), 3)
            assert set(got) == set(exp)
            for k in got:
                assert got[k].shape == exp[k].shape
                assert got[k].dtype.name == exp[k].dtype.name


def _timeline_requests(mod, request_mod, n=9):
    rng = np.random.default_rng(11)
    reqs = []
    for i in range(n):
        r = request_mod.Request(prompt_len=8, max_new_tokens=4,
                                arrival=float(i), rid=i)
        kind = i % 4
        if kind == 3:
            r.phase = request_mod.Phase.SHED
        elif kind == 2 and i > 5:
            r.phase = request_mod.Phase.ABORTED
        else:
            r.first_token_time = float(i + rng.integers(0, 4))
            r.token_times = list(np.cumsum(
                [r.first_token_time] + list(rng.integers(1, 4, size=3))))
            r.token_times = [float(t) for t in r.token_times]
            if kind != 1 or i < 4:
                r.finish_time = r.token_times[-1]
                r.phase = request_mod.Phase.DONE
        reqs.append(r)
    points = [mod.TimelinePoint(t=float(t), queue_depth=int(q),
                                n_prefill=int(p), n_decode=int(d),
                                n_idle=2 - int(p) - int(d))
              for t, q, p, d in zip(range(12), rng.integers(0, 6, 12),
                                    rng.integers(0, 2, 12),
                                    rng.integers(0, 2, 12))]
    return reqs, points


@pytest.mark.parametrize("slo", [(float("inf"),) * 3, (3.0, 2.0, 9.0),
                                 (1.0, 1.0, 4.0)],
                         ids=["none", "loose", "tight"])
def test_metrics_match_reference(slo):
    r_reqs, r_pts = _timeline_requests(rwl, rrequest)
    t_reqs, t_pts = _timeline_requests(twl, trequest)
    ref = rwl.slo_summary(r_reqs, rwl.SLO(*slo), duration=12.0, unit="iters")
    port = twl.slo_summary(t_reqs, twl.SLO(*slo), duration=12.0,
                           unit="iters")
    ref_d, port_d = dataclasses.asdict(ref), dataclasses.asdict(port)
    assert port_d.keys() == ref_d.keys()
    for k, v in ref_d.items():
        assert (port_d[k] == v
                or (isinstance(v, float) and math.isnan(v)
                    and math.isnan(port_d[k]))), k
    assert port.describe() == ref.describe()
    assert twl.utilization(t_pts, 2) == rwl.utilization(r_pts, 2)
    assert twl.queue_depth_stats(t_pts) == rwl.queue_depth_stats(r_pts)
    assert ([twl.SLO(*slo).met_by(r) for r in t_reqs]
            == [rwl.SLO(*slo).met_by(r) for r in r_reqs])


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def test_registry_names_match_reference_minus_vec():
    """Every name of the JAX package's registry, since the scale slice
    the four ``-vec`` ones too."""
    ref = rreg.policy_names()
    assert treg.policy_names() == ref
    assert sum(n.endswith("-vec") for n in ref) == 4
    for name in treg.policy_names():
        pol = treg.get_policy(name)
        assert pol.name == rreg.get_policy(name).name == name
        for attr in ("requires_pairs", "allow_mixed", "chunk_tokens",
                     "requeue_unplaced"):
            assert getattr(pol, attr, None) == \
                getattr(rreg.get_policy(name), attr, None), (name, attr)
        for param in ("redundancy", "hedging", "chunk_tokens"):
            assert treg.policy_accepts(name, param) == \
                rreg.policy_accepts(name, param), (name, param)
    with pytest.raises(KeyError, match="unknown policy"):
        treg.get_policy("nope")

