"""The serving step's tracer (``repro_torch.core.tracing``) on the CPU.

The reduced starcoder2-3b in f32 serves a short trace under accellm
(prefills, streams to the partner, mirror syncs, promotions) and under
sarathi with 8-token chunks, once with a ``Tracer`` and once without:

* the tracer changes nothing the cluster serves;
* without one the program reads no clock;
* spans nest and balance, each step's children come in the order the
  step runs them, and ``mark`` sees every edge in order;
* the blocking device-to-host reads are counted one a plan;
* every request's stamps come in lifecycle order, its first token
  inside one step.
"""
import re
import time

import numpy as np
import pytest

from repro_torch.api import ServeSpec, build_cluster
from repro_torch.core.tracing import Tracer
from repro_torch.serving import Request

# (prompt_len, max_new_tokens), or a bare step
_TRACE = [(8, 4), None, (12, 6), (6, 5), None, (10, 3), None, (7, 6),
          (9, 4), None, (21, 5), (30, 3)]
POLICIES = {"accellm": {}, "sarathi": {"chunk_tokens": 8}}


def _serve(policy, tracer=None):
    cluster = build_cluster(ServeSpec(
        arch="starcoder2-3b", policy=policy,
        policy_kwargs=POLICIES[policy], n_instances=2, num_slots=8,
        kv_capacity=256, reduced=True, device="cpu", seed=0),
        tracer=tracer)
    vocab = cluster.cfg.vocab_size
    reqs = []
    for op in _TRACE:
        if op is not None:
            rid = len(reqs)
            toks = np.random.default_rng(500 + rid).integers(
                0, vocab, (1, op[0]), dtype=np.int32)
            reqs.append(Request(prompt_len=op[0], max_new_tokens=op[1],
                                rid=rid, prompt_tokens=toks))
            cluster.submit(reqs[-1])
        cluster.step()
    for _ in range(200):
        if not cluster.pending():
            break
        cluster.step()
    assert not cluster.pending()
    return cluster, reqs


def _outcome(cluster, reqs):
    return {"tokens": [list(map(int, r.output_tokens)) for r in reqs],
            "stamps": [(r.phase.name, r.first_token_time, r.finish_time,
                        list(r.token_times)) for r in reqs],
            "stats": dict(cluster.stats),
            "timeline": [tuple(vars(p).values()) for p in cluster.timeline],
            "host_syncs": [e.host_syncs for e in cluster.engines],
            "iterations": cluster.n_iterations}


@pytest.fixture(scope="module", params=sorted(POLICIES))
def traced(request):
    """(policy, cluster, requests, tracer, marks) of a traced serve."""
    marks = []
    tracer = Tracer(mark=marks.append)
    cluster, reqs = _serve(request.param, tracer)
    return request.param, cluster, reqs, tracer, marks


def _children(spans):
    """Each span's direct children in the order they ran, by index into
    ``spans`` (which lists a span after all it holds)."""
    kids = {i: [] for i in range(len(spans))}
    open_ = []       # (index, depth) of spans seen whose parent is later
    for i, (_, depth, _, _) in enumerate(spans):
        mine = [j for j, d in open_ if d == depth + 1]
        kids[i] = sorted(mine, key=lambda j: spans[j][2])
        open_ = [(j, d) for j, d in open_ if d <= depth] + [(i, depth)]
    return kids


def test_tracer_on_and_off_serve_alike(traced):
    policy, cluster, reqs, tracer, _ = traced
    assert tracer.spans and tracer.counters and tracer.stamps
    assert _outcome(cluster, reqs) == _outcome(*_serve(policy))


def test_no_tracer_reads_no_clock(monkeypatch):
    def refuse():
        raise AssertionError("the untraced program read the clock")
    monkeypatch.setattr(time, "perf_counter_ns", refuse)
    cluster, _ = _serve("accellm")
    assert cluster.tracer is None
    assert all(e.tracer is None and e.store.tracer is None
               for e in cluster.engines)
    with pytest.raises(AssertionError):
        Tracer().begin("x")


def test_the_traffic_reaches_every_span(traced):
    policy, cluster, _, tracer, _ = traced
    names = {s[0] for s in tracer.spans}
    assert {"cluster.step", "cluster.schedule", "cluster.prefill",
            "engine.prefill", "engine.prefill.launch", "engine.prefill.sync",
            "kv.merge", "kv.alloc", "cluster.relieve", "engine.decode",
            "engine.decode.launch", "engine.decode.sync",
            "engine.decode.book", "cluster.release"} <= names
    if policy == "accellm":
        assert cluster.stats["replica_promotions"] > 0
        assert {"kv.stream", "kv.stream.slot", "kv.stream.alloc",
                "kv.stream.copy", "kv.mirror", "kv.promote"} <= names


# a step's direct children, one letter each, in the order the step runs
# them: scheduling, prefills, placements with their streams, then each
# decode plan after its relief, the release, the mirror syncs and the
# rebalancing with their moves
_LETTER = {"cluster.schedule": "S", "cluster.prefill": "P",
           "cluster.relieve": "R", "engine.decode": "D",
           "cluster.release": "L", "kv.stream": "K", "kv.mirror": "K",
           "kv.promote": "K"}
_STEP = re.compile(r"SP*(SK*)*(RD?)*LSK*(SK*)*")
_INSIDE = {"cluster.prefill": r"(engine\.prefill )+",
           "engine.prefill": r"(engine\.prefill\.launch (kv\.merge )?"
                             r"(engine\.prefill\.sync )?"
                             r"(kv\.merge |kv\.alloc )*)+",
           "kv.stream.alloc": r"kv\.alloc ",
           "engine.decode": r"engine\.decode\.launch engine\.decode\.sync "
                            r"engine\.decode\.book ",
           "kv.stream": r"kv\.stream\.slot (kv\.stream\.alloc "
                        r"kv\.stream\.copy )?"}


def test_spans_nest_balance_and_keep_the_step_order(traced):
    _, cluster, _, tracer, _ = traced
    spans = tracer.spans
    assert not tracer._open
    kids = _children(spans)
    steps = [i for i, s in enumerate(spans) if s[0] == "cluster.step"]
    assert steps
    assert all(spans[i][1] == 0 for i in steps)
    assert sum(1 for s in spans if s[1] == 0) == len(steps)
    for i, (name, depth, t0, t1) in enumerate(spans):
        assert t0 <= t1
        for j in kids[i]:
            assert spans[j][1] == depth + 1
            assert t0 <= spans[j][2] <= spans[j][3] <= t1
        seq = [spans[j][0] for j in kids[i]]
        if name == "cluster.step":
            assert _STEP.fullmatch("".join(_LETTER[n] for n in seq)), seq
        elif name in _INSIDE:
            assert re.fullmatch(_INSIDE[name], "".join(
                n + " " for n in seq)), (name, seq)
        # siblings do not overlap
        for a, b in zip(kids[i], kids[i][1:]):
            assert spans[a][3] <= spans[b][2]


def test_mark_sees_every_edge_in_order(traced):
    _, _, _, tracer, marks = traced
    edges = sorted([(t0, "+" + n) for n, _, t0, _ in tracer.spans]
                   + [(t1, "-" + n) for n, _, _, t1 in tracer.spans])
    assert marks == [label for _, label in edges]
    stack = []
    for label in marks:
        if label[0] == "+":
            stack.append(label[1:])
        else:
            assert stack.pop() == label[1:]
    assert not stack


def test_end_closes_what_a_raise_left_open():
    marks = []
    tr = Tracer(mark=marks.append)
    with pytest.raises(RuntimeError):
        with tr.span("outer"):
            tr.begin("inner")
            raise RuntimeError
    assert marks == ["+outer", "+inner", "-inner", "-outer"]
    assert [(n, d) for n, d, _, _ in tr.spans] == [("inner", 1),
                                                   ("outer", 0)]
    with pytest.raises(ValueError):
        tr.end("outer")


def test_host_reads_are_counted_one_a_plan(traced):
    _, cluster, _, tracer, _ = traced
    n = {name: sum(1 for s in tracer.spans if s[0] == name)
         for name in ("engine.decode", "engine.prefill.sync")}
    c = tracer.counters
    assert c["d2h.decode"] == n["engine.decode"] \
        == sum(e.host_syncs for e in cluster.engines)
    assert c["d2h.prefill.sample"] == n["engine.prefill.sync"]
    assert 1 <= c["tables.rebuild"] <= c["d2h.decode"]
    # on the CPU every paged decode plan runs op by op (no CUDA graph)
    assert c["decode.graph.eager"] == c["d2h.decode"]
    assert set(c) == {"d2h.decode", "d2h.prefill.sample", "tables.rebuild",
                      "decode.graph.eager"}


def test_request_stamps_come_in_lifecycle_order(traced):
    _, _, reqs, tracer, _ = traced
    steps = [(t0, t1) for n, _, t0, t1 in tracer.spans
             if n == "cluster.step"]
    for r in reqs:
        st = tracer.stamps[r.rid]
        assert st["submit"] <= st["prefill"] <= st["first"] <= st["done"]
        # the first token reaches the host inside a step, before its end
        assert sum(1 for t0, t1 in steps if t0 <= st["first"] <= t1) == 1
