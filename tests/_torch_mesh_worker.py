"""The port's side of the mesh-serving parity tests, run in gloo worlds.

``tests/test_torch_meshserve.py`` starts these functions on a world of
CPU processes (``repro_torch.meshserve.world.spawn``).  This module
imports torch, numpy and the port only, never JAX nor the JAX package,
and hands everything back as numpy and plain Python.  Every rank runs
every step (SPMD), so each function returns one result per rank.
"""
import dataclasses

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.meshserve import STATS, MeshPlacement, carve_slices
from repro_torch.meshserve.pool import local_state, shard_params
from repro_torch.meshserve.topology import group_of
from repro_torch.models import (decode_step_paged, init_state, prefill,
                                prefill_batched)
from repro_torch.models.moe import moe_forward
from repro_torch.scheduling.accellm import AcceLLMScheduler
from repro_torch.scheduling.live import LiveCluster
from repro_torch.serving import InstanceEngine, Request
from repro_torch import sharding

CPU = "cpu"


def prompt(i, plen, vocab, seed=3):
    return np.random.default_rng(seed * 1000 + i).integers(
        0, vocab, (1, plen), dtype=np.int32)


def requests(cfg, n, seed=3, steps=5, rid0=0):
    return [Request(prompt_len=6 + (i % 5), max_new_tokens=steps,
                    rid=rid0 + i,
                    prompt_tokens=prompt(i, 6 + (i % 5), cfg.vocab_size,
                                         seed))
            for i in range(n)]


def generate(cfg, params, mesh, steps=5, device=CPU):
    """The JAX package's ``_generate``: three requests prefilled one by
    one, then one fused decode plan."""
    eng = InstanceEngine(cfg, params, num_slots=4, kv_capacity=64,
                         temperature=0.0, mesh=mesh, device=device)
    reqs = requests(cfg, 3, steps=steps)
    for r in reqs:
        eng.prefill_request(r)
    eng.decode_multi(steps=steps - 1)
    return eng, [list(map(int, r.output_tokens)) for r in reqs]


def logits_at(cfg, params, sl):
    """Prefill logits of three padded prompts and one paged decode step's,
    under the slice's TP context (whole params without a slice)."""
    reqs = requests(cfg, 3)
    L = 16
    toks = np.zeros((4, L), np.int32)
    lens = np.ones((4,), np.int32)
    for i, r in enumerate(reqs):
        toks[i, :r.prompt_len] = r.prompt_tokens[0]
        lens[i] = r.prompt_len
    if sl is not None:
        params = shard_params(cfg, params, sl)
        state = local_state(cfg, sl, 4, L)
    else:
        state = init_state(cfg, 4, L, device=CPU)
    ctx = sharding.use_mesh(sl.group if sl is not None else None)
    with ctx:
        pre, state = prefill_batched(cfg, params, torch.as_tensor(toks),
                                     state, torch.as_tensor(lens))
        nxt = pre.argmax(-1).to(torch.int32)
        tables = torch.arange(4, dtype=torch.int32)[:, None]
        dec, _ = decode_step_paged(cfg, params, nxt[:, None], state,
                                   torch.as_tensor(lens), torch.arange(4),
                                   tables, L)
    return pre.numpy(), dec.numpy()


def six_heads(cfg):
    """A variant with 6 query and 2 KV heads: 6 heads do not divide a
    slice of 4, while the FFN, the experts and the vocab do."""
    return dataclasses.replace(cfg, num_heads=6, num_kv_heads=2)


def partial_tp(cfg, params, tp=4):
    """tp ``tp`` where the query heads do not divide it: this rank's
    tokens, logits, param and state bytes and param shapes."""
    (sl,) = carve_slices(tp, 1, device=CPU)
    eng, toks = generate(cfg, params, sl)
    out = {"tokens": toks, "holds": sl.holds,
           "state_bytes": eng.state_bytes(),
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in _leaves(eng.params)),
           "params": _shapes(eng.params), "state": _shapes(eng.state)}
    out["prefill"], out["decode"] = (logits_at(cfg, params, sl) if sl.holds
                                     else (None, None))
    return out


def tp_engines(cfg, params):
    out = {}
    for tp in (2, 4, 3):
        (sl,) = carve_slices(tp, 1, device=CPU)
        eng, toks = generate(cfg, params, sl)
        mine = {"tokens": toks, "holds": sl.holds,
                "state_bytes": eng.state_bytes(),
                "param_bytes": sum(t.numel() * t.element_size()
                                   for t in _leaves(eng.params))}
        if tp != 3:
            mine["prefill"], mine["decode"] = (
                logits_at(cfg, params, sl) if sl.holds else (None, None))
        out[tp] = mine
    return out


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rows(eng, slot, lines):
    """This rank's K rows [0, lines - 1) of ``slot`` (None on a shadow)."""
    if eng.state is None:
        return None
    k = eng.state["layers"][0]["p0"]["k"]
    return k[:, slot, :lines - 1].cpu().numpy().copy()


def _transfers():
    return (STATS.d2d_copies, STATS.d2d_bytes, STATS.host_copies,
            STATS.host_bytes)


def stream_and_mirror(cfg, params, tp=2, device=CPU):
    """The JAX package's cross-slice mirror test on two tp-``tp``
    slices."""
    a_sl, b_sl = carve_slices(tp, 2, device=device)
    a = InstanceEngine(cfg, params, num_slots=2, kv_capacity=64,
                       temperature=0.0, mesh=a_sl, device=device)
    b = InstanceEngine(cfg, params, num_slots=2, kv_capacity=64,
                       temperature=0.0, mesh=b_sl, device=device)
    (req,) = requests(cfg, 1, steps=4)
    slot = a.prefill_request(req)
    STATS.reset()
    chunks, length, last, lines = a.export_stream(slot)
    b_slot = b.free_slots()[0]
    b.import_stream(b_slot, chunks, length, last, lines, req,
                    as_replica_of=(0, slot))
    stream = _transfers()
    a.decode()
    from_line = b.store.lines(req.rid)
    STATS.reset()
    moved = b.sync_replica_from(a, slot, b_slot)
    mirror = _transfers()
    n = a.store.lines(req.rid)
    return {"stream": stream, "mirror": mirror, "moved": moved,
            "delta": n - from_line, "lines": n, "rows_a": _rows(a, slot, n),
            "rows_b": _rows(b, b_slot, n), "rank_in": (a_sl.holds,
                                                       b_sl.holds)}


def mesh_cluster(cfg, params, shapes):
    kernel = AcceLLMScheduler()
    kernel.trace = []
    cluster = LiveCluster(cfg, params, n_instances=2, num_slots=6,
                          kv_capacity=64, policy=kernel,
                          mesh=MeshPlacement.carve(2, tp=2, device=CPU),
                          device=CPU)
    STATS.reset()
    reqs = [Request(prompt_len=p, max_new_tokens=d, rid=i,
                    prompt_tokens=prompt(i, p, cfg.vocab_size, seed=11))
            for i, (p, d) in enumerate(shapes)]
    for r in reqs:
        cluster.submit(r)
    done = cluster.run(max_steps=200)
    return {"finished": len(done), "stats": dict(cluster.stats),
            "trace": kernel.trace,
            "tokens": [list(map(int, r.output_tokens)) for r in reqs],
            "transfers": (STATS.d2d_copies, STATS.host_copies)}


def join_past_the_pod(cfg, params, policy="vllm"):
    """A third instance joins a two-slice pod at iteration 2: past the
    carved pod it lands unsharded, every rank building it whole."""
    from repro_torch.fleet import FixedFleet, FleetController, JoinInstance
    mesh = (MeshPlacement.carve(2, tp=2, device=CPU)
            if dist_world() else None)
    cluster = LiveCluster(cfg, params, 2, 6, 64, policy, mesh=mesh,
                          device=CPU, fleet=FleetController(
                              FixedFleet((JoinInstance(2.0),))))
    reqs = [Request(prompt_len=6 + i % 5, max_new_tokens=8, rid=i,
                    prompt_tokens=prompt(i, 6 + i % 5, cfg.vocab_size,
                                         seed=13))
            for i in range(8)]
    for r in reqs:
        cluster.submit(r)
    done = cluster.run(max_steps=200)
    joined = cluster.engines[2]
    return {"finished": len(done), "stats": dict(cluster.stats),
            "fleet": dict(cluster.fleet.stats),
            "tokens": [list(map(int, r.output_tokens)) for r in reqs],
            "joined": (joined.mesh is None, joined.draws > 0,
                       joined.state_bytes()),
            "spec": cluster.instance_specs[2]}


def dist_world():
    from repro_torch.meshserve.topology import active_world
    return active_world() is not None


def api_serve():
    from repro_torch.api import ServeSpec, serve
    rep = serve(ServeSpec(arch="starcoder2-3b", n_instances=2, num_slots=4,
                          kv_capacity=64, n_requests=6, request_scale=0.02,
                          mesh_tp=2, device=CPU))
    return {"stats": dict(rep.stats), "finished": len(rep.finished),
            "tokens": sorted((r.rid, tuple(r.output_tokens))
                             for r in rep.finished)}


def moe(rank, payload):
    """The 2 x 2 ("data", "model") grid of the JAX package's distributed
    MoE test: rank = 2 * data + model."""
    cfg = payload["moe_cfg"]
    data, model = divmod(rank, 2)
    model_group = group_of((2 * data, 2 * data + 1))
    batch_group = group_of((model, model + 2))
    x = torch.from_numpy(payload["moe_x"])
    B = x.shape[0] // 2
    x_loc = x[data * B:(data + 1) * B]
    routed = {}
    for k, v in payload["moe_params"].items():
        t = torch.from_numpy(v)
        if k != "router":
            n = t.shape[0] // 2
            t = t[model * n:(model + 1) * n]
        routed[k] = t
    out = {}
    for strategy in ("a2a", "psum"):
        with sharding.use_mesh(model_group, batch_group=batch_group,
                               moe_strategy=strategy):
            y, aux = moe_forward(cfg, routed, x_loc)
            out["spec"] = sharding.spec("batch", None, "model", "seq")
        out[strategy] = (y.numpy(), float(aux))
    out["spec_outside"] = sharding.spec("batch", None, "model")
    return out


def seq_parallel_engine(cfg, params):
    """tp 2 with ``REPRO_SEQ_PARALLEL=1`` set in every rank: the tokens
    of ``generate``, the logits of ``logits_at`` and the collectives
    both issued."""
    from _torch_train_worker import _Calls, seq_parallel
    (sl,) = carve_slices(2, 1, device=CPU)
    with seq_parallel(True), _Calls() as calls:
        _, toks = generate(cfg, params, sl)
        pre, dec = logits_at(cfg, params, sl) if sl.holds else (None, None)
    return {"tokens": toks, "prefill": pre, "decode": dec,
            "calls": dict(calls.log)}


def world4(rank, world, payload):
    torch.manual_seed(0)
    cfg = get_config("starcoder2-3b").reduced()
    params = params_from_numpy(payload["params"], device=CPU)
    return {"tp": tp_engines(cfg, params),
            "sp": seq_parallel_engine(cfg, params),
            "stream": stream_and_mirror(cfg, params),
            "cluster": mesh_cluster(cfg, params, payload["shapes"]),
            "serve": api_serve(),
            "join": join_past_the_pod(cfg, params),
            "moe": moe(rank, payload),
            "partial": partial_tp(six_heads(cfg), params_from_numpy(
                payload["partial_params"], device=CPU))}


def hetero(rank, world, payload):
    """The JAX package's heterogeneous golden trace: a [4, 2] pod, live."""
    from repro_torch.sim import ASCEND_910B2, H100, InstanceSpec
    cfg = get_config("starcoder2-3b").reduced()
    params = params_from_numpy(payload["params"], device=CPU)
    specs = (InstanceSpec(H100, 4, intra_link_gbps=H100.link_gbps),
             InstanceSpec(ASCEND_910B2, 2,
                          intra_link_gbps=ASCEND_910B2.link_gbps))
    kernel = AcceLLMScheduler()
    kernel.trace = []
    cluster = LiveCluster(cfg, params, n_instances=2, num_slots=8,
                          kv_capacity=256, policy=kernel,
                          mesh=MeshPlacement.carve(2, specs=specs,
                                                   device=CPU),
                          device=CPU)
    rids = []
    for i, op in enumerate(payload["trace"]):
        if op[0] == "arrive":
            plen, dlen = op[1], op[2]
            req = Request(prompt_len=plen, max_new_tokens=dlen, rid=100 + i,
                          prompt_tokens=prompt(i, plen, cfg.vocab_size,
                                               seed=7))
            rids.append(req.rid)
            cluster.submit(req)
        cluster.step()
    steps = 0
    while cluster.pending() and steps < 50:
        cluster.step()
        steps += 1
    from repro_torch.scheduling.live import LiveInstanceView
    return {"trace": kernel.trace, "rids": rids, "steps": steps,
            "pending": bool(cluster.pending()),
            "tps": [e.mesh.tp for e in cluster.engines],
            "specs": [LiveInstanceView(cluster, i).spec() is specs[i]
                      for i in range(2)],
            "stats": dict(cluster.stats)}


def card_engine(rank, world, payload=None):
    """tp ``world`` on one card (every rank on card 0, over gloo): the
    tokens of ``generate`` and this rank's kernel counts."""
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.models import init_params
    cfg = get_config("starcoder2-3b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    (sl,) = carve_slices(world, 1, device="cuda")
    reset_counts()
    eng, tokens = generate(cfg, params, sl, device="cuda")
    return {"tokens": tokens, "counts": read_counts(),
            "state_bytes": eng.state_bytes()}


def card_stream(rank, world):
    """Two one-rank slices on card 0 over gloo: the cross-slice stream
    and mirror, whose every hop gloo stages through the host."""
    from repro_torch.models import init_params
    cfg = get_config("starcoder2-3b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    return stream_and_mirror(cfg, params, tp=1, device="cuda")


# ---------------------------------------------------------------------------
# the other stacks on a mesh: Mamba, MLA, xLSTM, encoder-decoder, vision
# ---------------------------------------------------------------------------

#: the families served on a mesh beside the GQA decoders
FAMILIES = ("jamba-1.5-large-398b", "deepseek-v3-671b", "xlstm-1.3b",
            "seamless-m4t-large-v2", "internvl2-1b")


def family_extras(cfg, n, seed=5):
    """Request ``i``'s modality payload (numpy), or None."""
    from repro_torch.workloads import default_extras
    return [default_extras(cfg, seed, i) for i in range(n)]


def family_generate(cfg, params, mesh, steps=5, device=CPU):
    """Three requests, each with its payload, prefilled one by one, then
    ``steps - 1`` decode steps (dense: these stacks do not page)."""
    eng = InstanceEngine(cfg, params, num_slots=4, kv_capacity=64,
                         temperature=0.0, mesh=mesh, device=device)
    reqs = requests(cfg, 3, steps=steps)
    for r, extra in zip(reqs, family_extras(cfg, 3)):
        eng.prefill_request(r, extra)
    eng.decode_multi(steps=steps - 1)
    return eng, [list(map(int, r.output_tokens)) for r in reqs]


def family_batch(cfg, B=2, S=8):
    """Two equal-length prompts and their payloads, stacked (numpy)."""
    toks = np.concatenate([prompt(i, S, cfg.vocab_size, seed=9)
                           for i in range(B)])
    batch = {"tokens": toks}
    extras = family_extras(cfg, B, seed=9)
    if extras[0]:
        for key in extras[0]:
            batch[key] = np.concatenate([e[key] for e in extras])
    return batch


def family_clock(cfg, S=8):
    """The decode clock after a prefill of ``S`` tokens: a VLM's patches
    lead the sequence."""
    vlm = cfg.frontend is not None and cfg.frontend.kind == "vision"
    return S + (cfg.frontend.num_prefix_tokens if vlm else 0)


def family_logits(cfg, params, sl, steps=2, cut=None):
    """Prefill logits of ``family_batch`` and ``steps`` greedy dense decode
    steps' logits, under the slice's TP context (whole params without a
    slice).  ``cut(cfg, params, sl, batch, seq_len)`` gives the rank's
    params and state in place of the rule table's."""
    from repro_torch.models import decode_step, prefill
    batch = {k: torch.as_tensor(v) for k, v in family_batch(cfg).items()}
    B = batch["tokens"].shape[0]
    if cut is not None:
        params, state = cut(cfg, params, sl, B, 32)
    elif sl is not None:
        params = shard_params(cfg, params, sl)
        state = local_state(cfg, sl, B, 32)
    else:
        state = init_state(cfg, B, 32, device=CPU)
    t = family_clock(cfg)
    out = []
    with sharding.use_mesh(sl.group if sl is not None else None):
        logits, state = prefill(cfg, params, batch, state)
        out.append(logits.numpy())
        for j in range(steps):
            tok = logits.argmax(-1).to(torch.int32)[:, None]
            logits, state = decode_step(cfg, params, tok, state,
                                        torch.full((B,), t + j,
                                                   dtype=torch.int32))
            out.append(logits.numpy())
    return out


def _shapes(tree, path=""):
    """{path: shape} of a nested dict/list tree's tensors."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        return {p: n for k, v in tree.items()
                for p, n in _shapes(v, f"{path}/{k}" if path else k).items()}
    if isinstance(tree, list):
        return {p: n for i, v in enumerate(tree)
                for p, n in _shapes(v, f"{path}/{i}" if path else str(i))
                .items()}
    return {path: tuple(tree.shape)}


def with_capacity(cfg, factor):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))


def family_ranks(cfg, params, tps=(2, 4), mutate=None):
    """Per tp: this rank's tokens, logits and per-leaf numels, on a slice
    of the first ``tp`` ranks.  ``mutate`` maps a block kind to leaf rules
    that replace the rule table's (a deliberately wrong cut)."""
    from repro_torch.meshserve import pool
    out = {}
    saved = {k: dict(v) for k, v in pool.PARAM_RULES.items()}
    try:
        for kind, rules in (mutate or {}).items():
            pool.PARAM_RULES[kind].update(rules)
        for tp in tps:
            (sl,) = carve_slices(tp, 1, device=CPU)
            eng, toks = family_generate(cfg, params, sl)
            mine = {"tokens": toks, "holds": sl.holds,
                    "params": _shapes(eng.params),
                    "state": _shapes(eng.state),
                    "logits": (family_logits(cfg, params, sl)
                               if sl.holds else None)}
            out[tp] = mine
    finally:
        for kind, rules in saved.items():
            pool.PARAM_RULES[kind].clear()
            pool.PARAM_RULES[kind].update(rules)
    return out


def mutated(payload):
    """Each mutation case: its config's tokens and logits at tp 2 under
    the rule table and under the mutated cuts, on weights drawn on every
    rank from one seed; MoE dispatch dropless, so that one device's
    logits are the answer."""
    from repro_torch.models import init_params
    out = {}
    for name, (arch, xlstm, rules) in payload.items():
        cfg = get_config(arch).reduced()
        if xlstm:
            cfg = dataclasses.replace(cfg, xlstm=dataclasses.replace(
                cfg.xlstm, **xlstm))
        if cfg.moe is not None:
            cfg = with_capacity(cfg, cfg.moe.num_experts / cfg.moe.top_k)
        params = init_params(cfg, torch.Generator().manual_seed(1),
                             device=CPU)
        one = family_logits(cfg, params, None)
        out[name] = {"one": one,
                     "kept": family_ranks(cfg, params, tps=(2,)),
                     "mutated": family_ranks(cfg, params, tps=(2,),
                                             mutate=rules)}
    return out


def split_heads(cfg, params, sl, batch, seq_len):
    """A deliberately wrong cut of every mLSTM leaf: the contiguous block
    of ``d_in / tp`` channels a width-only rule gives where the heads do
    not divide the slice, so each rank keeps part of one head (its
    diagonal block of ``wq``/``wk``/``wv``, its channels of the gates) and
    runs it as a head of its own; every other leaf by the rule table."""
    from repro_torch.models.xlstm import xlstm_dims
    local = shard_params(cfg, params, sl)
    state = local_state(cfg, sl, batch, seq_len)
    d_in, hd = xlstm_dims(cfg, "mlstm")
    n = d_in // sl.tp
    lo = sl.model_rank * n
    head, off = divmod(lo, hd)
    cols = slice(lo, lo + n)
    sub = slice(off, off + n)
    one = slice(head, head + 1)
    for seg, (whole, mine) in enumerate(zip(params["segments"],
                                            local["segments"])):
        for pj, part in whole.items():
            if "w_up" not in part["mixer"] or "w_z" not in part["mixer"]:
                continue
            w, m = part["mixer"], mine[pj]["mixer"]
            for key in ("w_up", "w_z", "conv_w", "conv_b", "w_o"):
                m[key] = w[key][..., cols].clone()
            m["w_down"] = w["w_down"][..., cols, :].clone()
            for key in ("wq", "wk", "wv"):
                m[key] = w[key][..., one, sub, sub].clone()
            for key in ("w_i", "w_f"):
                m[key] = w[key][..., one, sub].clone()
            for key in ("b_i", "b_f"):
                m[key] = w[key][..., one].clone()
            st = state["layers"][seg][pj]
            for key, shape in (("C", (1, n, n)), ("n", (1, n)), ("m", (1,)),
                               ("conv", (n,))):
                lead = st[key].shape[:st[key].dim() - len(shape)]
                st[key] = torch.zeros(tuple(lead) + shape,
                                      dtype=st[key].dtype)
    return local, state


def head_cut(case):
    """The head gate's case: one device's logits, then each rank's at
    ``tp`` under the rule table (the mLSTM whole) and under
    :func:`split_heads`, on weights drawn on every rank from one seed."""
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(),
                              **case["heads"])
    params = init_params(cfg, torch.Generator().manual_seed(1), device=CPU)
    tp = case["tp"]
    (sl,) = carve_slices(tp, 1, device=CPU)
    out = {"one": family_logits(cfg, params, None),
           "one_tokens": family_generate(cfg, params, None)[1],
           "kept": family_ranks(cfg, params, tps=(tp,))[tp]}
    out["split"] = (family_logits(cfg, params, sl, cut=split_heads)
                    if sl.holds else None)
    return out


def seq_parallel_prefill(cases):
    """Each case's ``prefill`` of ``family_batch``, and its
    ``prefill_batched`` of the same tokens where the stack has no
    encoder, at tp 2 with ``REPRO_SEQ_PARALLEL`` unset and then set, on
    weights drawn on every rank from one seed: this rank's logits of
    both, whether every cache leaf came out equal, and the collectives
    each run issued (None on a shadow)."""
    from repro_torch.models import init_params
    from _torch_train_worker import _Calls, seq_parallel
    (sl,) = carve_slices(2, 1, device=CPU)
    out = {}
    for name, (arch, heads) in cases.items():
        cfg = get_config(arch).reduced()
        if heads:
            cfg = dataclasses.replace(cfg, **heads)
        params = init_params(cfg, torch.Generator().manual_seed(1),
                             device=CPU)
        if not sl.holds:
            out[name] = None
            continue
        local = shard_params(cfg, params, sl)
        batch = {k: torch.as_tensor(v) for k, v in family_batch(cfg).items()}
        B, S = batch["tokens"].shape
        res = {}
        for path in ("prefill", "prefill_batched"):
            if path == "prefill_batched" and cfg.is_encoder_decoder:
                continue
            runs = []
            for on in (False, True):
                state = local_state(cfg, sl, B, 32)
                with seq_parallel(on), _Calls() as calls, \
                        sharding.use_mesh(sl.group):
                    if path == "prefill":
                        logits, state = prefill(cfg, local, batch, state)
                    else:
                        logits, state = prefill_batched(
                            cfg, local, batch["tokens"], state,
                            torch.full((B,), S))
                runs.append((logits.numpy(), _leaves(state),
                             dict(calls.log)))
            (off, c_off, k_off), (on, c_on, k_on) = runs
            res[path] = {"off": off, "on": on, "calls": (k_off, k_on),
                         "caches_equal": len(c_off) == len(c_on) and all(
                             torch.equal(a, b) for a, b in zip(c_off, c_on))}
        out[name] = res
    return out


def families(rank, world, payload):
    """Every family at tp 2 and 4 on a world of 4: tokens, logits, bytes;
    the MoE families also at the dropless capacity factor; the mutation
    cases at tp 2; the sequence-parallel prefills at tp 2."""
    out = {}
    for arch, params_np in payload["params"].items():
        cfg = get_config(arch).reduced()
        params = params_from_numpy(params_np, device=CPU)
        got = {"published": family_ranks(cfg, params,
                                         tps=payload["tps"].get(arch,
                                                                (2, 4)))}
        if cfg.moe is not None and arch != "arctic-480b":
            dropless = with_capacity(cfg, cfg.moe.num_experts
                                     / cfg.moe.top_k)
            got["dropless"] = family_ranks(dropless, params, tps=(2,))
        out[arch] = got
    for name, (arch, params_np) in payload["variants"].items():
        cfg = six_heads(get_config(arch).reduced())
        if cfg.moe is not None:
            cfg = with_capacity(cfg, cfg.moe.num_experts / cfg.moe.top_k)
        params = params_from_numpy(params_np, device=CPU)
        out[name] = {"published": family_ranks(cfg, params, tps=(4,))}
    out["mutated"] = mutated(payload["mutate"])
    out["head_cut"] = head_cut(payload["head_cut"])
    out["seq_parallel"] = seq_parallel_prefill(payload["seq_parallel"])
    return out


def family_cluster(cfg, params, shapes, mesh=True, seed=11):
    """``mesh_cluster`` with each request's modality payload: two
    instances, on two tp-2 slices of a world of 4 (``mesh``) or whole in
    this process."""
    kernel = AcceLLMScheduler()
    kernel.trace = []
    cluster = LiveCluster(cfg, params, n_instances=2, num_slots=6,
                          kv_capacity=64, policy=kernel,
                          mesh=(MeshPlacement.carve(2, tp=2, device=CPU)
                                if mesh else None), device=CPU)
    STATS.reset()
    reqs = [Request(prompt_len=p, max_new_tokens=d, rid=i,
                    prompt_tokens=prompt(i, p, cfg.vocab_size, seed=seed))
            for i, (p, d) in enumerate(shapes)]
    for r, extra in zip(reqs, family_extras(cfg, len(reqs), seed=seed)):
        cluster.submit(r, extra)
    done = cluster.run(max_steps=200)
    return {"finished": len(done), "stats": dict(cluster.stats),
            "trace": kernel.trace,
            "tokens": [list(map(int, r.output_tokens)) for r in reqs],
            "transfers": (STATS.d2d_copies, STATS.host_copies),
            "pools": [e.state_bytes() for e in cluster.engines]}


def api_serve_arch(arch, mesh_tp=2):
    from repro_torch.api import ServeSpec, serve
    rep = serve(ServeSpec(arch=arch, n_instances=2, num_slots=4,
                          kv_capacity=64, n_requests=6, request_scale=0.02,
                          mesh_tp=mesh_tp, device=CPU))
    return {"stats": dict(rep.stats), "finished": len(rep.finished),
            "tokens": sorted((r.rid, tuple(r.output_tokens))
                             for r in rep.finished)}


def family_clusters(rank, world, payload):
    """Mesh clusters of two tp-2 slices for each family of the payload,
    and ``api.serve`` with ``mesh_tp=2`` on xlstm-1.3b."""
    out = {}
    for arch, params_np in payload["params"].items():
        cfg = get_config(arch).reduced()
        params = params_from_numpy(params_np, device=CPU)
        out[arch] = family_cluster(cfg, params, payload["shapes"])
    out["serve"] = api_serve_arch("xlstm-1.3b")
    return out
