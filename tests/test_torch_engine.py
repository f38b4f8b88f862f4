"""The port's InstanceEngine on the CPU.

Three groups:

* against the JAX package's engine on the same requests and weights: equal
  token streams, equal ``host_syncs``, equal ledger bytes and free blocks
  after every step (temperature 0: the packages' random bits differ);
* the JAX package's three fused-decode contracts, inside the port: paged ==
  dense including ring wrap, ``decode_multi`` == k x ``decode`` including
  EOS mid-span, compacted == full with replicas resident;
* redundancy: mirror sync then promote gives the tokens of a run with no
  handoff, each sync moving ``LineCosts.mirror_bytes``; at temperature > 0
  fused == sequential inside the port.
"""
import jax
import numpy as np
import pytest
import torch

import repro.configs as rcfg
from repro.models import init_params as r_init_params
from repro.serving import InstanceEngine as REngine
from repro.serving import Request as RRequest
from repro.stepplan import PrefillItem as RPrefillItem
from repro.stepplan import PrefillPlan as RPrefillPlan
import repro_torch.configs as tcfg
from repro_torch.bridge import params_from_numpy
from repro_torch.kvstore import KVStoreError
from repro_torch.serving import InstanceEngine, Request
from repro_torch.serving.sampling import sample_slots
from repro_torch.stepplan import PrefillItem, PrefillPlan

# ragged lengths; 12 + 10 > 16 = kv_capacity exercises the ring wrap
RAGGED = [(5, 10), (12, 10), (9, 4)]


@pytest.fixture(scope="module")
def setup():
    cfg_r = rcfg.get_config("starcoder2-3b").reduced()
    cfg = tcfg.get_config("starcoder2-3b").reduced()
    params_r = r_init_params(jax.random.PRNGKey(0), cfg_r)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, params_r),
                               device="cpu")
    return cfg_r, cfg, params_r, params


def _prompt(i, plen, vocab):
    return np.random.default_rng(100 + i).integers(0, vocab, (1, plen),
                                                   dtype=np.int32)


def _mk(cfg, i, plen, new=6):
    return Request(prompt_len=plen, max_new_tokens=new,
                   prompt_tokens=_prompt(i, plen, cfg.vocab_size))


def _engine(cfg, params, **kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("kv_capacity", 16)
    return InstanceEngine(cfg, params, device="cpu", **kw)


def _serve(cfg, params, shapes, *, paged, steps=0, eos=None, **kw):
    eng = _engine(cfg, params, paged_decode=paged, eos_token=eos, **kw)
    reqs = [_mk(cfg, i, p, n) for i, (p, n) in enumerate(shapes)]
    for r in reqs:
        eng.prefill_request(r)
    for _ in range(200):
        if not eng.slot_req:
            break
        if steps:
            eng.decode_multi(steps=steps)
        else:
            eng.decode()
    return [r.output_tokens for r in reqs], eng


# ---------------------------------------------------------------------------
# against the JAX package's engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("paged,steps,eos", [(True, 1, None), (True, 4, None),
                                             (False, 1, None), (True, 3, "mid")])
def test_engine_matches_repro_engine(setup, paged, steps, eos):
    cfg_r, cfg, params_r, params = setup
    if eos == "mid":      # an EOS that fires mid-stream, taken from a probe
        probe, _ = _serve(cfg, params, RAGGED, paged=True)
        eos = probe[1][3]
    kw = dict(num_slots=4, kv_capacity=16, paged_decode=paged,
              eos_token=eos)
    er, et = REngine(cfg_r, params_r, **kw), _engine(cfg, params, **kw)
    reqs_r = [RRequest(prompt_len=p, max_new_tokens=n,
                       prompt_tokens=_prompt(i, p, cfg.vocab_size))
              for i, (p, n) in enumerate(RAGGED)]
    reqs_t = [_mk(cfg, i, p, n) for i, (p, n) in enumerate(RAGGED)]
    for rr, rt in zip(reqs_r, reqs_t):
        assert er.prefill_request(rr) == et.prefill_request(rt)
        assert er.used_bytes() == et.used_bytes()
        assert er.free_blocks() == et.free_blocks()
    while er.slot_req or et.slot_req:
        assert er.decode_multi(steps=steps) == et.decode_multi(steps=steps)
        assert er.host_syncs == et.host_syncs
        assert er.used_bytes() == et.used_bytes()
        assert er.free_blocks() == et.free_blocks()
        assert er.total_kv_tokens() == et.total_kv_tokens()
    assert [r.output_tokens for r in reqs_r] == \
        [r.output_tokens for r in reqs_t]
    if eos is not None:
        assert any(len(r.output_tokens) < n for r, (_, n)
                   in zip(reqs_t, RAGGED)), "EOS never fired mid-stream"


def test_prefill_plans_match_repro_engine(setup):
    """A batched plan (padded to a power-of-two batch) and a prompt longer
    than the window (the single-prompt ring path), against the JAX
    package's engine."""
    cfg_r, cfg, params_r, params = setup
    er = REngine(cfg_r, params_r, num_slots=4, kv_capacity=16)
    et = _engine(cfg, params)
    shapes = [(7, 5), (13, 5), (3, 5), (21, 5)]
    reqs_r = [RRequest(prompt_len=p, max_new_tokens=n,
                       prompt_tokens=_prompt(i, p, cfg.vocab_size))
              for i, (p, n) in enumerate(shapes)]
    reqs_t = [_mk(cfg, i, p, n) for i, (p, n) in enumerate(shapes)]

    def items(item_cls, reqs):
        return tuple(item_cls(r.rid, r.prompt_len, 0, r.prompt_len, req=r)
                     for r in reqs)

    done_r = er.prefill_batch(RPrefillPlan(0, items(RPrefillItem, reqs_r),
                                           16))
    done_t = et.prefill_batch(PrefillPlan(0, items(PrefillItem, reqs_t), 16))
    assert ([done_r[r.rid] for r in reqs_r]
            == [done_t[r.rid] for r in reqs_t])
    assert er.used_bytes() == et.used_bytes()
    while er.slot_req:
        assert er.decode_multi(steps=2) == et.decode_multi(steps=2)
    assert [r.output_tokens for r in reqs_r] == \
        [r.output_tokens for r in reqs_t]
    assert er.host_syncs == et.host_syncs


# ---------------------------------------------------------------------------
# the fused-decode contracts, inside the port
# ---------------------------------------------------------------------------


def test_paged_decode_matches_dense_oracle(setup):
    _, cfg, _, params = setup
    dense, eng_d = _serve(cfg, params, RAGGED, paged=False)
    assert not eng_d.use_paged_decode
    paged, eng_p = _serve(cfg, params, RAGGED, paged=True)
    assert eng_p.use_paged_decode and eng_p.supports_paged_decode
    assert paged == dense
    assert eng_p.host_syncs == eng_d.host_syncs


def test_decode_multi_matches_sequential_decode(setup):
    _, cfg, _, params = setup
    seq, eng_s = _serve(cfg, params, RAGGED, paged=True)
    fused, eng_f = _serve(cfg, params, RAGGED, paged=True, steps=4)
    assert fused == seq
    assert eng_f.host_syncs < eng_s.host_syncs


def test_decode_multi_eos_short_circuits_mid_span(setup):
    _, cfg, _, params = setup
    ref, _ = _serve(cfg, params, RAGGED, paged=False)
    eos = ref[1][3]
    seq, _ = _serve(cfg, params, RAGGED, paged=False, eos=eos)
    fused, _ = _serve(cfg, params, RAGGED, paged=True, steps=6, eos=eos)
    assert fused == seq
    assert any(len(a) < len(b) for a, b in zip(seq, ref)), \
        "EOS never fired mid-stream; the test lost its teeth"


def test_compacted_batch_matches_full_with_replicas_resident(setup):
    _, cfg, _, params = setup

    def run(with_replica):
        src = _engine(cfg, params, instance_id=1)
        eng = _engine(cfg, params, paged_decode=True)
        reqs = [_mk(cfg, i, p, n) for i, (p, n) in
                enumerate([(5, 6), (9, 6)])]
        for r in reqs:
            eng.prefill_request(r)
        if with_replica:
            other = _mk(cfg, 7, 11, 6)
            s = src.prefill_request(other)
            eng.import_slot(eng.free_slots()[0], src.export_slot(s),
                            other, as_replica_of=(1, s))
        while eng.slot_req:
            eng.decode_multi(steps=2)
        return [r.output_tokens for r in reqs]

    assert run(True) == run(False)


def test_empty_decode_does_no_work(setup):
    _, cfg, _, params = setup
    eng = _engine(cfg, params, paged_decode=True)
    assert eng.decode() == {} and eng.decode_multi(steps=4) == {}
    src = _engine(cfg, params, instance_id=1)
    req = _mk(cfg, 0, 5)
    slot = src.prefill_request(req)
    eng.import_slot(0, src.export_slot(slot), req, as_replica_of=(1, slot))
    assert eng.replica_of and eng.decode() == {}
    assert eng.host_syncs == 0


@pytest.mark.parametrize("rows,blocks,key", [
    (1, 64, (1, 64)), (16, 128, (16, 128)), (17, 256, (32, 256)),
    (32, 64, (32, 64)), (33, 128, (48, 128)), (128, 256, (128, 256))])
def test_decode_graph_key_pads_rows_past_16(rows, blocks, key):
    """A paged decode plan's CUDA graph: exact rows up to 16, then rows
    rounded up to a multiple of 16; the table blocks as the plan has them
    (already a power of two)."""
    from repro_torch.serving.decode_graph import graph_key
    assert graph_key(rows, blocks) == key


@pytest.mark.parametrize("where", ["cpu", "mesh"])
def test_cpu_and_mesh_engines_decode_eagerly(setup, where):
    """No CUDA graph off the card or on a mesh: the tokens are the plain
    engine's, and ``decode.graph.eager`` counts every plan (one host read
    each)."""
    from repro_torch.core.tracing import Tracer
    from repro_torch.meshserve import carve_slices
    _, cfg, _, params = setup
    want, _ = _serve(cfg, params, RAGGED, paged=True, steps=3)
    tracer = Tracer()
    kw = {"mesh": carve_slices(1, 1, device="cpu")[0]} if where == "mesh" \
        else {}
    got, eng = _serve(cfg, params, RAGGED, paged=True, steps=3,
                      tracer=tracer, **kw)
    assert eng._graphs is None and (eng.mesh is None) == (where == "cpu")
    assert got == want
    plans = tracer.counters["decode.graph.eager"]
    assert plans == tracer.counters["d2h.decode"] == eng.host_syncs > 0
    assert not {"decode.graph.capture", "decode.graph.replay"} \
        & set(tracer.counters)


# ---------------------------------------------------------------------------
# redundancy: mirror sync, demote, promote
# ---------------------------------------------------------------------------


def test_mirror_sync_then_promote_matches_no_handoff(setup):
    _, cfg, _, params = setup
    plen, new = 9, 14                         # 9 + 14 > 16: the ring wraps

    control = _engine(cfg, params)
    req_c = _mk(cfg, 3, plen, new)
    control.prefill_request(req_c)
    while control.slot_req:
        control.decode()

    a = _engine(cfg, params, instance_id=0)
    b = _engine(cfg, params, instance_id=1)
    req = _mk(cfg, 3, plen, new)
    sa = a.prefill_request(req)
    sb = 2                                    # another slot index on B
    b.import_slot(sb, a.export_slot(sa), req, as_replica_of=(0, sa))
    line_bytes = b.store.costs.mirror_bytes(1)
    for _ in range(6):
        a.decode()
        assert b.sync_replica_from(a, sa, sb) == line_bytes
    # A's later in-place writes never reach B's replica (export copies)
    assert b.store.synced_line(req.rid) == a.store.lines(req.rid)
    a.demote_to_replica(sa, (1, sb))
    b.promote_replica(sb, req)
    while b.slot_req:
        b.decode()
    assert req.output_tokens == req_c.output_tokens
    # B finished and released the request; A still holds it as a replica
    assert b.used_bytes() == 0 and a.replica_of == {sa: (1, sb)}


def test_export_is_a_copy(setup):
    """An exported slot does not alias the exporter's cache."""
    _, cfg, _, params = setup
    a = _engine(cfg, params)
    req = _mk(cfg, 4, 6, 4)
    slot = a.prefill_request(req)
    exported = a.export_slot(slot)
    before = exported[0]["layers"][0]["p0"]["k"].clone()
    a.decode()
    assert torch.equal(exported[0]["layers"][0]["p0"]["k"], before)


# ---------------------------------------------------------------------------
# sampling at temperature > 0, inside the port
# ---------------------------------------------------------------------------


def test_fused_eos_draw_consumption_matches_sequential(setup):
    """A fused span that EOS ends early leaves the draw counter where the
    per-step path would, so the NEXT request's tokens at temperature > 0
    are identical fused vs sequential."""
    _, cfg, _, params = setup

    def run(steps, eos):
        eng = _engine(cfg, params, paged_decode=True, temperature=0.7,
                      eos_token=eos, kv_capacity=32)
        first = _mk(cfg, 0, 5, 8)
        eng.prefill_request(first)
        while eng.slot_req:
            eng.decode_multi(steps=steps)
        second = _mk(cfg, 1, 7, 8)
        eng.prefill_request(second)
        while eng.slot_req:
            eng.decode_multi(steps=steps)
        return first.output_tokens, second.output_tokens

    probe, _ = run(1, None)
    eos = probe[3]
    seq = run(1, eos)
    fused = run(6, eos)
    assert len(seq[0]) == 4, "EOS did not fire early; test lost its teeth"
    assert fused == seq


def test_sample_slots_invariant_to_batch_composition():
    g = torch.Generator().manual_seed(4)
    logits = torch.randn((6, 40), generator=g)
    noise = torch.randn((7, 40), generator=g)
    slots = torch.arange(6, dtype=torch.int32)
    full = sample_slots(logits, slots, 0.8, noise)
    sel = torch.tensor([1, 4, 5], dtype=torch.int32)
    compact = sample_slots(logits[sel.long()], sel, 0.8, noise)
    assert torch.equal(full[sel.long()], compact)


# ---------------------------------------------------------------------------
# paths that wait for later slices
# ---------------------------------------------------------------------------


def test_later_slices_raise(setup):
    _, cfg, _, params = setup
    # the prefix-cache slice has landed (tests/test_torch_prefixcache.py)
    assert _engine(cfg, params, prefix_cache=True).prefix_cache is not None
    # the mesh slices have landed for every stack: the GQA decoders
    # (tests/test_torch_meshserve.py) and the Mamba, MLA, xLSTM,
    # encoder-decoder and vision stacks
    # (tests/test_torch_meshserve_families.py)
    from repro_torch.meshserve import carve_slices
    from repro_torch.models import init_params
    (sl,) = carve_slices(1, 1, device="cpu")
    assert _engine(cfg, params, mesh=sl).mesh is sl
    xcfg = tcfg.get_config("xlstm-1.3b").reduced()
    xlstm = _engine(xcfg, init_params(xcfg, torch.Generator().manual_seed(0),
                                      device="cpu"), mesh=sl)
    assert xlstm.mesh is sl and xlstm.state_bytes() > 0
    eng = _engine(cfg, params)
    # chunk resume and streamed exports run since the cluster slice; a
    # chunk of a prompt that would wrap the 16-line window still waits for
    # a later slice, and a streamed encoder memory (which streams since
    # the encoder-decoder slice) is refused by a store that holds none
    req = _mk(cfg, 0, 20)
    chunk = PrefillPlan(0, (PrefillItem(req.rid, 20, 0, 8, req=req),), 16)
    with pytest.raises(NotImplementedError):
        eng.prefill_batch(chunk)
    # a stamped hit with no pinned run behind it is refused
    hit = _mk(cfg, 2, 12)
    hit.prefix_hit = 8
    chunk = PrefillPlan(0, (PrefillItem(hit.rid, 12, 8, 12, req=hit),), 16)
    with pytest.raises(KVStoreError):
        eng.prefill_batch(chunk)
    slot = eng.prefill_request(_mk(cfg, 1, 5))
    with pytest.raises(KVStoreError, match="no encoder memory"):
        eng.store.import_chunk(slot, ("enc_out",), None)
