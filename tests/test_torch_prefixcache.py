"""The port's prefix cache held against the JAX package's on the CPU.

``repro_torch.prefixcache`` is a copy of ``repro.prefixcache`` over the
port's ``BlockLedger``; the engine, the ``LiveCluster``, ``api.serve``,
the serve launcher and the simulator use it as ``repro``'s do.  Case for
case of ``tests/test_prefixcache.py``, on the reduced starcoder2-3b in
f32 (the JAX package's weights bridged through numpy) and the same
numpy-seeded prompt tokens in both packages:

* the radix index (walk, extend, subtree), the cache's hit, pin and LRU
  accounting, share-aware frees, copy-on-write and pinned subtrees: the
  same operations give the same answers in both packages;
* the refcount invariant under random interleavings (hypothesis), with
  both packages' ledgers and caches in lockstep;
* ``PagedStore.copy_prefix``: the rows and bytes of ``repro``'s
  ``_gather_rows`` on one pool;
* the golden prefix trace: the port's live cluster and simulator make
  ``repro``'s kernel decisions, with its hit stats and per-tick saved
  blocks;
* a shared-prefix open-loop serve: tokens, stats and traces equal to
  ``repro``'s with the cache on, and tokens equal to the port's own run
  with the cache off (bitwise at T = 0 in f32); batch arrival never
  overcommits slots; the ledger conserves every iteration; the
  simulator's prefix run drains and conserves as ``repro``'s does;
* the entry points (``InstanceEngine``, ``LiveCluster``, ``ServeSpec``,
  ``launch.serve``, ``Simulator``) take ``prefix_cache=True``.
"""
import jax
import numpy as np
import pytest
import torch

import repro.configs as rcfg
import repro.kvstore as rkv
import repro.models as rm
import repro.prefixcache as rpc
import repro.sim as rsim
import repro.workloads as rwl
from repro.kvstore.paged import _gather_rows
from repro.scheduling import AcceLLMScheduler as RAcceLLM
from repro.scheduling.live import LiveCluster as RLiveCluster
from repro.serving import Request as RRequest
from repro.sim.policies import AcceLLMPolicy as RAcceLLMPolicy
from repro.sim.workload import SimRequest as RSimRequest
import repro_torch.api as tapi
import repro_torch.configs as tcfg
import repro_torch.kvstore as tkv
import repro_torch.launch.serve as tlserve
import repro_torch.prefixcache as tpc
import repro_torch.sim as tsim
import repro_torch.workloads as twl
from repro_torch.bridge import params_from_numpy
from repro_torch.scheduling import AcceLLMScheduler
from repro_torch.scheduling.live import LiveCluster
from repro_torch.serving import InstanceEngine, Request
from repro_torch.sim.policies import AcceLLMPolicy
from repro_torch.sim.workload import SimRequest
from repro_torch.stepplan import PrefillItem, PrefillPlan
from tests._propcheck import given, settings, st

BL = 4      # block_lines for the pure-ledger tests
_BLK = 8    # block_lines for the engine and cluster tests

# (ledger/cache modules, KVStoreError) per package
_PKGS = {"ref": (rkv, rpc), "port": (tkv, tpc)}


@pytest.fixture(scope="module")
def setup():
    cfg_r = rcfg.get_config("starcoder2-3b").reduced()
    cfg = tcfg.get_config("starcoder2-3b").reduced()
    params_r = rm.init_params(jax.random.PRNGKey(0), cfg_r)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, params_r),
                               device="cpu")
    return cfg_r, cfg, params_r, params


def _ledger(kv, num_blocks=32, fixed=0):
    return kv.BlockLedger(kv.LineCosts(8.0, fixed, 0), num_blocks, BL)


def _both(fn):
    """``fn(kvstore module, prefixcache module)`` in each package."""
    return fn(*_PKGS["ref"]), fn(*_PKGS["port"])


# ---------------------------------------------------------------------------
# alignment rule, radix index, cache accounting
# ---------------------------------------------------------------------------


def test_aligned_hit_lines_matches_reference():
    grid = [(p, n, b) for p in (0, 3, 7, 8, 17, 100) for n in (1, 8, 9, 20)
            for b in (1, 4, 8)]
    got = [tpc.aligned_hit_lines(*g) for g in grid]
    assert got == [rpc.aligned_hit_lines(*g) for g in grid]
    assert tpc.aligned_hit_lines(8, 20, BL) == 8
    assert tpc.aligned_hit_lines(8, 8, BL) == 4     # full-prompt hit refused
    assert tpc.aligned_hit_lines(100, 1, BL) == 0


def test_index_walk_extend_subtree_matches_reference():
    def run(kv, pc):
        idx = pc.PrefixIndex(BL)
        toks = list(range(12))
        out = [[n.block for n in idx.extend(toks, [10, 11, 12])], len(idx),
               [n.block for n in idx.walk(toks)],
               [n.block for n in idx.walk(toks[:7])], idx.walk([99] * 8)]
        other = toks[:4] + [50, 51, 52, 53]
        out += [[n.block for n in idx.extend(other, [10, 33])], len(idx),
                pc.chunk_key(other, 1, BL)]
        root_node = idx.walk(toks[:4])[0]
        with pytest.raises(kv.KVStoreError):
            idx.remove(root_node)
        sub = idx.subtree(root_node)
        out += [[n.block for n in sub], sub[-1] is root_node,
                [n.block for n in idx.lru_leaves()]]
        return out
    ref, port = _both(run)
    assert port == ref
    assert port[0] == [10, 11, 12] and port[5] == [33] and len(port[8]) == 4


def test_cache_insert_hit_and_lru_eviction_matches_reference():
    def run(kv, pc):
        led = _ledger(kv)
        cache = pc.PrefixCache(led, capacity_blocks=3)
        led.alloc(1, lines=12)
        t1 = list(range(100, 112))
        out = [cache.insert(t1, led.tables[1]), cache.cached_blocks(),
               [led.refcount(b) for b in led.tables[1]],
               cache.peek_blocks(t1[:8]), dict(cache.stats)]
        run_ = cache.lookup_pin(rid=2, tokens=t1[:8])
        out += [run_, dict(cache.stats), sorted(cache.pinned())]
        led.alloc(3, lines=8)
        out += [cache.insert(list(range(200, 208)), led.tables[3]),
                cache.cached_blocks(), sorted(cache.index.blocks()),
                set(run_) <= set(cache.index.blocks()), dict(cache.stats)]
        cache.unpin(2)
        out.append(sorted(cache.pinned()))
        return out
    ref, port = _both(run)
    assert port == ref
    assert port[6] == {"lookups": 1, "hits": 1, "hit_blocks": 2,
                       "hit_tokens": 8, "inserted_blocks": 3,
                       "evicted_blocks": 0}
    assert port[11] and port[-1] == []


def test_free_returns_only_unique_blocks_matches_reference():
    def run(kv, pc):
        led = _ledger(kv)
        cache = pc.PrefixCache(led)
        led.alloc(1, lines=12)
        head = led.tables[1][:2]
        cache.insert(list(range(12)), led.tables[1])
        out = [led.free(1)]
        led.alloc(2, lines=12, shared=head)
        out += [led.shared_head_lines(2), led.shared_blocks_count(),
                led.shared_saved_blocks(), led.free(2), cache.release_all(),
                led.free_blocks() == led.num_blocks]
        with pytest.raises(kv.KVStoreError):
            led.release(head)
        return out
    ref, port = _both(run)
    assert port == ref == [0, 8, 2, 2, 1, 3, True]


def test_ledger_cow_on_shared_tail_append_matches_reference():
    def run(kv, pc):
        led = _ledger(kv)
        led.alloc(1, lines=6)
        a, b = led.tables[1]
        led.retain([a, b])
        led.alloc(2, lines=6, shared=[a, b])
        out = [led.shared_head_lines(2), led.append_line(2), led.last_cow,
               list(led.tables[2]), led.refcount(b),
               led.shared_head_lines(2)]
        led.append_line(1, 3)
        out += [led.last_cow, led.refcount(b), led.free(2), led.free(1),
                led.release([a, b])]
        return out
    ref, port = _both(run)
    assert port == ref
    assert port[0] == 6 and port[2][:2] == (2, 1) and port[5] == 4


def test_evict_obstructing_spares_pinned_subtrees_matches_reference():
    def run(kv, pc):
        led = _ledger(kv)
        cache = pc.PrefixCache(led)
        led.alloc(1, lines=16)
        toks = list(range(16))
        cache.insert(toks, led.tables[1])
        led.free(1)
        first, second = cache.index.blocks()[:2]
        cache.lookup_pin(rid=9, tokens=toks[:4])
        out = [cache.evict_obstructing({first}), cache.cached_blocks(),
               cache.evict_obstructing({second}), cache.cached_blocks()]
        cache.unpin(9)
        return out + [cache.release_all(), dict(cache.stats)]
    ref, port = _both(run)
    assert port == ref
    assert port[:5] == [0, 4, 3, 1, 1]


# ---------------------------------------------------------------------------
# property: both packages' ledgers and caches in lockstep, refcounts equal
# to references, no leak, no double free
# ---------------------------------------------------------------------------


def _check_conservation(led, cache):
    refs = {}
    for table in led.tables.values():
        for b in table:
            refs[b] = refs.get(b, 0) + 1
    for fb in led.fixed_block.values():
        if fb is not None:
            refs[fb] = refs.get(fb, 0) + 1
    for node in cache.index._nodes:
        refs[node.block] = refs.get(node.block, 0) + 1
    assert refs == led._refs, "refcounts drifted from actual references"
    assert len(set(led._free)) == len(led._free), "double-freed block"
    assert set(led._free).isdisjoint(led._refs)
    assert len(led._free) + len(led._refs) == led.num_blocks, "leaked block"


def _key_of(group, lines):
    return [(group, j) for j in range(lines)]


def _apply_op(led, cache, live, next_rid, op):
    """One op of the reference's random schedule; returns (next_rid, what
    it returned)."""
    kind, a, b = op
    out = None
    if kind in (0, 1):
        g, lines = a % 3, b
        run = cache.peek_blocks(_key_of(g, lines)) if kind == 1 else []
        run = run[:led.line_blocks_for(lines)]
        need = (led.line_blocks_for(lines) - len(run)
                + (1 if led.costs.fixed_bytes > 0 else 0))
        if need <= led.free_blocks():
            led.alloc(next_rid, lines, shared=run or None)
            live[next_rid] = g
            next_rid += 1
    elif kind == 2 and live:
        rid = sorted(live)[a % len(live)]
        old, table = led.lines(rid), led.tables[rid]
        cow = 1 if (old % BL and table and led.refcount(table[-1]) > 1) else 0
        grow = led.line_blocks_for(old + 1) - len(table)
        if cow + max(grow, 0) <= led.free_blocks():
            out = (led.append_line(rid), led.last_cow)
    elif kind == 3 and live:
        rid = sorted(live)[a % len(live)]
        k = led.lines(rid) // BL
        if k:
            out = cache.insert(_key_of(live[rid], k * BL),
                               led.tables[rid][:k])
    elif kind == 4 and live:
        rid = sorted(live)[a % len(live)]
        out = led.free(rid)
        del live[rid]
    elif kind == 5:
        out = (cache.evict_obstructing({b % 32}) if b % 2
               else cache._evict_to(b % 8))
    return next_rid, out


@given(st.booleans(),
       st.lists(st.tuples(st.integers(min_value=0, max_value=5),
                          st.integers(min_value=0, max_value=11),
                          st.integers(min_value=1, max_value=23)),
                min_size=1, max_size=60))
@settings(max_examples=30, deadline=None)
def test_refcount_invariant_under_random_interleavings(with_fixed, ops):
    """The reference's random alloc/share/append(+COW)/free/insert/evict
    schedules, run on both packages at once: every op returns the same
    value, the two ledgers hold the same refcounts and tables after it,
    and the port's refcounts equal its table plus cache references, with
    no block leaked or double-freed; a full teardown returns the pool."""
    sides = []
    for kv, pc in (_PKGS["ref"], _PKGS["port"]):
        led = _ledger(kv, num_blocks=32, fixed=100 if with_fixed else 0)
        sides.append([led, pc.PrefixCache(led, capacity_blocks=10), {}, 0])
    for op in ops:
        outs = []
        for side in sides:
            side[3], out = _apply_op(side[0], side[1], side[2], side[3], op)
            outs.append(out)
        assert outs[1] == outs[0], op
        (lr, cr, _, _), (lt, ct, _, _) = sides
        assert lt._refs == lr._refs and lt.tables == lr.tables
        assert sorted(ct.index.blocks()) == sorted(cr.index.blocks())
        assert ct.stats == cr.stats
        _check_conservation(lt, ct)
    led, cache, live, _ = sides[1]
    for rid in list(live):
        led.free(rid)
        _check_conservation(led, cache)
    cache.release_all()
    assert led.free_blocks() == led.num_blocks, "teardown leaked blocks"


# ---------------------------------------------------------------------------
# the store's one-time gather of a shared head
# ---------------------------------------------------------------------------


def test_copy_prefix_matches_reference_gather(setup):
    """``PagedStore.copy_prefix`` moves the rows ``repro``'s
    ``_gather_rows`` moves on one pool (source blocks in other slots'
    regions, out of order, one of them overlapping the destination's own
    region) and returns its bytes."""
    cfg_r, cfg, _, _ = setup
    store = tkv.PagedStore(cfg, num_slots=4, kv_capacity=32, block_lines=_BLK,
                           device="cpu")
    store_r = rkv.PagedStore(cfg_r, num_slots=4, kv_capacity=32,
                             block_lines=_BLK)
    rng = np.random.default_rng(0)
    before = {}
    for path in store._paths:
        i, pj, key, _ = path
        leaf = store.state["layers"][i][pj][key]
        before[path] = rng.standard_normal(tuple(leaf.shape)).astype(
            np.float32)
        leaf.copy_(torch.as_tensor(before[path]))
        store_r.state["layers"][i][pj][key] = jax.numpy.asarray(before[path])
    # blocks 5 (slot 1, block 1), 12 (slot 3, block 0) and 9 (slot 2,
    # block 1: inside the rows slot 2 receives)
    blocks, dst, n = [5, 12, 9], 2, 20
    moved = store.copy_prefix(blocks, dst, n)
    assert moved == store_r.copy_prefix(blocks, dst, n) \
        == store.costs.line_bytes * n
    src_slots = np.asarray([blocks[j // _BLK] // 4 for j in range(n)])
    src_pos = np.asarray([(blocks[j // _BLK] % 4) * _BLK + j % _BLK
                          for j in range(n)])
    for path in store._paths:
        i, pj, key, _ = path
        got = store.state["layers"][i][pj][key].numpy()
        assert np.array_equal(
            got, np.asarray(store_r.state["layers"][i][pj][key])), path
        # the reference's gather on the pool as it was before the copy
        want = _gather_rows(jax.numpy.asarray(before[path]), dst, src_slots,
                            src_pos, np.arange(n))
        assert np.array_equal(got, np.asarray(want)), path
        assert not np.array_equal(got, before[path])
    assert store.copy_prefix(blocks, dst, 0) == 0.0


def test_engine_hit_prefills_only_the_suffix(setup):
    """An engine with the cache: the second request of a prefix group
    adopts the first one's head, prefills only its suffix through the
    chunk path at ``q_offset`` = the hit, and samples the token the
    cache-off engine samples, with as many host syncs; the ledger holds
    the head once."""
    _, cfg, _, params = setup
    rng = np.random.default_rng(3)
    head = rng.integers(0, cfg.vocab_size, (1, 16), dtype=np.int32)

    def req(i, plen):
        toks = rng.integers(0, cfg.vocab_size, (1, plen), dtype=np.int32)
        toks[0, :16] = head[0]
        return toks

    toks = [req(0, 22), req(1, 27)]
    out = []
    for cache in (True, False):
        eng = InstanceEngine(cfg, params, num_slots=3, kv_capacity=64,
                             block_lines=_BLK, prefix_cache=cache,
                             device="cpu")
        reqs = [Request(prompt_len=t.shape[1], max_new_tokens=6, rid=i,
                        prompt_tokens=t, prefix_id=0, prefix_len=16)
                for i, t in enumerate(toks)]
        hits = []
        for r in reqs:
            hit = eng.prefix_stamp(r)
            hits.append(hit)
            plan = PrefillPlan(0, (PrefillItem(r.rid, r.prompt_len, hit,
                                               r.prompt_len, req=r),), 32)
            eng.prefill_batch(plan)
        saved = eng.store.ledger.shared_saved_blocks()
        while eng.slot_req:
            eng.decode()
        out.append(([r.output_tokens for r in reqs], hits, saved,
                    eng.host_syncs))
    (on, hits_on, saved_on, syncs_on), (off, hits_off, saved_off,
                                         syncs_off) = out
    assert syncs_on == syncs_off > 0
    assert hits_on == [0, 16] and hits_off == [0, 0]
    # each head block: the first request's table, the cache, the second's
    assert saved_on == 2 * 2 and saved_off == 0
    assert on == off


# ---------------------------------------------------------------------------
# golden lockstep trace: the reference's script through both backends of
# both packages
# ---------------------------------------------------------------------------

_PTRACE = [("arrive", 24, 4, 0, 24), ("tick",),
           ("arrive", 24, 5, 0, 24), ("arrive", 18, 4, None, 0), ("tick",),
           ("arrive", 25, 3, 0, 24), ("arrive", 20, 6, 1, 16), ("tick",),
           ("arrive", 20, 4, 1, 16), ("tick",), ("tick",)]


def _trace_tokens(vocab):
    """Numpy-seeded prompts for the script; a group's members share the
    group's head."""
    rng = np.random.default_rng(7)
    heads = {g: rng.integers(0, vocab, (1, 32), dtype=np.int32)
             for g in (0, 1)}
    out = []
    for op in _PTRACE:
        if op[0] == "arrive":
            _, plen, _, pid, pflen = op
            t = rng.integers(0, vocab, (1, plen), dtype=np.int32)
            if pid is not None:
                t[0, :pflen] = heads[pid][0, :pflen]
            out.append(t)
    return out


def _hit_stats(cache):
    return {k: cache.stats[k]
            for k in ("lookups", "hits", "hit_blocks", "hit_tokens")}


def _run_live_trace(cluster, req_cls, toks):
    cluster.policy.trace = []
    it, rids, saved = iter(toks), [], []
    for op in _PTRACE:
        if op[0] == "arrive":
            _, plen, dlen, pid, pflen = op
            req = req_cls(prompt_len=plen, max_new_tokens=dlen, rid=len(rids),
                          prompt_tokens=next(it), prefix_id=pid,
                          prefix_len=pflen)
            rids.append(req.rid)
            cluster.submit(req)
        cluster.step()
        saved.append(tuple(e.store.ledger.shared_saved_blocks()
                           for e in cluster.engines))
    steps = 0
    while cluster.pending() and steps < 50:
        cluster.step()
        steps += 1
    assert not cluster.pending()
    return {"trace": cluster.policy.trace, "rids": rids, "steps": steps,
            "stats": [_hit_stats(e.prefix_cache) for e in cluster.engines],
            "saved": saved, "hits": cluster.stats["prefix_hits"]}


def _run_sim_trace(sim_mod, policy_cls, kernel, simreq_cls, cfg, rids,
                   extra_ticks):
    kernel.trace = []
    perf = sim_mod.PerfModel(cfg, sim_mod.InstanceSpec(sim_mod.H100, 4))
    sim = sim_mod.Simulator(policy_cls(kernel=kernel), perf, n_instances=2,
                            block_lines=_BLK, prefix_cache=True)
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

    arrivals, saved = iter(rids), []
    for op in _PTRACE:
        skip = None
        if op[0] == "arrive":
            _, plen, dlen, pid, pflen = op
            r = simreq_cls(rid=next(arrivals), arrival=0.0, prompt_len=plen,
                           decode_len=dlen)
            r.prefix_id, r.prefix_len = pid, pflen
            inst = pol.route(r)
            pol._prefix_stamp(inst, r)
            r.generated = 1
            pol.on_prefill_done(inst, [r])
            skip = inst.iid
        tick(skip_iid=skip)
        saved.append(tuple(i.synced_store().ledger.shared_saved_blocks()
                           for i in sim.instances))
    for _ in range(extra_ticks):
        tick()
    return {"trace": kernel.trace,
            "stats": [_hit_stats(i.prefix_cache) for i in sim.instances],
            "saved": saved}


def test_golden_prefix_trace_live_vs_sim_matches_reference(setup):
    """Under prefix-heavy traffic the port's live cluster and simulator
    make the reference's kernel decisions, with its hit accounting and,
    tick for tick, its pool blocks saved by sharing."""
    cfg_r, cfg, params_r, params = setup
    toks = _trace_tokens(cfg.vocab_size)
    kw = dict(n_instances=2, num_slots=8, kv_capacity=256, block_lines=_BLK,
              prefix_cache=True)
    live_r = _run_live_trace(RLiveCluster(cfg_r, params_r, policy=RAcceLLM(),
                                          **kw), RRequest, toks)
    live = _run_live_trace(LiveCluster(cfg, params, policy=AcceLLMScheduler(),
                                       device="cpu", **kw), Request, toks)
    assert live == live_r
    sim_r = _run_sim_trace(rsim, RAcceLLMPolicy, RAcceLLM(), RSimRequest,
                           cfg_r, live_r["rids"], live_r["steps"])
    sim = _run_sim_trace(tsim, AcceLLMPolicy, AcceLLMScheduler(), SimRequest,
                         cfg, live["rids"], live["steps"])
    assert sim == sim_r
    assert live["trace"] == sim["trace"]
    assert live["stats"] == sim["stats"]
    assert live["saved"] == sim["saved"]
    assert live["hits"] == sum(s["hits"] for s in live["stats"]) > 0
    assert any(s > 0 for tick_ in live["saved"] for s in tick_)


# ---------------------------------------------------------------------------
# open-loop shared-prefix serves
# ---------------------------------------------------------------------------


def _reuse_spec(wl, arrival=None):
    return wl.WorkloadSpec(
        arrival=arrival or wl.Poisson(rate=0.6, duration=14.0),
        lengths=wl.UniformLengths(prompt=(10, 16), decode=(3, 6)),
        name="prefix-heavy",
        prefix_reuse=wl.PrefixReuse(pool=2, reuse=0.8, prefix_len=8))


class _Replay:
    """An open-loop source over fixed requests."""

    def __init__(self, reqs):
        self._reqs, self.concurrency = reqs, None

    def __iter__(self):
        return iter(self._reqs)


def _stream(cfg, arrival=None):
    """The port's shared-prefix stream (numpy tokens) and the same requests
    for the reference."""
    port = list(_reuse_spec(twl, arrival and arrival(twl)).source(
        seed=3, cfg=cfg))
    ref = [RRequest(prompt_len=r.prompt_len, max_new_tokens=r.max_new_tokens,
                    arrival=r.arrival, rid=r.rid,
                    prompt_tokens=np.asarray(r.prompt_tokens),
                    prefix_id=r.prefix_id, prefix_len=r.prefix_len)
           for r in port]
    return ref, port


def _fresh(reqs):
    return [Request(prompt_len=r.prompt_len, max_new_tokens=r.max_new_tokens,
                    arrival=r.arrival, rid=r.rid,
                    prompt_tokens=np.asarray(r.prompt_tokens),
                    prefix_id=r.prefix_id, prefix_len=r.prefix_len)
            for r in reqs]


def _serve(cluster, reqs, max_steps=300):
    cluster.policy.trace = []
    cluster.planner.trace = []
    cluster.run(max_steps=max_steps, source=_Replay(reqs))
    return {"stats": dict(cluster.stats), "iterations": cluster.n_iterations,
            "kernel_trace": cluster.policy.trace,
            "plan_trace": cluster.planner.trace,
            "tokens": {r.rid: list(map(int, r.output_tokens)) for r in reqs},
            "finished": sorted(r.rid for r in cluster.finished)}


def test_live_tokens_bit_identical_with_cache_on(setup):
    """With the cache on the port serves the reference's tokens, stats,
    kernel trace and plan trace; and its tokens equal its own run with the
    cache off, bitwise (f32, T = 0)."""
    cfg_r, cfg, params_r, params = setup
    ref_reqs, reqs = _stream(cfg)
    kw = dict(n_instances=2, num_slots=4, kv_capacity=64, block_lines=_BLK)
    on_r = _serve(RLiveCluster(cfg_r, params_r, policy=RAcceLLM(),
                               prefix_cache=True, **kw), ref_reqs)
    on = _serve(LiveCluster(cfg, params, policy=AcceLLMScheduler(),
                            prefix_cache=True, device="cpu", **kw), reqs)
    off = _serve(LiveCluster(cfg, params, policy=AcceLLMScheduler(),
                             device="cpu", **kw), _fresh(reqs))
    assert on == on_r
    assert off["stats"]["prefix_hits"] == 0
    assert on["stats"]["prefix_hits"] > 0
    assert on["stats"]["prefix_hit_tokens"] > 0
    assert len(on["finished"]) == len(reqs)
    assert on["tokens"] == off["tokens"], \
        "prefix-cache adoption changed a generated token"


def test_live_batch_arrival_never_overcommits_slots(setup):
    """A batch arrival of more requests than slots under heavy reuse: a
    stamped pin can wall off the last free slot's region between the
    policy's admission count and execution.  Every request drains, with
    the reference's hits, stats and decisions."""
    cfg_r, cfg, params_r, params = setup
    ref_reqs, reqs = _stream(cfg, arrival=lambda wl: wl.Batch(n=12))
    kw = dict(n_instances=2, num_slots=3, kv_capacity=64, block_lines=_BLK,
              prefix_cache=True)
    out_r = _serve(RLiveCluster(cfg_r, params_r, policy=RAcceLLM(), **kw),
                   ref_reqs, max_steps=400)
    out = _serve(LiveCluster(cfg, params, policy=AcceLLMScheduler(),
                             device="cpu", **kw), reqs, max_steps=400)
    assert len(out["finished"]) == 12, "batch arrival did not drain"
    assert out["stats"]["prefix_hits"] > 0
    assert out == out_r


def test_live_ledger_conservation_under_reuse(setup):
    """Per scheduling iteration, every engine's pool conserves: distinct
    used blocks == table references + cache references - the blocks
    sharing saved, and used bytes stay the line-exact identity.  At the
    end every own-region block the cache does not hold is free, and
    ``release_all`` returns the whole pool."""
    _, cfg, _, params = setup
    cluster = LiveCluster(cfg, params, n_instances=2, num_slots=4,
                          kv_capacity=64, policy=AcceLLMScheduler(),
                          block_lines=_BLK, prefix_cache=True, device="cpu")
    source = iter(_reuse_spec(twl).source(seed=3, cfg=cfg))
    pending = next(source, None)
    saw_sharing = False
    for _ in range(300):
        while pending is not None and pending.arrival <= cluster.now:
            cluster.submit(pending, stamp_arrival=False)
            pending = next(source, None)
        if pending is None and not cluster.pending():
            break
        cluster.step()
        for eng in cluster.engines:
            led = eng.store.ledger
            table_refs = sum(len(t) for t in led.tables.values()) + sum(
                1 for fb in led.fixed_block.values() if fb is not None)
            cache_refs = eng.prefix_cache.cached_blocks()
            assert led.used_blocks() == (table_refs + cache_refs
                                         - led.shared_saved_blocks())
            assert led.free_blocks() + led.used_blocks() == led.num_blocks
            assert led.used_bytes() == pytest.approx(sum(
                led.costs.bytes_at(n) for n in led._lines.values()))
            saw_sharing |= led.shared_saved_blocks() > 0
    assert not cluster.pending(), "trace did not drain"
    assert saw_sharing, "no block was ever shared"
    for eng in cluster.engines:
        led = eng.store.ledger
        assert set(led._refs) == set(eng.prefix_cache.index.blocks())
        eng.prefix_cache.release_all()
        assert led.free_blocks() == led.num_blocks


def test_sim_prefix_run_drains_and_conserves():
    """The simulator's prefix run: the reference's trace, finish times and
    hits; drained, only cache references remain, one per cached block."""
    outs = []
    for sim_mod, wl, cfgs, pol_cls in ((rsim, rwl, rcfg, RAcceLLMPolicy),
                                       (tsim, twl, tcfg, AcceLLMPolicy)):
        cfg = cfgs.get_config("starcoder2-3b").reduced()
        pol = pol_cls()
        pol.kernel.trace = []
        sim = sim_mod.Simulator(pol, sim_mod.PerfModel(
            cfg, sim_mod.InstanceSpec(sim_mod.H100, 4)), n_instances=2,
            block_lines=_BLK, prefix_cache=True)
        done = sim.run(source=_reuse_spec(wl).source(seed=3), horizon=200.0)
        assert len(done) == len(sim.submitted)
        for inst in sim.instances:
            led = inst.synced_store().ledger
            assert set(led._refs) == set(inst.prefix_cache.index.blocks())
            assert all(c == 1 for c in led._refs.values())
        outs.append((pol.kernel.trace,
                     [(r.rid, r.generated, r.finish_time, r.prefix_hit)
                      for r in sorted(sim.submitted, key=lambda r: r.rid)],
                     [dict(i.prefix_cache.stats) for i in sim.instances]))
    assert outs[1] == outs[0]
    assert sum(s["hits"] for s in outs[1][2]) > 0


def test_prefix_cache_entry_points_run_on_the_cpu(setup, capsys):
    """``ServeSpec(prefix_cache=True)`` and ``launch.serve --prefix-cache``
    serve a shared-prefix stream with hits; ``prefix_cache_blocks`` caps
    the cache; an engine of a stack that cannot resume a chunk keeps no
    cache, as in the JAX package."""
    _, cfg, _, params = setup
    rep = tapi.serve(tapi.ServeSpec(
        arch="starcoder2-3b", n_instances=2, num_slots=4, kv_capacity=64,
        block_lines=_BLK, prefix_cache=True, prefix_cache_blocks=6,
        traffic=_reuse_spec(twl), seed=3, max_steps=300, device="cpu"),
        cfg=cfg, params=params)
    assert rep.all_finished and rep.stats["prefix_hits"] > 0
    assert all(e.prefix_cache.capacity_blocks == 6
               and e.prefix_cache.cached_blocks() <= 6
               for e in rep.cluster.engines)
    rc = tlserve.main(["--arch", "starcoder2-3b", "--instances", "2",
                       "--requests", "6", "--slots", "4", "--kv-capacity",
                       "64", "--block-lines", "8", "--scale", "0.05",
                       "--prefix-cache", "--prefix-reuse", "0.8",
                       "--prefix-len", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "prefix_cache=on" in out
    assert "'prefix_hits'" in out
    eng = InstanceEngine(cfg, params, num_slots=2, kv_capacity=64,
                         prefix_cache=True, device="cpu")
    assert eng.prefix_cache.capacity_blocks == 2 * 64 // 16 // 2


# ---------------------------------------------------------------------------
# PagedStore's block-table and sharing accessors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["starcoder2-3b", "jamba-1.5-large-398b"])
def test_paged_store_accessors_match_reference(arch):
    """``line_block_table``, ``delta_since`` and ``shared_saved_bytes`` on
    the same admissions as the JAX package's store: its own slot-affinity
    case (``tests/test_kvstore.py``), a synced mirror's delta, and a
    second request adopting a resident prefix's blocks."""
    cfg_r = rcfg.get_config(arch).reduced()
    cfg = tcfg.get_config(arch).reduced()
    r = rkv.PagedStore(cfg_r, num_slots=4, kv_capacity=64, block_lines=16)
    t = tkv.PagedStore(cfg, num_slots=4, kv_capacity=64, block_lines=16,
                       device="meta")

    def both(op, *args):
        got, want = getattr(t, op)(*args), getattr(r, op)(*args)
        assert got == want, (op, args, got, want)
        return got

    both("alloc", 42, 2, 20)
    table = both("line_block_table", 42)
    assert table == [8, 9]                  # slot 2 owns pool blocks 8..11
    both("mark_synced", 42, 20)
    both("append_line", 42, 45)             # 65 lines: capped at the window
    assert both("line_block_table", 42) == [8, 9, 10, 11]
    for line in (0, 5, 20, 64):
        both("delta_since", 42, line)
    assert both("shared_saved_bytes") == 0
    off = 1 if t._has_fixed else 0
    both("alloc", 7, 0, 40)
    head = t.ledger.tables[7][off:off + 2]
    assert head == r.ledger.tables[7][off:off + 2]
    both("alloc", 8, 1, 40, None, head)
    assert both("shared_saved_bytes") == 2 * t.ledger.block_bytes > 0
    for rid in (7, 8, 42):
        both("line_block_table", rid)
        both("delta_since", rid, 3)
    both("free_slot", 0)
    assert both("shared_saved_bytes") == 0
    both("line_block_table", 8)
