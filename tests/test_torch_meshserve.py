"""Mesh serving of the port held against the JAX package's on the CPU.

The JAX package runs its mesh on the 8 CPU devices ``tests/conftest.py``
forces, in this process.  The port runs one process per rank: its side
runs in gloo worlds of CPU processes (``repro_torch.meshserve.world``,
file rendezvous in a fresh temporary directory) that import no JAX
(``tests/_torch_mesh_worker.py``) and hand their results back as numpy.
One world of 4 ranks runs every check but two, which need a world of 6
(the heterogeneous ``[4, 2]`` pod) and the launcher's own world.  The
reduced starcoder2-3b in f32 (4 query heads, 2 KV heads), the JAX
package's weights bridged through numpy, numpy-seeded prompts:

* ``carve_slices``: disjoint, heterogeneous, ``MeshError`` past the
  world, and ``model_axis_for`` gating, as the JAX package's;
* at tp 2 and 4 the greedy tokens equal the port's one-device engine's
  and the JAX package's sharded engine's, on every rank (shadows too),
  with prefill and paged-decode logits within 1e-4 of both; tp 3 (4 heads
  do not divide) matches too, and cuts nothing: the attention is
  head-bound and neither ``d_ff`` (256) nor the vocab (512) divides 3;
* tensor parallelism past whole heads: a variant with 6 query and 2 KV
  heads at tp 4 (6 does not divide 4) keeps its attention and K/V whole
  on every rank and cuts its FFN and vocab in four; its tokens equal one
  device's and the JAX package's sharded engine's on every rank, its
  logits within 1e-4 of both, and each leaf's per-rank shape equals the
  JAX package's ``param_pspecs`` cut but the four head-bound attention
  leaves;
* each rank's shard bytes at tp 4, where 2 KV heads do not divide: the
  port keeps the head each rank's queries read (half the pool a rank),
  where the JAX package's store replicates K/V (a divergence by design);
* the cross-slice stream and mirror: hops counted device-to-device, no
  host copy, the replica's rows equal to the primary's, and the bytes
  equal to ``LineCosts`` and to ``PerfModel.line_costs``;
* a mesh cluster's stats, kernel trace and tokens equal a host cluster's
  and the JAX package's mesh cluster's stats, on every rank;
* the heterogeneous golden trace, live on a world of 6, against the
  port's simulator and the JAX package's live trace;
* MoE ``psum`` and ``a2a`` on the 2 x 2 ("data", "model") grid of
  ``tests/test_moe_distributed.py`` against the local path and the JAX
  package's strategies (y within 1e-4, aux within 5e-4, its bounds);
* ``ServeSpec(mesh_tp=2, device="cpu")`` through ``api.serve`` and
  ``launch.serve --mesh-tp 2 --device cpu`` against the host serve;
* sequence parallelism (``REPRO_SEQ_PARALLEL=1`` in the ranks) at tp 2:
  the greedy tokens equal the flag-off ones and the JAX package's
  sharded engine's under the flag, on every rank, and the prefill and
  paged-decode logits the flag-off ones within 1e-5 of max|logit|.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.configs as rcfg
import repro.models as rm
from repro import sharding as rsharding
from repro.kvstore import LineCosts as RLineCosts
from repro.launch.specs import param_pspecs as r_param_pspecs
from repro.meshserve import MeshPlacement as RPlacement
from repro.meshserve import carve_slices as rcarve
from repro.meshserve import shard_params as rshard_params
from repro.models.moe import init_moe as r_init_moe
from repro.models.moe import moe_forward as r_moe_forward
from repro.scheduling.accellm import AcceLLMScheduler as RScheduler
from repro.scheduling.live import LiveCluster as RLiveCluster
from repro.serving import InstanceEngine as REngine
from repro.serving import Request as RRequest
from repro.sim import ASCEND_910B2 as R910
from repro.sim import H100 as RH100
from repro.sim import InstanceSpec as RSpec
import repro_torch.api as tapi
import repro_torch.configs as tcfg
import repro_torch.sim as tsim
from repro_torch.bridge import params_from_numpy
from repro_torch.kvstore import KVStoreError, LineCosts, PagedStore
from repro_torch.launch import serve as tlserve
from repro_torch.meshserve import MeshError, carve_slices
from repro_torch.meshserve.pool import head_split, local_state, shard_params
from repro_torch.models import init_state, prefill_batched
from repro_torch.meshserve.world import spawn
from repro_torch.models.moe import moe_forward
from repro_torch.scheduling.accellm import AcceLLMScheduler
from repro_torch.scheduling.live import LiveCluster
import _torch_mesh_worker as W

TOL = 1e-4
SHAPES = [(6 + i % 5, 5) for i in range(6)]
_TRACE = [("arrive", 8, 4), ("tick",), ("arrive", 12, 6), ("arrive", 6, 5),
          ("tick",), ("arrive", 10, 3), ("tick",), ("arrive", 7, 6),
          ("arrive", 9, 4), ("tick",)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def bridge():
    cfg_r = rcfg.get_config("starcoder2-3b").reduced()
    cfg = tcfg.get_config("starcoder2-3b").reduced()
    params_r = rm.init_params(jax.random.PRNGKey(0), cfg_r)
    params_np = _np(params_r)
    return cfg_r, cfg, params_r, params_np, params_from_numpy(params_np,
                                                              device="cpu")


@pytest.fixture(scope="module")
def partial_bridge(bridge):
    """The 6-head variant of ``bridge``: JAX config and params, the port's
    config and params, and the numpy params."""
    cfg_r = W.six_heads(bridge[0])
    params_r = rm.init_params(jax.random.PRNGKey(0), cfg_r)
    params_np = _np(params_r)
    return (cfg_r, W.six_heads(bridge[1]), params_r, params_np,
            params_from_numpy(params_np, device="cpu"))


@pytest.fixture(scope="module")
def moe_case():
    """``tests/test_moe_distributed.py``'s case: reduced arctic-480b with
    4 experts, top-2, capacity factor 8; x (4, 8, d)."""
    cfg_r = rcfg.get_config("arctic-480b").reduced()
    cfg_r = dataclasses.replace(cfg_r, moe=dataclasses.replace(
        cfg_r.moe, num_experts=4, top_k=2, capacity_factor=8.0))
    cfg = tcfg.get_config("arctic-480b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=4, top_k=2, capacity_factor=8.0))
    params = r_init_moe(jax.random.PRNGKey(0), cfg_r, jnp.float32)
    routed = {k: np.asarray(params[k])
              for k in ("router", "w_gate", "w_up", "w_down")}
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (4, 8, cfg_r.d_model)))
    return cfg_r, cfg, routed, x


@pytest.fixture(scope="module")
def world4(bridge, moe_case, partial_bridge):
    _, _, _, params_np, _ = bridge
    _, cfg, routed, x = moe_case
    return spawn("_torch_mesh_worker:world4", 4, device="cpu",
                 args=({"params": params_np, "shapes": SHAPES,
                        "moe_cfg": cfg, "moe_params": routed,
                        "moe_x": x, "partial_params": partial_bridge[3]},),
                 timeout=600)


@pytest.fixture(scope="module")
def world6(bridge):
    return spawn("_torch_mesh_worker:hetero", 6, device="cpu",
                 args=({"params": bridge[3], "trace": _TRACE},), timeout=600)


def _same_on_every_rank(results, key):
    first = results[0][key]
    for r, out in enumerate(results):
        assert out[key] == first, f"rank {r}'s {key} differs from rank 0's"
    return first


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------


def test_carve_slices_disjoint_and_heterogeneous():
    slices = carve_slices(2, n_instances=3, world=8, device="cpu")
    assert [sl.tp for sl in slices] == [2, 2, 2]
    seen = set()
    for sl in slices:
        assert not (set(sl.devices) & seen), "slices must be disjoint"
        seen |= set(sl.devices)
        assert sl.group is None          # no world: no process group
    wide, narrow = carve_slices([4, 2], world=8, device="cpu")
    assert (wide.tp, narrow.tp) == (4, 2)
    assert wide.ranks == (0, 1, 2, 3) and narrow.ranks == (4, 5)
    with pytest.raises(MeshError, match="start 12 processes"):
        carve_slices(4, n_instances=3, world=8, device="cpu")
    with pytest.raises(MeshError, match="processes, one per card"):
        carve_slices(2, n_instances=1, device="cpu")    # a world of one
    with pytest.raises(MeshError):
        carve_slices([2, 0], world=8, device="cpu")


def test_model_axis_gating(mesh8, bridge):
    cfg_r, cfg = bridge[:2]
    two, four = carve_slices([2, 4], world=8, device="cpu")
    r_two, r_four = rcarve([2, 4])
    assert two.model_axis_for(cfg) == r_two.model_axis_for(cfg_r) == "model"
    assert four.model_axis_for(cfg) == r_four.model_axis_for(cfg_r) \
        == "model"
    (three,) = carve_slices(3, n_instances=1, world=8, device="cpu")
    (r_three,) = rcarve(3, n_instances=1)
    assert three.model_axis_for(cfg) is r_three.model_axis_for(cfg_r) is None


def test_head_split_keeps_whole_heads():
    cfg = tcfg.get_config("starcoder2-3b")
    red = cfg.reduced()                                   # 4 / 2 heads
    assert head_split(red, 2) == [((0, 1), (0,)), ((2, 3), (1,))]
    assert head_split(red, 4) == [((0,), (0,)), ((1,), (0,)), ((2,), (1,)),
                                  ((3,), (1,))]
    assert head_split(red, 3) is None
    full = head_split(cfg, 2)                             # 24 / 2 heads
    assert [kv for _, kv in full] == [(0,), (1,)]
    assert [len(q) for q, _ in full] == [12, 12]
    # queries that straddle two KV groups keep one copy per query
    odd = dataclasses.replace(red, num_heads=6, num_kv_heads=3)
    assert head_split(odd, 2) == [((0, 1, 2), (0, 0, 1)),
                                  ((3, 4, 5), (1, 2, 2))]


@pytest.mark.parametrize("part", ["embed", "mixer", "ffn", "lm_head"])
def test_a_shard_refuses_to_run_without_a_mesh(bridge, part):
    """A whole tree with one part replaced by rank 0's shard of it, run
    with no mesh installed: the model raises where it would sum or gather
    over the ranks, never returning a rank's partial as the answer."""
    _, cfg, _, _, params = bridge
    (sl,) = carve_slices(2, 1, world=2, device="cpu")
    shard = shard_params(cfg, params, sl)
    tree = dict(params)
    if part in ("embed", "lm_head"):
        tree[part] = shard[part]
    else:
        seg = dict(params["segments"][0]["p0"])
        seg[part] = shard["segments"][0]["p0"][part]
        tree["segments"] = [{"p0": seg}] + params["segments"][1:]
    state = (local_state(cfg, sl, 1, 16) if part == "mixer"
             else init_state(cfg, 1, 16, device="cpu"))
    toks = torch.as_tensor(W.prompt(0, 8, cfg.vocab_size))
    with pytest.raises(RuntimeError, match="no mesh installed"):
        prefill_batched(cfg, tree, toks, state, torch.tensor([8]))
    (whole,) = W.logits_at(cfg, params, None)[:1]       # whole: no mesh
    assert np.isfinite(whole).all()


def test_stores_on_two_devices_move_state_only_between_slices(bridge):
    """Two whole stores of one process on two devices neither mirror nor
    stream into each other: no entry point builds them, and a copy
    between their devices would go uncounted."""
    cfg = bridge[1]
    host = PagedStore(cfg, 2, 16, device="cpu")
    other = PagedStore(cfg, 2, 16, device="meta")
    with pytest.raises(KVStoreError, match="mirror only between mesh"):
        host.copy_lines(other, 0, 1, 1, 5)
    path, chunk = next(iter(other.stream_slot(0)))
    with pytest.raises(KVStoreError, match="stream only between mesh"):
        host.import_chunk(1, path, chunk)


# ---------------------------------------------------------------------------
# sharded engines: tokens, logits, bytes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_device(bridge):
    _, cfg, _, _, params = bridge
    eng, tokens = W.generate(cfg, params, None)
    pre, dec = W.logits_at(cfg, params, None)
    return {"tokens": tokens, "prefill": pre, "decode": dec,
            "state_bytes": eng.state_bytes()}


def _ref_requests(cfg_r, n, seed=3, steps=5):
    return [RRequest(prompt_len=6 + (i % 5), max_new_tokens=steps, rid=i,
                     prompt_tokens=W.prompt(i, 6 + (i % 5), cfg_r.vocab_size,
                                            seed))
            for i in range(n)]


def _ref_engine(cfg_r, params_r, tp):
    sl = rcarve(tp, n_instances=1)[0] if tp else None
    return REngine(cfg_r, params_r, num_slots=4, kv_capacity=64,
                   temperature=0.0, mesh=sl)


def _ref_tokens(cfg_r, params_r, tp):
    eng = _ref_engine(cfg_r, params_r, tp)
    reqs = _ref_requests(cfg_r, 3)
    for r in reqs:
        eng.prefill_request(r)
    eng.decode_multi(steps=4)
    return [list(map(int, r.output_tokens)) for r in reqs]


def _ref_logits(cfg_r, params_r, tp):
    """The JAX package's prefill and paged-decode logits on a sharded
    slice, under its sharding context: the same inputs as
    ``_torch_mesh_worker.logits_at``."""
    (sl,) = rcarve(tp, n_instances=1)
    p = rshard_params(cfg_r, params_r, sl)
    toks = np.zeros((4, 16), np.int32)
    lens = np.ones((4,), np.int32)
    for i, r in enumerate(_ref_requests(cfg_r, 3)):
        toks[i, :r.prompt_len] = r.prompt_tokens[0]
        lens[i] = r.prompt_len
    with rsharding.use_mesh(sl.mesh, batch_axes=(),
                            model_axis=sl.model_axis_for(cfg_r)):
        pre, st = jax.jit(functools.partial(rm.prefill_batched, cfg_r))(
            p, jnp.asarray(toks), rm.init_state(cfg_r, 4, 16),
            jnp.asarray(lens))
        nxt = jnp.argmax(pre, -1).astype(jnp.int32)
        dec, _ = jax.jit(functools.partial(rm.decode_step_paged, cfg_r,
                                           block_lines=16))(
            p, nxt[:, None], st, jnp.asarray(lens), jnp.arange(4),
            jnp.arange(4, dtype=jnp.int32)[:, None])
    return np.asarray(pre), np.asarray(dec)


@pytest.mark.parametrize("tp", [2, 4, 3])
def test_sharded_tokens_equal_one_device_and_reference(mesh8, bridge,
                                                       world4, one_device, tp):
    cfg_r, _, params_r, _, _ = bridge
    tokens = [out["tp"][tp]["tokens"] for out in world4]
    assert all(t == tokens[0] for t in tokens), "ranks disagree"
    assert tokens[0] == one_device["tokens"]
    assert tokens[0] == _ref_tokens(cfg_r, params_r, tp)
    holds = [out["tp"][tp]["holds"] for out in world4]
    assert holds == [r < tp for r in range(4)]      # the rest are shadows


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_logits_match(mesh8, bridge, world4, one_device, tp):
    cfg_r, _, params_r, _, _ = bridge
    ref_pre, ref_dec = _ref_logits(cfg_r, params_r, tp)
    for r, out in enumerate(world4[:tp]):
        mine = out["tp"][tp]
        for got, one, ref in ((mine["prefill"], one_device["prefill"],
                               ref_pre),
                              (mine["decode"], one_device["decode"],
                               ref_dec)):
            assert np.abs(got - one).max() < TOL, r
            assert np.abs(got - ref).max() < TOL, r


def test_shard_bytes_per_rank(mesh8, bridge, world4, one_device):
    """At tp 4 the 2 KV heads do not divide the slice: each rank keeps
    the one head its query reads, half the pool, where the JAX package's
    ``shard_store`` replicates K/V on every device of the slice."""
    cfg_r, cfg, params_r, _, _ = bridge
    whole = one_device["state_bytes"]
    for tp in (2, 4):
        got = [out["tp"][tp]["state_bytes"] for out in world4]
        assert got[:tp] == [whole // 2] * tp, (tp, got)
        assert all(b == 0 for b in got[tp:])        # shadows hold nothing
    # tp 3: the 4 heads do not divide, so K/V stay whole on every rank
    assert [out["tp"][3]["state_bytes"] for out in world4] == \
        [whole] * 3 + [0]
    # the JAX package at tp 4: every device's K shard holds every KV head
    eng = _ref_engine(cfg_r, params_r, 4)
    k = eng.store.state["layers"][0]["p0"]["k"]
    assert len(k.addressable_shards) == 4
    assert {s.data.shape[3] for s in k.addressable_shards} == \
        {cfg.num_kv_heads}
    # params: tp 2 halves every attention and FFN matrix and the vocab
    p1 = sum(v.size * 4 for v in jax.tree_util.tree_leaves(params_r))
    p2 = world4[0]["tp"][2]["param_bytes"]
    norms = 4 * cfg.d_model * (2 * cfg.num_layers + 1)
    assert p2 == (p1 - norms) // 2 + norms
    # tp 3 cuts no leaf: the attention is head-bound (4 heads do not
    # divide 3) and neither d_ff 256 nor the vocab 512 divides 3
    assert [out["tp"][3]["param_bytes"] for out in world4[:3]] == [p1] * 3


# ---------------------------------------------------------------------------
# tensor parallelism past whole heads: 6 query heads at tp 4
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def partial_one_device(partial_bridge):
    _, cfg, _, _, params = partial_bridge
    eng, tokens = W.generate(cfg, params, None)
    pre, dec = W.logits_at(cfg, params, None)
    return {"tokens": tokens, "prefill": pre, "decode": dec,
            "state_bytes": eng.state_bytes()}


def test_partial_tp_tokens_equal_one_device_and_reference(
        mesh8, partial_bridge, world4, partial_one_device):
    cfg_r, cfg, params_r, _, _ = partial_bridge
    assert cfg.num_heads % 4 and cfg.d_ff % 4 == cfg.vocab_size % 4 == 0
    tokens = _same_on_every_rank([o["partial"] for o in world4], "tokens")
    assert tokens == partial_one_device["tokens"]
    assert tokens == _ref_tokens(cfg_r, params_r, 4)
    assert all(o["partial"]["holds"] for o in world4)


def test_partial_tp_logits_match(mesh8, partial_bridge, world4,
                                 partial_one_device):
    cfg_r, _, params_r, _, _ = partial_bridge
    ref_pre, ref_dec = _ref_logits(cfg_r, params_r, 4)
    one = partial_one_device
    for r, out in enumerate(world4):
        mine = out["partial"]
        for got, want, ref in ((mine["prefill"], one["prefill"], ref_pre),
                               (mine["decode"], one["decode"], ref_dec)):
            assert np.abs(got - want).max() < TOL, r
            assert np.abs(got - ref).max() < TOL, r


def test_partial_tp_param_shapes_follow_the_pspecs_but_the_attention(
        partial_bridge, world4):
    """Leaf by leaf against the JAX package's ``param_pspecs`` at
    ``model_n=4``: equal, but for the head-bound attention leaves, which
    the pspecs cut by width (384 and 128 divide 4) and the port keeps
    whole (6 heads do not)."""
    cfg_r, _, params_r, _, _ = partial_bridge
    specs = r_param_pspecs(cfg_r, params_r, mode="serve", model_n=4)
    want = {}
    for (path, leaf), spec in zip(
            jax.tree_util.tree_flatten_with_path(params_r)[0],
            jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))):
        name = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        want[name] = tuple(
            n // 4 if ax == "model" else n
            for n, ax in zip(leaf.shape, tuple(spec) + (None,) * leaf.ndim))
    head_bound = {f"segments/0/p0/mixer/{n}" for n in ("wq", "wk", "wv",
                                                          "wo")}
    for r, out in enumerate(world4):
        got = out["partial"]["params"]
        assert set(got) == set(want)
        assert {p for p in want if got[p] != want[p]} == head_bound, r


def test_partial_tp_bytes_per_rank(partial_bridge, world4,
                                   partial_one_device):
    """Each rank holds the attention leaves whole, a quarter of the FFN
    and of the vocab (``embed``, ``lm_head``), the norms whole; its K/V
    pool is one device's, whole."""
    _, cfg, _, _, params = partial_bridge
    attn = sum(t.numel() * 4 for k, t in
               params["segments"][0]["p0"]["mixer"].items())
    norms = 4 * cfg.d_model * (2 * cfg.num_layers + 1)
    rest = sum(t.numel() * 4 for t in W._leaves(params)) - attn - norms
    for r, out in enumerate(world4):
        mine = out["partial"]
        assert mine["param_bytes"] == attn + norms + rest // 4, r
        assert mine["state_bytes"] == partial_one_device["state_bytes"], r
        shapes = mine["state"]
        for key in ("k", "v"):
            assert shapes[f"layers/0/p0/{key}"][-2] == cfg.num_kv_heads


# ---------------------------------------------------------------------------
# cross-slice stream and mirror
# ---------------------------------------------------------------------------


def test_cross_slice_stream_and_mirror(bridge, world4):
    cfg_r, cfg = bridge[:2]
    for rank, out in enumerate(world4):
        s = out["stream"]
        assert s["rank_in"] == (rank < 2, rank >= 2)
        assert s["stream"][0] > 0, "the stream must cross the slices"
        assert s["mirror"][0] > 0, "the mirror must cross the slices"
        assert s["stream"][2] == s["mirror"][2] == 0, "a host copy"
        assert s["delta"] == 1
        costs = LineCosts.from_config(cfg)
        assert s["moved"] == costs.mirror_bytes(s["delta"])
        assert s["moved"] == RLineCosts.from_config(cfg_r).mirror_bytes(1)
        perf = tsim.PerfModel(cfg, tsim.InstanceSpec(tsim.H100, 2))
        assert s["moved"] == perf.line_costs.mirror_bytes(s["delta"])
    # the replica's rows equal the primary's, head by head: ranks 0 and 2
    # hold KV head 0 of slices a and b, ranks 1 and 3 head 1
    for a, b in ((0, 2), (1, 3)):
        ra, rb = world4[a]["stream"]["rows_a"], world4[b]["stream"]["rows_b"]
        assert ra.shape == rb.shape and np.array_equal(ra, rb)
        assert np.abs(ra).max() > 0


# ---------------------------------------------------------------------------
# mesh cluster
# ---------------------------------------------------------------------------


def test_mesh_cluster_matches_host_and_reference(mesh8, bridge, world4):
    cfg_r, cfg, params_r, _, params = bridge
    stats = _same_on_every_rank([o["cluster"] for o in world4], "stats")
    trace = _same_on_every_rank([o["cluster"] for o in world4], "trace")
    tokens = _same_on_every_rank([o["cluster"] for o in world4], "tokens")
    for out in world4:
        assert out["cluster"]["finished"] == len(SHAPES)
        d2d, host = out["cluster"]["transfers"]
        assert d2d > 0 and host == 0
    kernel = AcceLLMScheduler()
    kernel.trace = []
    host = LiveCluster(cfg, params, 2, 6, 64, kernel, device="cpu")
    reqs = [W.Request(prompt_len=p, max_new_tokens=d, rid=i,
                      prompt_tokens=W.prompt(i, p, cfg.vocab_size, seed=11))
            for i, (p, d) in enumerate(SHAPES)]
    for r in reqs:
        host.submit(r)
    assert len(host.run(max_steps=200)) == len(SHAPES)
    assert stats == host.stats
    assert trace == kernel.trace
    assert tokens == [list(map(int, r.output_tokens)) for r in reqs]
    ref = RLiveCluster(cfg_r, params_r, n_instances=2, num_slots=6,
                       kv_capacity=64, policy=RScheduler(),
                       mesh=RPlacement.carve(2, tp=2))
    for i, (p, d) in enumerate(SHAPES):
        ref.submit(RRequest(prompt_len=p, max_new_tokens=d, rid=i,
                            prompt_tokens=W.prompt(i, p, cfg.vocab_size,
                                                   seed=11)))
    assert len(ref.run(max_steps=200)) == len(SHAPES)
    for key in ("mirror_syncs", "mirror_bytes", "stream_bytes",
                "replica_promotions", "prefills", "decode_steps"):
        assert stats[key] == ref.stats[key], key
    assert stats["mirror_syncs"] > 0


def test_join_past_the_pod_lands_unsharded(bridge, world4):
    """An autoscaled join past the carved pod: every rank builds the
    third instance whole and serves it alike; the stats, fleet stats and
    tokens equal a host cluster's with the same schedule."""
    _, cfg, _, _, params = bridge
    out = _same_on_every_rank([o["join"] for o in world4], "stats")
    joins = [o["join"] for o in world4]
    host = W.join_past_the_pod(cfg, params)
    for key in ("finished", "stats", "fleet", "tokens"):
        assert all(j[key] == host[key] for j in joins), key
    unsharded, served, nbytes = joins[0]["joined"]
    assert unsharded and served and nbytes == host["joined"][2] > 0
    assert all(j["joined"] == joins[0]["joined"] for j in joins)
    assert joins[0]["spec"] is None and out["prefills"] == 8


def test_api_serve_mesh_tp(world4):
    stats = _same_on_every_rank([o["serve"] for o in world4], "stats")
    tokens = _same_on_every_rank([o["serve"] for o in world4], "tokens")
    rep = tapi.serve(tapi.ServeSpec(arch="starcoder2-3b", n_instances=2,
                                    num_slots=4, kv_capacity=64, n_requests=6,
                                    request_scale=0.02, device="cpu"))
    assert world4[0]["serve"]["finished"] == len(rep.finished) == 6
    assert stats == rep.stats
    assert tokens == sorted((r.rid, tuple(r.output_tokens))
                            for r in rep.finished)


def test_launch_serve_mesh_tp(capsys):
    argv = ["--arch", "starcoder2-3b", "--instances", "2", "--requests", "4",
            "--slots", "4", "--kv-capacity", "64", "--scale", "0.02",
            "--device", "cpu"]
    assert tlserve.main(argv) == 0
    host = capsys.readouterr().out
    assert tlserve.main(argv + ["--mesh-tp", "2"]) == 0
    mesh = capsys.readouterr().out
    assert "mesh slices: 2 x tp 2 over 4 processes" in mesh
    stats = [line for line in host.splitlines() if line.startswith("stats:")]
    assert stats and stats[0] in mesh.splitlines()


# ---------------------------------------------------------------------------
# heterogeneous golden trace
# ---------------------------------------------------------------------------


def _sim_trace(cfg, rids, extra_ticks, specs):
    """The JAX package's lock-step drive of the simulator adapter, each
    instance priced on its own slice's spec."""
    kernel = AcceLLMScheduler()
    kernel.trace = []
    sim = tsim.Simulator(tsim.AcceLLMPolicy(kernel=kernel),
                         [tsim.PerfModel(cfg, s) for s in specs],
                         n_instances=2)
    sim.kick = lambda inst: None
    pol = sim.policy
    views = list(pol.view().instances())
    assert [v.spec() for v in views] == list(specs)

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


def _ref_hetero(cfg_r, params_r):
    kernel = RScheduler()
    kernel.trace = []
    specs = (RSpec(RH100, 4, intra_link_gbps=RH100.link_gbps),
             RSpec(R910, 2, intra_link_gbps=R910.link_gbps))
    cluster = RLiveCluster(cfg_r, params_r, n_instances=2, num_slots=8,
                           kv_capacity=256, policy=kernel,
                           mesh=RPlacement.carve(2, specs=specs))
    for i, op in enumerate(_TRACE):
        if op[0] == "arrive":
            cluster.submit(RRequest(
                prompt_len=op[1], max_new_tokens=op[2], rid=100 + i,
                prompt_tokens=W.prompt(i, op[1], cfg_r.vocab_size, seed=7)))
        cluster.step()
    while cluster.pending():
        cluster.step()
    return kernel.trace, cluster.stats


def test_golden_trace_hetero_mesh(mesh8, bridge, world6):
    cfg_r, cfg, params_r, _, _ = bridge
    trace = _same_on_every_rank(world6, "trace")
    stats = _same_on_every_rank(world6, "stats")
    out = world6[0]
    assert out["tps"] == [4, 2] and out["specs"] == [True, True]
    assert not out["pending"]
    specs = (tsim.InstanceSpec(tsim.H100, 4,
                               intra_link_gbps=tsim.H100.link_gbps),
             tsim.InstanceSpec(tsim.ASCEND_910B2, 2,
                               intra_link_gbps=tsim.ASCEND_910B2.link_gbps))
    assert trace == _sim_trace(cfg, out["rids"], out["steps"], specs)
    ref_trace, ref_stats = _ref_hetero(cfg_r, params_r)
    assert trace == ref_trace
    assert {"route", "place"} <= {e[0] for e in trace}
    assert stats["mirror_syncs"] > 0 and stats["mirror_bytes"] > 0
    for key in ("mirror_syncs", "mirror_bytes", "stream_bytes", "prefills",
                "decode_steps", "replica_promotions"):
        assert stats[key] == ref_stats[key], key


# ---------------------------------------------------------------------------
# MoE strategies
# ---------------------------------------------------------------------------


def test_moe_strategies_match_local_and_reference(mesh8, world4, moe_case):
    cfg_r, cfg, routed, x = moe_case
    y_ref, aux_ref = moe_forward(cfg, {k: torch.tensor(v)
                                       for k, v in routed.items()},
                                 torch.tensor(x))
    y_ref, aux_ref = y_ref.numpy(), float(aux_ref)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    ref = {}
    for strategy in ("a2a", "psum"):
        with rsharding.use_mesh(mesh, batch_axes=("data",),
                                model_axis="model", moe_strategy=strategy):
            y, aux = jax.jit(lambda xx: r_moe_forward(
                cfg_r, {k: jnp.asarray(v) for k, v in routed.items()},
                xx))(jnp.asarray(x))
        ref[strategy] = (np.asarray(y), float(aux))
    with rsharding.use_mesh(mesh, batch_axes=("data",), model_axis="model"):
        want = tuple(rsharding.spec("batch", None, "model", "seq"))
    for out in world4:
        # the logical-axis rules inside the grid's context and outside any
        # (``PartitionSpec`` folds a one-name tuple of axes into the name)
        got = tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                    for a in out["moe"]["spec"])
        assert out["moe"]["spec"][0] == ("data",)
        assert got == want == ("data", None, "model", "model")
        assert out["moe"]["spec_outside"] == tuple(
            rsharding.spec("batch", None, "model")) == (None, None, None)
    for rank, out in enumerate(world4):
        data = rank // 2
        rows = slice(2 * data, 2 * data + 2)
        for strategy in ("a2a", "psum"):
            y, aux = out["moe"][strategy]
            assert np.abs(y - y_ref[rows]).max() < 1e-4, (rank, strategy)
            assert abs(aux - aux_ref) < 5e-4, (rank, strategy)
            ry, raux = ref[strategy]
            assert np.abs(y - ry[rows]).max() < 1e-4, (rank, strategy)
            assert abs(aux - raux) < 1e-6, (rank, strategy)


# ---------------------------------------------------------------------------
# sequence parallelism (REPRO_SEQ_PARALLEL=1)
# ---------------------------------------------------------------------------


def test_seq_parallel_engine_matches_flag_off_and_reference(
        mesh8, bridge, world4, monkeypatch):
    cfg_r, _, params_r, _, _ = bridge
    for out in world4:
        assert out["sp"]["tokens"] == out["tp"][2]["tokens"]
    monkeypatch.setenv("REPRO_SEQ_PARALLEL", "1")
    assert world4[0]["sp"]["tokens"] == _ref_tokens(cfg_r, params_r, 2)
    for out in world4[:2]:
        for key in ("prefill", "decode"):
            want = out["tp"][2][key]
            err = float(np.abs(out["sp"][key] - want).max())
            assert err <= 1e-5 * float(np.abs(want).max()), (key, err)
        kinds = {k for k, _, _ in out["sp"]["calls"]}
        assert {"reduce-scatter", "all-gather"} <= kinds
