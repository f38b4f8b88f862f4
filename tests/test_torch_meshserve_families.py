"""Mesh serving of the Mamba, MLA, xLSTM, encoder-decoder and vision
stacks held against the JAX package's sharded engine on the CPU.

The JAX package runs its mesh on the 8 CPU devices ``tests/conftest.py``
forces, in this process; the port runs one process per rank, in one
gloo world of 4 CPU processes (``_torch_mesh_worker.families``, which
imports no JAX).  The reduced f32 configs of jamba-1.5-large-398b,
deepseek-v3-671b, xlstm-1.3b, seamless-m4t-large-v2 and internvl2-1b
(4 query heads each), and arctic-480b for the MoE capacity case, with
the JAX package's weights bridged through numpy, numpy-seeded prompts and
modality payloads (``workloads.default_extras``):

* at tp 2 and 4 the greedy tokens of three requests (5 tokens each) equal
  the JAX package's sharded engine's on every rank (shadows too), and the
  prefill and two dense decode steps' logits are within 1e-4 of its
  logits, at the published MoE capacity factor 1.25 too (arctic at tp 2);
* against the port's one-device engine: the tokens of the stacks without
  MoE equal it at tp 2 and 4; the MoE stacks' do at the dropless factor
  ``num_experts / top_k``, while at 1.25 the per-shard ``a2a`` capacity
  changes jamba's tokens, as it changes the JAX package's own (a
  divergence by design of the reference, pinned here);
* per-rank shapes of every parameter leaf against the JAX package's
  ``param_pspecs``, and of every state leaf against its ``state_pspecs``
  model axis: equal, except for the divergences by design the rule table
  makes (``repro_torch.meshserve.pool``), one case each;
* tensor parallelism past whole heads: reduced arctic-480b (dropless)
  with 6 query and 2 KV heads at tp 4 keeps its attention whole and cuts
  its experts (one a rank), its residual FFN and its vocab; tokens equal
  one device's and the JAX package's sharded engine's, logits within
  1e-4, and every leaf's per-rank shape equals the ``param_pspecs`` cut
  but the head-bound leaves, logged (``tests/test_torch_meshserve.py``
  holds the 6-head starcoder2-3b alike);
* a mutation: Mamba's ``in_proj`` or the sLSTM FFN's ``w_up`` cut as one
  contiguous block (the pspec's cut) instead of per packed half gives
  logits off the one-device ones by far more than the tolerance, where
  the rule table's cut stays within it; and the head gate: reduced
  xlstm-1.3b with 2 heads at tp 4, whose ``w_up`` columns divide 4 while
  its heads do not, gives one device's logits with its mLSTM whole, and
  logits far off them with every mLSTM leaf cut in contiguous blocks of
  ``d_in / 4`` channels (half a head a rank);
* without a world: each rank's part of a sharded store is the whole leaf
  at the indices its ``holders`` records (what a pull plans from), and
  the pull planner takes every index from the rank that holds it;
* sequence parallelism (``REPRO_SEQ_PARALLEL=1`` set in the ranks): at
  tp 2 ``prefill`` and ``prefill_batched`` of GQA, jamba (Mamba, MoE
  ``a2a``), deepseek-v3 (MLA), xLSTM, seamless-m4t (cross attention;
  ``prefill`` only: ``prefill_batched`` takes no frames), internvl2
  (the prefix) and minicpm-2b with 3 query heads (attention whole) give
  the flag-off logits within 1e-5 of max|logit| and equal caches, through
  reduce-scatters and all-gathers on the sequence.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as rcfg
import repro.models as rm
from repro import sharding as rsharding
from repro.configs.base import InputShape as RInputShape
from repro.launch.specs import param_pspecs as r_param_pspecs
from repro.launch.specs import state_pspecs as r_state_pspecs
from repro.meshserve import carve_slices as rcarve
from repro.meshserve import shard_params as rshard_params
from repro.serving import InstanceEngine as REngine
from repro.serving import Request as RRequest
import repro_torch.configs as tcfg
from repro_torch.bridge import params_from_numpy
from repro_torch.meshserve.world import spawn
import _torch_mesh_worker as W

TOL = 1e-4
FAMILIES = W.FAMILIES
ARCTIC = "arctic-480b"
MOE = ("jamba-1.5-large-398b", "deepseek-v3-671b", ARCTIC)
#: the 6-query-head variants (``_torch_mesh_worker.six_heads``, MoE
#: dropless), served at tp 4 only: their heads do not divide 4
VARIANTS = {"arctic-480b/6h": ARCTIC}
#: the sequence-parallel prefill cases: name -> (arch, head overrides)
SEQ_PARALLEL = {"starcoder2-3b": ("starcoder2-3b", None),
                **{a: (a, None) for a in W.FAMILIES},
                "minicpm-3h": ("minicpm-2b",
                               {"num_heads": 3, "num_kv_heads": 1})}
#: the head gate's case: 2 heads at tp 4
HEAD_CUT = {"arch": "xlstm-1.3b",
            "heads": {"num_heads": 2, "num_kv_heads": 2}, "tp": 4}
#: a rule replaced by the contiguous cut of the pspec: (arch, xLSTM
#: overrides giving the sLSTM FFN an even width, the mutated rules)
MUTATE = {
    "mamba-in_proj": ("jamba-1.5-large-398b", None,
                      {"mamba": {"in_proj": (-1, 1)}}),
    "slstm-w_up": ("xlstm-1.3b", {"proj_factor_slstm": 1.25},
                   {"slstm": {"w_up": (-1, 1)}}),
}
#: where the rule table's per-rank parameter cut departs from the JAX
#: package's ``param_pspecs`` (ROADMAP.md, divergences by design), in the
#: reduced configs: (arch, leaf path) -> (the widths it shows at, why)
MLSTM, SLSTM = "segments/0/p0/mixer/", "segments/1/p0/mixer/"
PARAM_DIVERGENCES = {
    ("jamba-1.5-large-398b", "segments/0/p0/mixer/x_proj"): (
        (2, 4), "row-parallel: dt, B and C read every channel"),
    ("jamba-1.5-large-398b", "segments/0/p0/mixer/dt_w"): (
        (2, 4), "its columns are the rank's channels, not its dt_rank rows"),
    ("jamba-1.5-large-398b", "segments/0/p0/mixer/D"): (
        (2, 4), "by channel (the pspec tries the repeat dim)"),
    **{("deepseek-v3-671b", f"segments/{i}/p0/mixer/{n}"): (
        (2, 4), "whole: its norm normalises the whole latent")
       for i in (0, 1) for n in ("wq_a", "wkv_a")},
    **{("xlstm-1.3b", MLSTM + n): (
        (2, 4), "mLSTM: the rank's whole heads, not the head dim")
       for n in ("wq", "wk", "wv")},
    **{("xlstm-1.3b", MLSTM + n): (
        (2, 4), "mLSTM: the rank's heads' i/f gates (whole in the pspec)")
       for n in ("w_i", "w_f", "b_i", "b_f")},
    ("xlstm-1.3b", SLSTM + "w_in"): (
        (2, 4), "sLSTM: the recurrence stays whole on every rank"),
    ("xlstm-1.3b", SLSTM + "w_up"): (
        (2,), "sLSTM FFN: 341 units a half do not divide 2 (the pspec cuts "
              "the packed 682 across the halves)"),
    **{("internvl2-1b", f"segments/0/p0/mixer/{n}"): (
        (4,), "2 KV heads at tp 4: each rank keeps its queries' head")
       for n in ("wk", "wv")},
    **{(v, f"segments/0/p0/mixer/{n}"): (
        (4,), "head-bound: 6 query heads do not divide 4, the attention "
              "stays whole (the pspec cuts the widths, which divide)")
       for v in VARIANTS for n in ("wq", "wk", "wv", "wo")},
}
#: where the rule table's per-rank state cut departs from the model axis
#: of the JAX package's ``state_pspecs``: (arch, leaf path) -> (widths,
#: why)
STATE_DIVERGENCES = {
    **{("deepseek-v3-671b", f"layers/{i}/p0/{n}"): (
        (2, 4), "the latent stays whole (the pspec cuts its lines)")
       for i in (0, 1) for n in ("c_kv", "k_rope")},
    **{("xlstm-1.3b", f"layers/0/p0/{n}"): (
        (2, 4), "mLSTM state by head (the pspec: C and n by the key dim, "
                "m whole)") for n in ("C", "n", "m")},
    **{("internvl2-1b", f"layers/0/p0/{n}"): (
        (4,), "2 KV heads at tp 4: each rank keeps its queries' head")
       for n in ("k", "v")},
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(name):
    """(JAX config, port config) of an arch or a variant's name."""
    arch = VARIANTS.get(name, name)
    cfgs = [rcfg.get_config(arch).reduced(), tcfg.get_config(arch).reduced()]
    if name in VARIANTS:
        cfgs = [W.six_heads(c) for c in cfgs]
        if cfgs[1].moe is not None:
            cfgs = [W.with_capacity(c, c.moe.num_experts / c.moe.top_k)
                    for c in cfgs]
    return tuple(cfgs)


def _tps(name):
    return (4,) if name in VARIANTS else (2, 4)


@pytest.fixture(scope="module")
def bridged():
    """Per arch or variant: (JAX config, port config, JAX params, numpy
    params)."""
    out = {}
    for name in FAMILIES + (ARCTIC,) + tuple(VARIANTS):
        cfg_r, cfg = _configs(name)
        params_r = rm.init_params(jax.random.PRNGKey(0), cfg_r)
        out[name] = (cfg_r, cfg, params_r, _np(params_r))
    return out


@pytest.fixture(scope="module")
def world(bridged):
    return spawn("_torch_mesh_worker:families", 4, device="cpu",
                 args=({"params": {a: v[3] for a, v in bridged.items()
                                   if a not in VARIANTS},
                        "variants": {v: (a, bridged[v][3])
                                     for v, a in VARIANTS.items()},
                        "tps": {ARCTIC: (2,)}, "mutate": MUTATE,
                        "head_cut": HEAD_CUT,
                        "seq_parallel": SEQ_PARALLEL},),
                 timeout=600)


@functools.lru_cache(maxsize=None)
def _one_device(arch, factor=None):
    """The port's one-device tokens and logits (the capacity factor
    replaced where given)."""
    cfg_r, cfg = _configs(arch)
    if factor is not None:
        cfg = W.with_capacity(cfg, factor)
    params = params_from_numpy(
        _np(rm.init_params(jax.random.PRNGKey(0), cfg_r)), device="cpu")
    _, tokens = W.family_generate(cfg, params, None)
    return tokens, W.family_logits(cfg, params, None)


def _ref_requests(cfg_r, n=3, steps=5):
    reqs = W.requests(cfg_r, n, steps=steps)
    return [RRequest(prompt_len=r.prompt_len, max_new_tokens=steps, rid=r.rid,
                     prompt_tokens=r.prompt_tokens) for r in reqs]


_REF = {}


def _reference(bridged, arch, tp):
    """The JAX package's sharded engine on a tp-wide slice (one device at
    tp 0): its tokens, and its prefill and dense decode logits on
    ``family_batch``, as ``_torch_mesh_worker`` computes the port's."""
    if (arch, tp) in _REF:
        return _REF[arch, tp]
    cfg_r, cfg, params_r, _ = bridged[arch]
    sl = rcarve(tp, n_instances=1)[0] if tp else None
    eng = REngine(cfg_r, params_r, num_slots=4, kv_capacity=64,
                  temperature=0.0, mesh=sl)
    reqs = _ref_requests(cfg_r)
    for r, extra in zip(reqs, W.family_extras(cfg, 3)):
        eng.prefill_request(r, extra)
    eng.decode_multi(steps=4)
    tokens = [list(map(int, r.output_tokens)) for r in reqs]
    batch = {k: jnp.asarray(v) for k, v in W.family_batch(cfg).items()}
    B = batch["tokens"].shape[0]
    p = rshard_params(cfg_r, params_r, sl) if sl is not None else params_r
    ctx = (rsharding.use_mesh(sl.mesh, batch_axes=(),
                              model_axis=sl.model_axis_for(cfg_r))
           if sl is not None else rsharding.use_mesh(None))
    t = W.family_clock(cfg)
    logits = []
    with ctx:
        out, st = jax.jit(functools.partial(rm.prefill, cfg_r))(
            p, batch, rm.init_state(cfg_r, B, 32))
        logits.append(np.asarray(out))
        step = jax.jit(functools.partial(rm.decode_step, cfg_r))
        for j in range(2):
            tok = jnp.argmax(out, -1).astype(jnp.int32)[:, None]
            out, st = step(p, tok, st, jnp.full((B,), t + j, jnp.int32))
            logits.append(np.asarray(out))
    _REF[arch, tp] = (tokens, logits)
    return _REF[arch, tp]


def _same_on_every_rank(world, arch, tp, key="tokens", run="published"):
    first = world[0][arch][run][tp][key]
    for r, out in enumerate(world):
        assert out[arch][run][tp][key] == first, \
            f"rank {r}'s {key} differ from rank 0's"
    return first


def _max_err(a, b):
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# against the JAX package's sharded engine
# ---------------------------------------------------------------------------

CASES = ([(a, tp) for a in FAMILIES for tp in (2, 4)] + [(ARCTIC, 2)]
         + [(v, 4) for v in VARIANTS])


@pytest.mark.parametrize("arch,tp", CASES)
def test_tokens_equal_reference(mesh8, bridged, world, arch, tp):
    tokens = _same_on_every_rank(world, arch, tp)
    assert tokens == _reference(bridged, arch, tp)[0]
    holds = [out[arch]["published"][tp]["holds"] for out in world]
    assert holds == [r < tp for r in range(4)]      # the rest are shadows


@pytest.mark.parametrize("arch,tp", CASES)
def test_logits_match_reference(mesh8, bridged, world, arch, tp):
    ref = _reference(bridged, arch, tp)[1]
    for r, out in enumerate(world[:tp]):
        got = out[arch]["published"][tp]["logits"]
        assert _max_err(got, ref) < TOL, (arch, tp, r)


# ---------------------------------------------------------------------------
# against one device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [a for a in FAMILIES if a not in MOE])
def test_tokens_equal_one_device(world, arch):
    tokens, logits = _one_device(arch)
    for tp in (2, 4):
        assert _same_on_every_rank(world, arch, tp) == tokens, tp
        got = world[0][arch]["published"][tp]["logits"]
        assert _max_err(got, logits) < TOL, tp


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_partial_tp_equals_one_device(world, bridged, name):
    """6 query heads at tp 4: the attention whole on every rank, the FFN
    (the experts, one a rank, and the residual FFN) and the vocab cut in
    four, and one device's tokens and logits."""
    cfg = bridged[name][1]
    assert cfg.num_heads % 4 and cfg.vocab_size % 4 == 0
    tokens, logits = _one_device(name)
    assert _same_on_every_rank(world, name, 4) == tokens
    for r, out in enumerate(world):
        got = out[name]["published"][4]
        assert _max_err(got["logits"], logits) < TOL, r
        shapes = got["params"]
        assert shapes["segments/0/p0/mixer/wq"][-1] == \
            cfg.num_heads * cfg.head_dim
        assert shapes["lm_head"][-1] == cfg.vocab_size // 4
        if cfg.moe is not None:
            assert shapes["segments/0/p0/ffn/w_up"][-3] == 1
        else:
            assert shapes["segments/0/p0/ffn/w_up"][-1] == cfg.d_ff // 4


@pytest.mark.parametrize("arch", [a for a in MOE if a != ARCTIC])
def test_moe_tokens_equal_one_device_dropless(world, bridged, arch):
    cfg = bridged[arch][1]
    tokens, logits = _one_device(arch, cfg.moe.num_experts / cfg.moe.top_k)
    assert _same_on_every_rank(world, arch, 2, run="dropless") == tokens
    got = world[0][arch]["dropless"][2]["logits"]
    assert _max_err(got, logits) < TOL


def test_published_capacity_a2a_drops_per_shard(mesh8, bridged, world):
    """At capacity factor 1.25 the ``a2a`` dispatch of a prompt whose
    length divides the slice drops assignments against each shard's
    capacity, not one device's: jamba's tp 2 tokens differ from one
    device's, in the JAX package as in the port, and the two packages
    agree on the sharded tokens."""
    arch = "jamba-1.5-large-398b"
    sharded = _same_on_every_rank(world, arch, 2)
    one, _ = _one_device(arch)
    assert sharded == _reference(bridged, arch, 2)[0]
    assert _reference(bridged, arch, 0)[0] == one
    assert sharded != one


# ---------------------------------------------------------------------------
# per-rank bytes against the JAX package's layouts
# ---------------------------------------------------------------------------


def _cut(shape, spec, tp):
    """A leaf's per-rank shape under a partition spec's model axis."""
    return tuple(n // tp if ax == "model" else n
                 for n, ax in zip(shape, tuple(spec) + (None,) * len(shape)))


def _param_shapes(cfg_r, params_r, tp):
    """{path: per-rank shape} under the JAX package's ``param_pspecs``."""
    specs = r_param_pspecs(cfg_r, params_r, mode="serve", model_n=tp)
    out = {}
    for (path, leaf), spec in zip(
            jax.tree_util.tree_flatten_with_path(params_r)[0],
            jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))):
        name = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        out[name] = _cut(leaf.shape, spec, tp)
    return out


def _state_shapes(cfg_r, tp):
    """{path: per-rank shape} of an engine state under the model axis of
    the JAX package's ``state_pspecs`` (4 slots of 64 lines)."""
    state = jax.eval_shape(lambda: rm.init_state(cfg_r, 4, 64))
    # a global batch the data axis divides: the batch stays on the data
    # axis (4 slots do not divide it), and the model axis is what remains
    specs = r_state_pspecs(cfg_r, state, RInputShape("serve", 64, 16,
                                                     "decode"),
                           long_context=False, model_n=tp)
    out = {}
    for (path, leaf), spec in zip(
            jax.tree_util.tree_flatten_with_path(state)[0],
            jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))):
        name = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        out[name] = _cut(leaf.shape, spec, tp)
    return out


def _diverging(got, want):
    return {p for p in want if got[p] != want[p]}


def _logged(table, arch, tp):
    return {p for (a, p), (tps, _) in table.items() if a == arch and tp in tps}


@pytest.mark.parametrize("arch", FAMILIES + tuple(VARIANTS))
def test_param_shapes_follow_the_pspecs_but_the_logged(bridged, world,
                                                      arch):
    cfg_r, _, params_r, _ = bridged[arch]
    for tp in _tps(arch):
        got = world[0][arch]["published"][tp]["params"]
        want = _param_shapes(cfg_r, params_r, tp)
        assert set(got) == set(want)
        assert _diverging(got, want) == _logged(PARAM_DIVERGENCES, arch, tp)


@pytest.mark.parametrize("arch,path", sorted(PARAM_DIVERGENCES))
def test_param_divergence_by_design(bridged, world, arch, path):
    cfg_r, _, params_r, _ = bridged[arch]
    for tp in PARAM_DIVERGENCES[arch, path][0]:
        got = world[0][arch]["published"][tp]["params"][path]
        assert got != _param_shapes(cfg_r, params_r, tp)[path], tp


@pytest.mark.parametrize("arch", FAMILIES + tuple(VARIANTS))
def test_state_shapes_follow_the_pspecs_but_the_logged(bridged, world, arch):
    cfg_r = bridged[arch][0]
    for tp in _tps(arch):
        got = world[0][arch]["published"][tp]["state"]
        want = _state_shapes(cfg_r, tp)
        assert set(got) == set(want)
        assert _diverging(got, want) == _logged(STATE_DIVERGENCES, arch, tp)
        for r, out in enumerate(world):
            mine = out[arch]["published"][tp]["state"]
            assert mine == (got if r < tp else {}), (tp, r)


@pytest.mark.parametrize("arch,path", sorted(STATE_DIVERGENCES))
def test_state_divergence_by_design(bridged, world, arch, path):
    cfg_r = bridged[arch][0]
    for tp in STATE_DIVERGENCES[arch, path][0]:
        got = world[0][arch]["published"][tp]["state"][path]
        assert got != _state_shapes(cfg_r, tp)[path], tp


# ---------------------------------------------------------------------------
# the mutation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(MUTATE))
def test_contiguous_cut_of_a_packed_leaf_fails(world, case):
    out = world[0]["mutated"][case]
    kept = _max_err(out["kept"][2]["logits"], out["one"])
    wrong = _max_err(out["mutated"][2]["logits"], out["one"])
    assert kept < TOL, kept
    assert wrong > 100 * TOL, wrong


def test_contiguous_cut_of_a_head_bound_leaf_fails(world):
    """2 heads at tp 4: the rule table keeps the mLSTM whole (its heads do
    not divide) and gives one device's logits and tokens; cutting every
    mLSTM leaf in contiguous blocks of ``d_in / 4`` channels, as a rule
    that checks the width alone would (512 divides 4), splits each head
    in two and gives logits far off one device's."""
    for r, out in enumerate(world):
        case = out["head_cut"]
        kept = case["kept"]
        assert kept["params"]["segments/0/p0/mixer/w_up"][-1] == 512
        assert kept["params"]["embed"][0] == 512 // 4     # vocab cut
        assert kept["tokens"] == case["one_tokens"], r
        assert _max_err(kept["logits"], case["one"]) < TOL, r
        wrong = _max_err(case["split"], case["one"])
        assert wrong > 100 * TOL, (r, wrong)


# ---------------------------------------------------------------------------
# the store's recorded cut, and the pull planned from it
# ---------------------------------------------------------------------------


def _state_leaves(state):
    for i, layer in enumerate(state["layers"]):
        for pj, part in layer.items():
            for key, leaf in part.items():
                yield (i, pj, key), leaf


@pytest.mark.parametrize("tp", (2, 4))
@pytest.mark.parametrize("arch", FAMILIES)
def test_store_cut_is_the_recorded_layout(arch, tp):
    """Each rank's part of a sharded store is the whole leaf at the
    indices ``store.holders.cuts`` records for that rank (what a pull
    between slices plans from), the ranks' indices cover the whole dim,
    and every leaf not recorded stays whole."""
    import torch
    from repro_torch.kvstore import PagedStore
    from repro_torch.meshserve.pool import shard_store
    from repro_torch.meshserve.topology import MeshSlice
    cfg = tcfg.get_config(arch).reduced()
    gen = torch.Generator().manual_seed(0)
    whole = PagedStore(cfg, 2, 32, block_lines=16, device="cpu")
    for _, leaf in _state_leaves(whole.state):
        leaf.copy_(torch.randn(leaf.shape, generator=gen).to(leaf.dtype))
    leaves = dict(_state_leaves(whole.state))
    for r in range(tp):
        store = PagedStore(cfg, 2, 32, block_lines=16, device="cpu")
        for path, leaf in _state_leaves(store.state):
            leaf.copy_(leaves[path])
        shard_store(store, MeshSlice(index=0, ranks=tuple(range(tp)),
                                     device=torch.device("cpu"), rank=r))
        cuts = store.holders.cuts
        for path, part in _state_leaves(store.state):
            if path not in cuts:
                assert torch.equal(part, leaves[path]), path
                continue
            dim, layout = cuts[path]
            assert sorted(set().union(*map(set, layout))) == list(
                range(leaves[path].shape[dim])), path
            assert torch.equal(part, leaves[path].index_select(
                dim, torch.as_tensor(list(layout[r])))), path
    # deepseek's latent stays whole; every other family cuts its state
    assert bool(cuts) == (arch != "deepseek-v3-671b")


def test_pull_plan_fills_every_index_from_its_holder():
    """Two ranks of a channel-blocked leaf pull into two others: a cut
    from a cut goes block to block; a whole destination takes each index
    from the source rank holding it; a cut from a whole source takes its
    block from the source's first rank, as do the whole leaves."""
    from repro_torch.meshserve.collectives import _plan
    blocks = (range(0, 4), range(4, 8))
    same, gather, scatter = (blocks, blocks), (None, blocks), (blocks, None)
    moves = {(s, d): (pos, whole) for s, d, pos, whole in _plan(
        (2, 3), (0, 1), (same, gather, scatter))}
    assert sorted(moves) == [(0, 2), (0, 3), (1, 2), (1, 3)]
    first = list(range(4))
    assert moves[0, 2] == ({same: (first, first), gather: (first, first),
                            scatter: (first, first)}, True)
    assert moves[1, 2] == ({gather: ([4, 5, 6, 7], first)}, False)
    assert moves[0, 3] == ({gather: (first, first),
                            scatter: (first, [4, 5, 6, 7])}, True)
    assert moves[1, 3] == ({same: (first, first),
                            gather: ([4, 5, 6, 7], first)}, False)


# ---------------------------------------------------------------------------
# sequence parallelism (REPRO_SEQ_PARALLEL=1)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SEQ_PARALLEL))
def test_seq_parallel_prefill_matches_flag_off(world, name):
    """Each holding rank's logits under the flag within 1e-5 of the
    flag-off max|logit|, its caches equal, and the residual's sequence
    cut on the wire: reduce-scatters and all-gathers where the flag-off
    run had none (shadows run nothing)."""
    cfg = _configs(SEQ_PARALLEL[name][0])[1]
    paths = ({"prefill"} if cfg.is_encoder_decoder
             else {"prefill", "prefill_batched"})
    for out in world[:2]:
        runs = out["seq_parallel"][name]
        assert set(runs) == paths
        for path, run in runs.items():
            scale = float(np.abs(run["off"]).max())
            err = float(np.abs(run["on"] - run["off"]).max())
            assert err <= 1e-5 * scale, (path, err, scale)
            assert run["caches_equal"], path
            off, on = ({k for k, _, _ in calls} for calls in run["calls"])
            assert "reduce-scatter" in on and "all-gather" in on, path
            assert "reduce-scatter" not in off, path
    assert all(out["seq_parallel"][name] is None for out in world[2:])
