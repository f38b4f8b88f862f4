"""The sharded train step (TP on "model", FSDP on "data") held against one
device and against the JAX package's sharded ``train_step`` on the CPU.

The port's side runs in one gloo world of 4 CPU processes, a (data 2,
model 2) mesh (``_torch_train_worker.families``, which imports no JAX);
the references run in this process.  Reduced f32 configs with the JAX
package's random weights bridged through numpy, the training data
pipeline (B = 2, S = 16) and each family's numpy-seeded payload:

* against the port's one-device step, for GQA (starcoder2-3b), Mamba and
  MoE (jamba), MLA and MoE (deepseek-v3), xLSTM, encoder-decoder
  (seamless-m4t) and vision (internvl2): each rank's part of the first
  batch's gradients, of the params after 3 AdamW steps and of the
  moments, within 1e-4 of the whole leaf's max|·| of the one-device
  result cut the same way (the parts cover every leaf, so this is the
  gathered comparison); the step losses within 1e-5 and the clipping
  norm within 1e-4.  The MoE configs run dropless through the ``psum`` dispatch,
  whose aux loss is the mean of the data ranks' (the JAX package's
  ``pmean``): their one-device reference accumulates the two data
  ranks' batches, as one device runs the global batch in two halves;
* against the JAX package's ``train_step`` jitted with
  ``param_pspecs(mode="train", model_n=2)`` shardings on a 2 x 2 mesh of
  the forced CPU devices, for starcoder2-3b and for jamba at its
  published capacity factor 1.25 through the auto (``a2a``) dispatch,
  which drops per shard as the JAX package's does;
* tensor parallelism past whole heads: reduced minicpm-2b with 3 query
  heads and 1 KV head, which do not divide the model width 2, keeps its
  attention whole on both model ranks and cuts its FFN and vocab on
  "model"; against one device and against the JAX package's sharded
  ``train_step`` as above;
* ``global_norm`` on the parts equal to one device's;
* the collectives the dry run's recording mesh writes for jamba's step
  equal, kind by kind, in bytes and in group size, those the world
  issued (``tests/test_torch_dryrun.py`` holds the recorder's side);
* the no-mesh step bitwise equal to the whole-tree step it was (a copy
  kept here), and a rank's part of a sharded tree refused by the
  one-device step;
* sequence parallelism (``REPRO_SEQ_PARALLEL=1`` set in the ranks, in
  the same world): starcoder2-3b, jamba (``psum``) and minicpm-3h give
  each rank the flag-off grads, params and moments within 1e-4 of each
  leaf's max|·| and the losses within 1e-5; gqa-ref and moe-ref (``a2a``)
  match the JAX package's ``train_step`` jitted anew under the flag; and
  the recording mesh's collectives under the flag equal the world's.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import repro.configs as rcfg
import repro.models as rm
import repro.training as rtr
from repro import sharding as rsharding
from repro.launch.specs import param_pspecs as r_param_pspecs
from repro_torch.bridge import params_from_numpy
from repro_torch.meshserve.world import spawn
from repro_torch.models import init_params
from repro_torch.training import adamw_update, init_opt_state, train_step
from repro_torch.training.fsdp import TrainMesh, plan, shard
from repro_torch.training.optimizer import OptState, global_norm
from repro_torch.training.train_step import grads_of
import _torch_train_worker as W

TOL = 1e-4
B, S = 2, 16
#: name -> (arch, capacity override, MoE strategy)
ONE_DEVICE = {
    "starcoder2-3b": ("starcoder2-3b", None, None),
    "jamba": ("jamba-1.5-large-398b", "dropless", "psum"),
    "deepseek": ("deepseek-v3-671b", "dropless", "psum"),
    "xlstm": ("xlstm-1.3b", None, None),
    "seamless": ("seamless-m4t-large-v2", None, None),
    "internvl": ("internvl2-1b", None, None),
    "minicpm-3h": ("minicpm-2b", None, None),
}
#: name -> arch, against the JAX package's sharded step (published
#: capacity, auto dispatch)
REFERENCE = {"gqa-ref": "starcoder2-3b", "moe-ref": "jamba-1.5-large-398b",
             "minicpm-3h-ref": "minicpm-2b"}
COUNTED = "moe-ref"
#: the runs repeated with ``REPRO_SEQ_PARALLEL=1`` (as ``name + SP``):
#: against their flag-off runs, and against the JAX package's sharded
#: step under the flag
SP = "/sp"
SEQ = ("starcoder2-3b", "jamba", "minicpm-3h")
SEQ_REFERENCE = ("gqa-ref", "moe-ref")
#: name -> head counts replacing the reduced config's: 3 query heads and
#: 1 KV head do not divide the model width 2
HEADS = {"minicpm-3h": {"num_heads": 3, "num_kv_heads": 1},
         "minicpm-3h-ref": {"num_heads": 3, "num_kv_heads": 1}}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _extras(cfg, rng):
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        return {"patch_embeds": rng.standard_normal(
            (B, cfg.frontend.num_prefix_tokens, cfg.frontend.embed_dim),
            dtype=np.float32)}
    if cfg.is_encoder_decoder:
        return {"frames": rng.standard_normal(
            (B, cfg.encoder.max_source_positions, cfg.frontend.embed_dim),
            dtype=np.float32)}
    return {}


def _batches(cfg, n=3):
    gen = rtr.batches(rtr.DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                     global_batch=B, seed=1))
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        b = next(gen)
        out.append({"tokens": b[:, :-1], "labels": b[:, 1:],
                    **_extras(cfg, rng)})
    return out


def _ref_config(arch, name=None):
    """The JAX package's reduced config, with ``name``'s head counts."""
    cfg_r = rcfg.get_config(arch).reduced()
    return dataclasses.replace(cfg_r, **HEADS.get(name, {}))


@functools.lru_cache(maxsize=None)
def _weights(arch, name=None):
    return _np(rm.init_params(jax.random.PRNGKey(0),
                              _ref_config(arch, name)))


def _payloads():
    out = {}
    for name, (arch, cap, strategy) in ONE_DEVICE.items():
        out[name] = {"arch": arch, "capacity": cap, "strategy": strategy,
                     "heads": HEADS.get(name),
                     "params": _weights(arch, name),
                     "batches": _batches(W.config(arch, None,
                                                  HEADS.get(name)))}
    for name, arch in REFERENCE.items():
        out[name] = {"arch": arch, "params": _weights(arch, name),
                     "heads": HEADS.get(name),
                     "batches": _batches(W.config(arch, None,
                                                  HEADS.get(name))),
                     "count": name == COUNTED}
    for name in SEQ + SEQ_REFERENCE:
        out[name + SP] = dict(out[name], seq=True)
    return out


@pytest.fixture(scope="module")
def world():
    ranks = spawn("_torch_train_worker:families", 4, device="cpu",
                  args=(_payloads(),), timeout=900)
    return ranks


# ---------------------------------------------------------------------------
# references
# ---------------------------------------------------------------------------


def _th(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _halves(b):
    return [{k: v[i:i + 1] for k, v in b.items()} for i in range(B)]


def _one_grads(cfg, params, batch, accumulate):
    if not accumulate:
        return grads_of(cfg, params, batch)
    parts = [grads_of(cfg, params, h) for h in _halves(batch)]
    loss = sum(p[0] for p in parts) / len(parts)
    grads = jax.tree_util.tree_map(lambda *g: sum(g) / len(g),
                                   *[p[2] for p in parts])
    return loss, None, grads


@functools.lru_cache(maxsize=None)
def _one_device(name):
    """The port's one-device run: the first batch's grads, then 3 steps
    (grads accumulated over the data ranks' halves for the MoE psum
    configs)."""
    arch, cap, strategy = ONE_DEVICE[name]
    cfg = W.config(arch, cap, HEADS.get(name))
    params = params_from_numpy(_weights(arch, name), device="cpu")
    batches = [_th(b) for b in _batches(cfg)]
    acc = strategy == "psum"
    _, _, grads = _one_grads(cfg, params, batches[0], acc)
    out = {"grads": grads, "grad_norm": float(global_norm(grads)),
           "losses": [], "norms": []}
    opt = init_opt_state(W.OPT, params)
    for i, b in enumerate(batches):
        loss, _, g = _one_grads(cfg, params, b, acc)
        params, opt, gnorm = adamw_update(W.OPT, params, g, opt, W.LR[i])
        out["losses"].append(float(loss))
        out["norms"].append(float(gnorm))
    out["params"], out["moments"] = params, {"m": opt.m, "v": opt.v}
    return cfg, out


def _named(mesh, specs):
    return jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s), specs,
                                  is_leaf=lambda s: isinstance(s, P))


@functools.lru_cache(maxsize=None)
def _reference(name, seq=False):
    """The JAX package's sharded run on a (data 2, model 2) mesh of the
    forced CPU devices: the first batch's grads, then 3 steps; with
    ``seq`` jitted under ``REPRO_SEQ_PARALLEL=1``."""
    with W.seq_parallel(seq):
        return _reference_run(name)


def _reference_run(name):
    arch = REFERENCE[name]
    cfg_r = _ref_config(arch, name)
    params = jax.tree_util.tree_map(jnp.asarray, _weights(arch, name))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    p_specs = r_param_pspecs(cfg_r, params, mode="train", model_n=2)
    opt_cfg = rtr.AdamWConfig(lr=W.OPT.lr, weight_decay=W.OPT.weight_decay,
                              grad_clip=W.OPT.grad_clip)
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in _batches(W.config(arch, None, HEADS.get(name)))]
    b_specs = {k: P("data", *([None] * (v.ndim - 1)))
               for k, v in batches[0].items()}
    with rsharding.use_mesh(mesh):
        params = jax.device_put(params, _named(mesh, p_specs))
        grad_fn = jax.jit(
            jax.grad(lambda p, b: rtr.loss_fn(cfg_r, p, b)[0]),
            in_shardings=(_named(mesh, p_specs), _named(mesh, b_specs)))
        grads = grad_fn(params, batches[0])
        opt = rtr.init_opt_state(opt_cfg, params)
        opt_specs = rtr.OptState(step=P(), m=p_specs, v=p_specs)
        step = jax.jit(
            lambda p, o, b, lr: rtr.train_step(cfg_r, opt_cfg, p, o, b, lr),
            in_shardings=(_named(mesh, p_specs), _named(mesh, opt_specs),
                          _named(mesh, b_specs), NamedSharding(mesh, P())),
            out_shardings=(_named(mesh, p_specs), _named(mesh, opt_specs),
                           None))
        losses = []
        for i, b in enumerate(batches):
            params, opt, metrics = step(params, opt, b,
                                        jnp.float32(W.LR[i]))
            losses.append(float(metrics["loss"]))
    return {"grads": _np(grads), "params": _np(params), "losses": losses,
            "moments": {"m": _np(opt.m), "v": _np(opt.v)}}


# ---------------------------------------------------------------------------
# comparison of the ranks' parts
# ---------------------------------------------------------------------------


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _torch_tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _meta(cfg):
    return init_params(cfg, torch.Generator().manual_seed(0), device="meta")


def _parts_close(cfg, ranks, key, whole, tol=TOL):
    """Each rank's part of ``key`` against ``whole`` cut by the rank's
    plan, within ``tol`` of the whole leaf's max|·|."""
    if not isinstance(next(iter(_leaves(whole)))[1], torch.Tensor):
        whole = _torch_tree(whole)
    if key == "moments":
        scale = {p: max(float(np.abs(_f32(x)).max(initial=0.0)), 1e-30)
                 for part in ("m", "v")
                 for p, x in _leaves(whole[part], f"/{part}")}
    else:
        scale = {p: max(float(np.abs(_f32(x)).max(initial=0.0)), 1e-30)
                 for p, x in _leaves(whole)}
    meta = _meta(cfg)
    for r in ranks:
        d, m = r["cut"]
        mesh = TrainMesh(2, 2, d, m)
        cuts = plan(cfg, meta, mesh)
        if key == "moments":
            want = {part: shard(whole[part], cuts, mesh) for part in
                    ("m", "v")}
        else:
            want = shard(whole, cuts, mesh)
        got = dict(_leaves(r[key]))
        want = dict(_leaves(want))
        assert got.keys() == want.keys()
        for p in want:
            x, y = _f32(got[p]), _f32(want[p])
            assert x.shape == y.shape, (r["rank"], p)
            err = float(np.abs(x - y).max(initial=0.0))
            assert err <= tol * scale[p], (key, r["rank"], p, err, scale[p])


@pytest.mark.parametrize("name", list(ONE_DEVICE))
def test_grads_match_one_device(world, name):
    cfg, one = _one_device(name)
    ranks = [w[name] for w in world]
    _parts_close(cfg, ranks, "grads", one["grads"])
    for r in ranks:
        assert abs(r["grad_norm"] - one["grad_norm"]) <= 1e-4 * one[
            "grad_norm"]


@pytest.mark.parametrize("name", list(ONE_DEVICE))
def test_three_steps_match_one_device(world, name):
    cfg, one = _one_device(name)
    ranks = [w[name] for w in world]
    _parts_close(cfg, ranks, "params", one["params"])
    _parts_close(cfg, ranks, "moments", one["moments"])
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-5)
        np.testing.assert_allclose(r["norms"], one["norms"], rtol=1e-4)


@pytest.mark.parametrize("name", list(REFERENCE))
def test_matches_reference_sharded_step(world, name):
    cfg = W.config(REFERENCE[name], None, HEADS.get(name))
    ref = _reference(name)
    ranks = [w[name] for w in world]
    _parts_close(cfg, ranks, "grads", ref["grads"])
    _parts_close(cfg, ranks, "params", ref["params"])
    _parts_close(cfg, ranks, "moments", ref["moments"])
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-5)


def test_ranks_hold_their_cut_only(world):
    """Each rank's params and moments hold a quarter of the cut leaves'
    bytes; the whole tree is never kept."""
    cfg, one = _one_device("starcoder2-3b")
    whole = sum(_f32(x).nbytes for _, x in _leaves(one["params"]))
    for w in world:
        part = sum(x.nbytes for _, x in _leaves(w["starcoder2-3b"]["params"]))
        moments = sum(x.nbytes for _, x in
                      _leaves(w["starcoder2-3b"]["moments"]))
        assert part < 0.3 * whole
        assert moments == 2 * part


def test_partial_tp_cuts_ffn_and_vocab_only(world):
    """3 query heads on a model width of 2: each rank keeps the attention
    whole on "model" (its "data" cut aside) and a half of the FFN and of
    the vocab."""
    cfg, _ = _one_device("minicpm-3h")
    assert cfg.num_heads % 2 and cfg.tie_embeddings
    cuts = plan(cfg, _meta(cfg), TrainMesh(2, 2, 0, 1))
    layer = cuts["segments"][0]["p0"]
    for key in ("wq", "wk", "wv", "wo"):
        assert layer["mixer"][key].model is None, key
    for key in ("w_gate", "w_up", "w_down"):
        assert layer["ffn"][key].model is not None, key
    assert cuts["embed"].model == (0, tuple(range(cfg.vocab_size // 2,
                                                  cfg.vocab_size)))
    for w in world:
        got = dict(_leaves(w["minicpm-3h"]["params"]))
        data = 2 if cuts["embed"].data is not None else 1
        assert got["/embed"].shape == (cfg.vocab_size // 2,
                                       cfg.d_model // data)
        assert got["/segments/0/p0/ffn/w_up"].shape[-1] in (
            cfg.d_ff // 2, cfg.d_ff // 4)
        wq = got["/segments/0/p0/mixer/wq"].shape
        assert wq[-1] == cfg.num_heads * cfg.head_dim


# ---------------------------------------------------------------------------
# global norm, the no-mesh step
# ---------------------------------------------------------------------------


def test_global_norm_counts_each_element_once(world):
    for name in ONE_DEVICE:
        _, one = _one_device(name)
        for w in world:
            assert w[name]["grad_norm"] == pytest.approx(one["grad_norm"],
                                                         rel=1e-4), name


def _whole_tree_step(cfg, opt_cfg, params, opt_state, batch, lr_scale):
    """The one-device train step before the sharded one existed: the
    whole-tree norm and update, kept as the reference."""
    from torch.utils._pytree import tree_flatten, tree_unflatten
    loss, metrics, grads = grads_of(cfg, params, batch)
    leaves = tree_flatten(grads)[0]
    gnorm = torch.linalg.vector_norm(torch.stack([
        torch.linalg.vector_norm(x, dtype=torch.float32) for x in leaves]))
    clip = torch.clamp(opt_cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = opt_state.step + 1
    b1c = 1.0 - opt_cfg.b1 ** step.float()
    b2c = 1.0 - opt_cfg.b2 ** step.float()
    lr = opt_cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32)
    flat_p, spec = tree_flatten(params)
    outs = []
    for p, g, m, v in zip(flat_p, tree_flatten(grads)[0],
                          tree_flatten(opt_state.m)[0],
                          tree_flatten(opt_state.v)[0]):
        g = g.float() * clip
        m32 = m.float() * opt_cfg.b1 + g * (1 - opt_cfg.b1)
        v32 = v.float() * opt_cfg.b2 + torch.square(g) * (1 - opt_cfg.b2)
        update = (m32 / b1c) / (torch.sqrt(v32 / b2c) + opt_cfg.eps)
        if p.dim() >= 2:
            update = update + opt_cfg.weight_decay * p.float()
        outs.append(((p.float() - lr * update).to(p.dtype),
                     m32.to(m.dtype), v32.to(v.dtype)))
    new = [tree_unflatten([o[i] for o in outs], spec) for i in range(3)]
    return new[0], OptState(step, new[1], new[2]), dict(
        metrics, loss=loss, grad_norm=gnorm)


@pytest.mark.parametrize("arch", ["minicpm-2b", "jamba-1.5-large-398b"])
def test_no_mesh_step_is_the_whole_tree_step_bitwise(arch):
    cfg = W.config(arch)
    params = params_from_numpy(_weights(arch), device="cpu")
    opt = init_opt_state(W.OPT, params)
    a = (params, opt)
    b = (params, opt)
    for i, batch in enumerate(_batches(cfg, 2)):
        batch = _th(batch)
        pa, oa, ma = train_step(cfg, W.OPT, *a, batch, W.LR[i])
        pb, ob, mb = _whole_tree_step(cfg, W.OPT, *b, batch, W.LR[i])
        for (_, x), (_, y) in zip(_leaves((pa, oa.m, oa.v)),
                                  _leaves((pb, ob.m, ob.v))):
            assert torch.equal(x, y)
        assert torch.equal(ma["loss"], mb["loss"])
        assert torch.equal(ma["grad_norm"], mb["grad_norm"])
        a, b = (pa, oa), (pb, ob)


def test_sharded_tree_without_mesh_raises():
    cfg = W.config("starcoder2-3b")
    params = params_from_numpy(_weights("starcoder2-3b"), device="cpu")
    mesh = TrainMesh(2, 2, 0, 1)
    part = shard(params, plan(cfg, _meta(cfg), mesh), mesh)
    batch = _th(_batches(cfg, 1)[0])
    with pytest.raises(RuntimeError, match="not the whole model"):
        train_step(cfg, W.OPT, part, init_opt_state(W.OPT, part), batch, 1.0)
    # a TP part alone (no data cut) raises at its first collective
    tp_only = TrainMesh(1, 2, 0, 1)
    part = shard(params, plan(cfg, _meta(cfg), tp_only), tp_only)
    with pytest.raises(RuntimeError, match="no mesh installed"):
        grads_of(cfg, part, batch)


# ---------------------------------------------------------------------------
# the recording mesh against the world
# ---------------------------------------------------------------------------


def test_recorded_collectives_equal_the_worlds(world):
    from repro_torch.launch.dryrun import rank_program
    cfg = W.config(REFERENCE[COUNTED])
    calls = {}
    for w in world:
        for key, n in w[COUNTED]["calls"].items():
            calls.setdefault(w[COUNTED]["rank"], {})[key] = n
    batch = {k: torch.from_numpy(np.array(v)) for k, v in
             _batches(cfg, 1)[0].items()}
    recorded = rank_program(cfg, batch, data=2, model=2, opt_cfg=W.OPT)
    want = {k: int(v) for k, v in recorded["collectives"].items()}
    assert any(k[0] == "all-to-all" for k in want)
    assert any(k[0] == "reduce-scatter" for k in want)
    for rank, got in calls.items():
        assert got == want, rank


# ---------------------------------------------------------------------------
# sequence parallelism (REPRO_SEQ_PARALLEL=1)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", SEQ)
def test_seq_parallel_matches_flag_off(world, name):
    """Each rank's grads, params after 3 steps and moments under the flag
    within 1e-4 of the same rank's flag-off parts (of each leaf's
    max|·|), its losses within 1e-5 and its clipping norms within 1e-4."""
    for w in world:
        off, on = w[name], w[name + SP]
        for key in ("grads", "params", "moments"):
            got, want = dict(_leaves(on[key])), dict(_leaves(off[key]))
            assert got.keys() == want.keys()
            for p in want:
                scale = max(float(np.abs(want[p]).max(initial=0.0)), 1e-30)
                err = float(np.abs(got[p] - want[p]).max(initial=0.0))
                assert err <= TOL * scale, (key, w[name]["rank"], p, err)
        np.testing.assert_allclose(on["losses"], off["losses"], rtol=1e-5)
        np.testing.assert_allclose(on["norms"], off["norms"], rtol=1e-4)


@pytest.mark.parametrize("name", SEQ_REFERENCE)
def test_seq_parallel_matches_reference_sharded_step(world, name):
    """The flag-on step against the JAX package's ``train_step`` jitted
    under ``REPRO_SEQ_PARALLEL=1`` on the forced 2 x 2 mesh."""
    cfg = W.config(REFERENCE[name], None, HEADS.get(name))
    ref = _reference(name, seq=True)
    ranks = [w[name + SP] for w in world]
    _parts_close(cfg, ranks, "grads", ref["grads"])
    _parts_close(cfg, ranks, "params", ref["params"])
    _parts_close(cfg, ranks, "moments", ref["moments"])
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-5)


def test_seq_parallel_recorded_collectives_equal_the_worlds(world,
                                                            monkeypatch):
    """Under the flag the recording mesh's collectives for jamba's step
    equal the world's, kind by kind, in bytes and in group size; and the
    world's boundary all-reduces became reduce-scatters and all-gathers."""
    from repro_torch.launch.dryrun import rank_program
    cfg = W.config(REFERENCE[COUNTED])
    batch = {k: torch.from_numpy(np.array(v)) for k, v in
             _batches(cfg, 1)[0].items()}
    monkeypatch.setenv("REPRO_SEQ_PARALLEL", "1")
    recorded = rank_program(cfg, batch, data=2, model=2, opt_cfg=W.OPT)
    want = {k: int(v) for k, v in recorded["collectives"].items()}

    def calls(tag, kind):
        return sum(n for (k, _, _), n in tag.items() if k == kind)

    for w in world:
        got, off = w[COUNTED + SP]["calls"], w[COUNTED]["calls"]
        assert got == want, w[COUNTED]["rank"]
        assert calls(got, "all-reduce") < calls(off, "all-reduce")
        assert calls(got, "reduce-scatter") > calls(off, "reduce-scatter")
        assert calls(got, "all-gather") > calls(off, "all-gather")
