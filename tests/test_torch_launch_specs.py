"""The port's partition-spec rules held against the JAX package's.

Every architecture of the registries at its published widths: the port
builds its parameter tree on the meta device, the JAX package through
``jax.eval_shape``, and both trees must have the same leaves at the same
paths with the same shapes.  ``param_pspecs`` must then give every leaf
the same spec, compared as strings, in both modes ("serve", "train"),
both layouts ("tp", "fsdp") and at ``model_n`` 16, 4 and 2 (a mesh
slice's width).  ``pick_layout`` follows ``REPRO_LAYOUT`` as the JAX
package's does.  ``INPUT_SHAPES`` field by field; ``token_layout`` and
``input_specs`` (shapes, dtypes, specs) for every arch x shape x mesh x
layout; the serving state at full width (the port's on meta, the JAX
package's through ``jax.eval_shape``) leaf by leaf, and ``state_pspecs``
on it for every arch x serving shape x mesh.  ``launch.mesh``'s plain
description against the JAX package's mesh shapes.
"""
import dataclasses
from types import SimpleNamespace

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.configs as rcfg
import repro.models as rm
from repro.launch import mesh as rmesh
from repro.launch import specs as rspecs
import repro_torch.configs as tcfg
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.models import init_params, init_state

#: the JAX package's ``list_archs()`` (its ten assigned architectures)
#: and the paper's evaluation model, which both registries also hold
ARCHS = tcfg.list_archs(include_extra=True)


def test_registries_agree():
    assert rcfg.list_archs() + ["llama2-70b"] == ARCHS
    assert tcfg.list_archs() == rcfg.list_archs()
    assert tcfg.ASSIGNED_ARCHS == rcfg.ASSIGNED_ARCHS
    assert rcfg.list_archs(include_extra=True) == ARCHS
    assert rcfg.get_config("llama2-70b").name == "llama2-70b"


@pytest.mark.parametrize("name", list(rcfg.INPUT_SHAPES))
def test_get_shape_equals_reference(name):
    r, t = rcfg.get_shape(name), tcfg.get_shape(name)
    assert t is tcfg.INPUT_SHAPES[name]
    assert dataclasses.asdict(t) == dataclasses.asdict(r)


@pytest.fixture(scope="module")
def trees():
    """arch -> (ref config, port config, ref shape tree, port meta tree),
    built once per arch."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg_r, cfg = rcfg.get_config(arch), tcfg.get_config(arch)
            ref = jax.eval_shape(lambda k: rm.init_params(k, cfg_r),
                                 jax.random.PRNGKey(0))
            port = init_params(cfg, torch.Generator().manual_seed(0),
                               device="meta")
            cache[arch] = (cfg_r, cfg, ref, port)
        return cache[arch]

    return get


def _ref_flat(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {rspecs._path_str(path): leaf for path, leaf in flat}


def _fold(spec):
    """A spec as ``PartitionSpec`` writes it: a one-name tuple of axes
    folds into the name (``("data",)`` is ``"data"``)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def _port_flat(tree):
    out = {}
    tspecs.map_with_path(lambda ps, leaf: out.__setitem__(ps, leaf), tree)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_trees_agree(trees, arch):
    _, _, ref, port = trees(arch)
    ref_flat, port_flat = _ref_flat(ref), _port_flat(port)
    assert sorted(ref_flat) == sorted(port_flat)
    for ps, leaf in port_flat.items():
        assert leaf.is_meta
        assert tuple(leaf.shape) == tuple(ref_flat[ps].shape), ps


@pytest.mark.parametrize("model_n", [16, 4, 2])
@pytest.mark.parametrize("layout", ["tp", "fsdp"])
@pytest.mark.parametrize("mode", ["serve", "train"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_reference(trees, arch, mode, layout, model_n):
    cfg_r, cfg, ref, port = trees(arch)
    want = _ref_flat(rspecs.param_pspecs(cfg_r, ref, mode=mode, layout=layout,
                                         model_n=model_n),
                     is_leaf=lambda x: isinstance(x, P))
    got = _port_flat(tspecs.param_pspecs(cfg, port, mode=mode, layout=layout,
                                         model_n=model_n))
    assert sorted(got) == sorted(want)
    bad = {ps: (str(tuple(want[ps])), str(_fold(got[ps]))) for ps in got
           if str(tuple(want[ps])) != str(_fold(got[ps]))}
    assert not bad, bad
    # every cut on the model axis divides its dim
    leaves = _port_flat(port)
    for ps, spec in got.items():
        for dim, ax in enumerate(spec):
            if ax == "model":
                assert leaves[ps].shape[dim] % model_n == 0, (ps, spec)


@pytest.mark.parametrize("env", [None, "fsdp", "tp"])
def test_pick_layout_follows_repro_layout(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("REPRO_LAYOUT", raising=False)
    else:
        monkeypatch.setenv("REPRO_LAYOUT", env)
    seen = set()
    for arch in ARCHS:
        for shape in rcfg.INPUT_SHAPES.values():
            want = rspecs.pick_layout(rcfg.get_config(arch), shape)
            got = tspecs.pick_layout(tcfg.get_config(arch),
                                     SimpleNamespace(kind=shape.kind))
            assert got == want, (arch, shape.kind)
            seen.add(got)
    assert seen == ({"tp", "fsdp"} if env == "fsdp" else {"tp"})


@pytest.mark.parametrize("name", ["token_layout", "input_specs",
                                  "state_pspecs"])
def test_input_and_state_specs_wait_for_the_dry_run(name):
    """The three specs that waited for the dry-run slice now answer (the
    comparisons with the JAX package are below)."""
    cfg, shape = tcfg.get_config("starcoder2-3b"), tcfg.INPUT_SHAPES[
        "decode_32k"]
    if name == "state_pspecs":
        state = init_state(cfg, shape.global_batch, shape.seq_len,
                           device="meta")
        out = tspecs.state_pspecs(cfg, state, shape, long_context=False)
        assert _port_flat(out)["layers/0/p0/k"] == (None, ("data",), None,
                                                    None, None)
    else:
        out = getattr(tspecs, name)(cfg, shape)
        assert out


def test_input_shapes_match_reference():
    assert list(tcfg.INPUT_SHAPES) == list(rcfg.INPUT_SHAPES)
    for name, want in rcfg.INPUT_SHAPES.items():
        got = tcfg.INPUT_SHAPES[name]
        assert isinstance(got, tcfg.InputShape)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_matches_reference(multi_pod):
    mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    assert mesh.axis_names == axes and mesh.axis_sizes == shape
    assert mesh.shape == dict(zip(axes, shape))
    assert mesh.size == (512 if multi_pod else 256)
    assert mesh.tag == ("2x16x16" if multi_pod else "16x16")
    assert tmesh.batch_axes(multi_pod) == rmesh.batch_axes(multi_pod)


_DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("layout", ["tp", "fsdp"])
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", list(rcfg.INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape, multi_pod, layout):
    cfg_r, cfg = rcfg.get_config(arch), tcfg.get_config(arch)
    shp_r, shp = rcfg.INPUT_SHAPES[shape], tcfg.INPUT_SHAPES[shape]
    assert tspecs.token_layout(cfg, shp) == rspecs.token_layout(cfg_r, shp_r)
    sds_r, specs_r = rspecs.input_specs(cfg_r, shp_r, multi_pod,
                                        layout=layout)
    sds, specs = tspecs.input_specs(cfg, shp, multi_pod, layout=layout)
    assert list(sds) == list(sds_r) and list(specs) == list(specs_r)
    for key, want in sds_r.items():
        got = sds[key]
        assert got.is_meta
        assert tuple(got.shape) == want.shape, key
        assert got.dtype == _DTYPES[str(want.dtype)], key
        assert str(_fold(specs[key])) == str(tuple(specs_r[key])), key


@pytest.fixture(scope="module")
def states():
    """(arch, shape) -> (ref state shape tree, port meta state)."""
    cache = {}

    def get(arch, shape):
        if (arch, shape) not in cache:
            cfg_r, cfg = rcfg.get_config(arch), tcfg.get_config(arch)
            shp, long_ctx = rcfg.INPUT_SHAPES[shape], shape == "long_500k"
            ref = jax.eval_shape(lambda: rm.init_state(
                cfg_r, shp.global_batch, shp.seq_len, long_ctx))
            port = init_state(cfg, shp.global_batch, shp.seq_len,
                              long_context=long_ctx, device="meta")
            cache[(arch, shape)] = (ref, port)
        return cache[(arch, shape)]

    return get


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_state_pspecs_match_reference(states, arch, shape, multi_pod):
    """The serving state at full width, leaf by leaf (paths, shapes,
    dtypes: the long-context rings included), and its specs."""
    ref, port = states(arch, shape)
    ref_flat, port_flat = _ref_flat(ref), _port_flat(port)
    assert sorted(ref_flat) == sorted(port_flat)
    for ps, leaf in port_flat.items():
        assert leaf.is_meta
        assert tuple(leaf.shape) == ref_flat[ps].shape, ps
        assert str(leaf.dtype)[6:] == str(ref_flat[ps].dtype), ps
    long_ctx = shape == "long_500k"
    cfg_r, cfg = rcfg.get_config(arch), tcfg.get_config(arch)
    shp_r, shp = rcfg.INPUT_SHAPES[shape], tcfg.INPUT_SHAPES[shape]
    want = _ref_flat(rspecs.state_pspecs(cfg_r, ref, shp_r,
                                         long_context=long_ctx,
                                         multi_pod=multi_pod),
                     is_leaf=lambda x: isinstance(x, P))
    got = _port_flat(tspecs.state_pspecs(cfg, port, shp,
                                         long_context=long_ctx,
                                         multi_pod=multi_pod))
    bad = {ps: (str(tuple(want[ps])), str(_fold(got[ps]))) for ps in got
           if str(tuple(want[ps])) != str(_fold(got[ps]))}
    assert not bad, bad
