"""The port's partition-spec rules held against the JAX package's.

Every architecture of the registries at its published widths: the port
builds its parameter tree on the meta device, the JAX package through
``jax.eval_shape``, and both trees must have the same leaves at the same
paths with the same shapes.  ``param_pspecs`` must then give every leaf
the same spec, compared as strings, in both modes ("serve", "train"),
both layouts ("tp", "fsdp") and at ``model_n`` 16, 4 and 2 (a mesh
slice's width).  ``pick_layout`` follows ``REPRO_LAYOUT`` as the JAX
package's does; the input and state specs wait for the dry-run slice.
"""
from types import SimpleNamespace

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.configs as rcfg
import repro.models as rm
from repro.launch import specs as rspecs
import repro_torch.configs as tcfg
from repro_torch.launch import specs as tspecs
from repro_torch.models import init_params

#: the JAX package's ``list_archs()`` (its ten assigned architectures)
#: and the paper's evaluation model, which both registries also hold
ARCHS = tcfg.list_archs()


def test_registries_agree():
    assert rcfg.list_archs() + ["llama2-70b"] == ARCHS
    assert rcfg.get_config("llama2-70b").name == "llama2-70b"


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
    with pytest.raises(NotImplementedError, match="slice 12"):
        getattr(tspecs, name)(tcfg.get_config("starcoder2-3b"), None)
