"""The port's model held against the JAX package's on the CPU.

Reduced starcoder2-3b in f32: the JAX package's random weights go through
numpy into the port (``params_from_numpy``), the same prompts (numpy,
seeded) go through both, and logits must agree to 1e-4 abs with greedy
tokens exactly equal.  Caches are compared leaf by leaf.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
import repro.models as rm
from repro.core import kvbytes as r_kvbytes
from repro.kvstore import LineCosts as RLineCosts
from repro.models.state import state_bytes as r_state_bytes
from repro.serving.sampling import decode_keys
import repro_torch.configs as tcfg
import repro_torch.models as tm
from repro_torch.bridge import params_from_numpy, state_from_numpy
from repro_torch.core import kvbytes as t_kvbytes
from repro_torch.kvstore import LineCosts as TLineCosts
from repro_torch.models.state import state_bytes as t_state_bytes

TOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


@pytest.fixture(scope="module")
def setup():
    cfg_r = rcfg.get_config("starcoder2-3b").reduced()
    cfg_t = tcfg.get_config("starcoder2-3b").reduced()
    params_r = rm.init_params(jax.random.PRNGKey(0), cfg_r)
    params_t = params_from_numpy(_np_tree(params_r), device="cpu")
    return cfg_r, cfg_t, params_r, params_t


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_equal_field_by_field(reduced):
    a = rcfg.get_config("starcoder2-3b")
    b = tcfg.get_config("starcoder2-3b")
    if reduced:
        a, b = a.reduced(), b.reduced()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.head_dim == b.head_dim and a.q_per_kv == b.q_per_kv
    assert a.param_count() == b.param_count()


@pytest.mark.parametrize("reduced", [False, True])
def test_line_costs_equal(reduced):
    a = rcfg.get_config("starcoder2-3b")
    b = tcfg.get_config("starcoder2-3b")
    if reduced:
        a, b = a.reduced(), b.reduced()
    assert (dataclasses.asdict(RLineCosts.from_config(a))
            == dataclasses.asdict(TLineCosts.from_config(b)))
    assert (r_kvbytes.state_bytes_at(a, 517)
            == t_kvbytes.state_bytes_at(b, 517))


def test_init_params_layout_and_scales(setup):
    cfg_r, cfg_t, params_r, _ = setup
    own = tm.init_params(cfg_t, torch.Generator().manual_seed(0),
                         device="cpu")
    ref_shapes = [tuple(x.shape) for x in _leaves(params_r)]
    assert [tuple(x.shape) for x in _leaves(own)] == ref_shapes
    assert all(x.dtype == torch.float32 for x in _leaves(own))
    assert abs(float(own["embed"].std()) - 0.02) < 2e-3
    wq = own["segments"][0]["p0"]["mixer"]["wq"]
    assert abs(float(wq.std()) - cfg_t.d_model ** -0.5) < 5e-3


def test_state_layout_and_bytes(setup):
    cfg_r, cfg_t, _, _ = setup
    st_r = rm.init_state(cfg_r, 3, 32)
    st_t = tm.init_state(cfg_t, 3, 32, device="cpu")
    assert ([tuple(x.shape) for x in _leaves(st_r)]
            == [tuple(x.shape) for x in _leaves(st_t)])
    assert r_state_bytes(st_r) == t_state_bytes(st_t)


def test_prefill_logits_and_caches(setup):
    cfg_r, cfg_t, params_r, params_t = setup
    toks = _tokens(1, (2, 24), cfg_r.vocab_size)
    lr, st_r = rm.prefill(cfg_r, params_r, {"tokens": jnp.asarray(toks)},
                          rm.init_state(cfg_r, 2, 32))
    lt, st_t = tm.prefill(cfg_t, params_t, {"tokens": torch.from_numpy(toks)},
                          tm.init_state(cfg_t, 2, 32, device="cpu"))
    assert _err(lt, lr) < TOL
    assert np.array_equal(lt.argmax(-1).numpy(), np.asarray(lr.argmax(-1)))
    for a, b in zip(_leaves(st_r), _leaves(st_t)):
        assert _err(b, a) < TOL


def test_prefill_ring_keeps_last_window(setup):
    """A prompt longer than the cache window keeps its last rows (ring)."""
    cfg_r, cfg_t, params_r, params_t = setup
    toks = _tokens(2, (1, 21), cfg_r.vocab_size)
    lr, st_r = rm.prefill(cfg_r, params_r, {"tokens": jnp.asarray(toks)},
                          rm.init_state(cfg_r, 1, 16))
    lt, st_t = tm.prefill(cfg_t, params_t, {"tokens": torch.from_numpy(toks)},
                          tm.init_state(cfg_t, 1, 16, device="cpu"))
    assert _err(lt, lr) < TOL
    for a, b in zip(_leaves(st_r), _leaves(st_t)):
        assert _err(b, a) < TOL


def _batched(setup):
    cfg_r, cfg_t, params_r, params_t = setup
    toks = _tokens(3, (4, 16), cfg_r.vocab_size)
    lens = np.asarray([16, 5, 9, 1], np.int32)
    for i, n in enumerate(lens):
        toks[i, n:] = 0
    lr, st_r = rm.prefill_batched(cfg_r, params_r, jnp.asarray(toks),
                                  rm.init_state(cfg_r, 4, 32),
                                  jnp.asarray(lens))
    lt, st_t = tm.prefill_batched(cfg_t, params_t, torch.from_numpy(toks),
                                  tm.init_state(cfg_t, 4, 32, device="cpu"),
                                  torch.from_numpy(lens))
    return lens, (lr, st_r), (lt, st_t)


def test_prefill_batched_logits(setup):
    _, (lr, st_r), (lt, st_t) = _batched(setup)
    assert _err(lt, lr) < TOL
    assert np.array_equal(lt.argmax(-1).numpy(), np.asarray(lr.argmax(-1)))
    for a, b in zip(_leaves(st_r), _leaves(st_t)):
        assert _err(b, a) < TOL


def test_decode_step_dense_logits(setup):
    """Three greedy dense decode steps at per-request clocks."""
    cfg_r, cfg_t, params_r, params_t = setup
    lens, (lr, st_r), (lt, st_t) = _batched(setup)
    t = lens.copy()
    for _ in range(3):
        tok = np.array(lr.argmax(-1), np.int32)[:, None]
        assert np.array_equal(lt.argmax(-1).numpy()[:, None], tok)
        lr, st_r = rm.decode_step(cfg_r, params_r, jnp.asarray(tok), st_r,
                                  jnp.asarray(t))
        lt, st_t = tm.decode_step(cfg_t, params_t, torch.from_numpy(tok),
                                  st_t, torch.from_numpy(t))
        assert _err(lt, lr) < TOL
        t = t + 1


def _identity_tables(slots, blocks, per_slot):
    return np.asarray([[s * per_slot + j for j in range(blocks)]
                       for s in slots], np.int32)


def test_decode_step_paged_logits(setup):
    """Compacted paged decode over slots (2, 0) of the batched state."""
    cfg_r, cfg_t, params_r, params_t = setup
    lens, (lr, st_r), (lt, st_t) = _batched(setup)
    slots = np.asarray([2, 0], np.int32)
    tables = _identity_tables(slots, 2, 2)       # 32-line window, bl 16
    t = lens[slots].copy()
    tok = np.array(lr.argmax(-1), np.int32)[slots][:, None]
    for _ in range(3):
        lr2, st_r = rm.decode_step_paged(
            cfg_r, params_r, jnp.asarray(tok), st_r, jnp.asarray(t),
            jnp.asarray(slots), jnp.asarray(tables), 16)
        lt2, st_t = tm.decode_step_paged(
            cfg_t, params_t, torch.from_numpy(tok), st_t, torch.from_numpy(t),
            torch.from_numpy(slots), torch.from_numpy(tables), 16)
        assert _err(lt2, lr2) < TOL
        tok = np.array(lr2.argmax(-1), np.int32)[:, None]
        assert np.array_equal(lt2.argmax(-1).numpy()[:, None], tok)
        t = t + 1
    for a, b in zip(_leaves(st_r), _leaves(st_t)):
        assert _err(b, a) < TOL


@pytest.mark.parametrize("eos", [-1, "mid"])
def test_decode_multi_tokens_equal(setup, eos):
    cfg_r, cfg_t, params_r, params_t = setup
    lens, (lr, st_r), (lt, st_t) = _batched(setup)
    slots = np.asarray([0, 1, 3], np.int32)
    tables = _identity_tables(slots, 2, 2)
    t = lens[slots].copy()
    tok = np.array(lr.argmax(-1), np.int32)[slots][:, None]
    budget = np.asarray([6, 3, 6], np.int32)
    _, keys = decode_keys(jax.random.PRNGKey(0), 6)
    if eos == "mid":      # a token row 0 samples mid-span, taken from a probe
        probe, _, _ = rm.decode_multi(
            cfg_r, params_r, jnp.asarray(tok), dict(st_r), jnp.asarray(t),
            jnp.asarray(slots), jnp.asarray(tables), jnp.asarray(budget),
            keys, block_lines=16)
        eos = int(probe[2, 0])
    tr, st_r, er = rm.decode_multi(
        cfg_r, params_r, jnp.asarray(tok), st_r, jnp.asarray(t),
        jnp.asarray(slots), jnp.asarray(tables), jnp.asarray(budget), keys,
        block_lines=16, eos_token=eos)
    tt, st_t, et = tm.decode_multi(
        cfg_t, params_t, torch.from_numpy(tok), st_t, torch.from_numpy(t),
        torch.from_numpy(slots), torch.from_numpy(tables),
        torch.from_numpy(budget), steps=6, block_lines=16, eos_token=eos)
    assert np.array_equal(tt.numpy(), np.asarray(tr))
    assert np.array_equal(et.numpy(), np.asarray(er))
    # dead rows froze on the same reserved line: caches agree too
    for a, b in zip(_leaves(st_r), _leaves(st_t)):
        assert _err(b, a) < TOL


def test_state_from_numpy_copies(setup):
    cfg_r, _, _, _ = setup
    st = _np_tree(rm.init_state(cfg_r, 2, 16))
    out = state_from_numpy(st, device="cpu")
    leaf = out["layers"][0]["p0"]["k"]
    leaf += 1.0                              # writable, not the jax buffer
    assert float(np.asarray(st["layers"][0]["p0"]["k"]).max()) == 0.0
