"""The port's copies of the remaining GQA configs held against the JAX
package's on the CPU.

starcoder2-7b, phi3-medium-14b, minicpm-2b (MHA at head dim 64, tied
embeddings, residual and logit scales), llama2-70b (the paper's
evaluation model) and arctic-480b (128-expert top-2 MoE beside a dense
residual MLP): each ``ModelConfig`` equals ``repro``'s field by field,
full and ``.reduced()``, and at ``.reduced()`` in f32, with the JAX
package's weights bridged through numpy, a prefill and four greedy decode
steps give logits within 1e-4 and equal tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
import repro.models as rm
import repro_torch.configs as tcfg
import repro_torch.models as tm
from repro_torch.bridge import params_from_numpy

TOL = 1e-4
ARCHS = ["starcoder2-7b", "phi3-medium-14b", "minicpm-2b", "llama2-70b",
         "arctic-480b"]


def test_registry_lists_every_ported_config():
    archs = tcfg.list_archs()
    assert set(ARCHS) <= set(archs)
    assert set(archs) <= set(rcfg.list_archs(include_extra=True))
    for arch in archs:
        assert tcfg.get_config(arch).name == arch
    with pytest.raises(KeyError, match="unknown arch"):
        tcfg.get_config("deepseek-v3-671b")


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equal_field_by_field(arch, reduced):
    a, b = rcfg.get_config(arch), tcfg.get_config(arch)
    if reduced:
        a, b = a.reduced(), b.reduced()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.head_dim == b.head_dim and a.q_per_kv == b.q_per_kv
    assert a.param_count() == b.param_count()
    assert a.block_pattern == b.block_pattern


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    cfg_r, cfg_t = rcfg.get_config(arch).reduced(), \
        tcfg.get_config(arch).reduced()
    assert cfg_t.dtype == "float32"
    params_r = rm.init_params(jax.random.PRNGKey(0), cfg_r)
    params_t = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params_r), device="cpu")
    toks = np.random.default_rng(11).integers(0, cfg_r.vocab_size, (2, 12),
                                              dtype=np.int32)
    lr, st_r = rm.prefill(cfg_r, params_r, {"tokens": jnp.asarray(toks)},
                          rm.init_state(cfg_r, 2, 32))
    lt, st_t = tm.prefill(cfg_t, params_t, {"tokens": torch.from_numpy(toks)},
                          tm.init_state(cfg_t, 2, 32, device="cpu"))
    assert _err(lt, lr) < TOL
    t = np.full(2, 12, np.int32)
    for _ in range(4):
        tok = np.array(lr.argmax(-1), np.int32)[:, None]
        assert np.array_equal(lt.argmax(-1).numpy()[:, None], tok)
        lr, st_r = rm.decode_step(cfg_r, params_r, jnp.asarray(tok), st_r,
                                  jnp.asarray(t))
        lt, st_t = tm.decode_step(cfg_t, params_t, torch.from_numpy(tok),
                                  st_t, torch.from_numpy(t))
        assert _err(lt, lr) < TOL
        t = t + 1
    assert np.array_equal(lt.argmax(-1).numpy(), np.asarray(lr.argmax(-1)))
