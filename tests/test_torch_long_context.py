"""The long-context serving branch and ``sample`` held against the JAX
package's on the CPU.

``cache_capacity`` for every architecture at three lengths, with and
without the long-context policy; then reduced minicpm-2b (dense GQA with
no sliding window), deepseek-v3 (MLA), jamba (the hybrid stack, which
keeps full KV) and seamless-m4t (enc-dec) with ``long_context_window``
set to 48 on both sides, so that an 80-token prefill overflows the ring
and 40 decode steps wrap it again: logits within 1e-4 at every step and
every state leaf within 1e-4 at the end.  ``sample`` at temperature 0
against the JAX package's, and its top-k mask against the JAX package's
masked logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
import repro.models as rm
from repro.models.state import cache_capacity as r_capacity
from repro.serving.sampling import sample as r_sample
import repro_torch.configs as tcfg
import repro_torch.models as tm
from repro_torch.bridge import params_from_numpy
from repro_torch.models.state import cache_capacity as t_capacity
from repro_torch.models.state import state_bytes
from repro_torch.serving import sample
from repro_torch.serving.sampling import top_k_mask

TOL = 1e-4
WINDOW = 48
PROMPT, STEPS, BATCH = 80, 40, 2


@pytest.mark.parametrize("long_context", [False, True])
@pytest.mark.parametrize("seq_len", [1_024, 32_768, 524_288])
@pytest.mark.parametrize("arch", tcfg.list_archs(include_extra=True))
def test_cache_capacity_matches_reference(arch, seq_len, long_context):
    assert t_capacity(tcfg.get_config(arch), seq_len, long_context) == \
        r_capacity(rcfg.get_config(arch), seq_len, long_context)


def test_long_context_state_of_minicpm_at_full_width():
    """minicpm-2b's long_500k state for two requests: a ring of 8,192
    lines, 2 x 8,192 x 368,640 bytes, on the meta device."""
    cfg = tcfg.get_config("minicpm-2b")
    state = tm.init_state(cfg, 2, 524_288, long_context=True, device="meta")
    k = state["layers"][0]["p0"]["k"]
    assert tuple(k.shape)[1:3] == (2, 8_192)
    assert state_bytes(state) == 6_039_797_760


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _paths(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{path}/{i}")
    else:
        yield path, tree


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def _state_equal(st_r, st_t):
    ref, own = list(_paths(_np_tree(st_r))), list(_paths(st_t))
    assert [p for p, _ in own] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(ref, own):
        assert tuple(b.shape) == a.shape, path
        assert _err(b, a) < TOL, path


@pytest.mark.parametrize("arch", ["minicpm-2b", "deepseek-v3-671b",
                                  "jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2"])
def test_long_context_prefill_and_decode_match_reference(arch):
    cfg_r = dataclasses.replace(rcfg.get_config(arch).reduced(),
                                long_context_window=WINDOW)
    cfg = dataclasses.replace(tcfg.get_config(arch).reduced(),
                              long_context_window=WINDOW)
    params_r = rm.init_params(jax.random.PRNGKey(0), cfg_r)
    params = params_from_numpy(_np_tree(params_r), device="cpu")
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT), dtype=np.int32)
    batch_r, batch_t = {"tokens": jnp.asarray(toks)}, {
        "tokens": torch.from_numpy(toks)}
    if cfg.is_encoder_decoder:
        frames = rng.standard_normal((BATCH, cfg.encoder.max_source_positions,
                                      cfg.frontend.embed_dim)
                                     ).astype(np.float32)
        batch_r["frames"], batch_t["frames"] = (jnp.asarray(frames),
                                                torch.from_numpy(frames))
    seq = 4 * PROMPT
    want_cap = seq if cfg.family == "hybrid" else WINDOW
    assert t_capacity(cfg, seq, True) == want_cap
    # the reference's steps compiled once: eager they would dispatch op
    # by op at every step
    r_prefill = jax.jit(rm.prefill, static_argnums=0,
                        static_argnames="long_context")
    r_decode = jax.jit(rm.decode_step, static_argnums=0,
                       static_argnames="long_context")
    lr, st_r = r_prefill(cfg_r, params_r, batch_r,
                         rm.init_state(cfg_r, BATCH, seq, True),
                         long_context=True)
    lt, st_t = tm.prefill(cfg, params, batch_t,
                          tm.init_state(cfg, BATCH, seq, long_context=True,
                                        device="cpu"),
                          long_context=True)
    assert _err(lt, lr) < TOL
    t = np.full(BATCH, PROMPT, np.int32)
    for _ in range(STEPS):
        tok = np.array(lr.argmax(-1), np.int32)[:, None]
        assert np.array_equal(lt.argmax(-1).numpy()[:, None], tok)
        lr, st_r = r_decode(cfg_r, params_r, jnp.asarray(tok), st_r,
                            jnp.asarray(t), long_context=True)
        lt, st_t = tm.decode_step(cfg, params, torch.from_numpy(tok), st_t,
                                  torch.from_numpy(t), long_context=True)
        assert _err(lt, lr) < TOL
        t = t + 1
    _state_equal(st_r, st_t)


@pytest.mark.parametrize("route", ["batched+paged", "chunk+multi"])
def test_long_context_engine_steps_match_reference(route):
    """The engine's entry points under the long-context policy on reduced
    minicpm-2b with a 48-line ring: ``prefill_batched`` (rows of 80 and 77
    tokens) then 40 ``decode_step_paged`` steps, or ``prefill_chunk`` in
    chunks of 32, 32 and 16 (the last two past the ring's size) then one
    40-step greedy ``decode_multi``; logits, tokens and every state leaf
    within 1e-4 of the JAX package's."""
    arch, bl = "minicpm-2b", 16
    cfg_r = dataclasses.replace(rcfg.get_config(arch).reduced(),
                                long_context_window=WINDOW)
    cfg = dataclasses.replace(tcfg.get_config(arch).reduced(),
                              long_context_window=WINDOW)
    params_r = rm.init_params(jax.random.PRNGKey(0), cfg_r)
    params = params_from_numpy(_np_tree(params_r), device="cpu")
    toks = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (BATCH, PROMPT), dtype=np.int32)
    seq = 4 * PROMPT
    st_r = rm.init_state(cfg_r, BATCH, seq, True)
    st_t = tm.init_state(cfg, BATCH, seq, long_context=True, device="cpu")
    slots = np.arange(BATCH, dtype=np.int32)
    tables = (slots[:, None] * (WINDOW // bl)
              + np.arange(WINDOW // bl, dtype=np.int32)[None])
    if route == "batched+paged":
        lens = np.array([PROMPT, PROMPT - 3], np.int32)
        lr, st_r = jax.jit(rm.prefill_batched, static_argnums=0,
                           static_argnames="long_context")(
            cfg_r, params_r, jnp.asarray(toks), st_r, jnp.asarray(lens),
            long_context=True)
        lt, st_t = tm.prefill_batched(cfg, params, torch.from_numpy(toks),
                                      st_t, torch.from_numpy(lens),
                                      long_context=True)
        assert _err(lt, lr) < TOL
        r_step = jax.jit(rm.decode_step_paged, static_argnums=0,
                         static_argnames=("block_lines", "long_context"))
        t = lens
        for _ in range(STEPS):
            tok = np.array(lr.argmax(-1), np.int32)[:, None]
            lr, st_r = r_step(cfg_r, params_r, jnp.asarray(tok), st_r,
                              jnp.asarray(t), jnp.asarray(slots),
                              jnp.asarray(tables), block_lines=bl,
                              long_context=True)
            lt, st_t = tm.decode_step_paged(
                cfg, params, torch.from_numpy(tok), st_t,
                torch.from_numpy(t), torch.from_numpy(slots),
                torch.from_numpy(tables), bl, long_context=True)
            assert _err(lt, lr) < TOL
            t = t + 1
    else:
        r_chunk = jax.jit(rm.prefill_chunk, static_argnums=(0, 4),
                          static_argnames="long_context")
        for lo, hi in ((0, 32), (32, 64), (64, PROMPT)):
            lr, st_r = r_chunk(cfg_r, params_r, jnp.asarray(toks[:, lo:hi]),
                               st_r, lo, long_context=True)
            lt, st_t = tm.prefill_chunk(cfg, params,
                                        torch.from_numpy(toks[:, lo:hi]),
                                        st_t, lo, long_context=True)
            assert _err(lt, lr) < TOL, (lo, hi)
        tok = np.array(lr.argmax(-1), np.int32)[:, None]
        t = np.full(BATCH, PROMPT, np.int32)
        budget = np.array([STEPS, STEPS // 2], np.int32)
        out_r, st_r, em_r = jax.jit(
            rm.decode_multi, static_argnums=0,
            static_argnames=("block_lines", "long_context"))(
            cfg_r, params_r, jnp.asarray(tok), st_r, jnp.asarray(t),
            jnp.asarray(slots), jnp.asarray(tables), jnp.asarray(budget),
            jax.random.split(jax.random.PRNGKey(0), STEPS), block_lines=bl,
            long_context=True)
        out_t, st_t, em_t = tm.decode_multi(
            cfg, params, torch.from_numpy(tok), st_t, torch.from_numpy(t),
            torch.from_numpy(slots), torch.from_numpy(tables),
            torch.from_numpy(budget), steps=STEPS, block_lines=bl,
            long_context=True)
        assert np.array_equal(out_t.numpy(), np.asarray(out_r))
        assert np.array_equal(em_t.numpy(), np.asarray(em_r))
    _state_equal(st_r, st_t)


def test_sample_greedy_matches_reference():
    logits = np.random.default_rng(3).standard_normal((5, 300)).astype(
        np.float32)
    want = np.asarray(r_sample(jnp.asarray(logits), jax.random.PRNGKey(0)))
    got = sample(torch.from_numpy(logits)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("top_k", [1, 7, 40])
def test_top_k_mask_matches_reference(top_k):
    """The mask the JAX package's ``sample`` applies before its draw, and
    every draw at T = 1 within its row's top k."""
    logits = np.random.default_rng(top_k).standard_normal((4, 200)).astype(
        np.float32)
    vals, _ = jax.lax.top_k(jnp.asarray(logits), top_k)
    want = np.asarray(jnp.where(jnp.asarray(logits) < vals[:, -1:], -1e30,
                                jnp.asarray(logits)))
    got = top_k_mask(torch.from_numpy(logits), top_k).numpy()
    assert np.array_equal(got, want)
    cutoff = np.sort(logits, axis=-1)[:, -top_k]
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        draw = sample(torch.from_numpy(logits), temperature=1.0, top_k=top_k,
                      generator=gen).numpy()
        assert (logits[np.arange(len(draw)), draw] >= cutoff).all()
