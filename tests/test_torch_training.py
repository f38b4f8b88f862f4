"""The port's training path held against the JAX package's on the CPU.

Schedules, the data pipeline, AdamW, checkpoints, ``forward_train``,
``forward_mtp``, the train step and the two launchers, at ``.reduced()``
widths in f32.  The JAX package's random weights go through numpy into
the port (``params_from_numpy``); the same inputs (numpy, seeded) go
through both.  Tolerances: schedules 1e-7, AdamW 1e-6, logits and grads
1e-4 of the largest magnitude of the compared leaf (the packages sum in
different orders); data and checkpoints bitwise.  Training reaches no
kernel of the port nor its plain version (the autouse fixture), and each
kernel wrapper refuses inputs that require grad.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
import repro.models as rm
import repro.training as rtr
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.mamba_scan import mamba_scan_pallas
from repro.training import checkpoint as rckpt
import repro_torch.configs as tcfg
import repro_torch.models as tm
import repro_torch.training as ttr
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import read_counts, reset_counts
from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  paged_decode_attention_cuda)
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.mamba_scan import mamba_scan_cuda
from repro_torch.launch import train as ttrain
from repro_torch.launch import train_small as ttrain_small
from repro_torch.training import checkpoint as tckpt
from repro_torch.training.train_step import grads_of

TOL = 1e-4
ARCHS = ["minicpm-2b", "jamba-1.5-large-398b", "deepseek-v3-671b",
         "xlstm-1.3b", "seamless-m4t-large-v2", "internvl2-1b"]
STEP_ARCHS = ["minicpm-2b", "jamba-1.5-large-398b", "deepseek-v3-671b"]
B, S = 2, 16


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


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close_by_leaf(a_tree, b_tree, tol=TOL):
    """Every leaf within ``tol`` x that leaf's max |value|."""
    a, b = dict(_paths(a_tree)), dict(_paths(b_tree))
    assert a.keys() == b.keys()
    for k in a:
        x, y = _f32(a[k]), _f32(b[k])
        assert x.shape == y.shape, k
        scale = max(float(np.abs(x).max(initial=0.0)), 1e-30)
        assert float(np.abs(x - y).max(initial=0.0)) <= tol * scale, k


def _extras(cfg, seed=3):
    rng = np.random.default_rng(seed)
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        return {"patch_embeds": rng.standard_normal(
            (B, cfg.frontend.num_prefix_tokens, cfg.frontend.embed_dim),
            dtype=np.float32)}
    if cfg.is_encoder_decoder:
        return {"frames": rng.standard_normal(
            (B, cfg.encoder.max_source_positions, cfg.frontend.embed_dim),
            dtype=np.float32)}
    return {}


def _batch_np(cfg, seed=0):
    b = next(rtr.batches(rtr.DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=S, global_batch=B,
                                        seed=seed)))
    return {"tokens": b[:, :-1], "labels": b[:, 1:], **_extras(cfg)}


def _jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _th(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(autouse=True)
def no_kernel_runs():
    """Training reaches no kernel of the port nor its plain version."""
    reset_counts()
    yield
    for name, c in read_counts().items():
        assert c == {"launches": 0, "plain_calls": 0}, name


@pytest.fixture(scope="module")
def models():
    """arch -> (repro config, port config, repro params, port params)."""
    out = {}
    for arch in ARCHS:
        cfg_r = rcfg.get_config(arch).reduced()
        cfg_t = tcfg.get_config(arch).reduced()
        params_r = rm.init_params(jax.random.PRNGKey(0), cfg_r)
        out[arch] = (cfg_r, cfg_t, params_r,
                     params_from_numpy(_np_tree(params_r), device="cpu"))
    return out


# ---------------------------------------------------------------------------
# schedules, data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["cosine", "wsd"])
def test_schedule_matches_reference(name):
    total, warmup = 100, 10
    ref, port = rtr.SCHEDULES[name], ttr.SCHEDULES[name]
    for step in range(total + 1):
        a = float(ref(step, warmup=warmup, total=total))
        b = port(step, warmup=warmup, total=total)
        assert b.dtype == torch.float32
        assert abs(a - float(b)) <= 1e-7, step


def test_batches_bitwise_equal():
    cfg = dict(vocab_size=1000, seq_len=24, global_batch=3, seed=5)
    ref = rtr.batches(rtr.DataConfig(**cfg))
    port = ttr.batches(ttr.DataConfig(**cfg))
    for _ in range(3):
        a, b = next(ref), next(port)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _random_tree(seed):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"w": n(8, 16), "b": n(16), "seg": [{"k": n(2, 4, 6)},
                                                {"n": n(5)}]}


@pytest.mark.parametrize("clip", [1e3, 0.1], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(state_dtype, clip):
    params = _random_tree(0)
    cfg_r = rtr.AdamWConfig(lr=1e-2, grad_clip=clip, state_dtype=state_dtype)
    cfg_t = ttr.AdamWConfig(lr=1e-2, grad_clip=clip, state_dtype=state_dtype)
    jtree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    ttree = lambda t: params_from_numpy(t, device="cpu")
    p_r, p_t = jtree(params), ttree(params)
    s_r = rtr.init_opt_state(cfg_r, p_r)
    s_t = ttr.init_opt_state(cfg_t, p_t)
    for step in range(2):     # the second step reads the first's moments
        g = _random_tree(1 + step)
        p_r, s_r, n_r = rtr.adamw_update(cfg_r, p_r, jtree(g), s_r,
                                         jnp.float32(0.5))
        p_t, s_t, n_t = ttr.adamw_update(cfg_t, p_t, ttree(g), s_t, 0.5)
        assert abs(float(n_r) - float(n_t)) <= 1e-6 * float(n_r)
        assert int(s_t.step) == int(s_r.step) == step + 1
        for a, b in ((p_r, p_t), (s_r.m, s_t.m), (s_r.v, s_t.v)):
            _close_by_leaf(_np_tree(a), b, tol=1e-6)
    assert all(x.dtype == getattr(torch, state_dtype)
               for _, x in _paths(s_t.m))
    if clip < 1.0:
        assert float(n_t) > clip


def test_adamw_slices_do_not_change_the_update(monkeypatch):
    """A leaf updated in slices of CHUNK elements gets the update it gets
    whole, bit for bit (bf16 and f32 leaves, ragged last slice)."""
    from repro_torch.training import optimizer as topt
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)
    params = {"w": r(5, 9), "b": r(13).bfloat16(), "s": r()}
    grads = {"w": r(5, 9), "b": r(13).bfloat16(), "s": r()}
    cfg = ttr.AdamWConfig(grad_clip=0.5)
    state = ttr.init_opt_state(cfg, params)
    whole = ttr.adamw_update(cfg, params, grads, state, 1.0)
    monkeypatch.setattr(topt, "CHUNK", 7)
    sliced = ttr.adamw_update(cfg, params, grads, state, 1.0)
    for a, b in zip(torch.utils._pytree.tree_flatten(whole)[0],
                    torch.utils._pytree.tree_flatten(sliced)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------


def _ckpt_tree(seed):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((3, 5)).astype(np.float32)
    return {"a": f, "z": [f[0] * 2, (np.arange(4, dtype=np.int32),)],
            "bf": rng.standard_normal((4, 6)).astype(np.float32)}


def _as_jax(tree):
    out = jax.tree_util.tree_map(jnp.asarray, tree)
    out["bf"] = out["bf"].astype(jnp.bfloat16)
    return out


def _as_torch(tree):
    out = params_from_numpy(tree, device="cpu")
    out["z"][1] = tuple(out["z"][1])
    out["bf"] = out["bf"].to(torch.bfloat16)
    return out


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 else x


def test_reference_checkpoint_restores_in_port(tmp_path):
    src = _as_jax(_ckpt_tree(0))
    path = str(tmp_path / "ref.npz")
    rckpt.save(path, src)
    got = tckpt.restore(path, _as_torch(_ckpt_tree(9)))
    assert got["bf"].dtype == torch.bfloat16
    assert isinstance(got["z"][1], tuple)
    for (ka, a), (kb, b) in zip(_paths(src), _paths(got)):
        assert ka == kb
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_port_checkpoint_restores_in_reference(tmp_path):
    src = _as_torch(_ckpt_tree(1))
    path = str(tmp_path / "port.npz")
    tckpt.save(path, src)
    with np.load(path) as data:        # the reference's path keys
        assert sorted(data.files) == ["/a", "/bf", "/z/L0", "/z/L1/T0"]
    got = rckpt.restore(path, _as_jax(_ckpt_tree(9)))
    assert got["bf"].dtype == jnp.bfloat16
    for (ka, a), (kb, b) in zip(_paths(src), _paths(got)):
        assert ka == kb
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_reference_cannot_restore_its_own_bf16(tmp_path):
    """A fault of the reference, pinned: its writer stores a bf16 leaf as
    2-byte voids, which its own restore hands to JAX and JAX refuses.  The
    port reads those bits (above) and writes bf16 widened to f32."""
    src = _as_jax(_ckpt_tree(2))
    path = str(tmp_path / "ref.npz")
    rckpt.save(path, src)
    with pytest.raises(TypeError, match="V2"):
        rckpt.restore(path, src)


def test_checkpoint_roundtrip_of_model_params(models, tmp_path):
    _, cfg, _, params = models["internvl2-1b"]
    bf = dict(params)
    bf["embed"] = bf["embed"].to(torch.bfloat16)
    path = str(tmp_path / "model.npz")
    tckpt.save(path, bf)
    got = tckpt.restore(path, bf)
    for (ka, a), (kb, b) in zip(_paths(bf), _paths(got)):
        assert ka == kb and a.dtype == b.dtype
        assert torch.equal(a, b), ka


# ---------------------------------------------------------------------------
# forward_train, forward_mtp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(models, arch):
    cfg_r, cfg, params_r, params = models[arch]
    batch = _batch_np(cfg)
    del batch["labels"]
    logits_r, aux_r = rm.forward_train(cfg_r, params_r, _jx(batch))
    with torch.no_grad():
        logits, aux = tm.forward_train(cfg, params, _th(batch), remat=False)
        logits_re, aux_re = tm.forward_train(cfg, params, _th(batch),
                                             remat=True)
    assert logits.shape == (B, S, cfg.vocab_size)
    assert logits.dtype == aux.dtype == torch.float32 and aux.dim() == 0
    scale = float(np.abs(np.asarray(logits_r)).max())
    assert float(np.abs(np.asarray(logits_r) - logits.numpy()).max()) \
        <= TOL * scale
    assert abs(float(aux_r) - float(aux)) <= TOL * max(abs(float(aux_r)),
                                                       1e-30)
    if cfg.moe is not None:
        assert float(aux) > 0
    assert torch.equal(logits, logits_re) and torch.equal(aux, aux_re)


def test_remat_gives_the_same_grads(models):
    _, cfg, _, params = models["jamba-1.5-large-398b"]
    batch = _th(_batch_np(cfg))
    grads = []
    for remat in (False, True):
        def loss(p):
            logits, aux = tm.forward_train(cfg, p, batch, remat=remat)
            return ttr.cross_entropy(logits, batch["labels"]) + aux
        leaves, spec = torch.utils._pytree.tree_flatten(params)
        live = [x.detach().requires_grad_(True) for x in leaves]
        grads.append(torch.autograd.grad(
            loss(torch.utils._pytree.tree_unflatten(live, spec)), live,
            allow_unused=True))
    for a, b in zip(*grads):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)


def test_forward_mtp_matches_reference():
    cfg_r = dataclasses.replace(rcfg.get_config("deepseek-v3-671b").reduced(),
                                mtp_depth=1)
    cfg = dataclasses.replace(tcfg.get_config("deepseek-v3-671b").reduced(),
                              mtp_depth=1)
    params_r = rm.init_params(jax.random.PRNGKey(1), cfg_r)
    params = params_from_numpy(_np_tree(params_r), device="cpu")
    tokens = _batch_np(cfg)["tokens"]
    ref = np.asarray(rm.forward_mtp(cfg_r, params_r,
                                    {"tokens": jnp.asarray(tokens)}))
    with torch.no_grad():
        got = tm.forward_mtp(cfg, params, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (B, S - 1, cfg.vocab_size)
    assert float(np.abs(ref - got.numpy()).max()) \
        <= TOL * float(np.abs(ref).max())
    assert tm.forward_mtp(tcfg.get_config("minicpm-2b").reduced(), params,
                          {"tokens": torch.from_numpy(tokens)}) is None


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_matches_reference(models, arch):
    """Step 1's loss, grad norm and every leaf's grad, then the params after
    3 steps, each leaf within 1e-4 of its max."""
    cfg_r, cfg, params_r, params = models[arch]
    opt_r = rtr.AdamWConfig(lr=1e-3)
    opt_t = ttr.AdamWConfig(lr=1e-3)
    batches = [_batch_np(cfg, seed) for seed in range(3)]

    (loss_r, _), grads_r = jax.value_and_grad(
        lambda p: rtr.loss_fn(cfg_r, p, _jx(batches[0])), has_aux=True)(
        params_r)
    loss_t, metrics, grads_t = grads_of(cfg, params, _th(batches[0]))
    assert abs(float(loss_r) - float(loss_t)) <= TOL * abs(float(loss_r))
    _close_by_leaf(_np_tree(grads_r), grads_t)
    if cfg.moe is not None:
        assert float(metrics["router_aux"]) > 0

    step_r = jax.jit(rtr.make_train_step(cfg_r, opt_r))
    step_t = ttr.make_train_step(cfg, opt_t)
    s_r, s_t = rtr.init_opt_state(opt_r, params_r), \
        ttr.init_opt_state(opt_t, params)
    p_r, p_t = params_r, params
    for i, b in enumerate(batches):
        lr = rtr.wsd(i, warmup=1, total=3)
        p_r, s_r, m_r = step_r(p_r, s_r, _jx(b), lr)
        p_t, s_t, m_t = step_t(p_t, s_t, _th(b), ttr.wsd(i, warmup=1,
                                                          total=3))
        for key in ("loss", "ce", "router_aux", "grad_norm"):
            a, c = float(m_r[key]), float(m_t[key])
            assert abs(a - c) <= TOL * max(abs(a), 1e-30), (i, key)
    _close_by_leaf(_np_tree(p_r), p_t)
    assert not any(x.requires_grad for _, x in _paths(p_t))


# ---------------------------------------------------------------------------
# the kernel wrappers refuse gradients
# ---------------------------------------------------------------------------


def _wrapper_calls():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)
    q4, kv4 = r(1, 8, 2, 64), r(1, 8, 1, 64)
    q3, cache = r(2, 2, 64), r(2, 16, 1, 64)
    pool, tables = r(4, 8, 1, 64), torch.tensor([[0, 1], [2, 3]],
                                                dtype=torch.int32)
    lengths = torch.tensor([5, 16], dtype=torch.int32)
    x = r(1, 4, 8)
    return {
        "flash_attention": (flash_attention_cuda, (q4, kv4, kv4.clone())),
        "decode_attention": (decode_attention_cuda,
                             (q3, cache, cache.clone(), lengths)),
        "paged_decode_attention": (paged_decode_attention_cuda,
                                   (q3, pool, pool.clone(), tables, lengths)),
        "mamba_scan": (mamba_scan_cuda,
                       (x, r(1, 4, 8).abs(), r(1, 4, 8), r(1, 4, 8),
                        -r(8, 8).abs(), r(8), r(1, 8, 8))),
    }


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "paged_decode_attention", "mamba_scan"])
def test_kernel_wrapper_refuses_grad(name):
    fn, args = _wrapper_calls()[name]
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*args)
    with torch.no_grad():       # grad mode off: serving as before
        fn(*args)
    assert read_counts()[name]["plain_calls"] == 1
    reset_counts()


def test_forward_train_reaches_no_kernel(models):
    """With every leaf requiring grad, as in a step: any kernel wrapper on
    the path would raise, and none counts a call."""
    for arch in ("minicpm-2b", "jamba-1.5-large-398b"):
        _, cfg, _, params = models[arch]
        live = torch.utils._pytree.tree_map(
            lambda x: x.detach().requires_grad_(True), params)
        logits, _ = tm.forward_train(cfg, live, _th(_batch_np(cfg)))
        assert logits.requires_grad
    assert all(c == {"launches": 0, "plain_calls": 0}
               for c in read_counts().values())


@pytest.mark.parametrize("kernel", ["flash_attention", "mamba_scan"])
def test_reference_kernels_have_no_gradient(kernel):
    """A fault of the reference, pinned: ``jax.grad`` through its Pallas
    kernels (interpret mode) raises, so its train step on a TPU fails
    wherever the dispatch takes them (S % 128 == 0 for attention, S % 256
    for the scan)."""
    rng = np.random.default_rng(0)
    n = lambda *s: jnp.asarray(rng.standard_normal(s).astype(np.float32))
    if kernel == "flash_attention":
        q, k, v = n(1, 128, 2, 64), n(1, 128, 1, 64), n(1, 128, 1, 64)
        f = lambda q: flash_attention_pallas(q, k, v, interpret=True).sum()
        arg = q
    else:
        x, dt = n(1, 256, 128), jnp.abs(n(1, 256, 128)) * 0.1
        b, c, a = n(1, 256, 8), n(1, 256, 8), -jnp.abs(n(128, 8))
        d, h0 = n(128), n(1, 128, 8)
        f = lambda x: mamba_scan_pallas(x, dt, b, c, a, d, h0,
                                        interpret=True)[0].sum()
        arg = x
    with pytest.raises(AssertionError):
        jax.grad(f)(arg)


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------


def test_launch_train_on_cpu(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt.npz")
    rc = ttrain.main(["--arch", "minicpm-2b", "--steps", "10", "--batch",
                      "4", "--seq", "32", "--device", "cpu", "--ckpt",
                      ckpt])
    out = capsys.readouterr().out
    assert rc == 0, out
    first, last = out.strip().splitlines()[-1].split()[1::2]
    assert float(last) < float(first)
    assert "step    0 loss=" in out and os.path.exists(ckpt)


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "internvl2-1b"])
def test_launch_train_feeds_modality_payloads(arch, capsys):
    assert ttrain.main(["--arch", arch, "--steps", "3", "--batch", "2",
                        "--seq", "16", "--device", "cpu"]) in (0, 1)
    cfg = tcfg.get_config(arch).reduced()
    (name, x), = ttrain.modality_extras(cfg, 2, "cpu").items()
    assert x.shape[:2] == ((2, 32) if cfg.is_encoder_decoder
                           else (2, cfg.frontend.num_prefix_tokens))


def test_train_small_on_cpu(tmp_path, capsys):
    assert ttrain_small.main(["--steps", "6", "--batch", "2", "--seq", "16",
                              "--device", "cpu", "--ckpt",
                              str(tmp_path / "small.npz")]) == 0
    assert "saved+restored" in capsys.readouterr().out


def test_launchers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (ttrain.main, ttrain_small.main):
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--steps", "1"])
