"""The port's kernels held against the JAX package's.

Each plain PyTorch version (what a kernel wrapper runs on CPU tensors) is
compared with the Pallas TPU kernel run in interpret mode on the same
inputs, made with numpy from a seed.  Tolerance 1e-5 in f32 for attention:
the two sum in different orders, and f32 rounding over a 64- or 128-term
dot and a softmax over at most 512 keys stays near 1e-6 on outputs of
order 1.  Where a float64 numpy reference is at hand, each side is held to
it on its own, so a failure names the side that moved.  The selective scan
gets 1e-4, the JAX package's own kernel-test tolerance: its recurrence
carries rounding over every time step.  The CUDA kernels themselves run only on the card;
``test_torch_cuda.py`` holds them against these plain versions there.
"""
import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.decode_attention import (decode_attention_pallas,
                                            paged_decode_attention_pallas)
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.mamba_scan import mamba_scan_pallas
from repro.models.attention import flash_attention as repro_flash_jnp
from repro_torch.kernels import KERNELS, read_counts, reset_counts
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (
    NEG_INF, PAGED_HEADS_PER_BLOCK, _chunk, _paged_scratch,
    _paged_scratch_bufs, decode_attention_cuda, decode_attention_torch,
    paged_decode_attention_cuda, paged_decode_attention_torch, split_plan)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_torch)
from repro_torch.kernels.mamba_scan import mamba_scan_cuda, mamba_scan_torch

TOL = 1e-5
LOG2E = 1.4426950408889634
SCAN_TOL = 1e-4

FLASH_SHAPES = [
    # (B, S, H, KVH, hd): the JAX package's kernel-test shapes
    (1, 128, 4, 4, 64),
    (2, 256, 8, 2, 64),
    (1, 256, 8, 1, 128),
    (2, 128, 16, 4, 128),
]


def _randn(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def _flash_ref64(q, k, v, causal, window):
    """Float64 numpy attention: q (B, Sq, H, hd), k/v (B, Skv, KVH, hd)."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    kk = np.repeat(k.astype(np.float64), G, axis=2)
    vv = np.repeat(v.astype(np.float64), G, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) / np.sqrt(hd)
    pos = np.arange(S)
    mask = np.ones((S, S), bool)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= pos[:, None] - pos[None, :] < window
    s = np.where(mask, s, -np.inf)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, vv)


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas(shape, window, causal):
    """Each side against a float64 reference, then against each other."""
    B, S, H, KVH, hd = shape
    rng = np.random.default_rng(sum(shape))
    q, k, v = (_randn(rng, (B, S, H, hd)), _randn(rng, (B, S, KVH, hd)),
               _randn(rng, (B, S, KVH, hd)))
    ref = _flash_ref64(q, k, v, causal, window)
    exp = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 window=window, block_q=64, block_k=64,
                                 interpret=True)
    out = flash_attention_torch(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                window=window)
    assert _err(exp, ref) < TOL, "the Pallas kernel moved from float64"
    assert _err(out, ref) < TOL, "the plain version moved from float64"
    assert _err(out, exp) < TOL


@pytest.mark.parametrize("window", [None, 64])
def test_flash_plain_ragged_matches_ref(window):
    """Sq = 200 is no multiple of any tile: the kernel's contract (any
    length) held against the JAX package's oracle."""
    rng = np.random.default_rng(7)
    q, k, v = (_randn(rng, (2, 200, 8, 64)), _randn(rng, (2, 200, 2, 64)),
               _randn(rng, (2, 200, 2, 64)))
    exp = ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, window=window)
    out = flash_attention_cuda(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True,
                               window=window)
    assert _err(out, exp) < TOL


def test_flash_plain_q_offset_matches_chunked_jnp():
    """q_offset (chunk resume): a 48-row query chunk at absolute offset 80
    against 128 keys, as the JAX package's chunked path computes it."""
    rng = np.random.default_rng(8)
    q = _randn(rng, (1, 48, 4, 64))
    k, v = _randn(rng, (1, 128, 2, 64)), _randn(rng, (1, 128, 2, 64))
    exp = repro_flash_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, scale=0.125, window=32, q_offset=80)
    out = flash_attention_torch(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True, scale=0.125,
                                window=32, q_offset=80)
    assert _err(out, exp) < TOL


PAGED_SHAPES = [
    # (H, KVH, hd, W, block_lines)
    (8, 2, 64, 256, 16),
    (24, 2, 128, 128, 16),     # the full-width head layout, G = 12
    (8, 1, 128, 256, 64),
]


@pytest.mark.parametrize("shape", PAGED_SHAPES)
def test_paged_plain_matches_pallas(shape):
    """Shuffled pool placement; lengths 0, 1, partial and full."""
    H, KVH, hd, W, bl = shape
    B, nb = 4, W // bl
    rng = np.random.default_rng(H + W)
    q = _randn(rng, (B, 1, H, hd))
    num_blocks = 2 * B * nb
    tables = rng.permutation(num_blocks)[:B * nb].reshape(B, nb)
    tables = tables.astype(np.int32)
    k_pool = _randn(rng, (num_blocks, bl, KVH, hd))
    v_pool = _randn(rng, (num_blocks, bl, KVH, hd))
    lengths = np.asarray([0, 1, W // 2 + 3, W], np.int32)
    exp = paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(tables), jnp.asarray(lengths), interpret=True)
    out = paged_decode_attention_torch(
        torch.from_numpy(q), torch.from_numpy(k_pool),
        torch.from_numpy(v_pool), torch.from_numpy(tables),
        torch.from_numpy(lengths))
    assert _err(out, exp) < TOL
    assert float(out[0].abs().max()) == 0.0, "a length-0 row must give 0"


@pytest.mark.parametrize("bad", ["negative", "past_pool"])
def test_paged_plain_masks_out_of_pool_entries(bad):
    """The kernel's contract for bad tables, held by the plain version too:
    an entry outside the pool masks its lines, a length past the table is
    clamped to it, and a row with no line left gives 0."""
    H, KVH, hd, bl, nb = 4, 2, 64, 8, 6
    G = H // KVH
    rng = np.random.default_rng(11)
    q = _randn(rng, (2, H, hd))
    k_pool = _randn(rng, (nb, bl, KVH, hd))
    v_pool = _randn(rng, (nb, bl, KVH, hd))
    b = -1 if bad == "negative" else nb
    tables = np.asarray([[4, b, 1], [b, b, b]], np.int32)
    lengths = np.asarray([3 * bl + 5, 2 * bl], np.int32)
    out = paged_decode_attention_torch(
        torch.from_numpy(q), torch.from_numpy(k_pool),
        torch.from_numpy(v_pool), torch.from_numpy(tables),
        torch.from_numpy(lengths)).numpy()
    kk = np.concatenate([k_pool[4], k_pool[1]]).astype(np.float64)
    vv = np.concatenate([v_pool[4], v_pool[1]]).astype(np.float64)
    exp = np.zeros((H, hd))
    for h in range(H):
        sc = kk[:, h // G] @ q[0, h] / np.sqrt(hd)
        pr = np.exp(sc - sc.max())
        exp[h] = (pr / pr.sum()) @ vv[:, h // G]
    assert _err(out[0], exp) < TOL
    assert float(np.abs(out[1]).max()) == 0.0


def test_paged_plain_reads_store_block_tables():
    """Through a live store leaf and its slot-affine tables
    (``pool_view``, ``decode_block_tables``) the paged plain version equals
    the JAX package's dense decode kernel on the contiguous cache."""
    from repro.kernels.decode_attention import decode_attention_pallas
    from repro_torch.configs import get_config
    from repro_torch.kvstore import PagedStore
    cfg = get_config("starcoder2-3b").reduced()
    store = PagedStore(cfg, num_slots=4, kv_capacity=64, block_lines=16,
                       device="cpu")
    rids, slots, lengths = [11, 22], [1, 3], [20, 37]
    for rid, slot, n in zip(rids, slots, lengths):
        store.alloc(rid, slot, lines=n)
    shape = tuple(store.state["layers"][0]["p0"]["k"][0].shape)
    rng = np.random.default_rng(5)
    kc, vc = _randn(rng, shape), _randn(rng, shape)
    q = _randn(rng, (shape[0], 1, cfg.num_heads, cfg.head_dim))
    dense_lens = np.zeros((shape[0],), np.int32)
    dense_lens[slots] = lengths
    exp = decode_attention_pallas(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(dense_lens),
                                  block_k=16, interpret=True)
    tables = torch.from_numpy(store.decode_block_tables(rids, 4))
    out = paged_decode_attention_torch(
        torch.from_numpy(q[slots]), store.pool_view(torch.from_numpy(kc)),
        store.pool_view(torch.from_numpy(vc)), tables,
        torch.tensor(lengths, dtype=torch.int32))
    assert _err(out, np.asarray(exp)[slots]) < TOL


def test_wrappers_take_plain_version_on_cpu_only():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(_randn(rng, (1, 32, 4, 64)))
    kv = torch.from_numpy(_randn(rng, (1, 32, 2, 64)))
    reset_counts()
    flash_attention_cuda(q, kv, kv)
    pq = torch.from_numpy(_randn(rng, (2, 4, 64)))
    pool = torch.from_numpy(_randn(rng, (4, 16, 2, 64)))
    tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    lengths = torch.tensor([5, 32], dtype=torch.int32)
    paged_decode_attention_cuda(pq, pool, pool, tables, lengths)
    counts = read_counts()
    assert counts["flash_attention"] == {"launches": 0, "plain_calls": 1}
    assert counts["paged_decode_attention"] == {"launches": 0,
                                                "plain_calls": 1}
    # a device with no kernel and no plain path raises, never falls back
    with pytest.raises(ValueError):
        flash_attention_cuda(q.to("meta"), kv.to("meta"), kv.to("meta"))
    with pytest.raises(ValueError):
        paged_decode_attention_cuda(pq.to("meta"), pool.to("meta"),
                                    pool.to("meta"), tables.to("meta"),
                                    lengths.to("meta"))


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "contiguous", "heads"])
def test_flash_wrapper_rejects_what_kernel_does_not_take(bad):
    q = torch.zeros((1, 16, 4, 64))
    k = torch.zeros((1, 16, 2, 64))
    if bad == "dtype":
        q, k = q.half(), k.half()
    elif bad == "head_dim":
        q, k = torch.zeros((1, 16, 4, 32)), torch.zeros((1, 16, 2, 32))
    elif bad == "contiguous":
        q = torch.zeros((1, 4, 16, 64)).transpose(1, 2)
    else:
        q = torch.zeros((1, 16, 3, 64))
    with pytest.raises((TypeError, ValueError)):
        flash_attention_cuda(q, k, k)


def test_paged_wrapper_rejects_int64_tables():
    q = torch.zeros((1, 4, 64))
    pool = torch.zeros((2, 16, 2, 64))
    with pytest.raises(TypeError):
        paged_decode_attention_cuda(q, pool, pool,
                                    torch.zeros((1, 2), dtype=torch.int64),
                                    torch.ones((1,), dtype=torch.int32))


# ---------------------------------------------------------------------------
# dense decode attention
# ---------------------------------------------------------------------------

DENSE_SHAPES = [
    # (B, H, KVH, hd, W)
    (4, 8, 2, 64, 256),
    (4, 64, 8, 128, 128),      # Jamba's head layout, G = 8
    (4, 24, 2, 128, 512),      # G = 12
]


def _dense_inputs(shape):
    B, H, KVH, hd, W = shape
    rng = np.random.default_rng(B + H + W)
    q = _randn(rng, (B, 1, H, hd))
    kc, vc = _randn(rng, (B, W, KVH, hd)), _randn(rng, (B, W, KVH, hd))
    lengths = np.asarray([0, 1, W // 2 + 3, W], np.int32)
    return q, kc, vc, lengths


@pytest.mark.parametrize("shape", DENSE_SHAPES)
def test_dense_decode_plain_matches_pallas(shape):
    """Lengths 0, 1, partial and full (the whole window)."""
    q, kc, vc, lengths = _dense_inputs(shape)
    exp = decode_attention_pallas(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(lengths),
                                  block_k=64, interpret=True)
    out = decode_attention_torch(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc),
                                 torch.from_numpy(lengths))
    assert out.shape == exp.shape
    assert _err(out, exp) < TOL
    assert float(out[0].abs().max()) == 0.0, "a length-0 row must give 0"


@pytest.mark.parametrize("shape", DENSE_SHAPES)
def test_dense_decode_plain_matches_ref(shape):
    """Against the JAX package's oracle on the rows with a live line (its
    softmax over a length-0 row averages V where the kernels give 0)."""
    q, kc, vc, lengths = _dense_inputs(shape)
    exp = np.asarray(ref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lengths)))
    out = decode_attention_cuda(torch.from_numpy(q), torch.from_numpy(kc),
                                torch.from_numpy(vc),
                                torch.from_numpy(lengths)).numpy()
    assert _err(out[1:], exp[1:]) < TOL


def _split_merge_torch(q, k_cache, v_cache, lengths, splits):
    """The dense kernel's two passes in plain PyTorch.  Each request's
    lines are cut into spans of ``chunk`` lines as the kernel cuts them for
    ``splits``; each span gives an f32 partial per head (m in base 2, l,
    unnormalised acc), and the merge rescales them by ``exp2(m - max m)``.
    A span at or past a row's length gives the empty partial (m = NEG_INF,
    l = 0, acc = 0), which adds nothing."""
    q = q[:, 0]
    B, H, hd = q.shape
    W, KVH = k_cache.shape[1], k_cache.shape[2]
    chunk = _chunk(W, splits)
    qf = q.float().reshape(B, KVH, H // KVH, hd) * (LOG2E / np.sqrt(hd))
    s = torch.einsum("bkgd,bwkd->bkgw", qf, k_cache.float())
    valid = (torch.arange(W)[None] < lengths[:, None])[:, None, None, :]
    ms, ls, accs = [], [], []
    for lo in range(0, W, chunk):
        live = valid[..., lo:lo + chunk]
        sp = s[..., lo:lo + chunk].masked_fill(~live, NEG_INF)
        m = sp.amax(dim=-1)
        p = torch.exp2(sp - m[..., None]) * live
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bkgw,bwkd->bkgd", p,
                                 v_cache[:, lo:lo + chunk].float()))
    m = torch.stack(ms)
    w = torch.exp2(m - m.amax(dim=0))
    l = (torch.stack(ls) * w).sum(dim=0)
    o = (torch.stack(accs) * w[..., None]).sum(dim=0)
    o = (o / l.clamp_min(1e-30)[..., None]).reshape(B, H, hd).to(q.dtype)
    return o[:, None]


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("shape", DENSE_SHAPES)
def test_dense_split_merge_matches_plain_and_pallas(shape, splits):
    """The dense kernel's split-KV arithmetic in plain PyTorch equals the
    plain version and the Pallas kernel.  Lengths 0, 1, W / 2 + 3 and W:
    the length-0 row merges only empty partials and must give exactly 0,
    and with 3 or 8 splits the short rows leave whole splits past their
    length."""
    q, kc, vc, lengths = _dense_inputs(shape)
    exp = decode_attention_pallas(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(lengths),
                                  block_k=64, interpret=True)
    args = [torch.from_numpy(a) for a in (q, kc, vc, lengths)]
    out = _split_merge_torch(*args, splits)
    assert _err(out, decode_attention_torch(*args)) < TOL
    assert _err(out, exp) < TOL
    assert float(out[0].abs().max()) == 0.0, "a length-0 row must give 0"


@pytest.mark.parametrize("B,KVH,G,W", [(8, 8, 8, 1024), (1, 8, 8, 1024),
                                       (8, 2, 12, 512), (4, 2, 4, 16),
                                       (64, 8, 8, 1024), (2, 1, 4, 0)])
def test_split_plan_fills_the_card(B, KVH, G, W):
    """Enough blocks for two per SM where W allows two 64-line tiles per
    block; spans of whole tiles that cover W, none of them wholly past W."""
    sms = 132
    splits, chunk = split_plan(B, KVH, G, W, sms)
    blocks = B * KVH * -(-G // 8) * splits
    assert chunk % 64 == 0 and splits >= 1
    assert splits * chunk >= W and (splits - 1) * chunk < max(W, 1)
    assert blocks >= min(2 * sms, B * KVH * -(-G // 8) * -(-W // 128))


@pytest.mark.parametrize("bad", ["dtype", "lengths_dtype", "batch",
                                 "head_dim"])
def test_dense_wrapper_rejects_what_kernel_does_not_take(bad):
    q = torch.zeros((2, 4, 64))
    kc = torch.zeros((2, 16, 2, 64))
    lengths = torch.ones((2,), dtype=torch.int32)
    if bad == "dtype":
        q, kc = q.half(), kc.half()
    elif bad == "lengths_dtype":
        lengths = lengths.long()
    elif bad == "batch":
        kc = torch.zeros((3, 16, 2, 64))
    else:
        q, kc = torch.zeros((2, 4, 32)), torch.zeros((2, 16, 2, 32))
    with pytest.raises((TypeError, ValueError)):
        decode_attention_cuda(q, kc, kc, lengths)


# ---------------------------------------------------------------------------
# the paged kernel's split-KV design
# ---------------------------------------------------------------------------


def _paged_split_merge_torch(q, k_pool, v_pool, tables, lengths, splits,
                             heads_per_block=PAGED_HEADS_PER_BLOCK):
    """The paged kernel's arithmetic in plain PyTorch.  Each line's pool
    row is worked out as the kernel does (-1 past the row's length or for
    a table entry outside the pool, its K/V then zero-filled and its score
    masked).  Each request's lines are cut into spans of ``chunk`` lines as
    the kernel cuts them for ``splits``; only the ``ceil(len / chunk)``
    spans that start below the length run, per (KV head, group of
    ``heads_per_block`` query heads), each giving a base-2 partial (m, l,
    unnormalised acc).  One live span is the output; more are merged,
    rescaled by ``exp2(m - max m)``, skipping partials that saw no line."""
    B, H, hd = q.shape
    nb, bl, KVH = k_pool.shape[:3]
    W = tables.shape[1] * bl
    G = H // KVH
    chunk = _chunk(W, splits)
    lens = lengths.long().clamp(0, W)
    pos = torch.arange(W)
    blk = tables.long()[:, pos // bl]
    ok = (pos[None] < lens[:, None]) & (blk >= 0) & (blk < nb)
    rows = torch.where(ok, blk * bl + pos % bl, -1)

    def gather(pool):
        flat = pool.reshape(nb * bl, KVH, hd).float()
        return flat[rows.clamp_min(0)] * ok[..., None, None]

    kc, vc = gather(k_pool), gather(v_pool)
    scale_log2 = LOG2E / np.sqrt(hd)
    out = torch.zeros(B * H, hd)
    for b in range(B):
        n_live = max(1, -(-int(lens[b]) // chunk))
        for kvh in range(KVH):
            for lo_h in range(0, G, heads_per_block):
                heads = [kvh * G + gh
                         for gh in range(lo_h, min(G, lo_h + heads_per_block))]
                qh = q[b, heads].float()
                parts = []
                for split in range(n_live):
                    lo = split * chunk
                    hi = min(lo + chunk, int(lens[b]))
                    live = ok[b, lo:hi]
                    sc = (qh @ kc[b, lo:hi, kvh].T) * scale_log2
                    sc = sc.masked_fill(~live, NEG_INF)
                    m = (sc.amax(dim=-1) if hi > lo
                         else torch.full((len(heads),), NEG_INF))
                    pr = torch.exp2(sc - m[:, None]) * live
                    l = pr.sum(dim=-1)
                    parts.append((torch.where(l == 0, NEG_INF, m), l,
                                  pr @ vc[b, lo:hi, kvh]))
                if n_live == 1:
                    _, l, acc = parts[0]
                else:
                    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
                    w = [torch.where(l == 0, 0.0, torch.exp2(m - m_all))
                         for m, l, _ in parts]
                    l = sum(pl * wi for (_, pl, _), wi in zip(parts, w))
                    acc = sum(pa * wi[:, None]
                              for (_, _, pa), wi in zip(parts, w))
                out[[b * H + h for h in heads]] = (
                    acc / l.clamp_min(1e-30)[:, None])
    return out.reshape(B, H, hd).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _paged_case(block_lines, G):
    """Four requests over a shuffled pool, KVH 2, hd 64, W 256; lengths 0,
    1, W / 2 + 3 and W.  Returns the numpy inputs and the Pallas kernel's
    output (interpret mode), computed once per case."""
    KVH, hd, W, B = 2, 64, 256, 4
    mb = W // block_lines
    rng = np.random.default_rng(100 * block_lines + G)
    q = _randn(rng, (B, G * KVH, hd))
    nb = 2 * B * mb
    tables = rng.permutation(nb)[:B * mb].reshape(B, mb).astype(np.int32)
    k_pool = _randn(rng, (nb, block_lines, KVH, hd))
    v_pool = _randn(rng, (nb, block_lines, KVH, hd))
    lengths = np.asarray([0, 1, W // 2 + 3, W], np.int32)
    args = (q, k_pool, v_pool, tables, lengths)
    exp = paged_decode_attention_pallas(*map(jnp.asarray, args),
                                        interpret=True)
    return args, np.asarray(exp)


@pytest.mark.parametrize("G", [1, 4, 12, 20])
@pytest.mark.parametrize("block_lines", [8, 16, 32])
@pytest.mark.parametrize("splits", [1, 3, 8])
def test_paged_split_merge_matches_plain_and_pallas(splits, block_lines, G):
    """The paged kernel's split-KV arithmetic in plain PyTorch equals the
    plain version and the Pallas kernel.  Spans of 64-line tiles cross
    pool blocks of 8, 16 and 32 lines; G 20 makes two head groups (16 +
    4); with 3 or 8 splits the short rows leave whole spans past their
    length, and the length-0 row must give exactly 0."""
    args, exp = _paged_case(block_lines, G)
    targs = [torch.from_numpy(a) for a in args]
    out = _paged_split_merge_torch(*targs, splits)
    assert _err(out, paged_decode_attention_torch(*targs)) < TOL
    assert _err(out, exp) < TOL
    assert float(out[0].abs().max()) == 0.0, "a length-0 row must give 0"


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("bad", ["negative", "past_pool"])
def test_paged_split_merge_masks_out_of_pool_entries(bad, splits):
    """The bad-table contract through the split arithmetic: the inputs of
    ``test_paged_plain_masks_out_of_pool_entries``, then a 192-line table
    whose bad entries fall in different spans, a row of bad entries only
    and a length past the table."""
    H, KVH, hd, bl, nb = 4, 2, 64, 8, 6
    rng = np.random.default_rng(11)
    q = _randn(rng, (2, H, hd))
    k_pool = _randn(rng, (nb, bl, KVH, hd))
    v_pool = _randn(rng, (nb, bl, KVH, hd))
    b = -1 if bad == "negative" else nb
    cases = [(q, k_pool, v_pool, np.asarray([[4, b, 1], [b, b, b]], np.int32),
              np.asarray([3 * bl + 5, 2 * bl], np.int32))]
    mb, nb2 = 24, 40
    b2 = -1 if bad == "negative" else nb2 + 3
    tables = rng.integers(0, nb2, (3, mb))
    tables[0, [2, 9, 17]] = b2
    tables[1] = b2
    cases.append((_randn(rng, (3, 24, hd)), _randn(rng, (nb2, bl, KVH, hd)),
                  _randn(rng, (nb2, bl, KVH, hd)), tables.astype(np.int32),
                  np.asarray([mb * bl, 100, mb * bl + 9], np.int32)))
    for args in cases:
        targs = [torch.from_numpy(a) for a in args]
        out = _paged_split_merge_torch(*targs, splits)
        assert _err(out, paged_decode_attention_torch(*targs)) < TOL
        assert float(out[1].abs().max()) == 0.0


@pytest.mark.parametrize("B,KVH,G,W", [
    (6, 2, 12, 512), (1, 2, 12, 512), (8, 2, 12, 512), (1, 8, 1, 4096),
    (4, 2, 20, 256), (64, 8, 8, 1024), (2, 1, 4, 0), (1, 2, 12, 100)])
def test_paged_split_plan_fills_the_card(B, KVH, G, W):
    """Spans of whole 64-line tiles that cover W, none wholly past W, and
    at least two blocks per SM where W allows two tiles per block.  The
    plan reads no length: its inputs are the shapes and the SM count."""
    sms = 132
    splits, chunk = split_plan(B, KVH, G, W, sms, PAGED_HEADS_PER_BLOCK)
    rows = B * KVH * -(-G // PAGED_HEADS_PER_BLOCK)
    assert chunk % 64 == 0 and splits >= 1
    assert splits * chunk >= W and (splits - 1) * chunk < max(W, 1)
    assert rows * splits >= min(2 * sms, rows * -(-W // 128))
    assert list(inspect.signature(split_plan).parameters) == [
        "B", "KVH", "G", "W", "sm_count", "heads_per_block"]


def test_paged_scratch_is_kept_per_device_and_stream():
    """A call allocates no scratch: the same buffers come back for a
    shape that fits, they grow for one that does not, and a new stream
    gets its own.  Counters are zero when allocated."""
    dev = torch.device("cpu")
    try:
        first = _paged_scratch(dev, -1, 48, 128, 12)
        assert [t.numel() for t in first] == [96, 48 * 128, 12]
        assert not first[2].any()
        again = _paged_scratch(dev, -1, 24, 64, 4)
        assert all(a is b for a, b in zip(first, again))
        grown = _paged_scratch(dev, -1, 96, 64, 12)
        assert [t.numel() for t in grown] == [192, 48 * 128, 12]
        other = _paged_scratch(dev, -2, 24, 64, 4)
        assert all(a is not b for a, b in zip(grown, other))
    finally:
        _paged_scratch_bufs.pop((dev, -1), None)
        _paged_scratch_bufs.pop((dev, -2), None)


# ---------------------------------------------------------------------------
# selective scan
# ---------------------------------------------------------------------------


def _scan_inputs(seed, B, S, C, N):
    """The JAX package's kernel-test distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    softplus = lambda v: np.log1p(np.exp(v))       # noqa: E731
    return (
        _randn(rng, (B, S, C)),
        softplus(_randn(rng, (B, S, C)) - 1.0).astype(np.float32),
        _randn(rng, (B, S, N)),
        _randn(rng, (B, S, N)),
        -np.exp(_randn(rng, (C, N)) * 0.5).astype(np.float32),
        _randn(rng, (C,)),
        (_randn(rng, (B, C, N)) * 0.1).astype(np.float32),
    )


@pytest.mark.parametrize("shape", [
    # (B, S, C, N, c_blk, t_blk): the JAX package's scan-kernel sweep
    (1, 64, 32, 16, 16, 32),
    (2, 128, 64, 16, 32, 64),
    (1, 96, 48, 8, 48, 32),
])
def test_scan_plain_matches_pallas_and_ref(shape):
    """Nonzero h0 (a resumed state) in every case."""
    B, S, C, N, cb, tb = shape
    args = _scan_inputs(sum(shape), B, S, C, N)
    y_p, h_p = mamba_scan_pallas(*map(jnp.asarray, args), channel_blk=cb,
                                 time_blk=tb, interpret=True)
    y_r, h_r = ref.mamba_scan_ref(*map(jnp.asarray, args))
    y, h = mamba_scan_torch(*map(torch.from_numpy, args))
    for exp_y, exp_h in ((y_p, h_p), (y_r, h_r)):
        assert _err(y, exp_y) < SCAN_TOL
        assert _err(h, exp_h) < SCAN_TOL


def _scan_lanes_torch(x, dt, b_ssm, c_ssm, a, d, h0):
    """The scan kernel's arithmetic in plain PyTorch, in f32: exp(dt * A)
    as exp2(dt * (A * log2 e)) with A scaled once, each of a channel's 4
    lanes summing its N / 4 states in order, and the 4 lanes' parts added
    as the kernel adds them, (p0 + p2) + (p1 + p3), before D * x_t."""
    B, S, C = x.shape
    N = a.shape[1]
    a2 = a * np.float32(LOG2E)
    h = h0.clone()
    ys = []
    for t in range(S):
        h = (torch.exp2(dt[:, t, :, None] * a2) * h
             + (dt[:, t] * x[:, t])[..., None] * b_ssm[:, t, None, :])
        prod = (h * c_ssm[:, t, None, :]).reshape(B, C, 4, N // 4)
        part = prod[..., 0]
        for s in range(1, N // 4):
            part = part + prod[..., s]
        acc = (part[..., 0] + part[..., 2]) + (part[..., 1] + part[..., 3])
        ys.append(acc + d * x[:, t])
    return torch.stack(ys, 1), h


@pytest.mark.parametrize("shape", [
    # (B, S, C, N, c_blk, t_blk): the JAX package's scan-kernel sweep
    (1, 64, 32, 16, 16, 32),
    (2, 128, 64, 16, 32, 64),
    (1, 96, 48, 8, 48, 32),
])
def test_scan_lane_arithmetic_matches_plain_and_pallas(shape):
    """The kernel's exp2 with a pre-scaled A and its sum order over lanes
    stay within the scan's tolerance of the plain version and Pallas."""
    B, S, C, N, cb, tb = shape
    args = _scan_inputs(sum(shape) + 1, B, S, C, N)
    y_p, h_p = mamba_scan_pallas(*map(jnp.asarray, args), channel_blk=cb,
                                 time_blk=tb, interpret=True)
    y_t, h_t = mamba_scan_torch(*map(torch.from_numpy, args))
    y, h = _scan_lanes_torch(*map(torch.from_numpy, args))
    for exp_y, exp_h in ((y_p, h_p), (y_t, h_t)):
        assert _err(y, exp_y) < SCAN_TOL
        assert _err(h, exp_h) < SCAN_TOL


@pytest.mark.parametrize("S,C", [(100, 40), (1, 16), (0, 8)])
def test_scan_plain_any_length_matches_ref(S, C):
    """S = 100 is no multiple of the TPU kernel's time block and C = 40 of
    its channel block: the Hopper kernel's contract (any S, any C) held
    against the oracle.  S = 0 returns h0 as the final state."""
    args = _scan_inputs(S + C, 2, S, C, 16)
    y, h = mamba_scan_cuda(*map(torch.from_numpy, args))
    assert tuple(y.shape) == (2, S, C)
    if S:
        y_r, h_r = ref.mamba_scan_ref(*map(jnp.asarray, args))
        assert _err(y, y_r) < SCAN_TOL
        assert _err(h, h_r) < SCAN_TOL
    else:
        assert _err(h, args[-1]) == 0.0


@pytest.mark.parametrize("bad", ["dtype", "state_dim", "contiguous",
                                 "shape"])
def test_scan_wrapper_rejects_what_kernel_does_not_take(bad):
    args = [torch.from_numpy(a) for a in _scan_inputs(3, 1, 8, 16, 16)]
    if bad == "dtype":
        args[0] = args[0].to(torch.bfloat16)
    elif bad == "state_dim":
        args = [torch.from_numpy(a) for a in _scan_inputs(3, 1, 8, 16, 12)]
    elif bad == "contiguous":
        args[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    else:
        args[5] = args[5][:8]
    with pytest.raises((TypeError, ValueError)):
        mamba_scan_cuda(*args)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_registry_names_every_kernel_once():
    """Counts are keyed by kernel name (two kernels share the decode
    module); every kernel has a source to build."""
    names = ["flash_attention", "paged_decode_attention", "decode_attention",
             "mamba_scan"]
    assert sorted(KERNELS) == sorted(names)
    assert sorted(build.SOURCES) == sorted(names)
    for name, src in build.SOURCES.items():
        assert (build.CSRC / src).is_file(), name


def test_aligned16_copies_only_views_off_a_16_byte_boundary():
    """The kernels read 16-byte vectors and TMA boxes: a tensor whose data
    starts elsewhere is handed over as an aligned copy of equal values."""
    base = torch.arange(12, dtype=torch.float32)
    assert build.aligned16(base) is base
    view = base[1:]
    assert view.data_ptr() % 16 != 0
    copy = build.aligned16(view)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, view)


def test_new_wrappers_take_plain_version_on_cpu_only():
    rng = np.random.default_rng(2)
    reset_counts()
    q = torch.from_numpy(_randn(rng, (2, 4, 64)))
    kc = torch.from_numpy(_randn(rng, (2, 16, 2, 64)))
    lengths = torch.tensor([3, 16], dtype=torch.int32)
    decode_attention_cuda(q, kc, kc, lengths)
    scan = [torch.from_numpy(a) for a in _scan_inputs(4, 1, 8, 16, 16)]
    mamba_scan_cuda(*scan)
    counts = read_counts()
    assert counts["decode_attention"] == {"launches": 0, "plain_calls": 1}
    assert counts["mamba_scan"] == {"launches": 0, "plain_calls": 1}
    assert counts["paged_decode_attention"] == {"launches": 0,
                                                "plain_calls": 0}
    with pytest.raises(ValueError):
        decode_attention_cuda(q.to("meta"), kc.to("meta"), kc.to("meta"),
                              lengths.to("meta"))
    with pytest.raises(ValueError):
        mamba_scan_cuda(*[a.to("meta") for a in scan])
