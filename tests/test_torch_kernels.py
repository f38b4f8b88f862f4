"""The port's attention kernels held against the JAX package's.

Each plain PyTorch version (what a kernel wrapper runs on CPU tensors) is
compared with the Pallas TPU kernel run in interpret mode on the same
inputs, made with numpy from a seed.  Tolerance 1e-5 in f32: the two sum
in different orders.  The CUDA kernels themselves run only on the card;
``test_torch_cuda.py`` holds them against these plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.decode_attention import paged_decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.attention import flash_attention as repro_flash_jnp
from repro_torch.kernels import read_counts, reset_counts
from repro_torch.kernels.decode_attention import (
    paged_decode_attention_cuda, paged_decode_attention_torch)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_torch)

TOL = 1e-5

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


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas(shape, window, causal):
    B, S, H, KVH, hd = shape
    rng = np.random.default_rng(sum(shape))
    q, k, v = (_randn(rng, (B, S, H, hd)), _randn(rng, (B, S, KVH, hd)),
               _randn(rng, (B, S, KVH, hd)))
    exp = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 window=window, block_q=64, block_k=64,
                                 interpret=True)
    out = flash_attention_torch(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                window=window)
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
