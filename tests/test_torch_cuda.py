"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device (the kernels have
no CPU mode).  This file imports neither JAX nor the JAX package, so it
runs on a machine with the card alone:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: 1e-4 max abs in f32 and 2e-2 in bf16 for attention; the
kernel and the plain version sum in different orders.  The selective scan
(f32 only) is held to 1e-4 relative to the largest output.
"""
import pytest
import torch

from repro_torch.kernels.decode_attention import (
    PAGED_HEADS_PER_BLOCK, decode_attention_cuda, decode_attention_torch,
    paged_decode_attention_cuda, paged_decode_attention_torch, split_plan)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_torch)
from repro_torch.kernels.mamba_scan import mamba_scan_cuda, mamba_scan_torch


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("S,window", [(512, 4096), (200, None), (256, 64)])
def test_flash_kernel_matches_plain_on_card(dtype, tol, S, window):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(S)
    q = torch.randn((2, S, 24, 128), generator=g, device="cuda").to(dtype)
    k = torch.randn((2, S, 2, 128), generator=g, device="cuda").to(dtype)
    v = torch.randn((2, S, 2, 128), generator=g, device="cuda").to(dtype)
    out = flash_attention_cuda(q, k, v, causal=True, window=window)
    exp = flash_attention_torch(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert float((out.float() - exp.float()).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (B, Sq, Skv, H, KVH, hd, window, q_offset): the bf16 kernel's edges
    (2, 1, 1, 24, 2, 128, None, 0),        # one row, one key
    (2, 65, 65, 24, 2, 128, None, 0),      # one row past a warpgroup's 64
    (2, 129, 129, 24, 2, 128, None, 0),    # one row past the 128-row tile
    (1, 48, 128, 4, 2, 64, 32, 80),        # chunk resume: offset 80, window
    (2, 256, 256, 4, 1, 64, None, 0),      # hd 64
    (2, 300, 300, 24, 2, 128, 16, 0),      # a window inside one tile
])
def test_flash_bf16_edges_match_plain_on_card(case):
    _need_cuda()
    B, Sq, Skv, H, KVH, hd, window, q_offset = case
    g = torch.Generator(device="cuda").manual_seed(Sq + Skv)
    q = torch.randn((B, Sq, H, hd), generator=g, device="cuda").bfloat16()
    k = torch.randn((B, Skv, KVH, hd), generator=g, device="cuda").bfloat16()
    v = torch.randn((B, Skv, KVH, hd), generator=g, device="cuda").bfloat16()
    out = flash_attention_cuda(q, k, v, causal=True, window=window,
                               q_offset=q_offset)
    exp = flash_attention_torch(q, k, v, causal=True, window=window,
                                q_offset=q_offset)
    torch.cuda.synchronize()
    assert float((out.float() - exp.float()).abs().max()) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_paged_kernel_matches_plain_on_card(dtype, tol):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    B, H, KVH, hd, bl, mb = 8, 24, 2, 128, 16, 32
    q = torch.randn((B, H, hd), generator=g, device="cuda").to(dtype)
    k_pool = torch.randn((B * mb, bl, KVH, hd), generator=g,
                         device="cuda").to(dtype)
    v_pool = torch.randn((B * mb, bl, KVH, hd), generator=g,
                         device="cuda").to(dtype)
    tables = torch.randperm(B * mb, generator=g, device="cuda")
    tables = tables.reshape(B, mb).to(torch.int32)
    lengths = torch.tensor([0, 1, 15, 16, 17, 200, 511, 512],
                           dtype=torch.int32, device="cuda")
    out = paged_decode_attention_cuda(q, k_pool, v_pool, tables, lengths)
    exp = paged_decode_attention_torch(q, k_pool, v_pool, tables, lengths)
    torch.cuda.synchronize()
    assert float((out.float() - exp.float()).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_paged_kernel_bad_tables_match_plain_on_card(dtype, tol):
    """Out-of-pool table entries and lengths past the table: the kernel and
    the plain version share one contract (mask, clamp)."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(1)
    B, H, KVH, hd, bl, mb, nb = 3, 24, 2, 128, 16, 4, 12
    q = torch.randn((B, H, hd), generator=g, device="cuda").to(dtype)
    k_pool = torch.randn((nb, bl, KVH, hd), generator=g,
                         device="cuda").to(dtype)
    v_pool = torch.randn((nb, bl, KVH, hd), generator=g,
                         device="cuda").to(dtype)
    tables = torch.tensor([[3, -1, 7, nb], [nb, nb, nb, nb], [0, 1, 2, 5]],
                          dtype=torch.int32, device="cuda")
    lengths = torch.tensor([mb * bl, 20, mb * bl + 9], dtype=torch.int32,
                           device="cuda")
    out = paged_decode_attention_cuda(q, k_pool, v_pool, tables, lengths)
    exp = paged_decode_attention_torch(q, k_pool, v_pool, tables, lengths)
    torch.cuda.synchronize()
    assert float((out.float() - exp.float()).abs().max()) <= tol
    assert float(out[1].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("B,G,bl", [(1, 12, 16), (1, 12, 32), (6, 4, 16),
                                    (3, 1, 32), (8, 20, 16)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_paged_split_edges_match_plain_on_card(B, G, bl, dtype, tol):
    """Lengths 0, 1, on a span boundary and one past it, W - 1 and W (and
    one past the table, clamped), at B 1 (where splitting matters most)
    and larger B; G 12, 4, 1 and 20 (two head groups); 16- and 32-line
    pool blocks, so a 64-line tile spans several of them."""
    _need_cuda()
    KVH, hd, W = 2, 128, 512
    mb = W // bl
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits, chunk = split_plan(B, KVH, G, W, sms, PAGED_HEADS_PER_BLOCK)
    cand = [0, 1, chunk - 1, chunk, chunk + 1, 2 * chunk + 1, W - 1, W,
            W + 5]
    rows = ([[n] for n in (W, chunk, chunk + 1, 1, 0)] if B == 1
            else [[cand[(i * 2 + j) % len(cand)] for i in range(B)]
                  for j in range(2)])
    g = torch.Generator(device="cuda").manual_seed(B * 100 + G + bl)
    nb = 2 * B * mb
    for lengths in rows:
        q = torch.randn((B, G * KVH, hd), generator=g,
                        device="cuda").to(dtype)
        k_pool = torch.randn((nb, bl, KVH, hd), generator=g,
                             device="cuda").to(dtype)
        v_pool = torch.randn((nb, bl, KVH, hd), generator=g,
                             device="cuda").to(dtype)
        tables = torch.randperm(nb, generator=g, device="cuda")[:B * mb]
        tables = tables.reshape(B, mb).to(torch.int32)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        out = paged_decode_attention_cuda(q, k_pool, v_pool, tables, lens)
        exp = paged_decode_attention_torch(q, k_pool, v_pool, tables, lens)
        torch.cuda.synchronize()
        assert float((out.float() - exp.float()).abs().max()) <= tol, (
            lengths)
        for b in range(B):
            if lengths[b] == 0:
                assert float(out[b].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_dense_decode_kernel_matches_plain_on_card(dtype, tol):
    """Jamba's head layout (64 / 8, hd 128) with lengths 0, 1, ragged and
    the full window."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(2)
    B, H, KVH, hd, W = 6, 64, 8, 128, 1024
    q = torch.randn((B, 1, H, hd), generator=g, device="cuda").to(dtype)
    kc = torch.randn((B, W, KVH, hd), generator=g, device="cuda").to(dtype)
    vc = torch.randn((B, W, KVH, hd), generator=g, device="cuda").to(dtype)
    lengths = torch.tensor([0, 1, 63, 65, 700, W], dtype=torch.int32,
                           device="cuda")
    out = decode_attention_cuda(q, kc, vc, lengths)
    exp = decode_attention_torch(q, kc, vc, lengths)
    torch.cuda.synchronize()
    assert float((out.float() - exp.float()).abs().max()) <= tol
    assert float(out[0].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("B", [8, 1])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_dense_decode_split_edges_match_plain_on_card(B, dtype, tol):
    """Lengths 0, 1, one off each side of a split boundary and the full
    row of 1024, at B = 8 and at B = 1 (where the most splits run)."""
    _need_cuda()
    H, KVH, hd, W = 64, 8, 128, 1024
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits, chunk = split_plan(B, KVH, H // KVH, W, sms)
    assert B * KVH * splits >= min(2 * sms, B * KVH * W // 128)
    lens = [0, 1, chunk - 1, chunk, chunk + 1, W - chunk + 1, W - 1, W]
    rows = [lens] if B == 8 else [[n] for n in (W, chunk + 1, 0)]
    g = torch.Generator(device="cuda").manual_seed(B)
    for lengths in rows:
        q = torch.randn((B, 1, H, hd), generator=g, device="cuda").to(dtype)
        kc = torch.randn((B, W, KVH, hd), generator=g, device="cuda").to(dtype)
        vc = torch.randn((B, W, KVH, hd), generator=g, device="cuda").to(dtype)
        lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        out = decode_attention_cuda(q, kc, vc, lengths)
        exp = decode_attention_torch(q, kc, vc, lengths)
        torch.cuda.synchronize()
        assert float((out.float() - exp.float()).abs().max()) <= tol
        for b in range(B):
            if int(lengths[b]) == 0:
                assert float(out[b].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("S,C,N", [(512, 4096, 16), (300, 1000, 16),
                                   (37, 200, 8), (1, 16384, 16),
                                   (512, 1003, 8), (300, 1001, 16),
                                   (512, 16384, 8)])
def test_scan_kernel_matches_plain_on_card(S, C, N):
    """Any S, a ragged channel edge (C % 4 != 0 takes 4-byte copies),
    N 8 and 16, nonzero h0, B 2."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(S)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    B = 2
    args = (randn(B, S, C), torch.nn.functional.softplus(randn(B, S, C) - 1),
            randn(B, S, N), randn(B, S, N), -torch.exp(randn(C, N) * 0.5),
            randn(C), randn(B, C, N) * 0.1)
    y, h = mamba_scan_cuda(*args)
    y_p, h_p = mamba_scan_torch(*args)
    torch.cuda.synchronize()
    for a, b in ((y, y_p), (h, h_p)):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("C,N", [(1000, 16), (1003, 8)])
def test_scan_kernel_empty_sequence_returns_h0_on_card(C, N):
    """S = 0: y is empty and h_final holds h0's values exactly."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(C)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    args = (randn(2, 0, C), randn(2, 0, C), randn(2, 0, N), randn(2, 0, N),
            -torch.exp(randn(C, N) * 0.5), randn(C), randn(2, C, N))
    y, h = mamba_scan_cuda(*args)
    torch.cuda.synchronize()
    assert tuple(y.shape) == (2, 0, C)
    assert torch.equal(h, args[-1]) and h.data_ptr() != args[-1].data_ptr()
