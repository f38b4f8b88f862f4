"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device (the kernels have
no CPU mode).  This file imports neither JAX nor the JAX package, so it
runs on a machine with the card alone:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: 1e-4 max abs in f32 and 2e-2 in bf16; the kernel and the
plain version sum in different orders.
"""
import pytest
import torch

from repro_torch.kernels.decode_attention import (
    paged_decode_attention_cuda, paged_decode_attention_torch)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_torch)


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
