"""Prefill attention: the CUDA kernel ``csrc/flash_attention.cu`` and its
plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py::
flash_attention_pallas`` (body ``_flash_kernel``).  At the main path's
prefill shape (B 8, S 512, H 24, KVH 2, hd 128, bf16) its bound on the
H100 is bytes, by a small margin: 54.5 MB of q, k, v and out move in
0.0163 ms, while the 1.29e10 causal flops take 0.0130 ms at the bf16
tensor-core rate (about 237 flops per byte, under the ~295 ridge).  With
G = 12 query heads per KV head, q and out carry most of the bytes.
Longer prompts tip it to operations, since flops grow as S^2 and bytes
as S.  The kernel skips KV tiles that the causal mask or the window hide
entirely and reuses each K/V tile for 64 query rows; it runs the products
on the CUDA cores in f32, so it stays far from either bound (see the
source for the next step).

:func:`flash_attention_cuda` is the entry point the model calls.  On a
CUDA tensor it launches the kernel or raises; on a CPU tensor, and only
there, it runs :func:`flash_attention_torch`.  ``counts`` records kernel
launches and plain-version calls, so a run can show which one ran.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)

#: ``launches`` of the CUDA kernel and ``plain_calls`` of the plain version
counts = {"launches": 0, "plain_calls": 0}


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: Optional[float] = None,
                          window: Optional[int] = None,
                          q_offset: int = 0) -> torch.Tensor:
    """Plain version: q (B, Sq, H, hd), k/v (B, Skv, KVH, hd) -> (B, Sq, H,
    hd) in q's dtype, scores and softmax in f32.  Query row i sits at
    absolute position ``q_offset + i``; a key at position j is visible when
    ``j <= q_offset + i`` (causal) and ``q_offset + i - j < window``."""
    counts["plain_calls"] += 1
    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf = q.float().reshape(B, Sq, KVH, G, hd)
    s = torch.einsum("bqkgd,bckd->bkgqc", qf, k.float()) * scale
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
    o = torch.einsum("bkgqc,bckd->bkgqd", p, v.float())
    o = o / p.sum(dim=-1).clamp_min(1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window, q_offset):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,Sq,H,hd) and k, v (B,Skv,KVH,hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)} (batch, head dim, or heads not "
                         f"a multiple of kv heads)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: need one "
                        f"of {list(DTYPE_CODES)} for all three")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         scale: Optional[float] = None,
                         window: Optional[int] = None,
                         q_offset: int = 0) -> torch.Tensor:
    """The kernel's wrapper; same contract as :func:`flash_attention_torch`
    for any Sq and Skv, bf16 or f32, hd 64 or 128."""
    _check(q, k, v, window, q_offset)
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal=causal, scale=scale,
                                     window=window, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, H, KVH, hd, float(scale), int(bool(causal)),
            int(window or 0), int(q_offset), DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    counts["launches"] += 1
    return out
