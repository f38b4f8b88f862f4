"""Paged decode attention: the CUDA kernel
``csrc/paged_decode_attention.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py::
paged_decode_attention_pallas`` (body ``_paged_decode_kernel``).  Its
bound on the H100 is bytes: every live K and V line is read once per step.
The kernel reads only the ``ceil(len / 64)`` tiles of live lines through
the block table, and shares each tile among the G query heads of its KV
head; with one block per (request, KV head) it leaves most SMs idle at
small batch (see the source for the next step).

:func:`paged_decode_attention_cuda` is the entry point the model calls.
On CUDA tensors it launches the kernel or raises; on CPU tensors, and only
there, it runs :func:`paged_decode_attention_torch`.  ``counts`` records
kernel launches and plain-version calls.
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


def paged_decode_attention_torch(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 lengths: torch.Tensor, *,
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """Plain version: q (B, H, hd) or (B, 1, H, hd); pools (num_blocks,
    block_lines, KVH, hd); block_tables (B, max_blocks); lengths (B,).
    Line ``j`` of request ``b`` lives in pool block
    ``block_tables[b, j // block_lines]``; lines ``>= lengths[b]`` are
    masked, and a row of length 0 gives 0.

    The kernel's contract for bad tables, kept here too: lengths past
    ``max_blocks * block_lines`` are clamped to it, and a table entry
    outside ``[0, num_blocks)`` masks its lines (a row with no line left
    gives 0) rather than reading outside the pool."""
    counts["plain_calls"] += 1
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    B, H, hd = q.shape
    bl, KVH = k_pool.shape[1], k_pool.shape[2]
    G = H // KVH
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    tables = block_tables.long()
    in_pool = (tables >= 0) & (tables < k_pool.shape[0])
    tables = torch.where(in_pool, tables, 0)
    W = tables.shape[1] * bl
    kc = k_pool[tables].reshape(B, W, KVH, hd).float()
    vc = v_pool[tables].reshape(B, W, KVH, hd).float()
    qf = q.float().reshape(B, KVH, G, hd)
    s = torch.einsum("bkgd,bwkd->bkgw", qf, kc) * scale
    valid = ((torch.arange(W, device=q.device)[None]
              < lengths.to(q.device)[:, None])
             & in_pool.repeat_interleave(bl, dim=1))[:, None, None, :]
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * valid
    o = torch.einsum("bkgw,bwkd->bkgd", p, vc)
    o = o / p.sum(dim=-1).clamp_min(1e-30)[..., None]
    o = o.reshape(B, H, hd).to(q.dtype)
    return o[:, None] if squeeze else o


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load("paged_decode_attention").paged_decode_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k_pool, v_pool, block_tables, lengths):
    if q.dim() == 4 and q.shape[1] != 1:
        raise ValueError(f"4-d q must be (B, 1, H, hd), got {tuple(q.shape)}")
    if q.dim() not in (3, 4):
        raise ValueError(f"q must be (B, H, hd) or (B, 1, H, hd), got "
                         f"{tuple(q.shape)}")
    B, H, hd = q.shape[0], q.shape[-2], q.shape[-1]
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"pools must be (num_blocks, block_lines, KVH, hd); "
                         f"got {tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    if k_pool.shape[3] != hd or H % k_pool.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match pool "
                         f"{tuple(k_pool.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if (q.dtype not in DTYPE_CODES or k_pool.dtype != q.dtype
            or v_pool.dtype != q.dtype):
        raise TypeError(f"dtypes {q.dtype}, {k_pool.dtype}, {v_pool.dtype}: "
                        f"need one of {list(DTYPE_CODES)} for all three")
    if (block_tables.dim() != 2 or block_tables.shape[0] != B
            or lengths.shape != (B,)):
        raise ValueError(f"tables {tuple(block_tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {B}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    if not all(t.is_contiguous() for t in (q, k_pool, v_pool, block_tables,
                                           lengths)):
        raise ValueError("q, pools, tables and lengths must be contiguous")
    if len({t.device for t in (q, k_pool, v_pool, block_tables,
                               lengths)}) != 1:
        raise ValueError("q, pools, tables and lengths must share a device")


def paged_decode_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                block_tables: torch.Tensor,
                                lengths: torch.Tensor, *,
                                scale: Optional[float] = None
                                ) -> torch.Tensor:
    """The kernel's wrapper; same contract as
    :func:`paged_decode_attention_torch` for bf16 or f32, hd 64 or 128."""
    _check(q, k_pool, v_pool, block_tables, lengths)
    if q.device.type == "cpu":
        return paged_decode_attention_torch(q, k_pool, v_pool, block_tables,
                                            lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode kernel for device {q.device}")
    B, H, hd = q.shape[0], q.shape[-2], q.shape[-1]
    num_blocks, bl, KVH = k_pool.shape[:3]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, H, KVH, hd, num_blocks, bl, block_tables.shape[1],
            float(scale), DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"CUDA error {err}")
    counts["launches"] += 1
    return out
