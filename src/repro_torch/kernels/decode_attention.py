"""Decode attention, one query token per request: two CUDA kernels and
their plain PyTorch versions.

* Paged (``csrc/paged_decode_attention.cu``) replaces the TPU kernel
  ``src/repro/kernels/decode_attention.py::paged_decode_attention_pallas``:
  K/V are read through per-request block tables.  It is split-KV in one
  launch: :func:`split_plan` spreads each request's lines over enough
  blocks to fill the card, each block gathers its lines through the
  table, and the last block of each row merges the row's partials.  The
  partials and the rows' ticket counters live in a scratch this module
  keeps per device and stream, so a call allocates nothing but its output;
  on a stream where CUDA graphs are captured it is never freed
  (:func:`hold_paged_scratch`).
* Dense (``csrc/decode_attention.cu``) replaces
  ``src/repro/kernels/decode_attention.py::decode_attention_pallas``: K/V
  are each request's rows of a dense ``(B, W, KVH, hd)`` cache.  Stacks
  that do not page (the hybrid Mamba+attention stack) decode through it.
  It is split-KV too: each block writes an f32
  partial (m, l, acc) per head to a scratch this wrapper allocates, and a
  second pass merges them.

Their bound on the H100 is bytes: every live K and V line is read once
per step, and each line is shared by the G query heads of its KV head.
Both run their products on the tensor cores in bf16 and on the CUDA cores
in f32.  ``PERF.md`` has each kernel's time on the card beside its bound,
its plain version and ``scaled_dot_product_attention``.

:func:`paged_decode_attention_cuda` and :func:`decode_attention_cuda` are
the entry points the model calls.  On CUDA tensors they launch the kernel
or raise; on CPU tensors, and only there, they run the plain version.
``counts`` records, per kernel, launches (one per wrapper call, the dense
kernel's two passes included) and plain-version calls.  On meta tensors
(the dry run) they return an empty output of the kernel's shape and
credit :func:`decode_attention_flops` over every line of the cache or the
table (a meta tensor carries no lengths) to the active counter of
:mod:`repro_torch.core.opcount`, launching nothing and counting nothing.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.core import opcount as count

NEG_INF = -1e30
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
#: both kernels' lines per split come in whole tiles of this many; a dense
#: block serves this many query heads and writes up to this many partials
#: per head and split (one in bf16, 128 / hd in f32)
TILE_LINES = 64
HEADS_PER_BLOCK = 8
PARTS_PER_SPLIT = 2
#: query heads per paged block in bf16 (the m16 rows of its MMA); 8 in f32
PAGED_HEADS_PER_BLOCK = 16

#: per kernel: ``launches`` of the CUDA kernel, ``plain_calls`` of the
#: plain version
counts = {"paged_decode_attention": {"launches": 0, "plain_calls": 0},
          "decode_attention": {"launches": 0, "plain_calls": 0}}
_paged_counts = counts["paged_decode_attention"]
_dense_counts = counts["decode_attention"]


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
    _paged_counts["plain_calls"] += 1
    B, hd = q.shape[0], q.shape[-1]
    bl, KVH = k_pool.shape[1], k_pool.shape[2]
    tables = block_tables.long()
    in_pool = (tables >= 0) & (tables < k_pool.shape[0])
    tables = torch.where(in_pool, tables, 0)
    W = tables.shape[1] * bl
    kc = k_pool[tables].reshape(B, W, KVH, hd)
    vc = v_pool[tables].reshape(B, W, KVH, hd)
    valid = _prefix(lengths, W) & in_pool.repeat_interleave(bl, dim=1)
    return _attend(q, kc, vc, valid, scale)


def _prefix(lengths: torch.Tensor, W: int) -> torch.Tensor:
    """(B, W) mask of each row's first ``lengths[b]`` lines."""
    return (torch.arange(W, device=lengths.device)[None]
            < lengths[:, None])


def _attend(q, kc, vc, valid, scale):
    """q (B, H, hd) or (B, 1, H, hd) against kc/vc (B, W, KVH, hd) where
    ``valid`` (B, W); scores and softmax in f32, and a row with no valid
    line gives 0 (l clamped at 1e-30, as in the kernels)."""
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    B, H, hd = q.shape
    KVH = kc.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf = q.float().reshape(B, KVH, H // KVH, hd)
    s = torch.einsum("bkgd,bwkd->bkgw", qf, kc.float()) * scale
    valid = valid.to(q.device)[:, None, None, :]
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * valid
    o = torch.einsum("bkgw,bwkd->bkgd", p, vc.float())
    o = o / p.sum(dim=-1).clamp_min(1e-30)[..., None]
    o = o.reshape(B, H, hd).to(q.dtype)
    return o[:, None] if squeeze else o


def _check_q(q):
    if q.dim() == 4 and q.shape[1] != 1:
        raise ValueError(f"4-d q must be (B, 1, H, hd), got {tuple(q.shape)}")
    if q.dim() not in (3, 4):
        raise ValueError(f"q must be (B, H, hd) or (B, 1, H, hd), got "
                         f"{tuple(q.shape)}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {HEAD_DIMS}")


def _check_kv(q, k, v, lengths, what, *extra):
    """k/v ``(rows, W, KVH, hd)`` against q; lengths int32 (B,); all of
    them (and ``extra``) contiguous and on one device."""
    H, hd = q.shape[-2], q.shape[-1]
    if k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{what} must be (., ., KVH, hd); got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match {what} "
                         f"{tuple(k.shape)}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: need one "
                        f"of {list(DTYPE_CODES)} for all three")
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    if lengths.shape != (q.shape[0],):
        raise ValueError(f"lengths {tuple(lengths.shape)} do not match batch "
                         f"{q.shape[0]}")
    ts = (q, k, v, lengths) + extra
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"q, {what}, lengths and tables must be contiguous")
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"q, {what}, lengths and tables must share a "
                         f"device")


def decode_attention_torch(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, lengths: torch.Tensor, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the dense kernel: q (B, H, hd) or (B, 1, H, hd)
    against caches (B, W, KVH, hd); lines ``>= lengths[b]`` are masked
    (lengths clamped to [0, W]), and a row of length 0 gives 0, as the TPU
    kernel does."""
    _dense_counts["plain_calls"] += 1
    return _attend(q, k_cache, v_cache, _prefix(lengths, k_cache.shape[1]),
                   scale)


def decode_attention_flops(H: int, hd: int, lines: int) -> int:
    """Either decode kernel's operations: both products over ``lines``
    live K/V lines summed over the batch, 2 * hd multiply-adds each, for
    every query head."""
    return 4 * H * hd * lines


@functools.lru_cache(maxsize=None)
def split_plan(B: int, KVH: int, G: int, W: int, sm_count: int,
               heads_per_block: int = HEADS_PER_BLOCK) -> Tuple[int, int]:
    """``(splits, chunk)`` of a split-KV decode kernel: each request's W
    lines go to ``splits`` blocks of ``chunk`` lines (whole 64-line tiles)
    per (KV head, group of ``heads_per_block`` query heads: 8 for the dense
    kernel, :data:`PAGED_HEADS_PER_BLOCK` for the paged one), enough that
    the grid holds at least ``2 * sm_count`` blocks where W allows two
    tiles per block; fewer lines per block cost more in partials to merge
    than they save.  Host-only: it reads no length, so choosing it costs
    no device sync."""
    blocks = B * KVH * -(-G // heads_per_block)
    want = max(1, min(-(-2 * sm_count // blocks), -(-W // (2 * TILE_LINES))))
    chunk = _chunk(W, want)
    return max(1, -(-W // chunk)), chunk


def _chunk(W: int, splits: int) -> int:
    """Lines per split: W / splits rounded down to whole tiles, so that the
    rounding never leaves fewer splits than asked for."""
    return max(TILE_LINES, -(-W // splits) // TILE_LINES * TILE_LINES)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _dense_kernel():
    fn = build.load("decode_attention").decode_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, lengths: torch.Tensor, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The dense kernel's wrapper; same contract as
    :func:`decode_attention_torch` for bf16 or f32, hd 64 or 128.  Raises
    on inputs that require grad (:func:`build.refuse_grad`)."""
    _check_q(q)
    _check_kv(q, k_cache, v_cache, lengths, "caches")
    build.refuse_grad("decode_attention", q, k_cache, v_cache)
    if k_cache.shape[0] != q.shape[0]:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not match batch "
                         f"{q.shape[0]}")
    if q.device.type == "cpu":
        return decode_attention_torch(q, k_cache, v_cache, lengths,
                                      scale=scale)
    if q.is_meta:
        count.credit("kernel:decode_attention", decode_attention_flops(
            q.shape[-2], q.shape[-1], q.shape[0] * k_cache.shape[1]))
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"no decode kernel for device {q.device}")
    B, H, hd = q.shape[0], q.shape[-2], q.shape[-1]
    W, KVH = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    splits, chunk = split_plan(B, KVH, H // KVH, W,
                               _sm_count(q.device.index or 0))
    parts = splits * PARTS_PER_SPLIT
    q, k_cache, v_cache = (build.aligned16(t) for t in (q, k_cache, v_cache))
    out = torch.empty_like(q)
    part_ml = torch.empty((B, H, parts, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((B, H, parts, hd), dtype=torch.float32,
                           device=q.device)
    with torch.cuda.device(q.device):
        err = _dense_kernel()(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), part_ml.data_ptr(),
            part_acc.data_ptr(), B, H, KVH, hd, W, splits, chunk,
            float(scale), DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    _dense_counts["launches"] += 1
    return out


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load("paged_decode_attention").paged_decode_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


#: (device, stream) -> (part_ml, part_acc, counters) of the paged kernel;
#: launches on one stream run in order, so they can share one scratch
_paged_scratch_bufs: Dict[tuple, Tuple[torch.Tensor, ...]] = {}
#: (device, stream) -> the scratches it outgrew, for the streams of
#: :func:`hold_paged_scratch`
_paged_scratch_held: Dict[tuple, List[Tuple[torch.Tensor, ...]]] = {}


def hold_paged_scratch(stream: torch.cuda.Stream) -> None:
    """Never free a paged-kernel scratch of ``stream``, nor one it
    outgrows: a CUDA graph captured on it holds the addresses of the
    scratch its calls found there."""
    _paged_scratch_held.setdefault((stream.device, stream.cuda_stream), [])


def _paged_scratch(device: torch.device, stream: int, n_part: int,
                   hd: int, n_counters: int) -> Tuple[torch.Tensor, ...]:
    """The paged kernel's f32 partials (``n_part`` rows of (m, l) and of
    ``hd`` accumulators) and its int32 ticket counters, kept per device and
    stream and grown when a call needs more (never while the stream is
    captured).  The kernel leaves every counter at 0, so they are zeroed
    once, when allocated, and a graph may replay its calls on them."""
    key = (device, stream)
    need = (2 * n_part, n_part * hd, n_counters)
    bufs = _paged_scratch_bufs.get(key)
    if bufs is None or any(t.numel() < n for t, n in zip(bufs, need)):
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the paged kernel's scratch must be sized "
                               "before the capture")
        if bufs is not None and key in _paged_scratch_held:
            _paged_scratch_held[key].append(bufs)
        size = need if bufs is None else [max(t.numel(), n)
                                          for t, n in zip(bufs, need)]
        bufs = (torch.empty(size[0], dtype=torch.float32, device=device),
                torch.empty(size[1], dtype=torch.float32, device=device),
                torch.zeros(size[2], dtype=torch.int32, device=device))
        _paged_scratch_bufs[key] = bufs
    return bufs


def _check(q, k_pool, v_pool, block_tables, lengths):
    _check_q(q)
    B = q.shape[0]
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"tables {tuple(block_tables.shape)} do not match "
                         f"batch {B}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    _check_kv(q, k_pool, v_pool, lengths, "pools", block_tables)
    if k_pool.shape[0] * k_pool.shape[1] >= 2 ** 31:
        raise ValueError(f"pools {tuple(k_pool.shape)} hold 2**31 rows or "
                         f"more; the kernel indexes rows with int32")


def paged_decode_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                block_tables: torch.Tensor,
                                lengths: torch.Tensor, *,
                                scale: Optional[float] = None
                                ) -> torch.Tensor:
    """The kernel's wrapper; same contract as
    :func:`paged_decode_attention_torch` for bf16 or f32, hd 64 or 128.
    Raises on inputs that require grad (:func:`build.refuse_grad`)."""
    _check(q, k_pool, v_pool, block_tables, lengths)
    build.refuse_grad("paged_decode_attention", q, k_pool, v_pool)
    if q.device.type == "cpu":
        return paged_decode_attention_torch(q, k_pool, v_pool, block_tables,
                                            lengths, scale=scale)
    if q.is_meta:
        lines = block_tables.shape[0] * block_tables.shape[1] \
            * k_pool.shape[1]
        count.credit("kernel:paged_decode_attention", decode_attention_flops(
            q.shape[-2], q.shape[-1], lines))
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode kernel for device {q.device}")
    B, H, hd = q.shape[0], q.shape[-2], q.shape[-1]
    num_blocks, bl, KVH = k_pool.shape[:3]
    max_blocks = block_tables.shape[1]
    G = H // KVH
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    splits, chunk = split_plan(B, KVH, G, max_blocks * bl,
                               _sm_count(q.device.index or 0),
                               PAGED_HEADS_PER_BLOCK)
    q, k_pool, v_pool = (build.aligned16(t) for t in (q, k_pool, v_pool))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # a counter per (request, KV head, head group); f32's groups of 8
    # heads are the most
    part_ml, part_acc, counters = _paged_scratch(
        q.device, stream, B * H * splits, hd,
        B * KVH * -(-G // HEADS_PER_BLOCK))
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part_ml.data_ptr(), part_acc.data_ptr(), counters.data_ptr(),
            B, H, KVH, hd, num_blocks, bl, max_blocks, splits, chunk,
            float(scale), DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"CUDA error {err}")
    _paged_counts["launches"] += 1
    return out
