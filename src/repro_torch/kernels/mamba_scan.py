"""Mamba-1 selective scan: the CUDA kernel ``csrc/mamba_scan.cu`` and its
plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/mamba_scan.py::
mamba_scan_pallas`` (body ``_scan_kernel``)::

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) outer B_t
    y_t = h_t . C_t + D * x_t

Its bound on the H100 is the larger of the bytes (x, dt and y cross
memory once each, 3 * B * S * C * 4 bytes) and the B * S * C * N
exponentials at the SFU's rate; at Jamba's widths the two are about
equal.  The kernel keeps the state in registers for the whole sequence,
spread over 4 lanes per channel (N / 4 states a lane) so that the card
holds 4 * C threads per request, computes each exp as ``ex2.approx`` of a
pre-scaled argument, sums y_t across a channel's lanes once per tile in
shared memory, and stages x, dt, B and C by double-buffered ``cp.async``.
The TPU kernel's S % 256 and C % 128 tiling limits do not apply (any S,
any C).

:func:`mamba_scan_cuda` is the entry point the model calls.  On CUDA
tensors it launches the kernel or raises; on CPU tensors, and only there,
it runs :func:`mamba_scan_torch`.  ``counts`` records kernel launches and
plain-version calls.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build

STATE_DIMS = (8, 16)

#: per kernel: ``launches`` of the CUDA kernel, ``plain_calls`` of the
#: plain version
counts = {"mamba_scan": {"launches": 0, "plain_calls": 0}}
_counts = counts["mamba_scan"]


def mamba_scan_torch(x: torch.Tensor, dt: torch.Tensor, b_ssm: torch.Tensor,
                     c_ssm: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                     h0: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version, the time loop of the JAX package's oracle: x, dt
    (B, S, C); b_ssm, c_ssm (B, S, N); a (C, N); d (C,); h0 (B, C, N) ->
    (y (B, S, C), h_final (B, C, N)), all f32."""
    _counts["plain_calls"] += 1
    x, dt, b_ssm, c_ssm, a, d = (t.float() for t in (x, dt, b_ssm, c_ssm,
                                                      a, d))
    h = h0.float().clone()      # S = 0 returns h0's values, not h0
    ys = []
    for t in range(x.shape[1]):
        dt_t, x_t = dt[:, t], x[:, t]
        h = (torch.exp(dt_t[..., None] * a) * h
             + (dt_t * x_t)[..., None] * b_ssm[:, t, None, :])
        ys.append(torch.einsum("bcn,bn->bc", h, c_ssm[:, t]) + d * x_t)
    y = torch.stack(ys, 1) if ys else x.new_zeros(x.shape)
    return y, h


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load("mamba_scan").mamba_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, dt, b_ssm, c_ssm, a, d, h0):
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"x and dt must be one (B, S, C) shape, got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}")
    B, S, C = x.shape
    N = a.shape[-1] if a.dim() == 2 else -1
    if (a.shape != (C, N) or b_ssm.shape != (B, S, N)
            or c_ssm.shape != (B, S, N) or d.shape != (C,)
            or h0.shape != (B, C, N)):
        raise ValueError(
            f"shapes do not match x {tuple(x.shape)}: b {tuple(b_ssm.shape)}, "
            f"c {tuple(c_ssm.shape)}, a {tuple(a.shape)}, d {tuple(d.shape)}, "
            f"h0 {tuple(h0.shape)}")
    if N not in STATE_DIMS:
        raise ValueError(f"state dim {N} not in {STATE_DIMS}")
    ts = (x, dt, b_ssm, c_ssm, a, d, h0)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"the scan runs in f32; got "
                        f"{[str(t.dtype) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("scan inputs must be contiguous")
    if len({t.device for t in ts}) != 1:
        raise ValueError("scan inputs must share a device")


def mamba_scan_cuda(x: torch.Tensor, dt: torch.Tensor, b_ssm: torch.Tensor,
                    c_ssm: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                    h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's wrapper; same contract as :func:`mamba_scan_torch` for
    f32 inputs, N 8 or 16, any S and C."""
    _check(x, dt, b_ssm, c_ssm, a, d, h0)
    if x.device.type == "cpu":
        return mamba_scan_torch(x, dt, b_ssm, c_ssm, a, d, h0)
    if x.device.type != "cuda":
        raise ValueError(f"no selective-scan kernel for device {x.device}")
    B, S, C = x.shape
    x, dt, b_ssm, c_ssm, a, d, h0 = (build.aligned16(t) for t in
                                     (x, dt, b_ssm, c_ssm, a, d, h0))
    y = torch.empty_like(x)
    h_out = torch.empty_like(h0)
    with torch.cuda.device(x.device):
        err = _kernel()(
            x.data_ptr(), dt.data_ptr(), b_ssm.data_ptr(), c_ssm.data_ptr(),
            a.data_ptr(), d.data_ptr(), h0.data_ptr(), y.data_ptr(),
            h_out.data_ptr(), B, S, C, a.shape[1],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error "
                           f"{err}")
    _counts["launches"] += 1
    return y, h_out
