"""LR schedules: cosine and WSD (Warmup-Stable-Decay, MiniCPM arXiv:2404.06395).

Copies of the JAX package's ``repro.training.schedules``: each returns the
learning-rate scale at ``step`` as a 0-dim f32 tensor on the CPU, computed
in f32 as the JAX package computes it.
"""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def cosine(step, *, warmup: int, total: int, min_frac: float = 0.1
           ) -> torch.Tensor:
    step = _f32(step)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos


def wsd(step, *, warmup: int, total: int, decay_frac: float = 0.1,
        min_frac: float = 0.01) -> torch.Tensor:
    """Warmup -> Stable (flat) -> Decay (last ``decay_frac`` of steps,
    exponential-ish linear-in-log decay per the MiniCPM recipe)."""
    step = _f32(step)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    decay_start = total * (1.0 - decay_frac)
    prog = torch.clamp((step - decay_start) / max(total - decay_start, 1),
                       0.0, 1.0)
    decay = torch.exp(torch.log(_f32(max(min_frac, 1e-6))) * prog)
    return warm * torch.where(step < decay_start, 1.0, decay)


SCHEDULES = {"cosine": cosine, "wsd": wsd}
