"""Plain float32 forward of a dense decoder, the benchmark's reference.

It computes the whole-sequence forward pass of the configuration file's
model on the seeded weights the benchmark draws, in float32 with TF32 off,
with no cache, no batching and no kernel: embedding (times ``scale_emb``),
then per layer an RMS norm, grouped-query attention with rotary positions
(the two halves of each head rotated, not interleaved pairs) under a
causal mask and the ``sliding_window``, an RMS norm and the MLP (tanh GELU
on ``w_up``, or SwiGLU), each branch added to the residual times
``scale_depth / sqrt(num_hidden_layers)`` where the file gives
``scale_depth`` (else 1); then the final norm and the head (the embedding's
transpose where the file ties them), times ``dim_model_base /
hidden_size`` where the file gives ``dim_model_base`` (else 1).

It follows the weights' tree, which departs from the published
architectures where the file says so (``departures``): RMS norms without
bias and no bias on any projection for StarCoder2 (published: LayerNorm
and biases), and no embedding scale for MiniCPM (published:
``scale_emb`` 12).

Memory: the weights stay in the served dtype; each layer's matrices are
cast to float32 for that layer alone, and attention runs over blocks of
queries, so the reference fits beside nothing but its own activations.

``precision="fp8"`` is the control: every matrix product takes its
weights per output column and its activations per row rounded to
float8 e4m3, the step below the bfloat16 the configurations serve in.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

QUERY_BLOCK = 1024


def strict_f32() -> None:
    """Float32 matrix products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the largest magnitude maps to the format's largest)."""
    fmax = torch.finfo(torch.float8_e4m3fn).max
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / fmax
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Matmul:
    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        if self.fp8:
            x, w = _fp8(x, -1), _fp8(w, 0)
        return x @ w


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * w.float()


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (T, heads, hd), rows at positions 0..T-1."""
    T, _, hd = x.shape
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64,
                                       device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = ang.cos().float()[:, None, :]
    sin = ang.sin().float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, window: int) -> torch.Tensor:
    """q (T, H, hd), k and v (T, KVH, hd): causal, each query seeing at
    most ``window`` lines (0: all)."""
    T, H, hd = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)      # (H, T, hd)
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    keys = torch.arange(T, device=q.device)
    for s in range(0, T, QUERY_BLOCK):
        e = min(T, s + QUERY_BLOCK)
        qb = q[s:e].transpose(0, 1)                          # (H, b, hd)
        scores = (qb @ k.transpose(1, 2)) / math.sqrt(hd)    # (H, b, T)
        pos = torch.arange(s, e, device=q.device)[:, None]
        mask = keys[None, :] <= pos
        if window:
            mask &= pos - keys[None, :] < window
        scores = scores.masked_fill(~mask, float("-inf"))
        out[s:e] = (scores.softmax(-1) @ v).transpose(0, 1)
    return out


def forward(cfg: Dict, weights: Dict[str, torch.Tensor],
            sequences: Sequence[torch.Tensor],
            rows: Sequence[torch.Tensor], precision: str = "f32"
            ) -> List[torch.Tensor]:
    """Logits (float32) at ``rows[i]`` of ``sequences[i]`` (int token ids,
    positions 0..T-1); the row at position p scores the token at p + 1.
    Layer by layer over all sequences."""
    strict_f32()
    mm = _Matmul(precision)
    L = cfg["num_hidden_layers"]
    H, KVH = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["head_dim"]
    eps = cfg.get("rms_norm_eps", cfg.get("norm_epsilon"))
    window = cfg.get("sliding_window") or 0
    rs = (cfg["scale_depth"] / math.sqrt(L)) if "scale_depth" in cfg else 1.0
    ls = (cfg["dim_model_base"] / cfg["hidden_size"]
          if "dim_model_base" in cfg else 1.0)
    gated = cfg["hidden_act"] == "silu"
    emb = weights["embed"]
    xs = [emb[s.long()].float() * cfg.get("scale_emb", 1.0)
          for s in sequences]
    with torch.no_grad():
        for layer in range(L):
            w = {k: v[layer] for k, v in weights.items()
                 if k not in ("embed", "final_norm", "lm_head")}
            for i, x in enumerate(xs):
                T = x.shape[0]
                h = _rms(x, w["norm1"], eps)
                q = _rope(mm(h, w["wq"]).view(T, H, hd), cfg["rope_theta"])
                k = _rope(mm(h, w["wk"]).view(T, KVH, hd), cfg["rope_theta"])
                v = mm(h, w["wv"]).view(T, KVH, hd)
                a = _attention(q, k, v, window).reshape(T, H * hd)
                x = x + rs * mm(a, w["wo"])
                h = _rms(x, w["norm2"], eps)
                if gated:
                    f = torch.nn.functional.silu(mm(h, w["w_gate"])) \
                        * mm(h, w["w_up"])
                else:
                    f = torch.nn.functional.gelu(mm(h, w["w_up"]),
                                                 approximate="tanh")
                xs[i] = x + rs * mm(f, w["w_down"])
        head = weights["lm_head"] if "lm_head" in weights else emb.T
        out = []
        for x, r in zip(xs, rows):
            h = _rms(x[r.long()], weights["final_norm"], eps)
            out.append(mm(h, head) * ls)
    return out
