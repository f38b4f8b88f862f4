"""Frozen operation and byte counts behind the benchmark's shares.

Everything here is computed from the configuration file's published sizes
and from the token counts and lengths of the plans a run executed, never
from what the program reports or from a kernel's launch arguments, so a
later kernel that replaces one of today's is judged on the same work.

Peaks are NVIDIA's published H100 SXM figures (dense, no sparsity) at the
full 700 W power limit; the benchmark prints the card's own limit beside
every share.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

#: bf16 dense tensor-core peak, FLOP/s
PEAK_BF16_FLOPS = 989e12
#: HBM3 bandwidth, bytes/s
PEAK_HBM_BYTES = 3.35e12


@dataclass(frozen=True)
class Shape:
    """The sizes of a dense decoder that the counts need."""
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    gated_ffn: bool          # SwiGLU (three matrices) or a plain MLP (two)
    window: int              # attention window in lines (0: none)
    dtype_bytes: int = 2

    @classmethod
    def of(cls, cfg: dict) -> "Shape":
        return cls(layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
                   heads=cfg["num_attention_heads"],
                   kv_heads=cfg["num_key_value_heads"],
                   head_dim=cfg["head_dim"], d_ff=cfg["intermediate_size"],
                   vocab=cfg["vocab_size"],
                   gated_ffn=cfg["hidden_act"] == "silu",
                   window=cfg.get("sliding_window") or 0)


def layer_params(s: Shape) -> int:
    """Matrix parameters of one decoder layer (norm vectors left out)."""
    attn = s.d_model * s.head_dim * (2 * s.heads + 2 * s.kv_heads)
    ffn = (3 if s.gated_ffn else 2) * s.d_model * s.d_ff
    return attn + ffn


def body_params(s: Shape) -> int:
    """Matrix parameters of every decoder layer: the model's parameters
    without its embedding and head."""
    return s.layers * layer_params(s)


def head_params(s: Shape) -> int:
    return s.d_model * s.vocab


def visible(length: int, offset: int, window: int) -> int:
    """Key lines the queries at positions [offset, offset + length) attend
    to under a causal mask, each query seeing at most ``window`` lines
    (0: no window)."""
    total = 0
    # queries whose whole history fits the window see position + 1 lines
    lo, hi = offset, offset + length
    cut = hi if not window else min(hi, max(lo, window - 1))
    # positions lo .. cut-1 see p + 1 lines
    n = cut - lo
    total += n * (lo + 1) + n * (n - 1) // 2
    if window and hi > cut:
        total += (hi - cut) * window
    return total


def attention_flops(s: Shape, pairs: int) -> int:
    """QK^T and PV over ``pairs`` (query, key) pairs, all layers."""
    return 4 * s.heads * s.head_dim * pairs * s.layers


def prefill_model_flops(s: Shape, length: int, offset: int = 0,
                        logits: bool = True) -> int:
    """A prompt chunk of ``length`` tokens after ``offset`` cached ones:
    every layer's matrices for each token, attention over the lines each
    token sees, and the head for the one token whose logits are sampled."""
    return (2 * body_params(s) * length
            + attention_flops(s, visible(length, offset, s.window))
            + (2 * head_params(s) if logits else 0))


def decode_model_flops(s: Shape, lines_before: int, steps: int) -> int:
    """``steps`` decode tokens of one request whose cache held
    ``lines_before`` lines: the token at step j attends to
    lines_before + j + 1 lines (capped by the window)."""
    return (steps * 2 * (body_params(s) + head_params(s))
            + attention_flops(s, visible(steps, lines_before, s.window)))


def flash_work(s: Shape, length: int, offset: int = 0) -> Tuple[int, int]:
    """(FLOPs, bytes) the prefill attention of one request needs, all
    layers: Q and O of the chunk, K and V of every line it sees, each
    read or written once."""
    flops = attention_flops(s, visible(length, offset, s.window))
    kv_lines = offset + length
    if s.window:
        kv_lines = min(kv_lines, length + s.window - 1)
    per_layer = (2 * length * s.heads * s.head_dim
                 + 2 * kv_lines * s.kv_heads * s.head_dim) * s.dtype_bytes
    return flops, per_layer * s.layers


def paged_decode_work(s: Shape, lines: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one decode step's attention for one request that
    attends to ``lines`` cached lines (the new one included), all layers:
    its query and output once, each line's K and V once."""
    lines = min(lines, s.window) if s.window else lines
    flops = 4 * s.heads * s.head_dim * lines * s.layers
    per_layer = (2 * s.heads * s.head_dim
                 + 2 * lines * s.kv_heads * s.head_dim) * s.dtype_bytes
    return flops, per_layer * s.layers


def bound_s(flops: float, nbytes: float) -> float:
    """Least seconds the chip could take: the larger of the operations at
    the bf16 peak and the bytes at the HBM rate."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)

