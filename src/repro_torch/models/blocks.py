"""Layer composition + segment planning.

A model is a sequence of layers; each layer = pre-norm mixer + optional
FFN, with (optionally depth-scaled) residuals.  Layers are grouped into
*segments*, maximal periodic runs whose parameters and states are stacked
along a leading repeat dim, the layout the JAX package scans over.  Here a
Python loop walks the repeat dim; each step indexes views of the stacked
leaves, so cache writes land in the stacked state in place.

The port runs attention and Mamba mixers with dense or MoE FFNs; xLSTM
blocks and cross attention raise ``NotImplementedError`` naming their
slice.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba as mamba_mod
from repro_torch.models.attention import gqa_forward, init_gqa
from repro_torch.models.common import rms_norm
from repro_torch.models.ffn import dense_ffn, init_dense_ffn
from repro_torch.models.moe import init_moe, moe_forward
from repro_torch.models.state import cache_capacity, init_layer_state


class LayerSpec(NamedTuple):
    block: str        # attn | mamba | mlstm | slstm
    is_moe: bool
    d_ff: int         # dense-path d_ff (0 = no FFN sublayer)
    cross: bool       # has cross-attention (enc-dec decoder layers)


class Segment(NamedTuple):
    specs: Tuple[LayerSpec, ...]
    repeats: int
    layer_start: int


def layer_specs(cfg: ModelConfig, decoder: bool = True) -> List[LayerSpec]:
    specs = []
    for i, blk in enumerate(cfg.block_pattern):
        is_moe = cfg.layer_is_moe(i) and blk != "mlstm" and blk != "slstm"
        d_ff = cfg.d_ff
        if cfg.moe is not None and i < cfg.moe.first_dense_layers:
            d_ff = cfg.moe.first_dense_d_ff or cfg.d_ff
        if blk in ("mlstm", "slstm"):
            d_ff = 0
        cross = decoder and cfg.is_encoder_decoder and blk == "attn"
        specs.append(LayerSpec(blk, is_moe, d_ff, cross))
    return specs


def plan_segments(specs: List[LayerSpec], max_period: int = 16) -> List[Segment]:
    """Greedy maximal periodic runs (prefers the longest total run)."""
    segs: List[Segment] = []
    i, L = 0, len(specs)
    while i < L:
        best_p, best_r = 1, 1
        for p in range(1, min(max_period, L - i) + 1):
            r = 1
            while (i + (r + 1) * p <= L
                   and specs[i + r * p: i + (r + 1) * p] == specs[i: i + p]):
                r += 1
            if r >= 2 and p * r > best_p * best_r:
                best_p, best_r = p, r
        segs.append(Segment(tuple(specs[i: i + best_p]), best_r, i))
        i += best_p * best_r
    return segs


def check_supported(spec: LayerSpec):
    if spec.block not in ("attn", "mamba"):
        raise NotImplementedError(
            f"{spec.block!r} blocks wait for the xLSTM slice of the port")
    if spec.cross:
        raise NotImplementedError(
            "cross attention waits for the encoder-decoder slice of the port")


# ---------------------------------------------------------------------------
# Per-layer init / apply
# ---------------------------------------------------------------------------


def init_layer(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
               repeats: int, dtype, device):
    """One position of a segment, its leaves stacked over ``repeats``."""
    check_supported(spec)
    d = cfg.d_model
    p: Dict[str, Any] = {
        "norm1": torch.ones((repeats, d), dtype=dtype, device=device)}
    if spec.block == "attn":
        p["mixer"] = init_gqa(gen, cfg, repeats, dtype, device)
    else:
        p["mixer"] = mamba_mod.init_mamba(gen, cfg, repeats, dtype, device)
    if spec.d_ff or spec.is_moe:
        p["norm2"] = torch.ones((repeats, d), dtype=dtype, device=device)
        if spec.is_moe:
            p["ffn"] = init_moe(gen, cfg, repeats, dtype, device)
        else:
            p["ffn"] = init_dense_ffn(gen, cfg, spec.d_ff, repeats, dtype,
                                      device)
    return p


def apply_layer(cfg: ModelConfig, spec: LayerSpec, params, x: torch.Tensor,
                state, ctx: Dict[str, Any]
                ) -> Tuple[torch.Tensor, Any, Union[float, torch.Tensor]]:
    """Returns (x, state, router aux loss); the state's leaves are written
    in place.  The aux loss is the float 0.0 for a dense FFN, so stacks
    without MoE launch nothing for it."""
    rs = cfg.residual_scale
    aux = 0.0
    h_in = rms_norm(x, params["norm1"], cfg.rms_norm_eps)
    if spec.block == "attn":
        h, state = gqa_forward(
            cfg, params["mixer"], h_in, mode=ctx["mode"], state=state,
            update_cache=ctx["update_cache"], positions=ctx["positions"],
            t=ctx.get("t"), window=ctx.get("window"),
            causal=ctx.get("causal", True), history=ctx.get("history", 0),
            paged=ctx.get("paged"))
    else:
        h, state = mamba_mod.mamba_forward(
            cfg, params["mixer"], h_in, mode=ctx["mode"], state=state,
            update_cache=ctx["update_cache"])
    x = x + rs * h
    if spec.d_ff or spec.is_moe:
        f_in = rms_norm(x, params["norm2"], cfg.rms_norm_eps)
        if spec.is_moe:
            h, aux = moe_forward(cfg, params["ffn"], f_in)
        else:
            h = dense_ffn(cfg, params["ffn"], f_in)
        x = x + rs * h
    return x, state, aux


# ---------------------------------------------------------------------------
# Segment init / state / apply (stacked leaves, loop over repeats)
# ---------------------------------------------------------------------------


def _at(tree, r: int):
    """The repeat-``r`` view of every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: _at(v, r) for k, v in tree.items()}
    return tree[r]


def init_segment(gen: torch.Generator, cfg: ModelConfig, seg: Segment,
                 dtype, device):
    return {f"p{j}": init_layer(gen, cfg, spec, seg.repeats, dtype, device)
            for j, spec in enumerate(seg.specs)}


def init_segment_state(cfg: ModelConfig, seg: Segment, batch: int,
                       capacity: int, dtype, device):
    out = {}
    for j, spec in enumerate(seg.specs):
        check_supported(spec)
        out[f"p{j}"] = init_layer_state(cfg, spec.block, seg.repeats, batch,
                                        capacity, dtype, device)
    return out


def apply_segment(cfg: ModelConfig, seg: Segment, params, x: torch.Tensor,
                  seg_state, ctx: Dict[str, Any]
                  ) -> Tuple[torch.Tensor, Union[float, torch.Tensor]]:
    """Run the periodic body over the repeat dim; ``seg_state`` (if any)
    is updated in place.  Returns (x, summed router aux loss)."""
    aux = 0.0
    for r in range(seg.repeats):
        lp = _at(params, r)
        ls = _at(seg_state, r) if seg_state is not None else None
        for j, spec in enumerate(seg.specs):
            x, _, aux_j = apply_layer(
                cfg, spec, lp[f"p{j}"], x,
                ls[f"p{j}"] if ls is not None else None, ctx)
            aux = aux + aux_j
    return x, aux


# ---------------------------------------------------------------------------
# Whole-stack helpers
# ---------------------------------------------------------------------------


def init_stack(gen: torch.Generator, cfg: ModelConfig, dtype, device):
    segs = plan_segments(layer_specs(cfg))
    return segs, [init_segment(gen, cfg, s, dtype, device) for s in segs]


def init_stack_state(cfg: ModelConfig, segs: List[Segment], batch: int,
                     seq_len: int, dtype, device):
    cap = cache_capacity(cfg, seq_len)
    return [init_segment_state(cfg, s, batch, cap, dtype, device)
            for s in segs]


def apply_stack(cfg: ModelConfig, segs: List[Segment], seg_params,
                x: torch.Tensor, states, ctx: Dict[str, Any]
                ) -> Tuple[torch.Tensor, Union[float, torch.Tensor]]:
    """Returns (x, router aux loss summed over the stack)."""
    aux = 0.0
    for i, seg in enumerate(segs):
        x, aux_i = apply_segment(cfg, seg, seg_params[i], x,
                                 states[i] if states is not None else None,
                                 ctx)
        aux = aux + aux_i
    return x, aux
