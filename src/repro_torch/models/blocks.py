"""Layer composition + segment planning.

A model is a sequence of layers; each layer = pre-norm mixer + optional
cross attention (enc-dec decoder layers) + optional FFN, with (optionally
depth-scaled) residuals.  Layers are grouped into
*segments*, maximal periodic runs whose parameters and states are stacked
along a leading repeat dim, the layout the JAX package scans over.  Here a
Python loop walks the repeat dim; each step indexes views of the stacked
leaves, so cache writes land in the stacked state in place.  With
``remat`` (training) each repeat's body runs under
``torch.utils.checkpoint``, the counterpart of the JAX package's
``jax.checkpoint(body)``: its activations are recomputed in the backward
pass instead of kept.

The port runs attention (GQA or MLA), Mamba, mLSTM and sLSTM mixers with
dense or MoE FFNs, and the encoder stack of enc-dec models
(``layer_specs(cfg, decoder=False)``: no cross attention, and the caller
sets ``ctx["causal"] = False``).

With ``ctx["seq_shard"]`` (sequence parallelism, set by
``repro_torch.models.model``) the residual ``x`` is this model rank's
S / tp rows through the whole layer: the norms and the residual adds run
on them, and each module gathers its input rows at its entry and hands
back the rank's rows of its output (``sharding.module_in``/
``module_out``).  The norms' weights, whole on every rank and applied to
the rank's rows only, sum their gradients over the model ranks
(``copy_in``).
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding
from repro_torch.configs.base import ModelConfig
from repro_torch.core import opcount
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.attention import (attention_forward,
                                          cross_attn_forward, init_attention,
                                          init_cross_attn)
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


# ---------------------------------------------------------------------------
# Per-layer init / apply
# ---------------------------------------------------------------------------


def init_layer(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
               repeats: int, dtype, device):
    """One position of a segment, its leaves stacked over ``repeats``."""
    d = cfg.d_model
    p: Dict[str, Any] = {
        "norm1": torch.ones((repeats, d), dtype=dtype, device=device)}
    init = {"attn": init_attention, "mamba": mamba_mod.init_mamba,
            "mlstm": xlstm_mod.init_mlstm, "slstm": xlstm_mod.init_slstm}
    p["mixer"] = init[spec.block](gen, cfg, repeats, dtype, device)
    if spec.cross:
        p["cross_norm"] = torch.ones((repeats, d), dtype=dtype, device=device)
        p["cross"] = init_cross_attn(gen, cfg, repeats, dtype, device)
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
    seq = ctx.get("seq_shard", False)

    def norm(x, key):
        w = sharding.copy_in(params[key]) if seq else params[key]
        return rms_norm(x, w, cfg.rms_norm_eps)

    h_in = norm(x, "norm1")
    kw = dict(mode=ctx["mode"], state=state, update_cache=ctx["update_cache"],
              seq=seq)
    # ctx["train"] (set by forward_train only) sends full-mode attention and
    # the Mamba scan to the differentiable model-level paths
    train = ctx.get("train", False)
    if spec.block == "attn":
        h, state = attention_forward(
            cfg, params["mixer"], h_in, positions=ctx["positions"],
            t=ctx.get("t"), window=ctx.get("window"),
            causal=ctx.get("causal", True), history=ctx.get("history", 0),
            paged=ctx.get("paged"), train=train, **kw)
    elif spec.block == "mamba":
        h, state = mamba_mod.mamba_forward(cfg, params["mixer"], h_in,
                                           train=train, **kw)
    else:
        forward = {"mlstm": xlstm_mod.mlstm_forward,
                   "slstm": xlstm_mod.slstm_forward}[spec.block]
        h, state = forward(cfg, params["mixer"], h_in, **kw)
    x = x + rs * h
    if spec.cross:
        cx = norm(x, "cross_norm")
        h, _ = cross_attn_forward(
            cfg, params["cross"], cx, enc_out=ctx.get("enc_out"),
            state=state, precompute=ctx.get("precompute_cross", False),
            seq=seq)
        x = x + rs * h
    if spec.d_ff or spec.is_moe:
        f_in = norm(x, "norm2")
        if spec.is_moe:
            h, aux = moe_forward(cfg, params["ffn"], f_in, seq)
        else:
            h = dense_ffn(cfg, params["ffn"], f_in, spec.d_ff, seq)
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


def _repeats(tree, n: int):
    """The ``n`` repeat views of every leaf of a nested dict, from one
    ``unbind(0)`` per leaf: its backward stacks the repeats' grads in one
    pass, where ``n`` selects would each write a zeroed whole leaf."""
    if isinstance(tree, dict):
        parts = {k: _repeats(v, n) for k, v in tree.items()}
        return [{k: p[r] for k, p in parts.items()} for r in range(n)]
    return tree.unbind(0)


def init_segment(gen: torch.Generator, cfg: ModelConfig, seg: Segment,
                 dtype, device):
    return {f"p{j}": init_layer(gen, cfg, spec, seg.repeats, dtype, device)
            for j, spec in enumerate(seg.specs)}


def init_segment_state(cfg: ModelConfig, seg: Segment, batch: int,
                       capacity: int, dtype, device,
                       cross_len: Optional[int] = None):
    return {f"p{j}": init_layer_state(
        cfg, spec.block, seg.repeats, batch, capacity, dtype, device,
        cross_len=cross_len if spec.cross else None)
        for j, spec in enumerate(seg.specs)}


def _per_repeat(dims):
    """A stacked leaf's data-cut dim as a dim of one repeat's view."""
    if isinstance(dims, dict):
        return {k: _per_repeat(v) for k, v in dims.items()}
    return None if dims is None else dims - 1


def apply_segment(cfg: ModelConfig, seg: Segment, params, x: torch.Tensor,
                  seg_state, ctx: Dict[str, Any], remat: bool = False,
                  dims=None
                  ) -> Tuple[torch.Tensor, Union[float, torch.Tensor]]:
    """Run the periodic body over the repeat dim; ``seg_state`` (if any)
    is updated in place.  With ``remat`` each repeat's body is
    checkpointed.  ``dims`` (the sharded train step's FSDP) is the tree of
    each stacked leaf's data-cut dim: each repeat's leaves are gathered
    over "data" inside the body, so remat gathers them again in the
    backward.  Returns (x, summed router aux loss)."""
    rep_dims = _per_repeat(dims) if dims is not None else None

    def body(x, aux, lp, ls):
        lp = sharding.unshard(lp, rep_dims)
        for j, spec in enumerate(seg.specs):
            x, _, aux_j = apply_layer(
                cfg, spec, lp[f"p{j}"], x,
                ls[f"p{j}"] if ls is not None else None, ctx)
            aux = aux + aux_j
        return x, aux

    aux = 0.0
    for r, lp in enumerate(_repeats(params, seg.repeats)):
        args = (x, aux, lp,
                _at(seg_state, r) if seg_state is not None else None)
        x, aux = (checkpoint(body, *args, use_reentrant=False,
                             context_fn=opcount.remat_contexts) if remat
                  else body(*args))
    return x, aux


# ---------------------------------------------------------------------------
# Whole-stack helpers
# ---------------------------------------------------------------------------


def init_stack(gen: torch.Generator, cfg: ModelConfig, dtype, device,
               decoder: bool = True):
    segs = plan_segments(layer_specs(cfg, decoder=decoder))
    return segs, [init_segment(gen, cfg, s, dtype, device) for s in segs]


def init_stack_state(cfg: ModelConfig, segs: List[Segment], batch: int,
                     seq_len: int, dtype, device,
                     cross_len: Optional[int] = None,
                     long_context: bool = False):
    cap = cache_capacity(cfg, seq_len, long_context)
    return [init_segment_state(cfg, s, batch, cap, dtype, device, cross_len)
            for s in segs]


def apply_stack(cfg: ModelConfig, segs: List[Segment], seg_params,
                x: torch.Tensor, states, ctx: Dict[str, Any],
                remat: bool = False, dims=None
                ) -> Tuple[torch.Tensor, Union[float, torch.Tensor]]:
    """Returns (x, router aux loss summed over the stack).  ``dims``: the
    segments' data-cut dims (see :func:`apply_segment`)."""
    aux = 0.0
    for i, seg in enumerate(segs):
        x, aux_i = apply_segment(cfg, seg, seg_params[i], x,
                                 states[i] if states is not None else None,
                                 ctx, remat,
                                 dims[i] if dims is not None else None)
        aux = aux + aux_i
    return x, aux
