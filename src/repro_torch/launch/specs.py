"""Input stand-ins and partition-spec rules for the dry run and the mesh.

A copy of the JAX package's ``repro.launch.specs`` over the port's
nested-dict trees.  ``input_specs(cfg, shape)`` builds a meta-device
tensor for every model input of an input shape (nothing is allocated:
the full configs are only ever traced, never materialized), beside its
partition-spec tuple.  ``param_pspecs`` and ``state_pspecs`` give every
leaf of a parameter or serving-state tree a partition-spec tuple (one
entry per dim: an axis name, a tuple of axis names, or None), from its
path and shape, with divisibility-checked rules:

  * TP ("model") on head/ffn/expert dims,
  * FSDP ("data", + "pod" when multi-pod) on a second dim in train mode,
  * layout "fsdp": no TP, the largest divisible dim over every axis,
  * batch on "data" (+ "pod"); the KV sequence on "data" when the batch
    does not divide (long_500k, B = 1), the MLA latent's sequence on
    "model".

``meshserve.pool.shard_params`` cuts a serving slice's params by these
specs at ``model_n`` = the slice's TP width, at whole heads for the
attention projections; ``launch.dryrun`` divides each leaf's bytes by
the mesh axes its spec names.
"""
from __future__ import annotations

import os
import re
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig

# ---------------------------------------------------------------------------
# Input stand-ins (meta tensors)
# ---------------------------------------------------------------------------


def token_layout(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Resolve per-arch token/front-end layout for an input shape."""
    B, S = shape.global_batch, shape.seq_len
    out: Dict[str, Any] = {}
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        p = cfg.frontend.num_prefix_tokens
        out["patch_embeds"] = (B, p, cfg.frontend.embed_dim)
        out["text_len"] = max(S - p, 1)
    elif cfg.is_encoder_decoder:
        frames = min(cfg.encoder.max_source_positions, S)
        out["frames"] = (B, frames, cfg.frontend.embed_dim)
        out["text_len"] = S
    else:
        out["text_len"] = S
    return out


def input_specs(cfg: ModelConfig, shape: InputShape, multi_pod: bool = False,
                layout: str = "tp"
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, tuple]]:
    """(meta tensors, partition specs) for the batch of this shape: tokens
    (and labels for training) of the text length, or for decode one token
    and a per-request clock ``t``; a VLM's patch embeddings and an enc-dec
    model's frames for train and prefill shapes."""
    if layout == "fsdp":
        b_ax = (("pod", "data", "model") if multi_pod
                else ("data", "model"))
        n_b = _axes_size(multi_pod) * 16
    else:
        b_ax = ("pod", "data") if multi_pod else ("data",)
        n_b = _axes_size(multi_pod)
    B = shape.global_batch
    bspec = b_ax if _div(B, n_b) else None
    lay = token_layout(cfg, shape)
    meta = dict(device="meta")
    sds: Dict[str, torch.Tensor] = {}
    specs: Dict[str, tuple] = {}

    if shape.kind in ("train", "prefill"):
        sds["tokens"] = torch.empty((B, lay["text_len"]), dtype=torch.int32,
                                    **meta)
        specs["tokens"] = (bspec, None)
        if shape.kind == "train":
            sds["labels"] = torch.empty((B, lay["text_len"]),
                                        dtype=torch.int32, **meta)
            specs["labels"] = (bspec, None)
    else:  # decode: ONE new token + per-request clock
        sds["tokens"] = torch.empty((B, 1), dtype=torch.int32, **meta)
        specs["tokens"] = (bspec, None)
        sds["t"] = torch.empty((B,), dtype=torch.int32, **meta)
        specs["t"] = (bspec,)

    for key in ("patch_embeds", "frames"):
        if key in lay and shape.kind in ("train", "prefill"):
            sds[key] = torch.empty(lay[key], dtype=torch.bfloat16, **meta)
            specs[key] = (bspec, None, None)
    return sds, specs


def _axes_size(multi_pod: bool) -> int:
    return 32 if multi_pod else 16


def _div(n: int, k: int) -> bool:
    return n % k == 0 and n >= k


# ---------------------------------------------------------------------------
# Param partition specs (path+shape rules)
# ---------------------------------------------------------------------------

# column-parallel (shard OUTPUT dim on model)
_COL = re.compile(
    r"(wq|wk|wv|wq_b|wkv_a|wq_a|wkv_b|w_gate|w_up|w_z|w_in|in_proj|x_proj|"
    r"combine|w1)$")
# row-parallel (shard INPUT dim on model)
_ROW = re.compile(r"(wo|w_down|out_proj|dt_w|w2)$")
_EXPERT = re.compile(r"ffn/(w_gate|w_up|w_down)$")


def map_with_path(fn: Callable[[str, Any], Any], tree, path: str = ""):
    """``fn(path, leaf)`` over a nested dict/list tree, keeping its
    structure; a path joins dict keys and list indices with ``/``, as the
    JAX package's ``_path_str`` does.  A tuple is a leaf (a pspec)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def pick_layout(cfg, shape) -> str:
    """Per-(arch x shape) parallel layout on the fixed production mesh:
    "tp", unless ``REPRO_LAYOUT=fsdp`` asks for pure FSDP, which only a
    dense (non-MoE) training shape takes.  ``shape`` is anything with a
    ``kind`` ("train", "prefill" or "decode")."""
    if (os.environ.get("REPRO_LAYOUT") == "fsdp"
            and shape.kind == "train" and cfg.moe is None):
        return "fsdp"
    return "tp"


def param_pspecs(cfg, params_shape, *, mode: str, multi_pod: bool = False,
                 layout: str = "tp", model_n: int = 16):
    """mode: "serve" (TP only, replicated over data) or "train" (TP+FSDP).
    layout "fsdp": no tensor parallelism, every matrix shards one dim over
    ALL mesh axes combined.  ``model_n`` is the model-axis width the
    divisibility rules check against: 16 on the fixed production mesh; a
    mesh-serving slice passes its own TP width.  ``params_shape`` is any
    tree whose leaves have a ``shape`` (meta tensors will do)."""
    fsdp_ax = ("pod", "data") if multi_pod else ("data",)
    fsdp_n = _axes_size(multi_pod)

    if layout == "fsdp":
        all_ax = (("pod", "data", "model") if multi_pod
                  else ("data", "model"))
        all_n = _axes_size(multi_pod) * model_n

        def rule_fsdp(path, leaf):
            shape_ = tuple(leaf.shape)
            spec = [None] * len(shape_)
            # shard the largest divisible dim over the full mesh
            order = sorted(range(len(shape_)), key=lambda i: -shape_[i])
            for i in order:
                if _div(shape_[i], all_n):
                    spec[i] = all_ax
                    break
            return tuple(spec)

        return map_with_path(rule_fsdp, params_shape)

    def rule(ps, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec = [None] * nd

        def try_shard(dim: int, axis, n: int) -> bool:
            if spec[dim] is None and _div(shape[dim], n):
                spec[dim] = axis
                return True
            return False

        is_expert = bool(_EXPERT.search(ps)) and cfg.moe is not None and \
            shape[-3:-2] and nd >= 3 and shape[-3] == cfg.moe.num_experts
        if ps.endswith("embed"):
            try_shard(0, "model", model_n)          # vocab on model
            if mode == "train":
                try_shard(1, fsdp_ax, fsdp_n)
        elif ps.endswith("lm_head"):
            try_shard(nd - 1, "model", model_n)
            if mode == "train":
                try_shard(nd - 2, fsdp_ax, fsdp_n)
        elif is_expert:
            try_shard(nd - 3, "model", model_n)     # expert dim
            if mode == "train":
                try_shard(nd - 2, fsdp_ax, fsdp_n)
        elif ps.endswith("ffn/router"):
            pass                                    # replicated
        elif _COL.search(ps):
            try_shard(nd - 1, "model", model_n)
            if mode == "train" and nd >= 2:
                try_shard(nd - 2, fsdp_ax, fsdp_n)
        elif _ROW.search(ps):
            if nd >= 2:
                try_shard(nd - 2, "model", model_n)
                if mode == "train":
                    try_shard(nd - 1, fsdp_ax, fsdp_n)
        elif ps.endswith("conv_w") and nd >= 2:
            try_shard(nd - 1, "model", model_n)     # (k, d_in)
        elif ps.endswith("conv_b") or ps.endswith("A_log") \
                or ps.endswith("/D") or ps.endswith("dt_b") \
                or ps.endswith("w_o"):
            try_shard(nd - 1 if ps.endswith(("conv_b", "dt_b", "w_o"))
                      else nd - 2, "model", model_n)
        elif ps.endswith("wv") and nd >= 3:
            # xLSTM headwise value projection: shard hd_out
            try_shard(nd - 1, "model", model_n)
        elif re.search(r"(wq|wk|r)$", ps) and nd >= 3:
            pass  # replicated: q/k must be whole per rank (C's key dim)
        return tuple(spec)

    return map_with_path(rule, params_shape)


# ---------------------------------------------------------------------------
# Serving-state partition specs
# ---------------------------------------------------------------------------

#: state leaves whose dim 2 is the KV sequence
_SEQ_LEAVES = ("k", "v", "c_kv", "k_rope", "xk", "xv")


def state_pspecs(cfg: ModelConfig, state_shape, shape: InputShape, *,
                 long_context: bool, multi_pod: bool = False,
                 model_n: int = 16):
    """KV caches: batch on data when divisible; otherwise (long_500k,
    B = 1) the KV sequence dim on data (sharded-KV decode combine).  The
    MLA latent shards its sequence over the model axis (every head shares
    the latent, so its heads cannot be cut).  ``long_context`` is taken
    for the JAX package's signature; the rules read only the leaves'
    shapes."""
    b_ax = ("pod", "data") if multi_pod else ("data",)
    b_n = _axes_size(multi_pod)
    batch_ok = _div(shape.global_batch, b_n)

    def rule(ps, leaf):
        shape_ = tuple(leaf.shape)
        nd = len(shape_)
        spec = [None] * nd
        is_enc = ps.endswith("enc_out")
        # batch dim: 1 for layer states (dim 0 = repeat), 0 for enc_out
        bdim = 0 if is_enc else 1
        if batch_ok and nd > bdim and _div(shape_[bdim], b_n):
            spec[bdim] = b_ax
        tail = ps.rsplit("/", 1)[-1]
        if not batch_ok and tail in _SEQ_LEAVES and nd > 2 \
                and _div(shape_[2], b_n):
            spec[2] = b_ax                      # shard KV seq over data
        if tail in ("c_kv", "k_rope") and nd > 2 and spec[2] is None \
                and _div(shape_[2], model_n):
            spec[2] = "model"                   # MLA latent: seq on model
        if tail in ("k", "v", "xk", "xv") and nd >= 4 \
                and _div(shape_[3], model_n):
            spec[3] = "model"                   # kv heads
        if tail == "ssm" and nd >= 3 and _div(shape_[2], model_n):
            spec[2] = "model"                   # mamba d_in
        if tail in ("conv", "C", "n") and nd >= 4 \
                and _div(shape_[3], model_n):
            spec[3] = "model"                   # conv d_in, mLSTM key dim
        if is_enc and _div(shape_[-1], model_n):
            spec[-1] = None                     # enc_out replicated on d
        return tuple(spec)

    return map_with_path(rule, state_shape)
