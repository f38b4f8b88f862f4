"""Partition-spec rules for parameters, and the parallel layout choice.

A copy of the JAX package's ``repro.launch.specs`` path+shape rules over
the port's nested-dict trees: ``param_pspecs`` gives every leaf a
partition-spec tuple (one entry per dim: an axis name, a tuple of axis
names, or None), with divisibility-checked rules:

  * TP ("model") on head/ffn/expert dims,
  * FSDP ("data", + "pod" when multi-pod) on a second dim in train mode,
  * layout "fsdp": no TP, the largest divisible dim over every axis.

``meshserve.pool.shard_params`` cuts a serving slice's params by these
specs at ``model_n`` = the slice's TP width, at whole heads for the
attention projections.  The input and serving-state specs
(``token_layout``, ``input_specs``, ``state_pspecs``) need the dry run's
input shapes, which come with the dry-run slice of the port (slice 12).
"""
from __future__ import annotations

import os
import re
from typing import Any, Callable

# ---------------------------------------------------------------------------
# Input and state specs: the dry-run slice
# ---------------------------------------------------------------------------


def _dry_run_slice(name: str):
    def waits(*args, **kwargs):
        raise NotImplementedError(
            f"{name} needs the dry run's InputShape / INPUT_SHAPES, which "
            f"come with the dry-run slice of the port (slice 12)")
    waits.__name__ = name
    return waits


token_layout = _dry_run_slice("token_layout")
input_specs = _dry_run_slice("input_specs")
state_pspecs = _dry_run_slice("state_pspecs")


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
