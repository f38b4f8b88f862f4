"""Minimal dependency-free checkpointing: tensor tree <-> .npz with the
JAX package's path keys (``repro.training.checkpoint``).

A leaf's key is its path from the root: dict keys in sorted order, list
items as ``L{i}`` and tuple items as ``T{i}``, joined by ``/`` (``/embed``,
``/segments/L0/p0/mixer/wq``).  A checkpoint either package writes
restores in the other.

bf16 leaves: numpy has no bfloat16.  This module writes a bf16 leaf
widened to float32, which is exact, and which both packages restore into
a bf16 leaf bit for bit.  The JAX package's writer stores a bf16 leaf as
``np.asarray`` of it: 2-byte voids (``|V2``) holding the raw bf16 bits;
:func:`restore` reads those bits back as bf16.  (The JAX package's own
``restore`` cannot read them: JAX refuses a void array.)  Every other
dtype is written as it is and cast to the target leaf's dtype on restore.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _flatten(tree) -> dict:
    flat = {}

    def walk(prefix: str, node: Any):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}/{k}", node[k])
        elif isinstance(node, (list, tuple)):
            tag = "T" if isinstance(node, tuple) else "L"
            for i, v in enumerate(node):
                walk(f"{prefix}/{tag}{i}", v)
        else:
            flat[prefix] = _numpy(node)

    walk("", tree)
    return flat


def save(path: str, tree):
    flat = _flatten(tree)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def _leaf(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2 or like.dtype != torch.bfloat16:
            raise TypeError(f"a {arr.dtype} leaf restores only into bf16, "
                            f"not {like.dtype}")
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=like.device, dtype=like.dtype).reshape(like.shape)


def restore(path: str, like):
    """Restore into the structure of ``like`` (shapes, dtypes and devices
    preserved)."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")

    def walk(prefix: str, node: Any):
        if isinstance(node, dict):   # in ``like``'s key order
            return {k: walk(f"{prefix}/{k}", v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            tag = "T" if isinstance(node, tuple) else "L"
            out = [walk(f"{prefix}/{tag}{i}", v) for i, v in enumerate(node)]
            return tuple(out) if isinstance(node, tuple) else out
        return _leaf(data[prefix], node)

    with data:
        return walk("", like)
