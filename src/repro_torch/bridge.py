"""Weights and state carried into the port from numpy trees.

The JAX package's parameter and serving-state trees (nested dicts and
lists) keep their layout here: ``segments[i]["p{j}"]`` leaves stacked on
a leading repeat dim, weights as ``(in, out)`` for ``x @ w``, KV state
``layers[i]["p{j}"]["k"]`` as ``(repeats, slots, W, KVH, hd)``.  A caller
turns a JAX tree into numpy first (``jax.tree_util.tree_map(np.asarray,
tree)``); this module never sees a JAX object.  Arrays are copied, so a
read-only numpy buffer never backs a tensor the port writes in place.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.device import Device, resolve_device

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.float16): torch.float16,
           np.dtype(np.int32): torch.int32}


def _tensor(a, dev: torch.device, dtype: Optional[torch.dtype]):
    a = np.asarray(a)
    if a.dtype in _DTYPES:
        t = torch.from_numpy(np.array(a, copy=True))
    elif a.dtype.name == "bfloat16":  # ml_dtypes: bits travel as float32
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        raise TypeError(f"unsupported leaf dtype {a.dtype}")
    return t.to(device=dev, dtype=dtype if dtype is not None else t.dtype)


def _convert(tree, dev, dtype):
    if isinstance(tree, dict):
        return {k: _convert(v, dev, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, dev, dtype) for v in tree]
    return _tensor(tree, dev, dtype)


def params_from_numpy(tree, device: Device = "cuda",
                      dtype: Optional[torch.dtype] = None):
    """The port's params from a numpy parameter tree (optionally cast)."""
    return _convert(tree, resolve_device(device), dtype)


def state_from_numpy(tree, device: Device = "cuda",
                     dtype: Optional[torch.dtype] = None):
    """The port's serving state from a numpy state tree."""
    return _convert(tree, resolve_device(device), dtype)
