"""Weights and state carried into the port from numpy trees.

The JAX package's parameter and serving-state trees (nested dicts and
lists) keep their layout here: ``segments[i]["p{j}"]`` leaves stacked on
a leading repeat dim, weights as ``(in, out)`` for ``x @ w``, KV state
``layers[i]["p{j}"]["k"]`` as ``(repeats, slots, W, KVH, hd)``, Mamba
state ``conv``/``ssm`` and MoE expert leaves ``(repeats, E, ...)``.  Each
leaf keeps its own dtype; a cast to another model dtype leaves the f32
leaves of the JAX package (Mamba's ``A_log``, ``D``, ``dt_b``, the MoE
``router``, the xLSTM gate leaves, the ``ssm`` state and every xLSTM
state leaf) in f32.  A caller
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


#: leaves the JAX package keeps in f32 whatever the model dtype
F32_LEAVES = frozenset({"A_log", "D", "dt_b", "router", "ssm",
                        "w_i", "b_i", "w_f", "b_f", "w_o", "b"})
#: a state dict holding one of these keys is an xLSTM state: all f32 (the
#: mLSTM's ``conv`` window too, unlike Mamba's)
XLSTM_STATE_KEYS = frozenset({"C", "c"})


def _convert(tree, dev, dtype, key=None):
    if isinstance(tree, dict):
        if XLSTM_STATE_KEYS & set(tree):
            dtype = None
        return {k: _convert(v, dev, dtype, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, dev, dtype, key) for v in tree]
    return _tensor(tree, dev, None if key in F32_LEAVES else dtype)


def params_from_numpy(tree, device: Device = "cuda",
                      dtype: Optional[torch.dtype] = None):
    """The port's params from a numpy parameter tree (optionally cast to
    ``dtype``, f32 leaves excepted)."""
    return _convert(tree, resolve_device(device), dtype)


def state_from_numpy(tree, device: Device = "cuda",
                     dtype: Optional[torch.dtype] = None):
    """The port's serving state from a numpy state tree (optionally cast
    to ``dtype``, the f32 ``ssm`` state excepted)."""
    return _convert(tree, resolve_device(device), dtype)
