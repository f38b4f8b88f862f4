"""Seeded weights of a dense decoder, drawn on the device in the served
dtype, one call per kind of leaf stacked over the layers.

The benchmark's own layout (:func:`draw`) is what the reference reads;
:func:`port_tree` gives the same tensors, not copies, in the nested layout
that ``repro_torch.api.build_cluster(params=...)`` takes: one segment
whose leaves stack the layers, ``{"embed", "segments": [{"p0": {"norm1",
"mixer": {"wq", "wk", "wv", "wo"}, "norm2", "ffn": {["w_gate",] "w_up",
"w_down"}}}], "final_norm"[, "lm_head"]}``.
"""
from __future__ import annotations

from typing import Dict

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def shapes(cfg: Dict) -> Dict[str, tuple]:
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    H, KVH, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    ff, V = cfg["intermediate_size"], cfg["vocab_size"]
    out = {"embed": (V, d), "norm1": (L, d), "wq": (L, d, H * hd),
           "wk": (L, d, KVH * hd), "wv": (L, d, KVH * hd),
           "wo": (L, H * hd, d), "norm2": (L, d), "w_up": (L, d, ff),
           "w_down": (L, ff, d), "final_norm": (d,)}
    if cfg["hidden_act"] == "silu":
        out["w_gate"] = (L, d, ff)
    if not cfg["tie_word_embeddings"]:
        out["lm_head"] = (d, V)
    return out


def draw(cfg: Dict, seed: int, device, dtype: str = None
         ) -> Dict[str, torch.Tensor]:
    """Matrices fan-in normal, the embedding normal with std 0.02, norm
    weights 1 + 0.1 x normal; from a generator on ``device`` seeded by
    ``seed``."""
    dt = _DTYPES[dtype or cfg["torch_dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    out = {}
    for name, shape in shapes(cfg).items():
        w = torch.randn(shape, generator=gen, device=device, dtype=dt)
        if name.startswith("norm") or name == "final_norm":
            w.mul_(0.1).add_(1.0)
        elif name == "embed":
            w.mul_(0.02)
        else:
            w.mul_(shape[-2] ** -0.5)
        out[name] = w
    return out


def port_tree(cfg: Dict, w: Dict[str, torch.Tensor]) -> Dict:
    ffn = {k: w[k] for k in ("w_gate", "w_up", "w_down") if k in w}
    tree = {"embed": w["embed"],
            "segments": [{"p0": {
                "norm1": w["norm1"],
                "mixer": {k: w[k] for k in ("wq", "wk", "wv", "wo")},
                "norm2": w["norm2"], "ffn": ffn}}],
            "final_norm": w["final_norm"]}
    if "lm_head" in w:
        tree["lm_head"] = w["lm_head"]
    return tree

