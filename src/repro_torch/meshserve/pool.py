"""Sharded KV pool and parameter placement for one mesh slice.

``shard_params`` reuses the launch layer's TP rules
(``repro_torch.launch.specs.param_pspecs`` at ``model_n`` = the slice's
width), so serving cuts the dims training would: column-parallel q/k/v
and FFN up, row-parallel output projections, vocab-sharded embed and
lm_head, experts over the model ranks.  Each rank keeps only its own
part.  The attention projections are cut at whole heads: a rank computes
whole query heads, and keeps the KV head(s) those queries read, as vLLM
does.  Where the KV heads divide the slice that is the pspec's even cut;
where they do not (reduced starcoder2-3b's 2 KV heads at tp 4), the
ranks whose queries share a KV head each keep a copy of it, where the
JAX package's GSPMD split would hand each rank half a head.

``shard_store`` cuts a live :class:`repro_torch.kvstore.PagedStore`'s
state to the rank's part, in place: the attention K/V leaves (stacked
layout ``(R, B, W, KVH, hd)``, and an enc-dec's cross caches) keep the
rank's KV heads, so the paged decode kernel reads only the line blocks
of its own heads; every other leaf stays whole.  A rank outside the slice
keeps no state at all (the engine there is a shadow).  Block tables stay
host-side numpy, as on one device.

Where the query heads do not divide the slice, the engine runs
replicated: whole params and state on every rank of the slice, no
collective (``MeshSlice.model_axis_for``).
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple

import torch

from repro_torch.launch.specs import map_with_path, param_pspecs
from repro_torch.meshserve.collectives import Holders
from repro_torch.meshserve.topology import MeshError, MeshSlice

#: store leaves whose dim 3 is the KV head dim of the stacked
#: ``(R, B, W, KVH, hd)`` layout (k/v line caches + enc-dec cross caches)
HEAD_SHARDED = ("k", "v", "xk", "xv")
_HEAD_DIM = 3
#: attention projections, cut at whole heads
_ATTN = re.compile(r"(mixer|cross)/(wq|wk|wv|wo)$")


def head_split(cfg, tp: int
               ) -> Optional[List[Tuple[Tuple[int, ...], Tuple[int, ...]]]]:
    """Per model rank, the query heads it computes and the KV heads it
    keeps for them (in local order); None where the query heads do not
    divide ``tp`` (the slice runs replicated).  A rank whose queries span
    whole KV groups keeps those groups' heads; one whose queries lie in
    one group keeps that head; otherwise each query keeps its own copy."""
    H, KVH = cfg.num_heads, cfg.num_kv_heads
    if H % tp:
        return None
    G, n = H // KVH, H // tp
    out = []
    for r in range(tp):
        q = tuple(range(r * n, (r + 1) * n))
        kv_of = [h // G for h in q]
        uniq = sorted(set(kv_of))
        per = n // len(uniq)
        if n % len(uniq) == 0 and all(kv_of[i] == uniq[i // per]
                                      for i in range(n)):
            out.append((q, tuple(uniq)))
        else:
            out.append((q, tuple(kv_of)))
    return out


def holders(cfg, sl: MeshSlice) -> Holders:
    """Where a store on ``sl`` keeps its KV heads, rank by rank."""
    split = head_split(cfg, sl.tp) if sl.model_axis_for(cfg) else None
    whole = tuple(range(cfg.num_kv_heads))
    heads = (tuple(kv for _, kv in split) if split is not None
             else (whole,) * sl.tp)
    return Holders(sl.ranks, heads)


def local_config(cfg, sl: MeshSlice):
    """``cfg`` with this rank's KV head count: the shape of its state."""
    kv = holders(cfg, sl).heads_of(sl.rank)
    return dataclasses.replace(cfg, num_kv_heads=len(kv))


def _columns(heads, hd: int, device) -> torch.Tensor:
    return torch.as_tensor([h * hd + j for h in heads for j in range(hd)],
                           device=device)


def shard_params(cfg, params, sl: MeshSlice):
    """This rank's part of ``params`` on the slice's device, under the
    slice's TP layout.  The input tree is untouched: every engine of a pod
    cuts the same weights.  A replicated slice (heads do not divide) gets
    the whole tree."""
    if not sl.holds:
        raise MeshError(f"rank {sl.rank} is not on slice {sl.index} "
                        f"(ranks {sl.ranks})")
    dev = sl.device
    split = head_split(cfg, sl.tp) if sl.model_axis_for(cfg) else None
    if split is None or sl.tp == 1:
        return map_with_path(lambda ps, t: t.to(dev), params)
    r = sl.model_rank
    q_heads, kv_heads = split[r]
    specs = param_pspecs(cfg, params, mode="serve", model_n=sl.tp)
    flat_specs = {}
    map_with_path(lambda ps, s: flat_specs.__setitem__(ps, s), specs)

    def cut(ps, t):
        spec = flat_specs[ps]
        dims = [i for i, ax in enumerate(spec) if ax == "model"]
        m = _ATTN.search(ps)
        if m and cfg.attention_kind == "gqa":
            name = m.group(2)
            dim = t.dim() - (2 if name == "wo" else 1)
            if dims != [dim]:
                raise MeshError(f"{ps}: its pspec {spec} does not cut the "
                                f"head dim {dim} at tp {sl.tp}")
            heads = kv_heads if name in ("wk", "wv") else q_heads
            idx = _columns(heads, cfg.head_dim, t.device)
            return t.index_select(dim, idx).to(dev).contiguous()
        if not dims:
            return t.to(dev)
        (dim,) = dims
        n = t.shape[dim] // sl.tp
        return t.narrow(dim, r * n, n).to(dev, copy=True).contiguous()

    return map_with_path(cut, params)


def shard_store(store, sl: MeshSlice) -> None:
    """Cut ``store``'s state to this rank's part on the slice's device,
    in place, and record where the rest lives (``store.holders``)."""
    cfg = store.cfg
    store.holders = holders(cfg, sl)
    if not sl.holds:
        store.state = None
        return
    mine = store.holders.heads_of(sl.rank)
    keep = None if mine == tuple(range(cfg.num_kv_heads)) else mine
    dev = sl.device
    for path in store._paths:
        i, pj, key = path[:3]
        leaf = store.state["layers"][i][pj][key]
        if keep is not None and key in HEAD_SHARDED:
            leaf = leaf.index_select(
                _HEAD_DIM, torch.as_tensor(keep, device=leaf.device))
        store.state["layers"][i][pj][key] = leaf.to(dev)
    if "enc_out" in store.state:
        store.state["enc_out"] = store.state["enc_out"].to(dev)
