"""Sharded state and parameter placement for one mesh slice.

Explicit tensor parallelism (Megatron-style, one process per rank) can
only cut a leaf where every rank's part computes whole: GSPMD reshards
around any cut, a rank's own matmuls cannot.  So a rank's part of every
leaf comes from one rule table, by block kind and leaf name
(:data:`PARAM_RULES`, :data:`STATE_RULES`), and not from the launch
layer's ``param_pspecs``, which stays the dry run's layout.  A rule is

  * ``(dim, sections)``: a contiguous cut of ``dim`` into ``tp`` equal
    parts, one per rank, of each of ``sections`` packed tensors (Mamba's
    ``in_proj`` packs [x | z], the sLSTM FFN's ``w_up`` [gate | val]);
    where a section does not divide the slice the leaf stays whole, and
    since every leaf of a module carries the same cut dim, the module
    then runs whole on every rank;
  * ``(dim, "q")`` / ``(dim, "kv")``: the GQA head cut of
    :func:`head_split`: a rank computes whole query heads and keeps the
    KV head(s) those queries read, as vLLM does.  Where the KV heads
    divide the slice that is the even cut; where they do not (reduced
    starcoder2-3b's 2 KV heads at tp 4), the ranks whose queries share a
    KV head each keep a copy of it;
  * ``(dim, "h")``: a contiguous cut at whole heads (MLA's per-head
    projections, every mLSTM leaf): the cut of ``(dim, 1)``, but only
    where the query heads divide the slice; a width that divides while
    the heads do not (xlstm-1.3b's ``w_up`` at tp 16) would split a head;
  * absent: the leaf is whole on every rank.

The head-bound rules (``"q"``, ``"kv"``, ``"h"``) leave their module
whole where the query heads do not divide the slice: a rank then
computes every head of it and issues no collective for it.  Every other
leaf keeps its cut wherever its own dim divides, whatever the heads, as
the JAX package's ``param_pspecs`` cuts each dim that divides.

The cuts, by block:

  * GQA attention, the encoder's and cross attention: ``wq``/``wo`` at
    whole query heads, ``wk``/``wv`` at the rank's KV heads; ``wo`` is
    row-parallel, its partials summed.
  * MLA: ``wq_b``, ``wkv_b`` and ``wo`` at whole heads; ``wq_a``,
    ``wkv_a`` and their norms whole (the norms normalise the whole
    latent), and so is the latent cache.
  * Mamba: the inner channels ``d_in``: both halves of ``in_proj``, the
    conv, ``dt_w``'s columns, ``dt_b``, ``A_log``, ``D``, and the rows of
    the row-parallel ``x_proj`` (dt, B and C need every channel: the
    partials are summed in f32) and ``out_proj``; the scan runs on the
    local channels.
  * mLSTM: whole heads: the rank's heads' columns of ``w_up``, ``w_z``,
    the conv and ``w_o``, its heads of ``wq``/``wk``/``wv`` and the
    i/f gates, ``w_down``'s rows; the whole recurrence is local.
  * sLSTM: the recurrence (``w_in``, ``r``, ``b``) whole on every rank:
    its headwise recurrent product feeds every unit's gates from every
    head, so a head cut would need a gather every time step.  Its gated
    FFN is cut: each half of ``w_up``, ``w_down``'s rows.
  * dense FFNs (the shared experts and Arctic's residual too):
    column-parallel ``w_gate``/``w_up``, row-parallel ``w_down``; routed
    experts over the ranks (expert dim), the router whole.
  * the vision projector: ``w1`` column-parallel, ``w2`` row-parallel
    (summed in f32, as the prefix is computed in f32).
  * ``embed`` and ``lm_head`` by vocab rows; norms whole.

``shard_store`` cuts a live :class:`repro_torch.kvstore.PagedStore`'s
state to the rank's part, in place, by :data:`STATE_RULES`: GQA K/V and
cross K/V by the rank's KV heads, Mamba ``conv``/``ssm`` by channel,
mLSTM ``C``/``n``/``m`` by head and its ``conv`` by channel; the sLSTM
state, the MLA latent and ``enc_out`` stay whole.  :func:`local_state`
builds a rank's scratch state at those shapes.  A rank outside the slice
keeps no state at all (the engine there is a shadow).  Block tables stay
host-side numpy, as on one device.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple, Union

import torch

from repro_torch.launch.specs import map_with_path
from repro_torch.meshserve.collectives import Holders
from repro_torch.meshserve.topology import MeshError, MeshSlice

#: a rule: (dim, sections) of a contiguous cut, (dim, "q" | "kv") of the
#: GQA head cut, or (dim, "h") of a contiguous cut at whole heads
Rule = Tuple[int, Union[int, str]]

_GQA_PARAMS = {"wq": (-1, "q"), "wk": (-1, "kv"), "wv": (-1, "kv"),
               "wo": (-2, "q")}
_FFN = {"w_gate": (-1, 1), "w_up": (-1, 1), "w_down": (-2, 1)}

#: per block kind, per leaf name: the cut of a parameter leaf (a leaf not
#: named is whole on every rank)
PARAM_RULES: Dict[str, Dict[str, Rule]] = {
    "gqa": _GQA_PARAMS,
    "mla": {"wq_b": (-1, "h"), "wkv_b": (-1, "h"), "wo": (-2, "h")},
    "mamba": {"in_proj": (-1, 2), "conv_w": (-1, 1), "conv_b": (-1, 1),
              "x_proj": (-2, 1), "dt_w": (-1, 1), "dt_b": (-1, 1),
              "A_log": (-2, 1), "D": (-1, 1), "out_proj": (-2, 1)},
    "mlstm": {"w_up": (-1, "h"), "w_z": (-1, "h"), "conv_w": (-1, "h"),
              "conv_b": (-1, "h"), "w_o": (-1, "h"), "wq": (-3, "h"),
              "wk": (-3, "h"), "wv": (-3, "h"), "w_i": (-2, "h"),
              "w_f": (-2, "h"), "b_i": (-1, "h"), "b_f": (-1, "h"),
              "w_down": (-2, "h")},
    "slstm": {"w_up": (-1, 2), "w_down": (-2, 1)},
    "ffn": _FFN,
    "experts": {"w_gate": (-3, 1), "w_up": (-3, 1), "w_down": (-3, 1)},
    "proj": {"w1": (-1, 1), "w2": (-2, 1)},
    "model": {"embed": (0, 1), "lm_head": (-1, 1)},
}

#: per block kind, per state leaf: its cut (the stacked layouts of
#: ``repro_torch.models.state``; a leaf not named, and ``enc_out``, is
#: whole)
STATE_RULES: Dict[str, Dict[str, Rule]] = {
    "gqa": {"k": (-2, "kv"), "v": (-2, "kv"), "xk": (-2, "kv"),
            "xv": (-2, "kv")},
    "mla": {},
    "mamba": {"conv": (-1, 1), "ssm": (-2, 1)},
    "mlstm": {"C": (-3, "h"), "n": (-2, "h"), "m": (-1, "h"),
              "conv": (-1, "h")},
    "slstm": {},
}


def head_split(cfg, tp: int
               ) -> Optional[List[Tuple[Tuple[int, ...], Tuple[int, ...]]]]:
    """Per model rank, the query heads it computes and the KV heads it
    keeps for them (in local order); None where the query heads do not
    divide ``tp`` (every head-bound module then stays whole).  A rank
    whose queries span whole KV groups keeps those groups' heads; one
    whose queries lie in one group keeps that head; otherwise each query
    keeps its own copy."""
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


# ---------------------------------------------------------------------------
# which rule a leaf takes
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _segments(cfg, decoder: bool = True):
    from repro_torch.models.blocks import layer_specs, plan_segments
    return plan_segments(layer_specs(cfg, decoder=decoder))


def _layer_block(cfg, parts: List[str]) -> Tuple[str, bool]:
    """The block kind ("attn", "mamba", "mlstm", "slstm") and MoE flag of
    the layer a param path lies in: ``segments/i/pj/...``,
    ``encoder/segments/i/pj/...`` or the MTP head's ``mtp/layer/...``."""
    if parts[0] == "mtp":
        return "attn", False
    decoder = parts[0] != "encoder"
    if not decoder:
        parts = parts[1:]
    seg = _segments(cfg, decoder)[int(parts[1])]
    spec = seg.specs[int(parts[2][1:])]
    return spec.block, spec.is_moe


def _attention(cfg) -> str:
    return "mla" if cfg.attention_kind == "mla" else "gqa"


def param_rule(cfg, path: str) -> Optional[Rule]:
    """The rule table's entry for the param leaf at ``path`` (a path of
    ``launch.specs.map_with_path``), or None: whole."""
    parts = path.split("/")
    name = parts[-1]
    if len(parts) == 1:
        return PARAM_RULES["model"].get(name)
    parent = parts[-2]
    if parent == "proj":
        return PARAM_RULES["proj"].get(name)
    if parent == "cross":
        return PARAM_RULES["gqa"].get(name)
    if parent in ("shared", "dense_residual"):
        return PARAM_RULES["ffn"].get(name)
    if parent not in ("mixer", "ffn"):
        return None                         # norms, the MTP combine
    block, is_moe = _layer_block(cfg, parts)
    if parent == "ffn":
        return PARAM_RULES["experts" if is_moe else "ffn"].get(name)
    kind = _attention(cfg) if block == "attn" else block
    return PARAM_RULES[kind].get(name)


def state_rule(cfg, block: str, key: str) -> Optional[Rule]:
    """The rule table's entry for the state leaf ``key`` of a ``block``
    layer ("attn", "mamba", "mlstm", "slstm"), or None: whole."""
    kind = _attention(cfg) if block == "attn" else block
    return STATE_RULES[kind].get(key)


def _columns(heads, hd: int) -> List[int]:
    return [h * hd + j for h in heads for j in range(hd)]


def kept(rule: Optional[Rule], size: int, tp: int, r: int,
         split: Optional[list] = None, unit: int = 1
         ) -> Optional[List[int]]:
    """The indices along the rule's dim (of ``size``) that model rank
    ``r`` of ``tp`` keeps, in local order; None: the whole dim.  ``split``
    is :func:`head_split`'s (None: the head-bound rules keep the whole
    dim), ``unit`` the width of one head along the dim (``head_dim`` for
    projections, 1 for a cache's head axis)."""
    if rule is None or tp == 1:
        return None
    _, how = rule
    if how in ("q", "kv", "h") and split is None:
        return None
    if how in ("q", "kv"):
        q_heads, kv_heads = split[r]
        return _columns(q_heads if how == "q" else kv_heads, unit)
    if how == "h":
        how = 1
    sec = size // how
    if sec % tp or sec < tp:
        return None
    n = sec // tp
    return [s * sec + r * n + j for s in range(how) for j in range(n)]


def _take(t: torch.Tensor, dim: int, idx: Optional[List[int]], dev
          ) -> torch.Tensor:
    if idx is None:
        return t.to(dev)
    lo = idx[0]
    if idx == list(range(lo, lo + len(idx))):
        return t.narrow(dim, lo, len(idx)).to(dev, copy=True).contiguous()
    return t.index_select(dim, torch.as_tensor(idx, device=t.device)).to(
        dev).contiguous()


# ---------------------------------------------------------------------------
# params, state
# ---------------------------------------------------------------------------


def shard_params(cfg, params, sl: MeshSlice):
    """This rank's part of ``params`` on the slice's device, by the rule
    table.  The input tree is untouched: every engine of a pod cuts the
    same weights."""
    if not sl.holds:
        raise MeshError(f"rank {sl.rank} is not on slice {sl.index} "
                        f"(ranks {sl.ranks})")
    dev = sl.device
    split = head_split(cfg, sl.tp)

    def cut(ps, t):
        rule = param_rule(cfg, ps)
        if rule is None:
            return t.to(dev)
        dim = rule[0] % t.dim()
        idx = kept(rule, t.shape[dim], sl.tp, sl.model_rank, split,
                   unit=cfg.head_dim)
        return _take(t, dim, idx, dev)

    return map_with_path(cut, params)


def _state_paths(cfg):
    """(segment, part, block) of every layer-state position."""
    return [(i, f"p{j}", spec.block)
            for i, seg in enumerate(_segments(cfg))
            for j, spec in enumerate(seg.specs)]


def holders(cfg, sl: MeshSlice, state) -> Holders:
    """Where a store on ``sl`` keeps ``state`` (a whole serving state, or
    its meta twin), rank by rank: per leaf the rule table cuts, its
    (negative) dim and the global indices each model rank keeps; a leaf
    not recorded is whole on every rank."""
    if sl.tp == 1:
        return Holders(sl.ranks)
    split = head_split(cfg, sl.tp)
    cuts = {}
    for i, pj, block in _state_paths(cfg):
        for key, leaf in state["layers"][i][pj].items():
            rule = state_rule(cfg, block, key)
            if rule is None:
                continue
            size = leaf.shape[rule[0]]
            idx = [kept(rule, size, sl.tp, r, split) for r in range(sl.tp)]
            if all(x is None or x == list(range(size)) for x in idx):
                continue
            cuts[(i, pj, key)] = (rule[0] % leaf.dim() - leaf.dim(),
                                  tuple(map(_units, idx)))
    return Holders(sl.ranks, cuts)


def _units(idx: List[int]):
    """``idx`` as a ``range`` where it is one block (cheap to hash)."""
    lo = idx[0]
    return range(lo, lo + len(idx)) if idx == list(
        range(lo, lo + len(idx))) else tuple(idx)


def local_state(cfg, sl: MeshSlice, batch: int, seq_len: int,
                long_context: bool = False):
    """A zero serving state of this rank's part (``init_state``'s tree at
    the rule table's per-rank shapes) on the slice's device (the meta
    device for the dry run's per-rank program)."""
    from repro_torch.models import init_state
    meta = init_state(cfg, batch, seq_len, long_context=long_context,
                      device="meta")
    cuts = holders(cfg, sl, meta).cuts
    out = {"layers": [{pj: {} for pj in layer} for layer in meta["layers"]]}
    for i, layer in enumerate(meta["layers"]):
        for pj, part in layer.items():
            for key, leaf in part.items():
                shape = list(leaf.shape)
                if (i, pj, key) in cuts:
                    dim, layout = cuts[(i, pj, key)]
                    shape[dim] = len(layout[sl.model_rank])
                out["layers"][i][pj][key] = torch.zeros(
                    shape, dtype=leaf.dtype, device=sl.device)
    if "enc_out" in meta:
        out["enc_out"] = torch.zeros(meta["enc_out"].shape,
                                     dtype=meta["enc_out"].dtype,
                                     device=sl.device)
    return out


def shard_store(store, sl: MeshSlice) -> None:
    """Cut ``store``'s state to this rank's part on the slice's device,
    in place, and record where the rest lives (``store.holders``: each
    cut leaf's layout, which a pull between slices plans from)."""
    store.holders = hold = holders(store.cfg, sl, store.state)
    if not sl.holds:
        store.state = None
        return
    dev = sl.device
    for i, layer in enumerate(store.state["layers"]):
        for pj, part in layer.items():
            for key, leaf in part.items():
                cut = hold.cuts.get((i, pj, key))
                part[key] = (leaf.to(dev) if cut is None else _take(
                    leaf, cut[0], list(cut[1][sl.model_rank]), dev))
    if "enc_out" in store.state:
        store.state["enc_out"] = store.state["enc_out"].to(dev)
