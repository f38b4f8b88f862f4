"""Roofline terms of a dry-run step on the H100.

Three terms per (arch x shape x mesh), all in seconds per step:

  compute    = FLOPs_per_chip / PEAK_FLOPS
  memory     = analytic_bytes_per_chip / HBM_BW
  collective = wire_bytes_per_chip / LINK_BW

The FLOPs are the dry run's: the operations of one rank's step traced on
the meta device (``launch.dryrun.rank_program``: ``FlopCounterMode`` plus
the kernels' own counts and the loops' trip counts), so compute a rank
repeats counts.  The bytes are modelled structurally, as in the JAX
package (:func:`analytic_bytes`).  The collective term reads the record's
``collective_by_kind``: the wire bytes a chip puts on its links for each
kind of collective the rank's program issued (the recording mesh of
``repro_torch.sharding``, priced by :func:`_wire_bytes`), the role the
JAX package's ``collective_bytes`` plays on its partitioned HLO.  A
record without it (no per-rank program) gives ``t_collective = 0``, as
the JAX package's ``analyze`` does when no HLO was saved.

Hardware constants (NVIDIA H100 SXM, ``repro_torch.sim.devices.H100``):
989 TFLOP/s dense bf16 on the tensor cores, 3,350 GB/s HBM3, and 50 GB/s
a link: one 400 Gb/s InfiniBand port per card, which a 16-wide model axis
crosses since an HGX node holds 8 cards (the conservative single-link
stance).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.sim.devices import H100

PEAK_FLOPS = H100.fp16_tflops * 1e12
HBM_BW = H100.hbm_bw_gbps * 1e9
LINK_BW = 50e9

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
}


def _wire_bytes(kind: str, result_bytes: int, n: int) -> float:
    """Ring-algorithm bytes a device puts on the wire for one collective
    of ``result_bytes`` over a group of ``n``."""
    if kind == "all-gather":
        return result_bytes * (n - 1) / max(n, 1)
    if kind == "all-reduce":
        return 2.0 * result_bytes * (n - 1) / max(n, 1)
    if kind == "reduce-scatter":
        return result_bytes * (n - 1)
    if kind == "all-to-all":
        return result_bytes * (n - 1) / max(n, 1)
    return float(result_bytes)  # collective-permute


# ---------------------------------------------------------------------------
# Analytic HBM bytes
# ---------------------------------------------------------------------------

ACT_IO_FACTOR = 12   # per-layer activation reads+writes, in units of
                     # tokens x d_model x 2B (block I/O, qkv/ffn temps)


def _scan_state_bytes(cfg, shape, chips: int) -> float:
    """Per-chip HBM traffic of recurrent-state carries over a full-sequence
    pass: every scan step reads+writes the carry.  mLSTM runs chunkwise
    (state touched once per chunk of 64); mamba/sLSTM are per-step but
    their states are small."""
    if shape.kind == "decode":
        return 0.0
    from repro_torch.models.state import xlstm_dims
    B, S = shape.global_batch, shape.seq_len
    b_loc = max(B // 16, 1)                     # batch over the data axis
    total = 0.0
    for blk in cfg.block_pattern:
        if blk == "mamba":
            mc = cfg.mamba
            st = mc.expand * cfg.d_model * mc.d_state * 4
            total += 2.0 * b_loc * st * S       # r+w per step
        elif blk == "mlstm":
            _, hd = xlstm_dims(cfg, "mlstm")
            st = cfg.num_heads * hd * hd * 4
            steps = max(S // 64, 1)             # chunkwise: once per chunk
            total += 2.0 * b_loc * st * steps
        elif blk == "slstm":
            total += 2.0 * b_loc * 4 * cfg.d_model * 4 * S
    return total


def analytic_bytes(cfg, shape, chips: int = 256,
                   layout: str = "tp") -> float:
    """Per-chip HBM bytes of one step on the single-pod mesh (layout
    "tp": TP=16 on 'model', 16-way batch/FSDP on 'data'; layout "fsdp":
    pure ZeRO-3, each chip streams the full gathered weights but holds
    1/chips of batch and optimizer)."""
    from repro_torch.core.kvbytes import state_bytes_at
    tp = 1 if layout == "fsdp" else 16
    p_total = cfg.param_count() * 2
    p_active = cfg.param_count(active_only=True) * 2
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    L = cfg.num_layers

    if shape.kind == "decode":
        tokens_per_chip = max(B // 16, 1)
        w = p_active / tp                       # weights: TP-sharded read
        state = B * state_bytes_at(cfg, min(S, 1 << 30)) / chips
        acts = tokens_per_chip * d * 2 * ACT_IO_FACTOR * L
        logits = tokens_per_chip * cfg.vocab_size / tp * 4
        return w + state + acts + logits

    tokens = B * S
    # batch over data axis (tp) or the whole mesh (fsdp)
    tokens_per_chip = tokens / (chips if layout == "fsdp" else 16)
    acts = tokens_per_chip * d * 2 * ACT_IO_FACTOR * L
    logits = tokens_per_chip * cfg.vocab_size / tp * 4
    scan_state = _scan_state_bytes(cfg, shape, chips)
    if shape.kind == "prefill":
        w = p_active / tp
        kv_writes = tokens * (state_bytes_at(cfg, 1)
                              - state_bytes_at(cfg, 0)) / chips
        return w + acts + kv_writes + logits + scan_state

    # train: fwd + bwd weight reads (gathered per chip = model shard),
    # remat recompute of fwd activations, optimizer streams (FSDP-sharded)
    opt_bytes = 4 if cfg.param_count() <= 100e9 else 2
    w = 2 * p_total / tp
    opt = (2 * 2 + 2 * opt_bytes) * cfg.param_count() / chips  # p,g + m,v r/w
    # fwd + bwd + remat-fwd passes over the recurrent-state traffic
    return w + 2 * acts + opt + logits + 3 * scan_state


# ---------------------------------------------------------------------------
# Roofline record
# ---------------------------------------------------------------------------


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    t_compute: float
    t_memory: float
    t_collective: float
    model_flops: float            # useful FLOPs (6ND / 2ND), global
    hlo_flops_global: float       # the traced step's FLOPs, global
    collective_by_kind: Dict[str, float]

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.hlo_flops_global \
            if self.hlo_flops_global else float("nan")


def model_flops(cfg, shape) -> float:
    """6·N_active·D for training, 2·N_active·D for inference steps."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch  # decode: one token per request
    return 2.0 * n_active * tokens


def analyze(record: dict, cfg, shape, chips: int = 256) -> Roofline:
    """The roofline of one dry-run record: its per-chip ``flops`` (one
    rank's traced FLOPs) at the peak rate, the analytic bytes at the HBM
    rate, and its ``collective_by_kind`` wire bytes at the link rate
    (none in a record without a per-rank program)."""
    fl = record.get("flops", 0.0)
    by = analytic_bytes(cfg, shape, chips, layout=record.get("layout", "tp"))
    coll = dict(record.get("collective_by_kind") or {})
    return Roofline(
        arch=record["arch"], shape=record["shape"], mesh=record["mesh"],
        t_compute=fl / PEAK_FLOPS,
        t_memory=by / HBM_BW,
        t_collective=sum(coll.values()) / LINK_BW,
        model_flops=model_flops(cfg, shape),
        hlo_flops_global=fl * chips,
        collective_by_kind=coll,
    )
