"""Analytic per-iteration performance model.

Mirrors the paper's simulator (§5.1): computation, HBM bandwidth, memory
requirements and KV-transfer costs, parameterized by ModelConfig and
InstanceSpec. Prefill is compute-bound (§3.2); decode is HBM-bound (§3.3):
per decode step the instance must stream the weights once plus every
batched request's KV cache.

A copy of the JAX package's ``repro.sim.perf``, held against it by
``tests/test_torch_sim.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.kvbytes import (bytes_per_token, fixed_state_bytes,
                                      state_bytes_at)
from repro_torch.scheduling.actions import MirrorSync, StreamState
from repro_torch.sim.devices import InstanceSpec
from repro_torch.stepplan import (DecodePlan, MixedPlan, PrefillPlan,
                                  TransferPlan)

DTYPE_BYTES = 2


@dataclass(frozen=True)
class PerfModel:
    cfg: ModelConfig
    inst: InstanceSpec

    def __post_init__(self):
        if self.kv_capacity_bytes <= 0:
            raise ValueError(
                f"instance HBM too small for {self.cfg.name!r}: weights "
                f"(+10% activations) need "
                f"{1.1 * self.weight_bytes / 1e9:.1f} GB but the instance "
                f"has {self.inst.hbm_bytes / 1e9:.1f} GB — no capacity "
                f"left for KV/serving state.  Use more/larger devices per "
                f"instance (InstanceSpec) or a smaller model.")

    @cached_property
    def weight_bytes(self) -> float:
        return self.cfg.param_count() * DTYPE_BYTES

    @cached_property
    def active_weight_bytes(self) -> float:
        """Bytes of weights actually read per decode step (MoE: active only)."""
        return self.cfg.param_count(active_only=True) * DTYPE_BYTES

    # param/arch walks are priced once; the sim calls these per iteration
    @cached_property
    def _n_active(self) -> int:
        return self.cfg.param_count(active_only=True)

    @cached_property
    def _n_attn(self) -> int:
        return sum(1 for b in self.cfg.block_pattern if b == "attn")

    @cached_property
    def _line_bytes(self) -> float:
        return bytes_per_token(self.cfg, DTYPE_BYTES)

    @cached_property
    def _fixed_bytes(self) -> int:
        return fixed_state_bytes(self.cfg, DTYPE_BYTES)

    @property
    def kv_capacity_bytes(self) -> float:
        """HBM left for serving state after weights (+10% activations)."""
        return self.inst.hbm_bytes - 1.1 * self.weight_bytes

    @cached_property
    def line_costs(self) -> "LineCosts":
        """The shared per-line cost card (``repro_torch.kvstore.LineCosts``)
        the SimStore ledger and the live PagedStore both charge from."""
        from repro_torch.kvstore import LineCosts
        return LineCosts.from_config(self.cfg, DTYPE_BYTES)

    # -- prefill (compute-bound, §3.2) --------------------------------------
    def prefill_flops(self, prompt_lens: Sequence[int]) -> float:
        n_active = self._n_active
        total = 0.0
        n_attn = self._n_attn
        for s in prompt_lens:
            total += 2.0 * n_active * s
            # causal attention: 2 matmuls * s^2/2 * heads*hd per attn layer
            total += 2.0 * n_attn * (s * s) * self.cfg.num_heads * self.cfg.head_dim
        return total

    def prefill_time(self, prompt_lens: Sequence[int]) -> float:
        if not prompt_lens:
            return 0.0
        t_compute = self.prefill_flops(prompt_lens) / (self.inst.tflops * 1e12)
        # weights must stream at least once per pass
        t_mem = self.weight_bytes / self.inst.hbm_bw
        return max(t_compute, t_mem)

    def chunked_prefill_time(self, chunks: Sequence[Tuple[int, int]]) -> float:
        """Prefill time for resumed chunks ``(start, end)``: a chunk's
        queries attend over ALL cached history rows ``[0, end)``, not
        just the chunk — the cost the live ``prefill_chunk`` path
        actually pays.  ``(0, s)`` degenerates to ``prefill_time([s])``
        exactly."""
        if not chunks:
            return 0.0
        n_active = self._n_active
        n_attn = self._n_attn
        total = 0.0
        for start, end in chunks:
            c = end - start
            total += 2.0 * n_active * c
            # causal q*k pairs: c*start full-history plus c^2/2 in-chunk,
            # scaled like prefill_flops' (s*s) convention (2 matmuls)
            total += (2.0 * n_attn * (c * c + 2.0 * c * start)
                      * self.cfg.num_heads * self.cfg.head_dim)
        t_compute = total / (self.inst.tflops * 1e12)
        t_mem = self.weight_bytes / self.inst.hbm_bw
        return max(t_compute, t_mem)

    # -- decode (HBM-bound, §3.3) --------------------------------------------
    def _decode_iter_time(self, lengths: Sequence[int],
                          block_lines: int = 0, grown: int = 0) -> float:
        """One decode iteration over the resident ``lengths``: HBM-bound
        over active weights + each request's KV read.  With
        ``block_lines`` the read is block-granular — what the paged
        gather actually DMAs — so lines round up to whole blocks;
        ``grown`` models lines already appended by earlier steps of a
        fused plan."""
        if not lengths:
            return 0.0
        # integer line totals, one multiply: bytes are exact integers in
        # float64 so this equals the per-request Σ state_bytes_at bit
        # for bit (sums stay far below 2**53)
        if block_lines:
            tot = sum(-(-(l + grown) // block_lines) * block_lines
                      for l in lengths)
        else:
            tot = sum(lengths) + grown * len(lengths)
        kv = self._line_bytes * tot + self._fixed_bytes * len(lengths)
        t_mem = (self.active_weight_bytes + kv) / self.inst.hbm_bw
        flops = 2.0 * self._n_active * len(lengths)
        t_compute = flops / (self.inst.tflops * 1e12)
        return max(max(t_mem, t_compute),
                   self.tp_collective_time(len(lengths)))

    def tp_collective_time(self, batch: int) -> float:
        """Per-step tensor-parallel all-reduce over the slice's intra
        fabric (ring: ``2 (n-1)/n`` activation bytes per layer).  Priced
        ONLY when a spec declares ``intra_link_gbps`` explicitly — the
        seed model treats the TP fabric as free, and every existing
        snapshot must stay bit-identical unless a spec opts in."""
        n = self.inst.n_devices
        if self.inst.intra_link_gbps is None or n <= 1 or batch <= 0:
            return 0.0
        act = batch * self.cfg.d_model * DTYPE_BYTES
        layers = len(self.cfg.block_pattern)
        return layers * 2.0 * (n - 1) / n * act / self.inst.intra_link_bw

    # -- step plans (THE simulator cost entry point) --------------------------
    def plan_time(self, plan) -> float:
        """Price one :class:`repro_torch.stepplan.StepPlan` — the simulator's
        only step-cost entry point: ``sim/cluster.py`` and every policy
        adapter charge iterations exclusively through here, so the cost
        arithmetic for an iteration lives in one place, keyed by the
        same plan objects the live executor runs.

        * PrefillPlan — compute-bound prompt work over the items' real
          chunk spans, including each resumed chunk's attention over
          its cached history (bucket padding is a live-compile concern,
          not modeled cost).
        * DecodePlan  — HBM-bound batch iterations over the resident
          line counts, read at the pool's block granularity (the paged
          gather DMAs whole blocks, not exact lines); ``steps`` fused
          iterations price each step at its grown lengths and pay the
          fixed per-dispatch overhead (``InstanceSpec.dispatch_s``)
          ONCE — the amortization the live engine's fused scan
          realizes.  When requests are mirrored, the per-step replica
          sync (one KV line each over the pair link) may bound each
          step instead (paper Fig. 10).
        * MixedPlan   — prefill + decode co-batched: the sum (the vLLM
          TBT spike of Fig. 5/16).
        * TransferPlan — StreamState moves the whole state over the
          link (per-layer overlapped when flagged, §4.2.4); MirrorSync
          moves only its delta lines; role flips and evictions are
          free.
        """
        if isinstance(plan, MixedPlan):
            t = self.plan_time(plan.prefill)
            if plan.decode is not None:
                t += self.plan_time(plan.decode)
            return t
        if isinstance(plan, PrefillPlan):
            return self.chunked_prefill_time(
                [(it.start, it.end) for it in plan.items])
        if isinstance(plan, DecodePlan):
            if not plan.lengths:
                return 0.0
            # mirror traffic charged from the shared ledger costs:
            # one new KV line per mirrored request per step (§4.1.2)
            t_link = (plan.mirrored * self.line_costs.mirror_bytes(1)
                      / self.inst.link_bw)
            total = self.inst.dispatch_s       # once per plan, not per step
            for j in range(max(1, plan.steps)):
                t = self._decode_iter_time(plan.lengths, plan.block_lines,
                                           grown=j)
                if plan.mirrored:
                    t = max(t, t_link)
                total += t
            return total
        if isinstance(plan, TransferPlan):
            # the fabric the bytes ride: mirror/stream between instances
            # defaults to the inter-slice link; an intra-slice plan
            # (same-host mesh slices) prices at the TP fabric's rate
            bw = self.link_bw_for(plan.link)
            if isinstance(plan.action, StreamState):
                return self.kv_transfer_time(
                    plan.lines, overlap_layers=plan.overlap_layers, bw=bw)
            if isinstance(plan.action, MirrorSync):
                return self.line_costs.mirror_bytes(plan.lines) / bw
            return 0.0  # PromoteReplica / EvictReplica: zero-cost flips
        raise TypeError(f"not a step plan: {plan!r}")

    # -- KV movement ----------------------------------------------------------
    def kv_bytes(self, length: int) -> float:
        return state_bytes_at(self.cfg, length, DTYPE_BYTES)

    def kv_transfer_time(self, length: int, *, overlap_layers: bool = False,
                         bw: float | None = None) -> float:
        """Whole-state transfer between instances. With per-layer streaming
        (AcceLLM §4.2.4) only the last layer's worth is visible latency."""
        t = self.kv_bytes(length) / (self.inst.link_bw if bw is None else bw)
        if overlap_layers:
            return t / max(1, len(self.cfg.block_pattern))
        return t

    def link_bw_for(self, link: str) -> float:
        """Bandwidth (bytes/s) of the named fabric — ``"inter"`` for the
        instance-to-instance network, ``"intra"`` for the in-slice TP
        link (``TransferPlan.link``)."""
        return (self.inst.intra_link_bw if link == "intra"
                else self.inst.inter_link_bw)

    # per-step mirror traffic is priced by the KV-store ledger:
    # SimStore.mirror_bytes_per_step (== LineCosts.mirror_bytes(1) per
    # mirrored request, the quantity the live executor counts in
    # stats['mirror_bytes'])
