"""PagedStore: the engine's block-table KV store.

Owns the serving-state tensors of one instance (the tree
:func:`repro_torch.models.init_state` builds) *and* the block ledger over
them.  Physical layout is **slot-affine**, as in the JAX package: each
request slot owns a contiguous region of the pool, ``kv_capacity /
block_lines`` line blocks backing rows of its dense cache window, so the
layer stack's state layout is untouched while allocation and headroom are
block-granular.  :meth:`decode_block_tables` feeds the paged decode kernel
(``repro_torch.kernels.decode_attention``), which gathers K/V through them.

The state is updated in place.  Whatever leaves the store (an exported
slot) is a copy, so later in-place writes on either side never alias.

:meth:`copy_lines` is the per-step redundancy mirror: only the KV rows of
the new accounting lines move, O(delta) per step, not O(kv_capacity).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import Device
from repro_torch.kvstore.base import BlockLedger, KVStoreError, LineCosts
from repro_torch.models import init_state
from repro_torch.models.blocks import layer_specs, plan_segments

#: attention-state keys indexed by KV line (axis 2 of the stacked leaf)
LINE_KEYS = ("k", "v")


def pick_block_lines(kv_capacity: int, requested: int = 16) -> int:
    """Largest divisor of the cache window that is <= ``requested``."""
    b = max(1, min(requested, kv_capacity))
    while kv_capacity % b:
        b -= 1
    return b


class PagedStore:
    def __init__(self, cfg: ModelConfig, num_slots: int, kv_capacity: int,
                 block_lines: Optional[int] = None, device: Device = "cuda"):
        self.cfg = cfg
        self.num_slots = num_slots
        self.kv_capacity = kv_capacity
        if block_lines is not None and kv_capacity % block_lines:
            # an explicit geometry request must not be silently rounded
            raise KVStoreError(
                f"block_lines {block_lines} does not divide "
                f"kv_capacity {kv_capacity}")
        self.block_lines = pick_block_lines(kv_capacity, block_lines or 16)
        self.costs = LineCosts.from_config(cfg)
        self.line_blocks_per_slot = kv_capacity // self.block_lines
        self._has_fixed = self.costs.fixed_bytes > 0
        self.blocks_per_slot = self.line_blocks_per_slot + (
            1 if self._has_fixed else 0)
        self.ledger = BlockLedger(
            self.costs, num_blocks=num_slots * self.blocks_per_slot,
            block_lines=self.block_lines,
            max_blocks_per_seq=self.line_blocks_per_slot)
        self.state = init_state(cfg, num_slots, kv_capacity, device=device)
        self.slot_rid: Dict[int, int] = {}
        self.rid_slot: Dict[int, int] = {}
        #: line-indexed leaves: (segment index, part key, leaf key)
        self._paths: List[Tuple[int, str, str]] = []
        for i, seg in enumerate(plan_segments(layer_specs(cfg))):
            for j in range(len(seg.specs)):
                for key in self.state["layers"][i][f"p{j}"]:
                    if key not in LINE_KEYS:
                        raise KVStoreError(f"state leaf {key!r} is not a KV "
                                           f"line leaf")
                    self._paths.append((i, f"p{j}", key))

    def _leaf(self, state, path) -> torch.Tensor:
        i, pj, key = path
        return state["layers"][i][pj][key]

    # -- capacity ------------------------------------------------------------
    def used_bytes(self) -> float:
        return self.ledger.used_bytes()

    def free_blocks(self) -> int:
        return self.ledger.free_blocks()

    # -- block tables ----------------------------------------------------------
    def slot_block_ids(self, slot: int) -> List[int]:
        lo = slot * self.blocks_per_slot
        return list(range(lo, lo + self.blocks_per_slot))

    def decode_block_tables(self, rids: List[int], blocks: int) -> np.ndarray:
        """Padded ``(len(rids), blocks)`` int32 block tables for the paged
        decode kernel.  Slot-affine placement makes each row the identity
        run over its slot's pool region, so one table covers a whole fused
        multi-step decode.  Entries past a request's live lines are masked
        by the kernel's ``lengths``, never read as valid KV."""
        blocks = min(blocks, self.line_blocks_per_slot)
        out = np.empty((len(rids), blocks), np.int32)
        for i, rid in enumerate(rids):
            base = self.rid_slot[rid] * self.line_blocks_per_slot
            out[i] = np.arange(base, base + blocks, dtype=np.int32)
        return out

    def pool_view(self, arr: torch.Tensor) -> torch.Tensor:
        """View one request-batched cache leaf ``(B, W, ...)`` as the block
        pool ``(B * W/block_lines, block_lines, ...)``."""
        B, W = arr.shape[:2]
        return arr.view((B * (W // self.block_lines), self.block_lines)
                        + tuple(arr.shape[2:]))

    # -- ledger ops (slot-affine) ----------------------------------------------
    def alloc(self, rid: int, slot: int, lines: int,
              synced: Optional[int] = None) -> None:
        """Admit ``rid`` into ``slot``'s own block region."""
        if slot in self.slot_rid:
            raise KVStoreError(f"slot {slot} already backs "
                               f"rid {self.slot_rid[slot]}")
        self.ledger.alloc(rid, lines, block_ids=self.slot_block_ids(slot),
                          synced=synced)
        self.slot_rid[slot] = rid
        self.rid_slot[rid] = slot

    def _grow_hint(self, rid: int) -> List[int]:
        """Free own-region blocks for the *next* logical positions."""
        ids = self.slot_block_ids(self.rid_slot[rid])
        off = 1 if self._has_fixed else 0
        return ids[off + len(self.ledger.tables[rid]):]

    def append_line(self, rid: int, n: int = 1) -> int:
        return self.ledger.append_line(rid, n,
                                       block_ids=self._grow_hint(rid))

    def set_lines(self, rid: int, lines: int) -> int:
        cur = self.ledger.lines(rid)
        if lines > cur:
            return self.append_line(rid, lines - cur)
        return self.ledger.set_lines(rid, lines)

    def free_slot(self, slot: int) -> int:
        """Release the slot's request; returns blocks freed."""
        rid = self.slot_rid.pop(slot, None)
        if rid is None:
            return 0
        self.rid_slot.pop(rid)
        return self.ledger.free(rid)

    def slot_used_blocks(self, slot: int) -> List[int]:
        """Own-region blocks still referenced; a slot is reusable for fresh
        prefill only once this is empty."""
        return [b for b in self.slot_block_ids(slot)
                if self.ledger.refcount(b) > 0]

    def shared_head_lines(self, rid: int) -> int:
        return self.ledger.shared_head_lines(rid)

    def lines(self, rid: int) -> int:
        return self.ledger.lines(rid)

    def synced_line(self, rid: int) -> int:
        return self.ledger.synced_line(rid)

    def mark_synced(self, rid: int, line: Optional[int] = None):
        self.ledger.mark_synced(rid, line)

    # -- whole-slot state movement ---------------------------------------------
    def extract_slot(self, slot: int):
        """Per-request state (batch dim kept, size 1), as a copy: the store
        keeps writing its own leaves in place."""
        out = {"layers": [{pj: {} for pj in seg}
                          for seg in self.state["layers"]]}
        for path in self._paths:
            i, pj, key = path
            out["layers"][i][pj][key] = \
                self._leaf(self.state, path)[:, slot: slot + 1].clone()
        return out

    def merge_slot(self, slot: int, sub_state, src_slot: int = 0):
        """Install ``sub_state`` (batch row ``src_slot``) into ``slot``,
        whole-window (row bounds clamp to the smaller of the two windows).
        Batch is dim 1 of the layer leaves (dim 0 is the repeat dim)."""
        self.merge_slot_rows(slot, sub_state, 0, self.kv_capacity,
                             src_slot=src_slot)

    def merge_slot_rows(self, slot: int, sub_state, lo: int, hi: int,
                        src_slot: int = 0):
        """Copy ``sub_state``'s batch row ``src_slot`` into ``slot``, KV rows
        ``[lo, hi)`` only (clamped to the smaller window): the merge for
        bucket-sized prefill scratch."""
        for path in self._paths:
            dst = self._leaf(self.state, path)
            src = self._leaf(sub_state, path)
            h = min(hi, src.shape[2], dst.shape[2])
            l = min(lo, h)
            if h > l:
                dst[:, slot, l:h] = src[:, src_slot, l:h]

    # -- delta line copy (the mirror) ------------------------------------------
    def copy_lines(self, src: "PagedStore", src_slot: int, dst_slot: int,
                   from_line: int, to_line: int) -> float:
        """Copy only the KV rows of accounting lines ``[from_line,
        to_line)`` from ``src``'s slot into ours; returns the bytes moved.
        Accounting line ``L`` reserves physical row ``L-1`` (the newest
        sampled token's KV is written by the *next* decode step), so rows
        ``[from_line-1, to_line-1)`` move, modulo the ring window."""
        lo, hi = max(0, from_line - 1), max(0, to_line - 1)
        if hi > lo:
            for path in self._paths:
                dst = self._leaf(self.state, path)
                cap = dst.shape[2]
                pos = torch.tensor([p % cap for p in range(lo, hi)],
                                   dtype=torch.long, device=dst.device)
                dst[:, dst_slot, pos] = \
                    self._leaf(src.state, path)[:, src_slot, pos]
        return self.costs.mirror_bytes(max(0, to_line - from_line))
