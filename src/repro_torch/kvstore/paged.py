"""PagedStore: the engine's block-table KV store.

Owns the serving-state tensors of one instance (the tree
:func:`repro_torch.models.init_state` builds) *and* the block ledger over
them.  Physical layout is **slot-affine**, as in the JAX package: each
request slot owns a contiguous region of the pool, ``kv_capacity /
block_lines`` line blocks backing rows of its dense cache window, so the
layer stack's state layout is untouched while allocation and headroom are
block-granular.  :meth:`decode_block_tables` feeds the paged decode kernel
(``repro_torch.kernels.decode_attention``), which gathers K/V through them.

Leaves are classified as in the JAX package: attention ``k``/``v`` (GQA)
and ``c_kv``/``k_rope`` (the MLA latent, with no head axis) are *line*
leaves (indexed by KV line, axis 2 of the stacked leaf); an enc-dec
decoder layer's cross K/V ``xk``/``xv`` are *static* leaves, written once
at prefill and never again; and every leaf of a recurrent mixer (Mamba's
``conv`` and ``ssm``, the mLSTM's ``C``, ``n``, ``m`` and ``conv``, the
sLSTM's ``c``, ``n``, ``h`` and ``m``) is a *recurrent* leaf, a
constant-size per-request state that moves whole.  An enc-dec state's
encoder memory ``enc_out`` (batch on axis 0, no repeat dim) is static
too: it moves with a whole slot (extract, merge, stream, import), never
with a mirror sync.

The state is updated in place.  Whatever leaves the store (an exported
slot) is a copy, so later in-place writes on either side never alias.

On a mesh slice (``repro_torch.meshserve.shard_store``) each rank's state
holds its part by the mesh's rule table (its KV heads, its block of a
recurrent state's channels or heads, the rest whole) and ``holders`` says
where the rest lives; a rank
outside the slice holds no state (``state`` is None) and keeps only the
ledger.  Then :meth:`stream_slot` yields
:class:`~repro_torch.meshserve.collectives.SliceChunk`s, and
:meth:`import_chunk` and :meth:`copy_lines` move rows between two stores
that do not share their devices through
:mod:`repro_torch.meshserve.collectives`, which counts every hop.  The
bytes they return are the ledger's, whatever the wire.

:meth:`copy_lines` is the per-step redundancy mirror: only the KV rows of
the new accounting lines move, plus the recurrent states whole, O(delta)
per step, not O(kv_capacity); static leaves are skipped, since a replica
gets them once, from the stream.  :meth:`copy_prefix` is the prefix cache's
one-time gather of a shared head's rows from other slots' windows into a
new request's window (``alloc(shared=)`` adopts those blocks in the
ledger).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import Device
from repro_torch.core.tracing import Tracer, traced
from repro_torch.kvstore.base import BlockLedger, KVStoreError, LineCosts
from repro_torch.models import init_state
from repro_torch.models.blocks import layer_specs, plan_segments
from repro_torch.models.state import cache_capacity

#: attention-state keys indexed by KV line (axis 2 of the stacked leaf)
LINE_KEYS = ("k", "v", "c_kv", "k_rope")
#: attention-state keys written once at prefill (enc-dec cross caches)
STATIC_KEYS = ("xk", "xv")


def pick_block_lines(kv_capacity: int, requested: int = 16) -> int:
    """Largest divisor of the cache window that is <= ``requested``."""
    b = max(1, min(requested, kv_capacity))
    while kv_capacity % b:
        b -= 1
    return b


class PagedStore:
    def __init__(self, cfg: ModelConfig, num_slots: int, kv_capacity: int,
                 block_lines: Optional[int] = None, device: Device = "cuda",
                 tracer: Optional[Tracer] = None):
        self.cfg = cfg
        #: the cluster's tracer (``repro_torch.core.tracing``), or None
        self.tracer = tracer
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
        #: where a mesh slice's state lives (None: whole, in this process)
        self.holders = None
        #: rows of each line leaf: the cache window (a ring of the
        #: sliding window where that is shorter)
        self._window = cache_capacity(cfg, kv_capacity)
        self.slot_rid: Dict[int, int] = {}
        self.rid_slot: Dict[int, int] = {}
        #: state leaves: (segment index, part key, leaf key, kind), kind
        #: ``line`` (attention KV), ``static`` (cross K/V, written once) or
        #: ``recurrent`` (moves whole on every sync)
        self._paths: List[Tuple[int, str, str, str]] = []
        for i, seg in enumerate(plan_segments(layer_specs(cfg))):
            for j, spec in enumerate(seg.specs):
                for key in self.state["layers"][i][f"p{j}"]:
                    if spec.block != "attn":
                        kind = "recurrent"
                    elif key in LINE_KEYS:
                        kind = "line"
                    elif key in STATIC_KEYS:
                        kind = "static"
                    else:
                        raise KVStoreError(f"attention state leaf {key!r} "
                                           f"is neither a KV line nor a "
                                           f"static leaf")
                    self._paths.append((i, f"p{j}", key, kind))

    def _leaf(self, state, path) -> Optional[torch.Tensor]:
        """The leaf at ``path`` (None where the state is None: a rank
        outside the store's mesh slice)."""
        if state is None:
            return None
        i, pj, key = path[:3]
        return state["layers"][i][pj][key]

    @property
    def device(self) -> Optional[torch.device]:
        leaf = self._leaf(self.state, self._paths[0]) if self._paths else None
        return leaf.device if leaf is not None else None

    def _pull_holders(self):
        """``holders``, or, for a whole store inside a mesh world (an
        engine every rank builds whole), every rank."""
        if self.holders is not None:
            return self.holders
        from repro_torch.meshserve.collectives import whole_holders
        return whole_holders()

    # -- capacity ------------------------------------------------------------
    @property
    def capacity_bytes(self) -> float:
        """Accounting capacity: every slot filled to the cache window."""
        return self.num_slots * self.costs.bytes_at(self.kv_capacity)

    def used_bytes(self) -> float:
        return self.ledger.used_bytes()

    def used_bytes_of(self, rid: int) -> float:
        return self.ledger.used_bytes_of(rid)

    def free_bytes(self) -> float:
        return self.capacity_bytes - self.ledger.used_bytes()

    def free_blocks(self) -> int:
        return self.ledger.free_blocks()

    # -- block tables ----------------------------------------------------------
    def slot_block_ids(self, slot: int) -> List[int]:
        lo = slot * self.blocks_per_slot
        return list(range(lo, lo + self.blocks_per_slot))

    def line_block_table(self, rid: int) -> List[int]:
        """Physical *line-block* ids of ``rid`` in pool numbering (the
        dense caches viewed as ``(num_slots * kv_capacity / block_lines,
        block_lines, ...)``): the table the paged decode kernel gathers
        through."""
        off = 1 if self._has_fixed else 0
        out = []
        for b in self.ledger.tables[rid]:
            slot, k = divmod(b, self.blocks_per_slot)
            out.append(slot * self.line_blocks_per_slot + (k - off))
        return out

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
    @traced("kv.alloc")
    def alloc(self, rid: int, slot: int, lines: int,
              synced: Optional[int] = None,
              shared: Optional[List[int]] = None) -> None:
        """Admit ``rid`` into ``slot``.  ``shared`` adopts a resident
        prefix's blocks (anywhere in the pool) as the table head; the
        slot's *own* region then backs only the suffix.  The dense window
        stays self-contained, so the caller must also :meth:`copy_prefix`
        the shared rows into the slot's window.  The slot's own blocks
        shadowed by the shared head (logical positions ``[0,
        len(shared))``) hold those copied rows and stay OFF the ledger:
        the ledger is the accounting truth, and sharing is exactly the
        memory it saves."""
        if slot in self.slot_rid:
            raise KVStoreError(f"slot {slot} already backs "
                               f"rid {self.slot_rid[slot]}")
        ids = self.slot_block_ids(slot)
        off = 1 if self._has_fixed else 0
        n_shared = len(shared) if shared else 0
        if n_shared:
            if n_shared * self.block_lines > min(lines, self.kv_capacity):
                raise KVStoreError(
                    f"rid {rid}: shared head {n_shared} blocks exceeds "
                    f"{lines} lines (hits must be block-aligned)")
            hint = ids[:off] + ids[off + n_shared:]
        else:
            hint = ids
        self.ledger.alloc(rid, lines, block_ids=hint, synced=synced,
                          shared=shared)
        self.slot_rid[slot] = rid
        self.rid_slot[rid] = slot

    def _grow_hint(self, rid: int) -> List[int]:
        """Free own-region blocks for the *next* logical positions of
        ``rid``, skipping the positions shadowed by a shared head: their
        own blocks hold the copied prefix rows and are never handed out
        as growth."""
        ids = self.slot_block_ids(self.rid_slot[rid])
        off = 1 if self._has_fixed else 0
        return ids[off + len(self.ledger.tables[rid]):]

    def append_line(self, rid: int, n: int = 1) -> int:
        out = self.ledger.append_line(rid, n,
                                      block_ids=self._grow_hint(rid))
        if self.ledger.last_cow is not None:
            raise KVStoreError(
                f"rid {rid}: copy-on-write inside the slot-affine store "
                f"(shared heads must be block-aligned)")
        return out

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

    def shared_saved_bytes(self) -> float:
        """Memory the refcounted prefix sharing avoids allocating:
        sum of (refs - 1) blocks, at block granularity."""
        return self.ledger.shared_saved_blocks() * self.ledger.block_bytes

    def lines(self, rid: int) -> int:
        return self.ledger.lines(rid)

    def synced_line(self, rid: int) -> int:
        return self.ledger.synced_line(rid)

    def delta_since(self, rid: int, line: int) -> Tuple[int, int]:
        return self.ledger.delta_since(rid, line)

    def mark_synced(self, rid: int, line: Optional[int] = None):
        self.ledger.mark_synced(rid, line)

    # -- whole-slot state movement ---------------------------------------------
    def extract_slot(self, slot: int):
        """Per-request state (batch dim kept, size 1), as a copy: the store
        keeps writing its own leaves in place.  None on a rank that holds
        no state."""
        if self.state is None:
            return None
        out = {"layers": [{pj: {} for pj in seg}
                          for seg in self.state["layers"]]}
        for path in self._paths:
            i, pj, key = path[:3]
            out["layers"][i][pj][key] = \
                self._leaf(self.state, path)[:, slot: slot + 1].clone()
        if "enc_out" in self.state:
            out["enc_out"] = self.state["enc_out"][slot: slot + 1].clone()
        return out

    def merge_slot(self, slot: int, sub_state, src_slot: int = 0):
        """Install ``sub_state`` (batch row ``src_slot``) into ``slot``,
        whole-window (row bounds clamp to the smaller of the two windows).
        Batch is dim 1 of the layer leaves (dim 0 is the repeat dim) and
        dim 0 of ``enc_out``."""
        self.merge_slot_rows(slot, sub_state, 0, self.kv_capacity,
                             src_slot=src_slot)

    @traced("kv.merge")
    def merge_slot_rows(self, slot: int, sub_state, lo: int, hi: int,
                        src_slot: int = 0):
        """Copy ``sub_state``'s batch row ``src_slot`` into ``slot``, KV rows
        ``[lo, hi)`` only of the line leaves (clamped to the smaller
        window): the merge for bucket-sized prefill scratch.  Recurrent and
        static leaves, and ``enc_out``, copy whole.  A rank that holds no
        state does nothing."""
        if self.state is None:
            return
        for path in self._paths:
            dst = self._leaf(self.state, path)
            src = self._leaf(sub_state, path)
            if path[3] != "line":
                dst[:, slot] = src[:, src_slot]
                continue
            h = min(hi, src.shape[2], dst.shape[2])
            l = min(lo, h)
            if h > l:
                dst[:, slot, l:h] = src[:, src_slot, l:h]
        if "enc_out" in self.state:
            self.state["enc_out"][slot] = sub_state["enc_out"][src_slot]

    # -- per-layer streamed transfer -------------------------------------------
    def stream_slot(self, slot: int) -> Iterator[Tuple[tuple, torch.Tensor]]:
        """Yield ``slot``'s state one layer-part leaf at a time, the chunk
        granularity a transfer can overlap with prefill compute.  Each
        chunk is a view of the store's leaf: install it (which copies)
        before the store writes the slot again.  A mesh store's chunks are
        ``SliceChunk``s (this rank's view, or None, and the holders)."""
        for path in self._paths:
            leaf = self._leaf(self.state, path)
            yield path[:3], self._chunk(
                None if leaf is None else leaf[:, slot: slot + 1])
        if self.cfg.is_encoder_decoder:
            enc = None if self.state is None else self.state["enc_out"]
            yield ("enc_out",), self._chunk(
                None if enc is None else enc[slot: slot + 1])

    def _chunk(self, view: Optional[torch.Tensor]):
        if self.holders is None:
            return view
        from repro_torch.meshserve.collectives import SliceChunk
        return SliceChunk(view, self.holders)

    def import_chunk(self, slot: int, path: tuple, chunk):
        """Install one streamed chunk into ``slot`` (a copy, on this
        store's device).  A ``SliceChunk``, or any chunk for a store on a
        mesh slice, is pulled across the two stores' ranks; a plain chunk
        on another device than a whole store's is refused (stores on two
        devices move state only between mesh slices)."""
        from repro_torch.meshserve import collectives as coll
        enc = path[0] == "enc_out"
        if enc and not self.cfg.is_encoder_decoder:
            raise KVStoreError("an encoder-memory chunk for a store that "
                               "holds no encoder memory")
        dst = None
        if self.state is not None:
            dst = (self.state["enc_out"][slot] if enc
                   else self._leaf(self.state, path)[:, slot])
        sliced = isinstance(chunk, coll.SliceChunk)
        view = chunk.tensor if sliced else chunk
        if view is not None:
            view = view[0] if enc else view[:, 0]
        if not sliced and self.holders is None:
            if view.device != dst.device:
                raise KVStoreError(
                    f"a chunk on {view.device} for a store on {dst.device}: "
                    f"stores on two devices stream only between mesh slices "
                    f"(LiveCluster(mesh=))")
            dst.copy_(view)
            return
        src = chunk.holders if sliced else coll.whole_holders()
        coll.pull([(dst, view, None if enc else path[:3])],
                  self._pull_holders(), src)

    # -- delta line copy (the mirror) ------------------------------------------
    def copy_lines(self, src: "PagedStore", src_slot: int, dst_slot: int,
                   from_line: int, to_line: int) -> float:
        """Copy only the KV rows of accounting lines ``[from_line,
        to_line)`` from ``src``'s slot into ours, plus the recurrent states
        whole (on every sync), and no static leaf (written once, it came
        with the stream); returns the bytes moved.  Accounting line
        ``L`` reserves physical row ``L-1`` (the newest sampled token's KV
        is written by the *next* decode step), so rows ``[from_line-1,
        to_line-1)`` move, modulo the ring window."""
        from repro_torch.meshserve import collectives as coll
        lo, hi = max(0, from_line - 1), max(0, to_line - 1)
        spans = _ring_spans(lo, hi, self._window)
        moves = [p for p in self._paths if p[3] != "static"]
        if coll.same_devices(self, src):
            for path in moves if self.state is not None else ():
                dst = self._leaf(self.state, path)
                src_leaf = self._leaf(src.state, path)
                if path[3] == "recurrent":
                    dst[:, dst_slot] = src_leaf[:, src_slot]
                    continue
                for a, b in spans:
                    dst[:, dst_slot, a:b] = src_leaf[:, src_slot, a:b]
        elif self.holders is None and src.holders is None:
            raise KVStoreError(
                f"a mirror from a store on {src.device} into one on "
                f"{self.device}: stores on two devices mirror only between "
                f"mesh slices (LiveCluster(mesh=))")
        else:
            items = []
            for path in moves:
                dst = self._leaf(self.state, path)
                src_leaf = self._leaf(src.state, path)
                views = [(slice(None),)] if path[3] == "recurrent" else [
                    (slice(None), slice(a, b)) for a, b in spans]
                items += [(None if dst is None else dst[:, dst_slot][v],
                           None if src_leaf is None
                           else src_leaf[:, src_slot][v], path[:3])
                          for v in views]
            if items:
                coll.pull(items, self._pull_holders(), src._pull_holders())
        return self.costs.mirror_bytes(max(0, to_line - from_line))

    # -- prefix adoption (one-time window fill) --------------------------------
    def copy_prefix(self, blocks: List[int], dst_slot: int,
                    n_lines: int) -> float:
        """Fill ``dst_slot``'s dense window rows ``[0, n_lines)`` from a
        shared prefix run: line ``i`` comes from block
        ``blocks[i // block_lines]``, which lives in another slot's region.

        The slot-affine layout keeps each window self-contained (the
        layers read their slot's rows directly), so adopting blocks from
        other slots' regions is a one-time row gather inside the store:
        data movement instead of prefill compute.  The ledger, not the
        window, is the accounting truth: the adopted blocks stay shared
        there and the shadowed own rows stay off it.  The row index is
        built on the host and uploaded once; each line leaf then takes one
        gather into a new tensor and one write, so a source row is read
        before any destination row is written even when the two overlap.
        Returns the bytes gathered (``line_bytes`` per line)."""
        n_lines = min(n_lines, self.kv_capacity,
                      len(blocks) * self.block_lines)
        if n_lines <= 0 or self.state is None:
            return max(0, n_lines) * self.costs.line_bytes
        off = 1 if self._has_fixed else 0
        i = np.arange(n_lines)
        head = np.asarray(blocks, np.int64)[i // self.block_lines]
        slot, k = np.divmod(head, self.blocks_per_slot)
        # row of the (slots * window) flattened line axis
        rows = slot * self.kv_capacity + (k - off) * self.block_lines \
            + i % self.block_lines
        index = None
        for path in self._paths:
            if path[3] != "line":
                continue
            leaf = self._leaf(self.state, path)
            if index is None:
                index = torch.as_tensor(rows, device=leaf.device)
            flat = leaf.view((leaf.shape[0], -1) + tuple(leaf.shape[3:]))
            leaf[:, dst_slot, :n_lines] = flat.index_select(1, index)
        return self.costs.line_bytes * n_lines


def _ring_spans(lo: int, hi: int, cap: int) -> List[Tuple[int, int]]:
    """Rows ``[lo, hi)`` of a ring of ``cap`` rows as at most two
    contiguous ``(start, stop)`` spans (all ``cap`` rows once the range
    covers the ring), so a copy needs no index tensor."""
    if hi <= lo:
        return []
    if hi - lo >= cap:
        return [(0, cap)]
    a, b = lo % cap, hi % cap
    return [(a, b)] if a < b else [(a, cap)] + ([(0, b)] if b else [])
