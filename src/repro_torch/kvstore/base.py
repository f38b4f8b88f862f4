"""The shared block-table ledger: line/byte accounting both backends use.

A *line* is one token's worth of attention KV across all attention layers
(``repro_torch.core.kvbytes.bytes_per_token``).  Recurrent blocks (SSM / xLSTM)
contribute a constant-size state that lives in a dedicated single block
per request; enc-dec static caches (encoder output, cross K/V) are priced
with it but written only once.

Line counts follow the serving convention both executors already used for
memory accounting: a resident request is charged ``total_len = prompt_len
+ generated`` lines — the prompt's KV plus one line per sampled token
(the line for the newest token is *reserved* at sampling time and
physically written by the next decode step; see
``PagedStore.copy_lines``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.kvbytes import (bytes_per_token, recurrent_state_bytes,
                                static_state_bytes)


class KVStoreError(RuntimeError):
    """Raised on ledger misuse (double alloc, unknown rid, pool
    exhaustion)."""


@dataclass(frozen=True)
class LineCosts:
    """Byte costs of one request's serving state, per architecture.

    The single source of truth consumed by the balancer weights, the
    scheduler views and both stores — derived from
    :mod:`repro_torch.core.kvbytes` so live engines and the simulator price a
    line identically.
    """
    line_bytes: float      # KV bytes appended per token (attention layers)
    recurrent_bytes: int   # constant-size state re-mirrored every step
    static_bytes: int      # written once at prefill (enc-dec caches)

    @property
    def fixed_bytes(self) -> int:
        return self.recurrent_bytes + self.static_bytes

    @classmethod
    def from_config(cls, cfg: ModelConfig, dtype_bytes: int = 2
                    ) -> "LineCosts":
        return cls(line_bytes=bytes_per_token(cfg, dtype_bytes),
                   recurrent_bytes=recurrent_state_bytes(cfg, dtype_bytes),
                   static_bytes=static_state_bytes(cfg, dtype_bytes))

    def bytes_at(self, lines: int) -> float:
        """Total state bytes for a request holding ``lines`` KV lines
        (== ``repro_torch.core.kvbytes.state_bytes_at(cfg, lines)``)."""
        return self.line_bytes * lines + self.fixed_bytes

    def mirror_bytes(self, delta_lines: int) -> float:
        """Per-sync replica-update traffic: only the new KV lines plus
        the constant-size recurrent state (§4.1.2)."""
        return self.line_bytes * delta_lines + self.recurrent_bytes


@dataclass
class BlockLedger:
    """Fixed-size block pool + per-request block tables.

    Blocks hold ``block_lines`` KV lines each; a request additionally
    pins one *fixed block* for its length-independent state when the
    architecture has any.  ``max_blocks_per_seq`` caps a single request's
    line blocks (the live engine's ring-buffer window: lines beyond the
    window reuse the same physical blocks).

    ``strict=False`` (the simulator's accounting overlay) lets the pool
    *overcommit*: an alloc past the last free block mints overflow ids
    instead of raising, ``free_blocks()`` bottoms out at 0, and overflow
    ids are discarded on free.  The live store stays strict — a real
    engine cannot mint HBM.

    Blocks are *refcounted*: ``alloc(..., shared=[...])`` adopts blocks
    already referenced elsewhere (a resident prefix) into the head of the
    new table without consuming pool headroom, and ``retain``/``release``
    let an external holder (the prefix cache) keep blocks alive after
    their last table drops them.  A block returns to the free list only
    when its last referent releases it; ``free``/``release`` report the
    count of blocks *actually* released.  Appending into a shared,
    partially-filled tail block triggers copy-on-write (the writer gets a
    private replacement; ``last_cow`` records the swap for stores that
    also move bytes).
    """
    costs: LineCosts
    num_blocks: int
    block_lines: int
    max_blocks_per_seq: Optional[int] = None
    strict: bool = True
    tables: Dict[int, List[int]] = field(default_factory=dict)
    fixed_block: Dict[int, Optional[int]] = field(default_factory=dict)
    _lines: Dict[int, int] = field(default_factory=dict)
    _synced: Dict[int, int] = field(default_factory=dict)
    _free: List[int] = field(default_factory=list)
    _next_overflow: int = 0
    #: per-block reference counts; a block is either free or in _refs
    _refs: Dict[int, int] = field(default_factory=dict)
    #: per-rid head lines backed by blocks adopted via ``shared=``
    _shared_head: Dict[int, int] = field(default_factory=dict)
    #: last copy-on-write swap: (rid, old_block, new_block)
    last_cow: Optional[Tuple[int, int, int]] = None
    #: running Σ of ``_lines`` values, so ``used_bytes`` is O(1) — the
    #: balancer reads it per scheduling decision over every instance
    _tot_lines: int = 0

    def __post_init__(self):
        if self.block_lines <= 0:
            raise KVStoreError(f"block_lines must be > 0 "
                               f"(got {self.block_lines})")
        if not self._free:
            self._free = list(range(self.num_blocks - 1, -1, -1))
        self._next_overflow = self.num_blocks

    def _take(self, need: int) -> List[int]:
        """Pop ``need`` blocks off the free list; in non-strict mode any
        shortfall is covered by minted overflow ids."""
        if need <= len(self._free):
            take = self._free[-need:][::-1] if need else []
            del self._free[len(self._free) - need:]
        else:
            if self.strict:
                raise KVStoreError(
                    f"pool exhausted: {need} blocks needed, "
                    f"{len(self._free)} free")
            take = self._free[::-1]
            self._free.clear()
            while len(take) < need:
                take.append(self._next_overflow)
                self._next_overflow += 1
        for b in take:
            self._refs[b] = 1
        return take

    def _take_hinted(self, need: int, block_ids: List[int],
                     exact: bool) -> List[int]:
        """Take ``need`` specific free blocks from a placement hint.
        ``exact`` demands the first ``need`` hint entries be free (alloc
        contract); otherwise free hint entries are filtered (append)."""
        if exact:
            if len(block_ids) < need:
                raise KVStoreError(
                    f"{need} blocks needed, hint has {len(block_ids)}")
            take = list(block_ids[:need])
            missing = [b for b in take if b not in self._free]
            if missing:
                raise KVStoreError(f"blocks {missing} are not free")
        else:
            take = [b for b in block_ids if b in self._free][:need]
            if len(take) < need:
                raise KVStoreError(
                    f"pool exhausted: {need} blocks needed, hint has "
                    f"{len(take)} free")
        for b in take:
            self._free.remove(b)
            self._refs[b] = 1
        return take

    # -- derived sizes -------------------------------------------------------
    @property
    def block_bytes(self) -> float:
        return self.block_lines * self.costs.line_bytes

    def line_blocks_for(self, lines: int) -> int:
        n = -(-lines // self.block_lines) if lines > 0 else 0
        if self.max_blocks_per_seq is not None:
            n = min(n, self.max_blocks_per_seq)
        return n

    def blocks_for(self, lines: int) -> int:
        return self.line_blocks_for(lines) + (
            1 if self.costs.fixed_bytes > 0 else 0)

    # -- queries -------------------------------------------------------------
    def resident(self) -> List[int]:
        return sorted(self.tables)

    def lines(self, rid: int) -> int:
        if rid not in self.tables:
            raise KVStoreError(f"rid {rid} not resident in ledger")
        return self._lines[rid]

    def synced_line(self, rid: int) -> int:
        """Line up to which this store's copy of ``rid`` has been
        mirrored (== ``lines`` when current)."""
        if rid not in self.tables:
            raise KVStoreError(f"rid {rid} not resident in ledger")
        return self._synced[rid]

    def delta_since(self, rid: int, line: int) -> Tuple[int, int]:
        """The ``(from_line, to_line)`` half-open range of lines a mirror
        holding ``line`` lines is missing."""
        to = self.lines(rid)
        return (min(line, to), to)

    def free_blocks(self) -> int:
        return len(self._free)

    def used_blocks(self) -> int:
        # counted from the refcounts (not num_blocks - free): a shared
        # block is one block however many tables reference it, and a
        # non-strict ledger can overcommit past the nominal pool size
        return len(self._refs)

    def refcount(self, block: int) -> int:
        return self._refs.get(block, 0)

    def shared_head_lines(self, rid: int) -> int:
        """Head lines of ``rid`` backed by blocks adopted from a resident
        prefix (0 for an unshared request)."""
        return self._shared_head.get(rid, 0) if rid in self.tables else 0

    def shared_blocks_count(self) -> int:
        """Distinct blocks currently referenced by more than one holder."""
        return sum(1 for c in self._refs.values() if c > 1)

    def shared_saved_blocks(self) -> int:
        """Pool blocks *not* consumed thanks to sharing: Σ (refs − 1).
        Each extra reference is a block a share-blind allocator would
        have paid for."""
        return sum(c - 1 for c in self._refs.values() if c > 1)

    def used_bytes_of(self, rid: int) -> float:
        return self.costs.bytes_at(self.lines(rid))

    def used_bytes(self) -> float:
        """Line-exact resident state bytes (Σ ``state_bytes_at``), the
        quantity the balancer and admission compare.  Computed from the
        running line total: line counts are exact integers in float64
        (far below 2**53), so one multiply equals the per-request sum
        bit for bit — and the call is O(1), not O(resident)."""
        return (self.costs.line_bytes * self._tot_lines
                + self.costs.fixed_bytes * len(self._lines))

    def can_alloc(self, lines: int) -> bool:
        return self.blocks_for(lines) <= len(self._free)

    # -- mutations -----------------------------------------------------------
    def alloc(self, rid: int, lines: int = 0, *,
              block_ids: Optional[List[int]] = None,
              synced: Optional[int] = None,
              shared: Optional[List[int]] = None) -> List[int]:
        """Admit ``rid`` at ``lines`` KV lines; returns the block ids
        backing it (fixed block first, if any).  ``block_ids`` lets a
        placement-aware caller (the live store's slot-affine layout) pick
        specific blocks from the free pool.  ``shared`` adopts
        already-referenced blocks (a resident prefix) as the head of the
        table: their refcounts go up, no pool headroom is consumed."""
        if rid in self.tables:
            raise KVStoreError(f"rid {rid} already resident")
        shared = list(shared or [])
        n_line = self.line_blocks_for(lines)
        if len(shared) > n_line:
            raise KVStoreError(
                f"rid {rid}: {len(shared)} shared blocks exceed the "
                f"{n_line} line blocks for {lines} lines")
        bad = [b for b in shared if b not in self._refs]
        if bad:
            raise KVStoreError(f"shared blocks {bad} are not referenced")
        need = (n_line - len(shared)) + (
            1 if self.costs.fixed_bytes > 0 else 0)
        if block_ids is not None:
            try:
                take = self._take_hinted(need, block_ids, exact=True)
            except KVStoreError as e:
                raise KVStoreError(f"rid {rid}: {e}") from None
        else:
            take = self._take(need)
        for b in shared:
            self._refs[b] += 1
        fixed = take[0] if self.costs.fixed_bytes > 0 else None
        self.fixed_block[rid] = fixed
        self.tables[rid] = shared + (take[1:] if fixed is not None
                                     else take)
        self._lines[rid] = lines
        self._tot_lines += lines
        self._synced[rid] = lines if synced is None else synced
        if shared:
            self._shared_head[rid] = min(lines,
                                         len(shared) * self.block_lines)
        return take

    def append_line(self, rid: int, n: int = 1,
                    *, block_ids: Optional[List[int]] = None) -> int:
        """Grow ``rid`` by ``n`` lines, pulling new blocks from the pool
        on boundary crossings; returns the new line count.

        Copy-on-write: if the append starts inside a *shared* tail block
        (refcount > 1), the writer first swaps in a private replacement
        block — recorded in ``last_cow`` — so the other referents keep
        the original bytes."""
        old = self.lines(rid)
        new = old + n
        table = self.tables[rid]
        self.last_cow = None
        if (old % self.block_lines != 0 and table
                and self._refs[table[-1]] > 1):
            old_b = table[-1]
            if block_ids is not None:
                repl = self._take_hinted(1, block_ids, exact=False)[0]
            else:
                repl = self._take(1)[0]
            table[-1] = repl
            self._decref(old_b)
            self.last_cow = (rid, old_b, repl)
            if self._shared_head.get(rid, 0) > (len(table) - 1) \
                    * self.block_lines:
                self._shared_head[rid] = (len(table) - 1) \
                    * self.block_lines
        need = self.line_blocks_for(new) - len(table)
        if need > 0:
            if block_ids is not None:
                try:
                    grab = self._take_hinted(need, block_ids, exact=False)
                except KVStoreError:
                    raise KVStoreError(
                        f"pool exhausted growing rid {rid} to {new} "
                        f"lines") from None
            else:
                grab = self._take(need)
            table.extend(grab)
        self._lines[rid] = new
        self._tot_lines += n
        return new

    def set_lines(self, rid: int, lines: int,
                  *, block_ids: Optional[List[int]] = None) -> int:
        """Reconcile ``rid`` to an absolute line count (simulator resync
        path); grows like :meth:`append_line`, never shrinks blocks."""
        cur = self.lines(rid)
        if lines > cur:
            return self.append_line(rid, lines - cur, block_ids=block_ids)
        self._lines[rid] = lines
        self._tot_lines += lines - cur
        return lines

    def mark_synced(self, rid: int, line: Optional[int] = None):
        self._synced[rid] = self.lines(rid) if line is None else line

    def _decref(self, block: int) -> bool:
        """Drop one reference; returns True when the block actually left
        the pool's used set (last referent)."""
        c = self._refs.get(block)
        if c is None:
            raise KVStoreError(f"block {block} is not referenced")
        if c > 1:
            self._refs[block] = c - 1
            return False
        del self._refs[block]
        # overflow ids (non-strict overcommit) evaporate; real ids return
        if block < self.num_blocks:
            self._free.append(block)
        return True

    def retain(self, blocks: List[int]):
        """External holder (the prefix cache) takes a reference on each
        block, keeping it alive past its last table."""
        bad = [b for b in blocks if b not in self._refs]
        if bad:
            raise KVStoreError(f"cannot retain free blocks {bad}")
        for b in blocks:
            self._refs[b] += 1

    def release(self, blocks: List[int]) -> int:
        """Drop one external reference per block; returns how many blocks
        actually returned to the pool."""
        return sum(1 for b in blocks if self._decref(b))

    def free(self, rid: int) -> int:
        """Release ``rid``'s references; returns the number of blocks
        *actually* freed back to the pool (shared blocks with surviving
        referents don't count — eviction of a shared-prefix replica only
        reclaims its unique suffix)."""
        if rid not in self.tables:
            raise KVStoreError(f"rid {rid} not resident in ledger")
        blocks = self.tables.pop(rid)
        fixed = self.fixed_block.pop(rid)
        if fixed is not None:
            blocks = [fixed] + blocks
        self._tot_lines -= self._lines.pop(rid)
        self._synced.pop(rid)
        self._shared_head.pop(rid, None)
        return sum(1 for b in blocks if self._decref(b))
