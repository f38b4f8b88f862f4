"""SimStore: pure block accounting for the discrete-event simulator.

One store per :class:`repro_torch.sim.cluster.SimInstance`, holding the ledger
for every request resident there (decode primaries *and* replicas — the
replica-memory undercounting of the old ad-hoc accounting is impossible
by construction).  The simulator mutates its ``decode_batch`` /
``replicas`` dicts at event granularity (and some consistency tests
drive those dicts directly, bypassing the event loop), so the store
reconciles ledger membership and line counts from them lazily on read:
the *costs* and the *ledger arithmetic* are shared with the live
``PagedStore``, the event mechanics stay the simulator's own.

A copy of the JAX package's ``repro.kvstore.sim``, held against it by
``tests/test_torch_sim.py``.
"""
from __future__ import annotations

from typing import List, Mapping, Optional

from repro_torch.kvstore.base import BlockLedger, LineCosts


class SimStore:
    def __init__(self, costs: LineCosts, capacity_bytes: float,
                 block_lines: int = 16,
                 max_blocks: int = 1 << 18):
        self.costs = costs
        self.capacity_bytes = float(capacity_bytes)
        block_bytes = block_lines * costs.line_bytes
        if block_bytes <= 0:
            # pure-recurrent architecture: blocks hold fixed states only
            block_bytes = max(costs.fixed_bytes, 1)
        # strict=False: the simulator admits on BYTE headroom (its decode
        # batch is elastic; §4.2.5 pressure is handled by eviction), so
        # block rounding + fixed blocks may overcommit the nominal pool —
        # the ledger then mints overflow ids and free_blocks() reads 0
        # instead of crashing an accounting query mid-run.
        self.ledger = BlockLedger(
            costs, num_blocks=min(max_blocks,
                                  int(self.capacity_bytes // block_bytes)),
            block_lines=block_lines, strict=False)

    # -- reconciliation ------------------------------------------------------
    def reconcile(self, resident: Mapping[int, int],
                  synced: Optional[Mapping[int, int]] = None,
                  shared: Optional[Mapping[int, List[int]]] = None):
        """Make ledger membership and line counts match ``resident``
        (rid -> current KV lines).  ``synced`` optionally pins mirror
        marks; by default every entry is considered current (the
        simulator executes the mirror implicitly inside the decode-step
        cost, so a replica is never more than in-flight-one-step
        behind).  ``shared`` maps rids to prefix-cache block runs adopted
        as their table heads — alloc/free stay symmetric on the
        refcounts, so a prefix-hit request prices exactly its unique
        suffix here just as it does on the live store."""
        led = self.ledger
        for rid in list(led.tables):
            if rid not in resident:
                led.free(rid)
        for rid, lines in resident.items():
            if rid in led.tables:
                led.set_lines(rid, lines)
            else:
                led.alloc(rid, lines,
                          shared=(shared or {}).get(rid))
            led.mark_synced(rid, None if synced is None
                            else synced.get(rid))
        return self

    # -- queries (post-reconcile ledger pass-throughs) -----------------------
    def used_bytes(self) -> float:
        return self.ledger.used_bytes()

    def used_bytes_of(self, rid: int) -> float:
        return self.ledger.used_bytes_of(rid)

    def free_bytes(self) -> float:
        return self.capacity_bytes - self.ledger.used_bytes()

    def free_blocks(self) -> int:
        return self.ledger.free_blocks()

    def lines(self, rid: int) -> int:
        return self.ledger.lines(rid)

    def delta_since(self, rid: int, line: int):
        return self.ledger.delta_since(rid, line)

    def mirror_bytes_per_step(self, n_mirrored: int) -> float:
        """Per-decode-step replica-update traffic: one new KV line (plus
        the constant recurrent state) per mirrored request — the ledger
        quantity the live executor also charges."""
        return n_mirrored * self.costs.mirror_bytes(1)
