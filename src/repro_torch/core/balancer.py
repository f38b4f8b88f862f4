"""Decode load balancing across an instance pair (AcceLLM §4.1.3).

Pure policy: given the requests currently decoded by the two instances of a
pair (each with a state-bytes weight), produce a balanced re-assignment that
equalizes (a) per-instance batch size and (b) per-instance total state
bytes read per step. With full KV redundancy every move is free; without a
replica a move costs a KV transfer, so only replica-backed moves are taken.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Set, Tuple


@dataclass(frozen=True)
class Item:
    rid: int
    weight: float          # state bytes read per decode step
    home: int              # current instance (0 or 1 within the pair)
    movable: bool = True   # replica exists on the other side


def partition(items: Sequence[Item], count_tol: int = 1
              ) -> Tuple[Set[int], Set[int], List[Tuple[int, int, int]]]:
    """LPT-style greedy: heaviest first onto the lighter side, under a batch
    count constraint (|n0 - n1| <= count_tol). Immovable items stay home.

    Returns (side0 rids, side1 rids, moves [(rid, src, dst), ...]).
    """
    side: Dict[int, Set[int]] = {0: set(), 1: set()}
    load = [0.0, 0.0]
    fixed = [it for it in items if not it.movable]
    free = sorted((it for it in items if it.movable),
                  key=lambda it: -it.weight)
    for it in fixed:
        side[it.home].add(it.rid)
        load[it.home] += it.weight
    total = len(items)
    cap = max(1, (total + count_tol) // 2)
    for it in free:
        pick = 0 if load[0] <= load[1] else 1
        if len(side[pick]) >= cap and len(side[1 - pick]) < cap:
            pick = 1 - pick
        side[pick].add(it.rid)
        load[pick] += it.weight
    moves = []
    by_rid = {it.rid: it for it in items}
    for dst in (0, 1):
        for rid in side[dst]:
            if by_rid[rid].home != dst:
                moves.append((rid, by_rid[rid].home, dst))
    return side[0], side[1], moves


def imbalance(items: Sequence[Item]) -> Tuple[int, float]:
    """(batch count delta, state-bytes delta) of the current placement."""
    n = [0, 0]
    w = [0.0, 0.0]
    for it in items:
        n[it.home] += 1
        w[it.home] += it.weight
    return abs(n[0] - n[1]), abs(w[0] - w[1])


def should_rebalance(items: Sequence[Item], count_trigger: int = 2,
                     bytes_trigger_frac: float = 0.2) -> bool:
    """Trigger when counts drift by >= count_trigger or state bytes by more
    than bytes_trigger_frac of the total."""
    if not items:
        return False
    n = [0, 0]
    w = [0.0, 0.0]
    for it in items:
        n[it.home] += 1
        w[it.home] += it.weight
    return should_rebalance_agg(n[0], n[1], w[0], w[1],
                                count_trigger, bytes_trigger_frac)


def should_rebalance_agg(n0: int, n1: int, w0: float, w1: float,
                         count_trigger: int = 2,
                         bytes_trigger_frac: float = 0.2) -> bool:
    """The :func:`should_rebalance` trigger from per-side aggregates —
    for callers (the vectorized kernels) that keep counts and byte sums
    incrementally and only materialize Items once a rebalance fires.
    Weights are exact integers in float64, so aggregate sums equal the
    per-item accumulation bit for bit."""
    if n0 + n1 == 0:
        return False
    total_w = (w0 + w1) or 1.0
    return (abs(n0 - n1) >= count_trigger
            or abs(w0 - w1) / total_w > bytes_trigger_frac)
