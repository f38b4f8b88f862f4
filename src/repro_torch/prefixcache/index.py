"""Radix prefix index + the refcount contract with the block ledger.

The index is block-granular: a prompt prefix is cached (and can hit)
only in whole ``block_lines`` chunks.  That alignment is what keeps
copy-on-write out of the serving fast path — a shared block is always
*full*, so the first divergent token of a new request lands in its own
fresh block and the ledger-level COW machinery (``BlockLedger.append_line``)
is exercised only by adversarial interleavings, not by admission.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Optional, Sequence, Set, Tuple

from repro_torch.kvstore.base import BlockLedger, KVStoreError


def aligned_hit_lines(prefix_len: int, prompt_len: int,
                      block_lines: int) -> int:
    """Largest usable hit: block-aligned, and strictly less than the
    prompt (at least one suffix token must run through prefill so the
    request has logits to sample its first token from)."""
    cap = min(prefix_len, prompt_len - 1)
    return max(0, (cap // block_lines) * block_lines)


def chunk_key(tokens: Sequence[Hashable], i: int,
              block_lines: int) -> Tuple[Hashable, ...]:
    """The i-th block-granular radix key of a token sequence."""
    return tuple(tokens[i * block_lines:(i + 1) * block_lines])


@dataclass
class _Node:
    key: Tuple[Hashable, ...]
    block: int
    parent: Optional["_Node"]
    children: Dict[Tuple[Hashable, ...], "_Node"] = field(
        default_factory=dict)
    last_use: int = 0


class PrefixIndex:
    """Radix tree over block-granular token chunks → pool block ids."""

    def __init__(self, block_lines: int):
        self.block_lines = block_lines
        self.root: Dict[Tuple[Hashable, ...], _Node] = {}
        self._nodes: List[_Node] = []
        self._tick = 0

    def __len__(self) -> int:
        return len(self._nodes)

    def blocks(self) -> List[int]:
        return [n.block for n in self._nodes]

    def walk(self, tokens: Sequence[Hashable],
             touch: bool = True) -> List[_Node]:
        """Longest cached path matching ``tokens``; ``touch`` refreshes
        LRU stamps along the way."""
        if touch:
            self._tick += 1
        path: List[_Node] = []
        children = self.root
        for i in range(len(tokens) // self.block_lines):
            node = children.get(chunk_key(tokens, i, self.block_lines))
            if node is None:
                break
            if touch:
                node.last_use = self._tick
            path.append(node)
            children = node.children
        return path

    def extend(self, tokens: Sequence[Hashable],
               blocks: Sequence[int]) -> List[_Node]:
        """Insert the path for ``tokens`` (backed block-for-block by
        ``blocks``); returns the *newly created* nodes."""
        self._tick += 1
        created: List[_Node] = []
        children, parent = self.root, None
        for i in range(min(len(tokens) // self.block_lines, len(blocks))):
            key = chunk_key(tokens, i, self.block_lines)
            node = children.get(key)
            if node is None:
                node = _Node(key=key, block=blocks[i], parent=parent)
                children[key] = node
                self._nodes.append(node)
                created.append(node)
            node.last_use = self._tick
            children, parent = node.children, node
        return created

    def remove(self, node: _Node):
        if node.children:
            raise KVStoreError("cannot remove an interior radix node")
        siblings = node.parent.children if node.parent else self.root
        del siblings[node.key]
        self._nodes.remove(node)

    def lru_leaves(self) -> List[_Node]:
        return sorted((n for n in self._nodes if not n.children),
                      key=lambda n: n.last_use)

    def subtree(self, node: _Node) -> List[_Node]:
        """Post-order descendants-then-self (safe removal order)."""
        out: List[_Node] = []
        for child in list(node.children.values()):
            out.extend(self.subtree(child))
        out.append(node)
        return out


class PrefixCache:
    """The index wired to a :class:`BlockLedger`: cached blocks carry one
    cache reference (``retain``), eviction ``release``-s them, and hits
    adopted by an admission carry their own table reference — so a block
    frees exactly when its last referent (table *or* cache) lets go.

    Identical instances run on both backends; only the token alphabet
    differs (real ids live, ``(prefix_id, pos)`` pairs in the
    simulator).
    """

    def __init__(self, ledger: BlockLedger,
                 capacity_blocks: Optional[int] = None):
        self.ledger = ledger
        self.index = PrefixIndex(ledger.block_lines)
        #: max blocks the cache may retain (None: unbounded — pool
        #: pressure alone evicts via ``evict_obstructing``)
        self.capacity_blocks = capacity_blocks
        self._pins: Dict[int, Set[int]] = {}
        self.stats: Dict[str, int] = {
            "lookups": 0, "hits": 0, "hit_blocks": 0, "hit_tokens": 0,
            "inserted_blocks": 0, "evicted_blocks": 0}

    # -- queries -------------------------------------------------------------
    def cached_blocks(self) -> int:
        return len(self.index)

    def peek_blocks(self, tokens: Sequence[Hashable]) -> List[int]:
        """Longest resident block run for ``tokens`` without touching
        LRU state or stats (scheduler views use this)."""
        return [n.block for n in self.index.walk(tokens, touch=False)]

    # -- the hit path --------------------------------------------------------
    def lookup_pin(self, rid: int,
                   tokens: Sequence[Hashable]) -> List[int]:
        """Longest resident block run for ``tokens``, pinned under
        ``rid`` until :meth:`unpin` — eviction will not release a pinned
        block, so the run survives the gap between scheduling the
        prefill and allocating the request's table."""
        self.stats["lookups"] += 1
        blocks = [n.block for n in self.index.walk(tokens)]
        if blocks:
            self.stats["hits"] += 1
            self.stats["hit_blocks"] += len(blocks)
            self.stats["hit_tokens"] += len(blocks) \
                * self.ledger.block_lines
            self._pins[rid] = set(blocks)
        return blocks

    def unpin(self, rid: int):
        self._pins.pop(rid, None)

    def pinned(self) -> Set[int]:
        out: Set[int] = set()
        for s in self._pins.values():
            out |= s
        return out

    # -- inserts and eviction ------------------------------------------------
    def insert(self, tokens: Sequence[Hashable],
               blocks: Sequence[int]) -> int:
        """Cache the (block-aligned) prefix path for a just-prefilled
        request; newly indexed blocks gain a cache reference.  Returns
        how many blocks were newly cached."""
        created = self.index.extend(tokens, blocks)
        self.ledger.retain([n.block for n in created])
        self.stats["inserted_blocks"] += len(created)
        if self.capacity_blocks is not None:
            self._evict_to(self.capacity_blocks)
        return len(created)

    def _remove_node(self, node) -> int:
        self.index.remove(node)
        return self.ledger.release([node.block])

    def _evict_to(self, capacity: int) -> int:
        """LRU-evict unpinned leaves until at most ``capacity`` blocks
        stay cached; returns blocks actually returned to the pool."""
        freed = 0
        pinned = self.pinned()
        while len(self.index) > capacity:
            victims = [n for n in self.index.lru_leaves()
                       if n.block not in pinned]
            if not victims:
                break
            freed += self._remove_node(victims[0])
            self.stats["evicted_blocks"] += 1
        return freed

    def evict_obstructing(self, blocks: Set[int]) -> int:
        """Drop every cached entry whose block is in ``blocks`` (and,
        for index consistency, its whole subtree); pinned blocks stay.
        Returns blocks actually returned to the pool — the live store
        calls this to reclaim a slot whose region is held only by the
        cache."""
        pinned = self.pinned()
        freed = 0
        for node in [n for n in list(self.index._nodes)
                     if n.block in blocks]:
            if node not in self.index._nodes:
                continue  # already removed as part of an earlier subtree
            sub = self.index.subtree(node)
            if any(n.block in pinned for n in sub):
                continue
            for n in sub:
                freed += self._remove_node(n)
                self.stats["evicted_blocks"] += 1
        return freed

    def release_all(self) -> int:
        """Drop the whole cache (instance teardown)."""
        self._pins.clear()
        freed = 0
        while self.index._nodes:
            for node in self.index.lru_leaves():
                freed += self._remove_node(node)
        return freed
