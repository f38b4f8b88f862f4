"""Prefix cache: radix index over token ids → resident block runs.

Production traffic shares system prompts, few-shot templates and
conversation history; a request whose prompt head is already resident
should never re-prefill it.  This package layers that reuse on the
refcounted :class:`repro_torch.kvstore.BlockLedger`:

* :class:`PrefixIndex` — a radix tree keyed on *block-granular* chunks
  of token ids; each node maps one chunk to the pool block holding its
  KV lines.
* :class:`PrefixCache` — the index plus the ledger contract: cached
  blocks are ``retain``-ed (kept alive past their last table), LRU
  leaves are ``release``-d under capacity pressure, and in-flight hits
  are pinned so eviction cannot snatch a run between scheduling and
  allocation.

Both backends run this same code: the live engine keys the index on
real prompt-token ids, the (token-free) simulator on synthetic
``(prefix_id, position)`` pairs — the radix walk only needs hashable,
equality-comparable chunk keys, so hit/miss decisions agree run-for-run
(see docs/ARCHITECTURE.md, "Prefix cache").

A copy of the JAX package's ``repro.prefixcache`` over the port's
``BlockLedger``, held against it by ``tests/test_torch_prefixcache.py``.
"""
from repro_torch.prefixcache.index import (PrefixCache, PrefixIndex,
                                           aligned_hit_lines, chunk_key)

__all__ = ["PrefixCache", "PrefixIndex", "aligned_hit_lines", "chunk_key"]
