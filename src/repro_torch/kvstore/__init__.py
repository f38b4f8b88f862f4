"""Paged KV store of the port: the line/byte ledger (a copy of the JAX
package's, so both price a line identically) and the live store over the
engine's state tensors, and ``SimStore``, the same ledger's block
accounting for the discrete-event simulator."""
from repro_torch.kvstore.base import BlockLedger, KVStoreError, LineCosts
from repro_torch.kvstore.paged import PagedStore
from repro_torch.kvstore.sim import SimStore

__all__ = ["BlockLedger", "KVStoreError", "LineCosts", "PagedStore",
           "SimStore"]
