"""CUDA graphs of the engine's fused paged decode, one per decode shape.

Enqueued op by op, one iteration of the fused paged decode loop
(:func:`repro_torch.models.model.decode_iteration`) is about 2,000
launches at starcoder2-3b's 30 layers, and the host takes far longer to
enqueue them than the card takes to run them.  On a card, outside a mesh
(whose gloo collectives a graph cannot hold), the engine instead replays a
captured graph of one iteration ``steps`` times a plan
(:class:`DecodeGraphs`); the math, the dtypes and the kernels are the
eager loop's.

* **Key** (:func:`graph_key`): the plan's rows and its tables' block count.
  Rows are exact up to :data:`ROW_STEP` and rounded up to a multiple of it
  past that.  A pad row repeats the last live row (slot, clock, token,
  budget, table), so it writes the same K/V line, and its column is
  dropped.
* **Static buffers**, per key: ``io`` (7, rows) int32, the loop's state by
  row (:data:`TOKENS` ... :data:`ROW`, the output row the next replay
  writes), reset every plan by one non-blocking copy from a pinned host
  twin; the block tables, copied in only when they change
  (``tables.rebuild``); ``out`` (cap + 1, rows): after ``steps`` replays
  its row ``i`` holds iteration ``i``'s tokens and row ``steps`` the
  emitted counts.  At temperature > 0 each replay's noise is first copied
  into one buffer that the engine's graphs share.
* **Capture** is lazy: the first plan of a key (or one longer than its
  ``out`` holds) runs its first iteration eagerly on the engine's capture
  stream, which builds what is built at first use (cuBLAS' workspace for
  the stream, the paged kernel's scratch), then captures that iteration
  and replays it for the rest.  The paged kernel's scratch on the capture
  stream is never freed, as it grows too
  (:func:`repro_torch.kernels.decode_attention.hold_paged_scratch`): each
  graph holds the one it was captured with.  An engine's graphs share one
  memory pool: they run one after another on one stream, and each copies
  its results into its static buffers.
* **Kernel counts**: a replay calls no wrapper, so the calls a capture
  counted are taken back out of :mod:`repro_torch.kernels`' counts and
  every replay credits them; the eager first iteration counts itself.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig
from repro_torch.core.tracing import Tracer
from repro_torch.kernels.decode_attention import hold_paged_scratch
from repro_torch.models.model import decode_iteration
from repro_torch.stepplan import bucket_len

#: rows of a graph: exact up to this many, else a multiple of it
ROW_STEP = 16
#: rows of ``io``: the loop's state, then the output row of the next replay
TOKENS, CLOCKS, SLOTS, BUDGET, EMITTED, ALIVE, ROW = range(7)


def graph_key(rows: int, table_blocks: int) -> Tuple[int, int]:
    """The graph a plan of ``rows`` live rows over ``table_blocks``-block
    tables replays: ``(rows, table_blocks)``, its rows rounded up to a
    multiple of :data:`ROW_STEP` past :data:`ROW_STEP`."""
    if rows > ROW_STEP:
        rows = -(-rows // ROW_STEP) * ROW_STEP
    return rows, table_blocks


class _Graph:
    """One key's graph and static buffers."""

    def __init__(self, rows: int, blocks: int, cap: int,
                 device: torch.device):
        self.cap = cap
        self.io_host = torch.zeros((7, rows), dtype=torch.int32,
                                   pin_memory=True)
        self.io_host[ALIVE] = 1
        self.io = torch.empty((7, rows), dtype=torch.int32, device=device)
        self.tables_host = torch.empty((rows, blocks), dtype=torch.int32,
                                       pin_memory=True)
        self.tables = torch.empty((rows, blocks), dtype=torch.int32,
                                  device=device)
        #: what ``tables`` holds (the engine's key), None before a load
        self.tables_key: Optional[tuple] = None
        self.out = torch.empty((cap + 1, rows), dtype=torch.int32,
                               device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        #: kernel calls of one replay (a ``kernels.counts_since``)
        self.launches: Dict[str, Dict[str, int]] = {}


class DecodeGraphs:
    """The graphs of one engine's paged decode plans, by
    :func:`graph_key`: an engine of ``num_slots`` slots (its noise has a
    row more at temperature > 0) and ``block_lines``-line blocks."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 num_slots: int, block_lines: int, temperature: float,
                 eos_token: int, tracer: Optional[Tracer] = None):
        self.cfg = cfg
        self.device = device
        self.num_slots = num_slots
        self.block_lines = block_lines
        self.temperature = temperature
        self.eos_token = eos_token
        self.tracer = tracer
        self.graphs: Dict[Tuple[int, int], _Graph] = {}
        self._stream: Optional[torch.cuda.Stream] = None
        self._pool = None
        self._noise: Optional[torch.Tensor] = None

    def _count(self, name: str) -> None:
        if self.tracer is not None:
            self.tracer.count(name)

    def launch(self, params, state, tokens: np.ndarray, t0: np.ndarray,
               slots: np.ndarray, budget: np.ndarray, blocks: int,
               tables_key: tuple, tables: Callable[[], np.ndarray],
               steps: int,
               noise: Callable[[int], Optional[torch.Tensor]]
               ) -> torch.Tensor:
        """Enqueue ``steps`` iterations over the live rows ``tokens``,
        ``t0``, ``slots`` and ``budget`` (host arrays) with
        ``blocks``-block tables, and return ``out``'s first ``steps + 1``
        rows on the device: each iteration's tokens, then the emitted
        counts; the columns past the live rows are pad rows.  ``tables()``
        gives the live rows' tables (host), called only where the key's
        buffer does not hold ``tables_key``; ``noise(i)`` gives iteration
        ``i``'s noise, None at temperature 0."""
        n = len(slots)
        key = graph_key(n, blocks)
        g = self.graphs.get(key)
        capture = g is None or g.cap < steps
        if capture:
            g = self.graphs[key] = _Graph(*key, bucket_len(steps, floor=8),
                                          self.device)
        io = g.io_host.numpy()
        for row, live in ((TOKENS, tokens), (CLOCKS, t0), (SLOTS, slots),
                          (BUDGET, budget)):
            io[row, :n] = live
            io[row, n:] = live[-1]
        g.io.copy_(g.io_host, non_blocking=True)
        if g.tables_key != tables_key:
            self._count("tables.rebuild")
            host = g.tables_host.numpy()
            host[:n] = tables()
            host[n:] = host[n - 1]
            g.tables.copy_(g.tables_host, non_blocking=True)
            g.tables_key = tables_key
        first = 0
        if capture:
            self._capture(g, params, state, noise(0))
            first = 1
        self._count("decode.graph.capture" if capture
                    else "decode.graph.replay")
        for i in range(first, steps):
            z = noise(i)
            if z is not None:
                self._noise.copy_(z)
            g.graph.replay()
        kernels.add_counts(g.launches, steps - first)
        return g.out[:steps + 1]

    def _capture(self, g: _Graph, params, state,
                 noise: Optional[torch.Tensor]) -> None:
        """Run ``g``'s first iteration (``noise`` its noise) eagerly on the
        capture stream, then capture that iteration; the calls the capture
        counted go back out of the kernel counts, into ``g.launches``."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
            if self.temperature != 0.0:
                self._noise = torch.zeros(
                    (self.num_slots + 1, self.cfg.vocab_size),
                    dtype=torch.float32, device=self.device)
            hold_paged_scratch(self._stream)
        if noise is not None:
            self._noise.copy_(noise)
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self._iteration(g, params, state)
            before = kernels.read_counts()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=self._pool)
            try:
                self._iteration(g, params, state)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        g.graph, g.launches = graph, kernels.counts_since(before)
        kernels.add_counts(g.launches, -1)

    def _iteration(self, g: _Graph, params, state) -> None:
        """One iteration of the loop on ``g``'s static buffers."""
        io = g.io
        nxt, t, alive, emitted = decode_iteration(
            self.cfg, params, io[TOKENS][:, None], state, io[CLOCKS],
            io[ALIVE].bool(), io[EMITTED], io[BUDGET], io[SLOTS], g.tables,
            block_lines=self.block_lines, temperature=self.temperature,
            noise=self._noise,
            eos_token=self.eos_token)
        row = io[ROW, :1].long()
        g.out.index_copy_(0, row, nxt[None])
        g.out.index_copy_(0, row + 1, emitted[None])
        io[TOKENS].copy_(nxt)
        io[CLOCKS].copy_(t)
        io[EMITTED].copy_(emitted)
        io[ALIVE].copy_(alive)
        io[ROW, :1].add_(1)
