"""WorkloadSpec × RequestSource: the backend-agnostic traffic kernel.

A :class:`WorkloadSpec` is *arrival process × length model × modality
extras*.  ``spec.source(seed)`` returns a :class:`RequestSource` — a
deterministic iterator of timestamped shared request records
(:class:`repro_torch.serving.request.Request`) consumed by
``repro_torch.scheduling.live.LiveCluster``.

Draw order per request is fixed (arrival gap first, then lengths) from a
single seeded generator, so streams are reproducible, and equal field by
field to the JAX package's ``repro.workloads.spec`` for the same (spec,
seed).  Prompt tokens are the exception: the JAX package draws them from
``jax.random``, which the port cannot reproduce, so the port draws
request ``i``'s tokens from ``np.random.default_rng([seed, i])`` and
prefix group ``g``'s head from ``np.random.default_rng([seed, 2**20 +
g])``.  They are still fixed by ``(seed, i)`` and shared within a group.
Modality payloads (:func:`default_extras`) differ from the JAX package's
the same way: request ``i``'s come from ``np.random.default_rng([seed,
1000 + i])``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional

import numpy as np

from repro_torch.serving.request import Request
from repro_torch.workloads.arrivals import (ArrivalProcess, Poisson,
                                            TraceFileReplay, TraceReplay)
from repro_torch.workloads.lengths import (LengthModel, TableLengths,
                                           TraceFileLengths, TraceLengths)

#: extras_fn(cfg, key, i) -> per-request modality payload (or None); the
#: port has no JAX key and passes the stream's seed as ``key``
ExtrasFn = Callable[[object, object, int], Optional[dict]]


def default_extras(cfg, key, i: int) -> Optional[dict]:
    """The modality payloads the architectures need, as f32 numpy arrays:
    vision prefix patches (1, num_prefix_tokens, embed_dim) for image
    front ends, encoder frames (1, max_source_positions, embed_dim) for
    speech; text-only configs need none.  Request ``i``'s payload is
    standard normal from ``np.random.default_rng([seed, 1000 + i])``, where
    the JAX package folds ``1000 + i`` into its stream key: ``key`` is the
    stream's seed here."""
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        shape = (1, cfg.frontend.num_prefix_tokens, cfg.frontend.embed_dim)
        name = "patch_embeds"
    elif cfg.is_encoder_decoder:
        # frames length must equal the encoder memory capacity so the
        # engine can merge the per-request state into its slot
        shape = (1, cfg.encoder.max_source_positions, cfg.frontend.embed_dim)
        name = "frames"
    else:
        return None
    return {name: np.random.default_rng([key, 1000 + i]).standard_normal(
        shape, dtype=np.float32)}


@dataclass(frozen=True)
class PrefixReuse:
    """Shared-prefix traffic shape (system prompts / multi-turn reuse).

    With probability ``reuse`` a request draws one of ``pool`` prefix
    groups and its prompt head repeats that group's tokens — the
    substrate the prefix cache dedups.  ``growth`` lines are added to a
    group's declared prefix each time it is drawn (conversation history
    accreting onto a shared system prompt), capped at ``max_prefix``
    (default: ``prefix_len``, i.e. no growth).  Declared prefixes are
    always clamped below the request's prompt length.

    Group tokens are generated ONCE per group at ``max_prefix`` length
    from the stream key alone, and reuse draws happen AFTER the length
    draws — so the same (spec, seed) yields bit-identical prompts and
    lengths whether or not a backend's cache is enabled, and
    cache-on/cache-off runs are token-comparable by construction.
    """
    pool: int = 4
    reuse: float = 0.5
    prefix_len: int = 64
    growth: int = 0
    max_prefix: Optional[int] = None

    @property
    def cap(self) -> int:
        return self.max_prefix if self.max_prefix is not None \
            else self.prefix_len


@dataclass(frozen=True)
class WorkloadSpec:
    """Everything that defines the traffic, nothing about the backend."""
    arrival: ArrivalProcess
    lengths: LengthModel
    extras_fn: Optional[ExtrasFn] = None
    name: str = ""
    #: shared-prefix reuse shape (None: every prompt is unique)
    prefix_reuse: Optional[PrefixReuse] = None

    def source(self, seed: int = 0, cfg=None) -> "RequestSource":
        """A fresh deterministic request stream.  Pass the model ``cfg``
        on live backends to materialize prompt tokens and modality extras;
        the simulator needs neither and should omit it."""
        return RequestSource(self, seed=seed, cfg=cfg)

    def describe(self) -> str:
        label = self.name or type(self.arrival).__name__.lower()
        return (f"workload '{label}': arrival={self.arrival!r} "
                f"lengths={self.lengths!r}")


class RequestSource:
    """Iterator of timestamped shared request records.

    * ``rid`` is the stream index (0, 1, ...), identical across backends.
    * ``arrival`` is in abstract time units (see module docstring).
    * With ``cfg``: ``prompt_tokens`` and ``extra`` are materialized for
      real engines; without, records stay array-free for the simulator.
    * ``concurrency`` is non-None for closed-loop specs — executors then
      issue requests on completion instead of by arrival stamp.
    """

    def __init__(self, spec: WorkloadSpec, seed: int = 0, cfg=None):
        self.spec = spec
        self.seed = seed
        self.cfg = cfg

    @property
    def concurrency(self) -> Optional[int]:
        return self.spec.arrival.concurrency

    def __iter__(self) -> Iterator[Request]:
        rng = np.random.default_rng(self.seed)
        pr = self.spec.prefix_reuse
        # per-group declared prefix length (grows by pr.growth per draw)
        psize: dict = {}
        gtoks: dict = {}
        for i, t in enumerate(self.spec.arrival.times(rng)):
            plen, dlen = self.spec.lengths.sample(rng, i)
            req = Request(prompt_len=plen, max_new_tokens=dlen,
                          arrival=float(t), rid=i)
            if pr is not None and pr.pool > 0:
                # drawn AFTER lengths, unconditionally — the stream stays
                # bit-identical for every consumer of this spec+seed
                hit_draw = rng.random()
                g = int(rng.integers(pr.pool))
                if hit_draw < pr.reuse:
                    cur = psize.setdefault(g, pr.prefix_len)
                    req.prefix_id = g
                    req.prefix_len = min(cur, plen)
                    psize[g] = min(cur + pr.growth, pr.cap)
            if self.cfg is not None:
                vocab = self.cfg.vocab_size
                req.prompt_tokens = np.random.default_rng(
                    [self.seed, i]).integers(0, vocab, (1, plen),
                                             dtype=np.int32)
                if req.prefix_id is not None and req.prefix_len > 0:
                    # group tokens are a fixed max-length sequence drawn
                    # from (seed, group) alone: every member of the
                    # group shares the same prompt head, regardless of
                    # draw order or per-request prefix length
                    if req.prefix_id not in gtoks:
                        gtoks[req.prefix_id] = np.random.default_rng(
                            [self.seed, (1 << 20) + req.prefix_id]
                        ).integers(0, vocab, (1, pr.cap), dtype=np.int32)
                    n = req.prefix_len
                    req.prompt_tokens[0, :n] = gtoks[req.prefix_id][0, :n]
                extras = self.spec.extras_fn or default_extras
                req.extra = extras(self.cfg, self.seed, i)
            yield req

    def materialize(self) -> List[Request]:
        return list(self)


# ---------------------------------------------------------------------------
# JSONL trace round-trip
# ---------------------------------------------------------------------------


def save_trace(path, requests) -> int:
    """Write a request stream as JSONL ({arrival, prompt_len, decode_len}
    per line); returns the number of records written."""
    n = 0
    with open(path, "w") as fh:
        for r in requests:
            decode_len = getattr(r, "decode_len", None)
            if decode_len is None:
                decode_len = r.max_new_tokens
            fh.write(json.dumps({"arrival": r.arrival,
                                 "prompt_len": r.prompt_len,
                                 "decode_len": decode_len}) + "\n")
            n += 1
    return n


def load_trace(path, name: str = "", stream: bool = False) -> WorkloadSpec:
    """Read a JSONL trace back into a replayable :class:`WorkloadSpec`.

    With ``stream=True`` the spec replays straight off the file
    (``TraceFileReplay`` × ``TraceFileLengths``): nothing is materialized
    up front, so a 10^6-line trace costs O(1) memory — the form
    ``benchmarks/bench_scale.py`` feeds the million-request harness."""
    if stream:
        return WorkloadSpec(arrival=TraceFileReplay(str(path)),
                            lengths=TraceFileLengths(str(path)),
                            name=name or f"trace:{path}")
    arrivals, pairs = [], []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            arrivals.append(float(rec["arrival"]))
            pairs.append((int(rec["prompt_len"]), int(rec["decode_len"])))
    return WorkloadSpec(arrival=TraceReplay(tuple(arrivals)),
                        lengths=TraceLengths(tuple(pairs)),
                        name=name or f"trace:{path}")


def table2_spec(workload: str, rate: float, duration: float,
                scale: float = 1.0) -> WorkloadSpec:
    """The paper's §5.1 setup: Poisson arrivals with Table-2 lengths."""
    return WorkloadSpec(arrival=Poisson(rate=rate, duration=duration),
                        lengths=TableLengths(workload=workload, scale=scale),
                        name=workload)
