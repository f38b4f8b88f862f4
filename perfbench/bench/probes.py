"""The benchmark's own spans and records around calls into the layers of
``repro_torch``; the program is not edited.

Each engine's ``prefill_batch`` and ``decode_multi``, the cluster's
``_apply_stream``, ``_apply_mirror`` and ``_apply_promote``, and the model's
two attention kernel entries (``flash_attention_cuda`` and
``paged_decode_attention_cuda`` as ``repro_torch.models.attention`` calls
them), and the cluster's ``step``, are wrapped.  Every wrapper records
the host clock and what the call was asked to do (prefill items, decode
rows and their lengths, the request moved).  While a trace records
(``recording``), each wrapper also brackets its call with two sentinel
runtime calls (``cudaStreamQuery`` on the current stream) and notes the
span's name: the trace gives every runtime call a correlation id in call
order, so the activities whose launches fall between a span's two
sentinels are the ones that span launched, with no clock to align.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

PREFILL, DECODE, FLASH, PAGED = ("bench.prefill", "bench.decode",
                                 "bench.flash", "bench.paged_decode")
STEP = "bench.step"
MOVES = {"_apply_stream": "bench.stream", "_apply_mirror": "bench.mirror",
         "_apply_promote": "bench.promote"}


@dataclass
class Call:
    start: float
    end: float
    #: prefill: (length, offset) of each item; decode: (lines before, steps)
    #: of each row that emitted tokens
    work: List[Tuple[int, int]] = field(default_factory=list)


@dataclass
class Probes:
    #: wrap the kernel entries and the cluster's step too (traced runs)
    spans_on: bool = False
    prefills: List[Call] = field(default_factory=list)
    decodes: List[Call] = field(default_factory=list)
    moves: Dict[str, List[int]] = field(default_factory=dict)
    #: while True, sentinels bracket every span
    recording: bool = False
    #: "+name" / "-name" for each sentinel, in call order
    marks: List[str] = field(default_factory=list)
    _undo: List = field(default_factory=list)

    def _sentinel(self, label: str) -> None:
        import torch
        torch.cuda.current_stream().query()
        self.marks.append(label)

    @contextlib.contextmanager
    def span(self, name: str):
        on = self.recording
        if on:
            self._sentinel("+" + name)
        try:
            yield
        finally:
            if on:
                self._sentinel("-" + name)

    def _patch(self, owner, attr, wrapper):
        plain = getattr(owner, attr)
        had = attr in vars(owner)
        setattr(owner, attr, wrapper(plain))
        self._undo.append((owner, attr, plain, had))

    def install(self, cluster) -> "Probes":
        from repro_torch.models import attention
        for eng in cluster.engines:
            self._patch(eng, "prefill_batch", self._prefill(eng))
            self._patch(eng, "decode_multi", self._decode(eng))
        for attr, name in MOVES.items():
            self._patch(cluster, attr, self._move(name))
        if self.spans_on:
            self._patch(attention, "flash_attention_cuda",
                        self._plain_span(FLASH))
            self._patch(attention, "paged_decode_attention_cuda",
                        self._plain_span(PAGED))
            self._patch(cluster, "step", self._plain_span(STEP))
        return self

    def remove(self) -> None:
        for owner, attr, plain, had in reversed(self._undo):
            if had:
                setattr(owner, attr, plain)
            else:
                delattr(owner, attr)
        self._undo.clear()

    # -- wrappers -----------------------------------------------------------
    def _prefill(self, eng):
        def wrap(plain):
            def prefill_batch(plan, *a, **kw):
                work = [(it.end - it.start, it.start) for it in plan.items]
                t0 = time.perf_counter()
                with self.span(PREFILL):
                    out = plain(plan, *a, **kw)
                self.prefills.append(Call(t0, time.perf_counter(), work))
                return out
            return prefill_batch
        return wrap

    def _decode(self, eng):
        def wrap(plain):
            def decode_multi(*a, **kw):
                before = {s: int(eng.lengths[s]) for s in eng.slot_req}
                t0 = time.perf_counter()
                with self.span(DECODE):
                    out = plain(*a, **kw)
                self.decodes.append(Call(t0, time.perf_counter(), [
                    (before[s], len(toks)) for s, toks in out.items()]))
                return out
            return decode_multi
        return wrap

    def _move(self, name):
        def wrap(plain):
            def move(act):
                self.moves.setdefault(name, []).append(act.rid)
                with self.span(name):
                    return plain(act)
            return move
        return wrap

    def _plain_span(self, name):
        def wrap(plain):
            def entry(*a, **kw):
                with self.span(name):
                    return plain(*a, **kw)
            return entry
        return wrap
