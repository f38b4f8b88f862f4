"""An in-program tracer for the serving step: host spans, integer
counters and per-request wall stamps, all on ``time.perf_counter_ns``.

A ``LiveCluster`` built with ``tracer=Tracer()`` hands the one tracer to
every engine and store, and they record into it:

* spans ``(name, depth, t0_ns, t1_ns)``, appended when they end, so a
  span follows every span it holds; ``depth`` counts the spans open
  around it;
* counters ``{name: n}`` (blocking device-to-host reads by site, decode
  block-table uploads);
* stamps ``{rid: {event: t_ns}}``, the first time each event happened to
  the request (``submit``, ``prefill``, ``first``, ``done``).

``mark``, where given, is called with ``"+name"`` as a span opens and
``"-name"`` as it closes, in that order, so a caller can put each edge on
another clock (a device trace's).  Every ``begin`` is ended, by its own
``end`` or by the ``end`` of a span around it, so the edges always
balance.

Without a tracer (``tracer=None``, the default everywhere) the program
reads no clock: each site is a ``None`` test, :func:`span`'s shared
no-op context or :func:`traced`'s.
"""
from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Dict, List, Optional, Tuple

#: the no-op context every span site enters when there is no tracer
_NO_SPAN = contextlib.nullcontext()


class Tracer:
    def __init__(self, mark: Optional[Callable[[str], None]] = None):
        self.mark = mark
        self.spans: List[Tuple[str, int, int, int]] = []
        self.counters: Dict[str, int] = {}
        self.stamps: Dict[int, Dict[str, int]] = {}
        self._open: List[Tuple[str, int]] = []

    def begin(self, name: str) -> None:
        if self.mark is not None:
            self.mark("+" + name)
        self._open.append((name, time.perf_counter_ns()))

    def end(self, name: str) -> None:
        """Close ``name``, the innermost open span of that name, and
        every span still open inside it (a raise skipped their ends)."""
        if all(n != name for n, _ in self._open):
            raise ValueError(f"span {name!r} is not open")
        while True:
            inner, t0 = self._open.pop()
            self.spans.append((inner, len(self._open), t0,
                               time.perf_counter_ns()))
            if self.mark is not None:
                self.mark("-" + inner)
            if inner == name:
                return

    @contextlib.contextmanager
    def span(self, name: str):
        self.begin(name)
        try:
            yield
        finally:
            self.end(name)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def stamp(self, rid: int, event: str) -> None:
        """The wall time ``event`` first happened to request ``rid``."""
        events = self.stamps.setdefault(rid, {})
        if event not in events:
            events[event] = time.perf_counter_ns()


def span(tracer: Optional[Tracer], name: str):
    """``tracer.span(name)``, or a shared no-op context without one."""
    return _NO_SPAN if tracer is None else tracer.span(name)


def traced(name: str):
    """Decorate a method of an object with a ``tracer`` attribute so that
    each call runs inside the span ``name``."""
    def wrap(method):
        @functools.wraps(method)
        def inner(self, *args, **kwargs):
            if self.tracer is None:
                return method(self, *args, **kwargs)
            with self.tracer.span(name):
                return method(self, *args, **kwargs)
        return inner
    return wrap
