"""The wall-clock pump over ``repro_torch``'s ``LiveCluster``.

It copies ``LiveCluster.run``'s open- and closed-loop admission, calling
``submit`` and ``step`` itself, and stamps the wall time at the end of
every step.  The cluster stamps a request's first token and every later
one with its iteration clock; each iteration maps to the wall time at the
end of the step that ran it, when its tokens reached the host (a fused
decode dispatch delivers all of its tokens at once).

The pump writes three of the cluster's private attributes, as
``LiveCluster.run`` does: ``_arrival_horizon`` (a fused decode span may not
run past the next arrival), ``_closed_loop`` and ``finished`` (with each
finished request's ``finish_time``).  It checks that each is there before
it runs, so that a program that renames one fails here instead of running
on with a setting nothing reads.
"""
from __future__ import annotations

import bisect
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from bench.traffic import Arrival


@dataclass
class Sent:
    """A request of the traffic as the cluster got it: when it was due on
    the wall clock, and the program's own ``Request``."""
    arrival: Arrival
    due: float
    req: object
    window: bool
    promoted: bool = False
    streamed: bool = False
    mirrored: bool = False


@dataclass
class Pump:
    cluster: object
    make_request: Callable[[Arrival], object]
    clock: Callable[[], float] = time.perf_counter
    #: per step: the iteration clock and the wall time at its end, and
    #: the wall time at its start
    ends_iter: List[float] = field(default_factory=list)
    ends_wall: List[float] = field(default_factory=list)
    starts_wall: List[float] = field(default_factory=list)
    sent: Dict[int, Sent] = field(default_factory=dict)
    inflight: Dict[int, Sent] = field(default_factory=dict)

    #: the cluster's attributes the pump writes, as ``LiveCluster.run``
    CLUSTER_ATTRS = ("_arrival_horizon", "_closed_loop", "finished")

    def __post_init__(self):
        missing = [a for a in self.CLUSTER_ATTRS
                   if not hasattr(self.cluster, a)]
        if missing:
            raise AttributeError(
                f"the cluster has no {', '.join(missing)}: the pump copies "
                f"LiveCluster.run's admission and writes them")

    # -- the cluster's clock on the wall ----------------------------------
    def wall_of(self, iteration: float) -> float:
        """Wall time at the end of the step that ran ``iteration``."""
        i = bisect.bisect_left(self.ends_iter, iteration)
        return self.ends_wall[i]

    def token_walls(self, s: Sent) -> List[float]:
        return [self.wall_of(t) for t in s.req.token_times]

    def first_wall(self, s: Sent) -> Optional[float]:
        t = s.req.first_token_time
        return None if t is None else self.wall_of(t)

    def seconds_per_iteration(self) -> Optional[float]:
        if len(self.ends_iter) < 2 or self.ends_iter[-1] == self.ends_iter[0]:
            return None
        return ((self.ends_wall[-1] - self.ends_wall[0])
                / (self.ends_iter[-1] - self.ends_iter[0]))

    def in_flight(self, times: List[float]) -> List[int]:
        """Requests due and not yet finished (waiting or decoding) at each
        of ``times``."""
        done = {rid: self.wall_of(s.req.finish_time)
                for rid, s in self.sent.items()
                if s.req.finish_time is not None}
        return [sum(1 for rid, s in self.sent.items() if s.due <= t
                    and done.get(rid, math.inf) > t) for t in times]

    # -- submit and step ----------------------------------------------------
    def submit(self, a: Arrival, due: float, window: bool) -> Sent:
        req = self.make_request(a)
        if not hasattr(req, "finish_time"):
            raise AttributeError("the program's Request has no finish_time")
        s = Sent(a, due, req, window)
        self.sent[req.rid] = s
        self.inflight[req.rid] = s
        self.cluster.submit(req)
        return s

    def step(self) -> List[Sent]:
        """One ``LiveCluster.step``; returns the requests it ended."""
        from repro_torch.serving.request import Phase
        c = self.cluster
        self.starts_wall.append(self.clock())
        c.step()
        self.ends_wall.append(self.clock())
        self.ends_iter.append(c.now)
        ended = []
        for rid, s in list(self.inflight.items()):
            req = s.req
            if req.phase in (Phase.DONE, Phase.SHED, Phase.ABORTED):
                if req.phase is Phase.DONE and req.finish_time is None:
                    req.finish_time = c.now
                    c.finished.append(req)
                del self.inflight[rid]
                ended.append(s)
        return ended

    # -- open loop ----------------------------------------------------------
    def open_loop(self, arrivals: List[Arrival], start: float,
                  seconds: float, window: bool) -> None:
        """Send each arrival when it is due (``start`` + its due time) and
        step the cluster until ``start + seconds``; idle while nothing is
        in flight.  As ``LiveCluster.run`` does, a fused decode span may
        not run past the next arrival: its horizon is the iterations until
        then at the seconds per iteration seen so far."""
        c = self.cluster
        end = start + seconds
        i = 0
        while True:
            now = self.clock()
            if now >= end:
                break
            while i < len(arrivals) and start + arrivals[i].due <= now:
                self.submit(arrivals[i], start + arrivals[i].due, window)
                i += 1
            nxt = start + arrivals[i].due if i < len(arrivals) else None
            spi = self.seconds_per_iteration()
            if nxt is None:
                c._arrival_horizon = None
            elif spi is None:
                c._arrival_horizon = 1
            else:
                c._arrival_horizon = max(1, math.floor((nxt - now) / spi))
            if not c.pending():
                time.sleep(max(0.0, min(nxt if nxt is not None else end,
                                        end) - now))
                continue
            self.step()

    # -- closed loop --------------------------------------------------------
    def closed_loop(self, clients: List[List[Arrival]], seconds: float,
                    open_after: Callable[[], None],
                    warm_timeout: float) -> float:
        """Send every client's first request, step until each of them is
        decoding (the warm stretch), call ``open_after`` and keep every
        client sending its next request when its last one ends, until
        ``seconds`` after the window opened.  Returns the window's start."""
        c = self.cluster
        c._closed_loop = True
        nxt = [1] * len(clients)
        t0 = self.clock()
        first = [self.submit(reqs[0], t0, window=False) for reqs in clients]

        def refill(window: bool) -> None:
            for s in self.step():
                k = s.arrival.client
                if nxt[k] >= len(clients[k]):
                    raise RuntimeError(f"client {k} ran out of requests")
                self.submit(clients[k][nxt[k]], self.clock(), window=window)
                nxt[k] += 1

        while any(s.req.first_token_time is None for s in first):
            if self.clock() - t0 > warm_timeout:
                raise RuntimeError(
                    f"the warm stretch did not reach every client's first "
                    f"token in {warm_timeout} s")
            refill(window=False)
        open_after()
        start = self.clock()
        end = start + seconds
        while self.clock() < end:
            refill(window=True)
        return start


def request_factory(prompts: Dict[int, np.ndarray]):
    """Builds the program's ``Request`` of an arrival from its prompt ids
    (``prompts`` by arrival index; the rid is the index)."""
    from repro_torch.serving.request import Request

    def make(a: Arrival):
        ids = prompts[a.index]
        return Request(prompt_len=int(ids.shape[0]),
                       max_new_tokens=int(a.output_len), rid=int(a.index),
                       prompt_tokens=ids.reshape(1, -1))
    return make
