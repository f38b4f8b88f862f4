"""What one run recorded, as the metric readers see it: the window on the
wall clock, every request sent with its due time and token stamps, the
harness's spans around the layers, the cluster's counters at the window's
edges, and the reduced device trace of a traced run."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from bench import stats
from bench.probes import Call, Probes
from bench.pump import Pump, Sent
from bench.trace import Trace
from flops import Shape


@dataclass
class Run:
    cell: object
    seed: int
    seconds: float
    start: float
    end: float
    setup_s: float
    pump: Pump
    probes: Probes
    shape: Shape
    stats0: Dict[str, float]
    stats1: Dict[str, float]
    sched0: tuple
    sched1: tuple
    trace: Optional[Trace] = None
    _walls: Dict[int, List[float]] = field(default_factory=dict)

    # -- requests -----------------------------------------------------------
    def walls(self, s: Sent) -> List[float]:
        rid = s.req.rid
        if rid not in self._walls:
            self._walls[rid] = self.pump.token_walls(s)
        return self._walls[rid]

    def window_requests(self) -> List[Sent]:
        """Open loop: the requests due in the window; closed loop: those
        sent in it."""
        return [s for s in self.pump.sent.values()
                if s.window and s.due < self.end]

    def output_tokens(self) -> int:
        return sum(stats.count_in_window(self.walls(s), self.start, self.end)
                   for s in self.pump.sent.values())

    def ttfts_ms(self) -> List[float]:
        reqs = self.window_requests()
        return [1e3 * t for t in stats.ttft_samples(
            [s.due for s in reqs], [self.pump.first_wall(s) for s in reqs],
            self.end)]

    def tpots_ms(self) -> List[float]:
        """Time per output token of every request that ended in the
        window: its first token to its last over the gaps between."""
        out = []
        for s in self.pump.sent.values():
            if s.req.finish_time is None:
                continue
            w = self.walls(s)
            end = self.pump.wall_of(s.req.finish_time)
            if len(w) >= 2 and self.start <= end <= self.end:
                out.append(1e3 * (w[-1] - w[0]) / (len(w) - 1))
        return out

    def tbts_ms(self) -> List[float]:
        out: List[float] = []
        for s in self.pump.sent.values():
            out += stats.gaps_in_window(self.walls(s), self.start, self.end)
        return [1e3 * g for g in out]

    # -- spans --------------------------------------------------------------
    def in_window(self, calls: List[Call]) -> List[Call]:
        return [c for c in calls if self.start <= c.start < self.end]

    def steps(self) -> List[tuple]:
        return [(s, e) for s, e in zip(self.pump.starts_wall,
                                       self.pump.ends_wall)
                if self.start <= s < self.end]

    def delta(self, key: str) -> float:
        return self.stats1[key] - self.stats0[key]
