"""Traffic generators in seconds, driven by the parameters of a traffic
file (``perfbench/traffic/<mix>.json``) and the run's seed.

Every seed gets the same work in another order: prompt and output lengths
are the evenly spaced quantiles of their distribution, and Poisson gaps
the evenly spaced quantiles of the exponential, each permuted by the seed.
So the spread between two seeds is the system's, not the draw's.  Token
ids are drawn from the seed.  An MMPP (on/off Poisson) stream draws its
phases and gaps from the seed as they come, since its bursts are the point.

Arrival kinds:
  ``poisson``  open loop, ``rate`` requests per second;
  ``mmpp``     open loop, ``rate_on``/``rate_off`` requests per second in
               exponential phases of mean ``mean_on``/``mean_off`` seconds;
  ``closed``   ``clients`` clients, each sending its next request when its
               last one ends.  The clients start out of step, as a loop
               that has run for a while does: each client's first request
               is one already part of the way through its answer (its
               prompt holds the tokens answered so far, its output what
               is left), the parts evenly spread over the clients, so
               requests end and refill all through the window.
Length kinds: ``uniform`` (inclusive ``prompt`` and ``output`` ranges) and
``table2`` (AcceLLM Table 2's ``light``, ``mixed`` or ``heavy`` ranges).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

#: AcceLLM (arXiv:2411.05555) Table 2: ((prompt lo, hi), (output lo, hi))
TABLE2 = {
    "light": ((20, 500), (20, 500)),
    "mixed": ((20, 1000), (20, 1000)),
    "heavy": ((500, 1000), (500, 1000)),
}

#: streams drawn from one seed: the window's, the warm-up's, token ids
_WINDOW, _WARM, _TOKENS = 1, 2, 3
#: the one generator, whatever the seed, that pairs a closed loop's first
#: output lengths (by rank) with the parts already answered
_PAIRING = 0


@dataclass
class Arrival:
    """One request of the traffic: when it is due (seconds after its
    stream starts; closed-loop requests are due when their client sends
    them), its sizes and, for a closed loop, its client."""
    index: int
    due: float
    prompt_len: int
    output_len: int
    client: Optional[int] = None


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A generator per (seed, stream); any whole seed, negative or past 64
    bits, maps to one."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def ranges(lengths: Dict) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    if lengths["kind"] == "uniform":
        return tuple(lengths["prompt"]), tuple(lengths["output"])
    if lengths["kind"] == "table2":
        return TABLE2[lengths["mix"]]
    raise ValueError(f"unknown length kind {lengths['kind']!r}")


def even_uniform(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` evenly spaced quantiles of the uniform integers lo..hi."""
    return lo + ((np.arange(n) + 0.5) * (hi - lo + 1) / n).astype(np.int64)


def even_exponential(rate: float, n: int) -> np.ndarray:
    """``n`` evenly spaced quantiles of the exponential of ``rate``."""
    return -np.log1p(-(np.arange(n) + 0.5) / n) / rate


def sizes(lengths: Dict, n: int, rng: np.random.Generator
          ) -> Tuple[np.ndarray, np.ndarray]:
    """(prompt lengths, output lengths) of ``n`` requests: the same
    multiset for every seed, in the seed's order."""
    (plo, phi), (olo, ohi) = ranges(lengths)
    return (rng.permutation(even_uniform(plo, phi, n)),
            rng.permutation(even_uniform(olo, ohi, n)))


def poisson(rate: float, seconds: float, rng: np.random.Generator
            ) -> np.ndarray:
    """Due times of a Poisson stream over [0, seconds): n = round(rate x
    seconds) arrivals whose gaps are the exponential's n evenly spaced
    quantiles in the seed's order, scaled so that the last one falls
    half a mean gap before ``seconds``."""
    n = max(1, int(round(rate * seconds)))
    gaps = rng.permutation(even_exponential(rate, n))
    gaps *= seconds * n / (n + 0.5) / gaps.sum()
    return np.cumsum(gaps)


def mmpp(rate_on: float, rate_off: float, mean_on: float, mean_off: float,
         seconds: float, rng: np.random.Generator) -> np.ndarray:
    """Due times of a Markov-modulated on/off Poisson stream over
    [0, seconds), starting in an ON phase."""
    out: List[float] = []
    t, on = 0.0, True
    phase_end = rng.exponential(mean_on)
    while t < seconds:
        r = rate_on if on else rate_off
        if r > 0.0:
            gap = rng.exponential(1.0 / r)
            if t + gap < phase_end:
                t += gap
                if t < seconds:
                    out.append(t)
                continue
        t = phase_end
        on = not on
        phase_end = t + rng.exponential(mean_on if on else mean_off)
    return np.asarray(out)


def open_loop(traffic: Dict, seconds: float, rng: np.random.Generator
              ) -> List[Arrival]:
    arr = traffic["arrival"]
    if arr["kind"] == "poisson":
        due = poisson(arr["rate"], seconds, rng)
    elif arr["kind"] == "mmpp":
        due = mmpp(arr["rate_on"], arr["rate_off"], arr["mean_on"],
                   arr["mean_off"], seconds, rng)
    else:
        raise ValueError(f"{arr['kind']!r} is not an open-loop arrival")
    p, o = sizes(traffic["lengths"], len(due), rng)
    return [Arrival(i, float(d), int(pl), int(ol))
            for i, (d, pl, ol) in enumerate(zip(due, p, o))]


def closed_loop(traffic: Dict, per_client: int, rng: np.random.Generator
                ) -> List[List[Arrival]]:
    """Each client's requests in the order it sends them, ``per_client``
    each; due times are set when they are sent.  The j-th requests of all
    clients are one round: the same multiset of sizes for every seed, in
    the seed's order over the clients.  The first round's parts already
    answered are paired with its output lengths by one pairing for every
    seed (by the lengths' ranks), so the tokens left to answer are the
    same multiset for every seed, and requests end in the window at the
    same iterations whatever the seed."""
    k = traffic["arrival"]["clients"]
    rounds = [sizes(traffic["lengths"], k, rng) for _ in range(per_client)]
    out = [[Arrival(c * per_client + j, math.nan, int(rounds[j][0][c]),
                    int(rounds[j][1][c]), client=c)
            for j in range(per_client)] for c in range(k)]
    parts = (np.random.default_rng(_PAIRING).permutation(k) + 0.5) / k
    rank = np.argsort(rounds[0][1], kind="stable")
    for r, c in enumerate(rank):
        a = out[c][0]
        answered = min(int(parts[r] * a.output_len), a.output_len - 2)
        a.prompt_len += answered
        a.output_len -= answered
    return out


def window_traffic(traffic: Dict, seed: int, seconds: float):
    """The measured window's requests: a list of arrivals for an open
    loop, or a list per client for a closed one."""
    rng = rng_for(seed, _WINDOW)
    if traffic["arrival"]["kind"] == "closed":
        return closed_loop(traffic, traffic["arrival"]["per_client"], rng)
    return open_loop(traffic, seconds, rng)


def warm_traffic(traffic: Dict, seed: int) -> List[Arrival]:
    """The open-loop warm-up before the window: the same mix for
    ``warm_seconds``, from a stream of its own."""
    return open_loop(traffic, traffic["warm_seconds"], rng_for(seed, _WARM))


def prompt_ids(seed: int, lens: List[int], vocab: int) -> List[np.ndarray]:
    """Token ids of each prompt, uniform over the vocabulary, in one
    draw."""
    rng = rng_for(seed, _TOKENS)
    flat = rng.integers(0, vocab, size=int(sum(lens)), dtype=np.int64)
    out, at = [], 0
    for n in lens:
        out.append(flat[at:at + n].astype(np.int32))
        at += n
    return out
