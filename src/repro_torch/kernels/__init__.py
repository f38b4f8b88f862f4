"""Hand-written Hopper kernels of the port, each beside its plain version.

* :mod:`repro_torch.kernels.flash_attention` — prefill attention;
* :mod:`repro_torch.kernels.decode_attention` — paged and dense decode
  attention;
* :mod:`repro_torch.kernels.mamba_scan` — the Mamba-1 selective scan.

Each module keeps a ``counts`` dict that maps each of its kernels to its
kernel launches and plain-version calls; :data:`KERNELS` gathers them by
kernel name, and :func:`reset_counts` and :func:`read_counts` read them
all.  A replayed CUDA graph calls no wrapper: a capture takes the calls
it counted back out (:func:`counts_since`, :func:`add_counts` with
``times`` -1), and each replay credits them.
"""
from __future__ import annotations

from typing import Dict, Mapping

from repro_torch.kernels import decode_attention, flash_attention, mamba_scan

#: kernel name -> its ``{"launches", "plain_calls"}`` counts
KERNELS = {name: c for mod in (flash_attention, decode_attention, mamba_scan)
           for name, c in mod.counts.items()}


def reset_counts() -> None:
    for c in KERNELS.values():
        for key in c:
            c[key] = 0


def read_counts() -> Dict[str, Dict[str, int]]:
    return {name: dict(c) for name, c in KERNELS.items()}


def counts_since(before: Mapping[str, Mapping[str, int]]
                 ) -> Dict[str, Dict[str, int]]:
    """The calls counted since ``before`` (a :func:`read_counts`)."""
    return {name: {key: n - before[name][key] for key, n in c.items()}
            for name, c in KERNELS.items()}


def add_counts(counts: Mapping[str, Mapping[str, int]], times: int = 1
               ) -> None:
    """Credit ``times`` x ``counts`` (a :func:`counts_since`)."""
    for name, c in counts.items():
        for key, n in c.items():
            KERNELS[name][key] += times * n
