"""Hand-written Hopper kernels of the port, each beside its plain version.

* :mod:`repro_torch.kernels.flash_attention` — prefill attention;
* :mod:`repro_torch.kernels.decode_attention` — paged and dense decode
  attention;
* :mod:`repro_torch.kernels.mamba_scan` — the Mamba-1 selective scan.

Each module keeps a ``counts`` dict that maps each of its kernels to its
kernel launches and plain-version calls; :data:`KERNELS` gathers them by
kernel name, and :func:`reset_counts` and :func:`read_counts` read them
all.
"""
from __future__ import annotations

from typing import Dict

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
