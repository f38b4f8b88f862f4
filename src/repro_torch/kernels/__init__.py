"""Hand-written Hopper kernels of the port, each beside its plain version.

* :mod:`repro_torch.kernels.flash_attention` — prefill attention;
* :mod:`repro_torch.kernels.decode_attention` — paged decode attention.

Each module keeps a ``counts`` dict of kernel launches and plain-version
calls; :func:`reset_counts` and :func:`read_counts` read them all.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import decode_attention, flash_attention

KERNELS = {"flash_attention": flash_attention,
           "paged_decode_attention": decode_attention}


def reset_counts() -> None:
    for mod in KERNELS.values():
        for key in mod.counts:
            mod.counts[key] = 0


def read_counts() -> Dict[str, Dict[str, int]]:
    return {name: dict(mod.counts) for name, mod in KERNELS.items()}
