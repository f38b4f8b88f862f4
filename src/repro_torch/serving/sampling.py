"""Token sampling.

Decode determinism contract, as in the JAX package: every sampling site
(prefill, padded batched prefill, dense decode and the fused paged decode
loop) consumes exactly ONE draw of the engine's iteration counter, and a
row's randomness is keyed by its request *slot*.  The token for a slot
therefore depends only on (iteration, slot), never on how the batch is
composed: compacted vs full-batch decode and fused vs sequential steps
stay token-identical.

At temperature > 0 iteration ``i`` draws Gumbel noise of shape
``(num_slots + 1, V)`` from a ``torch.Generator`` seeded by
``(seed, instance_id, i)``; each row takes the noise row of its slot (the
extra row serves padded prefill rows).  The bits differ from the JAX
package's threefry keys, so the two packages agree at temperature 0 only.
"""
from __future__ import annotations

from typing import Optional

import torch


def sample_slots(logits: torch.Tensor, slots: torch.Tensor,
                 temperature: float = 0.0,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B, V), slots (B,) -> (B,) int32.  Greedy at temperature 0;
    otherwise Gumbel-max with row ``i`` taking ``noise[slots[i]]``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if noise is None:
        raise ValueError("sampling at temperature > 0 needs noise")
    z = logits.float() / temperature + noise[slots.long()]
    return torch.argmax(z, dim=-1).to(torch.int32)


def gumbel_noise(seed: int, instance_id: int, iteration: int, rows: int,
                 vocab: int, device) -> torch.Tensor:
    """Standard Gumbel noise (rows, vocab) for one sampling iteration; the
    generator seed is distinct per (seed + instance_id, iteration), like
    the JAX package's ``PRNGKey(seed + instance_id)`` split chain."""
    gen = torch.Generator(device=device)
    gen.manual_seed(((seed + instance_id) << 32) + iteration)
    u = torch.rand((rows, vocab), generator=gen, device=device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp_min(tiny)))
