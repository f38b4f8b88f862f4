"""The comparison that decides ``correct``.

Once the window has closed, a sample of the served requests, drawn from
the seed and holding the longest, goes to the plain reference: it runs
once over each prompt followed by the tokens the cluster served, and at
every served position reads the gap by which the served token's logit
lies below the reference's best.  The widest gap over the sample is the
number compared; the cell's file gives its limit.  Greedy decoding makes
the served token the program's own best, so the gap measures how far the
program's arithmetic strays from the reference's.

The control puts the reference in the program's place, computed one
precision step below the served bfloat16 (float8 e4m3 matrix products):
at the same positions it reads the gap of the token the lower precision
puts first.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from bench.traffic import rng_for

_SAMPLE = 4


def choose(cands: Sequence, seed: int, k: int) -> List:
    """``k`` of ``cands`` (each with ``.req``): the longest (prompt plus
    served tokens), one the cluster promoted and one it streamed where
    there are such, the rest drawn from the seed."""
    if not cands:
        return []
    total = [s.req.prompt_len + len(s.req.output_tokens) for s in cands]
    picked = [int(np.argmax(total))]
    for flag in ("promoted", "streamed"):
        have = [i for i, s in enumerate(cands) if getattr(s, flag)
                and i not in picked]
        if have and not any(getattr(cands[i], flag) for i in picked):
            picked.append(have[0])
    rest = [i for i in range(len(cands)) if i not in picked]
    rng = rng_for(seed, _SAMPLE)
    need = max(0, min(k, len(cands)) - len(picked))
    picked += [rest[i] for i in rng.permutation(len(rest))[:need]]
    return [cands[i] for i in picked]


def sequences(chosen: Sequence, device) -> Tuple[List, List, List]:
    """Per request: the prompt followed by every served token but the
    last, the rows whose logits score the served tokens, and those
    tokens."""
    import torch
    seqs, rows, toks = [], [], []
    for s in chosen:
        prompt = np.asarray(s.req.prompt_tokens).reshape(-1)
        out = np.asarray(s.req.output_tokens, np.int64)
        ids = np.concatenate([prompt.astype(np.int64), out[:-1]])
        seqs.append(torch.as_tensor(ids, device=device))
        P = prompt.shape[0]
        rows.append(torch.arange(P - 1, P - 1 + len(out), device=device))
        toks.append(torch.as_tensor(out, device=device))
    return seqs, rows, toks


def gap_of(logits, tokens):
    """Per row: the best logit minus the logit of ``tokens``."""
    best = logits.max(dim=-1).values
    return best - logits.gather(1, tokens.long()[:, None])[:, 0]


def served_gaps(cfg: Dict, weights, chosen: Sequence, device
                ) -> Tuple[float, int, List[float]]:
    """(widest gap, tokens compared, widest gap per request) of the
    served tokens against the float32 reference."""
    from reference.dense import forward
    seqs, rows, toks = sequences(chosen, device)
    logits = forward(cfg, weights, seqs, rows)
    per = [float(gap_of(lg, t).max()) for lg, t in zip(logits, toks)]
    return max(per), sum(int(t.numel()) for t in toks), per


def control_gap(cfg: Dict, weights, chosen: Sequence, device) -> float:
    """The widest gap at the served positions between the float32
    reference's best and its logit of the token the float8 control puts
    first."""
    from reference.dense import forward
    seqs, rows, _ = sequences(chosen, device)
    ref = forward(cfg, weights, seqs, rows)
    low = forward(cfg, weights, seqs, rows, precision="fp8")
    return max(float(gap_of(r, lo.argmax(-1)).max())
               for r, lo in zip(ref, low))
