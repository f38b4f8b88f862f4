"""Top-level model: embedding → layer stack → head.

Functional API on nested-dict params, mirroring the JAX package's:

  init_params(cfg, generator, device)                  -> params
  init_state(cfg, batch, seq_len, device)             -> serving state
  prefill(cfg, params, batch, state)                   -> (last_logits, state)
  prefill_batched(cfg, params, tokens, state, lengths) -> (logits, state)
  decode_step(cfg, params, tokens, state, t)           -> (logits, state)
  decode_step_paged(...)                               -> (logits, state)
  decode_multi(...)                                    -> (tokens, state, emitted)

The state is updated in place; the returned state is the one passed in.
This slice runs decoder-only attention stacks with GQA and dense FFNs.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import Device, resolve_device
from repro_torch.models.attention import PagedDecode
from repro_torch.models.blocks import (apply_stack, init_stack,
                                       init_stack_state, layer_specs,
                                       plan_segments)
from repro_torch.models.common import (dense_init, dtype_of, embed_init,
                                       rms_norm)


def _segs(cfg: ModelConfig):
    return plan_segments(layer_specs(cfg))


def check_config(cfg: ModelConfig):
    """Raise for what this slice of the port does not run yet."""
    later = []
    if cfg.attention_kind != "gqa":
        later.append(f"{cfg.attention_kind} attention (MLA slice)")
    if cfg.is_encoder_decoder or cfg.frontend is not None:
        later.append("encoder / modality front ends (encoder-decoder slice)")
    if cfg.abs_pos != "none":
        later.append(f"{cfg.abs_pos} absolute positions")
    if cfg.mtp_depth:
        later.append("multi-token prediction (training slice)")
    if later:
        raise NotImplementedError(f"{cfg.name}: " + "; ".join(later)
                                  + " wait for later slices of the port")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: Device = "cuda"):
    """Random weights at the JAX package's scales (fan-in normal, embedding
    std 0.02), drawn from ``generator`` (which must live on ``device``)."""
    check_config(cfg)
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    params: Dict[str, Any] = {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype,
                            dev)}
    _, params["segments"] = init_stack(generator, cfg, dtype, dev)
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, (cfg.d_model,
                                                   cfg.vocab_size), dtype, dev)
    return params


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def _embed_tokens(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def _head(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ w).float() * cfg.logit_scale


# ---------------------------------------------------------------------------
# Serving: state init / prefill / decode
# ---------------------------------------------------------------------------


def init_state(cfg: ModelConfig, batch: int, seq_len: int,
               device: Device = "cuda"):
    check_config(cfg)
    dev = resolve_device(device)
    return {"layers": init_stack_state(cfg, _segs(cfg), batch, seq_len,
                                       dtype_of(cfg.dtype), dev)}


def prefill(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], state
            ) -> Tuple[torch.Tensor, Any]:
    """Process the prompt, fill the caches, return last-token logits."""
    tokens = batch["tokens"]
    if set(batch) != {"tokens"}:
        raise NotImplementedError(
            f"batch extras {sorted(set(batch) - {'tokens'})} wait for the "
            f"encoder-decoder slice of the port")
    S = tokens.shape[1]
    pos = torch.arange(S, device=tokens.device)
    x = _embed_tokens(params, tokens)
    ctx = {"mode": "full", "positions": pos, "update_cache": True, "t": 0,
           "window": cfg.sliding_window}
    x = apply_stack(cfg, _segs(cfg), params["segments"], x, state["layers"],
                    ctx)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.rms_norm_eps)
    return _head(cfg, params, x)[:, 0], state


def prefill_batched(cfg: ModelConfig, params, tokens: torch.Tensor, state,
                    lengths: torch.Tensor) -> Tuple[torch.Tensor, Any]:
    """Right-padded multi-prompt prefill: ``tokens`` (B, L) with each row's
    true length in ``lengths`` (B,); returns per-row logits at the last
    *real* token and the filled caches.  Padded positions write garbage
    K/V rows beyond each row's length, which the per-request decode clocks
    mask (attention-only stacks only)."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)
    x = _embed_tokens(params, tokens)
    ctx = {"mode": "full", "positions": positions, "update_cache": True,
           "t": 0, "window": cfg.sliding_window}
    x = apply_stack(cfg, _segs(cfg), params["segments"], x, state["layers"],
                    ctx)
    last = x[torch.arange(B, device=x.device), lengths.long() - 1]
    last = rms_norm(last, params["final_norm"], cfg.rms_norm_eps)
    return _head(cfg, params, last), state


def decode_step(cfg: ModelConfig, params, tokens: torch.Tensor, state,
                t: torch.Tensor, paged: Optional[PagedDecode] = None
                ) -> Tuple[torch.Tensor, Any]:
    """One decode step: tokens (B, 1) at clock t (scalar or (B,)) ->
    (logits (B, V), state).  With ``paged`` the batch is compacted and
    attention reads K/V through block tables."""
    t = torch.as_tensor(t, device=tokens.device)
    pos = (t + torch.arange(1, device=t.device) if t.dim() == 0
           else t[:, None] + torch.arange(1, device=t.device)[None])
    x = _embed_tokens(params, tokens)
    ctx = {"mode": "decode", "positions": pos, "update_cache": True, "t": t,
           "window": cfg.sliding_window, "paged": paged}
    x = apply_stack(cfg, _segs(cfg), params["segments"], x, state["layers"],
                    ctx)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _head(cfg, params, x)[:, 0], state


def decode_step_paged(cfg: ModelConfig, params, tokens: torch.Tensor, state,
                      t: torch.Tensor, slots: torch.Tensor,
                      tables: torch.Tensor, block_lines: int
                      ) -> Tuple[torch.Tensor, Any]:
    """One *compacted, paged* decode step: ``tokens`` (Bc, 1) / ``t`` (Bc,)
    cover only the active primary slots; ``slots`` (Bc,) names each row's
    slot in the full cache, ``tables`` (Bc, max_blocks) its physical line
    blocks in the pool view."""
    return decode_step(cfg, params, tokens, state, t,
                       paged=PagedDecode(slots, tables, block_lines))


def decode_multi(cfg: ModelConfig, params, tokens: torch.Tensor, state,
                 t: torch.Tensor, slots: torch.Tensor, tables: torch.Tensor,
                 budget: torch.Tensor, *, steps: int, block_lines: int,
                 temperature: float = 0.0,
                 noise: Optional[torch.Tensor] = None, eos_token: int = -1
                 ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Fused multi-step paged decode: ``steps`` iterations of
    :func:`decode_step_paged` with on-device sampling and EOS / budget
    masks kept on the device, so the loop never waits on the host.

    Per row: ``budget`` is the remaining ``max_new_tokens``; a row goes
    dead once it has emitted its budget or sampled ``eos_token`` (-1 = no
    EOS).  Dead rows freeze: their clock stops, their (frozen) token
    re-writes the same reserved cache line, and their trace repeats the
    last token; the host reads only the first ``emitted[i]`` entries.
    ``noise`` (steps, num_slots + 1, V) is the per-iteration Gumbel noise
    for temperature > 0, indexed by slot.

    Returns ``(tokens_all (steps, Bc), state, emitted (Bc,))``."""
    from repro_torch.serving.sampling import sample_slots  # import cycle
    toks, tt = tokens, t
    Bc = tokens.shape[0]
    alive = torch.ones((Bc,), dtype=torch.bool, device=tokens.device)
    emitted = torch.zeros((Bc,), dtype=torch.int32, device=tokens.device)
    outs = []
    for i in range(steps):
        logits, state = decode_step_paged(cfg, params, toks, state, tt, slots,
                                          tables, block_lines)
        nxt = sample_slots(logits, slots, temperature,
                           None if noise is None else noise[i])
        nxt = torch.where(alive, nxt, toks[:, 0])
        emitted = emitted + alive.to(torch.int32)
        tt = tt + alive.to(tt.dtype)
        alive = alive & (nxt != eos_token) & (emitted < budget)
        toks = nxt[:, None]
        outs.append(nxt)
    return torch.stack(outs), state, emitted
