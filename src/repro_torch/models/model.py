"""Top-level model: embedding → (encoder) → layer stack → head.

Functional API on nested-dict params, mirroring the JAX package's:

  init_params(cfg, generator, device)                  -> params
  forward_train(cfg, params, batch, remat)             -> (logits, aux_loss)
  forward_mtp(cfg, params, batch)                      -> mtp logits
  init_state(cfg, batch, seq_len, long_context)        -> serving state
  prefill(cfg, params, batch, state)                   -> (last_logits, state)
  prefill_batched(cfg, params, tokens, state, lengths) -> (logits, state)
  prefill_chunk(cfg, params, tokens, state, history)   -> (logits, state)
  decode_step(cfg, params, tokens, state, t)           -> (logits, state)
  decode_step_paged(...)                               -> (logits, state)
  decode_multi(...)                                    -> (tokens, state, emitted)
  decode_iteration(...)                                -> one of decode_multi's steps

``batch`` is a dict: {"tokens": (B, S) int32} plus, per the modality
carve-out, {"patch_embeds": (B, P, E)} for VLMs or {"frames": (B, F, E)}
for audio enc-dec (precomputed front-end embeddings).  A VLM's patches go
through the projector (in f32) and lead the sequence at positions
``[0, P)``; an enc-dec model encodes its frames with a bidirectional
stack, keeps the memory in the state's ``enc_out`` and each decoder
layer's cross K/V in ``xk``/``xv``.

The state is updated in place; the returned state is the one passed in.
The port runs stacks of GQA or MLA attention, Mamba, mLSTM and sLSTM
mixers with dense or MoE FFNs, with or without an encoder, sinusoidal
absolute positions and a vision prefix.  The router's aux loss is summed
by ``apply_stack`` as in the JAX package; serving ignores it, training
adds it to the loss.  A multi-token-prediction head (DeepSeek-V3's
``mtp``) is built with the params, so both packages hold the same tree;
only :func:`forward_mtp` reads it, and, as in the JAX package, no caller
uses it.

The training forwards set ``ctx["train"]``: full-mode GQA attention and
the Mamba scan then take the differentiable model-level paths (the plain
chunked attention, the loop over ``_ssm_step``) and reach no kernel.
Serving never sets it, so it keeps the kernels.

Sequence parallelism (the JAX package's ``REPRO_SEQ_PARALLEL=1``): where
:func:`_seq_shard_ok` allows it, ``forward_train``, ``prefill`` and
``prefill_batched`` set ``ctx["seq_shard"]``, and the decoder's residual
stream holds each model rank's S / tp rows from the embedding to the
final norm (``repro_torch.models.blocks``).  The encoder, a chunk resume
and every decode step keep it whole.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import sharding
from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import Device, resolve_device
from repro_torch.models.attention import PagedDecode
from repro_torch.models.blocks import (LayerSpec, _at, apply_layer,
                                       apply_stack, init_layer, init_stack,
                                       init_stack_state, layer_specs,
                                       plan_segments)
from repro_torch.models.common import (dense_init, dtype_of, embed_init,
                                       gelu, rms_norm, sinusoidal_positions)


def _segs(cfg: ModelConfig):
    return plan_segments(layer_specs(cfg))


def _enc_segs(cfg: ModelConfig):
    return plan_segments(layer_specs(cfg, decoder=False))


def _is_vlm(cfg: ModelConfig) -> bool:
    return cfg.frontend is not None and cfg.frontend.kind == "vision"


def _seq_shard_ok(seq_len: int) -> bool:
    """The JAX package's sequence-parallelism gate: ``REPRO_SEQ_PARALLEL``
    is "1" (read at each call), a model axis of more than one rank is
    installed (a process group, or the dry run's recording mesh), and
    the ``seq_len`` rows divide it."""
    if os.environ.get("REPRO_SEQ_PARALLEL", "0") != "1":
        return False
    n = sharding.current().model_size
    return n > 1 and seq_len % n == 0 and seq_len >= n


def _seq_len(cfg: ModelConfig, batch: Dict[str, torch.Tensor]) -> int:
    """The decoder's rows: a VLM's patches lead its tokens."""
    S = batch["tokens"].shape[1]
    return S + batch["patch_embeds"].shape[1] if _is_vlm(cfg) else S


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: Device = "cuda"):
    """Random weights at the JAX package's scales and dtypes (fan-in
    normal, embedding std 0.02; Mamba's ``A_log``, ``D`` and ``dt_b``, the
    xLSTM gate leaves and the MoE router in f32), drawn from ``generator``
    (which must live on ``device``).  A VLM's tree holds the projector
    ``proj.{w1, w2}`` and an enc-dec model's the ``encoder`` stack (the
    decoder's dims) with its final norm.  With ``mtp_depth`` the tree holds
    the multi-token-prediction head as the JAX package's does: a norm, the
    combine projection and one attention layer with a dense FFN."""
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
    if _is_vlm(cfg):
        e = cfg.frontend.embed_dim
        params["proj"] = {
            "w1": dense_init(generator, (e, cfg.d_model), dtype, dev),
            "w2": dense_init(generator, (cfg.d_model, cfg.d_model), dtype,
                             dev)}
    if cfg.is_encoder_decoder:
        if cfg.encoder.d_model != cfg.d_model:
            raise ValueError(f"{cfg.name}: the encoder's d_model "
                             f"{cfg.encoder.d_model} is not the decoder's "
                             f"{cfg.d_model}")
        _, enc_segments = init_stack(generator, cfg, dtype, dev,
                                     decoder=False)
        params["encoder"] = {
            "segments": enc_segments,
            "final_norm": torch.ones((cfg.d_model,), dtype=dtype,
                                     device=dev)}
    if cfg.mtp_depth:
        layer = init_layer(generator, cfg, LayerSpec("attn", False, cfg.d_ff,
                                                     False), 1, dtype, dev)
        params["mtp"] = {
            "norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
            "combine": dense_init(generator, (2 * cfg.d_model, cfg.d_model),
                                  dtype, dev),
            "layer": _at(layer, 0)}
    return params


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def _embed_tokens(cfg: ModelConfig, params, tokens: torch.Tensor,
                  positions: torch.Tensor, seq: bool = False) -> torch.Tensor:
    """The tokens' embedding (plus sinusoidal positions); under ``seq``
    this model rank's rows of it."""
    emb = params["embed"]
    if emb.shape[0] != cfg.vocab_size:
        # vocab-sharded (tensor parallelism): each rank looks up the ids
        # of its rows, zeros elsewhere, and the ranks' rows are summed
        n = emb.shape[0]
        ids = tokens.long() - sharding.current().model_rank * n
        hit = (ids >= 0) & (ids < n)
        x = emb[ids.clamp(0, n - 1)] * hit[..., None].to(emb.dtype)
        x = sharding.seq_scatter(x) if seq else sharding.reduce(x)
    else:
        x = emb[tokens.long()]
        if seq:
            x = sharding.seq_split(x)
    if cfg.abs_pos == "sinusoidal":
        if seq:
            positions = sharding.seq_split(positions, -1)
        x = x + sinusoidal_positions(positions, cfg.d_model).to(x.dtype)
    return x


def _embed_inputs(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
                  seq: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token (+ visual prefix) embedding for decoder-only models, and the
    positions of the whole sequence.  The projector runs in f32 and its
    output is cast to the embedding's dtype; under tensor parallelism a
    rank holds ``w1``'s columns and ``w2``'s rows of its block of the
    hidden width.  Under ``seq`` the embedding is this model rank's rows
    (a VLM's P + S rows are cut after the concatenation)."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    dev = tokens.device
    if _is_vlm(cfg):
        pe = batch["patch_embeds"]
        proj = params["proj"]
        if proj["w1"].shape[-1] != cfg.d_model:
            pe = sharding.copy_in(pe)    # column-parallel w1
        prefix = gelu(pe.float() @ proj["w1"].float())
        prefix = prefix @ proj["w2"].float()
        if proj["w1"].shape[-1] != cfg.d_model:
            # tensor parallelism: column-parallel w1, row-parallel w2,
            # the ranks' f32 partials summed before the cast
            prefix = sharding.reduce(prefix)
        prefix = prefix.to(params["embed"].dtype)
        P = pe.shape[1]
        positions = torch.arange(P + S, device=dev)
        tok_x = _embed_tokens(cfg, params, tokens, positions[P:])
        x = torch.cat([prefix, tok_x], dim=1)
        return (sharding.seq_split(x) if seq else x), positions
    positions = torch.arange(S, device=dev)
    return _embed_tokens(cfg, params, tokens, positions, seq), positions


def _head(cfg: ModelConfig, params, x: torch.Tensor,
          seq: bool = False) -> torch.Tensor:
    """Logits of ``x``; under ``seq`` x is the rank's rows, gathered
    here."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    # the rank's vocab columns
    x = sharding.module_in(x, w.shape[-1] != cfg.vocab_size, seq)
    logits = (x @ w).float() * cfg.logit_scale
    if w.shape[-1] != cfg.vocab_size:
        # vocab-sharded head: every rank gets the whole row
        logits = sharding.gather(logits, -1, cfg.vocab_size)
    return logits


# ---------------------------------------------------------------------------
# Encoder (enc-dec models)
# ---------------------------------------------------------------------------


def _encode(cfg: ModelConfig, params, frames: torch.Tensor,
            train: bool = False, dims=None) -> torch.Tensor:
    """frames: (B, F, E) precomputed front-end embeddings -> the encoder
    memory (B, F, D): bidirectional attention through the prefill kernel
    (``causal=False``), or the plain chunked attention in training; no
    cache."""
    x = frames.to(params["final_norm"].dtype)
    pos = torch.arange(x.shape[1], device=x.device)
    if cfg.abs_pos == "sinusoidal":
        x = x + sinusoidal_positions(pos, cfg.d_model).to(x.dtype)
    ctx = {"mode": "full", "positions": pos, "update_cache": False,
           "causal": False, "train": train}
    x, _ = apply_stack(cfg, _enc_segs(cfg), params["encoder"]["segments"], x,
                       None, ctx, dims=dims)
    return rms_norm(x, params["encoder"]["final_norm"], cfg.rms_norm_eps)


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


def forward_train(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
                  remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full causal forward; returns (logits (B, S, V) f32, router aux loss
    (0-dim f32)).  An enc-dec batch's frames are encoded and each decoder
    layer's cross K/V recomputed from them (training keeps no cache); a
    VLM's logits start past its patches.  ``remat`` checkpoints each
    repeat of the stack.  Under sequence parallelism (``seq_shard``, the
    JAX package's residual constraint) the decoder's residual is the
    model rank's rows; the final norm runs on them and they are gathered
    into the head.  Under the sharded train step's FSDP
    (``sharding.current().fsdp``, each leaf's data-cut dim) the leaves
    outside the stack are gathered over "data" here, and the stack's per
    repeat."""
    dims = sharding.current().fsdp
    if dims is not None:
        params = _gather_outside(params, dims)
    seq = _seq_shard_ok(_seq_len(cfg, batch))
    ctx = {"mode": "full", "update_cache": False, "train": True,
           "seq_shard": seq}
    if cfg.is_encoder_decoder:
        enc_out = _encode(cfg, params, batch["frames"], train=True,
                          dims=dims and dims["encoder"]["segments"])
        tokens = batch["tokens"]
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = _embed_tokens(cfg, params, tokens, pos, seq)
        ctx.update(enc_out=enc_out, precompute_cross=True)
    else:
        x, pos = _embed_inputs(cfg, params, batch, seq)
    ctx["positions"] = pos
    x, aux = apply_stack(cfg, _segs(cfg), params["segments"], x, None, ctx,
                         remat=remat, dims=dims and dims["segments"])
    final = params["final_norm"]
    x = rms_norm(x, sharding.copy_in(final) if seq else final,
                 cfg.rms_norm_eps)
    logits = _head(cfg, params, x, seq)
    if _is_vlm(cfg):
        logits = logits[:, batch["patch_embeds"].shape[1]:]
    return logits, torch.as_tensor(aux, dtype=torch.float32,
                                   device=logits.device)


def _gather_outside(params, dims):
    """``params`` with the leaves outside the stacks (embedding, head,
    norms, the projector) gathered over "data"; the stacks stay cut."""
    out = dict(params)
    for key, value in params.items():
        if key == "encoder":
            out[key] = dict(value, final_norm=sharding.unshard(
                value["final_norm"], dims[key]["final_norm"]))
        elif key not in ("segments", "mtp"):
            out[key] = sharding.unshard(value, dims[key])
    return out


def forward_mtp(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]
                ) -> Optional[torch.Tensor]:
    """DeepSeek-V3 MTP auxiliary logits (depth 1): predict token t+2 from
    [h_t ; emb(token_{t+1})], (B, S - 1, V); None without an MTP head.
    A training loss term that, as in the JAX package, no caller uses."""
    if not cfg.mtp_depth or "mtp" not in params:
        return None
    tokens = batch["tokens"]
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x, _ = _embed_inputs(cfg, params, batch)
    ctx = {"mode": "full", "positions": pos, "update_cache": False,
           "train": True}
    h, _ = apply_stack(cfg, _segs(cfg), params["segments"], x, None, ctx,
                       remat=True)
    # shift: combine h_t with the embedding of token_{t+1}
    e_next = params["embed"][tokens[:, 1:].long()]
    comb = torch.cat([h[:, :-1], e_next], dim=-1) @ params["mtp"]["combine"]
    comb = rms_norm(comb, params["mtp"]["norm"], cfg.rms_norm_eps)
    out, _, _ = apply_layer(cfg, LayerSpec("attn", False, cfg.d_ff, False),
                            params["mtp"]["layer"], comb, None,
                            dict(ctx, positions=pos[:-1]))
    return _head(cfg, params, out)


# ---------------------------------------------------------------------------
# Serving: state init / prefill / decode
# ---------------------------------------------------------------------------


def init_state(cfg: ModelConfig, batch: int, seq_len: int,
               long_context: bool = False, device: Device = "cuda"):
    """Serving state for ``batch`` requests of up to ``seq_len`` lines; an
    enc-dec model's also holds the encoder memory ``enc_out`` (batch,
    max_source_positions, D) and each decoder layer's cross K/V.  With
    ``long_context`` the attention caches are the long-context policy's
    rings (:func:`repro_torch.models.state.cache_capacity`); the steps
    that run on such a state take ``long_context=True`` too."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    cross_len = (cfg.encoder.max_source_positions
                 if cfg.is_encoder_decoder else None)
    state: Dict[str, Any] = {"layers": init_stack_state(
        cfg, _segs(cfg), batch, seq_len, dtype, dev, cross_len=cross_len,
        long_context=long_context)}
    if cfg.is_encoder_decoder:
        state["enc_out"] = torch.zeros((batch, cross_len, cfg.d_model),
                                       dtype=dtype, device=dev)
    return state


def prefill(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], state,
            long_context: bool = False) -> Tuple[torch.Tensor, Any]:
    """Process the prompt, fill the caches, return last-token logits.  An
    enc-dec batch's ``frames`` are encoded first, into the state's
    ``enc_out``, and every decoder layer projects its cross K/V from them;
    a VLM batch's ``patch_embeds`` lead the sequence, so P + S rows of each
    cache are written.  Under sequence parallelism the residual is
    gathered before its last row is read."""
    seq = _seq_shard_ok(_seq_len(cfg, batch))
    ctx = {"mode": "full", "update_cache": True, "t": 0,
           "window": _window(cfg, long_context), "seq_shard": seq}
    if cfg.is_encoder_decoder:
        enc_out = _encode(cfg, params, batch["frames"])
        if enc_out.shape != state["enc_out"].shape:
            raise ValueError(f"encoder memory {tuple(enc_out.shape)} for a "
                             f"state of {tuple(state['enc_out'].shape)}")
        state["enc_out"].copy_(enc_out)
        tokens = batch["tokens"]
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = _embed_tokens(cfg, params, tokens, pos, seq)
        ctx.update(enc_out=enc_out, precompute_cross=True)
    else:
        x, pos = _embed_inputs(cfg, params, batch, seq)
    ctx["positions"] = pos
    x, _ = apply_stack(cfg, _segs(cfg), params["segments"], x,
                       state["layers"], ctx)
    if seq:
        x = sharding.seq_gather(x, whole=True)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.rms_norm_eps)
    return _head(cfg, params, x)[:, 0], state


def prefill_batched(cfg: ModelConfig, params, tokens: torch.Tensor, state,
                    lengths: torch.Tensor, long_context: bool = False
                    ) -> Tuple[torch.Tensor, Any]:
    """Right-padded multi-prompt prefill: ``tokens`` (B, L) with each row's
    true length in ``lengths`` (B,); returns per-row logits at the last
    *real* token and the filled caches.  Padded positions write garbage
    K/V rows beyond each row's length, which the per-request decode clocks
    mask (attention-only stacks only).  Under sequence parallelism the
    residual is gathered before the last rows are read."""
    B, S = tokens.shape
    seq = _seq_shard_ok(S)
    positions = torch.arange(S, device=tokens.device)
    x = _embed_tokens(cfg, params, tokens, positions, seq)
    ctx = {"mode": "full", "positions": positions, "update_cache": True,
           "t": 0, "window": _window(cfg, long_context), "seq_shard": seq}
    x, _ = apply_stack(cfg, _segs(cfg), params["segments"], x,
                       state["layers"], ctx)
    if seq:
        x = sharding.seq_gather(x, whole=True)
    last = x[torch.arange(B, device=x.device), lengths.long() - 1]
    last = rms_norm(last, params["final_norm"], cfg.rms_norm_eps)
    return _head(cfg, params, last), state


def prefill_chunk(cfg: ModelConfig, params, tokens: torch.Tensor, state,
                  history: int, long_context: bool = False
                  ) -> Tuple[torch.Tensor, Any]:
    """Resumable chunked prefill: process ``tokens`` (B, C) at absolute
    positions ``[history, history + C)`` against a cache whose first
    ``history`` rows earlier chunks filled.  Returns logits at the chunk's
    last token (meaningful on the final chunk) and the extended caches.
    Attention-only stacks only, as in the JAX package."""
    C = tokens.shape[1]
    positions = history + torch.arange(C, device=tokens.device)
    x = _embed_tokens(cfg, params, tokens, positions)
    ctx = {"mode": "full", "positions": positions, "update_cache": True,
           "t": history, "window": _window(cfg, long_context),
           "history": history}
    x, _ = apply_stack(cfg, _segs(cfg), params["segments"], x,
                       state["layers"], ctx)
    x = rms_norm(x[:, -1], params["final_norm"], cfg.rms_norm_eps)
    return _head(cfg, params, x), state


def decode_step(cfg: ModelConfig, params, tokens: torch.Tensor, state,
                t: torch.Tensor, long_context: bool = False,
                paged: Optional[PagedDecode] = None
                ) -> Tuple[torch.Tensor, Any]:
    """One decode step: tokens (B, 1) at clock t (scalar or (B,)) ->
    (logits (B, V), state).  With ``paged`` the batch is compacted and
    attention reads K/V through block tables."""
    t = torch.as_tensor(t, device=tokens.device)
    pos = (t + torch.arange(1, device=t.device) if t.dim() == 0
           else t[:, None] + torch.arange(1, device=t.device)[None])
    x = _embed_tokens(cfg, params, tokens, pos)
    ctx = {"mode": "decode", "positions": pos, "update_cache": True, "t": t,
           "window": _window(cfg, long_context), "paged": paged}
    if cfg.is_encoder_decoder:
        ctx["enc_out"] = state["enc_out"]
    x, _ = apply_stack(cfg, _segs(cfg), params["segments"], x,
                       state["layers"], ctx)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _head(cfg, params, x)[:, 0], state


def decode_step_paged(cfg: ModelConfig, params, tokens: torch.Tensor, state,
                      t: torch.Tensor, slots: torch.Tensor,
                      tables: torch.Tensor, block_lines: int,
                      long_context: bool = False
                      ) -> Tuple[torch.Tensor, Any]:
    """One *compacted, paged* decode step: ``tokens`` (Bc, 1) / ``t`` (Bc,)
    cover only the active primary slots; ``slots`` (Bc,) names each row's
    slot in the full cache, ``tables`` (Bc, max_blocks) its physical line
    blocks in the pool view."""
    return decode_step(cfg, params, tokens, state, t,
                       long_context=long_context,
                       paged=PagedDecode(slots, tables, block_lines))


def decode_multi(cfg: ModelConfig, params, tokens: torch.Tensor, state,
                 t: torch.Tensor, slots: torch.Tensor, tables: torch.Tensor,
                 budget: torch.Tensor, *, steps: int, block_lines: int,
                 temperature: float = 0.0,
                 noise: Optional[torch.Tensor] = None, eos_token: int = -1,
                 long_context: bool = False
                 ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Fused multi-step paged decode: ``steps`` iterations of
    :func:`decode_iteration` with on-device sampling and EOS / budget
    masks kept on the device, so the loop never waits on the host.

    Per row: ``budget`` is the remaining ``max_new_tokens``; a row goes
    dead once it has emitted its budget or sampled ``eos_token`` (-1 = no
    EOS).  Dead rows freeze: their clock stops, their (frozen) token
    re-writes the same reserved cache line, and their trace repeats the
    last token; the host reads only the first ``emitted[i]`` entries.
    ``noise`` (steps, num_slots + 1, V) is the per-iteration Gumbel noise
    for temperature > 0, indexed by slot.

    Returns ``(tokens_all (steps, Bc), state, emitted (Bc,))``."""
    toks, tt = tokens, t
    Bc = tokens.shape[0]
    alive = torch.ones((Bc,), dtype=torch.bool, device=tokens.device)
    emitted = torch.zeros((Bc,), dtype=torch.int32, device=tokens.device)
    outs = []
    for i in range(steps):
        nxt, tt, alive, emitted = decode_iteration(
            cfg, params, toks, state, tt, alive, emitted, budget, slots,
            tables, block_lines=block_lines, temperature=temperature,
            noise=None if noise is None else noise[i], eos_token=eos_token,
            long_context=long_context)
        toks = nxt[:, None]
        outs.append(nxt)
    return torch.stack(outs), state, emitted


def decode_iteration(cfg: ModelConfig, params, tokens: torch.Tensor, state,
                     t: torch.Tensor, alive: torch.Tensor,
                     emitted: torch.Tensor, budget: torch.Tensor,
                     slots: torch.Tensor, tables: torch.Tensor, *,
                     block_lines: int, temperature: float = 0.0,
                     noise: Optional[torch.Tensor] = None,
                     eos_token: int = -1, long_context: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """One iteration of :func:`decode_multi`: a paged decode step of the
    rows ``tokens`` (Bc, 1) at clocks ``t`` (:func:`decode_step_paged`),
    sampled (``noise`` (num_slots + 1, V) at temperature > 0), then the
    masks.  Returns the next ``(tokens (Bc,), t, alive, emitted)``; an
    engine's CUDA graph captures exactly this
    (``repro_torch.serving.decode_graph``)."""
    from repro_torch.serving.sampling import sample_slots  # import cycle
    logits, state = decode_step_paged(cfg, params, tokens, state, t, slots,
                                      tables, block_lines,
                                      long_context=long_context)
    nxt = sample_slots(logits, slots, temperature, noise)
    nxt = torch.where(alive, nxt, tokens[:, 0])
    emitted = emitted + alive.to(torch.int32)
    t = t + alive.to(t.dtype)
    alive = alive & (nxt != eos_token) & (emitted < budget)
    return nxt, t, alive, emitted


def _window(cfg: ModelConfig, long_context: bool) -> Optional[int]:
    """The attention window of a serving step: the config's sliding window,
    or under the long-context policy the ring's (none for the hybrid
    stack, which keeps full KV)."""
    if long_context:
        if cfg.family == "hybrid":
            return None
        return cfg.sliding_window or cfg.long_context_window
    return cfg.sliding_window
