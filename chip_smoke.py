#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and the CUDA toolkit (``nvcc``), builds the
port's kernels from ``src/repro_torch/csrc``, and runs thirty-three phases,
each of which exits non-zero on failure:

1. build — compile every kernel (one ``nvcc`` per source, in parallel);
2. kernels — each CUDA kernel against its plain PyTorch version at the
   main paths' shapes plus a ragged shape, and timed beside its plain
   version, its roofline bound and, where one PyTorch call computes the
   same function, that call: prefill attention (tile edges, a chunk
   resume with q_offset) and paged decode attention in bf16 (tolerance
   2e-2 max abs) and f32 (1e-4), the latter at B 1 and larger, G 12, 4,
   1 and 20, 16- and 32-line blocks, lengths 0 and on each side of a
   span edge, and bad tables; dense decode attention at Jamba's heads
   in bf16 and f32 likewise, with lengths on each side of a split
   boundary; the selective scan in f32 (1e-4 relative) at d_in 16384
   for S = 512, a ragged S = 300 and S = 1, at a ragged C with N 8 and
   16 at B 2, and S = 0 (h_final equals h0); its bound counts its
   exponentials at the SFU rate; prefill and paged decode attention are
   also checked and timed at minicpm-2b's served shape (36/36 heads, hd
   64: G = 1) and at a tp 2 rank's of starcoder2-3b (12/1 heads, phase
   28's shape); the prefill kernel non-causal at seamless-m4t's encoder
   shape (1 x 4096 x 4096, 16/16 heads, hd 64) and at ragged Sq != Skv
   (bf16 held to 0.05 x the RMS of the plain output as well: every row
   averages all Skv keys, so outputs are ~sqrt(e / Skv) and 2e-2 alone
   would pass a dropped key tile), causal at internvl2-1b's 256 patches + 300 tokens (14/2 heads: G = 7),
   and dense decode at hd 64 with G = 1 (W 512) and G = 7 (W 1024), lengths
   on each side of a split boundary, each checked as above and the main
   ones timed; and at phase 30's shapes (minicpm-2b, 36/36 heads, hd 64):
   the prefill kernel under an 8,192-token window over 12,288 rows
   (every row checked, in twelve 1,024-row blocks at their q_offset;
   timed at B 2, its plain version over twelve row blocks, SDPA with the
   window's mask) and dense decode over an 8,192-line ring, both held in
   bf16 row by row to 1e-2 x the row's max |expected| (f32 plain version
   on the same values) and in f32 to 1e-4; and at phase 31's tp 2
   per-rank shapes, held the same way and timed: the scan at 8,192
   channels (S 256 and a ragged 131), dense decode at 32/4 (hd 128), 8/8
   and 7/1 heads (hd 64), the prefill kernel causal at 32/4 and 7/1
   (256 patches + 256 tokens) and non-causal at seamless' encoder's 8/8
   over 4096 frames; and at phase 31's tp 2
   per-rank shapes, held the same way and timed: the scan at 8,192
   channels (S 256 and a ragged 131), dense decode at 32/4 (hd 128), 8/8
   and 7/1 heads (hd 64), the prefill kernel causal at 32/4 and 7/1
   (256 patches + 256 tokens) and non-causal at seamless' encoder's 8/8
   over 4096 frames;
3. serve — full-width starcoder2-3b in bf16 (random weights from a seed)
   behind one ``InstanceEngine``: six greedy requests admitted by
   ``prefill_batch`` and decoded by ``decode_multi(steps=8)``; every
   request must finish, every logit be finite, the prefill and paged
   decode kernels must have launched and no plain version run;
4. consistency — in f32 at full width, decode logits through the paged
   kernel against a fresh prefill (through the prefill kernel) over the
   prompt plus the generated tokens, within 1e-3 * max|logit|;
5. redundancy — a replica on a second engine follows a request by mirror
   syncs, then takes over by promotion; its tokens must equal a run with
   no handoff;
6. cluster — full-width starcoder2-3b in bf16 served by ``api.serve``
   through a two-instance AcceLLM ``LiveCluster`` (8 slots each, a
   1024-line window, fused decode up to 8 steps) on ~12 requests of the
   paper's Table 2 "light" traffic (Poisson, rate 0.1 per iteration);
   every request must finish with all its tokens, every logit be finite,
   mirror syncs and a rebalance or promotion must happen, the mirror and
   stream bytes must equal ``LineCosts`` over the lines each engine's
   ledger moved, and the prefill and paged kernels must have launched with
   no plain version run.  Prints the report, wall ms per iteration (the
   run timed apart from the weights' draw: sim-calibration reads it),
   ``sched_us_per_iter`` and the card's busy share over the serve's first
   30 scheduling steps (profiled in a rerun of them);
7. cluster-chunked — the same model's first ``CHUNKED_LAYERS`` (6) of 30
   layers and the same traffic shape, ~6 requests, under sarathi with
   128-token chunks: chunks must resume past their prompt's start and the
   prefill kernel must launch at ``q_offset > 0``;
8. cluster-fleet — first the cluster phase's profiled rerun of its first
   30 scheduling steps on the whole depth, whose tokens so far must equal
   the serve's, and the near-tie limit on each request's first token;
   then the cluster phase's stream
   on the weights' first ``FLEET_LAYERS`` (6) of 30 layers once with no
   kill (the kill runs' token reference) and with instance 1 killed at
   iteration 60 and rejoined at 90, under accellm and under vllm, each
   beside a CPU rehearsal at reduced width cut to ``REHEARSAL_LAYERS`` (1)
   layer (the depth cuts bound the phase's time):
   fleet stats, fleet trace, plan trace and iterations must equal the
   rehearsal's; accellm must absorb the kill by promotions (no re-queue,
   no re-prefilled token) and warm the rejoin, vllm must re-queue and
   re-prefill (the prefill kernel launching once per layer per prefill
   plan); every request's tokens must equal the cluster serve's (the
   rerun) or the 6-layer no-kill run's (kill runs), unless the two tokens' f32
   logits lie within the bf16 error measured on that row (printed); wall
   ms per iteration beside TTFT/TBT/JCT;
9. cluster-prefix — the cluster phase's arrival and length processes
   over 60 iterations (12 requests) with shared prompt heads (two system
   prompts, 80% reuse, 256-token heads) served on its weights' first
   ``PREFIX_LAYERS`` (6) of 30 layers with the prefix cache off and on,
   beside
   a CPU rehearsal at reduced width: every request must finish with all
   its tokens; the cache-on serve must hit, with the rehearsal's hits,
   hit tokens, iterations and kernel and plan traces, and the cache-off
   serve must not; the prefill kernel must launch at ``q_offset > 0`` at
   least once per layer per hit; stream bytes with the cache must not
   exceed those without, and mirror and stream bytes must equal
   ``LineCosts`` over the lines moved (adopted head lines excluded); a
   ledger must save blocks by sharing, hold only cached blocks after the
   drain and be whole after ``release_all``; tokens must equal the
   cache-off serve's up to near-ties by phase 8's rule; in f32 a hit's
   suffix prefill over the gathered head must match a whole-prompt
   prefill within 1e-3 * max|logit|.  Prints TTFT/TBT/JCT, prefill tokens
   computed, wall ms per iteration and ``sched_us_per_iter`` of both
   serves, and each hit's ``copy_prefix`` bytes with the first one's
   device time (torch.profiler);
10. cluster-consistency — in f32 at full width, T=0: a 500-token prompt's
   final chunk (sarathi, 128-token chunks) against the whole-prompt
   prefill within 1e-3 * max|logit|, and six prompts through the accellm
   cluster against one engine: equal tokens, unless the engine's top-2
   logit gap at the differing step is under 1e-4 * max|logit| (printed);
11. serve-minicpm — minicpm-2b at full width in bf16 (MHA at head dim
    64, tied embeddings, residual and logit scales; ~5.4 GB): the serve
    phase's six requests, the prefill and paged kernels only at 36/36
    heads, hd 64, no plain call; its f32 decode-vs-prefill check as in
    phase 4;
12. sim-calibration — on the host: the port's simulator on the cluster
    phase's stream with one modeled H100 per instance, its decode
    dispatch set to the serve phase's decode ms per step at 8 active and
    to 0; modeled TTFT/TBT/JCT beside the measured ones of phase 6's
    serve;
13. scale — on the host: the port's simulator on the bursty llama2-70b
    stream (4 instances, 500 s) under accellm and ulb and their ``-vec``
    twins (the array-backed cluster state), and on phase 9's stream with
    the prefix cache under accellm and accellm-vec: equal decision traces
    and request outcomes; ``sched_us_per_iter`` of each;
14. serve-hybrid — Jamba-1.5-Large at full width, depth cut to its first
    5 layers (4 mamba, MoE on 1 and 3, attention at 4; ~48 GB in bf16):
    six greedy requests (prompts 100 to 1000, 32 tokens each) through
    ``prefill_batch`` (one prompt at a time) and ``decode_multi(steps=8)``
    (dense decode over all 8 slots); every request must finish, every
    logit be finite, the scan, prefill and dense decode kernels must have
    launched and no plain version run; decode ms per step and a profiled
    breakdown;
15. redundancy-hybrid — mirror syncs of one KV line plus the whole
    recurrent state each, then promotion; tokens equal a control run;
16. consistency-hybrid — in f32 on Jamba's first 3 layers (mamba; mamba +
    MoE; mamba) with capacity factor 8: decode logits after 1, 8 and 16
    steps against a fresh prefill within 1e-3 * max|logit|, and each
    mamba layer's ssm state within 1e-4 relative;
17. serve-deepseek — deepseek-v3-671b at its published widths, depth cut
    to layers 0-3 (three dense layers, the first MoE layer: 256 experts
    top-8 and a shared one) with the MTP head's weights (~30.9 GB in
    bf16): the serve phase's six requests behind one 8-slot engine with a
    1024-line window (bucketed prefill, dense absorbed-latent decode);
    decode ms per step at 1, 4 and 8 active, prefill tokens/s and a
    profiled decode plan.  MLA computes outside every kernel, as in the
    JAX package: no kernel may launch and no plain version run;
18. cluster-deepseek — the same weights through ``api.serve`` with the
    cluster phase's spec and stream, its lengths scaled by
    ``DEEPSEEK_CLUSTER_SCALE`` (0.3), MoE dispatch dropless (capacity
    factor 32): every request must finish, mirror syncs and a promotion
    must happen, mirror and stream bytes must equal ``LineCosts`` over
    the lines moved (4 x 1,152 B a line), tokens must equal one 8-slot
    engine's on the same requests up to near-ties (phase 8's rule, the
    f32 rows in 128-token chunks on an f32 redraw); then sarathi with
    128-token chunks over 60 iterations: chunks must resume and the MLA
    layer expand cached latent rows (history > 0); no kernel launched;
19. consistency-deepseek — in f32 at full width on one dense and one MoE
    layer, dropless (~57 GB): absorbed decode after 1, 8 and 16 steps
    against a fresh materialized prefill, and a prompt's final chunk (at
    history 128) against the whole prompt, within 1e-3 * max|logit|;
20. serve-xlstm — xlstm-1.3b at full width and depth (48 blocks, 42 mLSTM
    and 6 sLSTM) in bf16 through three of the serve phase's six requests
    (``XLSTM_PROMPTS``: 128, 200 and 256 tokens; one prompt at a time,
    dense decode; no kernel launched; its decode timings after
    ``XLSTM_TIMING_PROMPT`` (16) tokens), then in f32 on
    its first ``XLSTM_F32_LAYERS`` (8) blocks (one period of the pattern:
    7 mLSTM and the sLSTM, drawn in f32; the depth cut bounds the phase's
    time) 16 decode steps against fresh prefills within 1e-3 *
    max|logit| (a 200-token prompt: the stepwise mLSTM), and the
    chunkwise mLSTM against the stepwise one on a 256-token prompt
    (printed);
21. serve-seamless — seamless-m4t-large-v2 whole at full width in bf16
    (a 24-layer encoder over 4096 frames, a 24-layer decoder with cross
    attention; ~3.7 GB): the serve phase's six requests, each with its
    frames from ``default_extras``, prefilled one prompt at a time into a
    scratch of the whole window and decoded dense; every request must
    finish, every logit be finite, the prefill kernel launch non-causal
    (encoder) and causal (decoder) and the dense decode kernel launch, all
    at 16/16 heads, hd 64, with no plain version run.  Prints encoder ms
    per request, prefill ms per request, decode ms per step at 1, 4 and 8
    active, a profiled decode plan and the cross attention's share of a
    step; then in f32, decode logits after 1, 8 and 16 steps against a
    fresh prefill within 1e-3 * max|logit|;
22. cluster-seamless — those weights through ``api.serve`` with the
    cluster phase's spec and arrivals under accellm, lengths scaled by 0.2
    (8 requests, ~140 iterations): every request must
    finish, mirror syncs and a promotion or rebalance happen, the stream
    bytes equal ``LineCosts`` over the lines moved plus the 411,041,792 B
    of static state (encoder memory and cross K/V) per streamed request,
    the mirror bytes only KV lines, and the tokens equal one 8-slot
    engine's on the same requests up to near-ties (phase 8's rule, each
    row replayed on the engine's clock);
23. serve-internvl — internvl2-1b whole at full width in bf16 (~1 GB)
    with 256-patch payloads: the serve phase's six requests through one
    engine, then the cluster stream through ``api.serve`` under accellm,
    with the checks of phases 21-22 (the prefill kernel causal only, both
    kernels at 14/2 heads: G = 7, hd 64; no static byte); then in f32 the
    model's decode at t = P + S against a fresh prefill, and printed, not
    gated, the same step at t = S: the clock the engine keeps, as the JAX
    package's engine does;
24. train-minicpm — minicpm-2b whole in bf16 with f32 AdamW moments: 20
    WSD steps of 8 x 128 tokens from ``batches(DataConfig(seed=0))``
    through ``launch/train.py``'s loop; step 1's gradient must be finite
    on every leaf and nonzero on every attention and MLP leaf, the loss
    finite and lower at the last step than at the first, and no kernel
    nor plain version may run (training takes the model-level chunked
    attention).  Prints ms per step (forward+backward and optimizer
    apart), tokens/s and peak memory beside the card;
25. train-restore-serve — those trained params saved with
    ``training/checkpoint.py`` under ``build/`` and restored into a fresh
    tree, which must equal them bitwise; the serve phase's six requests
    through one engine on the restored params must launch the prefill
    and paged kernels, run no plain version, and give the tokens of the
    trained params served from memory;
26. train-grad-check — minicpm-2b at full width cut to 2 layers in f32,
    batch 2 x 128: one ``loss_fn`` gradient on the card against the same
    on the CPU, every leaf within 1e-4 x its max |grad|;
27. train-families — two bf16 WSD steps each of xlstm-1.3b whole,
    seamless-m4t-large-v2 whole (32 frames), internvl2-1b whole (256
    patches) and deepseek-v3-671b cut to its three dense MLA layers (bf16
    moments; its ``mtp`` leaves' grads must be exactly 0, as the loss
    never reads them): finite losses and grads, every mixer's input
    projection with a nonzero grad, no kernel run; peak memory of each;
28. mesh-engine — full-width starcoder2-3b in bf16 on the serve phase's
    weights, as one engine at tensor-parallel width 2: two processes
    (``repro_torch.meshserve.world.spawn``, torch.multiprocessing spawn)
    on this one card, over gloo, which stages every CUDA collective
    through the host, so this checks the sharded compute and the kernels
    at per-rank heads (12/1, hd 128), not a card-to-card wire.  The serve
    phase's six requests: both ranks launch the prefill and paged decode
    kernels with no plain version, each rank's K/V pool is half of tp 1's,
    the tokens equal the serve phase's up to near-ties measured and
    printed by phase 8's rule; in f32 at 2 layers, the sharded prefill and
    8 paged decode steps within 1e-3 * max|logit| of the whole model's;
    decode ms per step at 8 active beside the serve phase's tp 1.  Then
    with ``REPRO_SEQ_PARALLEL=1`` set in each rank (sequence parallelism:
    the residual cut over the two ranks, a reduce-scatter and an
    all-gather at each module boundary): the same six requests, whose
    tokens must equal the flag-off ones up to near-ties judged on the
    same f32 replay, through the prefill and paged kernels with no plain
    version (the flash launches printed); the f32 prefill of the
    200-token prompt within 1e-6 * max|logit| of the flag-off one and,
    against the whole model's, within the flag-off prefill's own
    distance from it plus 1e-6 * max|logit|; its collectives by kind:
    reduce-scatters and all-gathers over "model" where the flag-off
    prefill has all-reduces;
29. mesh-cluster — the cluster phase's spec on a 6-request Table 2
    "light" stream (lengths x 0.2) with ``mesh_tp=1`` over the same
    two-process world (two instances, one rank each), beside the same
    stream through a one-process cluster: every request finishes, mirror
    syncs happen, every cross-slice hop is counted as a host copy (gloo
    stages CUDA broadcasts through the host) and none as device-to-device,
    mirror and stream bytes equal ``LineCosts`` over the ledger's lines,
    both ranks hold the same decision trace, stats and tokens, and
    the stats, trace and iterations equal the one-process cluster's; the
    prefill and paged kernels launch on both ranks.  The parent frees its
    weights before each world starts, and the kernels the children load
    are the ones phase 1 built;
30. long-context — run right after phase 11 on its weights: the
    long-context policy (``long_context=True``) on full-width minicpm-2b in
    bf16: ``init_state(cfg, 2, 524_288)`` (a ring of 8,192 lines; the
    bytes the card allocates must equal the dry run's meta build of the
    same call, 6,039,797,760 B), two 12,288-token prompts prefilled through
    the prefill kernel under the 8,192-token window, then 64 greedy decode
    steps through the dense decode kernel over the full ring, past its
    wrap: both kernels launch once per layer per call, no plain version
    and no paged kernel; ``sample`` at T = 0 equals argmax and at T = 1
    with top_k 40 draws inside each row's top 40; then in f32 on 2 layers
    the decode logits at t = 12,288 + j (j = 0, 31, 63) against a fresh
    long-context prefill over the 12,288 + j + 1 tokens within 1e-3 *
    max|logit|.  Prints decode ms per step beside phase 11's and the dry
    run's long_500k record for minicpm-2b on the single mesh;
31. mesh-families — seamless-m4t-large-v2 and internvl2-1b whole,
    xlstm-1.3b on its first 8 blocks (one period of its pattern: over all
    48 random-weight blocks a bf16 row lies ~100% of max|logit| from its
    f32 replay, which leaves no token to judge), deepseek-v3-671b cut to
    layers 0-3 (MLA, three dense layers,
    the 256-expert MoE layer and its shared expert) and Jamba-1.5-Large
    in the reduced config's layout at published widths (Mamba + dense
    FFN, attention + MoE), in bf16, each as one engine at tp 2 on a world
    of two processes on card 0 over gloo, one family after another.  The
    ranks draw the whole weights in turn (a barrier between them), build
    their engine, which keeps only the rank's cut, and free the whole
    tree before the other draws; rank 0 first serves the same weights on
    one device.  Six greedy requests (prompts 128-256, 16 tokens, each
    with its payload): the tp 2 tokens equal one device's on both ranks
    up to near-ties by phase 8's rule, read on an f32 replay (rank 0 feeds
    the one-device tokens to the same weights upcast to f32: every row
    the engines sampled gets its f32 twin): where a request's tp 2 token
    first parts from one device's, the two tokens' f32 gap is within
    twice that row's one-device max |bf16 - f32|, and that limit does not
    span any replayed row; over the rows sampled on a common prefix, max
    |tp 1 - tp 2| / max|f32| is within twice the family's one-device max
    |bf16 - f32| / max|f32|; MoE dispatch dropless (capacity factor experts / top-k),
    0 assignments dropped on either side; the scan, prefill and dense
    decode kernels launch on both ranks with no plain version (MLA and
    xLSTM reach none); then two layers of each family in f32 (the MoE
    layers with fewer experts at their widths: deepseek 16, Jamba 4;
    xlstm-1.3b an mLSTM and the sLSTM), prefill and 8 decode steps
    within 1e-3 * max|logit| of one device's.
    Prints weight and state bytes a rank against one device's, decode ms
    per step at tp 1 and tp 2, ``sharding.reduce``/``gather`` calls per
    decode step and the launch counts;
32. mesh-cluster-hybrid — Jamba in that layout (capacity factor 1.25)
    behind two one-rank slices on the same two processes, on phase 29's
    stream: the hybrid stack's recurrent-state mirror across slices;
    every hop a host copy, mirror and stream bytes equal ``LineCosts``,
    the scan, prefill and dense decode kernels launch on both ranks, and
    stats, decision trace, iterations and tokens equal a one-process
    cluster's;
33. train-mesh — minicpm-2b at published widths cut to
    ``TRAIN_MESH_LAYERS`` (4) of 40 layers, in f32: three AdamW steps of
    the sharded train step (TP on "model", FSDP on "data") on the
    training data pipeline (``training.batches``), on a (data 2, model 2) world of four processes on
    card 0 over gloo, against one process's f32 steps on the same
    weights and batches: every step's loss within 1e-4, each leaf of
    every rank's part of the params after the steps within 1e-4 of the
    whole leaf's max|.|, each rank's param and moment bytes below one
    process's; no kernel runs.  Then the same three steps from the same
    weights in the same world with ``REPRO_SEQ_PARALLEL=1``: losses
    within 1e-5 of the flag-off ones, every leaf as above.  Prints
    seconds per step, each rank's peak memory
    (``torch.cuda.max_memory_allocated``) with and without the flag and
    the collectives a step makes by kind and axis;
34. mesh-partial — internvl2-1b whole at published widths in bf16, one
    engine at tp 4 on a world of four processes on card 0 over gloo: its
    14 query heads do not divide 4, so every rank computes the whole
    attention (the prefill and dense decode kernels at 14/2 heads, hd
    64) and a quarter of the FFN (1,216 of d_ff 4,864), its vocab of
    151,655 whole (odd).  Phase 31's checks (tokens against one process
    up to near-ties on the f32 replay, f32 logits at two layers within
    1e-3 * max|logit|, kernels launched with no plain version), the
    kernels' heads, and each rank's weight bytes equal to the rule
    table's parts and below one process's.  Prints decode ms per step at
    tp 4 beside tp 1, ``sharding.reduce``/``gather`` calls per step and
    the launch counts.

Each phase group's weights are freed before the next: starcoder2's after
phases 3-5, 6-9 and 10, minicpm-2b's after 11 and 30, the bf16 Jamba weights
before the f32 ones, deepseek's bf16 weights before its f32 ones,
xlstm-1.3b's bf16 weights before its f32 ones, seamless-m4t's after 22,
internvl2-1b's after 23, the trained minicpm-2b's after 25 and each
family's after its steps; the mesh phases' ranks hold their own.  TF32 is
off for matmuls and cuDNN.  ``python3 chip_smoke.py --mesh-only`` runs
phase 1, the serve phase's six requests, phases 28-29, the kernels at
phase 31's per-rank shapes and phases 31-32 and 34 alone, and prints no
result line.
The last two lines of standard output are the kernel summary and the
device line, each one JSON object.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SFU_OPS_PER_CLOCK_PER_SM = 16  # exp2 and the like, compute capability 9.0
#: the measured and derived numbers of a kernel's record
TIMING_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters, flush=None, spin=True):
    """Mean device ms of ``fn`` over ``iters`` launches, each timed with
    CUDA events after an optional L2 flush (the flush is not timed).  With
    ``spin``, a 0.2 ms spin on the card after the flush keeps it busy while
    the host enqueues the call, so the events time the device's work and
    not the wrapper's Python."""
    import torch
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        if spin:
            torch.cuda._sleep(400_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def _time_flash(torch, flash_mod, randn, flush, B, Sq, Skv, H, KVH, hd,
                window, causal=True, plain_blocks=1):
    """One bf16 prefill-attention instance timed: the kernel, its plain
    version and SDPA, beside its bound (each input read once, the output
    written once; the flops of the (query, key) pairs the mask keeps,
    ``flash_attention_flops``).  With ``plain_blocks`` > 1 the plain
    version runs over that many query-row blocks, each at its q_offset
    (its whole score tensor would not fit); where the window hides keys
    SDPA takes a boolean mask on its memory-efficient kernel (None where
    it refuses)."""
    q, k, v = (randn((B, Sq, H, hd), torch.bfloat16),
               randn((B, Skv, KVH, hd), torch.bfloat16),
               randn((B, Skv, KVH, hd), torch.bfloat16))
    kw = dict(causal=causal, window=window)
    ms = time_ms(lambda: flash_mod.flash_attention_cuda(q, k, v, **kw), 20,
                 flush)
    rows = Sq // plain_blocks

    def plain():
        for r0 in range(0, Sq, rows):
            flash_mod.flash_attention_torch(
                q[:, r0:r0 + rows], k[:, :r0 + rows] if causal else k,
                v[:, :r0 + rows] if causal else v, q_offset=r0, **kw)

    plain_ms = time_ms(plain, 5 if plain_blocks == 1 else 2, flush)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    flops = flash_mod.flash_attention_flops(B, Sq, Skv, H, hd, **kw)
    if flops == flash_mod.flash_attention_flops(B, Sq, Skv, H, hd,
                                                causal=causal):
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), 20, flush)
    else:
        from torch.nn.attention import SDPBackend, sdpa_kernel
        qp = torch.arange(Sq, device=q.device)[:, None]
        kp = torch.arange(Skv, device=q.device)[None]
        mask = (qp - kp < window) & ((qp >= kp) if causal else True)
        try:
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                lib = time_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask, enable_gqa=True), 10,
                    flush)
        except RuntimeError as e:
            log(f"kernels: SDPA refused the windowed mask: {e}")
            lib = None
        del mask
    bound, by = _bound(2 * (2 * B * Sq * H * hd + 2 * B * Skv * KVH * hd),
                       flops, "bfloat16")
    return {"shape": f"q {B}x{Sq}x{H}x{hd}, kv {Skv} x {KVH} heads, "
                     f"{'causal' if causal else 'non-causal'}"
                     + (f", window {window}" if window and window < Skv
                        else "") + ", bf16",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": lib}


def phase_kernels(torch, flash_mod, paged_mod, flush):
    """Kernel vs plain on the card; returns the per-kernel records."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1)
    tol = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # -- prefill attention ---------------------------------------------------
    flash_cases = [  # (B, Sq, Skv, H, KVH, hd, window, q_offset, what)
        (8, 512, 512, 24, 2, 128, 4096, 0, "main path: bucket 512, batch 8"),
        (2, 200, 200, 24, 2, 128, None, 0, "ragged Sq = Skv = 200"),
        (2, 256, 256, 4, 1, 64, 64, 0, "hd 64 (reduced config), window 64"),
        (2, 48, 128, 24, 2, 128, 32, 80,
         "chunk resume: 48 rows at offset 80, 128 keys, window 32"),
        (2, 300, 300, 24, 2, 128, None, 0, "Sq = 300, no multiple of 128"),
        (8, 512, 512, 36, 36, 64, None, 0,
         "minicpm-2b: bucket 512, batch 8, MHA (G 1) at hd 64"),
        (8, 512, 512, 12, 1, 128, 4096, 0,
         "a tp 2 rank of mesh-engine: bucket 512, batch 8, 12/1 heads"),
    ]
    flash_err = 0.0
    for B, Sq, Skv, H, KVH, hd, window, q_offset, what in flash_cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (randn((B, Sq, H, hd), dtype),
                       randn((B, Skv, KVH, hd), dtype),
                       randn((B, Skv, KVH, hd), dtype))
            out = flash_mod.flash_attention_cuda(q, k, v, causal=True,
                                                 window=window,
                                                 q_offset=q_offset)
            exp = flash_mod.flash_attention_torch(q, k, v, causal=True,
                                                  window=window,
                                                  q_offset=q_offset)
            torch.cuda.synchronize()
            err = max_err(out, exp)
            log(f"kernels: flash_attention {what} {str(dtype)[6:]}: "
                f"max_abs_err {err:.3e} (tol {tol[dtype]:.0e})")
            check(err <= tol[dtype], f"flash_attention {what} {dtype}: "
                  f"error {err} above {tol[dtype]}")
            flash_err = max(flash_err, err)

    f_main = _time_flash(torch, flash_mod, randn, flush, 8, 512, 512, 24, 2,
                         128, 4096)
    # minicpm-2b's served prefill: MHA (G = 1) at head dim 64, no window
    f_hd64 = _time_flash(torch, flash_mod, randn, flush, 8, 512, 512, 36, 36,
                         64, None)
    # a rank of starcoder2-3b at tensor-parallel width 2 (mesh-engine)
    f_tp2 = _time_flash(torch, flash_mod, randn, flush, 8, 512, 512, 12, 1,
                        128, 4096)

    # -- paged decode attention ----------------------------------------------
    # (lengths as a function of the case's span of lines per split, H, KVH,
    # hd, block_lines, what); W = 512 lines per table, as on the serve path
    W = 512
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    paged_cases = [
        (lambda s: [116, 144, 216, 272, 400, 512], 24, 2, 128, 16,
         "main path: 6 requests mid-decode"),
        (lambda s: [0, 1, 17, 255, 511, 512], 24, 2, 128, 16,
         "lengths 0, 1 and ragged"),
        (lambda s: [0, 1, 17, 255, 511, 600], 24, 2, 128, 16,
         "out-of-pool entries, length past the table"),
        (lambda s: [3, 40, 129], 4, 1, 64, 16, "hd 64 (reduced config)"),
        (lambda s: [116, 144, 216, 272, 400, 512], 36, 36, 64, 16,
         "minicpm-2b: 6 requests mid-decode, MHA (G 1) at hd 64"),
        (lambda s: [116, 144, 216, 272, 400, 512], 12, 1, 128, 16,
         "a tp 2 rank of mesh-engine: 6 requests, 12/1 heads"),
        (lambda s: [s], 24, 2, 128, 16, "B 1, G 12, length on the span edge"),
        (lambda s: [s + 1], 24, 2, 128, 32,
         "B 1, G 12, 32-line blocks, one past the span edge"),
        (lambda s: [0, 1, s, s + 1, 300, W], 8, 2, 128, 32,
         "G 4, 32-line blocks, span edges"),
        (lambda s: [1, s, s + 1, W], 2, 2, 128, 16, "G 1, span edges"),
        (lambda s: [1, s - 1, s + 1, 300, W, 0], 40, 2, 128, 16,
         "G 20 (two head groups), span edges"),
    ]
    paged_err = 0.0

    def paged_inputs(lengths, H, KVH, hd, bl, dtype):
        mb, nb = W // bl, 8 * (W // bl)
        qq = randn((len(lengths), H, hd), dtype)
        kp, vp = randn((nb, bl, KVH, hd), dtype), randn((nb, bl, KVH, hd), dtype)
        perm = torch.randperm(nb, generator=gen, device=dev)[:len(lengths) * mb]
        tables = perm.reshape(len(lengths), mb).to(torch.int32)
        if max(lengths) > W:  # the shared contract for bad tables
            tables[3, 2], tables[4, 0], tables[5, mb - 1] = -1, nb, nb + 7
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        return qq, kp, vp, tables, lens

    for lengths_of, H_, KVH_, hd_, bl_, what in paged_cases:
        splits, span = paged_mod.split_plan(
            len(lengths_of(0)), KVH_, H_ // KVH_, W, sms,
            paged_mod.PAGED_HEADS_PER_BLOCK)
        lengths = lengths_of(span)
        for dtype in (torch.bfloat16, torch.float32):
            args = paged_inputs(lengths, H_, KVH_, hd_, bl_, dtype)
            out = paged_mod.paged_decode_attention_cuda(*args)
            exp = paged_mod.paged_decode_attention_torch(*args)
            torch.cuda.synchronize()
            err = max_err(out, exp)
            log(f"kernels: paged_decode_attention {what} (lengths {lengths}, "
                f"{splits} splits of {span} lines) {str(dtype)[6:]}: "
                f"max_abs_err {err:.3e} (tol {tol[dtype]:.0e})")
            check(err <= tol[dtype], f"paged_decode_attention {what} "
                  f"{dtype}: error {err} above {tol[dtype]}")
            for b, n in enumerate(lengths):
                if n == 0:
                    check(float(out[b].abs().max()) == 0.0,
                          "paged_decode_attention: a length-0 row must give 0")
            paged_err = max(paged_err, err)

    def time_paged(H, KVH, hd):
        lengths = paged_cases[0][0](0)
        args = paged_inputs(lengths, H, KVH, hd, 16, torch.bfloat16)
        ms = time_ms(lambda: paged_mod.paged_decode_attention_cuda(*args), 50,
                     flush)
        plain = time_ms(lambda: paged_mod.paged_decode_attention_torch(*args),
                        20, flush)
        Bp, mb = len(lengths), W // 16
        nbytes = (2 * (2 * Bp * H * hd)               # q in, out
                  + 2 * 2 * sum(lengths) * KVH * hd   # live K and V lines
                  + 4 * Bp * mb + 4 * Bp)             # tables, lengths
        bound, by = _bound(nbytes, paged_mod.decode_attention_flops(
            H, hd, sum(lengths)), "bfloat16")
        return {"shape": f"{Bp} requests, lengths {lengths}, {H}/{KVH} "
                         f"heads, hd {hd}, bf16, 16-line blocks",
                "ms": ms, "plain_ms": plain, "bound_ms": bound,
                "bound_by": by, "library_ms": None}

    p_main = time_paged(24, 2, 128)
    p_hd64 = time_paged(36, 36, 64)
    p_tp2 = time_paged(12, 1, 128)

    records = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:119",
         "launches": 0, "max_abs_err": flash_err,
         **{k: f_main[k] for k in TIMING_KEYS},
         "instances": {"minicpm-2b hd 64": f_hd64,
                       "starcoder2-3b tp 2 rank": f_tp2}},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:233",
         "launches": 0, "max_abs_err": paged_err,
         **{k: p_main[k] for k in TIMING_KEYS},
         "instances": {"minicpm-2b hd 64": p_hd64,
                       "starcoder2-3b tp 2 rank": p_tp2}},
    ]
    return records


def _wall_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _device_profile(torch, fn):
    """{kernel name: (device ms, launches)} over one call of ``fn``, from
    torch.profiler's CUPTI trace."""
    prof = _profiler()
    torch.cuda.synchronize()
    with prof:
        fn()
        torch.cuda.synchronize()
    return _kernel_times(prof)


def _profiler(cpu=True):
    """A profiler of the card's kernels; ``cpu`` also records the host's
    operators (costly to aggregate over a long run)."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=([ProfilerActivity.CPU] if cpu else [])
                   + [ProfilerActivity.CUDA])


def _kernel_times(prof):
    """{kernel name: (device ms, launches)} of a finished profile."""
    from torch.autograd import DeviceType
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        out[ev.key] = (us / 1e3, ev.count)
    return out


# the port's own kernel functions, listed in a breakdown even below its top
PORT_KERNEL_FUNCTIONS = ("flash_fwd_kernel", "paged_kernel", "split_kernel",
                         "merge_kernel", "mamba_scan_kernel")


def _breakdown(wall_ms, kernels, top=6):
    """Device time and busy share of a run, its ``top`` kernels by device
    time and, below them, any of the port's own kernels."""
    device_ms = sum(ms for ms, _ in kernels.values())
    ranked = sorted(((ms, n, name) for name, (ms, n) in kernels.items()),
                    reverse=True)
    shown = ranked[:top] + [r for r in ranked[top:]
                            if any(f in r[2] for f in PORT_KERNEL_FUNCTIONS)]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms,
            "top": [(name, ms, n) for ms, n, name in shown]}


def _bound(nbytes, flops, dtype_name, sfu_ms=0.0):
    """(least ms, what bounds it): the bytes at the memory rate against the
    operations, the flops at the peak rate of their type or ``sfu_ms`` for
    the work only the special-function units do, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / PEAK_FLOPS[dtype_name] * 1e3, sfu_ms)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sfu_ms(n, sms):
    """Least ms for ``n`` exponentials on the special-function units: 16
    per clock per SM (CUDA C Programming Guide, arithmetic instruction
    throughput, compute capability 9.0) at the card's max SM clock."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    return n / (SFU_OPS_PER_CLOCK_PER_SM * sms * mhz * 1e6) * 1e3


def _time_dense(torch, dense_mod, randn, flush, lengths, W, H, KVH, hd):
    """One bf16 dense-decode instance timed: a row per length over a
    ``W``-line cache; the kernel, its plain version and SDPA with a
    boolean mask, beside its bound (q and out, the live K and V lines and
    the lengths, each moved once)."""
    dev = "cuda"
    B = len(lengths)
    q = randn((B, 1, H, hd), torch.bfloat16)
    kc, vc = (randn((B, W, KVH, hd), torch.bfloat16) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    ms = time_ms(lambda: dense_mod.decode_attention_cuda(q, kc, vc, lens),
                 50, flush)
    plain = time_ms(lambda: dense_mod.decode_attention_torch(q, kc, vc, lens),
                    20, flush)
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    mask = (torch.arange(W, device=dev)[None] < lens[:, None])[:, None, None]
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), 50, flush)
    nbytes = (2 * (2 * B * H * hd)                # q in, out
              + 2 * 2 * sum(lengths) * KVH * hd   # live K and V lines
              + 4 * B)                            # lengths
    bound, by = _bound(nbytes, dense_mod.decode_attention_flops(
        H, hd, sum(lengths)), "bfloat16")
    return {"shape": f"{B} rows, lengths {lengths}, W {W}, {H}/{KVH} heads, "
                     f"hd {hd}, bf16",
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": lib}


def phase_hybrid_kernels(torch, dense_mod, scan_mod, flush):
    """The hybrid path's two kernels against their plain versions on the
    card; returns their records."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(2)
    tol = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # -- selective scan (f32): Jamba's d_in 16384, d_state 16 ----------------
    def scan_inputs(B, S, C, N):
        return (randn((B, S, C)),
                torch.nn.functional.softplus(randn((B, S, C)) - 1.0),
                randn((B, S, N)), randn((B, S, N)),
                -torch.exp(randn((C, N)) * 0.5), randn((C,)),
                randn((B, C, N)) * 0.1)

    scan_err = 0.0
    for B, S, C, N, what in (
            (1, 512, 16384, 16, "main path: 512-token prompt"),
            (1, 300, 16384, 16, "ragged S = 300"),
            (2, 1, 16384, 16, "S = 1, B 2"),
            (2, 300, 1000, 16, "ragged C = 1000, B 2"),
            (2, 512, 1003, 8, "N 8, C = 1003 (4-byte copies), B 2")):
        args = scan_inputs(B, S, C, N)
        y, h = scan_mod.mamba_scan_cuda(*args)
        y_p, h_p = scan_mod.mamba_scan_torch(*args)
        torch.cuda.synchronize()
        for name, a, b in (("y", y, y_p), ("h_final", h, h_p)):
            err = max_err(a, b)
            rel = err / float(b.abs().max())
            log(f"kernels: mamba_scan {what} {name}: max_abs_err {err:.3e}, "
                f"relative {rel:.3e} (tol 1e-4 relative)")
            check(rel <= 1e-4, f"mamba_scan {what} {name}: relative error "
                  f"{rel} above 1e-4")
            scan_err = max(scan_err, err)
    args = scan_inputs(2, 0, 1000, 16)
    y, h = scan_mod.mamba_scan_cuda(*args)
    torch.cuda.synchronize()
    check(tuple(y.shape) == (2, 0, 1000) and torch.equal(h, args[-1]),
          "mamba_scan S = 0: y must be empty and h_final equal h0")
    log("kernels: mamba_scan S = 0, C = 1000, B 2: y empty, h_final == h0")
    B, S, C, N = 1, 512, 16384, 16
    args = scan_inputs(B, S, C, N)
    s_ms = time_ms(lambda: scan_mod.mamba_scan_cuda(*args), 50, flush)
    s_plain = time_ms(lambda: scan_mod.mamba_scan_torch(*args), 3, flush)
    s_bytes = 4 * (3 * B * S * C + 2 * B * S * N + C * N + C + 2 * B * C * N)
    s_flops = scan_mod.mamba_scan_flops(B, S, C, N)
    s_exps = B * S * C * N                   # one exp per state update
    s_bound, s_by = _bound(s_bytes, s_flops, "float32",
                           _sfu_ms(s_exps, sms))

    # -- dense decode attention: Jamba's 64/8 heads, hd 128, 1024 lines ------
    W, H, KVH, hd = 1024, 64, 8, 128
    splits, chunk = dense_mod.split_plan(8, KVH, H // KVH, W, sms)
    dense_cases = [  # (lengths, what)
        ([116, 272, 316, 528, 716, 1016, 1, 1],
         "main path: 6 requests mid-decode, 2 idle slots"),
        ([0, 1, 63, 65, 255, 513, 1000, 1024],
         "ragged lengths, one empty row, one full row"),
        ([0, 1, chunk - 1, chunk, chunk + 1, 2 * chunk + 1, W - 1, W],
         f"one off each side of the {chunk}-line split boundary"),
    ]
    log(f"kernels: decode_attention at 8 rows, {KVH} KV heads, W {W}: "
        f"{splits} splits of {chunk} lines, {8 * KVH * splits} split blocks "
        f"on {sms} SMs")
    check(8 * KVH * splits >= 2 * sms, "decode_attention: fewer than two "
          "split blocks per SM at the timed shape")

    def dense_inputs(lengths, dtype):
        Bd = len(lengths)
        return (randn((Bd, 1, H, hd), dtype), randn((Bd, W, KVH, hd), dtype),
                randn((Bd, W, KVH, hd), dtype),
                torch.tensor(lengths, dtype=torch.int32, device=dev))

    dense_err = 0.0
    for lengths, what in dense_cases:
        for dtype in (torch.bfloat16, torch.float32):
            dargs = dense_inputs(lengths, dtype)
            out = dense_mod.decode_attention_cuda(*dargs)
            exp = dense_mod.decode_attention_torch(*dargs)
            torch.cuda.synchronize()
            err = max_err(out, exp)
            log(f"kernels: decode_attention {what} {str(dtype)[6:]}: "
                f"max_abs_err {err:.3e} (tol {tol[dtype]:.0e})")
            check(err <= tol[dtype], f"decode_attention {what} {dtype}: "
                  f"error {err} above {tol[dtype]}")
            if lengths[0] == 0:
                check(float(out[0].abs().max()) == 0.0,
                      "decode_attention: a length-0 row must give 0")
            dense_err = max(dense_err, err)
    lengths = dense_cases[0][0]
    d_main = _time_dense(torch, dense_mod, randn, flush, lengths, W, H, KVH,
                         hd)

    records = [
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:120",
         "launches": 0, "max_abs_err": dense_err,
         **{k: d_main[k] for k in TIMING_KEYS}, "instances": {}},
        {"name": "mamba_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/mamba_scan.cu",
         "replaces": "src/repro/kernels/mamba_scan.py:84",
         "launches": 0, "max_abs_err": scan_err, "ms": s_ms,
         "plain_ms": s_plain, "bound_ms": s_bound, "bound_by": s_by,
         "library_ms": None, "instances": {}},
    ]
    log(f"kernels: mamba_scan timed at B 1, S 512, C 16384, N 16: "
        f"{s_bytes / 1e6:.1f} MB ({_bound(s_bytes, 0, 'float32')[0]:.4f} ms), "
        f"{s_flops:.3e} flops ({_bound(0, s_flops, 'float32')[0]:.4f} ms), "
        f"{s_exps:.3e} exps ({_sfu_ms(s_exps, sms):.4f} ms on the SFUs); "
        f"decode_attention at lengths {lengths}, W {W}")
    return records


def _log_records(records, lib_name):
    for r in records:
        for what, t in [("", r)] + [(f" at {k}", v) for k, v in
                                    r.get("instances", {}).items()]:
            lib = ("none" if t["library_ms"] is None
                   else f"{t['library_ms']:.4f} ms ({lib_name})")
            log(f"kernels: {r['name']}{what}: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}), library {lib}"
                + (f"; {t['shape']}" if what else ""))


def _watch_logits(torch, sampling_mod, engine_mod):
    """Patch the engine's sampler to record whether every logit it sees is
    finite; returns (flags, restore).  A decode graph captures the sampler
    and replays it without calling Python, so the flag of a device is one
    tensor that every call, captured ones included, ands in place; the
    first call is eager (a key's first iteration runs before its
    capture)."""
    finite = []
    plain_sample = sampling_mod.sample_slots

    def watched_sample(logits, *a, **kw):
        flag = next((f for f in finite if f.device == logits.device), None)
        if flag is None:
            flag = torch.ones((), dtype=torch.bool, device=logits.device)
            finite.append(flag)
        flag.logical_and_(torch.isfinite(logits).all())
        return plain_sample(logits, *a, **kw)

    def restore():
        sampling_mod.sample_slots = plain_sample
        engine_mod.sample_slots = plain_sample

    sampling_mod.sample_slots = watched_sample
    engine_mod.sample_slots = watched_sample
    return finite, restore


def _print_breakdown(breakdown, phase):
    for what, b in breakdown.items():
        if b["device_ms"] == 0:
            log(f"{phase}: {what}: profiler saw no device time; device busy "
                f"share not measured")
            continue
        log(f"{phase}: {what}: wall {b['wall_ms']:.3f} ms, device busy "
            f"{b['device_ms']:.3f} ms, idle share {1 - b['busy_share']:.3f}")
        for name, ms, n in b["top"]:
            log(f"{phase}:   {ms:9.3f} ms {n:6d} x {name[:90]}")


def _check_path_counts(counts, path_kernels, phase):
    for name, c in counts.items():
        if name in path_kernels:
            check(c["launches"] > 0, f"{phase}: {name} kernel never launched")
        check(c["plain_calls"] == 0, f"{phase}: {name} plain version ran "
              f"{c['plain_calls']} times on the main path")


#: the kernels of an attention-only GQA engine's serve
PAGED_PATH = ("flash_attention", "paged_decode_attention")


def _check_no_kernel(counts, phase):
    """A path that computes outside every kernel of the port (MLA, xLSTM)
    launches none of them and runs none of their plain versions."""
    for name, c in counts.items():
        check(c == {"launches": 0, "plain_calls": 0},
              f"{phase}: {name} ran on a path that reaches no kernel: {c}")


#: the serve phase's six prompt lengths
SIX_PROMPTS = (100, 128, 200, 256, 384, 500)


def _serve_six(torch, np, cfg, params, dev, phase, window=512,
               path_kernels=PAGED_PATH, keep=None, prompts=SIX_PROMPTS,
               timing_prompt=256):
    """Six greedy requests (prompts 100 to 500, 32 tokens each; or
    ``prompts``) behind one
    8-slot engine with a ``window``-line window: bucketed (or, for a
    recurrent stack, one-prompt) ``prefill_batch``,
    ``decode_multi(steps=8)`` and the ring wrap; every request must finish,
    every logit be finite, the ``path_kernels`` must launch and no plain
    version run (with no path kernels: no kernel may launch at all).  Then
    decode ms per step at 1, 4 and 8 active after ``timing_prompt``-token
    prompts.  ``keep`` (a list) gets the
    six requests.  Returns (counts, per_step, (rng, request, engine,
    admit))."""
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving import sampling as sampling_mod
    helpers = _serving(cfg, params, dev, np, 0, window)
    _, request, engine, admit = helpers

    finite, restore = _watch_logits(torch, sampling_mod, engine_mod)
    reset_counts()
    reqs, eng, prefill_s, decode_s, decode_steps = _run_six(
        torch, request, engine, admit, phase, prompts)
    counts = read_counts()
    restore()
    if keep is not None:
        keep.extend(reqs)
    check(bool(torch.stack(finite).all()), f"{phase}: non-finite logits")
    _check_path_counts(counts, path_kernels, phase)
    if not path_kernels:
        _check_no_kernel(counts, phase)
    prompts = [r.prompt_len for r in reqs]
    log(f"{phase}: {len(reqs)} requests x 32 tokens done; prefill "
        f"{sum(prompts)} tokens "
        f"in {prefill_s * 1e3:.1f} ms = "
        f"{sum(prompts) / prefill_s:.0f} tokens/s; {decode_steps} "
        f"decode steps in {decode_s * 1e3:.1f} ms; host_syncs "
        f"{eng.host_syncs}; launches {counts}")

    per_step = {}
    for n in (1, 4, 8):
        e = engine()
        admit(e, [request(timing_prompt, 33) for _ in range(n)])
        e.decode_multi(steps=8)                     # warm this shape
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.decode_multi(steps=8)
        e.decode_multi(steps=8)
        per_step[n] = (time.perf_counter() - t0) / 16 * 1e3
        check(e.batch_size == n, f"{phase}: {n}-slot timing lost a request")
        del e
    log(f"{phase}: decode ms per step ({timing_prompt}-token prompts, "
        f"steps=8): "
        + ", ".join(f"{n} active {v:.3f}" for n, v in per_step.items()))
    return counts, per_step, helpers


def _run_six(torch, request, engine, admit, phase, prompts=SIX_PROMPTS):
    """The serve phase's six greedy requests (``prompts``, 32 tokens each)
    through one fresh engine: ``prefill_batch`` while slots are free,
    else ``decode_multi(steps=8)``; every request must finish.  Returns
    (requests, engine, prefill s, decode s, decode steps)."""
    reqs = [request(n, 32) for n in prompts]
    eng = engine()
    pending = list(reqs)
    prefill_s = decode_s = 0.0
    decode_steps = 0
    torch.cuda.synchronize()
    while pending or eng.slot_req:
        free = eng.free_slots()
        if pending and free:
            batch, pending = pending[:len(free)], pending[len(free):]
            t0 = time.perf_counter()
            admit(eng, batch)
            torch.cuda.synchronize()
            prefill_s += time.perf_counter() - t0
        else:
            t0 = time.perf_counter()
            out = eng.decode_multi(steps=8)
            decode_s += time.perf_counter() - t0
            decode_steps += max(len(t) for t in out.values()) if out else 0
    torch.cuda.synchronize()
    check(all(len(r.output_tokens) == 32 for r in reqs),
          f"{phase}: output lengths {[len(r.output_tokens) for r in reqs]}")
    return reqs, eng, prefill_s, decode_s, decode_steps


def _decode_vs_prefill(torch, np, cfg, params, dev, rng, phase, paged=True,
                       extra=None, offset=0, window=256):
    """In f32 (weights of another dtype are upcast first): 16 greedy
    decode steps after a 200-token prompt, through the paged kernel or,
    with ``paged`` off, dense; the logits after steps 1, 8 and 16 against
    a fresh prefill over the prompt plus the generated tokens, within
    1e-3 * max|logit|.  ``extra`` (device tensors) joins every prefill's
    batch; a vision prefix of ``offset`` patches moves the decode clock
    to ``offset`` + 200.  Returns the prompt."""
    from repro_torch.models import (decode_step, decode_step_paged,
                                    init_state, prefill)
    if cfg.dtype != "float32":
        cfg = dataclasses.replace(cfg, dtype="float32")
        params = _tree_map(lambda t: t.float(), params)
        log(f"{phase}: f32 weights {_weight_bytes(params) / 1e9:.3f} GB")
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 200),
                                          dtype=np.int32), device=dev)
    extra = extra or {}
    state = init_state(cfg, 1, window, device=dev)
    logits, state = prefill(cfg, params, {"tokens": prompt, **extra}, state)
    tables = torch.arange(window // 16, dtype=torch.int32, device=dev)[None]
    slots = torch.zeros((1,), dtype=torch.int32, device=dev)
    gen_toks, dec_logits = [], {}
    for step in range(1, 17):
        tok = logits.argmax(-1).to(torch.int32)
        gen_toks.append(tok)
        t = torch.full((1,), offset + 200 + step - 1, dtype=torch.int32,
                       device=dev)
        if paged:
            logits, state = decode_step_paged(cfg, params, tok[:, None],
                                              state, t, slots, tables, 16)
        else:
            logits, state = decode_step(cfg, params, tok[:, None], state, t)
        if step in (1, 8, 16):
            dec_logits[step] = logits
    for step, dl in dec_logits.items():
        toks = torch.cat([prompt, torch.stack(gen_toks[:step], dim=1)], dim=1)
        fresh = init_state(cfg, 1, window, device=dev)
        pl, _ = prefill(cfg, params, {"tokens": toks, **extra}, fresh)
        err = max_err(dl, pl)
        scale = float(pl.abs().max())
        log(f"{phase}: step {step}: max |decode - prefill| {err:.3e}, "
            f"max |logit| {scale:.3f}, ratio {err / scale:.3e} (limit 1e-3)")
        check(err <= 1e-3 * scale, f"{phase}: step {step} differs by "
              f"{err} against max logit {scale}")
    return prompt


def phase_dense(torch, dev, np):
    """Phases 3-5 on full-width starcoder2-3b; returns the serve phase's
    kernel counts, its decode ms per step by active slots and its six
    requests (the mesh-engine phase's reference)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import counts_since, read_counts
    from repro_torch.models import init_params

    # -- 3. serve ----------------------------------------------------------------
    cfg = get_config("starcoder2-3b")
    log(f"serve: {cfg.name} full width: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}, hd "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    six = []
    counts, per_step, (rng, request, engine, admit) = _serve_six(
        torch, np, cfg, params, dev, "serve", keep=six)

    # where the time goes: one 8 x 256 prefill plan, then one fused decode
    # plan (steps=8) over those 8 requests; host wall clock unprofiled,
    # device time per kernel from a second, profiled run
    def fresh_plan():
        e = engine()
        batch = [request(256, 33) for _ in range(8)]
        return e, lambda: admit(e, batch)

    e, run = fresh_plan()
    run()                                                 # warm this shape
    e, run = fresh_plan()
    wall = _wall_ms(torch, run)
    e, run = fresh_plan()
    breakdown = {"prefill 8x256": _breakdown(wall, _device_profile(torch,
                                                                   run))}
    e.decode_multi(steps=8)
    wall = _wall_ms(torch, lambda: e.decode_multi(steps=8))
    before = read_counts()
    profiled = _device_profile(torch, lambda: e.decode_multi(steps=8))
    # a graph replay calls no wrapper: its launches are credited, so hold
    # the credit to the paged kernel's activities in the trace
    credited = counts_since(before)["paged_decode_attention"]["launches"]
    ran = sum(n for name, (_, n) in profiled.items() if "paged_kernel" in name)
    log(f"serve: a replayed decode plan's paged kernel launches: credited "
        f"{credited}, in the trace {ran}")
    check(credited == ran == 8 * cfg.num_layers,
          f"serve: paged launches credited {credited}, traced {ran}, want "
          f"{8 * cfg.num_layers}")
    breakdown["decode 8 active x 8 steps"] = _breakdown(wall, profiled)
    del e, run
    _print_breakdown(breakdown, "serve")

    # -- 4. consistency (f32, full width) ----------------------------------------
    _decode_vs_prefill(torch, np, cfg, params, dev, rng, "consistency")

    # -- 5. redundancy -----------------------------------------------------------
    _redundancy("redundancy", engine, rng.integers(
        0, cfg.vocab_size, (1, 300), dtype=np.int32), same_slot=False)
    return counts, per_step, six


def _serving(cfg, params, dev, np, seed, kv_capacity, mesh=None):
    """(rng, request, engine, admit): the helpers of one model's serve
    phases, after a warm-up (cuBLAS handles, allocator pools, kernel
    libraries).  Each request carries the modality payload that
    ``default_extras`` draws for its config (none for a text-only one).
    With ``mesh`` every engine is built on that slice."""
    from repro_torch.serving import InstanceEngine, Request
    from repro_torch.stepplan import PrefillItem, PrefillPlan, bucket_len
    from repro_torch.workloads import default_extras
    rng = np.random.default_rng(seed)
    drawn = [0]

    def request(plen, new):
        drawn[0] += 1
        return Request(prompt_len=plen, max_new_tokens=new,
                       prompt_tokens=rng.integers(0, cfg.vocab_size,
                                                  (1, plen), dtype=np.int32),
                       extra=default_extras(cfg, seed, drawn[0]))

    def engine(**kw):
        kw.setdefault("num_slots", 8)
        kw.setdefault("kv_capacity", kv_capacity)
        return InstanceEngine(cfg, params, block_lines=16, device=dev,
                              mesh=mesh, **kw)

    def admit(eng, reqs):
        items = tuple(PrefillItem(r.rid, r.prompt_len, 0, r.prompt_len, req=r)
                      for r in reqs)
        bucket = bucket_len(max(r.prompt_len for r in reqs),
                            cap=eng.kv_capacity)
        return eng.prefill_batch(PrefillPlan(eng.instance_id, items, bucket))

    warm = engine()
    admit(warm, [request(64, 9), request(100, 9)])
    while warm.slot_req:
        warm.decode_multi(steps=8)
    return rng, request, engine, admit


def _redundancy(phase, engine, prompt, same_slot):
    """A replica on a second 2-slot engine follows a request by mirror
    syncs, then takes over by promotion; its tokens must equal a run with
    no handoff.  Each sync must move ``mirror_bytes(1)``: one KV line plus
    the whole recurrent state.  With ``same_slot`` the request sits in
    slot 0 of every engine: dense decode runs every slot's row and MoE
    capacity ranks rows in order, so only the first row never loses its
    capacity to an idle row."""
    from repro_torch.serving import Request

    def red_request():
        return Request(prompt_len=prompt.shape[1], max_new_tokens=24,
                       prompt_tokens=prompt.copy())

    control = engine(num_slots=2)
    req_c = red_request()
    sc = control.prefill_request(req_c)
    while control.slot_req:
        control.decode()
    a, b = engine(num_slots=2), engine(num_slots=2, instance_id=1)
    req = red_request()
    sa = a.prefill_request(req)
    if same_slot:
        check(sa == sc == 0, f"{phase}: the request must sit in slot 0")
    sb = sa if same_slot else 1 - sa
    b.import_slot(sb, a.export_slot(sa), req, as_replica_of=(0, sa))
    costs = b.store.costs
    line = costs.mirror_bytes(1)
    moved = []
    for _ in range(8):
        a.decode()
        moved.append(b.sync_replica_from(a, sa, sb))
    check(all(m == line for m in moved),
          f"{phase}: syncs moved {moved}, expected {line} each")
    a.demote_to_replica(sa, (1, sb))
    b.promote_replica(sb, req)
    while b.slot_req:
        b.decode()
    check(req.output_tokens == req_c.output_tokens,
          f"{phase}: tokens after promotion differ from the control run")
    log(f"{phase}: 8 mirror syncs of {line:.0f} bytes each (one KV line of "
        f"{costs.line_bytes:.0f} bytes plus the whole recurrent state of "
        f"{costs.recurrent_bytes} bytes), promotion on the replica engine; "
        f"{len(req.output_tokens)} tokens equal the control run")


def _record_moves(engine_cls):
    """Patch ``engine_cls`` to count what its engines move, from each
    engine's own ledger: the bytes ``LineCosts`` price for the lines each
    replica's synced mark gained and for the lines each stream installed,
    less the head lines the destination adopted from its prefix cache
    (resident there, so not moved), and the streams installed.  Returns
    (moved, restore)."""
    moved = {"mirror": 0.0, "stream": 0.0, "mirror_lines": 0,
             "stream_lines": 0, "streams": 0}
    plain_sync, plain_import = (engine_cls.sync_replica_from,
                                engine_cls.import_stream)

    def sync(self, src, src_slot, dst_slot, from_line=None, to_line=None):
        rid = src._rid_at(src_slot)
        before = max(self.store.synced_line(rid),
                     self.store.shared_head_lines(rid))
        out = plain_sync(self, src, src_slot, dst_slot, from_line=from_line,
                         to_line=to_line)
        delta = self.store.synced_line(rid) - before
        moved["mirror"] += self.store.costs.mirror_bytes(delta)
        moved["mirror_lines"] += delta
        return out

    def stream(self, slot, chunks, length, last_tok, lines, req,
               as_replica_of=None):
        plain_import(self, slot, chunks, length, last_tok, lines, req,
                     as_replica_of=as_replica_of)
        got = self.store.lines(req.rid)
        head = min(got, self.store.shared_head_lines(req.rid))
        moved["stream"] += (self.store.costs.bytes_at(got)
                            - head * self.store.costs.line_bytes)
        moved["stream_lines"] += got - head
        moved["streams"] += 1

    def restore():
        engine_cls.sync_replica_from = plain_sync
        engine_cls.import_stream = plain_import

    engine_cls.sync_replica_from = sync
    engine_cls.import_stream = stream
    return moved, restore


#: scheduling steps of the cluster phase's serve that the profiler covers
#: the cluster phase's profiled rerun: scheduling steps [lo, hi) of the
#: serve's first hi steps
CLUSTER_WINDOW = (0, 30)


def _step_clock(torch, cluster_cls, window, prof=None):
    """Patch ``cluster_cls.step`` to record each scheduling step's host
    start, end and iterations, synchronising the card at the edges of
    ``window`` (first step, end step) and profiling the steps inside it
    with ``prof``; returns (marks, restore)."""
    plain = cluster_cls.step
    marks = []

    def step(self):
        i = len(marks)
        if i == window[0]:
            torch.cuda.synchronize()
            if prof is not None:
                prof.start()
        it0 = self.n_iterations
        t0 = time.perf_counter()
        plain(self)
        if i == window[1] - 1:
            torch.cuda.synchronize()
            if prof is not None:
                prof.stop()
        marks.append((t0, time.perf_counter(), self.n_iterations - it0))

    def restore():
        cluster_cls.step = plain

    cluster_cls.step = step
    return marks, restore


def _watch_offsets(attention_mod):
    """Patch the model's prefill-kernel entry to count the calls that
    resume a chunk (``q_offset > 0``); returns (counter, restore)."""
    plain = attention_mod.flash_attention_cuda
    calls = {"q_offset>0": 0}

    def watched(q, k, v, **kw):
        if kw.get("q_offset", 0) > 0:
            calls["q_offset>0"] += 1
        return plain(q, k, v, **kw)

    def restore():
        attention_mod.flash_attention_cuda = plain

    attention_mod.flash_attention_cuda = watched
    return calls, restore


def _light(duration):
    """The paper's Table 2 "light" traffic (prompts and decodes 20-500
    tokens) as Poisson arrivals at 0.1 per iteration over ``duration``
    iterations."""
    from repro_torch.workloads import Poisson, TableLengths, WorkloadSpec
    return WorkloadSpec(arrival=Poisson(rate=0.1, duration=duration),
                        lengths=TableLengths("light"), name="light")


def _cluster_spec(**kw):
    from repro_torch.api import ServeSpec
    base = dict(arch="starcoder2-3b", reduced=False, policy="accellm",
                n_instances=2, num_slots=8, kv_capacity=1024, block_lines=16,
                fuse_decode_steps=8, seed=0, device="cuda", max_steps=5000)
    base.update(kw)
    return ServeSpec(**base)


def phase_cluster(torch, np):
    """Phases 6-9: full-width starcoder2-3b in bf16 served by ``api.serve``
    through a two-instance AcceLLM cluster, then through a sarathi cluster
    that resumes prompts chunk by chunk, then the first stream again with
    a mid-serve kill and a rejoin, then a shared-prefix stream with the
    prefix cache off and on; returns each phase's kernel counts and the
    serves' measurements."""
    from repro_torch.api import ServeReport, build_cluster, serve
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.models import attention as attention_mod
    from repro_torch.scheduling import LiveCluster
    from repro_torch.serving import InstanceEngine
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving import sampling as sampling_mod

    # -- 6. cluster ----------------------------------------------------------------
    spec = _cluster_spec(traffic=_light(120.0))
    n_req = len(list(spec.traffic.source(seed=spec.seed)))
    log(f"cluster: {spec.arch} full width, bf16, policy {spec.policy}, "
        f"{spec.n_instances} instances x {spec.num_slots} slots, window "
        f"{spec.kv_capacity}, {spec.block_lines}-line blocks, fuse "
        f"{spec.fuse_decode_steps}; traffic {spec.traffic.describe()}: "
        f"{n_req} requests")
    finite, restore = _watch_logits(torch, sampling_mod, engine_mod)
    marks, unclock = _step_clock(torch, LiveCluster, CLUSTER_WINDOW)
    moved, unrecord = _record_moves(InstanceEngine)
    torch.cuda.synchronize()
    reset_counts()
    # api.serve's two steps, the weights' draw and the run timed apart
    t0 = time.perf_counter()
    cluster = build_cluster(spec)
    torch.cuda.synchronize()
    draw = time.perf_counter() - t0
    t0 = time.perf_counter()
    finished = cluster.run(max_steps=spec.max_steps,
                           source=spec.resolve_traffic().source(
                               seed=spec.seed, cfg=cluster.cfg))
    torch.cuda.synchronize()
    run = time.perf_counter() - t0
    wall = draw + run
    report = ServeReport(spec=spec, cluster=cluster, finished=finished,
                         n_submitted=len(cluster._submitted))
    counts = {"cluster": read_counts()}
    unrecord()
    unclock()
    restore()
    params = cluster.engines[0].params
    n_it = cluster.n_iterations
    # what the later phases hold their runs against: the no-kill tokens
    # and iterations, and the wall ms per iteration of the run on drawn
    # weights (sim-calibration reads it)
    measured = {"spec": spec, "requests": list(cluster._submitted),
                "iterations": n_it,
                "ms_per_iteration": [run * 1e3 / max(1, n_it)]}
    log("cluster: report:\n" + report.describe())
    log(f"cluster: serve wall {wall:.3f} s ({draw:.3f} s drawing the "
        f"weights, {run:.3f} s running), {n_it} iterations in {len(marks)} "
        f"scheduling steps, {measured['ms_per_iteration'][0]:.3f} ms per "
        f"iteration on drawn weights, sched_us_per_iter "
        f"{report.sched_us_per_iter:.1f}; launches {counts['cluster']}")
    check(report.all_finished, f"cluster: not every request finished: "
          f"{report.describe()}")
    check(report.n_submitted == n_req, f"cluster: {report.n_submitted} of "
          f"{n_req} requests submitted")
    check(all(len(r.output_tokens) == r.max_new_tokens
              for r in report.finished),
          "cluster: a request ended short of its max_new_tokens")
    check(bool(torch.stack(finite).all()), "cluster: non-finite logits")
    st = report.stats
    check(st["mirror_syncs"] > 0, "cluster: no mirror sync")
    check(st["rebalances"] + st["replica_promotions"] > 0,
          "cluster: no rebalance or promotion")
    for key in ("mirror", "stream"):
        check(st[f"{key}_bytes"] == moved[key],
              f"cluster: stats {key}_bytes {st[f'{key}_bytes']} != "
              f"{moved[key]} priced by LineCosts over "
              f"{moved[key + '_lines']} lines")
    log(f"cluster: mirror_bytes {st['mirror_bytes']:.0f} = LineCosts over "
        f"{moved['mirror_lines']} mirrored lines; stream_bytes "
        f"{st['stream_bytes']:.0f} = LineCosts over {moved['stream_lines']} "
        f"streamed lines")
    _check_path_counts(counts["cluster"],
                       ("flash_attention", "paged_decode_attention"),
                       "cluster")

    # the serve's first steps again on the same weights (T=0: the same
    # decisions), the card's kernels profiled over the window
    lo, hi = CLUSTER_WINDOW
    check(len(marks) >= hi, f"cluster: {len(marks)} scheduling steps, fewer "
          f"than the profiled window's end {hi}")
    again = build_cluster(spec, params=params)
    prof = _profiler(cpu=False)
    marks2, unclock = _step_clock(torch, LiveCluster, CLUSTER_WINDOW, prof)
    again.run(max_steps=hi,
              source=spec.traffic.source(seed=spec.seed, cfg=again.cfg))
    torch.cuda.synchronize()
    unclock()
    window_it = sum(m[2] for m in marks[lo:hi])
    check(again.n_iterations == sum(m[2] for m in marks[:hi])
          and sum(m[2] for m in marks2[lo:hi]) == window_it,
          "cluster: the rerun's iterations differ from the serve's")
    window_ms = (marks[hi - 1][1] - marks[lo][0]) * 1e3
    profiled_ms = (marks2[hi - 1][1] - marks2[lo][0]) * 1e3
    t0 = time.perf_counter()
    b = _breakdown(window_ms, _kernel_times(prof), top=8)
    log(f"cluster: profile aggregated in {time.perf_counter() - t0:.1f} s")
    log(f"cluster: scheduling steps {lo}-{hi - 1} ({window_it} iterations) "
        f"took {window_ms:.1f} ms in the serve, "
        f"{window_ms / max(1, window_it):.3f} ms per iteration; "
        f"{profiled_ms:.1f} ms profiled in a rerun of the serve's first {hi} "
        f"steps")
    _print_breakdown({f"steps {lo}-{hi - 1}": b}, "cluster")
    # the rerun's tokens so far: cluster-fleet holds them to the serve's
    measured["rerun"] = list(again._submitted)
    del again, cluster, report, prof

    # -- 7. cluster-chunked --------------------------------------------------------
    # on the weights' first CHUNKED_LAYERS layers: the chunk schedule
    # depends on the lengths alone, and each layer resumes as the first
    spec = _cluster_spec(policy="sarathi", policy_kwargs={"chunk_tokens": 128},
                         traffic=_light(60.0))
    n_req = len(list(spec.traffic.source(seed=spec.seed)))
    from repro_torch.configs import get_config
    chunked = build_cluster(
        spec, cfg=_depth_cut(get_config(spec.arch), CHUNKED_LAYERS),
        params=_first_layers(params, CHUNKED_LAYERS))
    chunked.planner.trace = []
    offsets, restore = _watch_offsets(attention_mod)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    finished = chunked.run(max_steps=spec.max_steps, source=spec.traffic.source(
        seed=spec.seed, cfg=chunked.cfg))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["cluster-chunked"] = read_counts()
    restore()
    report = ServeReport(spec=spec, cluster=chunked, finished=finished,
                         n_submitted=len(chunked._submitted))
    resumed = [it for e in chunked.planner.trace
               if e[0] in ("prefill", "mixed")
               for it in e[2][0 if e[0] == "mixed" else slice(None)]
               if it[1] > 0]
    log(f"cluster-chunked: sarathi, chunk_tokens 128, the first "
        f"{CHUNKED_LAYERS} of 30 layers; report:\n" + report.describe())
    log(f"cluster-chunked: serve wall {wall:.3f} s, {chunked.n_iterations} "
        f"iterations, {wall * 1e3 / max(1, chunked.n_iterations):.3f} ms per "
        f"iteration; {len(resumed)} resumed chunks (start > 0); prefill "
        f"kernel launches at q_offset > 0: {offsets['q_offset>0']}; "
        f"launches {counts['cluster-chunked']}")
    check(report.all_finished and len(finished) == n_req,
          f"cluster-chunked: not every request finished: {report.describe()}")
    check(resumed, "cluster-chunked: no chunk resumed past its start")
    check(offsets["q_offset>0"] >= CHUNKED_LAYERS,
          "cluster-chunked: the prefill kernel never ran at q_offset > 0")
    _check_path_counts(counts["cluster-chunked"],
                       ("flash_attention", "paged_decode_attention"),
                       "cluster-chunked")
    del chunked, report

    # -- 8. cluster-fleet ------------------------------------------------------------
    counts.update(phase_cluster_fleet(torch, params, measured))
    _free(torch)
    # -- 9. cluster-prefix -----------------------------------------------------------
    counts.update(phase_cluster_prefix(torch, params, measured))
    del params
    return counts, measured


#: cluster-chunked: the layers of its serve (of starcoder2-3b's 30)
CHUNKED_LAYERS = 6
#: cluster-fleet: the kill of instance 1 and its rejoin, in iterations.  A
#: CPU rehearsal of the stream at reduced width put the kill where
#: instance 1 holds two mirrored primaries (instance 0 two more) and the
#: rejoin where instance 0 still holds four requests, so it is warmed.
FLEET_KILL, FLEET_JOIN = 60.0, 90.0
#: cluster-fleet: the layers of the kill runs and their no-kill reference
#: (of starcoder2-3b's 30), and of their CPU rehearsal (of the reduced 2)
FLEET_LAYERS = 6
REHEARSAL_LAYERS = 1


def _fleet_spec(policy, kill=True, **kw):
    from repro_torch.fleet import FixedFleet, JoinInstance, KillInstance
    fleet = (FixedFleet((KillInstance(FLEET_KILL, 1),
                         JoinInstance(FLEET_JOIN, 1))) if kill else None)
    return _cluster_spec(policy=policy, traffic=_light(120.0), fleet=fleet,
                         **kw)


def _serve_traced(spec, params=None, cfg=None):
    """``api.serve`` with the planner's plan trace and the policy
    kernel's decision trace on."""
    from repro_torch.api import ServeReport, build_cluster
    cluster = build_cluster(spec, cfg=cfg, params=params)
    cluster.planner.trace = []
    cluster.policy.trace = []
    finished = cluster.run(max_steps=spec.max_steps, source=spec.traffic.source(
        seed=spec.seed, cfg=cluster.cfg))
    return ServeReport(spec=spec, cluster=cluster, finished=finished,
                       n_submitted=len(cluster._submitted))


def _prefill_plans(trace):
    """Plans with a prefill part: each launches the prefill kernel once per
    layer (whole prompts of a plan run as one padded batch)."""
    return sum(1 for e in trace if e[0] in ("prefill", "mixed"))


def _latency_line(report, ms_per_it):
    """TTFT p50/p99, TBT mean/worst and JCT p50/p99, in iterations and in
    ms at ``ms_per_it``."""
    import numpy as np
    vals = {"TTFT p50": np.percentile(report.ttfts(), 50),
            "TTFT p99": np.percentile(report.ttfts(), 99),
            "TBT mean": report.tbts().mean(), "TBT worst": report.tbts().max(),
            "JCT p50": np.percentile(report.jcts(), 50),
            "JCT p99": np.percentile(report.jcts(), 99)}
    return "; ".join(f"{k} {v:.2f} it = {v * ms_per_it:.1f} ms"
                     for k, v in vals.items())


def _rows16_32(cfg, params, params32, window, tokens):
    """One fresh prefill over ``tokens`` (1, S) in bf16 and one with the
    same weights upcast to f32: the last position's logits of each, f32."""
    from repro_torch.models import init_state, prefill
    dev = tokens.device
    rows = []
    for c, p in ((cfg, params),
                 (dataclasses.replace(cfg, dtype="float32"), params32)):
        logits, _ = prefill(c, p, {"tokens": tokens},
                            init_state(c, 1, window, device=dev))
        rows.append(logits[0].float())
        del logits
    return rows


def _tie_limit(row16, row32):
    """Two tokens whose f32 logits lie closer than this may come out in
    either order from a bf16 run: each logit of the row moved by at most
    max|bf16 - f32| in this reading, so their gap by at most twice it."""
    return 2.0 * float((row16 - row32).abs().max())


def _first_differences(requests, reference, phase):
    """(request, step, its token, the reference's token) where each
    request's tokens first differ from the same request's in
    ``reference`` (rid -> Request)."""
    out = []
    for r in requests:
        ref = reference[r.rid]
        check(bool((ref.prompt_tokens == r.prompt_tokens).all()),
              f"{phase}: request {r.rid}'s prompt differs from the reference")
        j = next((j for j, (a, b) in enumerate(zip(r.output_tokens,
                                                  ref.output_tokens))
                  if a != b), None)
        if j is not None:
            out.append((r, j, int(r.output_tokens[j]),
                        int(ref.output_tokens[j])))
    return out


def _with_outputs(torch, r, j, dev):
    """Request ``r``'s prompt followed by its first ``j`` tokens, (1, S)."""
    toks = torch.as_tensor(r.prompt_tokens, device=dev)
    if not j:
        return toks
    return torch.cat([toks, torch.tensor([r.output_tokens[:j]],
                                         dtype=toks.dtype, device=dev)], dim=1)


def _judge_ties(rows, phase):
    """Each differing pair (rid, step, token, reference token, its row's
    bf16 and f32 logits) is a near-tie (printed) when the two tokens' f32
    gap is within :func:`_tie_limit` of that row, and a fault otherwise;
    returns the near-ties."""
    near, faults = [], []
    for rid, j, a, b, row16, row32 in rows:
        gap, limit = abs(float(row32[a] - row32[b])), _tie_limit(row16, row32)
        (near if gap <= limit else faults).append((rid, j, a, b, gap, limit))
    for rid, j, a, b, gap, limit in near + faults:
        log(f"{phase}: request {rid} step {j}: token {a}, reference {b}; "
            f"f32 gap {gap:.3e}, bf16 limit on this row {limit:.3e} "
            f"({'near-tie' if gap <= limit else 'FAULT'})")
    check(not faults, f"{phase}: tokens differ beyond a near-tie: {faults}")
    return near


def _tokens_against(torch, cfg, params, params32, window, reference,
                    requests, phase):
    """Each request's tokens against the same request's in ``reference``
    (rid -> Request), at T = 0.  Where they first differ, the prompt and
    the common tokens go through one fresh prefill in bf16 and one in f32,
    and :func:`_judge_ties` judges the pair."""
    dev = _leaves(params)[0].device
    rows = []
    for r, j, a, b in _first_differences(requests, reference, phase):
        row16, row32 = _rows16_32(cfg, params, params32, window,
                                  _with_outputs(torch, r, j, dev))
        rows.append((r.rid, j, a, b, row16, row32))
    return _judge_ties(rows, phase)


def _tie_limits(torch, cfg, params, params32, window, requests, phase):
    """The near-tie limit read on each request's first token: the served
    token's f32 logit must be within the row's limit of the f32 maximum,
    and the row's lowest token beyond it (the limit separates a wrong
    token from a tie).  Prints each row's limit and f32 top-2 gap."""
    dev = _leaves(params)[0].device
    lines = []
    for r in requests:
        row16, row32 = _rows16_32(
            cfg, params, params32, window,
            torch.as_tensor(r.prompt_tokens, device=dev))
        limit, top = _tie_limit(row16, row32), float(row32.max())
        top2 = row32.topk(2).values
        served = top - float(row32[int(r.output_tokens[0])])
        check(served <= limit, f"{phase}: request {r.rid}'s first token lies "
              f"{served:.3e} below the f32 maximum, beyond the limit "
              f"{limit:.3e}")
        check(top - float(row32.min()) > limit, f"{phase}: request {r.rid}'s "
              f"limit {limit:.3e} does not separate the lowest token")
        lines.append(f"{r.rid}: limit {limit:.3e}, top-2 gap "
                     f"{float(top2[0] - top2[1]):.3e}, max |logit| "
                     f"{float(row32.abs().max()):.3f}")
    log(f"{phase}: bf16 near-tie limit (2 x max |bf16 - f32| over the row) "
        f"and f32 top-2 gap at each request's first token: "
        + "; ".join(lines))


def phase_cluster_fleet(torch, params, measured):
    """Phase 8: the cluster phase's stream on the same weights' first
    ``FLEET_LAYERS`` layers once with no kill (the kill runs' reference)
    and with instance 1 killed at ``FLEET_KILL`` and rejoined at
    ``FLEET_JOIN``, under accellm and under vllm, beside a CPU rehearsal
    at reduced width cut to ``REHEARSAL_LAYERS`` layer: the policy's and
    the fleet's decisions depend on neither the widths nor the depth.
    First, on the whole depth, the cluster phase's profiled rerun of its
    first steps (``measured["rerun"]``): each request's tokens so far equal
    the serve's up to near-ties.  Returns the kernel counts of each kill
    run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving import sampling as sampling_mod
    t_phase = time.perf_counter()
    reference = {r.rid: r for r in measured["requests"]}
    params32 = _tree_map(lambda t: t.float(), params)
    counts = {}
    spec = measured["spec"]
    cfg = get_config(spec.arch)

    # the whole depth: the rerun's tokens against the serve's, and the
    # near-tie limit on each request's first token
    phase = "cluster-fleet rerun"
    rerun = measured.get("rerun", [])
    check(sum(len(r.output_tokens) for r in rerun) > 0,
          f"{phase}: the cluster phase's rerun sampled no token")
    near = _tokens_against(torch, cfg, params, params32, spec.kv_capacity,
                           reference, rerun, phase)
    log(f"{phase}: {len(rerun)} requests of the cluster phase's rerun of its "
        f"first {CLUSTER_WINDOW[1]} scheduling steps, "
        f"{sum(len(r.output_tokens) for r in rerun)} tokens, equal the "
        f"serve's" + (f" up to {len(near)} near-ties" if near else ""))
    _tie_limits(torch, cfg, params, params32, spec.kv_capacity,
                measured["requests"], "cluster-fleet")
    # the kill runs on the first FLEET_LAYERS layers, beside their own
    # no-kill run, whose tokens they are held to
    cfg = _depth_cut(cfg, FLEET_LAYERS)
    params = _first_layers(params, FLEET_LAYERS)
    params32 = _first_layers(params32, FLEET_LAYERS)
    phase = f"cluster-fleet no-kill, {FLEET_LAYERS} layers"
    t0 = time.perf_counter()
    report = _serve_traced(_fleet_spec("accellm", kill=False), params=params,
                           cfg=cfg)
    torch.cuda.synchronize()
    n_it = report.cluster.n_iterations
    check(report.all_finished and n_it == measured["iterations"],
          f"{phase}: {n_it} iterations against the cluster serve's "
          f"{measured['iterations']}: {report.describe()}")
    reference = {r.rid: r for r in report.finished}
    log(f"{phase}: serve wall {time.perf_counter() - t0:.3f} s, {n_it} "
        f"iterations; the kill runs' reference")
    del report
    # the CPU rehearsal at reduced width: the policy's decisions depend on
    # neither the widths nor the tokens, so the card must repeat them
    t0 = time.perf_counter()
    small = _depth_cut(get_config("starcoder2-3b").reduced(),
                       REHEARSAL_LAYERS)
    rehearsal = {(policy, kill): _serve_traced(_fleet_spec(
        policy, kill, reduced=True, device="cpu"), cfg=small)
        for policy, kill in (("accellm", True), ("vllm", True),
                             ("vllm", False))}
    log(f"cluster-fleet: kill instance 1 at iteration {FLEET_KILL:g}, "
        f"rejoin at {FLEET_JOIN:g}, on the first {FLEET_LAYERS} layers; CPU "
        f"rehearsal at reduced width, {REHEARSAL_LAYERS} layer, in "
        f"{time.perf_counter() - t0:.1f} s")
    for policy in ("accellm", "vllm"):
        phase = f"cluster-fleet {policy}"
        spec = _fleet_spec(policy)
        finite, restore = _watch_logits(torch, sampling_mod, engine_mod)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        report = _serve_traced(spec, params=params, cfg=cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[phase] = read_counts()
        restore()
        cluster, reh = report.cluster, rehearsal[policy, True]
        n_it, fs = cluster.n_iterations, report.fleet_stats
        ms_per_it = wall * 1e3 / max(1, n_it)
        log(f"{phase}: report:\n" + report.describe())
        log(f"{phase}: serve wall {wall:.3f} s, {n_it} iterations, "
            f"{ms_per_it:.3f} ms per iteration; "
            + _latency_line(report, ms_per_it))
        log(f"{phase}: fleet trace {cluster.fleet.trace}; launches "
            f"{counts[phase]}")
        check(report.all_finished and len(report.finished)
              == len(reference), f"{phase}: not every request finished: "
              f"{report.describe()}")
        check(all(len(r.output_tokens) == r.max_new_tokens
                  for r in report.finished),
              f"{phase}: a request ended short of its max_new_tokens")
        check(bool(torch.stack(finite).all()), f"{phase}: non-finite logits")
        diff = {k: (v, reh.fleet_stats[k]) for k, v in fs.items()
                if v != reh.fleet_stats[k]}
        check(not diff, f"{phase}: fleet stats (card, rehearsal) differ: "
              f"{diff}")
        check(cluster.fleet.trace == reh.cluster.fleet.trace,
              f"{phase}: the fleet trace differs from the rehearsal's")
        check(n_it == reh.cluster.n_iterations
              and cluster.planner.trace == reh.cluster.planner.trace,
              f"{phase}: {n_it} iterations and the plan trace against the "
              f"rehearsal's {reh.cluster.n_iterations}")
        layers = cluster.cfg.num_layers
        plans = _prefill_plans(cluster.planner.trace)
        flash = counts[phase]["flash_attention"]["launches"]
        check(flash == layers * plans, f"{phase}: {flash} prefill kernel "
              f"launches for {plans} prefill plans x {layers} layers")
        if policy == "accellm":
            check(fs["promotions"] > 0 and fs["requeues"] == 0
                  and fs["reprefill_tokens"] == 0 and fs["warm_streams"] > 0,
                  f"{phase}: the kill must be absorbed by promotions and "
                  f"the rejoin warmed: {fs}")
        else:
            base = _prefill_plans(rehearsal["vllm", False].cluster
                                  .planner.trace)
            check(fs["requeues"] > 0 and fs["reprefill_tokens"] > 0
                  and plans > base, f"{phase}: the kill must re-prefill: "
                  f"{fs}, {plans} prefill plans against {base} with no kill")
            log(f"{phase}: {fs['requeues']} requests re-prefilled "
                f"({fs['reprefill_tokens']} prompt tokens) in "
                f"{plans - base} more prefill plans than with no kill: "
                f"prefill kernel launches {flash} = {layers} x {plans}, "
                f"{layers * (plans - base)} more than with no kill")
        log(f"{phase}: fleet stats equal the rehearsal's: "
            f"{ {k: v for k, v in fs.items() if v} }")
        _check_path_counts(counts[phase],
                           ("flash_attention", "paged_decode_attention"),
                           phase)
        near = _tokens_against(torch, cluster.cfg, params, params32,
                               spec.kv_capacity, reference, report.finished,
                               phase)
        log(f"{phase}: {len(report.finished)} requests' tokens equal the "
            f"{FLEET_LAYERS}-layer no-kill run's"
            + (f" up to {len(near)} near-ties" if near else ""))
        del report, cluster
    del params32
    log(f"cluster-fleet: phase {time.perf_counter() - t_phase:.1f} s")
    return counts


#: cluster-prefix: the cluster stream's processes over the first
#: ``PREFIX_DURATION`` iterations with shared prompt heads (two system
#: prompts, 80% of requests open with one).  A CPU rehearsal at reduced
#: width gives 3 hits over 12 requests, one of them a whole 256-line head
#: (the shortest such stream from seed 0: 55 iterations give 11 requests
#: and no whole head).
PREFIX_REUSE = dict(pool=2, reuse=0.8, prefix_len=256)
PREFIX_DURATION = 60.0
#: cluster-prefix serves both streams on the cluster weights' first
#: ``PREFIX_LAYERS`` of 30 layers (its checks count per layer; the
#: rehearsal's decisions depend on neither widths nor depth)
PREFIX_LAYERS = 6


def _prefix_spec(prefix_cache, **kw):
    from repro_torch.workloads import PrefixReuse
    traffic = dataclasses.replace(
        _light(PREFIX_DURATION), name="light-prefix",
        prefix_reuse=PrefixReuse(**PREFIX_REUSE))
    return _cluster_spec(traffic=traffic, prefix_cache=prefix_cache, **kw)


def _watch_saved(cluster_cls):
    """Patch ``cluster_cls.step`` to record, after each scheduling step,
    the most pool blocks any engine's ledger saves by sharing; returns
    (per-step maxima, restore)."""
    plain = cluster_cls.step
    saved = []

    def step(self):
        plain(self)
        saved.append(max(e.store.ledger.shared_saved_blocks()
                         for e in self.engines))

    def restore():
        cluster_cls.step = plain

    cluster_cls.step = step
    return saved, restore


def _watch_copies(torch, store_cls, lines=0):
    """Patch ``store_cls.copy_prefix`` to record each call's (lines,
    bytes), and to profile the first call that copies ``lines`` lines
    (with ``lines`` > 0) in a torch.profiler window of its own
    (:func:`_device_profile`); returns (calls, timed: {"kernels", "call":
    that call's arguments, to replay}, restore)."""
    plain = store_cls.copy_prefix
    calls, timed = [], {}

    def watched(self, blocks, dst_slot, n_lines):
        if not lines or n_lines != lines or timed:
            out = plain(self, blocks, dst_slot, n_lines)
        else:
            got = []
            timed["kernels"] = _device_profile(torch, lambda: got.append(
                plain(self, blocks, dst_slot, n_lines)))
            timed["call"] = (self, list(blocks), dst_slot, n_lines)
            out = got[0]
        calls.append((n_lines, out))
        return out

    def restore():
        store_cls.copy_prefix = plain

    store_cls.copy_prefix = watched
    return calls, timed, restore


def _prefill_tokens(trace):
    """Prompt tokens the prefill plans of a plan trace computed."""
    return sum(end - start for e in trace if e[0] in ("prefill", "mixed")
               for _, start, end in e[2][0 if e[0] == "mixed"
                                         else slice(None)])


def _suffix_vs_whole_f32(torch, cfg, params32, spec, requests, phase):
    """In f32 at full width: the request of ``requests`` with the longest
    hit, prefilled through an engine with the prefix cache (``spec``'s
    window and blocks) after the earlier member of its group whose head
    it adopts (its suffix at q_offset = the hit, over the gathered rows),
    against a whole-prompt prefill of its prompt, within 1e-3 *
    max|logit|."""
    from repro_torch.models import init_state, prefill
    from repro_torch.prefixcache import aligned_hit_lines
    from repro_torch.serving import InstanceEngine, Request
    from repro_torch.serving import engine as engine_mod
    from repro_torch.stepplan import PrefillItem, PrefillPlan, bucket_len
    reqs = sorted(requests, key=lambda r: r.rid)
    target = max((r for r in reqs if r.prefix_hit),
                 key=lambda r: (r.prefix_hit, -r.rid))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    dev = _leaves(params32)[0].device
    window = spec.kv_capacity
    eng = InstanceEngine(cfg32, params32, num_slots=2, kv_capacity=window,
                         block_lines=spec.block_lines, prefix_cache=True,
                         device=dev)
    bl = eng.store.block_lines
    donor = next(r for r in reqs if r.rid < target.rid
                 and r.prefix_id == target.prefix_id
                 and aligned_hit_lines(r.prefix_len, r.prompt_len, bl)
                 >= target.prefix_hit)
    rows = []
    plain = engine_mod.sample_slots

    def captured(logits, *a, **kw):
        rows.append(logits[0].float())
        return plain(logits, *a, **kw)

    engine_mod.sample_slots = captured
    try:
        for i, r in enumerate((donor, target)):
            req = Request(prompt_len=r.prompt_len, max_new_tokens=1, rid=i,
                          prompt_tokens=r.prompt_tokens,
                          prefix_id=r.prefix_id, prefix_len=r.prefix_len)
            hit = eng.prefix_stamp(req)
            eng.prefill_batch(PrefillPlan(0, (PrefillItem(
                i, req.prompt_len, hit, req.prompt_len, req=req),),
                bucket_len(req.prompt_len, cap=window)))
    finally:
        engine_mod.sample_slots = plain
    check(hit == target.prefix_hit, f"{phase}: the f32 engine hit {hit} "
          f"lines of request {target.rid}, the serve {target.prefix_hit}")
    toks = torch.as_tensor(target.prompt_tokens, device=dev)
    whole, _ = prefill(cfg32, params32, {"tokens": toks},
                       init_state(cfg32, 1, window, device=dev))
    whole = whole[0].float()
    err, scale = max_err(rows[-1], whole), float(whole.abs().max())
    log(f"{phase}: f32 at full width, request {target.rid} ({target.prompt_len}"
        f" tokens, prefix group {target.prefix_id}): suffix prefill at "
        f"q_offset {hit} over the head gathered from request {donor.rid} "
        f"against the whole-prompt prefill: max |difference| {err:.3e}, max "
        f"|logit| {scale:.3f}, ratio {err / scale:.3e} (limit 1e-3)")
    check(err <= 1e-3 * scale, f"{phase}: suffix-prefill logits differ by "
          f"{err} against max logit {scale}")


def phase_cluster_prefix(torch, params, measured):
    """Phase 9: a shared-prefix stream (the cluster stream's arrival and
    length processes with ``PREFIX_REUSE``) served on the cluster phase's
    weights' first ``PREFIX_LAYERS`` layers with the prefix cache off and
    on, each against a CPU rehearsal at reduced width; returns the kernel
    counts of both serves.  Puts the
    cache-on serve's ms per iteration and spec into ``measured``."""
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.kvstore import PagedStore
    from repro_torch.models import attention as attention_mod
    from repro_torch.scheduling import LiveCluster
    from repro_torch.serving import InstanceEngine
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving import sampling as sampling_mod
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    rehearsal = _serve_traced(_prefix_spec(True, reduced=True, device="cpu"))
    reh = rehearsal.cluster
    log(f"cluster-prefix: {_prefix_spec(True).traffic.describe()}; CPU "
        f"rehearsal at reduced width in {time.perf_counter() - t0:.1f} s: "
        f"{reh.n_iterations} iterations, prefix_hits "
        f"{rehearsal.stats['prefix_hits']}, prefix_hit_tokens "
        f"{rehearsal.stats['prefix_hit_tokens']}")
    check(rehearsal.all_finished and rehearsal.stats["prefix_hits"] > 0,
          f"cluster-prefix: the rehearsal gave no hit: "
          f"{rehearsal.describe()}")
    from repro_torch.configs import get_config
    cut = _depth_cut(get_config("starcoder2-3b"), PREFIX_LAYERS)
    params = _first_layers(params, PREFIX_LAYERS)
    log(f"cluster-prefix: both serves on the first {PREFIX_LAYERS} of 30 "
        f"layers")
    params32 = _tree_map(lambda t: t.float(), params)
    counts, runs = {}, {}
    for cache in (False, True):
        phase = "cluster-prefix" + ("" if cache else " no-cache")
        spec = _prefix_spec(cache)
        finite, restore = _watch_logits(torch, sampling_mod, engine_mod)
        offsets, unwatch = _watch_offsets(attention_mod)
        moved, unrecord = _record_moves(InstanceEngine)
        saved, unsave = _watch_saved(LiveCluster)
        copies, timed, uncopy = _watch_copies(
            torch, PagedStore, PREFIX_REUSE["prefix_len"] if cache else 0)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        try:
            report = _serve_traced(spec, params=params, cfg=cut)
            torch.cuda.synchronize()
        finally:
            for undo in (uncopy, unsave, unrecord, unwatch, restore):
                undo()
        wall = time.perf_counter() - t0
        counts[phase] = read_counts()
        cluster, st = report.cluster, report.stats
        n_it = cluster.n_iterations
        ms_per_it = wall * 1e3 / max(1, n_it)
        runs[cache] = report
        log(f"{phase}: report:\n" + report.describe())
        log(f"{phase}: serve wall {wall:.3f} s, {n_it} iterations, "
            f"{ms_per_it:.3f} ms per iteration, sched_us_per_iter "
            f"{report.sched_us_per_iter:.1f}; "
            + _latency_line(report, ms_per_it))
        log(f"{phase}: prefill tokens computed "
            f"{_prefill_tokens(cluster.planner.trace)} of "
            f"{sum(r.prompt_len for r in cluster._submitted)} prompt tokens; "
            f"prefill kernel launches at q_offset > 0: "
            f"{offsets['q_offset>0']}; launches {counts[phase]}")
        check(report.all_finished and report.n_submitted
              == len(rehearsal.finished), f"{phase}: not every request "
              f"finished: {report.describe()}")
        check(all(len(r.output_tokens) == r.max_new_tokens
                  for r in report.finished),
              f"{phase}: a request ended short of its max_new_tokens")
        check(bool(torch.stack(finite).all()), f"{phase}: non-finite logits")
        for key in ("mirror", "stream"):
            check(st[f"{key}_bytes"] == moved[key],
                  f"{phase}: stats {key}_bytes {st[f'{key}_bytes']} != "
                  f"{moved[key]} priced by LineCosts over "
                  f"{moved[key + '_lines']} lines moved")
        log(f"{phase}: mirror_bytes {st['mirror_bytes']:.0f} over "
            f"{moved['mirror_lines']} lines, stream_bytes "
            f"{st['stream_bytes']:.0f} over {moved['stream_lines']} lines "
            f"({st['stream_skipped_lines']} adopted head lines not moved): "
            f"equal to LineCosts")
        _check_path_counts(counts[phase],
                           ("flash_attention", "paged_decode_attention"),
                           phase)
        if not cache:
            check(st["prefix_hits"] == 0 and not copies,
                  f"{phase}: hits with the cache off: {st}")
            continue
        layers = cluster.cfg.num_layers
        check(st["prefix_hits"] > 0, f"{phase}: no prefix hit")
        for key in ("prefix_hits", "prefix_hit_tokens"):
            check(st[key] == rehearsal.stats[key], f"{phase}: {key} "
                  f"{st[key]} against the rehearsal's "
                  f"{rehearsal.stats[key]}")
        check(n_it == reh.n_iterations
              and cluster.planner.trace == reh.planner.trace
              and cluster.policy.trace == reh.policy.trace,
              f"{phase}: {n_it} iterations, the plan and the kernel traces "
              f"against the rehearsal's {reh.n_iterations}")
        check(offsets["q_offset>0"] >= layers * st["prefix_hits"],
              f"{phase}: {offsets['q_offset>0']} prefill launches at "
              f"q_offset > 0 for {st['prefix_hits']} hits x {layers} layers")
        check(len(copies) == st["prefix_hits"], f"{phase}: "
              f"{len(copies)} copy_prefix calls for {st['prefix_hits']} hits")
        check(max(saved) > 0, f"{phase}: no block was ever shared")
        for eng in cluster.engines:
            led, pc = eng.store.ledger, eng.prefix_cache
            check(set(led._refs) <= set(pc.index.blocks()),
                  f"{phase}: instance {eng.instance_id}: blocks held "
                  f"after the drain by more than the cache")
            freed = pc.release_all()
            check(led.free_blocks() == led.num_blocks,
                  f"{phase}: instance {eng.instance_id}: the pool is not "
                  f"whole after release_all")
            log(f"{phase}: instance {eng.instance_id}: cache stats "
                f"{pc.stats}; release_all freed {freed} blocks, the pool "
                f"is whole ({led.num_blocks} blocks)")
        whole = [nbytes for n, nbytes in copies
                 if n == PREFIX_REUSE["prefix_len"]]
        check(whole and timed, f"{phase}: no hit copied a whole "
              f"{PREFIX_REUSE['prefix_len']}-line head")
        b = _breakdown(1.0, timed["kernels"], top=4)
        per_hit = [f"{n} lines {nbytes / 1e6:.3f} MB" for n, nbytes in copies]
        log(f"{phase}: copy_prefix per hit: " + ", ".join(per_hit))
        device = ("profiler saw no device time: not measured"
                  if b["device_ms"] == 0 else
                  f"{b['device_ms']:.4f} ms device time in "
                  f"{sum(n for _, _, n in b['top'])} kernels (torch.profiler "
                  f"window around it)")
        # the same gather again on the drained store, on the kernels
        # phase's clock (device time; the L2 left warm by the last call)
        replay = time_ms(lambda: PagedStore.copy_prefix(*timed["call"]), 20)
        log(f"{phase}: the first {PREFIX_REUSE['prefix_len']}-line copy "
            f"({whole[0] / 1e6:.3f} MB over "
            f"{len(cluster.engines[0].store._paths)} line leaves): {device}; "
            f"replayed 20 times {replay:.4f} ms each (L2 warm), "
            f"{2 * whole[0] / replay / 1e6:.1f} GB/s read and written "
            f"(bytes bound {_bound(2 * whole[0], 0, 'bfloat16')[0]:.4f} ms)")
        for name, ms, n in b["top"]:
            log(f"{phase}:   {ms:9.4f} ms {n:5d} x {name[:90]}")
        log(f"{phase}: most pool blocks saved by sharing in one engine: "
            f"{max(saved)}; prefix stats equal the rehearsal's: "
            f"prefix_hits {st['prefix_hits']}, prefix_hit_tokens "
            f"{st['prefix_hit_tokens']}")
        measured["prefix_ms_per_iteration"] = ms_per_it
        measured["prefix_spec"] = spec
    off, on = runs[False], runs[True]
    check(on.stats["stream_bytes"] <= off.stats["stream_bytes"],
          f"cluster-prefix: stream bytes {on.stats['stream_bytes']} with the "
          f"cache against {off.stats['stream_bytes']} without")
    phase = "cluster-prefix"
    cfg = on.cluster.cfg
    near = _tokens_against(torch, cfg, params, params32, on.spec.kv_capacity,
                           {r.rid: r for r in off.finished}, on.finished,
                           phase)
    log(f"{phase}: {len(on.finished)} requests' tokens with the cache equal "
        f"the cache-off serve's" + (f" up to {len(near)} near-ties" if near
                                    else ""))
    _suffix_vs_whole_f32(torch, cfg, params32, on.spec,
                         on.cluster._submitted, phase)
    del params32, runs, off, on
    log(f"cluster-prefix: phase {time.perf_counter() - t_phase:.1f} s")
    return counts


def _watch_heads(mod, names):
    """Patch the kernel entries ``names`` of ``mod`` to record each call's
    (heads, KV heads, head dim), and for the prefill kernel whether it was
    causal; returns (seen, restore)."""
    plain = {n: getattr(mod, n) for n in names}
    seen = {n: set() for n in plain}

    def watch(name):
        def watched(q, k, *a, **kw):        # k: (..., KV heads, hd)
            key = (q.shape[-2], k.shape[-2], q.shape[-1])
            if name == "flash_attention_cuda":
                key += (kw.get("causal", True),)
            seen[name].add(key)
            return plain[name](q, k, *a, **kw)
        return watched

    def restore():
        for n, fn in plain.items():
            setattr(mod, n, fn)

    for n in plain:
        setattr(mod, n, watch(n))
    return seen, restore


def phase_minicpm(torch, dev, np):
    """Phase 11: full-width minicpm-2b in bf16 (MHA at head dim 64, tied
    embeddings, residual and logit scales) through the serve phase's six
    requests, then its f32 decode-vs-prefill check; returns the serve's
    kernel counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attention_mod
    from repro_torch.models import init_params
    cfg = get_config("minicpm-2b")
    reckoned = cfg.param_count() * 2
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(6),
                         device=dev)
    torch.cuda.synchronize()
    log(f"serve-minicpm: {cfg.name} full width: {cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}, "
        f"hd {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, tied "
        f"embeddings {cfg.tie_embeddings}, residual scale "
        f"{cfg.residual_scale:.4f}, logit scale {cfg.logit_scale:.4f}, "
        f"{cfg.dtype}; param_count {cfg.param_count()} x 2 bytes = "
        f"{reckoned / 1e9:.3f} GB reckoned, {_weight_bytes(params) / 1e9:.3f}"
        f" GB drawn in {time.perf_counter() - t0:.1f} s")
    from repro_torch.kernels import decode_attention as decode_mod
    heads, restore = _watch_heads(attention_mod, ("flash_attention_cuda",))
    # the model calls the paged kernel through its module
    paged, restore_paged = _watch_heads(decode_mod,
                                        ("paged_decode_attention_cuda",))
    try:
        counts, per_step, (rng, _, _, _) = _serve_six(
            torch, np, cfg, params, dev, "serve-minicpm")
    finally:
        restore()
        restore_paged()
    heads.update(paged)
    want = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    log(f"serve-minicpm: kernel calls at (heads, KV heads, hd[, causal]): "
        f"{ {n: sorted(v) for n, v in heads.items()} }")
    for name, got in heads.items():
        w = want + (True,) if name == "flash_attention_cuda" else want
        check(got == {w}, f"serve-minicpm: {name} ran at {sorted(got)}, "
              f"not only at {w} (G 1, hd 64)")
    _decode_vs_prefill(torch, np, cfg, params, dev, rng,
                       "serve-minicpm consistency")
    return counts, params, per_step


def _long_decode(torch, cfg, params, logits, state, steps, dev):
    """``steps`` greedy long-context decode steps after a
    ``LONG_PROMPT``-token prefill; returns (tokens fed (B, steps), logits
    after each step, wall ms per step)."""
    from repro_torch.models import decode_step
    toks, rows = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for j in range(steps):
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        toks.append(tok)
        t = torch.full((tok.shape[0],), LONG_PROMPT + j, dtype=torch.int32,
                       device=dev)
        logits, state = decode_step(cfg, params, tok, state, t,
                                    long_context=True)
        rows.append(logits)
    torch.cuda.synchronize()
    return (torch.cat(toks, dim=1), rows,
            (time.perf_counter() - t0) * 1e3 / steps)


def phase_long_context(torch, dev, np, cfg, params, per_step_11, card):
    """Phase 30: serve-minicpm's full-width bf16 weights under the
    long-context policy: a two-request state for 524,288 tokens (a ring
    of 8,192 lines, as many bytes as the dry run's meta build of the same
    call), two 12,288-token prompts prefilled through the prefill kernel
    under the 8,192-token window, then 64 greedy decode steps through the
    dense decode kernel over the full ring, past its wrap; no plain
    version and no paged kernel.  Then in f32 on 2 layers the same flow,
    the decode logits at t = 12,288 + j (j = 0, 31, 63) against a fresh
    long-context prefill over the 12,288 + j + 1 tokens within 1e-3 *
    max|logit|; ``sample`` at T = 0 against argmax and at T = 1 with
    top_k 40 inside each row's top 40.  Prints decode ms per step beside
    phase 11's and the dry run's long_500k record for minicpm-2b on the
    single mesh.  Returns the bf16 flow's kernel counts."""
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.launch import dryrun
    from repro_torch.models import (decode_step, init_params, init_state,
                                    prefill)
    from repro_torch.models.state import state_bytes
    from repro_torch.serving import sample
    phase = "long-context"
    B, seq = 2, 524_288
    meta = state_bytes(init_state(cfg, B, seq, long_context=True,
                                  device="meta"))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    state = init_state(cfg, B, seq, long_context=True, device=dev)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - before
    ring = state["layers"][0]["p0"]["k"].shape[2]
    log(f"{phase}: {cfg.name} full width, bf16: init_state({B}, {seq}, "
        f"long_context=True): a ring of {ring} lines; the card allocated "
        f"{allocated:,} B, the dry run's meta build of the same call "
        f"{meta:,} B")
    check(ring == LONG_WINDOW, f"{phase}: ring of {ring} lines, not "
          f"{LONG_WINDOW}")
    check(allocated == meta == state_bytes(state), f"{phase}: the card "
          f"allocated {allocated} B for the state, the meta build {meta} B")

    rng = np.random.default_rng(30)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                           (B, LONG_PROMPT), dtype=np.int32),
                              device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = prefill(cfg, params, {"tokens": prompts}, state,
                            long_context=True)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    _, rows, step_ms = _long_decode(torch, cfg, params, logits, state,
                                    LONG_STEPS, dev)
    counts = read_counts()
    check(all(bool(torch.isfinite(r).all()) for r in rows),
          f"{phase}: non-finite logits")
    log(f"{phase}: prefill of {B} x {LONG_PROMPT} tokens {prefill_ms:.1f} ms "
        f"({B * LONG_PROMPT / prefill_ms * 1e3:.0f} tokens/s); {LONG_STEPS} "
        f"decode steps at {B} active over the {ring}-line ring: "
        f"{step_ms:.3f} ms per step, against serve-minicpm's paged decode "
        + ", ".join(f"{n} active {v:.3f}" for n, v in per_step_11.items())
        + f" ms per step (512-line window); {card}; launches {counts}")
    L = cfg.num_layers
    check(counts["flash_attention"] == {"launches": L, "plain_calls": 0},
          f"{phase}: prefill kernel {counts['flash_attention']}, want {L} "
          f"launches and no plain call")
    check(counts["decode_attention"] == {"launches": L * LONG_STEPS,
                                         "plain_calls": 0},
          f"{phase}: dense decode {counts['decode_attention']}, want "
          f"{L * LONG_STEPS} launches and no plain call")
    check(counts["paged_decode_attention"]["launches"] == 0
          and all(c["plain_calls"] == 0 for c in counts.values()),
          f"{phase}: a paged kernel or a plain version ran: {counts}")
    # where a step's time goes: one more step, timed, then profiled
    t_next = torch.full((B,), LONG_PROMPT + LONG_STEPS, dtype=torch.int32,
                        device=dev)
    tok = rows[-1].argmax(-1).to(torch.int32)[:, None]
    step = lambda: decode_step(cfg, params, tok, state, t_next,
                               long_context=True)
    wall = _wall_ms(torch, step)
    _print_breakdown({"decode 2 active over the ring": _breakdown(
        wall, _device_profile(torch, step))}, phase)

    last = rows[-1]
    greedy = sample(last)
    check(torch.equal(greedy, last.argmax(-1).to(torch.int32)),
          f"{phase}: sample at T = 0 is not argmax")
    gen = torch.Generator(device=dev).manual_seed(30)
    # the row's 40th largest logit: ties with it are in the top 40 too, as
    # the mask keeps every logit not below it
    cutoff = torch.topk(last, 40, dim=-1).values[:, -1]
    for _ in range(16):
        draw = sample(last, temperature=1.0, top_k=40, generator=gen)
        check(bool((last.gather(-1, draw[:, None].long())[:, 0]
                    >= cutoff).all()),
              f"{phase}: a top_k 40 draw fell outside its row's top 40")
    log(f"{phase}: sample at T = 0 equals argmax; 16 draws at T = 1, top_k "
        f"40 each inside its row's top 40 (at or above its 40th largest "
        f"logit)")
    del state, rows, logits

    # -- f32, 2 layers: decode against a fresh long-context prefill -------------
    cfg32 = _depth_cut(cfg, 2, dtype="float32")
    params32 = init_params(cfg32, torch.Generator(device=dev).manual_seed(31),
                           device=dev)
    state = init_state(cfg32, 1, seq, long_context=True, device=dev)
    logits, state = prefill(cfg32, params32, {"tokens": prompts[:1]}, state,
                            long_context=True)
    toks, rows, _ = _long_decode(torch, cfg32, params32, logits, state,
                                 LONG_STEPS, dev)
    for j in (0, 31, 63):
        seq_j = torch.cat([prompts[:1], toks[:, :j + 1]], dim=1)
        fresh, _ = prefill(cfg32, params32, {"tokens": seq_j},
                           init_state(cfg32, 1, seq, long_context=True,
                                      device=dev), long_context=True)
        err, scale = max_err(rows[j], fresh), float(fresh.abs().max())
        log(f"{phase}: f32, 2 layers, t = {LONG_PROMPT} + {j}: max |decode - "
            f"prefill over {seq_j.shape[1]} tokens| {err:.3e}, max |logit| "
            f"{scale:.3f}, ratio {err / scale:.3e} (limit 1e-3)")
        check(err <= 1e-3 * scale, f"{phase}: f32 t = {LONG_PROMPT} + {j} "
              f"differs by {err} against max logit {scale}")
    del params32, state, rows

    rec = dryrun.run_one("minicpm-2b", "long_500k", False, save_trace=False)
    log(f"{phase}: the dry run's long_500k record for minicpm-2b on the "
        f"single mesh (meta device, on the host): {json.dumps(rec)}")
    check(rec["ok"], f"{phase}: the dry run failed: {rec.get('error')}")
    return counts


def phase_sim_calibration(measured, decode_ms_8):
    """Phase 12, on the host: the port's simulator on the cluster phase's
    stream (its WorkloadSpec and seed) with starcoder2-3b on one modeled
    H100 per instance, its dispatch cost set to the serve phase's decode
    ms per step at 8 active, and again at 0 (the pure roofline); the
    modeled TTFT/TBT/JCT beside the measured ones (iterations x the wall
    ms per iteration of the cluster phase's serve on drawn weights).  The
    stream's arrival at iteration i lands at i x that wall time, so both
    see the same arrivals in seconds."""
    from repro_torch.configs import get_config
    from repro_torch.sim import (H100, AcceLLMPolicy, InstanceSpec, PerfModel,
                                 SimRequest, Simulator, summarize)
    spec, reqs = measured["spec"], measured["requests"]
    fields = ("ttft_p50", "ttft_p99", "tbt_mean", "tbt_worst", "jct_p50",
              "jct_p99")
    live = summarize(reqs, spec.n_instances, measured["iterations"])
    models = (("modeled, dispatch = serve decode step", decode_ms_8 / 1e3),
              ("modeled, dispatch 0 (roofline)", 0.0))
    log(f"sim-calibration: starcoder2-3b, InstanceSpec(H100, n_devices=1), "
        f"{spec.n_instances} instances x {spec.num_slots} slots, the cluster "
        f"phase's stream ({len(reqs)} requests); seconds, against the "
        f"cluster phase's serve:")
    ratios = {name: {f: [] for f in fields} for name, _ in models}
    for k, ms_per_it in enumerate(measured["ms_per_iteration"]):
        s_per_it = ms_per_it / 1e3
        rows = {"measured": {f: getattr(live, f) * s_per_it for f in fields}}
        for name, dispatch_s in models:
            perf = PerfModel(get_config(spec.arch),
                             InstanceSpec(H100, n_devices=1,
                                          dispatch_s=dispatch_s))
            sim = Simulator(AcceLLMPolicy(
                fuse_decode_steps=spec.fuse_decode_steps), perf,
                n_instances=spec.n_instances, max_batch=spec.num_slots,
                block_lines=spec.block_lines)
            t0 = time.perf_counter()
            done = sim.run([SimRequest(rid=r.rid, arrival=r.arrival * s_per_it,
                                       prompt_len=r.prompt_len,
                                       decode_len=r.max_new_tokens)
                            for r in spec.traffic.source(seed=spec.seed)])
            check(len(done) == len(reqs), f"sim-calibration: {name}: "
                  f"{len(done)} of {len(reqs)} requests finished")
            summ = summarize(sim.submitted, spec.n_instances, sim.now)
            rows[name] = {f: getattr(summ, f) for f in fields}
            log(f"sim-calibration: run {k + 1}: {name}: dispatch_s "
                f"{dispatch_s:.6f}, {len(done)} requests, modeled "
                f"{sim.now:.3f} s, simulated in "
                f"{time.perf_counter() - t0:.2f} s")
        log(f"sim-calibration: run {k + 1} (arrivals at iteration x "
            f"{ms_per_it:.3f} ms):")
        for name, row in rows.items():
            ratio = ""
            if name != "measured":
                for f in fields:
                    ratios[name][f].append(row[f] / rows["measured"][f])
                ratio = "; modeled / measured " + ", ".join(
                    f"{f} {ratios[name][f][-1]:.3f}" for f in fields)
            log(f"sim-calibration: run {k + 1}: {name}: "
                + ", ".join(f"{f} {row[f]:.4f}" for f in fields) + ratio)
    for name, by_field in ratios.items():
        log(f"sim-calibration: {name}: modeled / measured over "
            f"{len(measured['ms_per_iteration'])} runs, min-max: "
            + ", ".join(f"{f} {min(v):.3f}-{max(v):.3f}"
                        for f, v in by_field.items()))


#: scale: the bursty llama2-70b stream of the scale layer's parity tests
#: (4 instances, 500 s), and the kernels held against their ``-vec`` twins
SCALE_KERNELS = ("accellm", "ulb")


def phase_scale(measured):
    """Phase 13, on the host: the port's simulator on the bursty llama2-70b
    stream under each of ``SCALE_KERNELS`` and its ``-vec`` twin (the
    array-backed cluster state), then on cluster-prefix's stream with the
    prefix cache under accellm and accellm-vec (arrival i at i x the
    cache-on serve's ms per iteration, one modeled H100 per instance).
    The decision traces and the requests' outcomes must be equal; prints
    each run's ``sched_us_per_iter``."""
    from repro_torch.configs import get_config
    from repro_torch.scheduling.registry import get_policy
    from repro_torch.sim import (H100, AcceLLMPolicy, InstanceSpec, PerfModel,
                                 SimRequest, Simulator, ULBPolicy)
    from repro_torch.workloads import Bursty, TableLengths, WorkloadSpec
    policies = {"accellm": AcceLLMPolicy, "ulb": ULBPolicy}

    def run(name, perf, requests, horizon=float("inf"), **kw):
        kernel = get_policy(name)
        kernel.trace = []
        sim = Simulator(policies[name.split("-")[0]](kernel=kernel), perf,
                        **kw)
        t0 = time.perf_counter()
        if isinstance(requests, list):
            sim.run(requests, horizon=horizon)
        else:
            sim.run(source=requests, horizon=horizon)
        wall = time.perf_counter() - t0
        out = [(r.rid, r.generated, r.finish_time, r.prefix_hit)
               for r in sorted(sim.submitted, key=lambda r: r.rid)]
        log(f"scale: {name}: {len(out)} requests, {sim.n_iterations} "
            f"iterations, {len(kernel.trace)} decisions, sched_us_per_iter "
            f"{sim.sched_us_per_iter:.2f}, simulated in {wall:.2f} s"
            + (", array state attached" if sim.policy.arrays is not None
               else ""))
        return kernel.trace, out, sim

    bursty = WorkloadSpec(arrival=Bursty(rate_on=12.0, duration=40.0,
                                         rate_off=2.0, mean_on=6.0,
                                         mean_off=4.0),
                          lengths=TableLengths(workload="mixed"),
                          name="bursty")
    perf = PerfModel(get_config("llama2-70b"), InstanceSpec(H100, 4))
    log(f"scale: llama2-70b on InstanceSpec(H100, 4) x 4 instances, "
        f"{bursty.describe()}, horizon 500 s")
    for name in SCALE_KERNELS:
        tr_s, out_s, _ = run(name, perf, bursty.source(seed=0), 500.0,
                             n_instances=4)
        tr_v, out_v, sim = run(f"{name}-vec", perf, bursty.source(seed=0),
                               500.0, n_instances=4)
        check(sim.policy.arrays is not None, f"scale: {name}-vec ran "
              f"without the array state")
        check(len(tr_s) > 50 and tr_v == tr_s and out_v == out_s,
              f"scale: {name}-vec's decisions or outcomes differ from "
              f"{name}'s ({len(tr_v)} against {len(tr_s)} decisions)")
        log(f"scale: {name}-vec: {len(tr_v)} decisions and "
            f"{len(out_v)} request outcomes equal {name}'s")
    spec = measured["prefix_spec"]
    s_per_it = measured["prefix_ms_per_iteration"] / 1e3
    perf = PerfModel(get_config(spec.arch), InstanceSpec(H100, n_devices=1))
    reqs = list(spec.traffic.source(seed=spec.seed))
    traces = []
    for name in ("accellm", "accellm-vec"):
        sim_reqs = []
        for r in reqs:
            q = SimRequest(rid=r.rid, arrival=r.arrival * s_per_it,
                           prompt_len=r.prompt_len,
                           decode_len=r.max_new_tokens)
            q.prefix_id, q.prefix_len = r.prefix_id, r.prefix_len
            sim_reqs.append(q)
        tr, out, sim = run(name, perf, sim_reqs,
                           n_instances=spec.n_instances,
                           max_batch=spec.num_slots,
                           block_lines=spec.block_lines, prefix_cache=True)
        hits = sum(i.prefix_cache.stats["hits"] for i in sim.instances)
        check(len(out) == len(reqs) and hits > 0, f"scale: {name} on the "
              f"prefix stream: {len(out)} of {len(reqs)} requests, {hits} "
              f"hits")
        traces.append((tr, out, hits))
    check(traces[1] == traces[0], "scale: accellm-vec's decisions on the "
          "prefix stream differ from accellm's")
    log(f"scale: cluster-prefix's stream with the prefix cache "
        f"(arrivals at iteration x {s_per_it * 1e3:.3f} ms): accellm-vec's "
        f"{len(traces[1][0])} decisions, outcomes and {traces[1][2]} hits "
        f"equal accellm's")


def _top2_gap(logits):
    top = logits.float().topk(2).values
    return float(top[0] - top[1]), float(logits.abs().max())


def phase_cluster_consistency(torch, np):
    """Phase 10, f32 at full width, T=0: a 500-token prompt's final chunk
    through a sarathi cluster against the whole-prompt prefill, and six
    prompts through the accellm cluster against one engine."""
    from repro_torch.api import serve
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, init_state, prefill
    from repro_torch.serving import InstanceEngine, Request
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving import sampling as sampling_mod
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("starcoder2-3b"), dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(4),
                         device="cuda")
    rng = np.random.default_rng(5)
    rng_tokens = [rng.integers(0, cfg.vocab_size, (1, 500), dtype=np.int32)
                  for _ in range(7)]

    def request(i, plen, new):
        return Request(prompt_len=plen, max_new_tokens=new, rid=i,
                       prompt_tokens=rng_tokens[i][:, :plen])
    seen = []
    plain_sample = sampling_mod.sample_slots

    def recording(logits, *a, **kw):
        seen.append(logits.detach().clone())
        return plain_sample(logits, *a, **kw)

    sampling_mod.sample_slots = engine_mod.sample_slots = recording
    try:
        # the final chunk's logits against the whole prompt's
        spec = _cluster_spec(policy="sarathi",
                             policy_kwargs={"chunk_tokens": 128},
                             fuse_decode_steps=1)
        rep = serve(spec, requests=[request(6, 500, 2)], cfg=cfg,
                    params=params)
        check(rep.all_finished, "cluster-consistency: the chunked request "
              "did not finish")
        chunk_logits = seen[0][0]
        whole, _ = prefill(cfg, params, {"tokens": torch.as_tensor(
            rng_tokens[6], device="cuda")}, init_state(cfg, 1, 512,
                                                       device="cuda"))
        err = max_err(chunk_logits, whole[0])
        scale = float(whole.abs().max())
        log(f"cluster-consistency: 500-token prompt in chunks of 128 (final "
            f"chunk at q_offset 384): max |chunked - whole| {err:.3e}, max "
            f"|logit| {scale:.3f}, ratio {err / scale:.3e} (limit 1e-3)")
        check(err <= 1e-3 * scale, f"cluster-consistency: final chunk logits "
              f"differ by {err} against max logit {scale}")

        # six prompts: the accellm cluster against one engine
        shapes = [(100, 16), (200, 12), (300, 16), (150, 10), (250, 14),
                  (400, 12)]
        creqs = [request(i, p, n) for i, (p, n) in enumerate(shapes)]
        rep = serve(_cluster_spec(fuse_decode_steps=1), requests=creqs,
                    cfg=cfg, params=params)
        check(rep.all_finished, "cluster-consistency: the cluster run did "
              "not finish")
        eng = InstanceEngine(cfg, params, num_slots=2, kv_capacity=1024,
                             block_lines=16, device="cuda")
        near, faults = [], []
        for i, (p, n) in enumerate(shapes):
            r = request(i, p, n)
            del seen[:]
            eng.prefill_request(r)
            while eng.slot_req:
                eng.decode()
            rows = [x[0] for x in seen]
            for j, (a, b) in enumerate(zip(creqs[i].output_tokens,
                                           r.output_tokens)):
                if a == b:
                    continue
                gap, top = _top2_gap(rows[j])
                (near if gap < 1e-4 * top else faults).append(
                    (i, j, a, b, gap, top))
                break
        for i, j, a, b, gap, top in near + faults:
            log(f"cluster-consistency: request {i} step {j}: cluster token "
                f"{a}, engine token {b}; engine top-2 gap {gap:.3e} of max "
                f"|logit| {top:.3f} ({'near-tie' if gap < 1e-4 * top else 'FAULT'})")
        check(not faults, f"cluster-consistency: tokens differ beyond a "
              f"near-tie: {faults}")
        log(f"cluster-consistency: {len(shapes)} requests, cluster (stats "
            f"{rep.stats}) against one engine: tokens equal"
            + (f" up to {len(near)} near-ties" if near else "")
            + f"; phase {time.perf_counter() - t_phase:.1f} s")
    finally:
        sampling_mod.sample_slots = engine_mod.sample_slots = plain_sample


def _depth_cut(cfg, n, **kw):
    return dataclasses.replace(cfg, num_layers=n,
                               block_pattern=cfg.block_pattern[:n], **kw)


def _first_layers(params, n):
    """Views of a one-segment stack's first ``n`` layers (starcoder2-3b's
    30 attention layers are one segment of 30 repeats)."""
    check(len(params["segments"]) == 1, "a depth cut by views needs one "
          "segment")
    return {**params, "segments": [_tree_map(lambda t: t[:n],
                                             params["segments"][0])]}


def _weight_bytes(params):
    return sum(t.numel() * t.element_size() for t in _leaves(params))


def phase_hybrid(torch, dev, np):
    """Phases 14-15 on Jamba-1.5-Large at full width, depth cut to its first
    5 layers, in bf16; returns the serve phase's kernel counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.models import init_params
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving import sampling as sampling_mod

    # -- 14. serve-hybrid ---------------------------------------------------------
    cfg = _depth_cut(get_config("jamba-1.5-large-398b"), 5)
    mc, moe = cfg.mamba, cfg.moe
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    log(f"serve-hybrid: {cfg.name} full width, depth cut to layers 0-4 "
        f"{cfg.block_pattern} (MoE on {[i for i in range(5) if cfg.layer_is_moe(i)]}): "
        f"d_model {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}, "
        f"hd {cfg.head_dim}, d_ff {cfg.d_ff}, {moe.num_experts} experts "
        f"top-{moe.top_k} d_ff {moe.expert_d_ff}, d_state {mc.d_state}, "
        f"d_conv {mc.d_conv}, expand {mc.expand}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}; param_count {cfg.param_count()}, weights "
        f"{_weight_bytes(params) / 1e9:.3f} GB drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    rng, request, engine, admit = _serving(cfg, params, dev, np, 1, 1024)

    finite, restore = _watch_logits(torch, sampling_mod, engine_mod)
    prompts = [100, 256, 300, 512, 700, 1000]
    reqs = [request(n, 32) for n in prompts]
    eng = engine()
    check(not (eng.supports_paged_decode or eng.supports_chunked_prefill),
          "serve-hybrid: a hybrid engine must not page or chunk")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    admit(eng, reqs)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    decode_steps = 0
    t0 = time.perf_counter()
    while eng.slot_req:
        out = eng.decode_multi(steps=8)
        decode_steps += max(len(t) for t in out.values()) if out else 0
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    counts = read_counts()
    restore()
    check(all(len(r.output_tokens) == 32 for r in reqs),
          f"serve-hybrid: output lengths "
          f"{[len(r.output_tokens) for r in reqs]}")
    check(bool(torch.stack(finite).all()), "serve-hybrid: non-finite logits")
    _check_path_counts(counts, ("mamba_scan", "flash_attention",
                                "decode_attention"), "serve-hybrid")
    log(f"serve-hybrid: 6 requests x 32 tokens done; prefill {sum(prompts)} "
        f"tokens in {prefill_s * 1e3:.1f} ms = "
        f"{sum(prompts) / prefill_s:.0f} tokens/s; {decode_steps} decode "
        f"steps in {decode_s * 1e3:.1f} ms; host_syncs {eng.host_syncs}; "
        f"launches {counts}")
    del eng

    per_step = {}
    for n in (1, 4, 8):
        e = engine()
        admit(e, [request(256, 33) for _ in range(n)])
        e.decode_multi(steps=4)                     # warm this shape
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.decode_multi(steps=8)
        torch.cuda.synchronize()
        per_step[n] = (time.perf_counter() - t0) / 8 * 1e3
        check(e.batch_size == n, f"serve-hybrid: {n}-slot timing lost a "
              f"request")
        del e
    log("serve-hybrid: decode ms per step (256-token prompts, 8 slots "
        "decoded densely): "
        + ", ".join(f"{n} active {v:.3f}" for n, v in per_step.items()))

    # where the time goes: one 512-token prefill, then 8 active x 8 steps
    e = engine()
    admit(e, [request(512, 2)])                      # warm this shape
    e = engine()
    one = [request(512, 40)]
    wall = _wall_ms(torch, lambda: admit(e, one))
    e = engine()
    one = [request(512, 40)]
    breakdown = {"prefill 1x512": _breakdown(
        wall, _device_profile(torch, lambda: admit(e, one)))}
    admit(e, [request(256, 40) for _ in range(7)])
    e.decode_multi(steps=2)
    wall = _wall_ms(torch, lambda: e.decode_multi(steps=8))
    breakdown["decode 8 active x 8 steps"] = _breakdown(
        wall, _device_profile(torch, lambda: e.decode_multi(steps=8)))
    del e
    _print_breakdown(breakdown, "serve-hybrid")

    # -- 15. redundancy-hybrid ---------------------------------------------------
    _redundancy("redundancy-hybrid", engine, rng.integers(
        0, cfg.vocab_size, (1, 300), dtype=np.int32), same_slot=True)
    return counts


def phase_consistency_hybrid(torch, dev, np):
    """Phase 16: f32 decode against a fresh prefill on Jamba's first 3
    layers (mamba; mamba + MoE; mamba) at full width, capacity factor 8
    (= experts / top-k, so no token drops)."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, init_state, prefill
    full = get_config("jamba-1.5-large-398b")
    cfg = _depth_cut(full, 3, dtype="float32", moe=dataclasses.replace(
        full.moe, capacity_factor=8.0))
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(3),
                         device=dev)
    torch.cuda.synchronize()
    log(f"consistency-hybrid: {cfg.block_pattern} in f32, capacity factor "
        f"8.0: weights {_weight_bytes(params) / 1e9:.3f} GB drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(2)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 200),
                                          dtype=np.int32), device=dev)

    def ssm_states(state):
        return [v["ssm"].clone() for seg in state["layers"]
                for v in seg.values()]

    state = init_state(cfg, 1, 256, device=dev)
    logits, state = prefill(cfg, params, {"tokens": prompt}, state)
    gen_toks, dec = [], {}
    for step in range(1, 17):
        tok = logits.argmax(-1).to(torch.int32)
        gen_toks.append(tok)
        logits, state = decode_step(cfg, params, tok[:, None], state,
                                    torch.tensor(200 + step - 1, device=dev))
        if step in (1, 8, 16):
            dec[step] = (logits, ssm_states(state))
    for step, (dl, dssm) in dec.items():
        toks = torch.cat([prompt, torch.stack(gen_toks[:step], dim=1)], dim=1)
        pl, pst = prefill(cfg, params, {"tokens": toks},
                          init_state(cfg, 1, 256, device=dev))
        err = max_err(dl, pl)
        scale = float(pl.abs().max())
        rels = [max_err(a, b) / float(b.abs().max())
                for a, b in zip(dssm, ssm_states(pst))]
        log(f"consistency-hybrid: step {step}: max |decode - prefill| "
            f"{err:.3e}, max |logit| {scale:.3f}, ratio {err / scale:.3e} "
            f"(limit 1e-3); ssm state relative errors "
            f"{', '.join(f'{r:.3e}' for r in rels)} (limit 1e-4)")
        check(err <= 1e-3 * scale, f"consistency-hybrid: step {step} logits "
              f"differ by {err} against max logit {scale}")
        check(max(rels) <= 1e-4, f"consistency-hybrid: step {step} ssm "
              f"states differ by {rels} relative")


# ---------------------------------------------------------------------------
# 17-20: deepseek-v3-671b (MLA) and xlstm-1.3b, outside every kernel
# ---------------------------------------------------------------------------


#: cluster-deepseek: the cluster stream's lengths scaled by this (8
#: requests, prompts and decodes 6-150): a CPU rehearsal of the stream at
#: reduced width takes 187 iterations to 519 at full length, with mirror
#: syncs and promotions
DEEPSEEK_CLUSTER_SCALE = 0.3


def _deepseek(layers=4, dropless=False, **kw):
    """deepseek-v3-671b at its published widths, depth cut to its first
    ``layers`` layers; ``dropless`` sets the capacity factor to experts /
    top-k, so that no expert assignment is ever dropped and a token's
    output does not depend on its batch neighbours."""
    from repro_torch.configs import get_config
    full = get_config("deepseek-v3-671b")
    moe = kw.pop("moe", full.moe)
    if dropless:
        moe = dataclasses.replace(moe, capacity_factor=moe.num_experts
                                  / moe.top_k)
    return _depth_cut(full, layers, moe=moe, **kw)


def _describe_mla(cfg):
    m, moe = cfg.mla, cfg.moe
    return (f"{cfg.name} full width, depth cut to layers "
            f"0-{cfg.num_layers - 1} (MoE on "
            f"{[i for i in range(cfg.num_layers) if cfg.layer_is_moe(i)]}): "
            f"d_model {cfg.d_model}, {cfg.num_heads} heads, MLA q rank "
            f"{m.q_lora_rank}, kv rank {m.kv_lora_rank}, qk "
            f"{m.qk_nope_head_dim}+{m.qk_rope_head_dim}, v {m.v_head_dim}; "
            f"dense d_ff {moe.first_dense_d_ff}, {moe.num_experts} experts "
            f"top-{moe.top_k} d_ff {moe.expert_d_ff} + "
            f"{moe.num_shared_experts} shared, capacity factor "
            f"{moe.capacity_factor}; MTP depth {cfg.mtp_depth}; vocab "
            f"{cfg.vocab_size}, {cfg.dtype}")


def _draw(torch, cfg, seed, dev, phase):
    """Random weights for ``cfg`` from ``seed`` on the card, logged with
    their bytes and the seconds the draw took."""
    from repro_torch.models import init_params
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         device=dev)
    torch.cuda.synchronize()
    log(f"{phase}: weights {_weight_bytes(params) / 1e9:.3f} GB drawn in "
        f"{time.perf_counter() - t0:.1f} s (param_count {cfg.param_count()})")
    return params


def _watch_history(attention_mod):
    """Patch the MLA layer to count the calls that expand cached latent
    rows (``history > 0``, a chunk resume); returns (counter, restore)."""
    plain = attention_mod.mla_forward
    calls = {"history>0": 0}

    def watched(cfg, params, x, **kw):
        if kw.get("history", 0) > 0:
            calls["history>0"] += 1
        return plain(cfg, params, x, **kw)

    def restore():
        attention_mod.mla_forward = plain

    attention_mod.mla_forward = watched
    return calls, restore


def _mla_near_ties(torch, cfg, held, seed, diffs, window, phase):
    """Phase 8's near-tie rule for the depth-cut deepseek, whose weights do
    not fit on the card twice: each differing row's bf16 logits first,
    then the bf16 weights are freed and the same draw is made in f32 and
    rounded to the bf16 values (the router stays f32, as in the bf16
    model); the f32 row is prefilled in 128-token chunks, so the dropless
    dispatch buffer stays small beside 62 GB of weights.  A pair is a
    near-tie when its f32 gap is within twice the row's max |bf16 - f32|.
    ``held`` is a one-element list holding the last reference to the bf16
    weights, which this empties."""
    from repro_torch.models import init_state, prefill, prefill_chunk
    params = held.pop()
    dev = _leaves(params)[0].device
    rows16 = []
    for r, j, a, b in diffs:
        logits, _ = prefill(cfg, params, {"tokens": _with_outputs(
            torch, r, j, dev)}, init_state(cfg, 1, window, device=dev))
        rows16.append(logits[0].float())
    dtypes = [t.dtype for t in _leaves(params)]
    del params
    _free(torch)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = _draw(torch, cfg32, seed, dev, f"{phase} near-tie check")
    for t, dt in zip(_leaves(params32), dtypes):
        if dt != torch.float32:
            t.copy_(t.to(dt).float())
    rows = []
    for (r, j, a, b), row16 in zip(diffs, rows16):
        toks = _with_outputs(torch, r, j, dev)
        state = init_state(cfg32, 1, window, device=dev)
        for lo in range(0, toks.shape[1], 128):
            logits, state = prefill_chunk(cfg32, params32,
                                          toks[:, lo: lo + 128], state,
                                          history=lo)
        rows.append((r.rid, j, a, b, row16, logits[0]))
    return _judge_ties(rows, phase)


def phase_deepseek(torch, dev, np):
    """Phases 17-18 on deepseek-v3-671b at full width, depth cut to layers
    0-3 (three dense layers, the first 256-expert MoE layer), in bf16:
    serve-deepseek, then cluster-deepseek on the same weights; returns
    each path's kernel counts."""
    from repro_torch.api import ServeReport, build_cluster, serve
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.kvstore import LineCosts
    from repro_torch.models import attention as attention_mod
    from repro_torch.serving import InstanceEngine, Request
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving import sampling as sampling_mod
    from repro_torch.workloads import TableLengths

    # -- 17. serve-deepseek -----------------------------------------------------
    t_phase = time.perf_counter()
    seed = 7
    cfg = _deepseek()
    costs = LineCosts.from_config(cfg)
    log(f"serve-deepseek: {_describe_mla(cfg)}; a latent line is "
        f"{costs.line_bytes:.0f} B ({cfg.num_layers} layers x "
        f"{costs.line_bytes / cfg.num_layers:.0f})")
    params = _draw(torch, cfg, seed, dev, "serve-deepseek")
    counts = {}
    counts["serve-deepseek"], per_step, (_, request, engine, admit) = \
        _serve_six(torch, np, cfg, params, dev, "serve-deepseek",
                   window=1024, path_kernels=())
    e = engine()
    check(e.supports_chunked_prefill and not e.supports_paged_decode,
          "serve-deepseek: an MLA engine must chunk and never page")
    # where the time goes: one fused plan of 8 active x 8 steps
    admit(e, [request(256, 40) for _ in range(8)])
    e.decode_multi(steps=2)
    wall = _wall_ms(torch, lambda: e.decode_multi(steps=8))
    _print_breakdown({"decode 8 active x 8 steps": _breakdown(
        wall, _device_profile(torch, lambda: e.decode_multi(steps=8)))},
        "serve-deepseek")
    del e
    log(f"serve-deepseek: phase {time.perf_counter() - t_phase:.1f} s")

    # -- 18. cluster-deepseek ---------------------------------------------------
    t_phase = time.perf_counter()
    # the same weights behind api.serve, dispatch dropless: with capacity
    # factor 1.25 a decode step's 8 rows get 1 slot per expert, and which
    # assignment drops depends on the batch, so no two schedules agree
    ccfg = _deepseek(dropless=True)
    spec = _cluster_spec(arch=cfg.name, traffic=dataclasses.replace(
        _light(120.0), lengths=TableLengths(
            "light", scale=DEEPSEEK_CLUSTER_SCALE)))
    n_req = len(list(spec.traffic.source(seed=spec.seed)))
    log(f"cluster-deepseek: {spec.arch} cut as serve-deepseek, capacity "
        f"factor {ccfg.moe.capacity_factor} (dropless), policy "
        f"{spec.policy}, {spec.n_instances} instances x {spec.num_slots} "
        f"slots, window {spec.kv_capacity}, fuse {spec.fuse_decode_steps}; "
        f"traffic {spec.traffic.describe()}: {n_req} requests")
    finite, restore = _watch_logits(torch, sampling_mod, engine_mod)
    moved, unrecord = _record_moves(InstanceEngine)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    report = serve(spec, cfg=ccfg, params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["cluster-deepseek"] = read_counts()
    unrecord()
    restore()
    n_it = report.cluster.n_iterations
    log("cluster-deepseek: report:\n" + report.describe())
    log(f"cluster-deepseek: serve wall {wall:.3f} s, {n_it} iterations, "
        f"{wall * 1e3 / max(1, n_it):.3f} ms per iteration, "
        f"sched_us_per_iter {report.sched_us_per_iter:.1f}; launches "
        f"{counts['cluster-deepseek']}")
    check(report.all_finished and report.n_submitted == n_req,
          f"cluster-deepseek: not every request finished: "
          f"{report.describe()}")
    check(all(len(r.output_tokens) == r.max_new_tokens
              for r in report.finished),
          "cluster-deepseek: a request ended short of its max_new_tokens")
    check(bool(torch.stack(finite).all()), "cluster-deepseek: non-finite "
          "logits")
    st = report.stats
    check(st["mirror_syncs"] > 0, "cluster-deepseek: no mirror sync")
    check(st["replica_promotions"] > 0, "cluster-deepseek: no promotion")
    for key in ("mirror", "stream"):
        check(st[f"{key}_bytes"] == moved[key],
              f"cluster-deepseek: stats {key}_bytes {st[f'{key}_bytes']} "
              f"!= {moved[key]} priced by LineCosts over "
              f"{moved[key + '_lines']} lines")
    log(f"cluster-deepseek: mirror_bytes {st['mirror_bytes']:.0f} = "
        f"{costs.line_bytes:.0f} B x {moved['mirror_lines']} mirrored lines; "
        f"stream_bytes {st['stream_bytes']:.0f} = {costs.line_bytes:.0f} B "
        f"x {moved['stream_lines']} streamed lines")
    _check_no_kernel(counts["cluster-deepseek"], "cluster-deepseek")
    served = list(report.cluster._submitted)
    del report

    # the same requests through one 8-slot engine, each prefilled alone at
    # its bucket as the cluster's plans prefill it
    eng = InstanceEngine(ccfg, params, num_slots=8, kv_capacity=1024,
                         block_lines=16, device=dev)
    pending = [Request(prompt_len=r.prompt_len, max_new_tokens=r.max_new_tokens,
                       rid=r.rid, prompt_tokens=np.asarray(r.prompt_tokens))
               for r in served]
    alone = {r.rid: r for r in pending}
    t0 = time.perf_counter()
    while pending or eng.slot_req:
        while pending and eng.free_slots():
            eng.prefill_request(pending.pop(0))
        if eng.slot_req:
            eng.decode_multi(steps=8)
    log(f"cluster-deepseek: one engine served the {len(alone)} requests in "
        f"{time.perf_counter() - t0:.1f} s")
    del eng
    diffs = _first_differences(served, alone, "cluster-deepseek")

    # -- 18b. cluster-deepseek-chunked: latent rows expanded at history > 0
    spec = _cluster_spec(arch=cfg.name, policy="sarathi",
                         policy_kwargs={"chunk_tokens": 128},
                         traffic=_light(60.0))
    n_req = len(list(spec.traffic.source(seed=spec.seed)))
    chunked = build_cluster(spec, cfg=ccfg, params=params)
    chunked.planner.trace = []
    resumes, restore = _watch_history(attention_mod)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    finished = chunked.run(max_steps=spec.max_steps, source=spec.traffic.source(
        seed=spec.seed, cfg=chunked.cfg))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["cluster-deepseek-chunked"] = read_counts()
    restore()
    report = ServeReport(spec=spec, cluster=chunked, finished=finished,
                         n_submitted=len(chunked._submitted))
    resumed = [it for e in chunked.planner.trace
               if e[0] in ("prefill", "mixed")
               for it in e[2][0 if e[0] == "mixed" else slice(None)]
               if it[1] > 0]
    log("cluster-deepseek-chunked: sarathi, chunk_tokens 128; report:\n"
        + report.describe())
    log(f"cluster-deepseek-chunked: serve wall {wall:.3f} s, "
        f"{chunked.n_iterations} iterations, "
        f"{wall * 1e3 / max(1, chunked.n_iterations):.3f} ms per iteration, "
        f"sched_us_per_iter {report.sched_us_per_iter:.1f}; {len(resumed)} "
        f"resumed chunks; MLA calls at history > 0: "
        f"{resumes['history>0']}; launches "
        f"{counts['cluster-deepseek-chunked']}")
    check(report.all_finished and len(finished) == n_req,
          f"cluster-deepseek-chunked: not every request finished: "
          f"{report.describe()}")
    check(resumed and resumes["history>0"] >= cfg.num_layers * len(resumed),
          "cluster-deepseek-chunked: no latent rows expanded at history > 0")
    _check_no_kernel(counts["cluster-deepseek-chunked"],
                     "cluster-deepseek-chunked")
    del chunked, report, finished, engine, admit, request

    # tokens: the cluster's against the engine's, up to measured near-ties;
    # the check frees the bf16 weights, so it takes the last reference
    held = [params]
    del params
    near = (_mla_near_ties(torch, ccfg, held, seed, diffs, 1024,
                           "cluster-deepseek") if diffs else [])
    log(f"cluster-deepseek: {len(served)} requests, cluster against one "
        f"engine: tokens equal"
        + (f" up to {len(near)} near-ties" if near else " bitwise")
        + f"; phase {time.perf_counter() - t_phase:.1f} s")
    return counts


def phase_consistency_deepseek(torch, dev, np):
    """Phase 19, f32 at full width on deepseek's layers 0-1 cut as one dense
    and one MoE layer (``first_dense_layers = 1``), dropless: absorbed
    decode against the materialized prefill, and a prompt in chunks (the
    latent rows expanded at history 128) against the whole prompt."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_state, prefill, prefill_chunk
    t_phase = time.perf_counter()
    full = get_config("deepseek-v3-671b")
    cfg = _deepseek(2, dropless=True, dtype="float32", moe=dataclasses.replace(
        full.moe, first_dense_layers=1))
    log(f"consistency-deepseek: {_describe_mla(cfg)}")
    params = _draw(torch, cfg, 9, dev, "consistency-deepseek")
    prompt = _decode_vs_prefill(torch, np, cfg, params, dev,
                                np.random.default_rng(10),
                                "consistency-deepseek", paged=False)
    whole, _ = prefill(cfg, params, {"tokens": prompt},
                       init_state(cfg, 1, 256, device=dev))
    state = init_state(cfg, 1, 256, device=dev)
    for lo, hi in ((0, 128), (128, 200)):
        logits, state = prefill_chunk(cfg, params, prompt[:, lo:hi], state,
                                      history=lo)
    err, scale = max_err(logits, whole), float(whole.abs().max())
    log(f"consistency-deepseek: 200-token prompt in chunks of 128 and 72 "
        f"(the second at history 128): max |chunked - whole| {err:.3e}, max "
        f"|logit| {scale:.3f}, ratio {err / scale:.3e} (limit 1e-3); phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    check(err <= 1e-3 * scale, f"consistency-deepseek: chunked logits differ "
          f"by {err} against max logit {scale}")


#: serve-xlstm: the blocks of its f32 checks (one period of the pattern)
XLSTM_F32_LAYERS = 8
#: serve-xlstm: its bf16 serve's prompts, three of the six: 200 (not a
#: multiple of 64: the stepwise mLSTM at full depth) and 128 and 256
#: (chunkwise); the stepwise 100 and 500 and the 384 cost ~35 s
XLSTM_PROMPTS = (128, 200, 256)
#: serve-xlstm: the prompt behind its decode timings (1, 4 and 8 active,
#: and the profiled 8 x 8 plan): a recurrent stack's decode step costs
#: the same after any prompt, and its prefill runs at ~80 tokens/s, so
#: 256-token prompts cost ~40 s of the phase
XLSTM_TIMING_PROMPT = 16


def phase_xlstm(torch, dev, np):
    """Phase 20: xlstm-1.3b at full width and depth in bf16 through three
    of the serve phase's six requests (``XLSTM_PROMPTS``, one prompt at a
    time, dense decode), then
    its f32 decode-vs-prefill check on the pattern's first
    ``XLSTM_F32_LAYERS`` blocks; returns the serve's kernel counts."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    cfg = get_config("xlstm-1.3b")
    xc = cfg.xlstm
    log(f"serve-xlstm: {cfg.name} full width and depth: {cfg.num_layers} "
        f"blocks ({cfg.block_pattern.count('mlstm')} mLSTM, "
        f"{cfg.block_pattern.count('slstm')} sLSTM), d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads, mLSTM projection {xc.proj_factor_mlstm}, "
        f"sLSTM {xc.proj_factor_slstm}, conv {xc.conv1d_kernel_size}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}")
    params = _draw(torch, cfg, 8, dev, "serve-xlstm")
    counts, _, (_, request, engine, admit) = _serve_six(
        torch, np, cfg, params, dev, "serve-xlstm", path_kernels=(),
        prompts=XLSTM_PROMPTS, timing_prompt=XLSTM_TIMING_PROMPT)
    e = engine()
    check(not (e.supports_paged_decode or e.supports_chunked_prefill),
          "serve-xlstm: an xLSTM engine must neither page nor chunk")
    # where the time goes: one fused plan of 8 active x 8 steps
    admit(e, [request(XLSTM_TIMING_PROMPT, 40) for _ in range(8)])
    e.decode_multi(steps=2)
    wall = _wall_ms(torch, lambda: e.decode_multi(steps=8))
    _print_breakdown({"decode 8 active x 8 steps": _breakdown(
        wall, _device_profile(torch, lambda: e.decode_multi(steps=8)))},
        "serve-xlstm")
    del e, engine, admit, request, params
    _free(torch)
    # the f32 checks on the first XLSTM_F32_LAYERS blocks (one period of
    # the pattern: 7 mLSTM and the sLSTM), drawn in f32
    t_f32 = time.perf_counter()
    cfg32 = _depth_cut(cfg, XLSTM_F32_LAYERS, dtype="float32")
    params32 = _draw(torch, cfg32, 8, dev, "serve-xlstm consistency")
    log(f"serve-xlstm consistency: blocks 0-{XLSTM_F32_LAYERS - 1} "
        f"{cfg32.block_pattern} in f32")
    # a 200-token prompt and its extensions all run the stepwise mLSTM
    _decode_vs_prefill(torch, np, cfg32, params32, dev,
                       np.random.default_rng(11), "serve-xlstm consistency",
                       paged=False)
    # measured, not gated: the chunkwise mLSTM (256 = 4 chunks of 64)
    # against the stepwise one on one prompt; the JAX package's two forms
    # part by ~1e-3 of max|logit| over 48 random-weight blocks
    from repro_torch.models import init_state, prefill
    from repro_torch.models import xlstm as xlstm_mod
    toks = torch.as_tensor(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (1, 256), dtype=np.int32), device=dev)
    rows = []
    for chunk in (xlstm_mod.MLSTM_CHUNK, 1 << 30):
        plain, xlstm_mod.MLSTM_CHUNK = xlstm_mod.MLSTM_CHUNK, chunk
        try:
            logits, _ = prefill(cfg32, params32, {"tokens": toks},
                                init_state(cfg32, 1, 256, device=dev))
        finally:
            xlstm_mod.MLSTM_CHUNK = plain
        rows.append(logits)
    err, scale = max_err(rows[0], rows[1]), float(rows[1].abs().max())
    log(f"serve-xlstm consistency: 256-token prefill over {XLSTM_F32_LAYERS} "
        f"blocks, chunkwise against "
        f"stepwise mLSTM: max |difference| {err:.3e}, max |logit| "
        f"{scale:.3f}, ratio {err / scale:.3e} (measured, not gated)")
    # the same two forms on the first block alone: what one block adds
    from repro_torch.models.common import rms_norm
    block = _tree_map(lambda t: t[0], params32["segments"][0]["p0"])
    x = rms_norm(params32["embed"][toks.long()], block["norm1"],
                 cfg.rms_norm_eps)
    outs = []
    for chunk in (xlstm_mod.MLSTM_CHUNK, 1 << 30):
        plain, xlstm_mod.MLSTM_CHUNK = xlstm_mod.MLSTM_CHUNK, chunk
        try:
            outs.append(xlstm_mod.mlstm_forward(cfg32, block["mixer"], x,
                                                mode="full")[0])
        finally:
            xlstm_mod.MLSTM_CHUNK = plain
    err, scale = max_err(outs[0], outs[1]), float(outs[1].abs().max())
    log(f"serve-xlstm consistency: block 0 alone, chunkwise against "
        f"stepwise: max |difference| {err:.3e}, max |output| {scale:.3f}, "
        f"ratio {err / scale:.3e} (measured, not gated)")
    t_end = time.perf_counter()
    log(f"serve-xlstm: phase {t_end - t_phase:.1f} s: bf16 serve "
        f"{t_f32 - t_phase:.1f} s, f32 checks on {XLSTM_F32_LAYERS} blocks "
        f"{t_end - t_f32:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# 21-23: seamless-m4t-large-v2 (encoder-decoder) and internvl2-1b (vision)
# ---------------------------------------------------------------------------

#: the kernels of an engine that neither pages nor chunks (the
#: encoder-decoder and vision-prefix stacks): prefill and dense decode
DENSE_PATH = ("flash_attention", "decode_attention")
#: the kernel entries the enc-dec and vision phases watch
DENSE_ENTRIES = ("flash_attention_cuda", "decode_attention_cuda")


def phase_encdec_kernels(torch, flash_mod, dense_mod, flush):
    """The prefill and dense decode kernels at the enc-dec and vision
    paths' shapes against their plain versions (bf16 2e-2, f32 1e-4 max
    abs): the prefill kernel non-causal at seamless' encoder shape and at
    ragged Sq != Skv, causal at internvl2-1b's G = 7, hd 64; dense decode
    at hd 64, G = 1 and G = 7, lengths on each side of a split boundary.
    Non-causal bf16 is also held to 0.05 x RMS of the plain output: each
    output averages all Skv values, so its scale is ~sqrt(e / Skv) (0.026
    at 4096), and a kernel that dropped one 64-key tile would move it by
    about a tenth of that, within 2e-2 but not within this limit.
    Returns ((flash max err, timed instances), (dense max err, timed
    instances))."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(3)
    tol = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    flash_cases = [  # (B, Sq, Skv, H, KVH, hd, causal, what)
        (1, 4096, 4096, 16, 16, 64, False,
         "seamless encoder: non-causal over 4096 frames, 16/16 heads, hd 64"),
        (2, 77, 300, 16, 16, 64, False,
         "non-causal, Sq 77 < Skv 300, edges off the tiles"),
        (2, 300, 131, 14, 2, 64, False,
         "non-causal, Sq 300 > Skv 131, G 7, edges off the tiles"),
        (1, 556, 556, 14, 2, 64, True,
         "internvl2-1b: 256 patches + 300 tokens, causal, G 7, hd 64"),
    ]
    flash_err = 0.0
    for B, Sq, Skv, H, KVH, hd, causal, what in flash_cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (randn((B, Sq, H, hd), dtype),
                       randn((B, Skv, KVH, hd), dtype),
                       randn((B, Skv, KVH, hd), dtype))
            out = flash_mod.flash_attention_cuda(q, k, v, causal=causal)
            exp = flash_mod.flash_attention_torch(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = max_err(out, exp)
            lim, rms = tol[dtype], float(exp.float().pow(2).mean().sqrt())
            if dtype == torch.bfloat16 and not causal:
                lim = min(lim, 0.05 * rms)
            log(f"kernels: flash_attention {what} {str(dtype)[6:]}: "
                f"max_abs_err {err:.3e}, RMS of the plain output {rms:.3e} "
                f"(limit {lim:.3e})")
            check(err <= lim, f"flash_attention {what} {dtype}: "
                  f"error {err} above {lim}")
            flash_err = max(flash_err, err)
            del q, k, v, out, exp
    flash_inst = {
        "seamless encoder, non-causal": _time_flash(
            torch, flash_mod, randn, flush, 1, 4096, 4096, 16, 16, 64, None,
            causal=False),
        "internvl2-1b prefill, G 7": _time_flash(
            torch, flash_mod, randn, flush, 1, 556, 556, 14, 2, 64, None)}

    dense_err, dense_inst = 0.0, {}
    for H, KVH, W, label, timed in (
            (16, 16, 512, "seamless decode, G 1",
             [116, 144, 216, 272, 400, 512, 1, 1]),
            (14, 2, 1024, "internvl2-1b decode, G 7",
             [116, 272, 316, 528, 716, 1016, 1, 1])):
        splits, chunk = dense_mod.split_plan(8, KVH, H // KVH, W, sms)
        lengths = [0, 1, chunk - 1, chunk, chunk + 1, 2 * chunk + 1, W - 1,
                   W]
        for dtype in (torch.bfloat16, torch.float32):
            args = (randn((8, 1, H, 64), dtype), randn((8, W, KVH, 64), dtype),
                    randn((8, W, KVH, 64), dtype),
                    torch.tensor(lengths, dtype=torch.int32, device=dev))
            out = dense_mod.decode_attention_cuda(*args)
            exp = dense_mod.decode_attention_torch(*args)
            torch.cuda.synchronize()
            err = max_err(out, exp)
            log(f"kernels: decode_attention {label}: 8 rows, {H}/{KVH} heads, "
                f"hd 64, W {W}, {splits} splits of {chunk} lines, lengths "
                f"{lengths} {str(dtype)[6:]}: max_abs_err {err:.3e} (tol "
                f"{tol[dtype]:.0e})")
            check(err <= tol[dtype], f"decode_attention {label} {dtype}: "
                  f"error {err} above {tol[dtype]}")
            check(float(out[0].abs().max()) == 0.0,
                  "decode_attention: a length-0 row must give 0")
            dense_err = max(dense_err, err)
        dense_inst[label] = _time_dense(torch, dense_mod, randn, flush, timed,
                                        W, H, KVH, 64)
    return (flash_err, flash_inst), (dense_err, dense_inst)


#: long-context (phase 30): minicpm-2b's ring and the prompts it serves
LONG_WINDOW = 8_192
LONG_PROMPT = 12_288
LONG_STEPS = 64


def _row_ratio(out, exp):
    """(worst ratio, max abs error) of ``out`` against ``exp`` row by row,
    a row being everything but the last two dims (heads, hd): each row's
    max abs error over its scale, max |exp| in that row.  A row whose
    expected values are all 0 must come out exactly 0 (ratio inf else)."""
    err = (out.float() - exp.float()).abs().flatten(0, -3).flatten(1)
    row_err = err.amax(dim=1)
    scale = exp.float().abs().flatten(0, -3).flatten(1).amax(dim=1)
    zero = scale == 0
    ratio = (row_err / scale.masked_fill(zero, 1.0)).masked_fill(
        zero, 0.0).masked_fill(zero & (row_err > 0), float("inf"))
    return float(ratio.max()), float(row_err.max())


def phase_long_kernels(torch, flash_mod, dense_mod, flush):
    """The prefill and dense decode kernels at the long-context path's
    shapes (minicpm-2b: 36/36 heads, hd 64) against their plain versions:
    the prefill kernel causal under an 8,192-token window over a
    12,288-token prompt, every one of its rows checked, in twelve
    1,024-row blocks against the plain version at each block's q_offset
    over the keys its window reaches; dense decode over an 8,192-line ring
    at lengths on each side of a split boundary and full.  bf16 (the
    tensor-core kernels the served path launches) is held row by row to
    1e-2 x the row's max |expected|, the expected values being the plain
    version's in f32 on the same bf16 values (a row that sees 8,192 keys
    has values ~0.02, so an absolute limit would not see a dropped tile);
    f32 to 1e-4 max abs.  Returns ((flash max err, timed instances),
    (dense max err, timed instances))."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(4)
    rel_tol, f32_tol, blk = 1e-2, 1e-4, 1024
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    H, hd, S, W = 36, 64, LONG_PROMPT, LONG_WINDOW

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def held(out, exp, dtype, what):
        """Checks ``out`` against ``exp`` (f32) by ``dtype``'s rule and
        returns its max abs error."""
        ratio, err = _row_ratio(out, exp)
        if dtype == torch.bfloat16:
            log(f"{what} bf16: max_abs_err {err:.3e}, worst row err / row "
                f"max|exp| {ratio:.3e} (tol {rel_tol:.0e})")
            check(ratio <= rel_tol, f"{what} bf16: a row's error is "
                  f"{ratio} x its max |expected|, above {rel_tol}")
        else:
            log(f"{what} f32: max_abs_err {err:.3e} (tol {f32_tol:.0e})")
            check(err <= f32_tol, f"{what} f32: error {err} above {f32_tol}")
        return err

    flash_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (randn((1, S, H, hd), dtype) for _ in range(3))
        out = flash_mod.flash_attention_cuda(q, k, v, causal=True, window=W)
        torch.cuda.synchronize()
        errs = []
        for r0 in range(0, S, blk):
            k0 = max(0, r0 - W + 1)
            exp = flash_mod.flash_attention_torch(
                q[:, r0:r0 + blk].float(), k[:, k0:r0 + blk].float(),
                v[:, k0:r0 + blk].float(), causal=True, window=W,
                q_offset=r0 - k0)
            errs.append(held(out[:, r0:r0 + blk], exp, dtype,
                             f"kernels: flash_attention minicpm-2b long "
                             f"context: q rows {r0}-{r0 + blk - 1} of 1 x "
                             f"{S}, window {W}, 36/36 heads, hd 64"))
            del exp
        flash_err = max(flash_err, *errs)
        del q, k, v, out
    flash_inst = {"minicpm-2b long context, window 8192": _time_flash(
        torch, flash_mod, randn, flush, 2, S, S, H, H, hd, W,
        plain_blocks=12)}

    splits, chunk = dense_mod.split_plan(2, H, 1, W, sms)
    dense_err = 0.0
    for lengths in ([W, W], [1, W - 1], [chunk - 1, chunk + 1], [0, W]):
        for dtype in (torch.bfloat16, torch.float32):
            args = (randn((2, 1, H, hd), dtype), randn((2, W, H, hd), dtype),
                    randn((2, W, H, hd), dtype),
                    torch.tensor(lengths, dtype=torch.int32, device=dev))
            out = dense_mod.decode_attention_cuda(*args)
            exp = dense_mod.decode_attention_torch(
                *(a.float() for a in args[:3]), args[3])
            torch.cuda.synchronize()
            dense_err = max(dense_err, held(
                out, exp, dtype, f"kernels: decode_attention minicpm-2b "
                f"ring: 2 rows, 36/36 heads, hd 64, W {W}, {splits} splits "
                f"of {chunk} lines, lengths {lengths}"))
            if lengths[0] == 0:
                check(float(out[0].abs().max()) == 0.0,
                      "decode_attention: a length-0 row must give 0")
    dense_inst = {"minicpm-2b ring W 8192": _time_dense(
        torch, dense_mod, randn, flush, [W, W], W, H, H, hd)}
    return (flash_err, flash_inst), (dense_err, dense_inst)


def phase_mesh_kernels(torch, flash_mod, dense_mod, scan_mod, flush):
    """The kernels at the per-rank shapes of the mesh-families phase
    (tp 2): the scan at jamba's C = 16,384 / 2 = 8,192 channels; dense
    decode at jamba's 64/8 / 2 = 32/4 heads (hd 128), seamless-m4t's
    16/16 / 2 = 8/8 and internvl2-1b's 14/2 / 2 = 7/1 (hd 64), lengths on
    each side of a split boundary; the prefill kernel causal at jamba's
    32/4 and internvl2-1b's 7/1 (256 patches + 256 tokens), non-causal at
    seamless-m4t's encoder (8/8 over 4096 frames).  bf16 is held row by
    row to 1e-2 x the row's max |expected| (the plain version in f32 on
    the same bf16 values), f32 to 1e-4 max abs, the scan (f32) to 1e-4
    relative.  Returns ((flash max err, timed instances), (dense max err,
    timed instances), (scan max err, timed instances))."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(5)
    rel_tol, f32_tol = 1e-2, 1e-4
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def held(out, exp, dtype, what):
        ratio, err = _row_ratio(out, exp)
        if dtype == torch.bfloat16:
            log(f"{what} bf16: max_abs_err {err:.3e}, worst row err / row "
                f"max|exp| {ratio:.3e} (tol {rel_tol:.0e})")
            check(ratio <= rel_tol, f"{what} bf16: a row's error is "
                  f"{ratio} x its max |expected|, above {rel_tol}")
        else:
            log(f"{what} f32: max_abs_err {err:.3e} (tol {f32_tol:.0e})")
            check(err <= f32_tol, f"{what} f32: error {err} above {f32_tol}")
        return err

    flash_err, flash_inst = 0.0, {}
    for label, B, S, H, KVH, hd, causal in (
            ("jamba tp 2 rank prefill, 32/4", 1, 256, 32, 4, 128, True),
            ("seamless encoder tp 2 rank, 8/8", 1, 4096, 8, 8, 64, False),
            ("internvl2-1b tp 2 rank prefill, 7/1", 1, 512, 7, 1, 64,
             True)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (randn((B, S, H, hd), dtype),
                       randn((B, S, KVH, hd), dtype),
                       randn((B, S, KVH, hd), dtype))
            out = flash_mod.flash_attention_cuda(q, k, v, causal=causal)
            exp = flash_mod.flash_attention_torch(q.float(), k.float(),
                                                  v.float(), causal=causal)
            torch.cuda.synchronize()
            flash_err = max(flash_err, held(
                out, exp, dtype, f"kernels: flash_attention {label}: q "
                f"{B}x{S}x{H}x{hd}, {'causal' if causal else 'non-causal'}"))
            del q, k, v, out, exp
        flash_inst[label] = _time_flash(torch, flash_mod, randn, flush, B, S,
                                        S, H, KVH, hd, None, causal=causal)

    dense_err, dense_inst = 0.0, {}
    for label, H, KVH, hd, W in (("jamba tp 2 rank decode, 32/4", 32, 4, 128,
                                  1024),
                                 ("seamless tp 2 rank decode, 8/8", 8, 8, 64,
                                  1024),
                                 ("internvl2-1b tp 2 rank decode, 7/1", 7, 1,
                                  64, 1024)):
        splits, chunk = dense_mod.split_plan(8, KVH, H // KVH, W, sms)
        lengths = [0, 1, chunk - 1, chunk, chunk + 1, 2 * chunk + 1, W - 1,
                   W]
        for dtype in (torch.bfloat16, torch.float32):
            args = (randn((8, 1, H, hd), dtype), randn((8, W, KVH, hd), dtype),
                    randn((8, W, KVH, hd), dtype),
                    torch.tensor(lengths, dtype=torch.int32, device=dev))
            out = dense_mod.decode_attention_cuda(*args)
            exp = dense_mod.decode_attention_torch(
                *(a.float() for a in args[:3]), args[3])
            torch.cuda.synchronize()
            dense_err = max(dense_err, held(
                out, exp, dtype, f"kernels: decode_attention {label}: 8 rows, "
                f"hd {hd}, W {W}, {splits} splits of {chunk} lines, lengths "
                f"{lengths}"))
            check(float(out[0].abs().max()) == 0.0,
                  "decode_attention: a length-0 row must give 0")
        dense_inst[label] = _time_dense(
            torch, dense_mod, randn, flush,
            [140, 160, 180, 200, 220, 240, 1, 1], W, H, KVH, hd)

    def scan_inputs(B, S, C, N):
        return (randn((B, S, C)),
                torch.nn.functional.softplus(randn((B, S, C)) - 1.0),
                randn((B, S, N)), randn((B, S, N)),
                -torch.exp(randn((C, N)) * 0.5), randn((C,)),
                randn((B, C, N)) * 0.1)

    scan_err = 0.0
    for S in (256, 131):
        args = scan_inputs(1, S, 8192, 16)
        y, h = scan_mod.mamba_scan_cuda(*args)
        y_p, h_p = scan_mod.mamba_scan_torch(*args)
        torch.cuda.synchronize()
        for name, a, b in (("y", y, y_p), ("h_final", h, h_p)):
            err = max_err(a, b)
            rel = err / float(b.abs().max())
            log(f"kernels: mamba_scan jamba tp 2 rank, S {S}, C 8192 "
                f"{name}: max_abs_err {err:.3e}, relative {rel:.3e} (tol "
                f"1e-4 relative)")
            check(rel <= 1e-4, f"mamba_scan tp 2 rank S {S} {name}: "
                  f"relative error {rel} above 1e-4")
            scan_err = max(scan_err, err)
    B, S, C, N = 1, 256, 8192, 16
    args = scan_inputs(B, S, C, N)
    s_bytes = 4 * (3 * B * S * C + 2 * B * S * N + C * N + C + 2 * B * C * N)
    s_bound, s_by = _bound(s_bytes, scan_mod.mamba_scan_flops(B, S, C, N),
                           "float32", _sfu_ms(B * S * C * N, sms))
    scan_inst = {"jamba tp 2 rank, S 256, C 8192": {
        "shape": f"B {B}, S {S}, C {C}, N {N}, f32",
        "ms": time_ms(lambda: scan_mod.mamba_scan_cuda(*args), 50, flush),
        "plain_ms": time_ms(lambda: scan_mod.mamba_scan_torch(*args), 3,
                            flush),
        "bound_ms": s_bound, "bound_by": s_by, "library_ms": None}}
    return ((flash_err, flash_inst), (dense_err, dense_inst),
            (scan_err, scan_inst))


def _check_modes(heads, want, phase):
    """The prefill kernel ran at ``want`` heads both causal and not (an
    encoder and a decoder), or causal only when ``want`` says so; the dense
    decode kernel at the same heads."""
    modes = want["modes"]
    log(f"{phase}: kernel calls at (heads, KV heads, hd[, causal]): "
        f"{ {n: sorted(v) for n, v in heads.items()} }")
    check(heads["flash_attention_cuda"] == {want["heads"] + (m,)
                                            for m in modes},
          f"{phase}: prefill kernel calls {heads['flash_attention_cuda']}, "
          f"expected heads {want['heads']} with causal in {modes}")
    check(heads["decode_attention_cuda"] == {want["heads"]},
          f"{phase}: dense decode kernel calls "
          f"{heads['decode_attention_cuda']}, expected {want['heads']}")


def _extra_on(torch, extra, dev):
    return {k: torch.as_tensor(v, device=dev) for k, v in (extra or {}).items()}


def _replay_rows(torch, cfg, params, params32, window, r, j, dev):
    """Request ``r``'s logits before its token ``j`` as an engine computes
    them: a prefill over its prompt and payload, then ``j`` decode steps on
    the engine's clock (``prompt_len + i``) fed its own tokens; in bf16 and
    with the weights upcast to f32."""
    from repro_torch.models import decode_step, init_state, prefill
    batch = {"tokens": torch.as_tensor(r.prompt_tokens, device=dev),
             **_extra_on(torch, r.extra, dev)}
    rows = []
    for c, p in ((cfg, params),
                 (dataclasses.replace(cfg, dtype="float32"), params32)):
        logits, state = prefill(c, p, batch, init_state(c, 1, window,
                                                        device=dev))
        for i in range(j):
            tok = torch.tensor([[int(r.output_tokens[i])]], dtype=torch.int32,
                               device=dev)
            t = torch.tensor([r.prompt_len + i], dtype=torch.int32,
                             device=dev)
            logits, state = decode_step(c, p, tok, state, t)
        rows.append(logits[0].float())
        del state
    return rows


def _short_light():
    """The cluster phase's arrivals (Poisson, 0.1 per iteration over 120
    iterations: 8 requests at seed 0) with Table 2 "light" lengths scaled
    by 0.2 (prompts and decodes 4-100 tokens): ~140 iterations."""
    from repro_torch.workloads import Poisson, TableLengths, WorkloadSpec
    return WorkloadSpec(arrival=Poisson(rate=0.1, duration=120.0),
                        lengths=TableLengths("light", scale=0.2),
                        name="light-short")


def _cluster_and_engine(torch, np, cfg, params, dev, phase, heads_want):
    """The cluster phase's spec through ``api.serve`` under accellm on
    ``cfg``'s weights with a short stream (:func:`_short_light`), each
    request carrying its ``default_extras`` payload, then the same
    requests through one
    8-slot engine: every request must finish with all its tokens, every
    logit be finite, mirror syncs and a promotion or rebalance happen,
    the stream bytes equal ``LineCosts`` over the lines moved plus the
    static state of each streamed request, the mirror bytes the lines
    alone, the prefill and dense decode kernels launch (no plain version)
    at the config's heads, and the tokens equal the engine's up to
    near-ties (phase 8's rule on rows replayed as an engine computes
    them).  Returns the serve's kernel counts."""
    from repro_torch.api import serve
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.kvstore import LineCosts
    from repro_torch.models import attention as attention_mod
    from repro_torch.serving import InstanceEngine, Request
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving import sampling as sampling_mod
    t_phase = time.perf_counter()
    costs = LineCosts.from_config(cfg)
    spec = _cluster_spec(arch=cfg.name, traffic=_short_light())
    n_req = len(list(spec.traffic.source(seed=spec.seed)))
    log(f"{phase}: {spec.arch}, policy {spec.policy}, {spec.n_instances} "
        f"instances x {spec.num_slots} slots, window {spec.kv_capacity}, "
        f"fuse {spec.fuse_decode_steps}; traffic {spec.traffic.describe()}: "
        f"{n_req} requests, payloads from default_extras")
    finite, restore = _watch_logits(torch, sampling_mod, engine_mod)
    moved, unrecord = _record_moves(InstanceEngine)
    heads, unwatch = _watch_heads(attention_mod, DENSE_ENTRIES)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    try:
        report = serve(spec, cfg=cfg, params=params)
        torch.cuda.synchronize()
    finally:
        unwatch()
        unrecord()
        restore()
    wall = time.perf_counter() - t0
    counts = read_counts()
    n_it = report.cluster.n_iterations
    log(f"{phase}: report:\n" + report.describe())
    log(f"{phase}: serve wall {wall:.3f} s, {n_it} iterations, "
        f"{wall * 1e3 / max(1, n_it):.3f} ms per iteration, "
        f"sched_us_per_iter {report.sched_us_per_iter:.1f}; launches {counts}")
    check(report.all_finished and report.n_submitted == n_req,
          f"{phase}: not every request finished: {report.describe()}")
    check(all(len(r.output_tokens) == r.max_new_tokens
              for r in report.finished),
          f"{phase}: a request ended short of its max_new_tokens")
    check(bool(torch.stack(finite).all()), f"{phase}: non-finite logits")
    st = report.stats
    check(st["mirror_syncs"] > 0, f"{phase}: no mirror sync")
    check(st["replica_promotions"] + st["rebalances"] > 0,
          f"{phase}: no promotion or rebalance")
    want_stream = (costs.line_bytes * moved["stream_lines"]
                   + costs.static_bytes * moved["streams"])
    check(st["stream_bytes"] == moved["stream"] == want_stream,
          f"{phase}: stream_bytes {st['stream_bytes']} against {moved['stream']}"
          f" priced by LineCosts, {want_stream} = {costs.line_bytes:.0f} B x "
          f"{moved['stream_lines']} lines + {costs.static_bytes} B x "
          f"{moved['streams']} streams")
    check(st["mirror_bytes"] == moved["mirror"]
          == costs.line_bytes * moved["mirror_lines"],
          f"{phase}: mirror_bytes {st['mirror_bytes']} carry more than "
          f"{moved['mirror_lines']} KV lines")
    log(f"{phase}: stream_bytes {st['stream_bytes']:.0f} = "
        f"{costs.line_bytes:.0f} B x {moved['stream_lines']} lines + "
        f"{costs.static_bytes} B static x {moved['streams']} streams; "
        f"mirror_bytes {st['mirror_bytes']:.0f} = {costs.line_bytes:.0f} B x "
        f"{moved['mirror_lines']} lines, no static byte")
    _check_path_counts(counts, DENSE_PATH, phase)
    _check_modes(heads, heads_want, phase)
    served = list(report.cluster._submitted)
    del report

    eng = InstanceEngine(cfg, params, num_slots=8, kv_capacity=1024,
                         block_lines=16, device=dev)
    pending = [Request(prompt_len=r.prompt_len, max_new_tokens=r.max_new_tokens,
                       rid=r.rid, prompt_tokens=np.asarray(r.prompt_tokens),
                       extra=r.extra) for r in served]
    alone = {r.rid: r for r in pending}
    t0 = time.perf_counter()
    while pending or eng.slot_req:
        while pending and eng.free_slots():
            eng.prefill_request(pending.pop(0))
        if eng.slot_req:
            eng.decode_multi(steps=8)
    log(f"{phase}: one engine served the {len(alone)} requests in "
        f"{time.perf_counter() - t0:.1f} s")
    del eng
    diffs = _first_differences(served, alone, phase)
    near = []
    if diffs:
        params32 = _tree_map(lambda t: t.float(), params)
        rows = [(r.rid, j, a, b) + tuple(_replay_rows(
            torch, cfg, params, params32, 1024, r, j, dev))
            for r, j, a, b in diffs]
        near = _judge_ties(rows, phase)
        del params32
    log(f"{phase}: {len(served)} requests, cluster against one engine: "
        f"tokens equal" + (f" up to {len(near)} near-ties" if near
                           else " bitwise")
        + f"; phase {time.perf_counter() - t_phase:.1f} s")
    return counts


def _prefill_ms(torch, request, engine, n=3):
    """Mean wall ms of one 256-token request's prefill (its payload
    included) into an empty 8-slot engine."""
    e = engine()
    total = 0.0
    for _ in range(n):
        r = request(256, 8)
        total += _wall_ms(torch, lambda: e.prefill_request(r))
        e.release(e.store.rid_slot[r.rid])
    return total / n


def _profile_decode(torch, request, engine, admit, phase):
    """Where a dense decode plan's time goes: 8 active x 8 steps, wall
    unprofiled, device time from torch.profiler; returns the engine."""
    e = engine()
    admit(e, [request(256, 40) for _ in range(8)])
    e.decode_multi(steps=2)
    wall = _wall_ms(torch, lambda: e.decode_multi(steps=8))
    _print_breakdown({"decode 8 active x 8 steps": _breakdown(
        wall, _device_profile(torch, lambda: e.decode_multi(steps=8)))},
        phase)
    return e


def phase_seamless(torch, dev, np):
    """Phases 21-22: seamless-m4t-large-v2 whole in bf16 behind one engine
    (serve-seamless, with its f32 check), then through the cluster
    (cluster-seamless); returns each path's kernel counts."""
    from repro_torch.configs import get_config
    from repro_torch.kvstore import LineCosts
    from repro_torch.models import attention as attention_mod
    from repro_torch.models import model as model_mod
    from repro_torch.models.blocks import _at
    from repro_torch.workloads import default_extras

    # -- 21. serve-seamless --------------------------------------------------
    t_phase = time.perf_counter()
    cfg = get_config("seamless-m4t-large-v2")
    enc, costs = cfg.encoder, LineCosts.from_config(cfg)
    log(f"serve-seamless: {cfg.name} whole: a {enc.num_layers}-layer "
        f"encoder over {enc.max_source_positions} frames of "
        f"{cfg.frontend.embed_dim}, a {cfg.num_layers}-layer decoder with "
        f"cross attention; d_model {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads}, hd {cfg.head_dim}, d_ff "
        f"{cfg.d_ff} ({cfg.activation}), {cfg.abs_pos} positions, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}; a KV line {costs.line_bytes:.0f} B, "
        f"static state {costs.static_bytes} B a request")
    check(costs.static_bytes == 411_041_792 and costs.line_bytes == 98_304,
          f"serve-seamless: LineCosts {costs}")
    params = _draw(torch, cfg, 13, dev, "serve-seamless")
    want = {"heads": (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim),
            "modes": (False, True)}
    heads, unwatch = _watch_heads(attention_mod, DENSE_ENTRIES)
    try:
        counts = {}
        counts["serve-seamless"], per_step, (rng, request, engine, admit) = \
            _serve_six(torch, np, cfg, params, dev, "serve-seamless",
                       path_kernels=DENSE_PATH)
    finally:
        unwatch()
    _check_modes(heads, want, "serve-seamless")
    frames = torch.as_tensor(default_extras(cfg, 0, 0)["frames"], device=dev)
    model_mod._encode(cfg, params, frames)
    enc_ms = min(_wall_ms(torch, lambda: model_mod._encode(cfg, params,
                                                           frames))
                 for _ in range(3))
    log(f"serve-seamless: encoder {enc_ms:.3f} ms per request "
        f"({enc.max_source_positions} frames, best of 3); prefill "
        f"{_prefill_ms(torch, request, engine):.3f} ms per 256-token request "
        f"with its frames (mean of 3)")
    e = _profile_decode(torch, request, engine, admit, "serve-seamless")
    check(not (e.supports_paged_decode or e.supports_chunked_prefill),
          "serve-seamless: an enc-dec engine must neither page nor chunk")
    # cross attention alone over the cached K/V of the 8 active slots: one
    # decode step's worth (every decoder layer), beside the whole step
    x = torch.randn((8, 1, cfg.d_model), device=dev).to(params["embed"].dtype)

    def cross_step():
        for i, seg in enumerate(params["segments"]):
            st_seg = e.store.state["layers"][i]
            for r in range(seg["p0"]["norm1"].shape[0]):
                for pj, lp in _at(seg, r).items():
                    if "cross" in lp:
                        attention_mod.cross_attn_forward(
                            cfg, lp["cross"], x, enc_out=None,
                            state=_at(st_seg, r)[pj])
    cross_step()
    cross_ms = min(_wall_ms(torch, cross_step) for _ in range(3))
    log(f"serve-seamless: cross attention over {enc.max_source_positions} "
        f"cached rows (the plain chunked softmax, as in the JAX package), "
        f"8 slots, all {cfg.num_layers} layers: {cross_ms:.3f} ms per step "
        f"(best of 3), against {per_step[8]:.3f} ms for the whole decode "
        f"step at 8 active: {cross_ms / per_step[8]:.1%}")
    del e, x
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    frames = torch.as_tensor(default_extras(cfg, 0, 1)["frames"], device=dev)
    _decode_vs_prefill(torch, np, cfg32, _tree_map(lambda t: t.float(),
                                                   params), dev, rng,
                       "serve-seamless consistency", paged=False,
                       extra={"frames": frames})
    _free(torch)
    log(f"serve-seamless: phase {time.perf_counter() - t_phase:.1f} s")

    # -- 22. cluster-seamless ------------------------------------------------
    counts["cluster-seamless"] = _cluster_and_engine(
        torch, np, cfg, params, dev, "cluster-seamless", want)
    return counts


def _clock_error(torch, np, cfg, params, dev, rng, patches):
    """Printed, not gated: the engine's clock error on one decode step in
    f32.  A 200-token prompt behind the patches, its greedy token decoded
    at t = S (the clock the engine keeps, as the JAX package's does) and at
    t = P + S, each against a fresh prefill over prompt + token."""
    from repro_torch.models import decode_step, init_state, prefill
    P = patches.shape[1]
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 200),
                                          dtype=np.int32), device=dev)
    batch = {"tokens": prompt, "patch_embeds": patches}
    logits, _ = prefill(cfg, params, batch, init_state(cfg, 1, 1024,
                                                       device=dev))
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    fresh, _ = prefill(cfg, params, {"tokens": torch.cat([prompt, tok], 1),
                                     "patch_embeds": patches},
                       init_state(cfg, 1, 1024, device=dev))
    scale = float(fresh.abs().max())
    out = {}
    for what, t in (("t = S", 200), ("t = P + S", P + 200)):
        _, state = prefill(cfg, params, batch, init_state(cfg, 1, 1024,
                                                          device=dev))
        dl, _ = decode_step(cfg, params, tok, state,
                            torch.tensor([t], dtype=torch.int32, device=dev))
        out[what] = max_err(dl, fresh)
    log(f"serve-internvl consistency: one decode step against a fresh "
        f"prefill, f32, max |logit| {scale:.3f}: "
        + "; ".join(f"at {w} {e:.3e} (ratio {e / scale:.3e})"
                    for w, e in out.items())
        + " (the engine decodes at t = S, as the JAX package's does; "
          "printed, not gated)")


def phase_internvl(torch, dev, np):
    """Phase 23: internvl2-1b whole in bf16 with 256-patch payloads behind
    one engine, then through the cluster, then the model's f32 decode at
    t = P + S against a fresh prefill; returns each path's kernel
    counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attention_mod
    from repro_torch.workloads import default_extras
    t_phase = time.perf_counter()
    cfg = get_config("internvl2-1b")
    fe = cfg.frontend
    log(f"serve-internvl: {cfg.name} whole: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} (G "
        f"{cfg.num_heads // cfg.num_kv_heads}), hd {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, tied embeddings "
        f"{cfg.tie_embeddings}, a {fe.num_prefix_tokens}-patch prefix of "
        f"{fe.embed_dim} through the 2-layer projector, {cfg.dtype}")
    params = _draw(torch, cfg, 14, dev, "serve-internvl")
    want = {"heads": (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim),
            "modes": (True,)}
    heads, unwatch = _watch_heads(attention_mod, DENSE_ENTRIES)
    try:
        counts = {}
        counts["serve-internvl"], _, (rng, request, engine, admit) = \
            _serve_six(torch, np, cfg, params, dev, "serve-internvl",
                       window=1024, path_kernels=DENSE_PATH)
    finally:
        unwatch()
    _check_modes(heads, want, "serve-internvl")
    log(f"serve-internvl: prefill {_prefill_ms(torch, request, engine):.3f} ms "
        f"per 256-token request behind its {fe.num_prefix_tokens} patches "
        f"(mean of 3)")
    e = _profile_decode(torch, request, engine, admit, "serve-internvl")
    check(not (e.supports_paged_decode or e.supports_chunked_prefill),
          "serve-internvl: a vision-prefix engine must neither page nor "
          "chunk")
    del e
    log(f"serve-internvl: phase {time.perf_counter() - t_phase:.1f} s")
    counts["cluster-internvl"] = _cluster_and_engine(
        torch, np, cfg, params, dev, "cluster-internvl", want)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = _tree_map(lambda t: t.float(), params)
    patches = torch.as_tensor(default_extras(cfg, 0, 1)["patch_embeds"],
                              device=dev)
    _decode_vs_prefill(torch, np, cfg32, params32, dev, rng,
                       "serve-internvl consistency", paged=False,
                       extra={"patch_embeds": patches},
                       offset=fe.num_prefix_tokens, window=1024)
    _clock_error(torch, np, cfg32, params32, dev, rng, patches)
    return counts


# ---------------------------------------------------------------------------
# 24-27. training
# ---------------------------------------------------------------------------

#: leaves of minicpm-2b whose step-1 gradient must be nonzero: attention
#: and MLP
ATTN_MLP = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
#: each mixer's input projections (GQA and cross attention, MLA, mLSTM,
#: sLSTM, Mamba): their gradient must be nonzero
INPUT_PROJECTIONS = ("wq", "wk", "wv", "wq_a", "wkv_a", "w_up", "w_z", "w_in",
                     "in_proj")
TRAIN_BATCH, TRAIN_SEQ = 8, 128



def _check_grads(torch, grads, nonzero, phase):
    """Every leaf's grad finite, and each leaf whose last key is in
    ``nonzero`` with a nonzero max |grad|, except under the ``mtp`` head,
    which the loss never reads; returns how many those were."""
    n = 0
    for path, g in _named_leaves(grads):
        check(bool(torch.isfinite(g).all()), f"{phase}: grad of {path} is "
              f"not finite")
        if (path.rsplit("/", 1)[-1] in nonzero
                and not path.startswith("/mtp/")):
            check(float(g.abs().max()) > 0, f"{phase}: grad of {path} is 0")
            n += 1
    return n


def _train_batch(torch, cfg, dev, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    """The first batch of ``batches(DataConfig(seed=0))``, which the
    launcher's loop also takes first, and its data iterator."""
    from repro_torch.training import DataConfig, batches

    def data():
        return batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=0))
    b = torch.from_numpy(next(data())).to(dev)
    return {"tokens": b[:, :-1], "labels": b[:, 1:]}, data


def phase_train_minicpm(torch, dev, np, card):
    """Phase 24: minicpm-2b whole (bf16 weights, f32 AdamW moments), 20 WSD
    steps of 8 x 128 tokens through ``launch/train.py``'s loop.  Step 1's
    gradient: every leaf finite, every attention and MLP leaf nonzero; the
    loss finite and falling; no kernel and no plain version ran.  Prints ms
    per step (forward+backward and optimizer apart), tokens/s and peak
    memory beside the card.  Returns (counts, cfg, trained params); the
    optimizer state is freed."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.launch.train import train_loop
    from repro_torch.training import (AdamWConfig, adamw_update,
                                      init_opt_state, wsd)
    from repro_torch.training.train_step import grads_of
    phase = "train-minicpm"
    t_phase = time.perf_counter()
    cfg = get_config("minicpm-2b")
    steps, tokens = 20, TRAIN_BATCH * TRAIN_SEQ
    log(f"{phase}: {cfg.name} whole: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}, hd "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, tied "
        f"embeddings {cfg.tie_embeddings}, {cfg.dtype} weights, f32 AdamW "
        f"moments; {steps} WSD steps of {TRAIN_BATCH} x {TRAIN_SEQ}")
    params = _draw(torch, cfg, 20, dev, phase)
    opt_cfg = AdamWConfig(lr=1e-3)
    batch, data = _train_batch(torch, cfg, dev)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    _, _, grads = grads_of(cfg, params, batch)
    n = _check_grads(torch, grads, ATTN_MLP, phase)
    least = min(float(g.abs().max()) for p, g in _named_leaves(grads)
                if p.rsplit("/", 1)[-1] in ATTN_MLP)
    log(f"{phase}: step 1's gradient: every leaf finite, {n} attention and "
        f"MLP leaves nonzero (the least max|grad| {least:.3e})")
    del grads
    ends = []

    def record(line):
        ends.append(time.perf_counter())   # the loop has read the loss
        log(f"{phase}: {line}")

    t0 = time.perf_counter()
    params, opt, losses = train_loop(
        cfg, opt_cfg, params, init_opt_state(opt_cfg, params), data(),
        steps=steps, schedule=wsd, warmup=max(steps // 10, 1), extras={},
        device=dev, log_every=1, log=record)
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    _check_no_kernel(counts, phase)
    check(all(np.isfinite(losses)), f"{phase}: losses {losses}")
    check(losses[-1] < losses[0], f"{phase}: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} did not fall")
    per_step = np.diff([t0] + ends) * 1e3
    steady = float(np.median(per_step[1:]))
    fb_ms = _wall_ms(torch, lambda: grads_of(cfg, params, batch))
    grads = grads_of(cfg, params, batch)[2]
    step = lambda: adamw_update(opt_cfg, params, grads, opt, 1.0)
    opt_ms = _wall_ms(torch, step)
    _print_breakdown({
        "forward+backward": _breakdown(fb_ms, _device_profile(
            torch, lambda: grads_of(cfg, params, batch))),
        "optimizer": _breakdown(opt_ms, _device_profile(torch, step))},
        phase)
    del grads, opt, step
    flops = 6 * cfg.param_count() * tokens
    log(f"{phase}: loss {losses[0]:.4f} -> {losses[-1]:.4f}; step 1 "
        f"{per_step[0]:.1f} ms, steps 2-{steps} median {steady:.1f} ms "
        f"(min {per_step[1:].min():.1f}, max {per_step[1:].max():.1f}) = "
        f"{tokens / steady * 1e3:.0f} tokens/s; forward+backward "
        f"{fb_ms:.1f} ms, optimizer {opt_ms:.1f} ms; 6 x params x tokens = "
        f"{flops:.3e} flops = {flops / steady / 1e9:.1f} TFLOP/s "
        f"({flops / steady / 1e9 / (PEAK_FLOPS['bfloat16'] / 1e12):.3f} of "
        f"the bf16 peak); peak memory {peak / 1e9:.3f} GB; {card}")
    log(f"{phase}: phase {time.perf_counter() - t_phase:.1f} s")
    return counts, cfg, params


def phase_train_restore_serve(torch, np, dev, cfg, params):
    """Phase 25: the trained minicpm-2b saved with ``training/checkpoint.py``
    and restored into a fresh tree (bitwise equal), then the serve phase's
    six requests through one engine on the restored params: the prefill and
    paged kernels launch, no plain version runs, and the tokens equal
    serving the trained params in memory.  Returns the restored serve's
    kernel counts."""
    import os
    import shutil
    import tempfile

    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.models import init_params
    from repro_torch.training.checkpoint import restore, save
    phase = "train-restore-serve"
    t_phase = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = os.path.join(tmp, "minicpm-2b.npz")
        free = shutil.disk_usage(tmp).free
        t0 = time.perf_counter()
        save(path, params)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        fresh = init_params(cfg, torch.Generator(device=dev).manual_seed(21),
                            device=dev)
        t0 = time.perf_counter()
        restored = restore(path, fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del fresh
    pairs = _leaf_pairs(params, restored, phase)
    check(all(a.dtype == b.dtype and torch.equal(a, b)
              for _, a, b in pairs),
          f"{phase}: the restored tree differs from the trained one")
    log(f"{phase}: {len(pairs)} leaves saved ({size / 1e9:.3f} GB on disk, "
        f"{free / 1e9:.1f} GB free before) in {save_s:.1f} s and restored in "
        f"{restore_s:.1f} s, bitwise equal")
    tokens = {}
    for name, tree in (("trained", params), ("restored", restored)):
        _, request, engine, admit = _serving(cfg, tree, dev, np, 0, 512)
        reset_counts()
        reqs = _run_six(torch, request, engine, admit, f"{phase} {name}")[0]
        counts = read_counts()
        tokens[name] = [list(r.output_tokens) for r in reqs]
    _check_path_counts(counts, PAGED_PATH, phase)
    check(tokens["restored"] == tokens["trained"],
          f"{phase}: the restored params serve other tokens")
    log(f"{phase}: six requests x 32 tokens equal on the restored and the "
        f"trained params; restored launches {counts}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return counts


def phase_train_grad_check(torch, np, dev):
    """Phase 26: minicpm-2b at full width cut to 2 layers, in f32 (TF32
    off), batch 2 x 128: one ``loss_fn`` gradient on the card against the
    same gradient on the CPU from the same params, every leaf within 1e-4
    x that leaf's max |grad|."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.training.train_step import grads_of
    phase = "train-grad-check"
    cfg = _depth_cut(get_config("minicpm-2b"), 2, dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(22),
                         device="cpu")
    batch = _train_batch(torch, cfg, "cpu", batch=2)[0]
    on_card = lambda tree: _tree_map(lambda t: t.to(dev), tree)
    t0 = time.perf_counter()
    loss_d, _, g_card = grads_of(cfg, on_card(params), on_card(batch))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_h, _, g_cpu = grads_of(cfg, params, batch)
    cpu_s = time.perf_counter() - t0
    worst = (0.0, "")
    for path, a, c in _leaf_pairs(g_cpu, g_card, phase):
        scale = float(a.abs().max())
        ratio = float((a - c.cpu()).abs().max()) / scale if scale else \
            float(c.abs().max())
        check(ratio <= 1e-4, f"{phase}: {path} off by {ratio:.3e} of its "
              f"max |grad|")
        worst = max(worst, (ratio, path))
    log(f"{phase}: {cfg.name} 2 layers, f32, 2 x 128: loss card "
        f"{float(loss_d):.6f} / CPU {float(loss_h):.6f}; every leaf's grad "
        f"within 1e-4 of its max, the worst {worst[0]:.3e} ({worst[1]}); "
        f"card {card_s:.1f} s, CPU {cpu_s:.1f} s")


def phase_train_families(torch, np, dev, card):
    """Phase 27: two bf16 WSD steps each of xlstm-1.3b whole,
    seamless-m4t-large-v2 whole (32 frames), internvl2-1b whole (256
    patches) and deepseek-v3-671b cut to its three dense MLA layers (bf16
    AdamW moments: with f32 ones its out-of-place update does not fit
    80 GB).  Step 1's gradient: every leaf finite, each mixer's input
    projection nonzero (deepseek's unread ``mtp`` leaves exactly zero);
    the losses finite; no kernel ran.  Returns the kernel counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.launch.train import modality_extras, train_loop
    from repro_torch.training import AdamWConfig, init_opt_state, wsd
    from repro_torch.training.train_step import grads_of
    phase = "train-families"
    families = [(get_config("xlstm-1.3b"), "float32"),
                (get_config("seamless-m4t-large-v2"), "float32"),
                (get_config("internvl2-1b"), "float32"),
                (_deepseek(layers=3), "bfloat16")]
    reset_counts()
    for seed, (cfg, state_dtype) in enumerate(families, 30):
        t0 = time.perf_counter()
        tag = f"{phase} {cfg.name}"
        params = _draw(torch, cfg, seed, dev, tag)
        torch.cuda.reset_peak_memory_stats()
        extras = modality_extras(cfg, TRAIN_BATCH, dev)
        batch, data = _train_batch(torch, cfg, dev)
        _, _, grads = grads_of(cfg, params, dict(batch, **extras))
        n = _check_grads(torch, grads, INPUT_PROJECTIONS, tag)
        mtp = [g for p, g in _named_leaves(grads) if p.startswith("/mtp/")]
        check(all(not bool(g.any()) for g in mtp),
              f"{tag}: an mtp leaf has a nonzero grad")
        del grads
        opt_cfg = AdamWConfig(lr=1e-3, state_dtype=state_dtype)
        params, opt, losses = train_loop(
            cfg, opt_cfg, params, init_opt_state(opt_cfg, params), data(),
            steps=2, schedule=wsd, warmup=1, extras=extras, device=dev,
            log_every=1, log=lambda line: log(f"{tag}: {line}"))
        torch.cuda.synchronize()
        check(all(np.isfinite(losses)), f"{tag}: losses {losses}")
        log(f"{tag}: {cfg.num_layers} layers, {_weight_bytes(params) / 1e9:.3f}"
            f" GB of weights, {state_dtype} moments, "
            f"{', '.join(f'{k} {tuple(v.shape)}' for k, v in extras.items()) or 'text only'}; "
            f"{n} input projections nonzero"
            f"{f', {len(mtp)} mtp leaves exactly 0' if mtp else ''}; losses "
            f"{[round(x, 4) for x in losses]}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; "
            f"{time.perf_counter() - t0:.1f} s; {card}")
        del params, opt
        _free(torch)
    counts = read_counts()
    _check_no_kernel(counts, phase)
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from "
              f"a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as decode_mod
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import mamba_scan as scan_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("chip_smoke: TF32 off (torch.backends.cuda.matmul.allow_tf32 = "
        "False, torch.backends.cudnn.allow_tf32 = False)")
    log(f"chip_smoke: python {sys.version.split()[0]}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0].strip())
    dev = torch.device("cuda")
    # a 64 MiB read between timed launches evicts the 50 MB L2 and leaves
    # it clean (a write would leave ~50 MB of dirty lines for the timed
    # launch to write back)
    scratch = torch.zeros(8 << 20, dtype=torch.int64, device=dev)

    def flush():
        scratch.sum()

    # -- 1. build --------------------------------------------------------------
    t0 = time.perf_counter()
    info = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(info)}")
    for name, i in info.items():
        for line in i["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")

    card = smi.splitlines()[0].strip()
    if sys.argv[1:] == ["--mesh-only"]:
        return mesh_only(torch, np, dev, card, flash_mod, decode_mod,
                         scan_mod, flush)

    # -- 2. kernels ------------------------------------------------------------
    kernels = phase_kernels(torch, flash_mod, decode_mod, flush)
    kernels += phase_hybrid_kernels(torch, decode_mod, scan_mod, flush)
    by_name = {r["name"]: r for r in kernels}
    for name, (err, inst) in [
            *zip(("flash_attention", "decode_attention"),
                 phase_encdec_kernels(torch, flash_mod, decode_mod, flush)),
            *zip(("flash_attention", "decode_attention"),
                 phase_long_kernels(torch, flash_mod, decode_mod, flush)),
            *zip(("flash_attention", "decode_attention", "mamba_scan"),
                 phase_mesh_kernels(torch, flash_mod, decode_mod, scan_mod,
                                    flush))]:
        by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], err)
        by_name[name]["instances"].update(inst)
    _log_records(kernels, "scaled_dot_product_attention")
    log("kernels: " + json.dumps([r["name"] for r in kernels]))

    # -- 3-5. starcoder2-3b: serve, consistency, redundancy -----------------------
    counts, per_step, six = phase_dense(torch, dev, np)
    paths = {"serve": counts}
    _free(torch)
    # -- 6-10. starcoder2-3b behind api.serve: cluster, cluster-chunked,
    # cluster-fleet, cluster-prefix, cluster-consistency ---------------------------
    t0 = time.perf_counter()
    counts, measured = phase_cluster(torch, np)
    paths.update(counts)
    _free(torch)
    phase_cluster_consistency(torch, np)
    _free(torch)
    log(f"chip_smoke: cluster phases {time.perf_counter() - t0:.1f} s")
    # -- 11. serve-minicpm, then 30. long-context on its weights --------------
    paths["serve-minicpm"], params, per_step_11 = phase_minicpm(torch, dev,
                                                                np)
    paths["long-context"] = phase_long_context(
        torch, dev, np, get_config("minicpm-2b"), params, per_step_11, card)
    del params
    _free(torch)
    # -- 12. sim-calibration (host only) ------------------------------------------
    phase_sim_calibration(measured, per_step[8])
    # -- 13. scale (host only) -------------------------------------------------------
    phase_scale(measured)
    # -- 14-15. Jamba, depth-cut, bf16: serve-hybrid, redundancy-hybrid -----------
    paths["serve-hybrid"] = phase_hybrid(torch, dev, np)
    _free(torch)
    # -- 16. consistency-hybrid (f32) --------------------------------------------
    phase_consistency_hybrid(torch, dev, np)
    _free(torch)
    # -- 17-18. deepseek-v3-671b, depth-cut, bf16: serve-deepseek,
    # cluster-deepseek ----------------------------------------------------------
    paths.update(phase_deepseek(torch, dev, np))
    _free(torch)
    # -- 19. consistency-deepseek (f32) -------------------------------------------
    phase_consistency_deepseek(torch, dev, np)
    _free(torch)
    # -- 20. serve-xlstm -----------------------------------------------------------
    paths["serve-xlstm"] = phase_xlstm(torch, dev, np)
    _free(torch)
    # -- 21-22. seamless-m4t-large-v2 whole: serve-seamless, cluster-seamless ----
    paths.update(phase_seamless(torch, dev, np))
    _free(torch)
    # -- 23. internvl2-1b whole: serve-internvl (one engine, the cluster) -----
    paths.update(phase_internvl(torch, dev, np))
    _free(torch)
    # -- 24-25. minicpm-2b whole: train-minicpm, train-restore-serve -------------
    paths["train-minicpm"], cfg, params = phase_train_minicpm(torch, dev, np,
                                                              card)
    _free(torch)
    paths["train-restore-serve"] = phase_train_restore_serve(torch, np, dev,
                                                             cfg, params)
    del params
    _free(torch)
    # -- 26. train-grad-check (f32, card against CPU) -------------------------------
    phase_train_grad_check(torch, np, dev)
    _free(torch)
    # -- 27. train-families --------------------------------------------------------
    paths["train-families"] = phase_train_families(torch, np, dev, card)
    _free(torch)
    # -- 28-29. starcoder2-3b on a world of two ranks: mesh-engine, mesh-cluster
    paths.update(phase_mesh(torch, np, six, per_step[8], card))
    _free(torch)
    # -- 31-32. the other stacks on a mesh: mesh-families,
    # mesh-cluster-hybrid ---------------------------------------------------------
    t0 = time.perf_counter()
    paths.update(phase_mesh_families(torch, np, card))
    log(f"mesh-families: phase {time.perf_counter() - t0:.1f} s")
    _free(torch)
    t0 = time.perf_counter()
    paths.update(phase_mesh_cluster_hybrid(torch, np, card))
    log(f"mesh-cluster-hybrid: phase {time.perf_counter() - t0:.1f} s")
    _free(torch)
    # -- 33. train-mesh: the sharded train step on a (data 2, model 2) world
    paths["train-mesh"] = phase_train_mesh(torch, np, card)
    _free(torch)
    # -- 34. mesh-partial: tp 4 where the query heads do not divide it
    paths.update(phase_mesh_partial(torch, np, card))

    for r in kernels:
        r["launches_by_path"] = {p: c[r["name"]]["launches"]
                                 for p, c in paths.items()}
        r["launches"] = sum(r["launches_by_path"].values())
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


#: mesh-engine and mesh-cluster: ranks of the world, every one on card 0
MESH_WORLD = 2
#: seconds each mesh phase's world may take
MESH_TIMEOUT = 420.0
#: seconds the mesh-families world may take (five stacks)
MESH_FAMILIES_TIMEOUT = 600.0


def _mesh_light():
    """The cluster phase's arrival process over 90 iterations (6 requests
    at seed 0) with Table 2 "light" lengths scaled by 0.2 (prompts 11-97,
    decodes 4-93 tokens)."""
    from repro_torch.workloads import Poisson, TableLengths, WorkloadSpec
    return WorkloadSpec(arrival=Poisson(rate=0.1, duration=90.0),
                        lengths=TableLengths("light", scale=0.2),
                        name="light-mesh")


@contextlib.contextmanager
def _seq_parallel():
    """``REPRO_SEQ_PARALLEL=1`` (sequence parallelism) while active."""
    os.environ["REPRO_SEQ_PARALLEL"] = "1"
    try:
        yield
    finally:
        os.environ.pop("REPRO_SEQ_PARALLEL", None)


@contextlib.contextmanager
def _collectives(calls):
    """Count the collectives of the port's ``sharding`` by (kind, axis)
    into ``calls`` while active: the kind each stands for, which on gloo
    with CUDA tensors runs as an all-reduce."""
    from repro_torch import sharding
    plain = sharding._issue

    def counted(kind, axis, *args, **kw):
        calls[kind, axis] = calls.get((kind, axis), 0) + 1
        return plain(kind, axis, *args, **kw)

    sharding._issue = counted
    try:
        yield calls
    finally:
        sharding._issue = plain


def _by_kind(calls, per=1):
    return ", ".join(f"{k} over {a} {n / per:g}"
                     for (k, a), n in sorted(calls.items()))


def _rank_setup(device="cuda"):
    """A rank of a mesh phase: TF32 off, as in the parent."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch, torch.device(device)


def mesh_engine_rank(rank, world, window):
    """Phase 28 on one rank: full-width starcoder2-3b in bf16 from the
    serve phase's seed, one engine on a slice of every rank; the serve
    phase's six requests (the same prompts), this rank's kernel counts and
    pool bytes, decode ms per step at 8 active, and an f32 check at 2
    layers of the sharded logits against the whole model's.  Then the
    same with ``REPRO_SEQ_PARALLEL=1`` (sequence parallelism): the six
    requests again, with their kernel counts and collectives, and the f32
    prefill against the flag-off and whole ones."""
    import numpy as np
    from repro_torch import sharding
    from repro_torch.configs import get_config
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.meshserve import carve_slices
    from repro_torch.meshserve.pool import local_state, shard_params
    from repro_torch.models import (decode_step_paged, init_params,
                                    init_state, prefill)
    from repro_torch.models.state import state_bytes
    from repro_torch.serving import Request
    torch, dev = _rank_setup()
    cfg = get_config("starcoder2-3b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    (sl,) = carve_slices(world, 1)
    rng, request, engine, admit = _serving(cfg, params, dev, np, 0, window,
                                           mesh=sl)
    torch.cuda.synchronize()
    reset_counts()
    reqs, eng, prefill_s, decode_s, steps = _run_six(
        torch, request, engine, admit, "mesh-engine")
    counts = read_counts()
    out = {"requests": [(np.asarray(r.prompt_tokens), list(r.output_tokens))
                        for r in reqs],
           "counts": counts, "pool": eng.state_bytes(),
           "whole": state_bytes(init_state(cfg, 8, window, device="meta")),
           "prefill_s": prefill_s, "decode_s": decode_s, "steps": steps}
    del eng
    e = engine()
    admit(e, [request(256, 33) for _ in range(8)])
    e.decode_multi(steps=8)                               # warm this shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e.decode_multi(steps=8)
    e.decode_multi(steps=8)
    torch.cuda.synchronize()
    out["ms_8"] = (time.perf_counter() - t0) / 16 * 1e3
    del e

    # the same six prompts under sequence parallelism
    again = iter(reqs)

    def same(plen, new):
        r = next(again)
        return Request(prompt_len=r.prompt_len, max_new_tokens=new,
                       prompt_tokens=r.prompt_tokens, extra=r.extra)

    calls = {}
    with _seq_parallel(), _collectives(calls):
        torch.cuda.synchronize()
        reset_counts()
        sp, eng, prefill_s, decode_s, steps = _run_six(
            torch, same, engine, admit, "mesh-engine sequence-parallel")
        out["sp"] = {"tokens": [list(r.output_tokens) for r in sp],
                     "counts": read_counts(), "calls": dict(calls),
                     "prefill_s": prefill_s, "decode_s": decode_s,
                     "steps": steps}
    del eng, engine, admit, request, params
    _free(torch)

    # f32 at 2 layers: the sharded prefill and paged decode against the
    # whole model's, on the whole model's greedy tokens
    cfg2 = _depth_cut(cfg, 2, dtype="float32")
    p32 = init_params(cfg2, torch.Generator(device=dev).manual_seed(0),
                      device=dev)
    mine = shard_params(cfg2, p32, sl)
    st1 = init_state(cfg2, 1, 256, device=dev)
    st2 = local_state(cfg2, sl, 1, 256)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 200),
                                          dtype=np.int32), device=dev)
    l1, st1 = prefill(cfg2, p32, {"tokens": prompt}, st1)
    calls = {}
    with sharding.use_mesh(sl.group), _collectives(calls):
        l2, st2 = prefill(cfg2, mine, {"tokens": prompt}, st2)
    sp_calls = {}
    with _seq_parallel(), sharding.use_mesh(sl.group), \
            _collectives(sp_calls):
        l3, _ = prefill(cfg2, mine, {"tokens": prompt},
                        local_state(cfg2, sl, 1, 256))
    out["sp_f32"] = (float((l3 - l2).abs().max()),
                     float((l3 - l1).abs().max()), float(l1.abs().max()))
    out["prefill_calls"] = (calls, sp_calls)
    rows = [(l1, l2)]
    tables = torch.arange(16, dtype=torch.int32, device=dev)[None]
    slots = torch.zeros((1,), dtype=torch.int32, device=dev)
    for step in range(1, 9):
        tok = rows[-1][0].argmax(-1).to(torch.int32)[:, None]
        t = torch.full((1,), 199 + step, dtype=torch.int32, device=dev)
        l1, st1 = decode_step_paged(cfg2, p32, tok, st1, t, slots, tables, 16)
        with sharding.use_mesh(sl.group):
            l2, st2 = decode_step_paged(cfg2, mine, tok, st2, t, slots,
                                        tables, 16)
        rows.append((l1, l2))
    out["f32"] = [(float((a - b).abs().max()), float(a.abs().max()))
                  for a, b in rows]
    return out


def mesh_cluster_rank(rank, world, spec, cfg=None):
    """Phase 29 (and 32, with ``cfg``) on one rank: ``spec`` (the cluster
    phase's, on the mesh stream, ``mesh_tp=1``) through
    ``api.build_cluster`` and the cluster's run, as ``api.serve`` runs it,
    with the kernel's decision trace on; returns what every rank must agree
    on and what it moved."""
    from repro_torch.api import build_cluster
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.meshserve import STATS
    from repro_torch.serving import InstanceEngine
    torch, _ = _rank_setup()
    moved, unrecord = _record_moves(InstanceEngine)
    cluster = build_cluster(spec, cfg=cfg)
    cluster.policy.trace = []
    torch.cuda.synchronize()
    STATS.reset()
    reset_counts()
    t0 = time.perf_counter()
    finished = cluster.run(max_steps=spec.max_steps,
                           source=spec.traffic.source(seed=spec.seed,
                                                      cfg=cluster.cfg))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    unrecord()
    return {"stats": dict(cluster.stats), "trace": cluster.policy.trace,
            "finished": len(finished), "submitted": len(cluster._submitted),
            "whole": all(len(r.output_tokens) == r.max_new_tokens
                         for r in finished),
            "tokens": sorted((r.rid, tuple(r.output_tokens))
                             for r in finished),
            "moved": dict(moved), "counts": counts, "wall": wall,
            "iterations": cluster.n_iterations,
            "transfers": (STATS.d2d_copies, STATS.d2d_bytes,
                          STATS.host_copies, STATS.host_bytes),
            "pool": [e.state_bytes() for e in cluster.engines]}


def _sum_counts(ranks):
    out = {}
    for r in ranks:
        for name, c in r["counts"].items():
            acc = out.setdefault(name, {"launches": 0, "plain_calls": 0})
            for key in acc:
                acc[key] += c[key]
    return out


def phase_mesh(torch, np, six, ms_tp1, card):
    """Phases 28-29: full-width starcoder2-3b on a world of
    ``MESH_WORLD`` processes, all on this one card over gloo; returns each
    phase's kernel counts summed over the ranks.  ``six`` are the serve
    phase's requests and ``ms_tp1`` its decode ms per step at 8 active."""
    from repro_torch.api import build_cluster
    from repro_torch.meshserve.world import spawn
    staging = ("gloo stages every CUDA collective through the host: these "
               "phases check the sharded compute and the kernels at per-rank "
               "heads, not a card-to-card wire")
    counts = {}

    # -- 28. mesh-engine -------------------------------------------------------------
    phase = "mesh-engine"
    window = 512
    t0 = time.perf_counter()
    ranks = spawn("chip_smoke:mesh_engine_rank", MESH_WORLD, device="cuda",
                  share_card=True, args=(window,), timeout=MESH_TIMEOUT,
                  threads=2)
    log(f"{phase}: {MESH_WORLD} ranks on card 0 in "
        f"{time.perf_counter() - t0:.1f} s; {staging}")
    for r, out in enumerate(ranks):
        _check_path_counts(out["counts"], PAGED_PATH, f"{phase} rank {r}")
        check(out["pool"] * MESH_WORLD == out["whole"],
              f"{phase} rank {r}: K/V pool {out['pool']} B, not 1/"
              f"{MESH_WORLD} of tp 1's {out['whole']} B")
        for step, (err, scale) in enumerate(out["f32"]):
            check(err <= 1e-3 * scale, f"{phase} rank {r}: f32 step {step} "
                  f"differs by {err} against max logit {scale}")
        log(f"{phase} rank {r}: prefill {out['prefill_s'] * 1e3:.1f} ms, "
            f"{out['steps']} decode steps in {out['decode_s'] * 1e3:.1f} ms; "
            f"K/V pool {out['pool']} B of tp 1's {out['whole']} B; f32 at 2 "
            f"layers max |tp {MESH_WORLD} - tp 1| / max|logit| "
            f"{max(e / s for e, s in out['f32']):.3e} (limit 1e-3) over "
            f"prefill + 8 decode steps; launches {out['counts']}")
    sp_phase = f"{phase} sequence-parallel"
    for r, out in enumerate(ranks):
        sp = out["sp"]
        _check_path_counts(sp["counts"], PAGED_PATH, f"{sp_phase} rank {r}")
        # the flag-off tp 2 prefill is itself ~1.4e-6 of max|logit| from
        # the whole model's (its sums run in another order): the flag may
        # add at most 1e-6 to that
        to_off, to_whole, scale = out["sp_f32"]
        off_whole = out["f32"][0][0]
        for what, err, limit in (("flag-off", to_off, 1e-6 * scale),
                                 ("whole", to_whole,
                                  off_whole + 1e-6 * scale)):
            check(err <= limit, f"{sp_phase} rank {r}: f32 prefill {err} "
                  f"from the {what} logits, limit {limit} (max logit "
                  f"{scale})")
        off, on = out["prefill_calls"]
        check(("all-reduce", "model") in off
              and ("all-reduce", "model") not in on
              and {("reduce-scatter", "model"), ("all-gather", "model")}
              <= set(on), f"{sp_phase} rank {r}: prefill collectives "
              f"{on} against the flag-off {off}")
        log(f"{sp_phase} rank {r}: prefill {sp['prefill_s'] * 1e3:.1f} ms, "
            f"{sp['steps']} decode steps in {sp['decode_s'] * 1e3:.1f} ms; "
            f"flash launches {sp['counts']['flash_attention']['launches']}, "
            f"launches {sp['counts']}; the serve's collectives "
            f"{_by_kind(sp['calls'])}; f32 prefill at 2 layers (200 tokens) "
            f"max |sp - flag-off| / max|logit| {to_off / scale:.3e} (limit "
            f"1e-6), |sp - tp 1| {to_whole / scale:.3e} against the "
            f"flag-off |tp 2 - tp 1| {off_whole / scale:.3e} (limit: that "
            f"+ 1e-6); its collectives {_by_kind(on)}, flag off "
            f"{_by_kind(off)}")
    check(all([t for _, t in o["requests"]]
              == [t for _, t in ranks[0]["requests"]]
              and o["sp"]["tokens"] == ranks[0]["sp"]["tokens"]
              for o in ranks), f"{phase}: the ranks' tokens differ")
    got = [SimpleNamespace(rid=ref.rid, prompt_tokens=p, output_tokens=t)
           for ref, (p, t) in zip(six, ranks[0]["requests"])]
    sp_got = [SimpleNamespace(rid=g.rid, prompt_tokens=g.prompt_tokens,
                              output_tokens=t)
              for g, t in zip(got, ranks[0]["sp"]["tokens"])]
    check(all(len(t) == 32 for _, t in ranks[0]["requests"]),
          f"{phase}: a request ended short")
    reference = {r.rid: r for r in six}
    flag_off = {g.rid: g for g in got}
    near = sp_near = []
    if (_first_differences(got, reference, phase)
            or _first_differences(sp_got, flag_off, sp_phase)):
        from repro_torch.configs import get_config
        from repro_torch.models import init_params
        dev = torch.device("cuda")
        cfg = get_config("starcoder2-3b")
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
        params32 = _tree_map(lambda t: t.float(), params)
        near = _tokens_against(torch, cfg, params, params32, window,
                               reference, got, phase)
        sp_near = _tokens_against(torch, cfg, params, params32, window,
                                  flag_off, sp_got, sp_phase)
        del params, params32
        _free(torch)
    log(f"{phase}: tokens equal the serve phase's one-device tokens"
        + (f" up to {len(near)} near-ties" if near else ""))
    log(f"{sp_phase}: tokens equal the flag-off tokens"
        + (f" up to {len(sp_near)} near-ties" if sp_near else "")
        + f"; {card}")
    log(f"{phase}: decode ms per step at 8 active (256-token prompts, "
        f"steps=8): tp 1 {ms_tp1:.3f} (serve phase, one process), tp "
        f"{MESH_WORLD} " + ", ".join(f"rank {r} {o['ms_8']:.3f}"
                                     for r, o in enumerate(ranks))
        + f"; {card}; {staging}")
    counts[phase] = _sum_counts(ranks)
    counts[sp_phase] = _sum_counts([o["sp"] for o in ranks])
    del ranks

    # -- 29. mesh-cluster --------------------------------------------------------------
    phase = "mesh-cluster"
    spec = _cluster_spec(traffic=_mesh_light())
    one = build_cluster(spec)
    one.policy.trace = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one.run(max_steps=spec.max_steps, source=spec.traffic.source(
        seed=spec.seed, cfg=one.cfg))
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t0
    one_stats, one_trace, one_it = (dict(one.stats), one.policy.trace,
                                    one.n_iterations)
    del one
    _free(torch)
    t0 = time.perf_counter()
    ranks = spawn("chip_smoke:mesh_cluster_rank", MESH_WORLD, device="cuda",
                  share_card=True,
                  args=(dataclasses.replace(spec, mesh_tp=1),),
                  timeout=MESH_TIMEOUT, threads=2)
    log(f"{phase}: {spec.n_instances} instances, one rank each, on card 0 "
        f"in {time.perf_counter() - t0:.1f} s; traffic "
        f"{spec.traffic.describe()}")
    for key in ("stats", "trace", "tokens", "iterations", "moved"):
        check(all(o[key] == ranks[0][key] for o in ranks),
              f"{phase}: the ranks' {key} differ")
    out = ranks[0]
    st = out["stats"]
    check(out["finished"] == out["submitted"] and out["whole"],
          f"{phase}: {out['finished']} of {out['submitted']} requests "
          f"finished whole")
    check(st["mirror_syncs"] > 0, f"{phase}: no mirror sync")
    for key in ("mirror", "stream"):
        check(st[f"{key}_bytes"] == out["moved"][key],
              f"{phase}: stats {key}_bytes {st[f'{key}_bytes']} != "
              f"{out['moved'][key]} priced by LineCosts over "
              f"{out['moved'][key + '_lines']} lines")
    for r, o in enumerate(ranks):
        # gloo on CUDA tensors stages every broadcast through the host,
        # so every hop must be counted as a host copy, none as d2d
        d2d, d2d_bytes, host, host_bytes = o["transfers"]
        check(host > 0 and host_bytes > 0 and d2d == d2d_bytes == 0,
              f"{phase} rank {r}: {d2d} device-to-device hops "
              f"({d2d_bytes} B) and {host} host copies ({host_bytes} B) "
              f"over gloo, where every hop stages through the host")
        _check_path_counts(o["counts"], PAGED_PATH, f"{phase} rank {r}")
        log(f"{phase} rank {r}: {host} cross-slice hops, {host_bytes} B, "
            f"all counted as host copies (gloo stages them), {d2d} "
            f"device-to-device; pools {o['pool']} B; wall "
            f"{o['wall']:.3f} s, {o['wall'] * 1e3 / o['iterations']:.3f} ms "
            f"per iteration; launches {o['counts']}")
    for key in ("mirror_syncs", "mirror_bytes", "stream_bytes",
                "replica_promotions", "prefills", "decode_steps"):
        check(st[key] == one_stats[key], f"{phase}: {key} {st[key]} against "
              f"the one-process cluster's {one_stats[key]}")
    check(out["trace"] == one_trace,
          f"{phase}: the decision trace differs from the one-process one's")
    check(out["iterations"] == one_it, f"{phase}: {out['iterations']} "
          f"iterations against the one-process cluster's {one_it}")
    log(f"{phase}: stats {st}; mirror_bytes {st['mirror_bytes']:.0f} = "
        f"LineCosts over {out['moved']['mirror_lines']} lines, stream_bytes "
        f"{st['stream_bytes']:.0f} over {out['moved']['stream_lines']}; "
        f"equal to the one-process cluster's, whose wall was "
        f"{one_wall:.3f} s ({one_wall * 1e3 / one_it:.3f} ms per "
        f"iteration); {card}; {staging}")
    counts[phase] = _sum_counts(ranks)
    return counts


# ---------------------------------------------------------------------------
# 31-32: the Mamba, MLA, xLSTM, encoder-decoder and vision stacks on a mesh
# ---------------------------------------------------------------------------

#: mesh-families: the stacks served at tp 2, one after another
MESH_FAMILIES = ("xlstm-1.3b", "seamless-m4t-large-v2", "internvl2-1b",
                 "deepseek-v3-671b", "jamba-1.5-large-398b")
#: the six requests' prompt lengths (multiples of the mLSTM chunk, so the
#: xLSTM prefills chunkwise) and new tokens each
MESH_PROMPTS = (128, 256, 192, 128, 256, 192)
MESH_NEW = 16
MESH_WINDOW = 1024
#: the f32 check: prompt length and decode steps
MESH_F32_PROMPT, MESH_F32_STEPS = 128, 8
#: the kernels each family's engine launches (none for MLA and xLSTM)
MESH_PATHS = {"xlstm-1.3b": (), "deepseek-v3-671b": (),
              "seamless-m4t-large-v2": DENSE_PATH,
              "internvl2-1b": DENSE_PATH,
              "jamba-1.5-large-398b": DENSE_PATH + ("mamba_scan",)}


def _dropless(cfg):
    """MoE capacity factor experts / top-k: no assignment is ever dropped,
    so a token's output does not depend on how the batch is cut."""
    moe = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.num_experts / moe.top_k))


def _jamba_cut(cfg):
    """Jamba in the reduced config's layout at published widths: Mamba +
    dense FFN, then attention + MoE (16 experts top-2)."""
    return dataclasses.replace(cfg, num_layers=2,
                               block_pattern=("mamba", "attn"))


def mesh_family_configs(arch):
    """(the bf16 config served at tp 1 and tp 2, the f32 two-layer
    config: xlstm-1.3b's an mLSTM and the sLSTM) of a mesh-families
    stack, MoE dispatch dropless in both.  xlstm-1.3b is served on its
    first ``XLSTM_F32_LAYERS`` blocks (one period of the pattern): over
    all 48 random-weight blocks a bf16 row lies ~100% of max|logit| from
    its f32 replay, which leaves no token to judge.  The f32 MoE layers keep their
    widths with fewer experts (deepseek 16 top-8, jamba 4 top-2): a rank
    holds a whole f32 tree in its turn beside the other rank's cut."""
    from repro_torch.configs import get_config
    full = get_config(arch)
    if arch == "deepseek-v3-671b":
        return (_deepseek(4, dropless=True),
                _deepseek(2, dropless=True, dtype="float32",
                          moe=dataclasses.replace(full.moe, num_experts=16,
                                                  first_dense_layers=1)))
    if arch == "jamba-1.5-large-398b":
        cut = _jamba_cut(full)
        return (_dropless(cut), _dropless(dataclasses.replace(
            cut, dtype="float32",
            moe=dataclasses.replace(cut.moe, num_experts=4))))
    if arch == "xlstm-1.3b":
        return (_depth_cut(full, XLSTM_F32_LAYERS),
                dataclasses.replace(full, num_layers=2, dtype="float32",
                                    block_pattern=("mlstm", "slstm")))
    return full, _depth_cut(full, 2, dtype="float32")


def _watch_drops(moe_mod):
    """Patch the MoE dispatch to count the assignments it drops (within-
    expert rank at or past the capacity); returns (counts, restore)."""
    drops, cap = [], [0]
    plain_cap, plain_ranks = moe_mod._capacity, moe_mod._ranks_of

    def capacity(*a):
        cap[0] = plain_cap(*a)
        return cap[0]

    def ranks_of(e_flat, num_experts):
        ranks = plain_ranks(e_flat, num_experts)
        drops.append((ranks >= cap[0]).sum())
        return ranks

    def restore():
        moe_mod._capacity, moe_mod._ranks_of = plain_cap, plain_ranks

    moe_mod._capacity, moe_mod._ranks_of = capacity, ranks_of
    return drops, restore


def _watch_collectives(sharding_mod):
    """Patch the TP helpers to count their calls; returns (count,
    restore)."""
    n = [0]
    plain = sharding_mod.reduce, sharding_mod.gather

    def reduce(x):
        n[0] += 1
        return plain[0](x)

    def gather(x, dim, full):
        n[0] += 1
        return plain[1](x, dim, full)

    def restore():
        sharding_mod.reduce, sharding_mod.gather = plain

    sharding_mod.reduce, sharding_mod.gather = reduce, gather
    return n, restore


def _mesh_requests(np, cfg, seed):
    """The six requests and their payloads, the same on every call."""
    from repro_torch.serving import Request
    from repro_torch.workloads import default_extras
    rng = np.random.default_rng(seed)
    reqs = [Request(prompt_len=n, max_new_tokens=MESH_NEW, rid=i,
                    prompt_tokens=rng.integers(0, cfg.vocab_size, (1, n),
                                               dtype=np.int32))
            for i, n in enumerate(MESH_PROMPTS)]
    return reqs, [default_extras(cfg, seed, i) for i in range(len(reqs))]


def _mesh_serve(torch, np, cfg, eng, seed):
    """The six requests through ``eng``: each prefilled alone, then dense
    decode steps until all finish; every sampled row's logits kept (f32,
    on the host) by (request, token index), the kernel counts and the
    (heads, KV heads, hd[, causal]) of their calls, the dropped MoE
    assignments, the TP collectives per decode step."""
    from repro_torch import sharding
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.models import attention as attention_mod
    from repro_torch.models import moe as moe_mod
    reqs, extras = _mesh_requests(np, cfg, seed)
    last = []
    plain = eng._sample

    def sample(logits, row_slots):
        last[:] = [logits]
        return plain(logits, row_slots)

    eng._sample = sample
    drops, undrop = _watch_drops(moe_mod)
    heads, unwatch = _watch_heads(attention_mod, DENSE_ENTRIES)
    rows = {}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for r, extra in zip(reqs, extras):
        eng.prefill_request(r, extra)
        rows[r.rid, 0] = last[0][0].float().cpu()
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    calls, uncount = _watch_collectives(sharding)
    steps = 0
    t0 = time.perf_counter()
    while eng.slot_req:
        live = {s: (q.rid, len(q.output_tokens))
                for s, q in eng.slot_req.items()}
        eng.decode()
        for s, key in live.items():
            rows[key] = last[0][s].float().cpu()
        steps += 1
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    uncount()
    counts = read_counts()
    undrop()
    unwatch()
    del eng._sample
    return {"tokens": [list(map(int, r.output_tokens)) for r in reqs],
            "heads": {n: sorted(v) for n, v in heads.items()},
            "rows": rows, "prefill_s": prefill_s, "decode_s": decode_s,
            "steps": steps, "collectives": calls[0] / max(1, steps),
            "counts": counts, "dropped": int(sum(int(d) for d in drops)),
            "state": eng.state_bytes()}


def _mesh_batch(torch, np, cfg, dev, seed):
    """The f32 check's prompt (``MESH_F32_PROMPT`` tokens) and extras."""
    from repro_torch.workloads import default_extras
    rng = np.random.default_rng(seed + 1)
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (1, MESH_F32_PROMPT), dtype=np.int32),
        device=dev)}
    for key, value in (default_extras(cfg, seed, 99) or {}).items():
        batch[key] = torch.as_tensor(value, device=dev)
    return batch


def _mesh_rows(torch, cfg, params, sl, dev, batch, steps, fed=None,
               clock=None):
    """A prompt's prefill logits and ``steps`` dense decode steps', fed
    ``fed`` (else greedy), the first step at ``clock`` (default: after
    the vision prefix and the prompt); under the slice's TP context with
    its per-rank state, or whole with ``sl`` None.  Returns (rows, tokens
    fed)."""
    import contextlib
    from repro_torch import sharding
    from repro_torch.meshserve.pool import local_state
    from repro_torch.models import decode_step, init_state, prefill
    offset = (cfg.frontend.num_prefix_tokens if cfg.frontend is not None
              and cfg.frontend.kind == "vision" else 0)
    if clock is None:
        clock = offset + batch["tokens"].shape[1]
    state = (local_state(cfg, sl, 1, MESH_WINDOW) if sl is not None
             else init_state(cfg, 1, MESH_WINDOW, device=dev))
    ctx = (sharding.use_mesh(sl.group) if sl is not None
           else contextlib.nullcontext())
    rows, toks = [], []
    with ctx:
        logits, state = prefill(cfg, params, batch, state)
        rows.append(logits[0].float())
        for step in range(steps):
            tok = (fed[step] if fed is not None
                   else logits.argmax(-1).to(torch.int32))
            toks.append(tok)
            t = torch.full((1,), clock + step, dtype=torch.int32,
                           device=dev)
            logits, state = decode_step(cfg, params, tok[:, None], state, t)
            rows.append(logits[0].float())
    return rows, toks


def _upcast(torch, tree):
    """Each bf16 leaf of ``tree`` replaced by its f32 copy, one leaf at a
    time (the whole tree is never held twice); f32 leaves stay."""
    for key in (tree.keys() if isinstance(tree, dict) else range(len(tree))):
        leaf = tree[key]
        if isinstance(leaf, (dict, list)):
            _upcast(torch, leaf)
        elif leaf.dtype != torch.float32:
            tree[key] = leaf.float()


def _mesh_judge(torch, np, cfg, dev, seed, one, two):
    """Phase 8's near-tie rule against an f32 replay: the one-device
    engine's tokens fed to the same weights upcast to f32, so each row
    the two engines sampled has its f32 twin.  The one-device bf16
    reading is max |bf16 - f32| over all those rows (one row's reading
    misses the MoE stacks' routing flips, where a near-tied expert choice
    moves a row far more than its neighbours: either run may flip on a
    row the other does not).  Where a request's tp 2 token first parts
    from one device's, the pair is a near-tie when the two tokens' f32
    gap is within twice the reading.  Returns (the parting pairs as (rid,
    index, one-device token, tp 2 token, f32 gap, twice the row's own
    reading: printed, not gated), the reading, the
    reading / max|f32| at its worst row, the worst max |tp 1 - tp 2| /
    max|f32| over the rows sampled on a common prefix, the parting rows
    whose whole f32 range the limit spans, seconds)."""
    from repro_torch.models import init_params
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         device=dev)
    _upcast(torch, params)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    reqs, extras = _mesh_requests(np, cfg, seed)
    pairs, spans, reading, ratio, worst = [], {}, 0.0, 0.0, 0.0
    for r, extra in zip(reqs, extras):
        ta, tb = one["tokens"][r.rid], two["tokens"][r.rid]
        batch = {"tokens": torch.as_tensor(r.prompt_tokens, device=dev)}
        for key, value in (extra or {}).items():
            batch[key] = torch.as_tensor(value, device=dev)
        fed = [torch.tensor([t], dtype=torch.int32, device=dev)
               for t in ta[:-1]]
        # at the engine's clock: a vision request decodes from its prompt
        # length S, not P + S, as the reference's engine does
        rows, _ = _mesh_rows(torch, cfg32, params, None, dev, batch,
                             len(ta) - 1, fed=fed, clock=r.prompt_len)
        j = next((i for i, (a, b) in enumerate(zip(ta, tb)) if a != b),
                 len(ta))
        for i, f in enumerate(rows):
            f = f.cpu()
            top = float(f.abs().max())
            e1 = float((one["rows"][r.rid, i] - f).abs().max())
            reading, ratio = max(reading, e1), max(ratio, e1 / top)
            if i <= j:
                worst = max(worst, float(
                    (one["rows"][r.rid, i] - two["rows"][r.rid, i]).abs()
                    .max()) / top)
            if i == j:
                pairs.append((r.rid, j, ta[j], tb[j],
                              abs(float(f[ta[j]] - f[tb[j]])), 2 * e1))
                spans[r.rid, j] = float(f.max() - f.min())
    del params
    _free(torch)
    blunt = [key for key, span in spans.items() if 2 * reading >= span]
    return (pairs, reading, ratio, worst, blunt,
            time.perf_counter() - t0)


def _mesh_family(torch, np, rank, world, sl, arch, cfg, cfg32, dev, seed):
    """One family on this rank: in turn the ranks draw the whole tree
    (rank 0 serves it on one device first), build their tp-``world``
    engine, which keeps only the rank's cut, and free the whole tree
    before the next rank draws; then that serve, rank 0's f32 replay of the
    one-device tokens (:func:`_mesh_judge`), and the two-layer f32 check
    drawn in turn likewise."""
    import torch.distributed as dist
    from repro_torch.meshserve.pool import shard_params
    from repro_torch.models import init_params
    from repro_torch.serving import InstanceEngine
    out = {"rank": rank}
    one = eng = None
    for turn in range(world):
        if rank == turn:
            whole = init_params(cfg, torch.Generator(device=dev).manual_seed(
                seed), device=dev)
            out["whole_bytes"] = _weight_bytes(whole)
            if rank == 0:
                one = _mesh_serve(torch, np, cfg, InstanceEngine(
                    cfg, whole, num_slots=8, kv_capacity=MESH_WINDOW,
                    block_lines=16, device=dev), seed)
            eng = InstanceEngine(cfg, whole, num_slots=8,
                                 kv_capacity=MESH_WINDOW, block_lines=16,
                                 mesh=sl, device=dev)
            del whole
            _free(torch)
        dist.barrier()
    out["rank_bytes"] = _weight_bytes(eng.params)
    two = _mesh_serve(torch, np, cfg, eng, seed)
    del eng
    _free(torch)
    out.update({k: v for k, v in two.items() if k != "rows"})
    if one is not None:
        # the f32 replay on rank 0 alone: the other ranks hold nothing now
        (out["ties"], out["reading"], out["ratio"], out["worst"],
         out["blunt"], out["replay_s"]) = _mesh_judge(torch, np, cfg, dev,
                                                      seed, one, two)
        out["one"] = {k: v for k, v in one.items() if k != "rows"}
    del one, two
    dist.barrier()
    # f32, two layers: each rank's own one-device rows, then tp 2's
    mine = ref = fed = None
    batch = _mesh_batch(torch, np, cfg32, dev, seed)
    for turn in range(world):
        if rank == turn:
            whole = init_params(cfg32, torch.Generator(
                device=dev).manual_seed(seed), device=dev)
            ref, fed = _mesh_rows(torch, cfg32, whole, None, dev, batch,
                                  MESH_F32_STEPS)
            mine = shard_params(cfg32, whole, sl)
            del whole
            _free(torch)
        dist.barrier()
    rows, _ = _mesh_rows(torch, cfg32, mine, sl, dev, batch, MESH_F32_STEPS,
                         fed=fed)
    out["f32"] = [(float((a - b).abs().max()), float(a.abs().max()))
                  for a, b in zip(ref, rows)]
    del mine, ref, rows
    _free(torch)
    return out


def mesh_families_rank(rank, world, plan):
    """Phase 31 on one rank: every family of ``plan`` one after another on
    one tp-``world`` slice; returns each family's record."""
    import numpy as np
    from repro_torch.meshserve import carve_slices
    torch, dev = _rank_setup(plan["device"])
    (sl,) = carve_slices(world, 1, device=dev)
    out = {}
    for arch, cfg, cfg32, seed in plan["families"]:
        t0 = time.perf_counter()
        out[arch] = _mesh_family(torch, np, rank, world, sl, arch, cfg,
                                 cfg32, dev, seed)
        out[arch]["seconds"] = time.perf_counter() - t0
    return out


def phase_mesh_families(torch, np, card, device="cuda"):
    """Phase 31: seamless-m4t-large-v2 and internvl2-1b whole,
    xlstm-1.3b's first 8 blocks, deepseek-v3-671b cut to layers 0-3 and
    Jamba in the reduced layout at published widths, each as one engine at tp 2 on a world of
    ``MESH_WORLD`` processes on this one card over gloo; returns the
    kernel counts summed over the ranks, by family."""
    from repro_torch.meshserve.world import spawn
    phase = "mesh-families"
    plan = {"device": device, "families": [
        (arch, *mesh_family_configs(arch), 31 + i)
        for i, arch in enumerate(MESH_FAMILIES)]}
    t0 = time.perf_counter()
    ranks = spawn("chip_smoke:mesh_families_rank", MESH_WORLD, device=device,
                  share_card=device == "cuda", args=(plan,),
                  timeout=MESH_FAMILIES_TIMEOUT, threads=2)
    log(f"{phase}: {MESH_WORLD} ranks on card 0 in "
        f"{time.perf_counter() - t0:.1f} s; gloo stages every CUDA "
        f"collective through the host: the phase checks the sharded compute "
        f"and the kernels at per-rank shapes, not a card-to-card wire")
    counts = {}
    for arch, cfg, cfg32, _ in plan["families"]:
        name = f"{phase} {arch}"
        outs = [r[arch] for r in ranks]
        _check_mesh_family(name, outs, cfg, cfg32, MESH_PATHS[arch], card)
        counts[name] = _sum_counts(outs)
    return counts


def _check_mesh_family(name, outs, cfg, cfg32, path_kernels, card):
    """Phase 31's checks and lines for one family's ranks ``outs`` (rank
    0 first, which also served one device): tokens against one device up
    to near-ties on the f32 replay, the kernels of ``path_kernels`` and no
    other, no MoE drop, the f32 rows within 1e-3 of max|logit|, each
    rank's weights below the whole tree's."""
    tp = len(outs)
    lead = outs[0]
    one = lead["one"]
    check(all(o["tokens"] == lead["tokens"] for o in outs),
          f"{name}: the ranks' tokens differ")
    check(all(len(t) == MESH_NEW for t in lead["tokens"] + one["tokens"]),
          f"{name}: a request ended short")
    # phase 8's rule on the f32 replay of the one-device tokens
    limit = 2 * lead["reading"]
    for rid, j, a, b, gap, _ in lead["ties"]:
        check(gap <= limit, f"{name}: request {rid}'s token {j} is {b} "
              f"at tp {tp} and {a} on one device, {gap:.3e} apart in the "
              f"f32 replay, beyond twice one device's max |bf16 - f32| "
              f"{lead['reading']:.3e}")
    check(not lead["blunt"], f"{name}: on the parting rows "
          f"{lead['blunt']} twice one device's max |bf16 - f32| spans "
          f"the whole f32 row: the near-tie rule would pass any token")
    check(lead["worst"] <= 2 * lead["ratio"], f"{name}: max |tp 1 - tp "
          f"{tp}| / max|f32| {lead['worst']:.3e} over the common prefixes, "
          f"beyond twice one device's max |bf16 - f32| / max|f32| "
          f"{lead['ratio']:.3e}")
    for r, o in enumerate(outs):
        label = f"{name} rank {r}"
        _check_path_counts(o["counts"], path_kernels, label)
        if not path_kernels:
            _check_no_kernel(o["counts"], label)
        if cfg.moe is not None:
            check(o["dropped"] == 0, f"{label}: {o['dropped']} MoE "
                  f"assignments dropped at capacity factor "
                  f"{cfg.moe.capacity_factor}")
        for step, (err, scale) in enumerate(o["f32"]):
            check(err <= 1e-3 * scale, f"{label}: f32 row {step} "
                  f"differs by {err} against max logit {scale}")
        check(o["rank_bytes"] < o["whole_bytes"], f"{label}: "
              f"{o['rank_bytes']} B of weights, the whole tree's "
              f"{o['whole_bytes']} B")
    if cfg.moe is not None:
        check(one["dropped"] == 0, f"{name}: one device dropped "
              f"{one['dropped']} MoE assignments")
    ms1 = one["decode_s"] * 1e3 / one["steps"]
    log(f"{name}: {cfg.num_layers} layers {cfg.block_pattern[:8]}, "
        f"d_model {cfg.d_model}, heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads}, {cfg.dtype}; {len(MESH_PROMPTS)} requests "
        f"(prompts {MESH_PROMPTS}) x {MESH_NEW} tokens; "
        f"{lead['seconds']:.1f} s on rank 0")
    log(f"{name}: weights per rank "
        + ", ".join(f"{o['rank_bytes'] / 1e9:.3f}" for o in outs)
        + f" GB of one device's {lead['whole_bytes'] / 1e9:.3f} GB; "
        f"state per rank " + ", ".join(f"{o['state'] / 1e6:.1f}"
                                       for o in outs)
        + f" MB of one device's {one['state'] / 1e6:.1f} MB")
    log(f"{name}: decode ms per step (6 active, dense): tp 1 {ms1:.3f}, "
        f"tp {tp} " + ", ".join(
            f"rank {r} {o['decode_s'] * 1e3 / o['steps']:.3f}"
            for r, o in enumerate(outs))
        + f"; prefill of the six: tp 1 {one['prefill_s']:.3f} s, tp {tp} "
        f"{lead['prefill_s']:.3f} s; {lead['collectives']:.1f} "
        f"sharding.reduce/gather calls per decode step; {card}")
    log(f"{name}: launches tp 1 {one['counts']}; tp {tp} "
        + "; ".join(f"rank {r} {o['counts']}" for r, o in enumerate(outs)))
    if cfg.moe is not None:
        log(f"{name}: MoE capacity factor {cfg.moe.capacity_factor} "
            f"(dropless): assignments dropped on one device "
            f"{one['dropped']}, at tp {tp} "
            + ", ".join(f"rank {r} {o['dropped']}"
                        for r, o in enumerate(outs)))
    log(f"{name}: tokens equal one device's"
        + (f" up to {len(lead['ties'])} near-ties (rid, index, one "
           f"device's token, tp {tp}'s, f32 gap, twice the row's own max "
           f"|bf16 - f32|) {lead['ties']}, limit {limit:.3e}"
           if lead["ties"] else "")
        + f"; over the {len(MESH_PROMPTS) * MESH_NEW} rows of the f32 "
        f"replay of one device's tokens, one device's max |bf16 - f32| "
        f"{lead['reading']:.3e}, / max|f32| at most {lead['ratio']:.3e}; "
        f"max |tp 1 - tp {tp}| / max|f32| over the rows sampled on a common "
        f"prefix {lead['worst']:.3e} (limit {2 * lead['ratio']:.3e}); "
        f"replay {lead['replay_s']:.1f} s")
    log(f"{name}: f32 at 2 layers {cfg32.block_pattern}: max |tp {tp} - "
        f"tp 1| / max|logit| over prefill + {MESH_F32_STEPS} decode steps: "
        + ", ".join(f"rank {r} {max(e / s for e, s in o['f32']):.3e}"
                    for r, o in enumerate(outs)) + " (limit 1e-3)")


def phase_mesh_cluster_hybrid(torch, np, card, device="cuda"):
    """Phase 32: Jamba in the reduced layout at published widths (capacity
    factor 1.25) behind two one-rank slices, two processes on this one
    card over gloo, on the mesh-cluster stream, beside a one-process
    cluster: the hybrid stack's recurrent-state mirror across slices.
    Returns the kernel counts summed over the ranks."""
    from repro_torch.api import build_cluster
    from repro_torch.configs import get_config
    from repro_torch.meshserve.world import spawn
    phase = "mesh-cluster-hybrid"
    cfg = _jamba_cut(get_config("jamba-1.5-large-398b"))
    spec = _cluster_spec(arch=cfg.name, traffic=_mesh_light(), device=device)
    one = build_cluster(spec, cfg=cfg)
    one.policy.trace = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = one.run(max_steps=spec.max_steps, source=spec.traffic.source(
        seed=spec.seed, cfg=one.cfg))
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t0
    one_stats, one_trace, one_it = (dict(one.stats), one.policy.trace,
                                    one.n_iterations)
    one_tokens = sorted((r.rid, tuple(r.output_tokens)) for r in done)
    del one, done
    _free(torch)
    t0 = time.perf_counter()
    ranks = spawn("chip_smoke:mesh_cluster_rank", MESH_WORLD, device=device,
                  share_card=device == "cuda",
                  args=(dataclasses.replace(spec, mesh_tp=1), cfg),
                  timeout=MESH_TIMEOUT, threads=2)
    log(f"{phase}: {cfg.name} {cfg.block_pattern} at published widths, "
        f"capacity factor {cfg.moe.capacity_factor}; {spec.n_instances} "
        f"instances, one rank each, on card 0 in "
        f"{time.perf_counter() - t0:.1f} s; traffic "
        f"{spec.traffic.describe()}")
    for key in ("stats", "trace", "tokens", "iterations", "moved"):
        check(all(o[key] == ranks[0][key] for o in ranks),
              f"{phase}: the ranks' {key} differ")
    out = ranks[0]
    st = out["stats"]
    check(out["finished"] == out["submitted"] and out["whole"],
          f"{phase}: {out['finished']} of {out['submitted']} requests "
          f"finished whole")
    check(st["mirror_syncs"] > 0, f"{phase}: no mirror sync")
    for key in ("mirror", "stream"):
        check(st[f"{key}_bytes"] == out["moved"][key],
              f"{phase}: stats {key}_bytes {st[f'{key}_bytes']} != "
              f"{out['moved'][key]} priced by LineCosts")
    for r, o in enumerate(ranks):
        d2d, d2d_bytes, host, host_bytes = o["transfers"]
        check(host > 0 and host_bytes > 0 and d2d == d2d_bytes == 0,
              f"{phase} rank {r}: {d2d} device-to-device hops and {host} "
              f"host copies over gloo, where every hop stages through the "
              f"host")
        _check_path_counts(o["counts"], MESH_PATHS["jamba-1.5-large-398b"],
                           f"{phase} rank {r}")
        log(f"{phase} rank {r}: {host} cross-slice hops, {host_bytes} B, "
            f"all host copies (gloo stages them); pools {o['pool']} B; wall "
            f"{o['wall']:.3f} s, {o['wall'] * 1e3 / o['iterations']:.3f} ms "
            f"per iteration; launches {o['counts']}")
    for key, value in one_stats.items():
        check(st[key] == value, f"{phase}: {key} {st[key]} against the "
              f"one-process cluster's {value}")
    check(out["trace"] == one_trace,
          f"{phase}: the decision trace differs from the one-process one's")
    check(out["iterations"] == one_it, f"{phase}: {out['iterations']} "
          f"iterations against the one-process cluster's {one_it}")
    check(out["tokens"] == one_tokens,
          f"{phase}: tokens differ from the one-process cluster's")
    log(f"{phase}: stats {st}; mirror_bytes {st['mirror_bytes']:.0f} = "
        f"LineCosts over {out['moved']['mirror_lines']} lines plus the "
        f"recurrent state on every sync; stats, trace, iterations and "
        f"tokens equal the one-process cluster's (wall {one_wall:.3f} s, "
        f"{one_wall * 1e3 / one_it:.3f} ms per iteration); {card}")
    return {phase: _sum_counts(ranks)}


# ---------------------------------------------------------------------------
# 33: train-mesh, the sharded train step on a (data, model) world
# ---------------------------------------------------------------------------

#: train-mesh: minicpm-2b at published widths cut to its first
#: ``TRAIN_MESH_LAYERS`` of 40 layers, in f32, on a (data 2, model 2)
#: world of processes on the one card over gloo
TRAIN_MESH_LAYERS = 4
TRAIN_MESH = (2, 2)
TRAIN_MESH_STEPS = 3
#: rows of each step's batch (128 tokens each; the data ranks take 2 each)
TRAIN_MESH_BATCH = 4
TRAIN_MESH_SEED = 33
#: seconds the world may take
TRAIN_MESH_TIMEOUT = 600.0


def _train_mesh_setup(torch, dev):
    """The phase's config, AdamW config, the schedule's LR scales and its
    batches (``training.batches``, seed 0), the same on every process."""
    from repro_torch.configs import get_config
    from repro_torch.training import AdamWConfig, DataConfig, batches, wsd
    cfg = _depth_cut(get_config("minicpm-2b"), TRAIN_MESH_LAYERS,
                     dtype="float32")
    data = batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_MESH_BATCH, seed=0))
    out = []
    for _ in range(TRAIN_MESH_STEPS):
        b = torch.from_numpy(next(data)).to(dev)
        out.append({"tokens": b[:, :-1], "labels": b[:, 1:]})
    lrs = [float(wsd(i, warmup=1, total=TRAIN_MESH_STEPS))
           for i in range(TRAIN_MESH_STEPS)]
    return cfg, AdamWConfig(), lrs, out


def train_mesh_rank(rank, world, payload):
    """Phase 33 on one rank of the (data, model) world: the whole weights
    drawn from the phase's seed and cut to this rank's part
    (``ShardedStep.shard``), ``TRAIN_MESH_STEPS`` sharded steps timed on
    the global batches, the collectives of this module's ``sharding``
    counted by kind and axis, and this rank's part of the params after
    the steps against the one-process run's (``payload["reference"]``,
    cut the same way).  Then the same steps from the same weights with
    ``REPRO_SEQ_PARALLEL=1`` (sequence parallelism), under ``"sp"``."""
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.models import init_params
    from repro_torch.training import init_opt_state
    from repro_torch.training.fsdp import leaf_bytes, train_mesh
    from repro_torch.training.train_step import make_train_step
    torch, dev = _rank_setup(payload["device"])
    cfg, opt_cfg, lrs, data = _train_mesh_setup(torch, dev)
    mesh = train_mesh(*TRAIN_MESH)
    step = make_train_step(cfg, opt_cfg, mesh)

    def run():
        whole = init_params(cfg, torch.Generator(device=dev).manual_seed(
            TRAIN_MESH_SEED), device=dev)
        params = step.shard(whole)
        del whole
        opt = init_opt_state(opt_cfg, params)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        calls, losses, seconds = {}, [], []
        reset_counts()
        with _collectives(calls):
            for i, batch in enumerate(data):
                _sync(torch, dev)
                t0 = time.perf_counter()
                params, opt, metrics = step(params, opt, batch, lrs[i])
                losses.append(float(metrics["loss"]))
                seconds.append(time.perf_counter() - t0)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        want = step.shard(torch.load(payload["reference"], mmap=True,
                                     weights_only=True), device=dev)
        errs = {path: max_err(x, _at_path(want, path))
                for path, x in _named_leaves(params)}
        return {"losses": losses, "seconds": seconds, "errs": errs,
                "calls": _by_kind(calls, len(data)),
                "param_bytes": leaf_bytes(params),
                "moment_bytes": leaf_bytes(opt.m) + leaf_bytes(opt.v),
                "peak": peak, "counts": counts}

    out = run()
    with _seq_parallel():
        out["sp"] = run()
    return dict(out, rank=rank, cut=(mesh.data_rank, mesh.model_rank))


def _at_path(tree, path):
    for key in path.strip("/").split("/"):
        tree = tree[int(key)] if isinstance(tree, list) else tree[key]
    return tree


def phase_train_mesh(torch, np, card, device="cuda"):
    """Phase 33, train-mesh: minicpm-2b at published widths cut to
    ``TRAIN_MESH_LAYERS`` layers, in f32, ``TRAIN_MESH_STEPS`` AdamW steps
    of the sharded train step (TP on "model", FSDP on "data") on a
    (data 2, model 2) world of four processes on this one card over gloo,
    against one process's f32 steps on the same weights and batches: every
    step's loss within 1e-4, each leaf of every rank's part of the params
    after the steps within 1e-4 of the whole leaf's max|.| (the parts
    cover every leaf), each rank's param and moment bytes below one
    process's; no kernel runs (training takes the model-level paths).
    Prints seconds per step, each rank's peak memory and the collectives
    a step makes.  Returns the kernel counts summed over the ranks."""
    from repro_torch.meshserve.world import spawn
    from repro_torch.models import init_params
    from repro_torch.training import init_opt_state, train_step
    from repro_torch.training.fsdp import leaf_bytes
    phase = "train-mesh"
    t_phase = time.perf_counter()
    dev = torch.device(device)
    cfg, opt_cfg, lrs, data = _train_mesh_setup(torch, dev)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        TRAIN_MESH_SEED), device=dev)
    whole_bytes = leaf_bytes(params)
    opt = init_opt_state(opt_cfg, params)
    losses, seconds = [], []
    for i, batch in enumerate(data):
        _sync(torch, dev)
        t0 = time.perf_counter()
        params, opt, metrics = train_step(cfg, opt_cfg, params, opt, batch,
                                          lrs[i])
        losses.append(float(metrics["loss"]))
        seconds.append(time.perf_counter() - t0)
    moment_bytes = leaf_bytes(opt.m) + leaf_bytes(opt.v)
    del opt
    scale = {path: float(x.abs().max()) for path, x in _named_leaves(params)}
    ref_path = ROOT / "build" / "train_mesh_reference.pt"
    ref_path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(_tree_map(lambda t: t.cpu(), params), ref_path)
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"{phase}: {cfg.name} at published widths, {cfg.num_layers} of 40 "
        f"layers, f32, {whole_bytes / 1e9:.3f} GB of weights; "
        f"{TRAIN_MESH_STEPS} AdamW steps (LR scales {lrs}) of "
        f"{TRAIN_MESH_BATCH} x {TRAIN_SEQ} tokens; one process: losses "
        f"{[round(x, 6) for x in losses]}, s per step "
        f"{[round(x, 3) for x in seconds]}")
    t0 = time.perf_counter()
    try:
        ranks = spawn("chip_smoke:train_mesh_rank", TRAIN_MESH[0]
                      * TRAIN_MESH[1], device=device,
                      share_card=device == "cuda",
                      args=({"reference": str(ref_path), "device": device},),
                      timeout=TRAIN_MESH_TIMEOUT, threads=2)
    finally:
        ref_path.unlink(missing_ok=True)
    log(f"{phase}: a (data {TRAIN_MESH[0]}, model {TRAIN_MESH[1]}) world of "
        f"{len(ranks)} processes on this card over gloo in "
        f"{time.perf_counter() - t0:.1f} s (gloo stages every collective "
        f"through the host); {card}")
    counts = {}
    for out in ranks:
        label = f"{phase} rank {out['rank']} (data {out['cut'][0]}, model "\
                f"{out['cut'][1]})"
        for i, (a, b) in enumerate(zip(out["losses"], losses)):
            check(abs(a - b) <= 1e-4 * abs(b), f"{label}: step {i} loss {a} "
                  f"against one process's {b}")
        worst = (0.0, "")
        for path, err in out["errs"].items():
            ratio = err / max(scale[path], 1e-30)
            check(ratio <= 1e-4, f"{label}: {path} after {TRAIN_MESH_STEPS} "
                  f"steps off by {ratio:.3e} of the whole leaf's max")
            worst = max(worst, (ratio, path))
        check(out["param_bytes"] < whole_bytes
              and out["moment_bytes"] == 2 * out["param_bytes"]
              and out["moment_bytes"] < moment_bytes,
              f"{label}: {out['param_bytes']} B of params and "
              f"{out['moment_bytes']} B of moments against one process's "
              f"{whole_bytes} and {moment_bytes}")
        log(f"{label}: losses {[round(x, 6) for x in out['losses']]}; "
            f"params within 1e-4 of one process's (worst {worst[0]:.3e}, "
            f"{worst[1]}); s per step "
            f"{[round(x, 3) for x in out['seconds']]}; params "
            f"{out['param_bytes'] / 1e9:.3f} GB ({out['param_bytes'] / whole_bytes:.3f} "
            f"of one process's), moments {out['moment_bytes'] / 1e9:.3f} GB; "
            f"peak {out['peak'] / 1e9:.3f} GB; {card}")
        # the same steps from the same weights with REPRO_SEQ_PARALLEL=1
        sp = out["sp"]
        for i, (a, b) in enumerate(zip(sp["losses"], out["losses"])):
            check(abs(a - b) <= 1e-5 * abs(b), f"{label} sequence-parallel: "
                  f"step {i} loss {a} against the flag-off {b}")
        sp_worst = max((err / max(scale[path], 1e-30), path)
                       for path, err in sp["errs"].items())
        check(sp_worst[0] <= 1e-4, f"{label} sequence-parallel: "
              f"{sp_worst[1]} after {TRAIN_MESH_STEPS} steps off by "
              f"{sp_worst[0]:.3e} of the whole leaf's max")
        for run in (out, sp):
            _check_no_kernel(run["counts"], label)
            for name, c in run["counts"].items():
                acc = counts.setdefault(name, {"launches": 0,
                                               "plain_calls": 0})
                for key in acc:
                    acc[key] += c[key]
        log(f"{label} sequence-parallel: losses "
            f"{[round(x, 6) for x in sp['losses']]}; params within 1e-4 of "
            f"one process's (worst {sp_worst[0]:.3e}, {sp_worst[1]}); s per "
            f"step {[round(x, 3) for x in sp['seconds']]}; peak "
            f"{sp['peak'] / 1e9:.3f} GB against {out['peak'] / 1e9:.3f} GB "
            f"with the flag off (torch.cuda.max_memory_allocated); {card}")
    for tag, run in (("", ranks[0]), (" sequence-parallel", ranks[0]["sp"])):
        log(f"{phase}{tag}: collectives a step on each rank: {run['calls']}")
    log(f"{phase}: phase {time.perf_counter() - t_phase:.1f} s; {card}")
    return counts


#: mesh-partial: internvl2-1b, whose 14 query heads do not divide the
#: slice of ``PARTIAL_WORLD`` ranks on card 0, while its d_ff 4,864 does
PARTIAL_ARCH = "internvl2-1b"
PARTIAL_WORLD = 4
PARTIAL_TIMEOUT = 600.0


def phase_mesh_partial(torch, np, card, device="cuda"):
    """Phase 34, mesh-partial: internvl2-1b whole at published widths, one
    engine at tp ``PARTIAL_WORLD`` on that many processes on this one
    card over gloo (phase 31's rank function and checks).  Its 14 query
    heads do not divide 4: every rank computes the whole attention (the
    prefill and dense decode kernels at 14/2 heads) and a quarter of the
    FFN (1,216 of 4,864); the vocab of 151,655 does not divide 4 and
    stays whole.  Checks tokens against one process up to near-ties on an
    f32 replay, f32 logits at 2 layers within 1e-3 of max|logit|, the
    kernels' heads, and each rank's weight bytes: the sum of the rule
    table's parts (``meshserve.pool.shard_params`` on the meta device),
    below one process's.  Returns the kernel counts summed over the
    ranks."""
    from repro_torch.meshserve.pool import shard_params
    from repro_torch.meshserve.topology import MeshSlice
    from repro_torch.meshserve.world import spawn
    from repro_torch.models import init_params
    phase = "mesh-partial"
    t_phase = time.perf_counter()
    cfg, cfg32 = mesh_family_configs(PARTIAL_ARCH)
    tp = PARTIAL_WORLD
    check(cfg.num_heads % tp and cfg.d_ff % tp == 0, f"{phase}: "
          f"{PARTIAL_ARCH}'s {cfg.num_heads} heads must not divide {tp} "
          f"while its d_ff {cfg.d_ff} does")
    meta = init_params(cfg, torch.Generator().manual_seed(0), device="meta")
    want = [_weight_bytes(shard_params(cfg, meta, MeshSlice(
        index=0, ranks=tuple(range(tp)), device=torch.device("meta"),
        rank=r))) for r in range(tp)]
    plan = {"device": device,
            "families": [(PARTIAL_ARCH, cfg, cfg32, 41)]}
    t0 = time.perf_counter()
    ranks = spawn("chip_smoke:mesh_families_rank", tp, device=device,
                  share_card=device == "cuda", args=(plan,),
                  timeout=PARTIAL_TIMEOUT, threads=2)
    log(f"{phase}: {tp} ranks on card 0 in {time.perf_counter() - t0:.1f} "
        f"s over gloo (every CUDA collective staged through the host)")
    name = f"{phase} {PARTIAL_ARCH}"
    outs = [r[PARTIAL_ARCH] for r in ranks]
    _check_mesh_family(name, outs, cfg, cfg32, DENSE_PATH, card)
    whole_heads = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    for r, o in enumerate([outs[0]["one"]] + outs):
        label = f"{name} " + ("one process" if r == 0 else f"rank {r - 1}")
        check(o["heads"] == {"flash_attention_cuda": [whole_heads + (True,)],
                             "decode_attention_cuda": [whole_heads]},
              f"{label}: kernel calls at {o['heads']}, expected the whole "
              f"{whole_heads} heads")
    for r, o in enumerate(outs):
        check(o["rank_bytes"] == want[r] < o["whole_bytes"],
              f"{name} rank {r}: {o['rank_bytes']} B of weights against the "
              f"rule table's {want[r]} B and one process's "
              f"{o['whole_bytes']} B")
    vocab = "whole" if cfg.vocab_size % tp else f"a {tp}th"
    log(f"{name}: each rank's weights equal the rule table's parts "
        f"({want[0] / 1e9:.4f} GB: attention and norms whole, the vocab of "
        f"{cfg.vocab_size} {vocab}, a {tp}th of d_ff {cfg.d_ff}), "
        f"{want[0] / outs[0]['whole_bytes']:.3f} of one process's "
        f"{outs[0]['whole_bytes'] / 1e9:.4f} GB; kernel calls at (heads, KV "
        f"heads, hd[, causal]) {outs[0]['heads']} on every rank and on one "
        f"process")
    log(f"{phase}: phase {time.perf_counter() - t_phase:.1f} s; {card}")
    return {name: _sum_counts(outs)}


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def mesh_only(torch, np, dev, card, flash_mod, decode_mod, scan_mod, flush):
    """``python3 chip_smoke.py --mesh-only``: the serve phase's six
    requests on one engine (the reference), then phases 28-29, the
    kernels at phase 31's per-rank shapes and phases 31-32 and 34 alone; for
    bringing the mesh phases up without the rest.  Prints no result
    line."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("starcoder2-3b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    six = []
    _, per_step, _ = _serve_six(torch, np, cfg, params, dev, "serve",
                                keep=six)
    del params
    _free(torch)
    phase_mesh(torch, np, six, per_step[8], card)
    _free(torch)
    phase_mesh_kernels(torch, flash_mod, decode_mod, scan_mod, flush)
    phase_mesh_families(torch, np, card)
    _free(torch)
    phase_mesh_cluster_hybrid(torch, np, card)
    _free(torch)
    phase_mesh_partial(torch, np, card)
    log("chip_smoke --mesh-only: serve, mesh-engine, mesh-cluster, the "
        "per-rank kernels, mesh-families, mesh-cluster-hybrid and "
        "mesh-partial passed")
    return 0


def _free(torch):
    """Return the last phase's weights to the card before the next."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    log(f"chip_smoke: {torch.cuda.memory_allocated() / 1e9:.3f} GB still "
        f"allocated, peak so far {torch.cuda.max_memory_allocated() / 1e9:.3f}"
        f" GB")


def _named_leaves(tree, path=""):
    """(path, leaf) for every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _leaves(tree):
    return [x for _, x in _named_leaves(tree)]


def _leaf_pairs(a, b, phase):
    """(path, leaf of ``a``, leaf of ``b``) over two trees that must have
    the same paths."""
    na, nb = list(_named_leaves(a)), list(_named_leaves(b))
    check([p for p, _ in na] == [p for p, _ in nb],
          f"{phase}: the two trees have different leaves")
    return [(p, x, y) for (p, x), (_, y) in zip(na, nb)]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


if __name__ == "__main__":
    sys.exit(main())
