"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and three paths through them against the CPU: the model's chunk path at
``q_offset > 0``, a two-instance AcceLLM cluster (equal tokens and stats)
and a two-instance cluster that loses an instance mid-serve and gets it
back (equal tokens, stats and fleet trace, under accellm and vllm).  The
reduced deepseek-v3-671b (MLA) and xlstm-1.3b, which reach no kernel,
give the CPU's logits on the card within 1e-3 * max|logit|, and so do the
reduced seamless-m4t-large-v2 (an encoder through the prefill kernel's
non-causal mode) and internvl2-1b (a vision prefix), through the prefill
and dense decode kernels; the engine takes their payloads already on the
card.  A train step on the card (reduced minicpm-2b and Jamba) gives
every leaf the CPU's gradient within 1e-4 of its max, every attention
and MLP leaf a nonzero one, and launches no kernel; each kernel wrapper
refuses card inputs that require grad.  One engine at tensor-parallel
width 2 runs as two processes on the one card (gloo) and gives the CPU
engine's tokens.

Marked ``cuda``: they skip where there is no CUDA device (the kernels have
no CPU mode).  This file imports neither JAX nor the JAX package, so it
runs on a machine with the card alone:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: 1e-4 max abs in f32 and 2e-2 in bf16 for attention; the
kernel and the plain version sum in different orders.  Non-causal bf16 is
also held to 0.05 x the RMS of the plain output, whose scale falls as
sqrt(e / Skv).  The selective scan
(f32 only) is held to 1e-4 relative to the largest output.
"""
import pytest
import torch

from repro_torch.kernels.decode_attention import (
    PAGED_HEADS_PER_BLOCK, decode_attention_cuda, decode_attention_torch,
    paged_decode_attention_cuda, paged_decode_attention_torch, split_plan)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_torch)
from repro_torch.kernels.mamba_scan import mamba_scan_cuda, mamba_scan_torch


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("S,window", [(512, 4096), (200, None), (256, 64)])
def test_flash_kernel_matches_plain_on_card(dtype, tol, S, window):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(S)
    q = torch.randn((2, S, 24, 128), generator=g, device="cuda").to(dtype)
    k = torch.randn((2, S, 2, 128), generator=g, device="cuda").to(dtype)
    v = torch.randn((2, S, 2, 128), generator=g, device="cuda").to(dtype)
    out = flash_attention_cuda(q, k, v, causal=True, window=window)
    exp = flash_attention_torch(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert float((out.float() - exp.float()).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (B, Sq, Skv, H, KVH, hd, window, q_offset): the bf16 kernel's edges
    (2, 1, 1, 24, 2, 128, None, 0),        # one row, one key
    (2, 65, 65, 24, 2, 128, None, 0),      # one row past a warpgroup's 64
    (2, 129, 129, 24, 2, 128, None, 0),    # one row past the 128-row tile
    (1, 48, 128, 4, 2, 64, 32, 80),        # chunk resume: offset 80, window
    (2, 256, 256, 4, 1, 64, None, 0),      # hd 64
    (2, 300, 300, 24, 2, 128, 16, 0),      # a window inside one tile
])
def test_flash_bf16_edges_match_plain_on_card(case):
    _need_cuda()
    B, Sq, Skv, H, KVH, hd, window, q_offset = case
    g = torch.Generator(device="cuda").manual_seed(Sq + Skv)
    q = torch.randn((B, Sq, H, hd), generator=g, device="cuda").bfloat16()
    k = torch.randn((B, Skv, KVH, hd), generator=g, device="cuda").bfloat16()
    v = torch.randn((B, Skv, KVH, hd), generator=g, device="cuda").bfloat16()
    out = flash_attention_cuda(q, k, v, causal=True, window=window,
                               q_offset=q_offset)
    exp = flash_attention_torch(q, k, v, causal=True, window=window,
                                q_offset=q_offset)
    torch.cuda.synchronize()
    assert float((out.float() - exp.float()).abs().max()) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_paged_kernel_matches_plain_on_card(dtype, tol):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    B, H, KVH, hd, bl, mb = 8, 24, 2, 128, 16, 32
    q = torch.randn((B, H, hd), generator=g, device="cuda").to(dtype)
    k_pool = torch.randn((B * mb, bl, KVH, hd), generator=g,
                         device="cuda").to(dtype)
    v_pool = torch.randn((B * mb, bl, KVH, hd), generator=g,
                         device="cuda").to(dtype)
    tables = torch.randperm(B * mb, generator=g, device="cuda")
    tables = tables.reshape(B, mb).to(torch.int32)
    lengths = torch.tensor([0, 1, 15, 16, 17, 200, 511, 512],
                           dtype=torch.int32, device="cuda")
    out = paged_decode_attention_cuda(q, k_pool, v_pool, tables, lengths)
    exp = paged_decode_attention_torch(q, k_pool, v_pool, tables, lengths)
    torch.cuda.synchronize()
    assert float((out.float() - exp.float()).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_paged_kernel_bad_tables_match_plain_on_card(dtype, tol):
    """Out-of-pool table entries and lengths past the table: the kernel and
    the plain version share one contract (mask, clamp)."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(1)
    B, H, KVH, hd, bl, mb, nb = 3, 24, 2, 128, 16, 4, 12
    q = torch.randn((B, H, hd), generator=g, device="cuda").to(dtype)
    k_pool = torch.randn((nb, bl, KVH, hd), generator=g,
                         device="cuda").to(dtype)
    v_pool = torch.randn((nb, bl, KVH, hd), generator=g,
                         device="cuda").to(dtype)
    tables = torch.tensor([[3, -1, 7, nb], [nb, nb, nb, nb], [0, 1, 2, 5]],
                          dtype=torch.int32, device="cuda")
    lengths = torch.tensor([mb * bl, 20, mb * bl + 9], dtype=torch.int32,
                           device="cuda")
    out = paged_decode_attention_cuda(q, k_pool, v_pool, tables, lengths)
    exp = paged_decode_attention_torch(q, k_pool, v_pool, tables, lengths)
    torch.cuda.synchronize()
    assert float((out.float() - exp.float()).abs().max()) <= tol
    assert float(out[1].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("B,G,bl", [(1, 12, 16), (1, 12, 32), (6, 4, 16),
                                    (3, 1, 32), (8, 20, 16)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_paged_split_edges_match_plain_on_card(B, G, bl, dtype, tol):
    """Lengths 0, 1, on a span boundary and one past it, W - 1 and W (and
    one past the table, clamped), at B 1 (where splitting matters most)
    and larger B; G 12, 4, 1 and 20 (two head groups); 16- and 32-line
    pool blocks, so a 64-line tile spans several of them."""
    _need_cuda()
    KVH, hd, W = 2, 128, 512
    mb = W // bl
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits, chunk = split_plan(B, KVH, G, W, sms, PAGED_HEADS_PER_BLOCK)
    cand = [0, 1, chunk - 1, chunk, chunk + 1, 2 * chunk + 1, W - 1, W,
            W + 5]
    rows = ([[n] for n in (W, chunk, chunk + 1, 1, 0)] if B == 1
            else [[cand[(i * 2 + j) % len(cand)] for i in range(B)]
                  for j in range(2)])
    g = torch.Generator(device="cuda").manual_seed(B * 100 + G + bl)
    nb = 2 * B * mb
    for lengths in rows:
        q = torch.randn((B, G * KVH, hd), generator=g,
                        device="cuda").to(dtype)
        k_pool = torch.randn((nb, bl, KVH, hd), generator=g,
                             device="cuda").to(dtype)
        v_pool = torch.randn((nb, bl, KVH, hd), generator=g,
                             device="cuda").to(dtype)
        tables = torch.randperm(nb, generator=g, device="cuda")[:B * mb]
        tables = tables.reshape(B, mb).to(torch.int32)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        out = paged_decode_attention_cuda(q, k_pool, v_pool, tables, lens)
        exp = paged_decode_attention_torch(q, k_pool, v_pool, tables, lens)
        torch.cuda.synchronize()
        assert float((out.float() - exp.float()).abs().max()) <= tol, (
            lengths)
        for b in range(B):
            if lengths[b] == 0:
                assert float(out[b].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_dense_decode_kernel_matches_plain_on_card(dtype, tol):
    """Jamba's head layout (64 / 8, hd 128) with lengths 0, 1, ragged and
    the full window."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(2)
    B, H, KVH, hd, W = 6, 64, 8, 128, 1024
    q = torch.randn((B, 1, H, hd), generator=g, device="cuda").to(dtype)
    kc = torch.randn((B, W, KVH, hd), generator=g, device="cuda").to(dtype)
    vc = torch.randn((B, W, KVH, hd), generator=g, device="cuda").to(dtype)
    lengths = torch.tensor([0, 1, 63, 65, 700, W], dtype=torch.int32,
                           device="cuda")
    out = decode_attention_cuda(q, kc, vc, lengths)
    exp = decode_attention_torch(q, kc, vc, lengths)
    torch.cuda.synchronize()
    assert float((out.float() - exp.float()).abs().max()) <= tol
    assert float(out[0].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("B", [8, 1])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_dense_decode_split_edges_match_plain_on_card(B, dtype, tol):
    """Lengths 0, 1, one off each side of a split boundary and the full
    row of 1024, at B = 8 and at B = 1 (where the most splits run)."""
    _need_cuda()
    H, KVH, hd, W = 64, 8, 128, 1024
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits, chunk = split_plan(B, KVH, H // KVH, W, sms)
    assert B * KVH * splits >= min(2 * sms, B * KVH * W // 128)
    lens = [0, 1, chunk - 1, chunk, chunk + 1, W - chunk + 1, W - 1, W]
    rows = [lens] if B == 8 else [[n] for n in (W, chunk + 1, 0)]
    g = torch.Generator(device="cuda").manual_seed(B)
    for lengths in rows:
        q = torch.randn((B, 1, H, hd), generator=g, device="cuda").to(dtype)
        kc = torch.randn((B, W, KVH, hd), generator=g, device="cuda").to(dtype)
        vc = torch.randn((B, W, KVH, hd), generator=g, device="cuda").to(dtype)
        lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        out = decode_attention_cuda(q, kc, vc, lengths)
        exp = decode_attention_torch(q, kc, vc, lengths)
        torch.cuda.synchronize()
        assert float((out.float() - exp.float()).abs().max()) <= tol
        for b in range(B):
            if int(lengths[b]) == 0:
                assert float(out[b].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("S,C,N", [(512, 4096, 16), (300, 1000, 16),
                                   (37, 200, 8), (1, 16384, 16),
                                   (512, 1003, 8), (300, 1001, 16),
                                   (512, 16384, 8)])
def test_scan_kernel_matches_plain_on_card(S, C, N):
    """Any S, a ragged channel edge (C % 4 != 0 takes 4-byte copies),
    N 8 and 16, nonzero h0, B 2."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(S)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    B = 2
    args = (randn(B, S, C), torch.nn.functional.softplus(randn(B, S, C) - 1),
            randn(B, S, N), randn(B, S, N), -torch.exp(randn(C, N) * 0.5),
            randn(C), randn(B, C, N) * 0.1)
    y, h = mamba_scan_cuda(*args)
    y_p, h_p = mamba_scan_torch(*args)
    torch.cuda.synchronize()
    for a, b in ((y, y_p), (h, h_p)):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("C,N", [(1000, 16), (1003, 8)])
def test_scan_kernel_empty_sequence_returns_h0_on_card(C, N):
    """S = 0: y is empty and h_final holds h0's values exactly."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(C)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    args = (randn(2, 0, C), randn(2, 0, C), randn(2, 0, N), randn(2, 0, N),
            -torch.exp(randn(C, N) * 0.5), randn(C), randn(2, C, N))
    y, h = mamba_scan_cuda(*args)
    torch.cuda.synchronize()
    assert tuple(y.shape) == (2, 0, C)
    assert torch.equal(h, args[-1]) and h.data_ptr() != args[-1].data_ptr()


def _reduced_starcoder():
    """The reduced starcoder2-3b in f32 with one set of random weights on
    the CPU and the same weights on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("starcoder2-3b").reduced()
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, cpu, _to_card(cpu)


def _to_card(tree):
    if isinstance(tree, dict):
        return {k: _to_card(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_card(v) for v in tree]
    return tree.to("cuda")


@pytest.mark.cuda
def test_prefill_chunk_on_card_matches_cpu():
    """The model's chunk path at q_offset > 0 through the prefill kernel:
    logits of every chunk within 1e-4 of the CPU's plain version."""
    _need_cuda()
    import numpy as np

    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.models import init_state, prefill_chunk
    cfg, p_cpu, p_card = _reduced_starcoder()
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 45), dtype=np.int32))
    st = {d: init_state(cfg, 1, 64, device=d) for d in ("cpu", "cuda")}
    reset_counts()
    for lo, hi in ((0, 16), (16, 32), (32, 45)):
        lc, st["cpu"] = prefill_chunk(cfg, p_cpu, toks[:, lo:hi], st["cpu"],
                                      history=lo)
        lg, st["cuda"] = prefill_chunk(cfg, p_card, toks[:, lo:hi].cuda(),
                                       st["cuda"], history=lo)
        torch.cuda.synchronize()
        assert float((lg.cpu() - lc).abs().max()) <= 1e-4, (lo, hi)
    assert read_counts()["flash_attention"]["launches"] == \
        3 * cfg.num_layers


@pytest.mark.cuda
def test_tp2_engine_on_card_matches_cpu():
    """One engine at tp 2 on the card, both ranks on card 0 over gloo
    (``tests/_torch_mesh_worker.py``): every rank's tokens equal one CPU
    engine's, both ranks launch the prefill and paged kernels at their
    per-rank heads with no plain version, and each holds half the pool."""
    _need_cuda()
    import _torch_mesh_worker as W
    from repro_torch.meshserve.world import spawn
    cfg, p_cpu, _ = _reduced_starcoder()
    one, want = W.generate(cfg, p_cpu, None)
    ranks = spawn("_torch_mesh_worker:card_engine", 2, device="cuda",
                  share_card=True, timeout=600)
    for out in ranks:
        assert out["tokens"] == want
        for name in ("flash_attention", "paged_decode_attention"):
            assert out["counts"][name]["launches"] > 0, name
            assert out["counts"][name]["plain_calls"] == 0, name
        assert out["state_bytes"] * 2 == one.state_bytes()


@pytest.mark.cuda
def test_cross_slice_mirror_on_card_counts_host_copies():
    """The cross-slice stream and mirror between two one-rank slices on
    card 0 over gloo: gloo stages a CUDA broadcast through the host, so
    every hop is counted as a host copy and none as device-to-device,
    and the replica's rows equal the primary's."""
    _need_cuda()
    import numpy as np
    from repro_torch.kvstore import LineCosts
    from repro_torch.meshserve.world import spawn
    cfg, _, _ = _reduced_starcoder()
    ranks = spawn("_torch_mesh_worker:card_stream", 2, device="cuda",
                  share_card=True, timeout=600)
    for out in ranks:
        for key in ("stream", "mirror"):
            d2d, d2d_bytes, host, host_bytes = out[key]
            assert d2d == d2d_bytes == 0, key
            assert host > 0 and host_bytes > 0, key
        assert out["moved"] == LineCosts.from_config(cfg).mirror_bytes(
            out["delta"])
    ra, rb = ranks[0]["rows_a"], ranks[1]["rows_b"]
    assert ra.shape == rb.shape and np.array_equal(ra, rb)
    assert np.abs(ra).max() > 0


@pytest.mark.cuda
def test_cluster_on_card_matches_cpu():
    """A 2-instance accellm cluster on the card serves the same requests
    as on the CPU: equal tokens and stats."""
    _need_cuda()
    import numpy as np

    from repro_torch.scheduling import LiveCluster
    from repro_torch.serving import Request
    cfg, p_cpu, p_card = _reduced_starcoder()
    shapes = [(8, 4), (12, 6), (6, 5), (10, 3), (7, 6), (9, 4)]
    out = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_card)):
        cluster = LiveCluster(cfg, params, 2, 8, 256, "accellm", device=dev)
        reqs = [Request(prompt_len=p, max_new_tokens=n, rid=i,
                        prompt_tokens=np.random.default_rng(i).integers(
                            0, cfg.vocab_size, (1, p), dtype=np.int32))
                for i, (p, n) in enumerate(shapes)]
        for r in reqs:
            cluster.submit(r)
        cluster.run(max_steps=200)
        out[dev] = ([r.output_tokens for r in reqs], dict(cluster.stats))
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][1]["mirror_syncs"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["accellm", "vllm"])
def test_fleet_kill_and_rejoin_on_card_matches_cpu(policy):
    """A 2-instance cluster loses instance 1 mid-serve and gets it back:
    on the card and on the CPU the fleet trace, its stats, the cluster's
    stats and every request's tokens are equal."""
    _need_cuda()
    import numpy as np

    from repro_torch.fleet import (FixedFleet, FleetController, JoinInstance,
                                   KillInstance)
    from repro_torch.scheduling import LiveCluster
    from repro_torch.serving import Request
    cfg, p_cpu, p_card = _reduced_starcoder()
    shapes = [(8, 14), (12, 16), (6, 15), (10, 12), (7, 16), (9, 14)]
    out = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_card)):
        fleet = FleetController(FixedFleet((KillInstance(5.0, 1),
                                            JoinInstance(9.0, 1))))
        cluster = LiveCluster(cfg, params, 2, 8, 256, policy, fleet=fleet,
                              device=dev)
        reqs = [Request(prompt_len=p, max_new_tokens=n, rid=i,
                        prompt_tokens=np.random.default_rng(i).integers(
                            0, cfg.vocab_size, (1, p), dtype=np.int32))
                for i, (p, n) in enumerate(shapes)]
        for r in reqs:
            cluster.submit(r)
        cluster.run(max_steps=300)
        out[dev] = ([r.output_tokens for r in reqs], dict(cluster.stats),
                    list(fleet.trace), dict(fleet.stats))
    assert out["cuda"] == out["cpu"]
    fs = out["cuda"][3]
    assert fs["kills"] == fs["joins"] == 1
    if policy == "accellm":
        assert fs["promotions"] > 0 and fs["reprefill_tokens"] == 0
    else:
        assert fs["requeues"] > 0 and fs["reprefill_tokens"] > 0


@pytest.mark.cuda
def test_prefix_cache_serve_on_card_matches_cpu():
    """A 2-instance accellm cluster with the prefix cache serves a
    shared-prefix stream on the card as on the CPU: equal hits, stats and
    plan trace; and in f32 its tokens equal the same serve's with the cache
    off (a hit's suffix prefill runs the prefill kernel at q_offset = hit
    over rows gathered from other slots)."""
    _need_cuda()
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.scheduling import LiveCluster
    from repro_torch.workloads import (Poisson, PrefixReuse, UniformLengths,
                                       WorkloadSpec)
    cfg, p_cpu, p_card = _reduced_starcoder()
    spec = WorkloadSpec(arrival=Poisson(rate=0.6, duration=14.0),
                        lengths=UniformLengths(prompt=(20, 40),
                                               decode=(3, 6)),
                        name="prefix-heavy",
                        prefix_reuse=PrefixReuse(pool=2, reuse=0.8,
                                                 prefix_len=16))
    out = {}
    for dev, params, cache in (("cpu", p_cpu, True), ("cuda", p_card, True),
                               ("cuda", p_card, False)):
        cluster = LiveCluster(cfg, params, 2, 4, 64, "accellm",
                              block_lines=8, prefix_cache=cache, device=dev)
        cluster.planner.trace = []
        reset_counts()
        done = cluster.run(max_steps=300,
                           source=spec.source(seed=3, cfg=cfg))
        out[dev, cache] = (
            {r.rid: r.output_tokens for r in done}, dict(cluster.stats),
            cluster.planner.trace, read_counts()["flash_attention"])
    on_cpu, on_card, off_card = (out["cpu", True], out["cuda", True],
                                 out["cuda", False])
    assert on_card[1]["prefix_hits"] > 0 and off_card[1]["prefix_hits"] == 0
    assert on_card[1:3] == on_cpu[1:3]
    assert on_card[0] == on_cpu[0] == off_card[0]
    assert on_card[3]["launches"] > 0 and on_card[3]["plain_calls"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "xlstm-1.3b",
                                  "seamless-m4t-large-v2", "internvl2-1b"])
def test_reduced_model_on_card_matches_cpu(arch):
    """The reduced model in f32 with the same weights (and modality
    payload) on the card and on the CPU: a 24-token prompt (for deepseek
    in chunks of 16 and 8, a resume at history 16; for seamless over its
    frames, for internvl2 behind its patches) and four greedy decode steps
    (for the vision model at t = P + S); the logits of each within
    1e-3 * max|logit|.  MLA and xLSTM launch no kernel; the encoder-decoder
    and vision stacks launch the prefill kernel once per attention layer
    (the encoder's non-causal) and the dense decode kernel once per layer
    and step, and nothing else."""
    _need_cuda()
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.models import (decode_step, init_params, init_state,
                                    prefill, prefill_chunk)
    from repro_torch.workloads import default_extras
    cfg = get_config(arch).reduced()
    p_cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    p_card = _to_card(p_cpu)
    extra = {k: torch.as_tensor(v)
             for k, v in (default_extras(cfg, 0, 0) or {}).items()}
    B = 1 if extra else 2
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, 24), dtype=np.int32))
    vision = cfg.frontend is not None and cfg.frontend.kind == "vision"
    t0 = 24 + (cfg.frontend.num_prefix_tokens if vision else 0)
    reset_counts()
    out = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_card)):
        st = init_state(cfg, B, 64, device=dev)
        if cfg.attention_kind == "mla":
            for lo, hi in ((0, 16), (16, 24)):
                logits, st = prefill_chunk(cfg, params, toks[:, lo:hi].to(dev),
                                           st, history=lo)
        else:
            batch = {"tokens": toks.to(dev),
                     **{k: v.to(dev) for k, v in extra.items()}}
            logits, st = prefill(cfg, params, batch, st)
        rows = [logits.cpu()]
        t = torch.full((B,), t0, dtype=torch.int32, device=dev)
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        for _ in range(4):
            logits, st = decode_step(cfg, params, tok, st, t)
            rows.append(logits.cpu())
            tok, t = logits.argmax(-1).to(torch.int32)[:, None], t + 1
        out[dev] = rows
    torch.cuda.synchronize()
    for a, b in zip(out["cuda"], out["cpu"]):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
    counts = read_counts()
    want = {name: {"launches": 0, "plain_calls": 0} for name in counts}
    if extra:  # each kernel ran once on the card and once plain on the CPU
        n_flash = cfg.num_layers + (cfg.encoder.num_layers
                                    if cfg.is_encoder_decoder else 0)
        want["flash_attention"] = {"launches": n_flash, "plain_calls": n_flash}
        want["decode_attention"] = {"launches": 4 * cfg.num_layers,
                                    "plain_calls": 4 * cfg.num_layers}
    assert counts == want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", [
    # (B, Sq, Skv, H, KVH, hd): the prefill kernel with causal=False
    (1, 1024, 1024, 16, 16, 64),           # an encoder's shape, shorter
    (2, 77, 300, 16, 16, 64),              # Sq < Skv, edges off the tiles
    (2, 300, 131, 14, 2, 64),              # Sq > Skv, G 7
])
def test_flash_noncausal_matches_plain_on_card(case, dtype, tol):
    _need_cuda()
    B, Sq, Skv, H, KVH, hd = case
    g = torch.Generator(device="cuda").manual_seed(Sq * Skv)
    q = torch.randn((B, Sq, H, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, Skv, KVH, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, Skv, KVH, hd), generator=g, device="cuda").to(dtype)
    out = flash_attention_cuda(q, k, v, causal=False)
    exp = flash_attention_torch(q, k, v, causal=False).float()
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        # every row averages all Skv values, so outputs are ~sqrt(e / Skv)
        # (0.05 at 1024): 2e-2 alone would pass a dropped 64-key tile
        tol = min(tol, 0.05 * float(exp.pow(2).mean().sqrt()))
    assert float((out.float() - exp).abs().max()) <= tol

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "internvl2-1b"])
def test_engine_takes_card_payload(arch):
    """``prefill_request`` takes a modality payload already on the card,
    and gives the tokens that the same payload in numpy gives."""
    _need_cuda()
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving.engine import InstanceEngine
    from repro_torch.serving.request import Request
    from repro_torch.workloads import default_extras
    cfg = get_config(arch).reduced()
    params = _to_card(init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu"))
    extra = default_extras(cfg, 0, 0)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 6),
                                               dtype=np.int32)
    toks = []
    for payload in (extra, {k: torch.as_tensor(v, device="cuda")
                            for k, v in extra.items()}):
        eng = InstanceEngine(cfg, params, num_slots=2, kv_capacity=32)
        req = Request(prompt_len=6, max_new_tokens=4, prompt_tokens=prompt)
        eng.prefill_request(req, payload)
        while eng.slot_req:
            eng.decode()
        toks.append(list(req.output_tokens))
    assert toks[0] == toks[1] and len(toks[0]) == 4


def _live(tree):
    return torch.utils._pytree.tree_map(
        lambda x: x.detach().requires_grad_(True), tree)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minicpm-2b", "jamba-1.5-large-398b"])
def test_train_step_on_card_matches_cpu(arch):
    """Step 1's gradient on the card (f32, TF32 off) against the CPU's;
    the attention and MLP leaves' grads are nonzero; no kernel ran."""
    _need_cuda()
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.models import init_params
    from repro_torch.training import (AdamWConfig, DataConfig, batches,
                                      init_opt_state, train_step)
    from repro_torch.training.train_step import grads_of
    cfg = get_config(arch).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = torch.from_numpy(next(batches(DataConfig(cfg.vocab_size, 128, 2))))
    batch = {"tokens": b[:, :-1], "labels": b[:, 1:]}
    on = lambda t: torch.utils._pytree.tree_map(lambda x: x.cuda(), t)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        reset_counts()
        _, _, g_cpu = grads_of(cfg, params, batch)
        _, _, g_card = grads_of(cfg, on(params), on(batch))
        opt = AdamWConfig()
        new, _, m = train_step(cfg, opt, on(params),
                               init_opt_state(opt, on(params)), on(batch),
                               1.0)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert all(c == {"launches": 0, "plain_calls": 0}
               for c in read_counts().values())
    assert np.isfinite(float(m["loss"]))
    flat_cpu = torch.utils._pytree.tree_flatten_with_path(g_cpu)[0]
    flat_card = torch.utils._pytree.tree_flatten(g_card)[0]
    for (path, a), c in zip(flat_cpu, flat_card):
        name = torch.utils._pytree.keystr(path)
        scale = float(a.abs().max())
        assert float((a - c.cpu()).abs().max()) <= 1e-4 * scale, name
        if any(k in name for k in ("'wq'", "'wk'", "'wv'", "'wo'",
                                   "'w_gate'", "'w_up'", "'w_down'",
                                   "'in_proj'")):
            assert scale > 0, name


@pytest.mark.cuda
def test_kernel_wrappers_refuse_grad_on_card():
    _need_cuda()
    q = torch.randn((1, 128, 2, 64), device="cuda", requires_grad=True)
    kv = torch.randn((1, 128, 1, 64), device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_cuda(q, kv, kv.clone())
    x = torch.randn((1, 16, 32), device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        mamba_scan_cuda(x, x.detach().abs(), torch.randn((1, 16, 8),
                        device="cuda"), torch.randn((1, 16, 8),
                        device="cuda"), -torch.rand((32, 8), device="cuda"),
                        torch.randn(32, device="cuda"),
                        torch.zeros((1, 32, 8), device="cuda"))
    with torch.no_grad():
        out = flash_attention_cuda(q, kv, kv.clone())
    assert out.grad_fn is None


def _graph_script(cfg, params, graphs: bool, temperature: float):
    """One engine on the card through a scripted decode, with its CUDA
    graphs or (``graphs`` False) through the eager loop: rows 3, then 5;
    a 4-step plan in which a budget-1 row ends after one iteration and is
    released; tables growing past 1, 2 and 4 blocks (rebuilds); 17 rows
    (the padded key of 32); plans of 3 steps as rows finish.  Returns the
    tokens, the kernel counts, the tracer's counters and the engine."""
    import numpy as np

    from repro_torch.core.tracing import Tracer
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.serving import InstanceEngine, Request
    tracer = Tracer()
    eng = InstanceEngine(cfg, params, num_slots=24, kv_capacity=64,
                         block_lines=8, temperature=temperature, seed=5,
                         device="cuda", tracer=tracer)
    if not graphs:
        eng._graphs = None
    rng = np.random.default_rng(1)

    def mk(p, n):
        return Request(prompt_len=p, max_new_tokens=n,
                       prompt_tokens=rng.integers(0, cfg.vocab_size, (1, p),
                                                  dtype=np.int32))

    reqs = [mk(5, 12), mk(9, 30), mk(3, 20)]
    for r in reqs:
        eng.prefill_request(r)
    reset_counts()
    eng.decode_multi(steps=1)
    eng.decode_multi(steps=1)
    late = [mk(7, 2), mk(4, 25)]
    for r in late:
        eng.prefill_request(r)
    reqs += late
    eng.decode_multi(steps=4)
    assert len(late[0].output_tokens) == 2 and late[0].rid not in \
        eng.store.rid_slot, "the budget-1 row did not end mid-plan"
    for _ in range(3):
        eng.decode_multi(steps=2)
    many = [mk(3 + i % 5, 6) for i in range(14)]
    for r in many:
        eng.prefill_request(r)
    reqs += many
    assert len(eng.slot_req) == 17
    for _ in range(4):
        eng.decode_multi(steps=1)
    while eng.slot_req:
        eng.decode_multi(steps=3)
    torch.cuda.synchronize()
    return ([r.output_tokens for r in reqs], read_counts(),
            dict(tracer.counters), eng)


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_decode_graphs_on_card_match_eager(temperature):
    """The engine's CUDA graphs against its eager loop on the same
    weights and script (``_graph_script``): equal tokens, equal kernel
    counts (each replay credits its captured launches), and capture +
    replay counting every plan; a padded key was met, and the tables were
    rebuilt as they grew."""
    _need_cuda()
    cfg, _, p_card = _reduced_starcoder()
    toks, counts, ctr, eng = _graph_script(cfg, p_card, True, temperature)
    want, want_counts, ctr_e, _ = _graph_script(cfg, p_card, False,
                                                temperature)
    assert toks == want
    assert counts == want_counts
    assert counts["paged_decode_attention"]["launches"] > 0
    assert counts["paged_decode_attention"]["plain_calls"] == 0
    plans = ctr["d2h.decode"]
    assert plans == ctr_e["d2h.decode"] == ctr_e["decode.graph.eager"]
    assert ctr["decode.graph.capture"] + ctr["decode.graph.replay"] == plans
    assert "decode.graph.eager" not in ctr
    assert ctr["decode.graph.replay"] > 0
    assert any(rows == 32 for rows, _ in eng._graphs.graphs)
    assert ctr["tables.rebuild"] >= 4 and ctr_e["tables.rebuild"] >= 4


@pytest.mark.cuda
def test_decode_graph_replays_run_the_credited_launches_on_card():
    """A replay calls no wrapper, so its kernel launches are credited: over
    a plan of replays alone, the paged kernel's activities in the
    profiler's trace (the graph's kernel nodes, by name) are the launches
    credited, one a layer and iteration."""
    _need_cuda()
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.tracing import Tracer
    from repro_torch.kernels import counts_since, read_counts
    from repro_torch.serving import InstanceEngine, Request
    cfg, _, p_card = _reduced_starcoder()
    tracer = Tracer()
    eng = InstanceEngine(cfg, p_card, num_slots=8, kv_capacity=64,
                         block_lines=8, device="cuda", tracer=tracer)
    rng = np.random.default_rng(2)
    for p in (5, 9, 3):
        eng.prefill_request(Request(
            prompt_len=p, max_new_tokens=20,
            prompt_tokens=rng.integers(0, cfg.vocab_size, (1, p),
                                       dtype=np.int32)))
    eng.decode_multi(steps=2)          # captures the key (3 rows, 2 blocks)
    torch.cuda.synchronize()
    before = read_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.decode_multi(steps=4)
        torch.cuda.synchronize()
    credited = counts_since(before)["paged_decode_attention"]["launches"]
    ran = sum(ev.count for ev in prof.key_averages()
              if "paged_kernel" in ev.key)
    assert tracer.counters["decode.graph.capture"] == 1
    assert tracer.counters["decode.graph.replay"] == 1
    assert credited == ran == 4 * cfg.num_layers


@pytest.mark.cuda
def test_padded_rows_keep_live_logits_on_card():
    """A padded key's pad rows repeat the last live row: the live rows'
    logits of a 17-row paged decode step padded to 32 stay within 1e-4 x
    max|logit| of the unpadded step's (the GEMMs see another M), with
    equal greedy tokens, and the pad rows' logits are the last row's."""
    _need_cuda()
    import numpy as np

    from repro_torch.models import decode_step_paged, init_state
    cfg, _, p_card = _reduced_starcoder()
    rng = np.random.default_rng(3)
    n, pad, W, bl = 17, 32, 64, 8
    g = torch.Generator(device="cuda").manual_seed(7)
    state = torch.utils._pytree.tree_map(
        lambda x: torch.randn(x.shape, generator=g, device="cuda"),
        init_state(cfg, 24, W, device="cuda"))
    slots = rng.permutation(24)[:n].astype(np.int32)
    t = rng.integers(5, W - 1, n).astype(np.int32)
    toks = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
    idx = np.r_[np.arange(n), np.full(pad - n, n - 1)]
    tables = (slots[:, None] * (W // bl) + np.arange(W // bl)).astype(
        np.int32)

    def step(rows):
        st = torch.utils._pytree.tree_map(torch.clone, state)
        on = lambda a: torch.as_tensor(a[rows], device="cuda")  # noqa: E731
        logits, _ = decode_step_paged(cfg, p_card, on(toks)[:, None], st,
                                      on(t), on(slots), on(tables), bl)
        return logits

    live = step(np.arange(n))
    padded = step(idx)
    torch.cuda.synchronize()
    scale = float(live.abs().max())
    assert float((padded[:n] - live).abs().max()) <= 1e-4 * scale
    assert torch.equal(padded[:n].argmax(-1), live.argmax(-1))
    assert torch.equal(padded[n:], padded[n - 1:n].expand(pad - n, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["accellm", "vllm"])
def test_cluster_decode_graphs_on_card_match_eager(policy):
    """A 2-instance cluster (fused up to 4 steps) on the card with the
    engines' CUDA graphs and again with every engine eager: equal tokens,
    stats and kernel counts; the three graph counters add up to the plans
    (one host read each)."""
    _need_cuda()
    import numpy as np

    from repro_torch.core.tracing import Tracer
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.scheduling import LiveCluster
    from repro_torch.serving import Request
    cfg, _, p_card = _reduced_starcoder()
    shapes = [(8, 14), (12, 16), (6, 15), (10, 12), (7, 16), (9, 14),
              (11, 9), (5, 13)]
    out = {}
    for graphs in (True, False):
        tracer = Tracer()
        cluster = LiveCluster(cfg, p_card, 2, 8, 256, policy,
                              fuse_decode_steps=4, device="cuda",
                              tracer=tracer)
        if not graphs:
            for eng in cluster.engines:
                eng._graphs = None
        reqs = [Request(prompt_len=p, max_new_tokens=n, rid=i,
                        prompt_tokens=np.random.default_rng(i).integers(
                            0, cfg.vocab_size, (1, p), dtype=np.int32))
                for i, (p, n) in enumerate(shapes)]
        reset_counts()
        for r in reqs:
            cluster.submit(r)
        cluster.run(max_steps=300)
        c = tracer.counters
        assert sum(c.get("decode.graph." + k, 0) for k in
                   ("capture", "replay", "eager")) == c["d2h.decode"]
        assert (c.get("decode.graph.eager", 0) == 0) == graphs
        out[graphs] = ([r.output_tokens for r in reqs], dict(cluster.stats),
                       read_counts())
    assert out[True] == out[False]
