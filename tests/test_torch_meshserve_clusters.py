"""Mesh clusters of the hybrid, xLSTM and encoder-decoder stacks, held
against the port's host cluster and the JAX package's mesh cluster on
the CPU.

Each family's cluster runs two AcceLLM instances on two tp-2 slices of
one gloo world of 4 CPU processes (``_torch_mesh_worker.family_clusters``,
which imports no JAX), on six numpy-seeded requests with their modality
payloads, the reduced f32 configs and the JAX package's weights bridged
through numpy.  On every rank the stats, the kernel's decision trace and
the tokens agree; they equal a host cluster's (the port's, one process,
whole engines) and the JAX package's mesh cluster's (on its 8 forced CPU
devices): its stats (mirror syncs, mirror and stream bytes, promotions,
prefills, decode steps) and its tokens.  Every cross-slice hop stays
device-to-device (``host_copies == 0``), the recurrent states' channel and
head blocks included.  jamba's MoE dispatch runs at its published
capacity factor 1.25, whose per-shard ``a2a`` capacity changes its tokens
against one device (``test_torch_meshserve_families.py``): its tokens are
held to the JAX package's mesh cluster only.  ``api.serve`` with
``ServeSpec(mesh_tp=2, device="cpu")`` on xlstm-1.3b equals the host
serve.
"""
import jax
import numpy as np
import pytest

import repro.configs as rcfg
import repro.models as rm
from repro.meshserve import MeshPlacement as RPlacement
from repro.scheduling.accellm import AcceLLMScheduler as RScheduler
from repro.scheduling.live import LiveCluster as RLiveCluster
from repro.serving import Request as RRequest
import repro_torch.api as tapi
import repro_torch.configs as tcfg
from repro_torch.bridge import params_from_numpy
from repro_torch.meshserve.world import spawn
import _torch_mesh_worker as W

ARCHS = ("jamba-1.5-large-398b", "xlstm-1.3b", "seamless-m4t-large-v2")
SHAPES = [(6 + i % 5, 5) for i in range(6)]
STATS_KEYS = ("mirror_syncs", "mirror_bytes", "stream_bytes",
              "replica_promotions", "prefills", "decode_steps")


@pytest.fixture(scope="module")
def bridged():
    out = {}
    for arch in ARCHS:
        cfg_r = rcfg.get_config(arch).reduced()
        params_r = rm.init_params(jax.random.PRNGKey(0), cfg_r)
        out[arch] = (cfg_r, tcfg.get_config(arch).reduced(), params_r,
                     jax.tree_util.tree_map(np.asarray, params_r))
    return out


@pytest.fixture(scope="module")
def world(bridged):
    return spawn("_torch_mesh_worker:family_clusters", 4, device="cpu",
                 args=({"params": {a: v[3] for a, v in bridged.items()},
                        "shapes": SHAPES},), timeout=600)


def _reference(cfg_r, params_r, cfg):
    """The JAX package's mesh cluster on the same requests: stats and
    tokens."""
    ref = RLiveCluster(cfg_r, params_r, n_instances=2, num_slots=6,
                       kv_capacity=64, policy=RScheduler(),
                       mesh=RPlacement.carve(2, tp=2))
    reqs = [RRequest(prompt_len=p, max_new_tokens=d, rid=i,
                     prompt_tokens=W.prompt(i, p, cfg.vocab_size, seed=11))
            for i, (p, d) in enumerate(SHAPES)]
    for r, extra in zip(reqs, W.family_extras(cfg, len(reqs), seed=11)):
        ref.submit(r, extra)
    assert len(ref.run(max_steps=200)) == len(SHAPES)
    return ref.stats, [list(map(int, r.output_tokens)) for r in reqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_cluster_matches_host_and_reference(mesh8, bridged, world,
                                                 arch):
    cfg_r, cfg, params_r, params_np = bridged[arch]
    runs = [out[arch] for out in world]
    for key in ("stats", "trace", "tokens"):
        assert all(r[key] == runs[0][key] for r in runs), key
    mine = runs[0]
    assert mine["finished"] == len(SHAPES)
    for r, run in enumerate(runs):
        d2d, host = run["transfers"]
        assert d2d > 0 and host == 0, (r, d2d, host)
    assert mine["stats"]["mirror_syncs"] > 0
    host = W.family_cluster(cfg, params_from_numpy(params_np, device="cpu"),
                            SHAPES, mesh=False)
    assert mine["stats"] == host["stats"]
    assert mine["trace"] == host["trace"]
    if cfg.moe is None:
        assert mine["tokens"] == host["tokens"]
    # rank r holds its part of instance r // 2's pool, smaller than the
    # host's, and nothing of the other's
    for r, run in enumerate(runs):
        for i, (p, h) in enumerate(zip(run["pools"], host["pools"])):
            assert (0 < p < h) if i == r // 2 else p == 0, (r, i, p, h)
    stats, tokens = _reference(cfg_r, params_r, cfg)
    for key in STATS_KEYS:
        assert mine["stats"][key] == stats[key], key
    assert mine["tokens"] == tokens


def test_api_serve_mesh_tp_xlstm(world):
    runs = [out["serve"] for out in world]
    for key in ("stats", "tokens"):
        assert all(r[key] == runs[0][key] for r in runs), key
    rep = tapi.serve(tapi.ServeSpec(arch="xlstm-1.3b", n_instances=2,
                                    num_slots=4, kv_capacity=64, n_requests=6,
                                    request_scale=0.02, device="cpu"))
    assert runs[0]["finished"] == len(rep.finished) == 6
    assert runs[0]["stats"] == rep.stats
    assert runs[0]["tokens"] == sorted((r.rid, tuple(r.output_tokens))
                                       for r in rep.finished)
