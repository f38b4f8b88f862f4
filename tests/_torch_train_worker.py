"""The port's side of the sharded train step's parity tests, run in a
gloo world of 4 CPU processes: a (data 2, model 2) mesh, rank
``2 * data + model``.

``tests/test_torch_train_mesh.py`` starts :func:`families` on the world
(``repro_torch.meshserve.world.spawn``).  This module imports torch,
numpy and the port only, never JAX nor the JAX package, and hands
everything back as numpy.  A payload with ``seq`` runs with
``REPRO_SEQ_PARALLEL=1`` set in the rank (sequence parallelism), and
unset after.
"""
import contextlib
import dataclasses
import os

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.training import AdamWConfig, init_opt_state
from repro_torch.training.fsdp import train_mesh
from repro_torch.training.optimizer import global_norm
from repro_torch.training.train_step import make_train_step

MESH = (2, 2)
OPT = AdamWConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0)
#: the WSD schedule of the one-device train step's test (warmup 1 of 3)
LR = (0.0, 1.0, 1.0)


def config(arch, capacity=None, heads=None):
    """The reduced f32 config; ``capacity`` overrides the MoE capacity
    factor ("dropless": ``num_experts / top_k``), ``heads`` the fields
    it names (``num_heads``, ``num_kv_heads``)."""
    cfg = get_config(arch).reduced()
    if heads:
        cfg = dataclasses.replace(cfg, **heads)
    if capacity is not None and cfg.moe is not None:
        cf = (cfg.moe.num_experts / cfg.moe.top_k if capacity == "dropless"
              else capacity)
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return cfg


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return tree.detach().float().numpy().copy()


def _batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


class _Calls:
    """Counts the ``torch.distributed`` collectives issued while active:
    (kind, result bytes, group size) -> calls."""

    OPS = {"all_reduce": "all-reduce", "all_gather_single": "all-gather",
           "all_gather_into_tensor": "all-gather",
           "reduce_scatter_single": "reduce-scatter",
           "reduce_scatter_tensor": "reduce-scatter",
           "all_to_all_single": "all-to-all"}

    def __init__(self):
        self.log = {}

    def __enter__(self):
        import torch.distributed as dist
        self.saved = {}
        for name, kind in self.OPS.items():
            plain = getattr(dist, name, None)
            if plain is None:
                continue
            self.saved[name] = plain

            def wrapped(*args, _plain=plain, _kind=kind, group=None,
                        **kw):
                out = args[0]
                key = (_kind, out.numel() * out.element_size(),
                       dist.get_world_size(group))
                self.log[key] = self.log.get(key, 0) + 1
                return _plain(*args, group=group, **kw)

            setattr(dist, name, wrapped)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for name, plain in self.saved.items():
            setattr(dist, name, plain)


@contextlib.contextmanager
def seq_parallel(on: bool):
    """``REPRO_SEQ_PARALLEL`` set to "1" while active where ``on``."""
    saved = os.environ.pop("REPRO_SEQ_PARALLEL", None)
    if on:
        os.environ["REPRO_SEQ_PARALLEL"] = "1"
    try:
        yield
    finally:
        os.environ.pop("REPRO_SEQ_PARALLEL", None)
        if saved is not None:
            os.environ["REPRO_SEQ_PARALLEL"] = saved


def run_family(payload, rank):
    """One config on this rank: grads of the first batch, then 3 AdamW
    steps; this rank's part of each, the step losses and norms."""
    with seq_parallel(payload.get("seq", False)):
        return _run_family(payload, rank)


def _run_family(payload, rank):
    cfg = config(payload["arch"], payload.get("capacity"),
                 payload.get("heads"))
    mesh = dataclasses.replace(train_mesh(*MESH), moe_strategy=payload.get(
        "strategy", "auto"))
    step = make_train_step(cfg, OPT, mesh)
    whole = params_from_numpy(payload["params"], device="cpu")
    params = step.shard(whole)
    del whole
    batches = [_batch(b) for b in payload["batches"]]
    with step.mesh.install(step.dims):
        _, _, grads = step.grads(params, batches[0])
        gnorm = global_norm(grads, step.cuts)
    opt = init_opt_state(OPT, params)
    out = {"grads": _np(grads), "grad_norm": float(gnorm), "losses": [],
           "norms": []}
    calls = _Calls() if payload.get("count") else None
    for i, b in enumerate(batches):
        if calls is not None and i == 0:
            with calls:
                params, opt, metrics = step(params, opt, b, LR[i])
            out["calls"] = dict(calls.log)
        else:
            params, opt, metrics = step(params, opt, b, LR[i])
        out["losses"].append(float(metrics["loss"]))
        out["norms"].append(float(metrics["grad_norm"]))
    out["params"] = _np(params)
    out["moments"] = _np({"m": opt.m, "v": opt.v})
    out["rank"] = rank
    out["cut"] = (mesh.data_rank, mesh.model_rank)
    return out


def families(rank, world, payloads):
    torch.manual_seed(0)
    return {name: run_family(p, rank) for name, p in payloads.items()}
