"""Training launcher: run the training substrate end to end on any
architecture, a copy of the JAX package's ``repro.launch.train`` on the
port, with the same flags plus ``--device``: it trains on the card unless
``--device cpu`` asks for the CPU.  Reduced configs by default;
``--full-config`` trains the published widths.

The step runs eagerly (the JAX launcher jits it).  A VLM's patch
embeddings and an enc-dec model's 32 frames are drawn once from
``np.random.default_rng(7)``, standard normal in f32, and fed to every
step, where the JAX launcher draws them from ``jax.random.PRNGKey(7)``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
      --steps 100 --device cpu [--schedule wsd] [--ckpt /tmp/ckpt.npz]
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import init_params
from repro_torch.training import (SCHEDULES, AdamWConfig, DataConfig,
                                  batches, init_opt_state, make_train_step)
from repro_torch.training.checkpoint import save

#: frames per enc-dec training example, as the JAX launcher feeds
ENC_FRAMES = 32
#: the JAX launcher's progress line
LINE = "step {i:4d} loss={loss:.4f} lr={lr:.3f} tok/s={tok_s:.0f}"


def modality_extras(cfg: ModelConfig, batch: int, device
                    ) -> Dict[str, torch.Tensor]:
    """The front-end payload a training batch needs: (batch, P, E) patch
    embeddings for a VLM, (batch, 32, E) frames for an enc-dec model,
    nothing for text-only configs."""
    rng = np.random.default_rng(7)      # the JAX launcher's fixed key
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        shape = (batch, cfg.frontend.num_prefix_tokens,
                 cfg.frontend.embed_dim)
        name = "patch_embeds"
    elif cfg.is_encoder_decoder:
        shape = (batch, ENC_FRAMES, cfg.frontend.embed_dim)
        name = "frames"
    else:
        return {}
    return {name: torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(device)}


def train_loop(cfg: ModelConfig, opt_cfg: AdamWConfig, params, opt,
               data: Iterator[np.ndarray], *, steps: int,
               schedule: Callable, warmup: int, extras: Dict, device,
               log_every: int, line: str = LINE,
               log: Callable[[str], None] = print):
    """``steps`` optimizer steps over ``data`` under ``schedule``; logs
    ``line`` (formatted with ``i``, ``loss``, ``lr``, ``gnorm`` and
    ``tok_s``) every ``log_every`` steps and at the last.  Returns
    (params, opt, losses)."""
    step_fn = make_train_step(cfg, opt_cfg)
    losses = []
    t0 = time.time()
    for i, b in zip(range(steps), data):
        b = torch.from_numpy(b).to(device)
        batch = {"tokens": b[:, :-1], "labels": b[:, 1:], **extras}
        lr = schedule(i, warmup=warmup, total=steps)
        params, opt, m = step_fn(params, opt, batch, lr)
        losses.append(float(m["loss"]))
        if i % log_every == 0 or i == steps - 1:
            tok_s = b.shape[0] * (b.shape[1] - 1) * (i + 1) / (time.time()
                                                              - t0)
            log(line.format(i=i, loss=losses[-1], lr=float(lr),
                            gnorm=float(m["grad_norm"]), tok_s=tok_s))
    return params, opt, losses


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", default="wsd", choices=list(SCHEDULES))
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    print(f"training {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"{args.steps} steps, schedule={args.schedule}")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    opt_cfg = AdamWConfig(lr=args.lr)
    opt = init_opt_state(opt_cfg, params)
    data = batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                              global_batch=args.batch, seed=0))
    every = max(args.steps // 10, 1)
    params, opt, losses = train_loop(
        cfg, opt_cfg, params, opt, data, steps=args.steps,
        schedule=SCHEDULES[args.schedule], warmup=every,
        extras=modality_extras(cfg, args.batch, dev), device=dev,
        log_every=every)
    if args.ckpt:
        save(args.ckpt, params)
        print(f"checkpoint: {args.ckpt}")
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return 0 if losses[-1] < losses[0] else 1


if __name__ == "__main__":
    raise SystemExit(main())
