"""Train a ~100M-param model for a few hundred steps on the synthetic
pipeline, with the WSD schedule and a checkpoint saved and restored: the
port's counterpart of the JAX package's ``examples/train_small.py``,
through the training launcher's loop.

Run: PYTHONPATH=src python -m repro_torch.launch.train_small [--steps 300]
     [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Optional

import torch
from torch.utils._pytree import tree_flatten

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.launch.train import train_loop
from repro_torch.models import init_params
from repro_torch.training import (AdamWConfig, DataConfig, batches,
                                  init_opt_state, wsd)
from repro_torch.training.checkpoint import restore, save


def build_100m():
    """A ~100M-parameter MiniCPM-family model (WSD is its native recipe)."""
    base = get_config("minicpm-2b")
    return dataclasses.replace(
        base, name="minicpm-100m", num_layers=8, d_model=768, num_heads=12,
        num_kv_heads=12, head_dim=64, d_ff=2048, vocab_size=32768,
        block_pattern=tuple(["attn"] * 8), dtype="float32",
        residual_scale=1.4 / 8 ** 0.5, logit_scale=256.0 / 768.0)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint path (default: a temporary directory)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = build_100m()
    print(f"model {cfg.name}: {cfg.param_count() / 1e6:.0f}M params")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    opt_cfg = AdamWConfig(lr=6e-4)
    data = batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                              global_batch=args.batch, seed=0))
    params, _, losses = train_loop(
        cfg, opt_cfg, params, init_opt_state(opt_cfg, params), data,
        steps=args.steps, schedule=wsd, warmup=20, extras={}, device=dev,
        log_every=25, line="step {i:4d} loss={loss:.4f} lr={lr:.3f} "
                           "gnorm={gnorm:.2f} tok/s={tok_s:.0f}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"loss did not improve: {losses[0]:.4f} -> "
                         f"{losses[-1]:.4f}")
    with tempfile.TemporaryDirectory() as tmp:
        path = args.ckpt or os.path.join(tmp, "train_small.npz")
        save(path, params)
        restored = restore(path, params)
    before, after = tree_flatten(params)[0], tree_flatten(restored)[0]
    if len(before) != len(after) or not all(
            torch.equal(a, b) for a, b in zip(before, after)):
        raise SystemExit("the restored checkpoint differs from the params")
    print(f"checkpoint saved+restored at {path}; final loss "
          f"{losses[-1]:.4f} (from {losses[0]:.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
