"""Starting a world of ranks for mesh serving: one process per rank.

:func:`spawn` starts ``world`` processes (``spawn`` start method), each
of which joins one ``torch.distributed`` world through a rendezvous file
in a fresh temporary directory and calls ``target(rank, world, *args)``;
it returns every rank's result, in rank order.  A rank that fails stops
the others, and its traceback is raised here.

The backend follows the device:
  * ``"cpu"``: gloo;
  * ``"cuda"``, one process per card (the default): NCCL for CUDA tensors
    and gloo for the host's (``"cpu:gloo,cuda:nccl"``), rank ``r`` on card
    ``r``; a host with fewer cards than ranks raises :class:`MeshError`
    (NCCL puts one rank on one card);
  * ``"cuda"`` with ``share_card``: every rank on card 0 over gloo, which
    stages CUDA collectives through the host: a check of the sharded
    compute and of the kernels at per-rank shapes, not of a card-to-card
    wire.
"""
from __future__ import annotations

import importlib
import os
import pickle
import shutil
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, List, Optional, Sequence

import torch

from repro_torch.core.device import resolve_device
from repro_torch.meshserve.topology import MeshError


def _child(target: str, rank: int, world: int, device: str,
           share_card: bool, root: str, args: Sequence, threads: int):
    import torch.distributed as dist
    out = Path(root) / f"rank{rank}.pkl"
    try:
        torch.set_num_threads(threads)
        backend = "gloo"
        if device == "cuda":
            torch.cuda.set_device(0 if share_card else rank)
            if not share_card:
                backend = "cpu:gloo,cuda:nccl"
        dist.init_process_group(backend, init_method=f"file://{root}/rdv",
                                rank=rank, world_size=world)
        mod, name = target.split(":")
        result = getattr(importlib.import_module(mod), name)(rank, world,
                                                              *args)
        payload = ("ok", result)
    except BaseException:                       # reported to the parent
        payload = ("error", traceback.format_exc())
    try:
        if dist.is_initialized():
            dist.destroy_process_group()
    finally:
        out.write_bytes(pickle.dumps(payload))
    if payload[0] != "ok":
        raise SystemExit(1)


def spawn(target: str, world: int, *, device: str = "cuda",
          share_card: bool = False, args: Sequence = (),
          timeout: Optional[float] = None, threads: int = 1) -> List[Any]:
    """Run ``target`` ("module:function") on ranks ``0 .. world - 1``;
    returns each rank's result.  ``threads`` caps each rank's intra-op
    threads (the ranks share the host's cores)."""
    import torch.multiprocessing as mp
    dev = resolve_device(device)
    if dev.type == "cuda" and not share_card \
            and torch.cuda.device_count() < world:
        raise MeshError(
            f"the pod needs {world} cards, one process per card, but this "
            f"host has {torch.cuda.device_count()}")
    root = tempfile.mkdtemp(prefix="repro_torch_world_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(
        target, r, world, dev.type, share_card, root, tuple(args), threads))
        for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            failed = [p for p in procs if p.exitcode not in (None, 0)]
            if failed or (deadline is not None
                          and time.monotonic() > deadline):
                break
            time.sleep(0.05)
        results, errors = [], []
        for r, p in enumerate(procs):
            path = Path(root) / f"rank{r}.pkl"
            if p.is_alive() or not path.exists():
                errors.append(f"rank {r}: exit code {p.exitcode} "
                              f"(no result)")
                continue
            status, value = pickle.loads(path.read_bytes())
            if status == "ok":
                results.append(value)
            else:
                errors.append(f"rank {r}:\n{value}")
        if errors:
            raise RuntimeError(f"{target} on a world of {world} failed:\n"
                               + "\n".join(errors))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
                if p.is_alive():
                    p.kill()
            p.join()
        shutil.rmtree(root, ignore_errors=True)
