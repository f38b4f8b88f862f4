"""Starting a world of ranks for mesh serving: one process per rank.

:func:`spawn` starts ``world`` processes (``spawn`` start method), each
of which joins one ``torch.distributed`` world through a rendezvous file
in a fresh temporary directory and calls ``target(rank, world, *args)``;
it returns every rank's result, in rank order.  A rank that fails stops
the others, and its traceback is raised here; a rank whose process dies
after it has handed its result over has not failed (its exit code is
logged).

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
import logging
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

_LOG = logging.getLogger(__name__)


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
        # written whole, then renamed: the parent never reads half a file
        tmp = out.with_suffix(".tmp")
        tmp.write_bytes(pickle.dumps(payload))
        os.replace(tmp, out)
    if payload[0] != "ok":
        raise SystemExit(1)


def _result(root: str, rank: int):
    """A rank's (status, value), or None before it has written one."""
    path = Path(root) / f"rank{rank}.pkl"
    return pickle.loads(path.read_bytes()) if path.exists() else None


def _reap(procs, wait: float = 10.0) -> None:
    """Give ranks that handed over their results ``wait`` seconds to exit,
    and log any that exits with an error code or a signal, or is still
    running (then it is stopped); it has not failed: its result is in."""
    deadline = time.monotonic() + wait
    for r, p in enumerate(procs):
        p.join(max(0.0, deadline - time.monotonic()))
        if p.exitcode is None:
            _LOG.warning("rank %d still runs %.0f s after handing over its "
                         "result; stopping it", r, wait)
        elif p.exitcode:
            _LOG.warning("rank %d exited with code %d after handing over "
                         "its result", r, p.exitcode)


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
        # wait until every rank has its result, or one rank failed (an
        # error, or an exit with no result); a rank whose process dies
        # after it wrote its result (in the backend's teardown, say) has
        # not failed
        got: List[Any] = [None] * world
        while True:
            got = [g if g is not None else _result(root, r)
                   for r, g in enumerate(got)]
            if all(g is not None and g[0] == "ok" for g in got):
                break
            if any(g is not None and g[0] != "ok" for g in got) or any(
                    g is None and p.exitcode is not None
                    for g, p in zip(got, procs)):
                break
            if deadline is not None and time.monotonic() > deadline:
                break
            time.sleep(0.05)
        results, errors = [], []
        for r, (g, p) in enumerate(zip(got, procs)):
            if g is None:
                errors.append(f"rank {r}: exit code {p.exitcode} "
                              f"(no result)")
            elif g[0] == "ok":
                results.append(g[1])
            else:
                errors.append(f"rank {r}:\n{g[1]}")
        if errors:
            raise RuntimeError(f"{target} on a world of {world} failed:\n"
                               + "\n".join(errors))
        _reap(procs)
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
