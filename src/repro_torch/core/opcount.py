"""Operation counting for the dry run on the meta device.

:class:`Counter` is ``torch.utils.flop_counter.FlopCounterMode`` plus a
tally of credited operations.  Two things credit it, and both act only on
meta tensors:

* **Kernel wrappers.**  On a meta tensor a kernel wrapper returns an
  output of the kernel's shape, launches nothing and calls no plain
  version; it credits the active counter with the kernel's own operation
  count, the one its bound in ``chip_smoke.py`` uses (:func:`credit`).
* **Trip counts** (the counterpart of XLA's ``known_trip_count``).  A
  Python loop whose trip count grows with the sequence goes through
  :func:`steps`.  On meta tensors it runs its body for real until the
  body's inputs (shapes, dtypes, which require grad) repeat, and for the
  last trip; every trip between is credited with the body's operations,
  measured once by a replay of the body on detached inputs in a thread of
  its own (its own dispatch-mode stack, so the replay is not traced
  twice): forward, and backward when a backward will follow (grad on and
  the outputs require it).  Under activation checkpointing the recompute,
  which runs inside the backward, is credited its forward only: the
  checkpoint runs it under :func:`recomputing` (``blocks`` passes
  :func:`remat_contexts` as its ``context_fn``).  Off meta ``steps`` is
  the plain loop.

Nothing here registers a custom op: a kernel wrapper stays a Python call,
so serving pays no dispatch for it.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

_TLS = threading.local()


def _stack() -> List["Counter"]:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


class Counter:
    """A FLOP counter for one traced step: ``traced`` is what
    ``FlopCounterMode`` saw, ``credited`` what kernels and loops credited,
    by name; :meth:`total` is their sum."""

    def __init__(self):
        self.mode = FlopCounterMode(display=False)
        self.credited: Dict[str, float] = {}
        #: the backward share of ``credited`` (a replay reads it)
        self.credited_bwd = 0.0
        #: the recording mesh's collectives: (kind, result bytes, group
        #: size) -> calls (a loop's skipped trips included)
        self.collectives: Dict[Tuple[str, int, int], float] = {}

    def __enter__(self) -> "Counter":
        _stack().append(self)
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self.mode.__exit__(*exc)
        finally:
            _stack().pop()

    @property
    def traced(self) -> int:
        return self.mode.get_total_flops()

    def total(self) -> float:
        return self.traced + sum(self.credited.values())

    def by_op(self) -> Dict[str, int]:
        """Traced FLOPs by aten op."""
        counts = self.mode.get_flop_counts().get("Global", {})
        return {str(op): int(n) for op, n in counts.items()}

    def credit(self, name: str, fwd: float, bwd: float = 0.0) -> None:
        self.credited[name] = self.credited.get(name, 0.0) + fwd + bwd
        self.credited_bwd += bwd

    def add_collectives(self, calls: Dict[Tuple[str, int, int], float],
                        times: float = 1.0) -> None:
        for key, n in calls.items():
            self.collectives[key] = self.collectives.get(key, 0.0) + n * times


def active() -> Optional[Counter]:
    stack = _stack()
    return stack[-1] if stack else None


def credit(name: str, flops: float) -> None:
    """Credit ``flops`` of forward work to the active counter, if any (a
    kernel wrapper on meta tensors calls it)."""
    counter = active()
    if counter is not None:
        counter.credit(name, float(flops))


def collective(kind: str, nbytes: int, group: int,
               fallback: Dict[Tuple[str, int, int], float]) -> None:
    """Record one collective of the recording mesh with the active
    counter (in a loop's replay, the replay's own), or in ``fallback``
    where none is active."""
    counter = active()
    log = counter.collectives if counter is not None else fallback
    key = (kind, int(nbytes), int(group))
    log[key] = log.get(key, 0.0) + 1.0


def on_meta(*tensors) -> bool:
    return any(isinstance(t, torch.Tensor) and t.is_meta for t in tensors)


def _flat(tree) -> List[Optional[torch.Tensor]]:
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _flat(x)]
    return [tree]


def _signature(carry, operands) -> Tuple:
    return tuple(None if not isinstance(t, torch.Tensor) else
                 (tuple(t.shape), t.dtype, t.requires_grad)
                 for t in _flat(carry) + _flat(operands))


def _detached(tree, grad: bool):
    if isinstance(tree, tuple):
        return tuple(_detached(x, grad) for x in tree)
    if isinstance(tree, list):
        return [_detached(x, grad) for x in tree]
    if not isinstance(tree, torch.Tensor):
        return tree
    d = tree.detach()
    if grad and tree.requires_grad:
        d.requires_grad_(True)
    return d


@contextlib.contextmanager
def recomputing():
    """Marks a checkpointed body's recompute in the backward: loops in it
    are credited their forward only (the forward pass already credited
    their backward)."""
    _TLS.recompute = getattr(_TLS, "recompute", 0) + 1
    try:
        yield
    finally:
        _TLS.recompute -= 1


def remat_contexts():
    """``torch.utils.checkpoint``'s ``context_fn``: nothing around the
    forward, :func:`recomputing` around the recompute."""
    return contextlib.nullcontext(), recomputing()


def _in_recompute() -> bool:
    return getattr(_TLS, "recompute", 0) > 0


def _measure(body: Callable, i: int, carry, operands: Sequence,
             grad: bool, backward: bool
             ) -> Tuple[float, float, Dict[Tuple[str, int, int], float]]:
    """(forward FLOPs, backward FLOPs, collectives) of one trip of
    ``body``, replayed on detached inputs in a thread of its own under a
    fresh counter."""
    result: Dict[str, Any] = {}

    def replay():
        try:
            with torch.set_grad_enabled(grad), Counter() as c:
                carry_d = _detached(carry, grad)
                ops_d = _detached(list(operands), grad)
                new_carry, out = body(i, carry_d, *ops_d)
                traced_fwd = c.traced
                fwd = traced_fwd + sum(c.credited.values()) - c.credited_bwd
                bwd = c.credited_bwd
                outs = [t for t in _flat((new_carry, out))
                        if isinstance(t, torch.Tensor) and t.requires_grad]
                ins = [t for t in _flat((carry_d, ops_d))
                       if isinstance(t, torch.Tensor) and t.requires_grad]
                if backward and outs and ins:
                    torch.autograd.grad(
                        outs, ins, grad_outputs=[torch.empty_like(t)
                                                 for t in outs],
                        allow_unused=True)
                    bwd += c.traced - traced_fwd
            result["flops"] = (fwd, bwd, dict(c.collectives))
        except BaseException as e:  # noqa: BLE001  (re-raised below)
            result["error"] = e

    worker = threading.Thread(target=replay, name="trip-replay")
    worker.start()
    worker.join()
    if "error" in result:
        raise result["error"]
    return result["flops"]


def steps(name: str, n: int, body: Callable, carry, *operands
          ) -> Tuple[Any, List[Any]]:
    """``n`` trips of ``carry, out = body(i, carry, *operands)``; returns
    the last carry and the list of each trip's ``out``.  ``operands`` are
    the tensors the body reads that may need a gradient; the body must
    not close over any other such tensor.

    On meta tensors, trips between the first steady one and the last are
    not run: their outputs repeat the steady trip's (the shapes are
    equal) and their operations are credited to the active counter under
    ``name`` (see the module docstring).  Elsewhere this is the plain
    loop."""
    if not on_meta(*_flat(carry), *operands):
        outs = []
        for i in range(n):
            carry, out = body(i, carry, *operands)
            outs.append(out)
        return carry, outs
    outs: List[Any] = []
    prev = None
    i = 0
    while i < n:
        sig = _signature(carry, operands)
        if sig == prev and i < n - 1:
            skipped = n - 1 - i
            grad = torch.is_grad_enabled()
            backward = grad and not _in_recompute() and any(
                isinstance(t, torch.Tensor) and t.requires_grad
                for t in _flat(outs[-1]) + _flat(carry))
            fwd, bwd, calls = _measure(body, i, carry, operands, grad,
                                       backward)
            counter = active()
            if counter is not None:
                counter.credit(f"loop:{name}", skipped * fwd,
                               skipped * bwd if backward else 0.0)
                counter.add_collectives(calls, skipped)
            outs.extend([outs[-1]] * skipped)
            i = n - 1
            continue
        prev = sig
        carry, out = body(i, carry, *operands)
        outs.append(out)
        i += 1
    return carry, outs
