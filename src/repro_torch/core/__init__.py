"""Shared helpers of the port: device resolution, state-size accounting
and the load balancer's partition arithmetic (a copy of the JAX package's
``repro.core.balancer``)."""
from repro_torch.core.balancer import (Item, imbalance, partition,
                                       should_rebalance)
from repro_torch.core.device import resolve_device

__all__ = ["Item", "imbalance", "partition", "resolve_device",
           "should_rebalance"]
