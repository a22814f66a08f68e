"""Batched and synthetic workloads on one device.

The counterpart of the JAX package's ``parallel/`` without its mesh
modules (``shard``, ``mesh``, ``multiproc_dryrun``), which need more
than one device and are ported over torch.distributed separately."""

from .montecarlo import MonteCarloBatch
from .synthetic import synthetic_params

__all__ = ["MonteCarloBatch", "synthetic_params"]
