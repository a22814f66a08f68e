"""Batched, synthetic and multi-device workloads.

The counterpart of the JAX package's ``parallel/``: the Monte-Carlo
batch, synthetic kernel parameters, and the ("time", "chan") mesh
(``mesh``, ``shard``, ``multiproc_dryrun``) over torch.distributed, one
process per rank."""

from .mesh import factor_devices, make_mesh
from .montecarlo import MonteCarloBatch
from .shard import pad_time_shards, shard_channel_params, synth_sharded
from .synthetic import synthetic_params

__all__ = ["MonteCarloBatch", "synthetic_params", "make_mesh",
           "factor_devices", "pad_time_shards", "shard_channel_params",
           "synth_sharded"]
