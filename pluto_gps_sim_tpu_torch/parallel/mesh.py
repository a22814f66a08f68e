"""The ("time", "chan") process mesh for multi-device synthesis.

The counterpart of the JAX package's ``parallel/mesh.py:23-40``, over
torch.distributed instead of a jax.sharding.Mesh.  The two parallel axes
are the JAX package's:

  * "chan" — satellite channel slots shard across ranks; the composite
    baseband is an all-reduce (SUM) over the ranks of one chan group;
  * "time" — 0.1 s blocks shard across ranks with no communication
    (closed-form phase parameters make every block independent); the
    time shards are gathered at the end so every rank holds the result.

The design is SPMD with one process per rank: every rank runs the same
deterministic control plane, and rank r sits at mesh coordinate
(t, c) = divmod(r, chan_shards).  make_mesh builds the groups over the
default process group the caller initialized, with its backend as it
is: gloo (CPU or CUDA tensors; the gather on the host) or nccl (one
rank per card).  Nothing is chosen automatically.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "factor_devices", "check_mesh_device"]


def factor_devices(n: int) -> tuple[int, int]:
    """Split n devices into (time, chan) as evenly as chan in {1,2,3,4}."""
    for chan in (4, 3, 2):
        if n % chan == 0 and n >= chan:
            return n // chan, chan
    return n, 1


@dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a ("time", "chan") mesh of ranks.

    shape reads as the JAX mesh's (shape["time"], shape["chan"]);
    coord is this rank's (t, c); chan_group holds the ranks of row t
    (the all-reduce), time_group those of column c (the gather);
    device is the rank's own torch.device.  stats counts the sharded
    launches of parallel.shard and sums the host seconds of their
    all-reduce calls, of the packing (with the copy to the host for a
    gloo gather) and of the gather calls: blocking under gloo, so the
    collectives' own time; enqueue time under nccl."""

    shape: dict
    coord: tuple[int, int]
    chan_group: object
    time_group: object
    device: torch.device
    backend: str
    stats: dict = field(default_factory=lambda: {
        "launches": 0, "reduce_s": 0.0, "pack_s": 0.0, "gather_s": 0.0})

    @property
    def host_gather(self) -> bool:
        """True when the time shards are gathered on the host: gloo's
        all_gather takes CPU tensors only (its all_reduce takes CUDA
        tensors as well, so the reduction stays on the card)."""
        return self.backend == "gloo"


def _card_key(dev: torch.device) -> str:
    """Identifies the physical card behind a CUDA device on this host."""
    props = torch.cuda.get_device_properties(dev)
    return f"{socket.gethostname()}/{props.uuid}"


def check_distinct_cards(keys: list[str]) -> None:
    """Raise ValueError unless every rank of an nccl group has a card of
    its own (keys: one _card_key per rank)."""
    seen: dict[str, int] = {}
    for rank, key in enumerate(keys):
        if key in seen:
            raise ValueError(
                f"ranks {seen[key]} and {rank} share one card ({key}); "
                "NCCL refuses duplicate GPUs in a communicator — give "
                "each rank its own card, or initialize the process "
                "group with backend='gloo'")
        seen[key] = rank


def check_mesh_device(mesh: Mesh, device) -> torch.device:
    """mesh.device, after checking that the caller's device names it
    (a bare "cuda" names the current card): a sharded path runs on its
    rank's device or raises."""
    dev = torch.device(device)
    if dev.type == mesh.device.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev != mesh.device:
        raise ValueError(f"device {device} is not the mesh's device "
                         f"{mesh.device}")
    return mesh.device


def make_mesh(time_shards: int | None = None,
              chan_shards: int | None = None, *,
              device: str | torch.device) -> Mesh:
    """The mesh over the initialized default process group.

    Every rank must call it, in the same order relative to other group
    constructions (torch.distributed.new_group is collective).  With
    time_shards or chan_shards None the world size is factored as the
    JAX package does (factor_devices).  Raises ValueError when
    time*chan != world size, or when an nccl group's ranks share one
    card."""
    from ..ops.synth_torch import resolve_device

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process "
                           "group (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    rank = dist.get_rank()
    if time_shards is None or chan_shards is None:
        time_shards, chan_shards = factor_devices(world)
    if time_shards * chan_shards != world:
        raise ValueError(f"{time_shards}x{chan_shards} != {world} ranks")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = str(dist.get_backend())
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"the mesh runs over gloo or nccl, not {backend!r}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"an nccl mesh runs on cuda devices, not {dev}")
        # NCCL itself would fail (or hang) on its first collective, so
        # compare the cards over a side group that is not NCCL
        probe = dist.new_group(backend="gloo")
        keys: list = [None] * world
        dist.all_gather_object(keys, _card_key(dev), group=probe)
        dist.destroy_process_group(probe)
        check_distinct_cards(keys)
        torch.cuda.set_device(dev)
    t, c = divmod(rank, chan_shards)
    chan_group = time_group = None
    # new_group is collective over the whole world: every rank creates
    # every group, in the same order, and keeps the two it belongs to
    for tt in range(time_shards):
        g = dist.new_group([tt * chan_shards + cc
                            for cc in range(chan_shards)])
        if tt == t:
            chan_group = g
    for cc in range(chan_shards):
        g = dist.new_group([tt * chan_shards + cc
                            for tt in range(time_shards)])
        if cc == c:
            time_group = g
    return Mesh({"time": time_shards, "chan": chan_shards}, (t, c),
                chan_group, time_group, dev, backend)
