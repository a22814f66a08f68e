"""The seam between plans and the card: what the synthesis kernel reads,
and how it gets there and back.

``pack_group`` turns consecutive SuperframePlans into one launch's
inputs: the [M, 256] parameter planes, the deduplicated bit-packed C/A
tables and the row -> table ``sf_map``.  ``launch_blocks`` stages them,
launches the kernel and brings its packed output back into pinned host
memory, ``device_view`` orders a device output on the consumer's
stream, and ``unpack_rows`` turns landed rows into host int16 IQ.
``runtime.stream.IqStream``, ``parallel.MonteCarloBatch`` and the
multi-process dryrun all go through here.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from ..constants import MAX_CHAN
from ..ops import synth_cuda as sc
from ..ops.synth_torch import pack_plan, split_plan
from . import trace

__all__ = ["DroppedCount", "Packed", "SF_BLOCKS", "device_view",
           "launch_blocks", "pack_group", "split_geometry", "unpack_rows"]

SF_BLOCKS = 300          # 0.1 s blocks in a 30 s superframe


class Packed(NamedTuple):
    """One kernel launch's inputs, packed from consecutive plans."""

    arrays: tuple            # (prmi, prmf, ca_tabs, sf_map)
    block_samples: int       # samples per kernel row (sub-block if split)
    n_orig: int              # samples per scenario block
    patch_dropped: object    # an int, or a one-element tensor on the card


class DroppedCount:
    """Gain-trunc patch words dropped to the per-block slot cap, summed
    over the Packed.patch_dropped added: ints of host builds at once,
    one-element tensors of card builds into one running tensor a device,
    without waiting for the card.  A card count is added on the current
    stream, which must be the one that built it (after the stream that
    added last, where that differs).  Reading `value` waits for the
    card.  Safe across threads."""

    def __init__(self):
        self._n = 0
        self._card: dict = {}    # device -> (running tensor, its stream)
        self._lock = threading.Lock()

    def add(self, dropped) -> None:
        with self._lock:
            if not (isinstance(dropped, torch.Tensor) and dropped.is_cuda):
                self._n += int(dropped)
                return
            dev = dropped.device
            stream = torch.cuda.current_stream(dev)
            held = self._card.get(dev)
            if held is None:
                total = dropped.to(torch.int64)
            else:
                run, last = held
                if last != stream:
                    stream.wait_stream(last)
                    run.record_stream(stream)
                total = run + dropped
            self._card[dev] = (total, stream)

    @property
    def value(self) -> int:
        with self._lock:
            for dev, (run, _) in self._card.items():
                torch.cuda.synchronize(dev)
                self._n += int(run)
            self._card.clear()
            return self._n


def split_geometry(block_samples: int) -> tuple[int, int]:
    """(K, sub): the kernel rows a block of block_samples becomes.  Within
    the kernel's Q24 range (sc.MAX_BLOCK_SAMPLES) a block is one row,
    (1, block_samples); past it, K = ceil(N / MAX_BLOCK_SAMPLES) equal
    re-anchored sub-rows of sub = ceil(N / K) samples, as
    ops.synth_torch.split_plan cuts them, the last running past the
    block's end (K * sub >= N)."""
    k = -(-block_samples // sc.MAX_BLOCK_SAMPLES)
    return k, -(-block_samples // k)


def _dedupe(tables: list, counts: list):
    """(the distinct tables by bytes, in first-seen order; an [M] int32
    map of every row to its table, tables[i] covering counts[i] rows)."""
    seen: dict = {}
    distinct, idx = [], np.empty(len(tables), np.int32)
    for i, tab in enumerate(tables):
        key = tab.tobytes()
        j = seen.get(key)
        if j is None:
            j = seen[key] = len(distinct)
            distinct.append(tab)
        idx[i] = j
    return distinct, np.repeat(idx, counts)


def pack_group(plans: list, device=None) -> Packed:
    """The kernel inputs of consecutive plans, rows in plan order.

    C/A tables dedupe by chip-table bytes: the channel allocation only
    changes at rise and set, and receivers near each other see the same
    satellites, so a group's plans share a handful of tables, and
    sf_map points every row at its table (the kernel reads tables only
    through sf_map, so the output is the same word for word).

    With no device, or a CPU one, everything is built on the host:
    pack_plan(tables=False) a plan, split_plan where a block passes the
    kernel's Q24 range (split_geometry; rows are then sub-blocks) and
    one build_group_params over the group.  With a CUDA device and
    blocks within the range, the plans' raw fields are concatenated into
    pinned arrays, their nav-bit tables deduped the same way, and
    sc.build_params builds the planes there in one launch on the current
    stream, nothing synchronized.  With a CUDA device and blocks past
    the range, the planes are built and split on the host as above and
    go up from pinned memory on the current stream.  Every upload goes
    from pinned memory, so none holds the calling thread behind the
    stream's earlier work."""
    n = plans[0].block_samples
    dev = None if device is None else torch.device(device)
    on_card = dev is not None and dev.type != "cpu"
    k, sub = split_geometry(n)
    rows = [p.n_blocks for p in plans]
    if on_card and k == 1:
        m = sum(rows)
        fields = sc.PlanFields(
            torch.empty((m, MAX_CHAN), dtype=torch.bool, pin_memory=True),
            torch.empty((5, m, MAX_CHAN), dtype=torch.float64,
                        pin_memory=True),
            torch.empty((3, m, MAX_CHAN), dtype=torch.int32,
                        pin_memory=True),
            plans[0].delt)
        np.concatenate([p.active for p in plans], out=fields.active.numpy())
        for planes, names in ((fields.real, sc._REAL_FIELDS),
                              (fields.ints, sc._INT_FIELDS)):
            for i, name in enumerate(names):
                np.concatenate([getattr(p, name) for p in plans],
                               out=planes[i].numpy())
        nav_tabs, bits_map = _dedupe([p.bits for p in plans], rows)
        prmi, prmf, dropped = sc.build_params(
            fields, np.stack(nav_tabs), bits_map, n, device=dev)
    else:
        dps = [pack_plan(p, tables=False) for p in plans]
        if k > 1:
            with trace.child("packing.split", n=sum(rows) / SF_BLOCKS):
                dps = [split_plan(dp, sc.MAX_BLOCK_SAMPLES) for dp in dps]
            rows = [dp.n_blocks for dp in dps]
        bp = sc.build_group_params(dps)
        prmi, prmf, dropped = bp.prmi, bp.prmf, bp.patch_dropped
    ca_tabs, sf_map = _dedupe([p.ca2 for p in plans], rows)
    # the deduped list as it is: the CUDA kernel takes any table count,
    # so the JAX package's power-of-two padding of a batch's tables (a
    # fixed Mosaic compile shape) has no counterpart here
    ca_tabs = sc.pack_ca_tables(ca_tabs)
    if on_card:
        sc.check_sf_map(sf_map, ca_tabs.shape[0])
        ca_tabs, sf_map = _upload((ca_tabs, sf_map), dev)
        if k > 1:
            with trace.child("transfer.pin_alloc",
                             nbytes=prmi.nbytes + prmf.nbytes):
                prmi, prmf = _upload((prmi, prmf), dev)
    return Packed((prmi, prmf, ca_tabs, sf_map), sub, n, dropped)


def _upload(arrays, device: torch.device) -> list:
    """Host arrays as device tensors, each copied from a pinned staging
    copy on the current stream without waiting."""
    return [torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(
        device, non_blocking=True) for a in arrays]


def launch_blocks(arrays, block_samples: int, device: torch.device,
                  cuda_stream, to_host: bool, mesh=None):
    """Stage one kernel launch's inputs and launch it; returns
    (out, done).

    On the CPU the twin runs here and done is None.  On CUDA the planes
    go up from pinned staging copies (unless they are device tensors
    already), the kernel runs, and (to_host) its packed output comes
    back into a fresh pinned host tensor, all enqueued on cuda_stream;
    done is the event recorded after them, so the caller returns at
    once and the next launch overlaps this one's copy.  With a mesh
    (parallel.mesh) the launch runs sharded through
    parallel.shard.launch_on_mesh, whose collectives block the calling
    thread; every rank must make the same calls in the same order."""
    if mesh is not None:
        from ..parallel.shard import launch_on_mesh
        out = launch_on_mesh(mesh, arrays, block_samples)
        if cuda_stream is None or (to_host and out.device.type == "cpu"):
            return out, None
        # a gloo mesh on a card gathered on the host: as_device wants
        # the words back on the card
        return _to_host_async(out.to(device), cuda_stream, to_host)
    prmi, prmf, ca_tabs, sf_map = arrays
    if isinstance(prmi, torch.Tensor):
        # inputs already on the card (pack_group with a device), their
        # sf_map checked before it went up
        out = sc.synth_blocks(prmi, prmf, ca_tabs, sf_map, block_samples)
        return _to_host_async(out, cuda_stream, to_host)
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (prmi, prmf, ca_tabs, sf_map)]
    if cuda_stream is None:
        return sc.synth_blocks(*args, block_samples), None
    sc.check_sf_map(sf_map, ca_tabs.shape[0])
    with trace.child("transfer.pin_alloc",
                     nbytes=sum(a.nbytes for a in args)):
        args = [a.pin_memory() for a in args]
    args = [a.to(device, non_blocking=True) for a in args]
    out = sc.synth_blocks(*args, block_samples)
    return _to_host_async(out, cuda_stream, to_host)


def _to_host_async(out: torch.Tensor, cuda_stream, to_host: bool):
    """(out, event) after an optional D2H of out into a fresh pinned
    host tensor, both on cuda_stream; the consumer owns the buffer."""
    if to_host:
        with trace.child("transfer.pin_alloc", nbytes=out.nbytes):
            host = torch.empty(out.shape, dtype=out.dtype,
                               pin_memory=True)
        host.copy_(out, non_blocking=True)
        out = host
    done = torch.cuda.Event()
    done.record(cuda_stream)
    return out, done


def device_view(out: torch.Tensor, done, device: torch.device):
    """A launch's device output ordered on the consumer's current CUDA
    stream (done is its event, None on the CPU)."""
    if done is not None:
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        out.record_stream(consumer)
    return out


def unpack_rows(out: torch.Tensor, block_samples: int,
                n_orig: int) -> np.ndarray:
    """Host int16 IQ [M, n_orig, 2] of a launch's packed rows once they
    are on the host.  Where split_plan cut each block into K sub-rows of
    block_samples (K = ceil(n_orig / block_samples)), a block's sub-rows
    are laid side by side and trimmed to n_orig, the last having run
    past the block's end.  Both are views of the unpacked rows: nothing
    is copied."""
    iq = sc.unpack_iq(out.numpy(), block_samples)
    k = -(-n_orig // block_samples)
    if k > 1:
        iq = iq.reshape(iq.shape[0] // k, k * block_samples, 2)
        iq = iq[:, :n_orig]
    return iq
