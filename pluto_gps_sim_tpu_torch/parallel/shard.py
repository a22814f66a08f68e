"""Sharded composite synthesis: channel all-reduce x time-block SPMD.

The counterpart of the JAX package's ``parallel/shard.py:33-115``.  The
JAX package maps its kernel over a ("time", "chan") device mesh with
shard_map and psum from one controller; here every rank of a
torch.distributed mesh (parallel.mesh) runs this code on the same host
inputs:

  * blocks shard over "time" (no communication — phase parameters are
    closed-form per block): rank (t, c) synthesizes rows
    [t*M/T, (t+1)*M/T);
  * channel slots shard over "chan": shard c keeps only its channels'
    gains and patch words (shard_channel_params), the kernel runs with
    packed=False (its epilogue removes the bias with the in-kernel count
    of active channels, so a row with none of the shard's channels gives
    exactly 0), the int32 I and Q partials are all-reduced (SUM) over
    the chan group, and packing happens after the reduction — the
    reference's cross-satellite accumulator (plutogpssim.c:2705-2706)
    turned into a collective;
  * the packed time shards are gathered over the time group, so every
    rank holds the single-device result.

The per-rank compute is ops.synth_cuda.synth_blocks: the CUDA kernel on
a card, its plain twin on the CPU.  Collective order: every rank issues
the same collectives in the same order (two all-reduces, one gather per
call), so callers call this in the same sequence on every rank.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..constants import MAX_CHAN
from ..ops import synth_cuda as sc
from .mesh import Mesh

__all__ = ["pad_time_shards", "shard_channel_params", "synth_sharded",
           "pack_iq", "local_inputs", "launch_on_mesh"]


def pad_time_shards(prmi: np.ndarray, prmf: np.ndarray, sf_map: np.ndarray,
                    n_time: int):
    """Zero-pad the block axis to a multiple of the mesh's time shards.

    Padded blocks have zero gain everywhere, so they synthesize silence
    and are sliced off by the caller."""
    m = prmi.shape[0]
    pad = (-m) % n_time
    if pad:
        prmi = np.concatenate(
            [prmi, np.zeros((pad,) + prmi.shape[1:], prmi.dtype)])
        prmf = np.concatenate(
            [prmf, np.zeros((pad,) + prmf.shape[1:], prmf.dtype)])
        sf_map = np.concatenate([sf_map, np.zeros(pad, np.int32)])
    return prmi, prmf, sf_map


def shard_channel_params(prmf: np.ndarray, n_chan_shards: int) -> np.ndarray:
    """Replicate the float param plane per channel shard, zeroing the gain
    of channels owned by other shards -> [n_shards, M, 2*128].

    Gain-trunc patch words are also filtered to the shard's channel
    range: a patch region runs unconditionally in-kernel (no gain
    guard), so a word left replicated would be applied once per shard
    and corrupt the sum by n_shards-1 extra deltas."""
    out = np.repeat(prmf[None], n_chan_shards, axis=0)
    bounds = np.linspace(0, MAX_CHAN, n_chan_shards + 1).astype(int)
    for s in range(n_chan_shards):
        lo, hi = bounds[s], bounds[s + 1]
        for c in range(MAX_CHAN):
            if not (lo <= c < hi):
                out[s, :, sc._F_GAIN + c] = 0.0
        for k in range(sc._N_PATCH):
            lane = sc.patch_word_lane(k)
            w = out[s, :, lane].astype(np.int64)
            chan = (w >> 2) & 15
            foreign = (w != 0) & ((chan < lo) | (chan >= hi))
            out[s, foreign, lane] = 0.0
    return out


def pack_iq(i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(I & 0xFFFF) | (Q << 16) as int32, word for word the JAX package's
    (i & 0xFFFF) | shift_left(q, 16): formed in int64 and wrapped to the
    signed 32-bit value (no int32 left shift of a negative Q)."""
    word = (i.to(torch.int64) & 0xFFFF) | (q.to(torch.int64) << 16)
    return sc._s32(word).to(torch.int32)


def local_inputs(mesh: Mesh, prmi, prmf_sharded, ca_tabs, sf_map):
    """This rank's kernel inputs as tensors on its device: its time rows
    of the planes and map, its channel shard's float plane."""
    n_time, n_chan = mesh.shape["time"], mesh.shape["chan"]
    m = prmi.shape[0]
    if m % n_time:
        raise ValueError(f"blocks ({m}) must divide time shards ({n_time})")
    if prmf_sharded.shape[0] != n_chan:
        raise ValueError(f"prmf_sharded holds {prmf_sharded.shape[0]} "
                         f"channel shards, the mesh {n_chan}")
    t, c = mesh.coord
    rows = slice(t * (m // n_time), (t + 1) * (m // n_time))
    local = [np.ascontiguousarray(a) for a in
             (prmi[rows], prmf_sharded[c, rows], ca_tabs, sf_map[rows])]
    args = [torch.from_numpy(a) for a in local]
    if mesh.device.type == "cuda":
        sc.check_sf_map(local[3], ca_tabs.shape[0])
        args = [a.pin_memory().to(mesh.device, non_blocking=True)
                for a in args]
    return args


def _sharded_packed(mesh: Mesh, prmi, prmf_sharded, ca_tabs, sf_map,
                    block_samples: int) -> torch.Tensor:
    """The full packed int32 [M, block_samples] on every rank, on the
    device its gather ran on: the host for a gloo mesh (gloo's
    all_gather takes CPU tensors only), else mesh.device.  The
    all-reduce and the packing stay on the rank's device (gloo
    all-reduces CUDA tensors too)."""
    args = local_inputs(mesh, prmi, prmf_sharded, ca_tabs, sf_map)
    i_acc, q_acc = sc.synth_blocks(*args, block_samples, packed=False)
    mesh.stats["launches"] += 1
    t0 = time.perf_counter()
    if mesh.shape["chan"] > 1:
        dist.all_reduce(i_acc, group=mesh.chan_group)
        dist.all_reduce(q_acc, group=mesh.chan_group)
    t1 = time.perf_counter()
    local = pack_iq(i_acc, q_acc)
    if mesh.host_gather:
        local = local.cpu()
    t2 = time.perf_counter()
    n_time = mesh.shape["time"]
    if n_time == 1:
        full = local
    else:
        full = torch.empty((n_time * local.shape[0], local.shape[1]),
                           dtype=local.dtype, device=local.device)
        dist.all_gather(list(full.chunk(n_time)), local,
                        group=mesh.time_group)
    mesh.stats["reduce_s"] += t1 - t0
    mesh.stats["pack_s"] += t2 - t1
    mesh.stats["gather_s"] += time.perf_counter() - t2
    return full


def synth_sharded(mesh: Mesh, prmi: np.ndarray, prmf_sharded: np.ndarray,
                  ca_tables: np.ndarray, sf_map: np.ndarray,
                  block_samples: int) -> torch.Tensor:
    """Run the sharded synthesis over `mesh` -> packed int32 IQ [M, N]
    on mesh.device, the same on every rank.

    prmi [M,256] int32, prmf_sharded [chan_shards, M, 256] f32
    (shard_channel_params), ca_tables and sf_map [M] as for
    ops.synth_cuda.synth_blocks; M must divide the time shards
    (pad_time_shards).  Every rank passes the same host arrays."""
    return _sharded_packed(mesh, prmi, prmf_sharded, ca_tables, sf_map,
                           int(block_samples)).to(mesh.device)


def launch_on_mesh(mesh: Mesh, arrays, block_samples: int) -> torch.Tensor:
    """One dispatch group's kernel inputs (prmi, prmf, ca_tabs, sf_map)
    through the mesh: pad to the time shards, shard the channels, run,
    and slice the padding off -> packed [M, N] on the host (gloo mesh)
    or mesh.device (nccl)."""
    prmi, prmf, ca_tabs, sf_map = arrays
    n_total = int(sf_map.size)
    prmi, prmf, sf_map = pad_time_shards(prmi, prmf, sf_map,
                                         mesh.shape["time"])
    prmf_sh = shard_channel_params(prmf, mesh.shape["chan"])
    return _sharded_packed(mesh, prmi, prmf_sh, ca_tabs, sf_map,
                           int(block_samples))[:n_total]
