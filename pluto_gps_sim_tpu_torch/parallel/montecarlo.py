"""Batched Monte-Carlo trajectory synthesis.

The counterpart of the JAX package's ``parallel/montecarlo.py:55-327``,
on one device or sharded over a parallel.mesh.Mesh of ranks (mesh=).

Nothing like this exists in the reference — it simulates exactly one
receiver (plutogpssim.c:2203).  On a GPU the marginal cost of more
receivers is tiny: every trajectory contributes an independent set of
0.1 s blocks, and blocks are the kernel's outer grid axis, so a batch of
B receivers over M blocks is ONE kernel launch over B*M receiver-major
rows (or one per chunk_blocks rows).  A block past the kernel's Q24
range (fs > 5.24 MHz at 0.1 s blocks) is split_k re-anchored sub-rows,
as in IqStream, and the batch yields whole blocks all the same.

Control plane (batched; the naive form — B sequential Schedulers each
making its own jit round-trips — costs ~3x the kernel time at B=256):

  * all receivers share one scenario clock, so the epoch grid
    (g_secs/g_weeks) is computed once;
  * the range solve is ONE `solve_ranges_batch` call (vmap over
    receivers) per superframe instead of B jit round-trips;
  * boundary allocation inputs (visibility, az/el, receiver and
    earth-center ranges) come from one batched solve at the boundary
    epoch — the earth-center reference solve (c:1959) is
    receiver-independent and computed once;
  * nav-message products are receiver-independent given the shared
    clock, so a shared models.lnav.NavCache collapses per-boundary nav
    regeneration from 12*B rebuilds to ~12;
  * on a card the batch's parameter planes are built there, by one
    ops.synth_cuda.build_params launch from the plans' raw fields, and
    the launches slice them in place (no host planes, no pinned copy);
  * batches asked for back to back are planned one ahead: the
    second and every later superframes() call in a row with the same
    n_blocks and device, once its own planes are ready, starts a thread
    (mc.lookahead) that plans the next batch while this one's kernels
    run, and the next such call takes its planes.  Any other call first
    puts the schedulers back as they were before the lookahead.

Typical use — receiver swarms, coverage/DOP studies, fuzzing a receiver
against perturbed trajectories:

    mc = MonteCarloBatch(rin, g0, ieph, xyz_batch, fs=2.6e6)
    iq = mc.generate(300, "cuda")               # [B, 300, N, 2] int16
    for off, iq in mc.superframes(300, "cuda", chunk_blocks=600):
        consume(off, iq)   # streaming: host RSS bounded by one chunk
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..ingest.rinex import RinexResult
from ..models import orbits
from ..models.gpstime import GpsTime
from ..models.lnav import NavCache
from ..ops import synth_cuda as sc
from ..ops.epoch import (solve_ranges, solve_ranges_batch,
                         solve_ranges_batch_lean)
from ..ops.synth_torch import resolve_device
from ..runtime import trace
from ..runtime.launch import (DroppedCount, device_view, launch_blocks,
                              pack_group, split_geometry, unpack_rows)
from ..runtime.scheduler import Scheduler, _gather_eph

__all__ = ["MonteCarloBatch"]


class _Lookahead:
    """The next batch, planned on a thread of its own: what it plans
    for, the schedulers' state before it, and what it planned."""

    def __init__(self, key: tuple, serial: int):
        self.key = key              # (n_blocks, device) it plans for
        self.serial = serial        # its batch's trace serial number
        self.thread: threading.Thread | None = None
        self.snap: list | None = None       # Scheduler.snapshot()s
        self.planes = None          # plan_blocks' result
        self.dropped: list = []     # its builds' dropped-patch counts
        self.error: BaseException | None = None


class MonteCarloBatch:
    """B independent receivers on a shared scenario clock."""

    def __init__(self, rin: RinexResult, start: GpsTime, ieph: int,
                 xyz_batch: np.ndarray, fs: float,
                 static_mode: bool = True,
                 block_samples: int | None = None):
        xyz_batch = np.asarray(xyz_batch, dtype=np.float64)
        if xyz_batch.ndim == 2:                 # [B, 3] static receivers
            xyz_batch = xyz_batch[:, None, :]
        if xyz_batch.ndim != 3 or xyz_batch.shape[-1] != 3:
            raise ValueError("xyz_batch must be [B, 3] or [B, numd, 3]")
        self.B = xyz_batch.shape[0]
        self.rin = rin
        self.nav_cache = NavCache()
        # batched initial-allocation solves at t_0 (motion sample 0)
        pre = self._alloc_precomp(rin.eph[ieph], start, xyz_batch[:, 0])
        self.scheds = [
            Scheduler(rin, start, ieph, xyz_batch[b], fs,
                      block_samples=block_samples,
                      static_mode=static_mode and xyz_batch.shape[1] == 1,
                      nav_cache=self.nav_cache, alloc_precomp=pre[b])
            for b in range(self.B)]
        self.block_samples = self.scheds[0].block_samples
        # blocks past the kernel's Q24 range launch as split_k sub-rows
        # of sub_block_samples (runtime.launch.pack_group splits them)
        self.split_k, self.sub_block_samples = split_geometry(
            self.block_samples)
        self._dropped = DroppedCount()   # dropped gain-trunc patches
        self._streams: dict = {}     # the batch's CUDA stream, per device
        self._last_key = None        # the last superframes() call's key
        self._lookahead: _Lookahead | None = None
        self.lookahead_hits = 0      # calls that took a lookahead's planes
        self.lookahead_misses = 0    # lookaheads discarded

    def _alloc_precomp(self, eph, grx: GpsTime, rx: np.ndarray):
        """Batched allocation inputs at time grx for all B receivers:
        one visibility solve, one range solve, one shared earth-center
        reference solve."""
        g = np.full(self.B, grx.sec)
        vis, azel = orbits.check_visibility_batch(eph, g, rx)
        rho = solve_ranges_batch(eph, self.rin.ionoutc,
                                 np.asarray([grx.sec]), rx[:, None, :])
        rho = {k: np.asarray(v)[:, 0] for k, v in rho.items()}  # [B, 32]
        ref = solve_ranges(eph, self.rin.ionoutc, np.asarray([grx.sec]),
                           np.zeros((1, 3)))
        ref = {k: np.asarray(v)[0] for k, v in ref.items()}     # [32]
        vis = np.asarray(vis)
        azel = np.asarray(azel)
        return [{"vis": vis[b], "azel": azel[b],
                 "rho": {k: v[b] for k, v in rho.items()},
                 "rho_ref": ref} for b in range(self.B)]

    # epoch cap per batched range solve: bounds the [B, n_epochs, 32]
    # f64 working set (B=256 x 1024 x 32 x 8 B x 3 keys ~ 2 GB) while
    # still amortizing the solve over multiple superframes per call
    _SOLVE_CHUNK_EPOCHS = 1024

    @property
    def patch_dropped(self) -> int:
        """Gain-trunc patch words dropped to the slot cap, over every
        batch planned for a call so far: a lookahead's batch counts once
        a call takes it, and never while pending or once discarded.
        Card builds count on the card; reading this waits for them."""
        return self._dropped.value

    def plan_blocks(self, n_blocks: int, device=None):
        """Plan n_blocks for every trajectory; returns kernel-ready args
        (prmi, prmf, ca2, sf_map), packed by runtime.launch.pack_group.

        With no device, or a CPU one, they are host numpy arrays.  With
        a CUDA device all four are device tensors, enqueued on the
        current stream and not synchronized: the parameter planes built
        on the card by ops.synth_cuda.build_params from the plans' raw
        fields, staged through pinned memory, or, where blocks pass the
        kernel's Q24 range, built and split into sub-rows on the host
        and uploaded from pinned memory.  Rows are sub-rows, split_k a
        block, where blocks are split.

        All trajectories share the scenario clock, so their superframe
        boundaries align and every plan() round covers the same block
        span for every receiver — which is what lets the range solve
        batch over receivers, and (round 5, mirroring
        Scheduler.plan_group) over RUNS of consecutive superframes on
        one ephemeris set: one solve_ranges_batch_lean call per
        eph-set run chunk instead of one per superframe.  satpos inside
        the batched solve is receiver-independent and computed once per
        epoch grid (compute_range broadcasts it against the B axis).

        A lookahead that superframes() left pending is joined and
        discarded first (the schedulers put back as they were before
        it), since this call plans the batches it planned."""
        la = self._lookahead
        ahead = la is not None and la.thread is threading.current_thread()
        if not ahead:
            self._settle_lookahead(None)
            self._last_key = None
        with trace.span(trace.recorder("batch"), "mc.plan_blocks", n=1.0):
            dev = None if device is None else resolve_device(device)
            plans = self._plan_blocks(int(n_blocks))
            with trace.child("mc.build"):
                packed = pack_group(plans, dev)
            if ahead:
                la.dropped.append(packed.patch_dropped)
            else:
                self._dropped.add(packed.patch_dropped)
            return packed.arrays

    def _plan_blocks(self, n_blocks: int) -> list:
        per_b = [[] for _ in range(self.B)]

        # shared-clock span pre-simulation: every scheduler advances in
        # lockstep, so receiver 0's simulate_spans (the one copy of the
        # span/boundary/rollover protocol) covers the whole batch
        s0 = self.scheds[0]
        spans = s0.simulate_spans(total_blocks=n_blocks)

        i = 0
        while i < len(spans):
            # chunk = contiguous spans on one eph set, capped by the
            # solve working-set bound
            j = i
            total = spans[i][1]
            while (j + 1 < len(spans) and spans[j + 1][2] == spans[i][2]
                   and total + spans[j + 1][1] + 1
                   <= self._SOLVE_CHUNK_EPOCHS):
                j += 1
                total += spans[j][1]
            jblk0 = spans[i][0]
            ks = jblk0 + np.arange(total + 1)
            g_secs = s0._grid_arrays(ks)[0]      # shared scenario clock
            rx = np.stack([s._grid_arrays(ks)[2] for s in self.scheds])
            eph = self.rin.eph[spans[i][2]]
            # solve over the UNION of all receivers' allocated SVs
            # (typically ~8 of 32 — same per-satellite-elementwise
            # bit-identity argument as Scheduler.plan_group's slot
            # gather), each receiver's slot columns gathered back out;
            # a boundary re-allocation that claims an SV outside the
            # union triggers a re-solve of the remaining spans
            k = i
            while k <= j:
                union = np.unique(np.concatenate(
                    [s.state.sv_idx for s in self.scheds]))
                eph_u = _gather_eph(eph, union)
                off0 = spans[k][0] - jblk0
                with trace.child("mc.solve"):
                    rho_b = solve_ranges_batch_lean(
                        eph_u, self.rin.ionoutc, g_secs[off0:],
                        rx[:, off0:])
                    rho_b = {kk: np.asarray(v) for kk, v in rho_b.items()}
                while k <= j:
                    # per-span slot->union column maps (re-allocation at
                    # a boundary inside the chunk may move slots WITHIN
                    # the union — re-gather — or outside it — re-solve)
                    idx = [np.minimum(
                        np.searchsorted(union, s.state.sv_idx),
                        len(union) - 1) for s in self.scheds]
                    if any(not np.array_equal(
                            union[idx[b]], self.scheds[b].state.sv_idx)
                           for b in range(self.B)):
                        break      # slots left the union: re-solve rest
                    jb, M, _, t_end, boundary, post = spans[k]
                    off = jb - jblk0 - off0
                    # boundary-allocation precomp (with the eph set in
                    # effect AFTER the clock-driven rollover check,
                    # c:2774-2790)
                    pre = None
                    if boundary:
                        with trace.child("mc.solve"):
                            pre = self._alloc_precomp(
                                self.rin.eph[post], t_end,
                                rx[:, jb - jblk0 + M])
                    with trace.child("mc.plan"):
                        for b, sched in enumerate(self.scheds):
                            rho = {kk: v[b, off:off + M + 1][:, idx[b]]
                                   for kk, v in rho_b.items()}
                            plan = sched.plan(
                                M, rho=rho, rho_in_slots=True,
                                alloc_precomp=None if pre is None
                                else pre[b])
                            assert plan.n_blocks == M, \
                                "schedulers lost clock sync"
                            per_b[b].append(plan)
                    k += 1
            i = j + 1
        # receiver-major rows: receiver b's plans, then receiver b+1's
        return [p for plans in per_b for p in plans]

    def _stream(self, dev: torch.device):
        """The batch's CUDA stream on dev: its builds, a lookahead's
        included, and its launches run there in order."""
        s = self._streams.get(dev)
        if s is None:
            s = self._streams[dev] = torch.cuda.Stream(dev)
        return s

    def _start_lookahead(self, key: tuple, cuda_stream) -> None:
        """Plan the next batch of key = (n_blocks, device) on a thread
        of its own, through self.plan_blocks, recording its spans as
        the calling thread would (runtime.trace.adopt)."""
        n_blocks, dev = key
        la = _Lookahead(key, trace.serial())
        rec = trace.recorder("batch", la.serial)

        def run() -> None:
            try:
                la.snap = [s.snapshot() for s in self.scheds]
                with trace.adopt(rec), torch.cuda.stream(cuda_stream):
                    la.planes = self.plan_blocks(n_blocks, device=dev)
            except BaseException as e:      # raised in the joining call
                la.error = e

        la.thread = threading.Thread(target=run, name="mc.lookahead",
                                     daemon=True)
        self._lookahead = la
        la.thread.start()

    def _settle_lookahead(self, key):
        """Join a pending lookahead.  Its planes when it planned for key
        (a hit); otherwise None, with every scheduler put back as the
        lookahead found it (a miss).  Its error, if it raised, is raised
        here, after the schedulers are put back."""
        la = self._lookahead
        if la is None:
            return None
        rec = trace.recorder("batch", la.serial)
        with trace.span(rec, "mc.lookahead_wait") as wait:
            la.thread.join()
            hit = la.error is None and la.key == key
            wait.n = float(hit)
        # cleared only now: until it ends, the thread's plan_blocks finds
        # itself here
        self._lookahead = None
        if hit:
            self.lookahead_hits += 1
            for dropped in la.dropped:
                self._dropped.add(dropped)
            return la.planes
        self.lookahead_misses += 1
        if la.snap is not None:
            for s, snap in zip(self.scheds, la.snap):
                s.restore(snap)
        if la.error is not None:
            raise la.error
        return None

    def superframes(self, n_blocks: int, device,
                    chunk_blocks: int | None = None,
                    as_device: bool = False, mesh=None):
        """Stream the batch as (block_offset, iq) chunks — host RSS stays
        bounded by ONE chunk, so B=256 x 300 blocks (80 GB of IQ at
        2.6 MHz) never materializes anywhere.

        device is "cuda" (the synthesis kernel) or "cpu" (its plain
        twin); nothing is chosen automatically.  Blocks are
        receiver-major: global row r = b*n_blocks + k is receiver b's
        block k; each yielded chunk covers rows [block_offset,
        block_offset + len).  as_device=True yields the packed int32
        tensor [len, N] on the device (ordered on the consumer's current
        CUDA stream) instead of host int16 [len, N, 2]; where blocks
        are split it is a view of the launch's sub-rows laid side by
        side and trimmed to N.  On CUDA chunk k+1 launches while chunk
        k's D2H into a pinned host buffer completes (one-deep software
        pipeline on a stream of its own, runtime.launch.launch_blocks).

        chunk_blocks bounds the rows per kernel launch so the packed
        output fits device memory at large B (4*split_k*sub_block_samples
        bytes per block); the pipeline keeps up to TWO chunks' outputs
        live on the device at once, so size chunk_blocks so two chunks
        fit.  Default: the whole batch in one launch.

        mesh (a parallel.mesh.Mesh) shards the batch over the mesh's
        ranks (parallel.shard), as the JAX package's mesh= does; device
        must name mesh.device.  Mesh runs launch whole (chunk_blocks
        does not apply), and every rank yields the whole batch; a mesh
        does not run split blocks and raises ValueError.

        Without a mesh, the second and every later call in a row with
        the same n_blocks and device starts, once its planes are ready
        and before its first launch, a thread (mc.lookahead) that plans
        the next batch; the next call with that n_blocks and device
        takes its planes (lookahead_hits).  Any other call, a mesh call
        or a direct plan_blocks first joins it and puts the schedulers
        back as they were (lookahead_misses).  The bytes are the same
        either way."""
        if mesh is not None:
            if self.split_k > 1:
                raise ValueError(
                    f"a mesh does not run a batch whose blocks are split "
                    f"({self.block_samples} samples, past the kernel's "
                    f"Q24 range of {sc.MAX_BLOCK_SAMPLES}); run it on one "
                    f"device")
            from .mesh import check_mesh_device
            dev = check_mesh_device(mesh, device)
            key = None
        else:
            dev = resolve_device(device)
            key = (int(n_blocks), dev)
        repeat = key is not None and key == self._last_key
        total = self.B * n_blocks
        n, k, sub = self.block_samples, self.split_k, self.sub_block_samples
        cuda_stream = self._stream(dev) if dev.type == "cuda" else None
        with torch.cuda.stream(cuda_stream):
            # a taken lookahead's counts are added on the stream that
            # built them
            planes = self._settle_lookahead(key)
        if planes is None and mesh is not None:
            # a mesh shards host arrays (parallel.shard.launch_on_mesh)
            planes = self.plan_blocks(n_blocks)
        elif planes is None:
            # on a card the planes are built there, on the batch's
            # stream, and the launches slice them there
            with torch.cuda.stream(cuda_stream):
                planes = self.plan_blocks(n_blocks, device=dev)
        self._last_key = key
        if repeat:
            self._start_lookahead(key, cuda_stream)
        prmi, prmf, ca2, sf_map = planes

        def launch(lo, hi):
            # blocks [lo, hi) are kernel rows [lo*k, hi*k)
            rows = slice(lo * k, hi * k)
            arrays = (prmi[rows], prmf[rows], ca2, sf_map[rows])
            if cuda_stream is None:
                return launch_blocks(arrays, sub, dev, None, not as_device,
                                     mesh)
            with torch.cuda.device(dev), torch.cuda.stream(cuda_stream):
                return launch_blocks(arrays, sub, dev, cuda_stream,
                                     not as_device, mesh)

        def finish(off, out, done):
            if as_device:
                # a block's sub-rows side by side, trimmed to the block:
                # a view, nothing copied
                out = device_view(out, done, dev)
                return off, out.view(-1, k * sub)[:, :n]
            if done is not None:
                done.synchronize()
            return off, unpack_rows(out, sub, n)

        step = total if chunk_blocks is None or mesh is not None \
            else max(1, chunk_blocks)
        pending = None
        for off in range(0, total, step):
            out, done = launch(off, min(off + step, total))
            if pending is not None:
                yield finish(*pending)
            pending = (off, out, done)
        if pending is not None:
            yield finish(*pending)

    def generate(self, n_blocks: int, device,
                 chunk_blocks: int | None = None, mesh=None) -> np.ndarray:
        """Synthesize [B, n_blocks, N, 2] int16 IQ over B*n_blocks blocks
        on device ("cuda" or "cpu"), sharded over `mesh` when given.

        Materializes the WHOLE batch on host — at large B use
        superframes() and consume per-chunk instead (B=256 x 300 blocks
        at 2.6 MHz is ~80 GB).  chunk_blocks still bounds the per-launch
        device footprint here."""
        n = self.block_samples
        out = np.empty((self.B * n_blocks, n, 2), dtype=np.int16)
        done = 0
        for off, iq in self.superframes(n_blocks, device,
                                        chunk_blocks=chunk_blocks,
                                        mesh=mesh):
            out[off:off + iq.shape[0]] = iq
            done += iq.shape[0]
        assert done == self.B * n_blocks
        return out.reshape(self.B, n_blocks, n, 2)
