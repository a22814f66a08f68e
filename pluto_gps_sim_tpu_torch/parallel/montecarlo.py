"""Batched Monte-Carlo trajectory synthesis.

The counterpart of the JAX package's ``parallel/montecarlo.py:55-327``,
on one device (its mesh sharding is not part of this module).

Nothing like this exists in the reference — it simulates exactly one
receiver (plutogpssim.c:2203).  On a GPU the marginal cost of more
receivers is tiny: every trajectory contributes an independent set of
0.1 s blocks, and blocks are the kernel's outer grid axis, so a batch of
B receivers over M blocks is ONE kernel launch over B*M receiver-major
rows (or one per chunk_blocks rows).

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
    regeneration from 12*B rebuilds to ~12.

Typical use — receiver swarms, coverage/DOP studies, fuzzing a receiver
against perturbed trajectories:

    mc = MonteCarloBatch(rin, g0, ieph, xyz_batch, fs=2.6e6)
    iq = mc.generate(300, "cuda")               # [B, 300, N, 2] int16
    for off, iq in mc.superframes(300, "cuda", chunk_blocks=600):
        consume(off, iq)   # streaming: host RSS bounded by one chunk
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ingest.rinex import RinexResult
from ..models import orbits
from ..models.gpstime import GpsTime
from ..models.lnav import NavCache
from ..ops import synth_cuda as sc
from ..ops.epoch import (solve_ranges, solve_ranges_batch,
                         solve_ranges_batch_lean)
from ..ops.synth_torch import pack_plan, resolve_device
from ..runtime.scheduler import Scheduler, _gather_eph
from ..runtime.stream import device_view, launch_blocks

__all__ = ["MonteCarloBatch"]


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
        bs = int(block_samples or round(fs / 10))
        if bs > sc.MAX_BLOCK_SAMPLES:
            # the single-receiver stream splits over-long blocks into
            # re-anchored sub-blocks (runtime.stream.IqStream /
            # ops.synth_torch.split_plan); the batch path doesn't carry
            # the reassembly plumbing — fail with guidance instead of
            # the kernel builder's bare range assert
            raise ValueError(
                f"block_samples={bs} exceeds the synthesis kernel's Q24 "
                f"range ({sc.MAX_BLOCK_SAMPLES}; fs <= 5.24 MHz at "
                f"0.1 s blocks); Monte-Carlo batches do not sub-block "
                f"split — use fs <= 5.24 MHz, or per-receiver IqStream "
                f"runs (which split transparently)")
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
        self.control_seconds = 0.0   # cumulative host control-plane time
        self.patch_dropped = 0       # this batch's dropped gain-trunc patches

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

    def plan_blocks(self, n_blocks: int):
        """Plan n_blocks for every trajectory; returns kernel-ready args.

        All trajectories share the scenario clock, so their superframe
        boundaries align and every plan() round covers the same block
        span for every receiver — which is what lets the range solve
        batch over receivers, and (round 5, mirroring
        Scheduler.plan_group) over RUNS of consecutive superframes on
        one ephemeris set: one solve_ranges_batch_lean call per
        eph-set run chunk instead of one per superframe.  satpos inside
        the batched solve is receiver-independent and computed once per
        epoch grid (compute_range broadcasts it against the B axis)."""
        t_start = time.time()
        ca_tabs, sf_map = [], []
        per_b = [[] for _ in range(self.B)]

        # shared-clock span pre-simulation: every scheduler advances in
        # lockstep, so receiver 0's simulate_spans (the one copy of the
        # span/boundary/rollover protocol) covers the whole batch
        s0 = self.scheds[0]
        spans = s0.simulate_spans(total_blocks=int(n_blocks))

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
                        pre = self._alloc_precomp(
                            self.rin.eph[post], t_end,
                            rx[:, jb - jblk0 + M])
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
        # C/A tables dedupe by chip-table bytes: receivers near each
        # other see the same satellites, so B=256 plans typically share
        # a handful of distinct tables — sf_map rows point straight at
        # the deduped slot (the kernel reads tables through sf_map, so
        # the output is bit-identical; the ~1.2 s/256-table bit-pack
        # pass and its H2D bytes collapse with it)
        ca_seen: dict = {}
        dps_all = []
        for b in range(self.B):
            for plan in per_b[b]:
                dp = pack_plan(plan, tables=False)  # kernel builds LUTs
                dps_all.append(dp)
                key = dp.ca2.tobytes()
                idx = ca_seen.get(key)
                if idx is None:
                    idx = ca_seen[key] = len(ca_tabs)
                    ca_tabs.append(dp.ca2)
                sf_map.append(np.full(plan.n_blocks, idx, np.int32))
        # one batched parameter build over all B receivers' plans
        # (bit-identical to per-plan builds + concat; per-op numpy
        # overhead amortizes over B x n_superframes segments)
        bp = sc.build_group_params(dps_all)
        self.patch_dropped += bp.patch_dropped
        prmi, prmf = bp.prmi, bp.prmf
        sf_map = np.concatenate(sf_map)
        # the deduped list as it is: the CUDA kernel takes any table
        # count, so the JAX package's power-of-two padding (a fixed
        # Mosaic compile shape) has no counterpart here
        ca2 = sc.pack_ca_tables(ca_tabs)
        self.control_seconds += time.time() - t_start
        return prmi, prmf, ca2, sf_map

    def superframes(self, n_blocks: int, device,
                    chunk_blocks: int | None = None,
                    as_device: bool = False):
        """Stream the batch as (block_offset, iq) chunks — host RSS stays
        bounded by ONE chunk, so B=256 x 300 blocks (80 GB of IQ at
        2.6 MHz) never materializes anywhere.

        device is "cuda" (the synthesis kernel) or "cpu" (its plain
        twin); nothing is chosen automatically.  Blocks are
        receiver-major: global row r = b*n_blocks + k is receiver b's
        block k; each yielded chunk covers rows [block_offset,
        block_offset + len).  as_device=True yields the packed int32
        tensor [len, N] on the device (ordered on the consumer's current
        CUDA stream) instead of host int16 [len, N, 2].  On CUDA chunk
        k+1 launches while chunk k's D2H into a pinned host buffer
        completes (one-deep software pipeline on a stream of its own,
        runtime.stream.launch_blocks).

        chunk_blocks bounds the rows per kernel launch so the packed
        output fits device memory at large B (4*N bytes per row); the
        pipeline keeps up to TWO chunks' outputs live on the device at
        once, so size chunk_blocks so two chunks fit.  Default: the
        whole batch in one launch."""
        dev = resolve_device(device)
        prmi, prmf, ca2, sf_map = self.plan_blocks(n_blocks)
        total = self.B * n_blocks
        n = self.block_samples
        cuda_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

        def launch(lo, hi):
            arrays = (prmi[lo:hi], prmf[lo:hi], ca2, sf_map[lo:hi])
            if cuda_stream is None:
                return launch_blocks(arrays, n, dev, None, not as_device)
            with torch.cuda.device(dev), torch.cuda.stream(cuda_stream):
                return launch_blocks(arrays, n, dev, cuda_stream,
                                     not as_device)

        def finish(off, out, done):
            if as_device:
                return off, device_view(out, done, dev)
            if done is not None:
                done.synchronize()
            return off, sc.unpack_iq(out.numpy(), n)

        step = total if chunk_blocks is None else max(1, chunk_blocks)
        pending = None
        for off in range(0, total, step):
            out, done = launch(off, min(off + step, total))
            if pending is not None:
                yield finish(*pending)
            pending = (off, out, done)
        if pending is not None:
            yield finish(*pending)

    def generate(self, n_blocks: int, device,
                 chunk_blocks: int | None = None) -> np.ndarray:
        """Synthesize [B, n_blocks, N, 2] int16 IQ over B*n_blocks blocks
        on device ("cuda" or "cpu").

        Materializes the WHOLE batch on host — at large B use
        superframes() and consume per-chunk instead (B=256 x 300 blocks
        at 2.6 MHz is ~80 GB).  chunk_blocks still bounds the per-launch
        device footprint here."""
        n = self.block_samples
        out = np.empty((self.B * n_blocks, n, 2), dtype=np.int16)
        done = 0
        for off, iq in self.superframes(n_blocks, device,
                                        chunk_blocks=chunk_blocks):
            out[off:off + iq.shape[0]] = iq
            done += iq.shape[0]
        assert done == self.B * n_blocks
        return out.reshape(self.B, n_blocks, n, 2)
