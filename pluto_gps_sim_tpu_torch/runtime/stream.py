"""IQ stream driver: scheduler -> synthesis -> consumer.

The counterpart of the JAX package's ``runtime/stream.py`` (its mode
dispatch, stream.py:72-89, 304-432).

Replaces the reference's mutex/condvar double-buffer handoff to the SDR
thread (plutogpssim.c:2689-2759, 2146-2158) with a pull-based generator
of superframe-sized int16 IQ arrays.  The device produces far faster
than real time; sinks (files, pipes) pace themselves.

Also exposes snapshot/restore: because all per-sample state is
closed-form from (scheduler state, block index), resuming a stream is
just re-planning from the saved host state — the checkpoint is a few KB,
and a snapshot written by either package resumes in the other.
"""

from __future__ import annotations

import collections
import queue as _queue
import threading
import time
from typing import Iterator, NamedTuple

import numpy as np
import torch

from ..models.gpstime import GpsTime
from ..ingest.rinex import RinexResult
from ..ops.synth_torch import (pack_plan, resolve_device,
                               synth_superframe_precise_async,
                               synth_superframe_tiled_async)
from . import trace
from .launch import (SF_BLOCKS, DroppedCount, _to_host_async, device_view,
                     launch_blocks, pack_group, split_geometry, unpack_rows)
from .scheduler import Scheduler, copy_snapshot

__all__ = ["IqStream"]

# synthesis paths: the CUDA kernel (its plain twin on the CPU, None here),
# and the tiled and f64 precise tensor paths of ops.synth_torch
MODES = {"kernel": None, "tiled": synth_superframe_tiled_async,
         "precise": synth_superframe_precise_async}


def builds_on_card(device: torch.device, mesh, split_k: int) -> bool:
    """Whether a kernel-path IqStream builds a dispatch group's parameter
    planes on the card (launch.pack_group with the device: the
    build_params kernel on the planner's CUDA stream) rather than on the
    host: on a CUDA device, unsharded, its blocks unsplit (within the
    kernel's Q24 range).  A mesh shards host planes, and split blocks
    are cut into sub-rows on the host (split_plan)."""
    return device.type == "cuda" and mesh is None and split_k == 1


class _Handle(NamedTuple):
    """A dispatched group: its output (device tensor, or host tensor the
    D2H copy lands in), the CUDA event that completes it (None on the
    CPU), and the group it came from (the kernel's launch.Packed, or
    the tables=True DevicePlans the tensor paths read)."""

    out: torch.Tensor
    done: torch.cuda.Event | None
    group: object


class IqStream:
    """Iterates int16 IQ superframes [M, N, 2] for a scenario.

    mode="kernel" (the default) synthesizes with the CUDA kernel
    (ops.synth_cuda.synth_blocks) on device="cuda" (or a torch.device of
    type cuda), and with its plain twin on device="cpu".  mode="tiled"
    and mode="precise" run the tensor paths of ops.synth_torch on the
    given device (the JAX package's modes of the same names).  There is
    no automatic choice: a cuda stream on a host without CUDA raises.

    superframes_per_dispatch=K batches K consecutive superframes into
    ONE kernel launch (multi-superframe sf_map + per-superframe C/A
    tables); the yielded arrays are identical, just K superframes tall
    (the first few groups ramp 1, 2, 4, ... so a cold pipeline delivers
    its first samples sooner — dispatch_ramp()).  Device memory bounds
    K: the pipeline keeps up to THREE groups in flight, each K x 0.31 GB
    of packed output at fs=2.6 MHz.

    n_hosts/host_id partition a finite stream across hosts: host h
    fast-forwards the deterministic control plane to its contiguous
    share and synthesizes only blocks [h*M/N, (h+1)*M/N); the N hosts'
    outputs concatenate byte-identically to an unsharded run.

    mesh (a parallel.mesh.Mesh, mode="kernel" only) shards every
    dispatch group over the mesh's ranks (parallel.shard): every rank
    constructs the same stream on its own mesh.device (device must name
    it) and iterates it in step with the others, and every rank yields
    the single-device stream's output.  The collectives are issued by
    the planner thread only, one group after another, so every rank
    issues the same ones in the same order."""

    def __init__(self, rin: RinexResult, start: GpsTime, ieph: int,
                 xyz: np.ndarray, fs: float,
                 block_samples: int | None = None,
                 static_mode: bool = True,
                 mode: str = "kernel",
                 device: str | torch.device = "cuda",
                 superframes_per_dispatch: int = 1,
                 n_hosts: int = 1, host_id: int = 0,
                 mesh=None):
        t_init = time.perf_counter()
        # spans of this stream: "stream <serial>", its dispatch groups
        # "stream <serial> / group <i>", i counted over its iterations
        self._serial = trace.serial()
        self._groups = 0
        rec = trace.recorder("stream", self._serial)
        if mode not in MODES:
            raise ValueError(f"unknown synthesis mode {mode!r}")
        if mesh is not None and mode != "kernel":
            raise ValueError("mesh sharding requires mode='kernel'")
        self.mode = mode
        # the tensor path's synth function; None = the kernel
        self._synth = MODES[mode]
        self.mesh = mesh
        if mesh is not None:
            from ..parallel.mesh import check_mesh_device
            self.device = check_mesh_device(mesh, device)
        else:
            self.device = resolve_device(device)
        self.sched = Scheduler(rin, start, ieph, xyz, fs,
                               block_samples=block_samples,
                               static_mode=static_mode)
        if superframes_per_dispatch < 1:
            raise ValueError("superframes_per_dispatch must be >= 1")
        self.superframes_per_dispatch = int(superframes_per_dispatch)
        if not (0 <= host_id < n_hosts):
            raise ValueError(f"host_id {host_id} not in [0, {n_hosts})")
        self.n_hosts = int(n_hosts)
        self.host_id = int(host_id)
        # blocks beyond the kernel's Q24 range (fs > 5.24 MHz at 0.1 s
        # blocks) split into K equal re-anchored sub-blocks
        # (ops.synth_torch.split_plan) — sub-blocks are just shorter rows
        # of the kernel's grid, so the kernel covers ANY -s >= 1 MHz like
        # the reference (c:2326-2329); _finish reassembles [M*K, sub] ->
        # [M, N].  The tensor paths have no range cap and never split.
        # Public for as_device consumers (see superframes()).
        n = self.sched.block_samples
        self.split_k, self.sub_block_samples = \
            split_geometry(n) if self._synth is None else (1, n)
        # the prepared groups' dropped patch words (patch_dropped)
        self._dropped = DroppedCount()
        if rec is not None:
            rec.span("stream.init").open(t_init).close()

    @property
    def patch_dropped(self) -> int:
        """Gain-trunc patch words dropped to the per-block slot cap by
        THIS stream's dispatch groups (each leaves one LUT entry at the
        kernel's f32 trunc, +-1 LSB on that block's dwell samples).
        Groups built on the card count there; reading this waits for
        them."""
        return self._dropped.value

    @staticmethod
    def dispatch_ramp(k: int) -> Iterator[int]:
        """Dispatch-group sizes for superframes_per_dispatch=k: 1, 2,
        4, ..., then k forever.  A cold pipeline has nothing to hide
        host planning or device synthesis under, so ramping the group
        size as the pipeline fills cuts time-to-first-sample while
        steady state is unchanged.  Deterministic and public so shadow
        streams / A-B tests can mirror the grouping."""
        s = 1
        while s < k:
            yield s
            s *= 2
        while True:
            yield k

    def superframes(self, n_blocks_total: int | None,
                    max_blocks: int = 300,
                    as_device: bool = False) -> Iterator:
        """Yield superframes covering n_blocks_total 0.1 s blocks
        (None = endless).

        The loop is software-pipelined TWO dispatch groups deep with
        all host planning on a background thread: the planner plans,
        packs, and launches group k+2 while group k+1 synthesizes and
        copies to the host and group k is consumed by the caller.  On
        CUDA the planner owns a torch.cuda.Stream: parameter uploads
        from pinned memory, the kernel, and the copy into a fresh pinned
        host tensor all run on it, and a CUDA event tells the consumer
        when the group's bytes have landed.  Each yielded array owns its
        own host buffer; callers may keep it.

        snapshot() during iteration returns the resume point right
        after the last *yielded* superframe, not the planned-ahead
        scheduler state; abandoning the generator rolls the scheduler
        back to exactly after the last yielded superframe.

        as_device=True yields the raw output as a tensor on the stream's
        device (ordered on the consumer's current CUDA stream) instead
        of host int16 [M, N, 2]: for the kernel its packed int32 words
        [M*split_k, sub_block_samples], for the tensor paths their
        int16 [M, N, 2].  When the kernel's sub-block split is active
        (split_k > 1) the rows are the SUB-blocks, the last of each
        scenario block extrapolating past the block end; host-fetch
        consumers get the reassembled [M, N, 2] either way.
        """
        # handed to the planner thread, which cannot ask the profiler
        rec = trace.recorder("stream", self._serial)
        if self.n_hosts > 1:
            if n_blocks_total is None:
                raise ValueError(
                    "host-partitioned streams need a finite n_blocks_total")
            lo = self.host_id * n_blocks_total // self.n_hosts
            hi = (self.host_id + 1) * n_blocks_total // self.n_hosts
            if self.sched.jblk > lo:
                raise RuntimeError(
                    f"scheduler already at block {self.sched.jblk}, past "
                    f"this host's partition start {lo}")
            self.fast_forward(lo - self.sched.jblk)
            remaining = hi - lo
        else:
            remaining = n_blocks_total

        # maxsize=1 + the item the planner is blocked putting = two
        # dispatched groups ahead of the consumer
        q: _queue.Queue = _queue.Queue(maxsize=1)
        stop = threading.Event()
        lock = threading.Lock()
        # before-planning snapshots of every group not yet yielded, in
        # plan order — [0] is the rollback point if the generator is
        # abandoned (covers queued, dispatching, and mid-plan groups)
        unyielded: collections.deque = collections.deque()
        # With a mesh every dispatch is a collective, so an abandoned
        # generator must stop every rank's planner after the SAME group,
        # or one rank waits forever in a collective the others never
        # issue.  A planner runs at most two groups past the last group
        # the consumer took (one queued, one being put), so on
        # abandonment each planner runs on to exactly that count — a
        # number every rank agrees on — and the rollback below undoes
        # the extra groups as it does without a mesh.
        taken = 0
        stop_at = [0]

        def _stopped(dispatched: int) -> bool:
            return stop.is_set() and (self.mesh is None
                                      or dispatched >= stop_at[0])

        def _put(item) -> None:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return
                except _queue.Full:
                    continue

        def _plan_loop(cuda_stream) -> None:
            rem = remaining
            ramp = self.dispatch_ramp(self.superframes_per_dispatch)
            dispatched = 0
            while not _stopped(dispatched):
                if rem is not None and rem <= 0:
                    break
                with lock:
                    unyielded.append(self.sched.snapshot())
                k = next(ramp)
                g = self._groups
                self._groups += 1
                with trace.span(rec, "stream.plan", g, cpu=True) as sp:
                    plans = self.sched.plan_group(k, max_blocks,
                                                  total_blocks=rem)
                    blocks = sum(p.n_blocks for p in plans)
                    sp.n = n_sf = blocks / SF_BLOCKS
                if not plans:
                    with lock:
                        unyielded.pop()
                    break
                if rem is not None:
                    rem -= blocks
                with trace.span(rec, "stream.prepare", g, n_sf, cpu=True):
                    group = self._prepare_group(plans)  # host-only work
                after = self.sched.snapshot()
                with trace.span(rec, "stream.dispatch", g, n_sf,
                                cpu=True) as sp:
                    handle = self._dispatch(group, cuda_stream, as_device)
                    sp.rows = blocks * self.split_k
                dispatched += 1
                _put(("ok", handle, after, g, n_sf))

        def _planner() -> None:
            try:
                if self.device.type == "cuda":
                    with torch.cuda.device(self.device):
                        cuda_stream = torch.cuda.Stream(self.device)
                        with torch.cuda.stream(cuda_stream):
                            _plan_loop(cuda_stream)
                else:
                    _plan_loop(None)
            except BaseException as e:        # surfaced at the consumer
                _put(("err", e))
                return
            _put(None)

        # resume point before anything is yielded = the iteration start
        # (snapshot() must not read live scheduler state once the
        # planner owns it)
        self._yield_snap = self.sched.snapshot()
        self._planner_alive = True
        t = threading.Thread(target=_planner, name="iqstream-planner",
                             daemon=True)
        t.start()
        try:
            while True:
                with trace.span(rec, "stream.queue_wait") as wait:
                    item = q.get()
                    if item is not None and item[0] == "ok":
                        wait.group, wait.n = item[3], item[4]
                if item is None:
                    return
                if item[0] == "err":
                    raise item[1]
                taken += 1
                _, handle, snap_after, g, n_sf = item
                if as_device:
                    out = device_view(handle.out, handle.done, self.device)
                else:
                    with trace.span(rec, "transfer.event_wait", g, n_sf):
                        if handle.done is not None:
                            handle.done.synchronize()
                    with trace.span(rec, "stream.unpack", g, n_sf):
                        out = self._finish(handle)
                with lock:
                    unyielded.popleft()
                self._yield_snap = snap_after
                yield out      # abandonment suspends HERE
        finally:
            stop_at[0] = taken + 2
            stop.set()
            # unblock a planner stuck in put(), then wait it out before
            # touching scheduler state
            try:
                while True:
                    q.get_nowait()
            except _queue.Empty:
                pass
            t.join()
            self._planner_alive = False
            if unyielded:
                # groups were planned (and possibly dispatched) but
                # never yielded: roll the scheduler back so a later
                # superframes()/generate() call resumes exactly after
                # the last DELIVERED superframe instead of silently
                # skipping signal
                self.restore(unyielded[0])

    def generate(self, n_blocks_total: int) -> np.ndarray:
        """Generate the whole scenario into one array [blocks, N, 2]."""
        parts = list(self.superframes(n_blocks_total))
        return np.concatenate(parts, axis=0)

    def fast_forward(self, n_blocks: int) -> None:
        """Advance the scheduler n_blocks without synthesizing — the
        host-partition entry point.  O(boundaries), not O(blocks): the
        closed-form carrier anchors (scheduler module docstring) mean
        host h of N reaches its partition start by maintaining only the
        per-30 s boundary state."""
        self.sched.skip(n_blocks)

    # -- dispatch / fetch ------------------------------------------------

    def _prepare_group(self, plans: list):
        """ALL packing for one dispatch group (runs on the planner
        thread): launch.pack_group for the kernel, its planes built on
        the card where builds_on_card says so (enqueued on the planner's
        CUDA stream, nothing waited for), else on the host; the
        tables=True DevicePlans for the tensor paths."""
        if self._synth is not None:
            return tuple(pack_plan(p, tables=True) for p in plans)
        if builds_on_card(self.device, self.mesh, self.split_k):
            n_sf = sum(p.n_blocks for p in plans) / SF_BLOCKS
            with trace.child("packing.card_build", n=n_sf):
                group = pack_group(plans, self.device)
        else:
            group = pack_group(plans)
        self._dropped.add(group.patch_dropped)
        return group

    def _dispatch(self, group, cuda_stream, as_device: bool):
        """Start synthesis of a prepared group (planner thread).  On CUDA
        everything is enqueued on the planner's stream and this returns
        at once; on the CPU the synthesis runs here.  The tensor paths
        run per superframe plan and concatenate into one output."""
        to_host = not as_device
        if self._synth is None:
            out, done = launch_blocks(group.arrays, group.block_samples,
                                      self.device, cuda_stream, to_host,
                                      self.mesh)
            return _Handle(out, done, group)
        parts = [self._synth(dp, self.device) for dp in group]
        out = parts[0] if len(parts) == 1 else torch.cat(parts)
        if cuda_stream is None:
            return _Handle(out, None, group)
        return _Handle(*_to_host_async(out, cuda_stream, to_host), group)

    def _finish(self, handle: _Handle) -> np.ndarray:
        """Host int16 IQ [M, N, 2] of a handle whose copy has landed."""
        if self._synth is not None:
            return handle.out.numpy()
        g = handle.group
        return unpack_rows(handle.out, g.block_samples, g.n_orig)

    # -- snapshot / resume ---------------------------------------------------

    def snapshot(self) -> dict:
        """Host state capsule; everything device-side is derived.

        During superframes() iteration this is the resume point after
        the last yielded superframe (the planner thread runs up to two
        dispatch groups ahead, see superframes()); while the planner is
        alive the live scheduler state is ITS working state and is
        never read here (the frozen per-yield capsule is)."""
        snap = getattr(self, "_yield_snap", None)
        if snap is not None and (getattr(self, "_planner_alive", False)
                                 or snap["jblk"] != self.sched.jblk):
            return copy_snapshot(snap)
        return self.sched.snapshot()

    def restore(self, snap: dict) -> None:
        s = self.sched
        # a snapshot written by an older schema (e.g. one without the
        # carrier anchor pair) would leave fields at their defaults and
        # resume with a silent per-channel phase discontinuity at the
        # splice — fail loudly instead
        missing = set(vars(s.state)) - set(snap["channel_state"])
        if missing:
            raise ValueError(
                f"snapshot lacks channel-state fields {sorted(missing)} "
                "(written by an incompatible framework version?)")
        s.restore(snap)
        self._yield_snap = None
