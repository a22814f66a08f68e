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
from typing import Iterator, NamedTuple

import numpy as np
import torch

from ..models.gpstime import GpsTime
from ..ingest.rinex import RinexResult
from ..ops import synth_cuda as sc
from ..ops.synth_torch import (pack_plan, resolve_device,
                               split_plan, synth_superframe_precise_async,
                               synth_superframe_tiled_async)
from .scheduler import Scheduler

__all__ = ["IqStream"]

# synthesis paths: the CUDA kernel (its plain twin on the CPU, None here),
# and the tiled and f64 precise tensor paths of ops.synth_torch
MODES = {"kernel": None, "tiled": synth_superframe_tiled_async,
         "precise": synth_superframe_precise_async}


class _Group(NamedTuple):
    """Host-packed inputs for one dispatch group: the kernel's planes,
    C/A tables and block->superframe map (mode "kernel"), or the
    tables=True DevicePlans the tensor paths read."""

    payload: tuple            # (prmi, prmf, ca_tabs, sf_map) or DevicePlans
    block_samples: int        # samples per output row (sub-block)
    n_orig: int               # samples per scenario block


class _Handle(NamedTuple):
    """A dispatched group: its output (device tensor, or host tensor the
    D2H copy lands in), the CUDA event that completes it (None on the
    CPU), and the group it came from."""

    out: torch.Tensor
    done: torch.cuda.Event | None
    group: _Group


def launch_blocks(arrays, block_samples: int, device: torch.device,
                  cuda_stream, to_host: bool):
    """Stage one kernel launch's host inputs and launch it; returns
    (out, done).

    On the CPU the twin runs here and done is None.  On CUDA the planes
    go up from pinned staging copies, the kernel runs, and (to_host)
    its packed output comes back into a fresh pinned host tensor, all
    enqueued on cuda_stream; done is the event recorded after them, so
    the caller returns at once and the next launch overlaps this one's
    copy.  Shared by IqStream and parallel.MonteCarloBatch."""
    prmi, prmf, ca_tabs, sf_map = arrays
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (prmi, prmf, ca_tabs, sf_map)]
    if cuda_stream is None:
        return sc.synth_blocks(*args, block_samples), None
    sc.check_sf_map(sf_map, ca_tabs.shape[0])
    args = [a.pin_memory().to(device, non_blocking=True) for a in args]
    out = sc.synth_blocks(*args, block_samples)
    return _to_host_async(out, cuda_stream, to_host)


def _to_host_async(out: torch.Tensor, cuda_stream, to_host: bool):
    """(out, event) after an optional D2H of out into a fresh pinned
    host tensor, both on cuda_stream; the consumer owns the buffer."""
    if to_host:
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
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
    outputs concatenate byte-identically to an unsharded run."""

    def __init__(self, rin: RinexResult, start: GpsTime, ieph: int,
                 xyz: np.ndarray, fs: float,
                 block_samples: int | None = None,
                 static_mode: bool = True,
                 mode: str = "kernel",
                 device: str | torch.device = "cuda",
                 superframes_per_dispatch: int = 1,
                 n_hosts: int = 1, host_id: int = 0):
        if mode not in MODES:
            raise ValueError(f"unknown synthesis mode {mode!r}")
        self.mode = mode
        # the tensor path's synth function; None = the kernel
        self._synth = MODES[mode]
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
        n = self.sched.block_samples
        self.split_k = -(-n // sc.MAX_BLOCK_SAMPLES) \
            if self._synth is None and n > sc.MAX_BLOCK_SAMPLES else 1
        # public split geometry for as_device consumers (see
        # superframes()); sub_block_samples matches what split_plan
        # derives per dispatch
        self.sub_block_samples = -(-n // self.split_k)
        # gain-trunc patch words dropped to the per-block slot cap by
        # THIS stream's dispatches (each leaves one LUT entry at the
        # kernel's f32 trunc, +-1 LSB on that block's dwell samples)
        self.patch_dropped = 0
        # packed C/A tables keyed by the +-1 chip table's bytes: the
        # channel allocation only changes at rise/set (minutes), so
        # every superframe of a dispatch group usually shares ONE
        # table and the bit-pack pass collapses to dict hits
        self._ca_cache: dict = {}

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
            while not stop.is_set():
                if rem is not None and rem <= 0:
                    break
                with lock:
                    unyielded.append(self._state_snapshot())
                k = next(ramp)
                if self.superframes_per_dispatch > 1:
                    plans = self.sched.plan_group(
                        k, max_blocks, total_blocks=rem)
                else:
                    todo = max_blocks if rem is None else \
                        min(rem, max_blocks)
                    plan = self.sched.plan(todo)
                    plans = [] if plan is None else [plan]
                if not plans:
                    with lock:
                        unyielded.pop()
                    break
                if rem is not None:
                    rem -= sum(p.n_blocks for p in plans)
                group = self._prepare_group(plans)     # host-only work
                after = self._state_snapshot()
                handle = self._dispatch(group, cuda_stream, as_device)
                _put(("ok", handle, after))

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
        self._yield_snap = self._state_snapshot()
        self._planner_alive = True
        t = threading.Thread(target=_planner, name="iqstream-planner",
                             daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if item[0] == "err":
                    raise item[1]
                _, handle, snap_after = item
                out = (self._device_view(handle) if as_device
                       else self._finish(handle))
                with lock:
                    unyielded.popleft()
                self._yield_snap = snap_after
                yield out      # abandonment suspends HERE
        finally:
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

    def _prepare_group(self, plans: list) -> _Group:
        """ALL host-side packing for one dispatch group (runs on the
        planner thread): plan -> DevicePlan pack, and for the kernel the
        parameter planes, C/A bit tables, and block->superframe map."""
        dps = [pack_plan(p, tables=self._synth is not None) for p in plans]
        n_orig = dps[0].block_samples
        if self._synth is not None:
            return _Group(tuple(dps), n_orig, n_orig)
        if self.split_k > 1:
            dps = [split_plan(dp, sc.MAX_BLOCK_SAMPLES) for dp in dps]
        # one batched build for the whole group (bit-identical to
        # per-plan builds + concat)
        bp = sc.build_group_params(dps)
        self.patch_dropped += bp.patch_dropped
        ca_tabs = self._pack_ca_group([dp.ca2 for dp in dps])
        sf_map = np.concatenate(
            [np.full(dp.n_blocks, i, np.int32)
             for i, dp in enumerate(dps)])
        return _Group((bp.prmi, bp.prmf, ca_tabs, sf_map),
                      dps[0].block_samples, n_orig)

    def _pack_ca_group(self, ca2s: list) -> np.ndarray:
        """pack_ca_tables through the per-stream packed-table cache.

        Output is bit-identical to sc.pack_ca_tables(ca2s) and keeps its
        [len(ca2s), C, 1, 128] shape (one table slot per superframe) —
        only the per-table packing work is deduplicated."""
        packed = []
        for ca2 in ca2s:
            key = ca2.tobytes()
            hit = self._ca_cache.pop(key, None)   # pop+reinsert = LRU:
            if hit is None:                       # a table hit every group
                if len(self._ca_cache) >= 64:     # but inserted early must
                    self._ca_cache.pop(next(iter(self._ca_cache)))  # stay
                hit = sc.pack_ca_tables([ca2])[0]
            self._ca_cache[key] = hit
            packed.append(hit)
        return np.stack(packed)

    def _dispatch(self, group: _Group, cuda_stream, as_device: bool):
        """Start synthesis of a prepared group (planner thread).  On CUDA
        everything is enqueued on the planner's stream and this returns
        at once; on the CPU the synthesis runs here.  The tensor paths
        run per superframe plan and concatenate into one output."""
        to_host = not as_device
        if self._synth is None:
            out, done = launch_blocks(group.payload, group.block_samples,
                                      self.device, cuda_stream, to_host)
            return _Handle(out, done, group)
        parts = [self._synth(dp, self.device) for dp in group.payload]
        out = parts[0] if len(parts) == 1 else torch.cat(parts)
        if cuda_stream is None:
            return _Handle(out, None, group)
        return _Handle(*_to_host_async(out, cuda_stream, to_host), group)

    def _device_view(self, handle: _Handle) -> torch.Tensor:
        """The raw output behind a handle, ordered on the consumer's
        current CUDA stream — what as_device=True yields."""
        return device_view(handle.out, handle.done, self.device)

    def _finish(self, handle: _Handle) -> np.ndarray:
        if handle.done is not None:
            handle.done.synchronize()
        g = handle.group
        if self._synth is not None:
            return handle.out.numpy()
        iq = sc.unpack_iq(handle.out.numpy(), g.block_samples)
        if self.split_k > 1:
            # reassemble sub-blocks into scenario blocks; the last
            # sub-block of each row extrapolated past the true block
            # end (split_plan), so trim K*sub -> N
            k = self.split_k
            iq = iq.reshape(iq.shape[0] // k, k * iq.shape[1], 2)
            iq = iq[:, :g.n_orig]
        return iq

    # -- snapshot / resume ---------------------------------------------------

    def _state_snapshot(self) -> dict:
        s = self.sched
        return {
            "jblk": s.jblk, "ieph": s.ieph,
            "channel_state": {k: np.copy(v) for k, v in
                              vars(s.state).items()},
        }

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
            return {"jblk": snap["jblk"], "ieph": snap["ieph"],
                    "channel_state": {k: np.copy(v) for k, v in
                                      snap["channel_state"].items()}}
        return self._state_snapshot()

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
        s.jblk = snap["jblk"]
        s.ieph = snap["ieph"]
        for k, v in snap["channel_state"].items():
            setattr(s.state, k, np.copy(v))
        self._yield_snap = None
