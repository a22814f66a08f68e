"""One run of one cell: inputs from the seed, set-up, the measured
window, the per-layer readings of a traced run, and the comparison
with the reference.

The three kinds of traffic are one general generator each, driven by
the traffic file's parameters:

  stream  IqStream(...).superframes() into a sink, the CLI's loop, from
          the seed's start to the end of the nav file's validity, then
          again from the file's first time of clock
  batch   MonteCarloBatch(...).superframes(as_device=True) batch after
          batch on the shared clock, each chunk summed on the card one
          chunk behind
  clips   a closed loop of fresh IqStreams, one client, each request a
          clip for a new receiver at a new time
"""

from __future__ import annotations

import math
import shutil
import statistics
import subprocess
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import data, judge, opmodel
from . import trace as tr

SF_BLOCKS = 300                 # 0.1 s blocks in a 30 s superframe


@dataclass
class Scenario:
    """The inputs handed alike to the program and to the reference."""

    nav_path: str
    fs: float
    day_s: float                 # the file's validity from its first toc
    last_toc_s: float            # the last set's toc after the first
    start_offset_s: float        # the stream's start after the first toc
    xyz: np.ndarray | None       # static receiver, ECEF
    motion_path: str | None
    dispatch: int                # superframes per dispatch group
    center: np.ndarray           # the configuration's receiver, ECEF
    ionosphere: bool             # False is upstream's -i


@dataclass
class Run:
    """What a run measured; the metric readers read it."""

    cell: str
    kind: str
    window_s: float = 0.0
    e2e: dict = field(default_factory=dict)
    rec: tr.Recorder = field(default_factory=tr.Recorder)
    ops: list = field(default_factory=list)         # DeviceOp, traced run
    t0: float = 0.0
    t1: float = 0.0
    units: float = 0.0           # superframes (stream), batches, clips
    work: dict | None = None     # opmodel.work of every row synthesized
    attempted: int = 0
    extra: dict = field(default_factory=dict)
    progress: list = field(default_factory=list)    # (host time, units)

    def per_second(self) -> list:
        """Units delivered in each whole second of the window."""
        out, k, last = [], 1, 0.0
        for t, u in self.progress:
            while t >= self.t0 + k:
                out.append(last)
                k += 1
            last = u
        return [b - a for a, b in zip([0.0] + out, out)]

    def device_seconds(self, match) -> float:
        return sum(o.t1 - o.t0 for o in self.ops if match(o.name))

    def busy_s(self) -> float:
        return sum(b - a for a, b in tr.busy_intervals(self.ops, self.t0,
                                                       self.t1))


def _rngs(seed: int):
    """Independent generators for the data, the scenario, the samples
    and the warm-up, all from the one seed."""
    return [np.random.default_rng([int(seed), k]) for k in range(4)]


def _offset(rng, span_s: float) -> float:
    """A start uniform over [0, span_s], on the 0.1 s grid."""
    return float(rng.integers(0, int(round(span_s * 10)) + 1)) / 10.0


def make_scenario(cfg: dict, seed: int, workdir: Path,
                  start_s: float | None = None):
    nav = cfg["nav"]
    r_data, r_scen, _, _ = _rngs(seed)
    nav_path = str(workdir / "brdc.23n")
    data.write_rinex2(nav_path, r_data, nav["sets"], nav["satellites"],
                      nav["set_gap_hours"])
    day_s = nav["sets"] * nav["set_gap_hours"] * 3600.0
    last_toc = (nav["sets"] - 1) * nav["set_gap_hours"] * 3600.0
    rx = cfg["receiver"]
    center = data.llh_to_ecef(*rx["llh"])
    motion_path, xyz = None, center
    if rx["kind"] == "circle":
        motion_path = str(workdir / "motion.csv")
        data.write_circle_motion(motion_path, rx["rows"], rx["llh"],
                                 rx["radius_m"], rx["period_s"])
        xyz = None
    start = _offset(r_scen, last_toc) if start_s is None else float(start_s)
    return Scenario(nav_path, float(cfg["fs_hz"]), day_s, last_toc, start,
                    xyz, motion_path, int(cfg["dispatch_superframes"]),
                    center, bool(cfg["ionosphere"])), r_scen


class Program:
    """The system under test, pluto_gps_sim_tpu_torch, on one scenario."""

    def __init__(self, scen: Scenario, device: str):
        from pluto_gps_sim_tpu_torch.ingest import (read_rinex2,
                                                    read_user_motion)
        from pluto_gps_sim_tpu_torch.runtime import setup_scenario
        self.scen, self.device = scen, device
        self.rin = read_rinex2(scen.nav_path)
        if not scen.ionosphere:                  # as the CLI's -i does
            self.rin.ionoutc.enable = np.array(False)
        self.first_toc = setup_scenario(self.rin, None)
        self.static = scen.motion_path is None
        self.xyz = scen.xyz if self.static else \
            read_user_motion(scen.motion_path)

    def start(self, offset_s: float):
        from pluto_gps_sim_tpu_torch.models.gpstime import inc_gps_time
        from pluto_gps_sim_tpu_torch.runtime import (select_ephemeris_set,
                                                     setup_scenario)
        g0 = setup_scenario(self.rin, inc_gps_time(self.first_toc, offset_s))
        return g0, select_ephemeris_set(self.rin, g0)

    def stream(self, offset_s: float, xyz=None):
        from pluto_gps_sim_tpu_torch.runtime.stream import IqStream
        g0, ieph = self.start(offset_s)
        return IqStream(self.rin, g0, ieph,
                        self.xyz if xyz is None else xyz,
                        fs=self.scen.fs, static_mode=self.static,
                        mode="kernel", device=self.device,
                        superframes_per_dispatch=self.scen.dispatch)


def _instrument_stream(rec: tr.Recorder, st, offset: float,
                       groups: list) -> None:
    """Spans around the stream's planner calls; groups gets (offset,
    first block, blocks) of every group planned."""
    if not rec.on:
        return
    plan_group = st.sched.plan_group

    def planned(*args, **kwargs):
        j0 = st.sched.jblk
        t0 = time.perf_counter()
        plans = plan_group(*args, **kwargs)
        n = sum(p.n_blocks for p in plans)
        rec.add("control.plan_group", t0, time.perf_counter(),
                n / SF_BLOCKS)
        groups.append((offset, j0, n))
        return plans
    st.sched.plan_group = planned
    rec.wrap(st, "_prepare_group", "packing.prepare_group",
             units=lambda out, args: sum(p.n_blocks for p in args[0])
             / SF_BLOCKS)


def _segments(prog: Program, scen: Scenario, seg_cap: int | None,
              rec: tr.Recorder | None, groups: list | None):
    """(offset, first block, superframes) through the stream's segments:
    from the seed's start to the end of the nav file's validity, then
    again from the file's first time of clock, without end.  With rec,
    the window's spans; closing it closes the open stream."""
    day_blocks = int(round(scen.day_s * 10))
    offset = scen.start_offset_s
    while True:
        n = day_blocks - int(round(offset * 10))
        t0 = time.perf_counter()
        st = prog.stream(offset)
        if rec is not None:
            rec.add("stream.init", t0, time.perf_counter())
            _instrument_stream(rec, st, offset, groups)
        gen = st.superframes(n if seg_cap is None else min(n, seg_cap))
        pos = 0
        try:
            while True:
                t0 = time.perf_counter()
                arr = next(gen, None)
                if arr is None:
                    break
                if rec is not None:
                    rec.add("stream.wait", t0, time.perf_counter(),
                            arr.shape[0] / SF_BLOCKS)
                yield offset, pos, arr
                pos += arr.shape[0]
        finally:
            gen.close()
        offset = 0.0


def _grow_pinned_pool(sf_bytes: int, k: int, groups: int,
                      device: str) -> None:
    """Hold `groups` pinned output buffers of a whole dispatch group,
    and two of each ramp size, at once, then free them: the caching host
    allocator keeps them, so no fresh pinned allocation (~0.25 s a GB)
    falls in the window when, now and then, more of the pipeline's
    buffers are alive at once than the warm-up happened to need."""
    if device != "cuda":
        return
    import torch
    sizes = [k * sf_bytes] * groups
    j = 1
    while j < k:
        sizes += [j * sf_bytes] * 2
        j *= 2
    held = [torch.empty(n, dtype=torch.uint8, pin_memory=True)
            for n in sizes]
    del held


def drive_stream(run: Run, prog: Program, scen: Scenario, trf: dict,
                 seconds: float, res: judge.Reservoir, timed,
                 seg_cap: int | None = None) -> None:
    from pluto_gps_sim_tpu_torch.runtime.sinks import open_sink
    sink = open_sink(trf["sink"], fs=scen.fs)

    # warm-up: the same traffic for a fixed number of superframes, so
    # the kernel is built, the host allocator holds every pinned size
    # the pipeline keeps in flight, and the rate has settled
    warm = 0.0
    seg = _segments(prog, scen, seg_cap, None, None)
    for _, _, arr in seg:
        sink.write(arr)
        warm += arr.shape[0] / SF_BLOCKS
        if warm >= trf["warm_superframes"]:
            break
    seg.close()
    _grow_pinned_pool(arr.shape[1] * 4 * SF_BLOCKS, scen.dispatch,
                      int(trf["pinned_groups"]), prog.device)
    del seg, arr

    groups: list = []
    blocks = restarts = 0
    t_start = timed()
    deadline = t_start + seconds
    seg = _segments(prog, scen, seg_cap, run.rec, groups)
    for offset, pos, arr in seg:
        if pos == 0 and blocks:
            restarts += 1
        sink.write(arr)
        res.offer([(offset, pos + i) for i in range(arr.shape[0])],
                  lambda i, a=arr: np.array(a[i]))
        blocks += arr.shape[0]
        n_per_block = arr.shape[1]
        t_last = time.perf_counter()
        run.progress.append((t_last, blocks / SF_BLOCKS))
        if t_last >= deadline:
            break
    seg.close()
    sink.close()
    run.t0, run.t1 = t_start, t_last
    run.window_s = t_last - t_start
    run.units = blocks / SF_BLOCKS
    run.attempted = blocks
    run.e2e["stream_rate"] = blocks * n_per_block / run.window_s / 1e6
    run.extra.update(restarts=restarts, blocks=blocks, groups=groups)


def _steady_start(scen: Scenario, rng, xyz: np.ndarray, channels: int,
                  span_blocks: int, tries: int = 1000) -> float:
    """A start drawn from rng at which every receiver keeps `channels`
    channels active for span_blocks: each seed then asks the same work
    of the batch, whatever constellation it drew."""
    import reference
    for _ in range(tries):
        start = _offset(rng, scen.last_toc_s)
        # the centre first: one receiver scans fast
        if all((reference.channel_counts(scen.nav_path, start, rx, scen.fs,
                                         span_blocks) == channels).all()
               for rx in (scen.center[None, :], xyz)):
            return start
    raise RuntimeError(f"no start with {channels} channels for "
                       f"{span_blocks} blocks in {tries} draws")


def drive_batch(run: Run, prog: Program, scen: Scenario, trf: dict,
                seconds: float, res: judge.Reservoir, timed, r_scen,
                start_fixed: bool = False) -> None:
    import torch

    from pluto_gps_sim_tpu_torch.parallel import MonteCarloBatch
    rec = run.rec
    b = int(trf["receivers"])
    xyz = scen.center[None, :] + r_scen.uniform(
        -trf["spread_m"], trf["spread_m"], (b, 3))
    if "active_channels" in trf and not start_fixed:
        scen.start_offset_s = _steady_start(
            scen, r_scen, xyz, int(trf["active_channels"]),
            int(trf["steady_blocks"]))
    g0, ieph = prog.start(scen.start_offset_s)
    mc = MonteCarloBatch(prog.rin, g0, ieph, xyz, fs=scen.fs)
    n_blocks = int(trf["batch_blocks"])
    rows_per_batch = b * n_blocks

    def consume(batch: int, keep: bool) -> None:
        gen = mc.superframes(n_blocks, prog.device,
                             chunk_blocks=int(trf["chunk_blocks"]),
                             as_device=True)
        total, pending, rows = 0, None, 0
        t0 = time.perf_counter()
        for off, dev in gen:
            rec.add("mc.consume", t0, time.perf_counter())
            # every word read once on the card: an int32 sum, which
            # wraps (sum(dtype=int64) would first copy the chunk to int64)
            s = dev.sum(dtype=torch.int32)
            if pending is not None:
                total += int(pending)      # one chunk behind
            pending = s
            if keep:
                res.offer([(batch, off + i) for i in range(dev.shape[0])],
                          lambda i, d=dev: d[i].clone())
            rows += dev.shape[0]
            t0 = time.perf_counter()
        total += int(pending)
        if rows != rows_per_batch:
            raise RuntimeError(f"batch {batch} delivered {rows} rows of "
                               f"{rows_per_batch}")
        run.extra.setdefault("sums", []).append(total)

    warm = int(trf["warm_batches"])
    for batch in range(warm):          # warm-up: the clock's first batches
        consume(batch, keep=False)
    rec.wrap(mc, "plan_blocks", "mc.plan_blocks",
             units=lambda out, args: 1.0)
    t_start = timed()
    deadline = t_start + seconds
    batch = warm
    while True:
        consume(batch, keep=True)
        t_last = time.perf_counter()
        run.progress.append((t_last, float(batch)))
        batch += 1
        if t_last >= deadline:
            break
    run.t0, run.t1 = t_start, t_last
    run.window_s = t_last - t_start
    run.units = batch - warm
    run.attempted = (batch - warm) * rows_per_batch
    n = mc.block_samples
    run.e2e["mc_rate"] = run.attempted * n / run.window_s / 1e6
    run.extra.update(xyz=xyz, n_blocks=n_blocks, batches=batch - warm,
                     warm_batches=warm, patch_dropped=mc.patch_dropped)


def _globe_point(rng, height):
    """A receiver uniform over the globe's area, at a uniform height."""
    lat = math.degrees(math.asin(rng.uniform(-1.0, 1.0)))
    lon = rng.uniform(-180.0, 180.0)
    return data.llh_to_ecef(lat, lon, rng.uniform(*height))


def drive_clips(run: Run, prog: Program, scen: Scenario, trf: dict,
                seconds: float, res: judge.Reservoir, timed, r_scen,
                r_warm) -> None:
    rec = run.rec
    nblk = int(trf["clip_blocks"])

    def request(rng):
        """(latency s, offset, xyz, delivered parts) of one clip."""
        t0 = time.perf_counter()
        xyz = _globe_point(rng, trf["height_m"])
        offset = _offset(rng, scen.last_toc_s)
        st = prog.stream(offset, xyz)
        rec.add("clips.init", t0, time.perf_counter())
        _instrument_stream(rec, st, offset, [])
        parts = []
        gen = st.superframes(nblk)
        while True:
            tw = time.perf_counter()
            part = next(gen, None)
            if part is None:
                break
            rec.add("stream.wait", tw, time.perf_counter())
            parts.append(part)
        t1 = time.perf_counter()
        got = sum(p.shape[0] for p in parts)
        if got != nblk:
            raise RuntimeError(f"clip delivered {got} blocks of {nblk}")
        return t1 - t0, offset, xyz, parts

    for _ in range(int(trf["warm_clips"])):
        request(r_warm)
    lat = []
    t_start = timed()
    deadline = t_start + seconds
    i = 0
    while True:
        dt, offset, xyz, parts = request(r_scen)
        lat.append(dt)
        run.progress.append((time.perf_counter(), float(len(lat))))
        pick = sorted({0, nblk - 1, int(r_scen.integers(0, nblk))})
        res.offer([(i, offset, tuple(xyz))],
                  lambda _, p=parts, b=pick: _blocks_of(p, b))
        del parts
        i += 1
        t_last = time.perf_counter()
        if t_last >= deadline:
            break
    run.t0, run.t1 = t_start, t_last
    run.window_s = t_last - t_start
    run.units = i
    run.attempted = i
    run.e2e["clip_p95_ms"] = float(np.percentile(lat, 95)) * 1e3
    run.extra.update(latencies=lat)


def _blocks_of(parts: list, blocks: list) -> dict:
    """Copies of the given blocks of a clip delivered as parts."""
    out, lo = {}, 0
    for p in parts:
        for b in blocks:
            if lo <= b < lo + p.shape[0]:
                out[b] = np.array(p[b - lo])
        lo += p.shape[0]
    return out


def _work(run: Run, scen: Scenario, trf: dict, n_samples: int) -> dict:
    """opmodel.work of every row the kernel synthesized in the window,
    from the reference's allocation."""
    import reference
    cps = 1.023e6 / scen.fs          # chips per sample at the code rate
    w = {"ops": 0.0, "bytes": 0.0, "channel_samples": 0.0}

    def add(counts):
        rows = np.zeros((counts.size, 12))
        for c in range(12):
            rows[:, c] = np.where(counts.ravel() > c, cps, 0.0)
        for k, v in opmodel.work(rows, n_samples).items():
            w[k] += v

    if run.kind == "stream":
        ends: dict = {}
        for offset, j0, n in run.extra["groups"]:
            ends[offset] = max(ends.get(offset, 0), j0 + n)
        for offset, end in ends.items():
            add(reference.channel_counts(scen.nav_path, offset, scen.xyz,
                                         scen.fs, end, scen.motion_path))
    elif run.kind == "batch":
        nb = run.extra["n_blocks"]
        warm = run.extra["warm_batches"] * nb
        counts = reference.channel_counts(
            scen.nav_path, scen.start_offset_s, run.extra["xyz"], scen.fs,
            warm + run.extra["batches"] * nb)
        add(counts[:, warm:])          # the window's batches
    else:
        return None
    return w


def trace_window(torch_mod):
    """(profiler, the host time its clock marker was recorded at)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])
    prof.__enter__()
    with record_function("h100_bench.mark"):
        mark_s = time.perf_counter()
    return prof, mark_s


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(spec: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_process: float = None,
             overrides: dict | None = None, control: bool = False,
             root: Path | None = None, hooks: dict | None = None) -> dict:
    """Run one cell; returns the result object the last line prints.

    overrides: {"config": {...}, "traffic": {...}} keys replaced (the CPU
    tests' tiny sizes); root: the checkout whose BENCHMARK.json names the
    cell (default this one); hooks: the CPU tests' own settings, never a
    traffic file's: "start_s" fixes the start, "segment_blocks" caps a
    stream's segments;
    control: the float32 reference takes the program's place in the
    comparison (the control that must come out not correct)."""
    import torch

    from . import spec as specmod

    t_process = time.perf_counter() if t_process is None else t_process
    root = specmod.ROOT if root is None else Path(root)
    bench_dir = root / specmod.BENCH_DIR.name
    w = specmod.cell(spec, cell_name)
    overrides = overrides or {}
    cfg = {**specmod.config(spec, w["config"], root),
           **overrides.get("config", {})}
    trf = {**specmod.traffic(w["traffic"], bench_dir),
           **overrides.get("traffic", {})}
    hooks = hooks or {}
    _check_channels(cfg)
    workdir = Path(tempfile.mkdtemp(prefix="h100_bench-"))
    phases = {"imports": time.perf_counter() - t_process}
    try:
        if device == "cuda":
            torch.zeros(1, device=device)          # the CUDA context
        phases["cuda_init"] = time.perf_counter() - t_process
        scen, r_scen = make_scenario(cfg, seed, workdir,
                                     hooks.get("start_s"))
        _, _, r_sample, r_warm = _rngs(seed)
        run = Run(cell_name, trf["kind"])
        run.rec.on = trace
        res = judge.Reservoir(trf["sample"], r_sample)
        prog = Program(scen, device)
        phases["inputs"] = time.perf_counter() - t_process
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        prof = None
        marks = {}

        def timed():
            """Start of the window: set-up ends here."""
            nonlocal prof
            if device == "cuda":
                torch.cuda.synchronize()
            marks["setup_s"] = time.perf_counter() - t_process
            marks["pinned"] = _pinned_allocs(device)
            if trace and device == "cuda":
                prof, marks["mark_s"] = trace_window(torch)
            return time.perf_counter()

        if run.kind == "stream":
            drive_stream(run, prog, scen, trf, seconds, res, timed,
                         hooks.get("segment_blocks"))
        elif run.kind == "batch":
            drive_batch(run, prog, scen, trf, seconds, res, timed, r_scen,
                        "start_s" in hooks)
        elif run.kind == "clips":
            drive_clips(run, prog, scen, trf, seconds, res, timed, r_scen,
                        r_warm)
        else:
            raise ValueError(f"unknown traffic kind {run.kind!r}")
        run.e2e["setup_s"] = marks["setup_s"]
        pinned = {k: v - marks["pinned"].get(k, 0)
                  for k, v in _pinned_allocs(device).items()}
        if device == "cuda":
            torch.cuda.synchronize()
        if prof is not None:
            prof.__exit__(None, None, None)
            run.ops = tr.device_ops(prof, tr.marker_us(prof,
                                                       "h100_bench.mark"),
                                    marks["mark_s"])
            del prof
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        kept = res.kept()
        del prog
        if device == "cuda":
            torch.cuda.empty_cache()

        # the comparison, once the window has closed and the program's
        # state is freed
        t_judge = time.perf_counter()
        got, want = _judge_inputs(run, scen, kept, trf, device, control)
        phases["judge_s"] = time.perf_counter() - t_judge
        readings = judge.compare(got, want)
        correct, checks = judge.verdict(readings)

        names = specmod.metrics_for(spec, cell_name, trace)
        metrics = {}
        if not trace:
            for m in names:
                metrics[m["name"]] = {"value": run.e2e[m["name"]],
                                      "unit": m["unit"]}
        else:
            run.work = _work(run, scen, trf, int(round(scen.fs / 10)))
            for m in names:
                v = specmod.metric_reader(m["name"], bench_dir)(run)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev = {"platform": "gpu" if device == "cuda" else device,
               "kind": torch.cuda.get_device_name(0) if device == "cuda"
               else "cpu",
               "count": int(w["chips"]), "memory_peak_bytes": int(peak)}
        if device == "cuda":
            dev["power_limit"] = power_limit()
        out = {"correct": bool(correct), "attempted": int(run.attempted),
               "failed": int(readings["failed_blocks"]),
               "metrics": metrics, "device": dev}
        if trace:
            busy = tr.busy_intervals(run.ops, run.t0, run.t1)
            dev["busy_s"] = sum(b - a for a, b in busy)
            dev["window_s"] = run.window_s
            ops: dict = {}
            for o in run.ops:
                ops[o.name] = ops.get(o.name, 0.0) + (o.t1 - o.t0)
            out["breakdown"] = {
                "device_ops": tr.top(ops),
                "idle_gaps": tr.top(tr.idle_gaps(busy, run.t0, run.t1,
                                                 run.rec.spans))}
            _write_trace(bench_dir / "out" / f"{cell_name}.{seed}.trace.json",
                         run)
        phases["total_s"] = time.perf_counter() - t_process
        out["info"] = {"window_s": run.window_s, "units": run.units,
                       "phases": phases,
                       "seed": int(seed), "start_offset_s":
                       scen.start_offset_s,
                       **{k: v for k, v in run.extra.items()
                          if k in ("restarts", "blocks", "batches",
                                   "patch_dropped")},
                       **({"clips": len(run.extra["latencies"]),
                           "clip_median_ms": statistics.median(
                               run.extra["latencies"]) * 1e3}
                          if "latencies" in run.extra else {}),
                       "pinned_allocs_in_window": pinned,
                       "per_second": run.per_second(),
                       "readings": readings}
        out["checks"] = checks
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _pinned_allocs(device: str) -> dict:
    """The caching host allocator's count and time of fresh pinned
    allocations, where this torch reports them."""
    import torch
    try:
        stats = torch.cuda.host_memory_stats() if device == "cuda" else {}
    except (AttributeError, RuntimeError):
        return {}
    return {k: v for k, v in stats.items()
            if isinstance(v, (int, float)) and k.startswith(
                ("num_host_alloc", "host_alloc_time", "allocated_bytes"))}


def _check_channels(cfg: dict) -> None:
    """The configuration's channel count is the one both sides run."""
    from pluto_gps_sim_tpu_torch.constants import MAX_CHAN

    from reference.constants import MAX_CHAN as REF_CHAN
    if not int(cfg["channels"]) == MAX_CHAN == REF_CHAN:
        raise ValueError(f"{cfg['name']} states {cfg['channels']} channels;"
                         f" the program runs {MAX_CHAN}, the reference "
                         f"{REF_CHAN}")


def _write_trace(path: Path, run: Run) -> None:
    """The traced window's spans and device operations, in seconds from
    the window's start, for reading by hand (git ignores out/)."""
    import json
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = run.t0
    path.write_text(json.dumps({
        "window_s": run.window_s,
        "spans": [[s.name, s.thread, s.t0 - t0, s.t1 - t0, s.n]
                  for s in run.rec.spans],
        "device_ops": [[o.name, o.t0 - t0, o.t1 - t0] for o in run.ops]}))


def _judge_inputs(run: Run, scen: Scenario, kept: list, trf: dict,
                  device: str, control: bool):
    """({key: program words}, {key: reference words}) of the kept
    units, each as int16 [N, 2]."""
    import torch

    import reference
    got: dict = {}
    asks: dict = {}        # (offset, xyz key, motion) -> {block: key}
    if run.kind == "stream":
        for (offset, blk), iq in kept:
            got[(offset, blk)] = iq
            asks.setdefault((offset, None), {})[blk] = (offset, blk)
    elif run.kind == "batch":
        nb = run.extra["n_blocks"]
        for (batch, row), words in kept:
            b, k = divmod(row, nb)
            blk = batch * nb + k
            got[(b, blk)] = judge.iq_of_words(words.cpu().numpy())
            asks.setdefault((scen.start_offset_s, b), {})[blk] = (b, blk)
    else:
        for (i, offset, xyz), blocks in kept:
            for blk, iq in blocks.items():
                got[(i, blk)] = iq
                asks.setdefault((offset, xyz), {})[blk] = (i, blk)
    want: dict = {}
    ctl: dict = {}
    for (offset, who), blocks in asks.items():
        if run.kind == "batch":
            xyz = run.extra["xyz"][who]
        elif run.kind == "clips":
            xyz = np.asarray(who)
        else:
            xyz = scen.xyz
        for dtype, dst in ((torch.float64, want),) + (
                ((torch.float32, ctl),) if control else ()):
            iq = reference.replay(scen.nav_path, offset, xyz, scen.fs,
                                  list(blocks), device, dtype,
                                  scen.motion_path, scen.ionosphere)
            for blk, key in blocks.items():
                dst[key] = iq[blk]
    return (ctl if control else got), want
