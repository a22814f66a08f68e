"""Command-line interface mirroring the reference simulator's flags.

Same option surface and semantics as the reference's getopt loop
(plutogpssim.c:2296-2396, usage c:1991-2012):

  -e <file>    RINEX navigation file (required unless -f)
  -u <file>    user motion CSV (dynamic mode, 10 Hz, wraps at EOF)
  -3           RINEX version 3
  -f           fetch the current hourly RINEX file from the IGS server
  -c <x,y,z>   static ECEF location [m]
  -l <l,l,h>   static geodetic location (deg, deg, m)
  -t <Y/M/D,h:m:s>  scenario start time
  -T <.|now>   overwrite TOC/TOE to the scenario start time
  -s <hz>      sampling frequency (>= 1 MHz)
  -i           disable ionospheric delay
  -v           verbose
  -A <db>      TX attenuation (clamped [-80, 0]; metadata for SDR sinks)
  -B <mhz>     RF bandwidth (clamped [1, 5] MHz; metadata for SDR sinks)
  -U <uri>     SDR URI (iio sink)
  -N <host>    SDR network hostname (iio sink)

Intentional divergences (each documented in SURVEY.md section 5):
  * the reference parses -g but ignores it; we accept and ignore it too,
    warning once (quirk parity without silent surprise);
  * default static location: the reference only converts its Tokyo llh
    default to ECEF inside the -l handler (c:2322), so running without
    -l/-c/-u leaves the receiver at the ECEF origin; we convert the
    default properly;
  * blocks are fs/10 samples so scenario time and signal time agree at
    every fs (the reference hardcodes NUM_SAMPLES=300000, c:44, which
    drifts at fs != 3 MHz);
  * default fs is 2.6 MHz — what the reference's usage text (c:2002)
    and README advertise and what BASELINE.json benchmarks — while the
    reference's code actually defaults to 3 MHz (c:43, c:2271); pass
    -s 3000000 for code-default parity;
  * new flags for the pluggable output stage (the reference can only
    transmit to a Pluto SDR): -o/--out, --sink, -d/--duration,
    --realtime, --mode, --device, plus --snapshot/--resume checkpointing.

The option surface is the JAX package's (pluto_gps_sim_tpu/cli.py).  Its
--mode auto|pallas|tiled|precise becomes --mode kernel|tiled|precise
(default kernel: the CUDA synthesis kernel, or its plain PyTorch twin on
the CPU) beside --device cuda|cpu (default cuda); nothing picks a path
or a device silently.  --profile writes a torch.profiler Chrome trace
that also holds the program's spans (runtime/trace).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import sys
import time

import numpy as np

from .constants import R2D
from .models.gpstime import DateTime, GpsTime, date2gps, gps2date

__all__ = ["main", "build_parser", "parse_cli"]

# flags taking a value whose argument may itself start with '-' (e.g.
# "-A -30"); argparse would otherwise read "-30" as an option because the
# parser also defines -3 (RINEX v3), so merge the pair into "-A-30"
_VALUE_FLAGS = {"-A", "-B", "-c", "-l"}


def parse_cli(argv: list[str] | None = None) -> argparse.Namespace:
    argv = list(sys.argv[1:] if argv is None else argv)
    merged: list[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in _VALUE_FLAGS and i + 1 < len(argv) and \
                re.match(r"-[\d.]", argv[i + 1]):
            # merge only when the next token is a negative NUMBER
            # ("-A -30"); "-c -l" stays two flags and errors cleanly
            merged.append(a + argv[i + 1])
            i += 2
        else:
            merged.append(a)
            i += 1
    return build_parser().parse_args(merged)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pluto-gps-sim-tpu-torch",
        description="GPS L1 C/A baseband IQ synthesizer (PyTorch + CUDA)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("-e", dest="navfile", metavar="FILE",
                   help="RINEX navigation file (required unless -f)")
    p.add_argument("-u", dest="umfile", metavar="FILE",
                   help="user motion CSV (dynamic mode, 10 Hz)")
    p.add_argument("-3", dest="rinex3", action="store_true",
                   help="RINEX version 3 format")
    p.add_argument("-f", dest="use_ftp", action="store_true",
                   help="fetch current hourly RINEX file from IGS FTP")
    p.add_argument("-c", dest="ecef", metavar="X,Y,Z",
                   help="static ECEF location in meters")
    p.add_argument("-l", dest="llh", metavar="LAT,LON,HGT",
                   help="static geodetic location (deg,deg,m)")
    p.add_argument("-t", dest="start", metavar="Y/M/D,h:m:s",
                   help="scenario start time")
    p.add_argument("-T", dest="overwrite", metavar="Y/M/D,h:m:s|now",
                   help="overwrite TOC/TOE to scenario start time")
    p.add_argument("-s", dest="fs", type=float, default=2_600_000.0,
                   metavar="HZ", help="sampling frequency")
    p.add_argument("-i", dest="iono_off", action="store_true",
                   help="disable ionospheric delay")
    p.add_argument("-v", dest="verbose", action="store_true",
                   help="show details about simulated channels")
    p.add_argument("-A", dest="gain_db", type=float, default=-20.0,
                   metavar="DB", help="TX attenuation (SDR sinks)")
    p.add_argument("-B", dest="bw_mhz", type=float, default=3.0,
                   metavar="MHZ", help="RF bandwidth (SDR sinks)")
    p.add_argument("-U", dest="uri", metavar="URI", help="SDR URI")
    p.add_argument("-N", dest="hostname", metavar="HOST",
                   help="SDR network hostname")
    p.add_argument("-g", dest="_legacy_g", metavar="X",
                   help=argparse.SUPPRESS)  # parsed-but-ignored, like c:2296
    # --- extensions over the reference -----------------------------------
    p.add_argument("-o", "--out", dest="out", default="gpssim.bin",
                   metavar="FILE", help="output IQ file ('-' = stdout)")
    p.add_argument("--sink", choices=["file", "stdout", "udp", "iio", "null"],
                   default=None, help="output sink (default: file, or iio "
                   "when -U/-N given)")
    p.add_argument("-d", "--duration", dest="duration", type=float,
                   default=30.0, metavar="SEC",
                   help="signal duration in seconds (0 = endless)")
    p.add_argument("--realtime", action="store_true",
                   help="pace output to fs via the native ring writer")
    p.add_argument("--mode", choices=["kernel", "tiled", "precise"],
                   default="kernel",
                   help="synthesis path (kernel = the CUDA kernel, or its "
                   "plain PyTorch twin on --device cpu; tiled = integer "
                   "NCO tensor path; precise = f64 golden)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="synthesis device")
    p.add_argument("--udp-host", default="127.0.0.1")
    p.add_argument("--udp-port", type=int, default=5015)
    p.add_argument("--snapshot", metavar="FILE",
                   help="write a resume checkpoint here on exit")
    p.add_argument("--resume", metavar="FILE",
                   help="resume from a checkpoint written by --snapshot")
    p.add_argument("--stats", action="store_true",
                   help="print JSON stream stats (samples, rate, CRC32)")
    p.add_argument("--selfcheck", action="store_true",
                   help="after a file-sink run, FFT-acquire every planned "
                        "PRN from the written IQ and fail if any is not "
                        "receivable (software stand-in for the reference's "
                        "hardware-receiver validation)")
    p.add_argument("--profile", metavar="DIR",
                   help="capture a torch.profiler Chrome trace of the run "
                   "into DIR/trace.json")
    p.add_argument("--dispatch-superframes", type=int, default=1,
                   metavar="K",
                   help="batch K consecutive 30 s superframes per device "
                        "dispatch (amortizes per-call latency; output is "
                        "identical)")
    p.add_argument("--shard", metavar="H/N",
                   help="host-partitioned stream: this process synthesizes "
                        "contiguous share H of N (0-based) of the requested "
                        "duration; the N outputs concatenate byte-"
                        "identically to an unsharded run (requires -d)")
    return p


def _parse_shard(s: str) -> tuple[int, int]:
    try:
        h, n = (int(x) for x in s.split("/"))
    except ValueError:
        raise SystemExit("ERROR: --shard must be H/N (e.g. 0/4)")
    if not (n >= 1 and 0 <= h < n):
        raise SystemExit("ERROR: --shard needs 0 <= H < N")
    return h, n


def _parse_time(s: str) -> GpsTime:
    try:
        date, clock = s.split(",")
        y, m, d = (int(x) for x in date.split("/"))
        hh, mm = (int(x) for x in clock.split(":")[:2])
        sec = float(clock.split(":")[2])
    except (ValueError, IndexError):
        raise SystemExit("ERROR: Invalid date and time.")
    if (y <= 1980 or not 1 <= m <= 12 or not 1 <= d <= 31
            or not 0 <= hh <= 23 or not 0 <= mm <= 59
            or not 0.0 <= sec < 60.0):
        raise SystemExit("ERROR: Invalid date and time.")
    return date2gps(DateTime(y, m, d, hh, mm, float(int(sec))))


def main(argv: list[str] | None = None) -> int:
    args = parse_cli(argv)

    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("ERROR: --device cuda needs a CUDA GPU, and torch sees "
                  "none (use --device cpu for the plain PyTorch path).",
                  file=sys.stderr)
            return 1

    if args.navfile is None and not args.use_ftp:
        print("ERROR: GPS ephemeris file is not specified.", file=sys.stderr)
        return 1
    if args.fs < 1e6:
        print("ERROR: Invalid sampling frequency.", file=sys.stderr)
        return 1
    if args._legacy_g is not None:
        print("WARNING: -g is accepted for reference CLI parity but has "
              "no effect (the reference parses and ignores it too).",
              file=sys.stderr)
    gain_db = min(0.0, max(-80.0, args.gain_db))
    bw_hz = min(5.0, max(1.0, args.bw_mhz)) * 1e6

    # defer heavy imports so --help stays fast
    from .ingest import read_rinex2, read_rinex3, read_user_motion
    from .models.geodesy import llh2xyz
    from .runtime import select_ephemeris_set, setup_scenario
    from .runtime.scenario import ScenarioError
    from .runtime.sinks import open_sink
    from .runtime.stream import IqStream

    # --- receiver position ------------------------------------------------
    static_mode = args.umfile is None
    if not static_mode:
        xyz = read_user_motion(args.umfile)
        print("Using user motion mode.", file=sys.stderr)
    else:
        try:
            if args.ecef:
                xyz = np.array([float(v) for v in args.ecef.split(",")],
                               dtype=np.float64)
                if xyz.shape != (3,):
                    raise ValueError(args.ecef)
            elif args.llh:
                lat, lon, hgt = (float(v) for v in args.llh.split(","))
            else:  # reference default (Tokyo), converted properly
                lat, lon, hgt = 35.681298, 139.766247, 10.0
        except ValueError:
            print("ERROR: Invalid location (expected three comma-separated "
                  "numbers).", file=sys.stderr)
            return 1
        if not args.ecef:
            xyz = np.asarray(llh2xyz(
                np.array([lat / R2D, lon / R2D, hgt])))
        print("Using static location mode.", file=sys.stderr)
    print(f"Gain: {gain_db:.1f}dB", file=sys.stderr)

    # --- ephemerides --------------------------------------------------------
    navfile = args.navfile
    if args.use_ftp:
        from .ingest.fetch import fetch_rinex
        navfile = "rinex3.gz" if args.rinex3 else "rinex2.gz"  # c:33-34
        try:
            url = fetch_rinex(navfile, use_rinex3=args.rinex3)
        except OSError as e:
            print(f"Curl error: {e}", file=sys.stderr)  # c:2471-2474
            return 1
        print(f"Fetched {url} -> {navfile}", file=sys.stderr)
    from .ingest.rinex import RinexError
    try:
        rin = (read_rinex3 if args.rinex3 else read_rinex2)(navfile)
    except (RinexError, OSError) as e:
        print(f"ERROR: {e}", file=sys.stderr)  # reference: c:2482-2485
        return 1
    if args.iono_off:
        rin.ionoutc.enable = np.array(False)
    print(f"RINEX date = {rin.rinex_date}", file=sys.stderr)

    if args.verbose and bool(rin.ionoutc.vflg):
        io = rin.ionoutc  # same formats as the reference (c:2486-2494)
        print(f"  {float(io.alpha0):12.3e} {float(io.alpha1):12.3e} "
              f"{float(io.alpha2):12.3e} {float(io.alpha3):12.3e}",
              file=sys.stderr)
        print(f"  {float(io.beta0):12.3e} {float(io.beta1):12.3e} "
              f"{float(io.beta2):12.3e} {float(io.beta3):12.3e}",
              file=sys.stderr)
        print(f"   {float(io.A0):19.11e} {float(io.A1):19.11e}  "
              f"{int(io.tot):9d} {int(io.wnt):9d}", file=sys.stderr)
        print(f"{int(io.dtls):6d}", file=sys.stderr)

    # --- scenario time ------------------------------------------------------
    g0 = None
    if args.overwrite:
        # -T now: current time; -T <date>: parse it; -T with any other
        # token (the reference idiom "-t <date> -T x", where -T only
        # flags the overwrite): take the time from -t
        if args.overwrite.startswith("now"):
            g0 = date2gps(_now_utc())
        elif "/" in args.overwrite:
            g0 = _parse_time(args.overwrite)
        elif args.start:
            g0 = _parse_time(args.start)
        else:
            print("ERROR: -T needs 'now', a date, or a -t start time.",
                  file=sys.stderr)
            return 1
    elif args.start:
        g0 = _parse_time(args.start)
    try:
        g0 = setup_scenario(rin, g0, timeoverwrite=bool(args.overwrite))
        ieph = select_ephemeris_set(rin, g0)
    except ScenarioError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    t0 = gps2date(g0)
    print(f"Start time = {t0.y:4d}/{t0.m:02d}/{t0.d:02d},"
          f"{t0.hh:02d}:{t0.mm:02d}:{int(t0.sec):02d} "
          f"({g0.week}:{g0.sec:.0f})", file=sys.stderr)

    # --- stream -------------------------------------------------------------
    host_id, n_hosts = (_parse_shard(args.shard) if args.shard else (0, 1))
    if n_hosts > 1 and args.duration <= 0:
        print("ERROR: --shard requires a finite -d duration",
              file=sys.stderr)
        return 1
    if args.selfcheck and host_id != 0:
        # the planned-PRN set is captured at scenario t0, but shard
        # host_id > 0 fast-forwards before writing: its file starts
        # mid-scenario where rise/set may have changed the set.
        # Selfcheck shard 0, or the concatenated output, instead.
        print("ERROR: --selfcheck only supports --shard 0/N",
              file=sys.stderr)
        return 1
    stream = IqStream(rin, g0, ieph, xyz, fs=args.fs,
                      static_mode=static_mode, mode=args.mode,
                      device=args.device,
                      superframes_per_dispatch=args.dispatch_superframes,
                      n_hosts=n_hosts, host_id=host_id)
    if args.resume:
        with open(args.resume, "rb") as fp:
            stream.restore(_load_snapshot(fp))
        print(f"Resumed from {args.resume} (block {stream.sched.jblk})",
              file=sys.stderr)

    if args.verbose:
        _print_channel_table(stream)
    # channel set at stream start (rise/set may change it mid-run; the
    # selfcheck acquires from the file's FIRST milliseconds)
    start_prns = sorted(int(p) for p in stream.sched.state.prn if p > 0)

    sink_kind = args.sink
    if sink_kind is None:
        sink_kind = ("iio" if (args.uri or args.hostname) else
                     "stdout" if args.out == "-" else "file")
    sink = open_sink(sink_kind, path=args.out, fs=args.fs,
                     realtime=args.realtime, udp_host=args.udp_host,
                     udp_port=args.udp_port, bw_hz=bw_hz, gain_db=gain_db,
                     uri=args.uri, hostname=args.hostname,
                     block_samples=stream.sched.block_samples)
    if args.stats:
        from .runtime.sinks import StatsSink
        sink = StatsSink(sink)

    profiler = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile, record_function
        activities = [ProfilerActivity.CPU]
        if stream.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.__enter__()
        # ties the program's perf_counter spans to the profiler's clock
        with record_function(_PROFILE_MARK):
            mark_s = time.perf_counter()

    stop = {"flag": False}

    def _handle(sig, frame):
        stop["flag"] = True
        print("\nDone!", file=sys.stderr)

    old_handlers = {}
    for s in (signal.SIGINT, signal.SIGTERM):
        try:
            old_handlers[s] = signal.signal(s, _handle)
        except ValueError:
            pass  # non-main thread (tests)
    try:
        # make a closed consumer raise BrokenPipeError instead of killing
        # the process (the runtime stack resets CPython's SIG_IGN default)
        old_handlers[signal.SIGPIPE] = signal.signal(signal.SIGPIPE,
                                                     signal.SIG_IGN)
    except (ValueError, AttributeError):
        pass

    n_blocks_total = (int(round(args.duration * 10))
                      if args.duration > 0 else None)
    produced = 0
    t_start = time.time()
    try:
        # one generator end-to-end: superframes() software-pipelines the
        # host plan / device synthesis / D2H across superframes
        for sf in stream.superframes(n_blocks_total):
            try:
                sink.write(sf)
                produced += sf.shape[0]
            except (BrokenPipeError, IOError) as e:
                # consumer went away (pipe closed, SDR unplugged,
                # ring-writer I/O error): stop cleanly, like the
                # reference's TX-failure exit flag (c:2182); the failed
                # superframe is not counted as delivered
                print(f"\nOutput closed ({e}); stopping.", file=sys.stderr)
                stop["flag"] = True
            if args.verbose:
                el = time.time() - t_start
                print(f"\rTime = {produced / 10.0:4.1f}s "
                      f"({produced / 10.0 / max(el, 1e-9):.0f}x real time)",
                      end="", file=sys.stderr)
            if stop["flag"]:
                break
        if args.verbose:
            print(file=sys.stderr)
    finally:
        sink.close()
        if profiler is not None:
            profiler.__exit__(None, None, None)
            os.makedirs(args.profile, exist_ok=True)
            trace = os.path.join(args.profile, "trace.json")
            profiler.export_chrome_trace(trace)
            _add_program_spans(trace, mark_s)
            print(f"Profiler trace written to {trace}", file=sys.stderr)
        for s, h in old_handlers.items():
            signal.signal(s, h)
        if args.snapshot:
            with open(args.snapshot, "wb") as fp:
                _dump_snapshot(stream.snapshot(), fp)
            print(f"Snapshot written to {args.snapshot}", file=sys.stderr)

    if args.selfcheck:
        if sink_kind != "file" or produced == 0:
            print("selfcheck: needs a file sink and >= 1 block written",
                  file=sys.stderr)
            return 1
        if not _selfcheck(args.out, args.fs, start_prns):
            return 1

    if hasattr(sink, "stats"):
        stats = sink.stats()
        if stream.mode == "kernel":
            # gain-trunc patch words THIS stream dropped to the
            # per-block slot cap (each degrades one LUT entry to the
            # kernel's f32 trunc, a +-1 LSB effect —
            # synth_cuda._N_PATCH); normally 0
            stats["patch_dropped"] = stream.patch_dropped
        stats["blocks"] = produced
        print(f"sink stats: {json.dumps(stats)}", file=sys.stderr)
    return 0


_PROFILE_MARK = "pluto_gps_sim_tpu_torch.mark"


def _add_program_spans(path: str, mark_s: float) -> None:
    """Add the program's spans that started since mark_s to the Chrome
    trace at path, as "X" events on the profiler's clock: the marker
    event _PROFILE_MARK was recorded as perf_counter() read mark_s."""
    from .runtime import trace
    with open(path) as fp:
        doc = json.load(fp)
    events = doc["traceEvents"]
    mark_us = next(e["ts"] for e in events
                   if e.get("name") == _PROFILE_MARK)
    pid = os.getpid()
    tids: dict = {}
    for s in trace.spans(mark_s):
        if s.thread not in tids:
            # a named track per thread, above any OS thread id
            tids[s.thread] = tid = (1 << 30) + len(tids)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid,
                           "args": {"name": f"program spans: {s.thread}"}})
        events.append({
            "ph": "X", "cat": "program", "name": s.name, "pid": pid,
            "tid": tids[s.thread], "ts": mark_us + (s.t0 - mark_s) * 1e6,
            "dur": (s.t1 - s.t0) * 1e6,
            "args": {"req": s.req, "parent": s.parent, "n": s.n,
                     "cpu_s": s.cpu, "bytes": s.bytes}})
    with open(path, "w") as fp:
        json.dump(doc, fp)


def _selfcheck(path: str, fs: float, planned: list[int]) -> bool:
    """FFT-acquire every planned PRN from the first ms of the written
    file (host int16, read back from disk); print one line per PRN and a
    verdict (the JAX package's cli.py:446-474)."""
    from .utils.acquisition import acquire

    # acquire() uses 2 one-ms windows: 2 * n_per_code IQ pairs of int16
    n_int16 = 4 * int(round(fs * 1e-3)) + 4
    iq = np.fromfile(path, dtype=np.int16, count=n_int16)
    # a run that planned no PRNs produced no receivable signal — that is
    # a selfcheck FAILURE, not a vacuous pass; likewise an all-zero file
    # (acquire() itself reports ratio 0 on silent IQ, but the energy
    # check gives the operator a direct diagnosis)
    if not planned:
        print("selfcheck: FAIL (no PRNs were planned — the scenario "
              "produced no signal)", file=sys.stderr)
        return False
    if not np.any(iq):
        print("selfcheck: FAIL (output IQ is all zeros)", file=sys.stderr)
        return False
    ok = True
    for prn in planned:
        r = acquire(iq, fs, prn)
        print(f"selfcheck: {r}", file=sys.stderr)
        ok = ok and r.detected
    print(f"selfcheck: {'PASS' if ok else 'FAIL'} "
          f"({len(planned)} planned PRNs)", file=sys.stderr)
    return ok


def _now_utc() -> DateTime:
    gmt = time.gmtime()
    return DateTime(gmt.tm_year, gmt.tm_mon, gmt.tm_mday, gmt.tm_hour,
                    gmt.tm_min, float(gmt.tm_sec))


def _print_channel_table(stream) -> None:
    """Startup channel table, same format as the reference (c:2634-2639)."""
    st = stream.sched.state
    print("PRN   Az    El     Range     Iono", file=sys.stderr)
    for c in range(st.prn.size):
        if st.prn[c] > 0:
            print(f"{int(st.prn[c]):02d} {st.azel[c, 0] * R2D:6.1f} "
                  f"{st.azel[c, 1] * R2D:5.1f} {st.d0[c]:11.1f} "
                  f"{st.iono_delay[c]:5.1f}", file=sys.stderr)


def _dump_snapshot(snap: dict, fp) -> None:
    np.savez(fp, jblk=snap["jblk"], ieph=snap["ieph"],
             **{f"cs_{k}": v for k, v in snap["channel_state"].items()})


def _load_snapshot(fp) -> dict:
    z = np.load(fp, allow_pickle=False)
    return {
        "jblk": int(z["jblk"]), "ieph": int(z["ieph"]),
        "channel_state": {k[3:]: z[k] for k in z.files
                          if k.startswith("cs_")},
    }


if __name__ == "__main__":
    sys.exit(main())
