#!/usr/bin/env python3
"""On-card smoke test of pluto_gps_sim_tpu_torch on one CUDA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints one line with its wall time; any failure raises and
exits non-zero):
  1. the card's name and power limit; build the CUDA synthesis kernel
     from ops/csrc/ with nvcc (sm_90a) and time the build;
  2. the kernel against its plain PyTorch twin (synth_blocks_plain, on
     the CPU), word for word: the fixture scenario at 2.6 MHz, 5 MHz
     (n reaches 499,999), a 10 MHz plan split into 2 sub-blocks, a
     patch-carrying nudge=False plan, and the packed=False epilogue;
     then kernel and twin both on the card at every dispatch group of
     phase 3's main path (1, 2, 4 and 3 superframes, multi-superframe
     sf_map), word for word; then both timed on the card at 300 blocks
     x 260,000 samples x 12 channels (CUDA events), with their words
     compared again;
  3. the CLI's main path on cuda: -s 2600000 -d 300
     --dispatch-superframes 8 --sink null --stats (3,000 blocks);
     asserts the kernel launched, no patch word was dropped and every
     block was produced, and prints the real-time factor;
  4. -d 60 to a file through the CLI, then blocks 0-1 and 300-301
     recomputed with IqStream(device="cpu") must equal the file;
  5. a JSON line per the kernels, the card line, and the result line.

Uses only this package (never jax) and the tracked RINEX fixture
tests/data/brdc_test.23n.  Extra logs go to chiprun_out/chip_smoke/.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RINEX = ROOT / "tests" / "data" / "brdc_test.23n"
LLH = "35.681298,139.766247,10.0"
OUT_DIR = ROOT / "chiprun_out" / "chip_smoke"
TIMED_BLOCKS = 300          # one 30 s superframe at 2.6 MHz
TIMED_SAMPLES = 260_000


def _phase(name: str, t0: float, msg: str = "") -> None:
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s {msg}".rstrip(),
          flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def _scenario():
    import numpy as np

    from pluto_gps_sim_tpu_torch.constants import R2D
    from pluto_gps_sim_tpu_torch.ingest import read_rinex2
    from pluto_gps_sim_tpu_torch.models.geodesy import llh2xyz
    from pluto_gps_sim_tpu_torch.runtime import (select_ephemeris_set,
                                                 setup_scenario)
    rin = read_rinex2(str(RINEX))
    g0 = setup_scenario(rin, None)
    ieph = select_ephemeris_set(rin, g0)
    lat, lon, hgt = (float(v) for v in LLH.split(","))
    xyz = np.asarray(llh2xyz(np.array([lat / R2D, lon / R2D, hgt])))
    return rin, g0, ieph, xyz


def _inputs(dps, nudge: bool = True):
    """Kernel inputs (numpy) for the DevicePlans of one dispatch."""
    import numpy as np

    from pluto_gps_sim_tpu_torch.ops import synth_cuda as sc
    bp = sc.build_group_params(dps, nudge=nudge)
    ca = sc.pack_ca_tables([dp.ca2 for dp in dps])
    sf_map = np.concatenate([np.full(dp.n_blocks, i, np.int32)
                             for i, dp in enumerate(dps)])
    return bp, ca, sf_map, dps[0].block_samples


def _synthetic_plan(n_blocks: int, n_samples: int, fs: float, seed: int,
                    gain=None):
    """A SuperframePlan with all 12 channel slots active, made from a
    seed (random Dopplers, code phases, nav bits and gains)."""
    import numpy as np

    from pluto_gps_sim_tpu_torch.constants import MAX_CHAN
    from pluto_gps_sim_tpu_torch.models.cacode import CA_TABLE
    from pluto_gps_sim_tpu_torch.runtime.scheduler import SuperframePlan
    rng = np.random.RandomState(seed)
    C = MAX_CHAN
    shape = (n_blocks, C)
    active = np.ones(shape, bool)
    f_carr = np.repeat(rng.uniform(-4500.0, 4500.0, (1, C)), n_blocks, 0)
    return SuperframePlan(
        n_blocks=n_blocks, block_samples=n_samples, delt=1.0 / fs,
        prn=np.arange(1, C + 1, dtype=np.int32),
        ca2=(CA_TABLE[np.arange(C)] * 2 - 1).astype(np.int8),
        bits=rng.choice([-1, 1], (C, 1800)).astype(np.int8),
        active=active, f_carr=f_carr, f_code=1_023_000.0 + f_carr / 1540.0,
        code_phase=rng.uniform(0, 1023, shape),
        icode=rng.randint(0, 20, shape).astype(np.int32),
        ibit=rng.randint(0, 30, shape).astype(np.int32),
        iword=rng.randint(0, 10, shape).astype(np.int32),
        carr_phase=rng.uniform(0, 1, shape),
        gain=(rng.uniform(0.3, 1.2, shape) if gain is None else gain),
        azel=np.zeros((n_blocks, C, 2)))


def _to(dev, bp, ca, sf_map):
    import torch
    return [torch.from_numpy(a).to(dev) for a in (bp.prmi, bp.prmf, ca,
                                                  sf_map)]


def _max_abs_err(a, b) -> int:
    """Largest |difference| over the int16 I and Q of two packed outputs."""
    import numpy as np

    from pluto_gps_sim_tpu_torch.ops.synth_cuda import unpack_iq
    ia = unpack_iq(np.ascontiguousarray(a)).astype(np.int64)
    ib = unpack_iq(np.ascontiguousarray(b)).astype(np.int64)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def _compare_case(name: str, bp, ca, sf_map, n: int, packed: bool = True):
    """Kernel on the card vs the twin on the CPU, word for word."""
    import numpy as np
    import torch

    from pluto_gps_sim_tpu_torch.ops import synth_cuda as sc
    t0 = time.perf_counter()
    got = sc.synth_blocks(*_to("cuda", bp, ca, sf_map), n, packed=packed)
    torch.cuda.synchronize()
    want = sc.synth_blocks_plain(*_to("cpu", bp, ca, sf_map), n,
                                 packed=packed)
    if packed:
        got, want = [got.cpu().numpy()], [want.numpy()]
        err = _max_abs_err(got[0], want[0])
    else:
        got = [t.cpu().numpy() for t in got]
        want = [t.numpy() for t in want]
        err = max(int(np.abs(g.astype(np.int64) - w).max())
                  for g, w in zip(got, want))
    bad = sum(int((g != w).sum()) for g, w in zip(got, want))
    if bad:
        raise AssertionError(f"{name}: kernel differs from the twin in "
                             f"{bad} words (max abs err {err})")
    _phase(f"compare {name}", t0,
           f"rows={bp.prmi.shape[0]} samples={n} words equal, "
           f"max_abs_err={err}")
    return err


def _time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_build() -> float:
    from pluto_gps_sim_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    cuda_build.load_kernel("synth_blocks")
    dt = time.perf_counter() - t0
    log = cuda_build.build_logs.get("synth_blocks", "(loaded from cache)")
    (OUT_DIR / "nvcc_synth_blocks.log").write_text(log)
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    _phase("build synth_blocks.cu", t0, "; ".join(regs))
    return dt


def phase_compare(scen) -> int:
    from pluto_gps_sim_tpu_torch.ops import synth_cuda as sc
    from pluto_gps_sim_tpu_torch.ops.synth_torch import pack_plan, split_plan
    from pluto_gps_sim_tpu_torch.runtime.scheduler import Scheduler
    rin, g0, ieph, xyz = scen
    errs = []

    dp26 = pack_plan(Scheduler(rin, g0, ieph, xyz, fs=2.6e6).plan(4),
                     tables=False)
    in26 = _inputs([dp26])
    errs.append(_compare_case("fs=2.6MHz 4 blocks", *in26))

    dp5 = pack_plan(Scheduler(rin, g0, ieph, xyz, fs=5e6).plan(4),
                    tables=False)
    errs.append(_compare_case("fs=5MHz 4 blocks", *_inputs([dp5])))

    dp10 = pack_plan(Scheduler(rin, g0, ieph, xyz, fs=10e6).plan(4),
                     tables=False)
    dp10s = split_plan(dp10, sc.MAX_BLOCK_SAMPLES)
    assert dp10s.n_blocks == 8 and dp10s.block_samples == 500_000
    errs.append(_compare_case("fs=10MHz split 2", *_inputs([dp10s])))

    # a gain on a trunc boundary (405*g straddles an integer in f32),
    # kept as patch words by nudge=False: exercises the patch pass
    import numpy as np
    gain = np.full((1, 12), 0.5)
    gain[0, 1] = 0.9086419713826426
    dpp = pack_plan(_synthetic_plan(1, TIMED_SAMPLES, 2.6e6, seed=7,
                                    gain=gain), tables=False)
    inp = _inputs([dpp], nudge=False)
    words = [inp[0].prmf[0, sc.patch_word_lane(k)]
             for k in range(sc._N_PATCH)]
    assert sum(w != 0 for w in words) == 2, words
    errs.append(_compare_case("patch words (nudge=False)", *inp))

    errs.append(_compare_case("packed=False", *in26, packed=False))
    return max(errs)


def _dev_max_abs_err(a, b) -> int:
    """_max_abs_err for packed outputs that lie on the card."""
    import torch

    def iq(w):
        return torch.stack([(w << 16) >> 16, w >> 16]).to(torch.int64)
    return int((iq(a) - iq(b)).abs().max()) if a.numel() else 0


def phase_groups(scen) -> int:
    """Kernel vs twin, both on the card, word for word at every dispatch
    group the main path of phase 3 launches (-d 300, K=8: groups of 1,
    2, 4 and 3 superframes, so up to 1,200 rows and sf_map 0..k-1)."""
    import torch

    from pluto_gps_sim_tpu_torch.ops import synth_cuda as sc
    from pluto_gps_sim_tpu_torch.ops.synth_torch import pack_plan
    from pluto_gps_sim_tpu_torch.runtime.scheduler import Scheduler
    from pluto_gps_sim_tpu_torch.runtime.stream import IqStream
    rin, g0, ieph, xyz = scen
    t0 = time.perf_counter()
    sched = Scheduler(rin, g0, ieph, xyz, fs=2.6e6)
    ramp = IqStream.dispatch_ramp(8)
    rem, sizes, err = 3000, [], 0
    while rem > 0:
        plans = sched.plan_group(next(ramp), 300, total_blocks=rem)
        rem -= sum(p.n_blocks for p in plans)
        bp, ca, sf_map, n = _inputs([pack_plan(p, tables=False)
                                     for p in plans])
        assert bp.patch_dropped == 0
        args = _to("cuda", bp, ca, sf_map)
        kern = sc.synth_blocks(*args, n)
        plain = sc.synth_blocks_plain(*args, n)
        torch.cuda.synchronize()
        bad = int((kern != plain).sum())
        err = max(err, _dev_max_abs_err(kern, plain))
        if bad:
            raise AssertionError(
                f"group of {len(plans)} superframes: kernel differs from "
                f"the twin on the card in {bad} words (max abs err {err})")
        sizes.append(f"{len(plans)}x{plans[0].n_blocks}")
        del kern, plain, args
    assert sizes == ["1x300", "2x300", "4x300", "3x300"], sizes
    _phase("compare main-path groups on the card", t0,
           f"groups {' '.join(sizes)} samples={n} words equal, "
           f"max_abs_err={err}")
    return err


def phase_timing() -> tuple[float, float]:
    import torch

    from pluto_gps_sim_tpu_torch.ops import synth_cuda as sc
    from pluto_gps_sim_tpu_torch.ops.synth_torch import pack_plan
    t0 = time.perf_counter()
    dp = pack_plan(_synthetic_plan(TIMED_BLOCKS, TIMED_SAMPLES, 2.6e6,
                                   seed=3), tables=False)
    bp, ca, sf_map, n = _inputs([dp])
    assert bp.patch_dropped == 0
    args = _to("cuda", bp, ca, sf_map)
    kern = sc.synth_blocks(*args, n)
    plain = sc.synth_blocks_plain(*args, n)
    torch.cuda.synchronize()
    bad = int((kern != plain).sum())
    if bad:
        raise AssertionError(f"timing shape: kernel differs from the twin "
                             f"on the card in {bad} words")
    del kern, plain
    ms = _time_ms(lambda: sc.synth_blocks(*args, n), reps=20)
    plain_ms = _time_ms(lambda: sc.synth_blocks_plain(*args, n), reps=3)
    gsps = TIMED_BLOCKS * TIMED_SAMPLES / (ms * 1e-3) / 1e9
    _phase("time 300x260000x12ch", t0,
           f"kernel {ms:.4f} ms ({gsps:.2f} Gsample/s), "
           f"plain twin on the card {plain_ms:.3f} ms, words equal")
    return ms, plain_ms


def _cli(argv: list[str]) -> tuple[int, str]:
    """Run the port's CLI in-process; returns (rc, its stderr)."""
    from pluto_gps_sim_tpu_torch import cli

    class _Tee(io.TextIOBase):
        def __init__(self):
            self.buf = io.StringIO()

        def write(self, s):
            sys.__stderr__.write(s)
            return self.buf.write(s)

    tee = _Tee()
    with contextlib.redirect_stderr(tee):
        rc = cli.main(argv)
    return rc, tee.buf.getvalue()


def phase_main_path() -> tuple[int, float]:
    from pluto_gps_sim_tpu_torch.ops import synth_cuda as sc
    t0 = time.perf_counter()
    sc.reset_launch_count()
    rc, err = _cli(["-e", str(RINEX), "-l", LLH, "-s", "2600000",
                    "-d", "300", "--dispatch-superframes", "8",
                    "--sink", "null", "--stats", "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = sc.launch_count()
    assert rc == 0, f"CLI exited {rc}"
    line = next(ln for ln in err.splitlines() if ln.startswith("sink stats"))
    stats = json.loads(line.split("sink stats: ", 1)[1])
    assert launches > 0, "the main path never launched the kernel"
    assert stats["patch_dropped"] == 0, stats
    assert stats["blocks"] == 3000, stats
    assert stats["samples"] == 3000 * TIMED_SAMPLES, stats
    rtf = 300.0 / wall
    _phase("main path -d 300 K=8 null sink", t0,
           f"launches={launches} blocks={stats['blocks']} "
           f"patch_dropped={stats['patch_dropped']} "
           f"crc32={stats['crc32']} real-time factor {rtf:.1f}x")
    return launches, rtf


def phase_file(scen) -> None:
    import numpy as np

    from pluto_gps_sim_tpu_torch.runtime.stream import IqStream
    rin, g0, ieph, xyz = scen
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "out60.bin")
        rc, _ = _cli(["-e", str(RINEX), "-l", LLH, "-s", "2600000",
                      "-d", "60", "--dispatch-superframes", "8",
                      "-o", path, "--device", "cuda"])
        assert rc == 0, f"CLI exited {rc}"
        iq = np.memmap(path, dtype=np.int16, mode="r").reshape(
            600, TIMED_SAMPLES, 2)
        for first in (0, 300):
            s = IqStream(rin, g0, ieph, xyz, fs=2.6e6, device="cpu")
            s.fast_forward(first)
            want = s.generate(2)
            got = np.asarray(iq[first:first + 2])
            if not np.array_equal(got, want):
                raise AssertionError(
                    f"file blocks {first}-{first + 1} differ from the twin "
                    f"in {int((got != want).sum())} components")
            assert np.any(want), "all-zero IQ"
        del iq
    _phase("file -d 60 spot check", t0,
           "blocks 0-1 and 300-301 equal the twin's")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "pluto_gps_sim_tpu_torch").is_dir() or not RINEX.is_file():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    t_all = time.perf_counter()

    card = _card_line()
    print(f"[card] {card}", flush=True)
    phase_build()
    scen = _scenario()
    max_err = max(phase_compare(scen), phase_groups(scen))
    ms, plain_ms = phase_timing()
    launches, rtf = phase_main_path()
    phase_file(scen)
    assert "jax" not in sys.modules, "the port imported jax"

    kernels = {"kernels": [{
        "name": "synth_blocks", "route": "cuda",
        "source": "pluto_gps_sim_tpu_torch/ops/csrc/synth_blocks.cu",
        "replaces": "pluto_gps_sim_tpu/ops/synth_pallas.py:194",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}
    (OUT_DIR / "result.json").write_text(json.dumps(
        {**kernels, "card": card, "realtime_factor": rtf,
         "wall_s": time.perf_counter() - t_all}, indent=1))
    _phase("all", t_all)
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
