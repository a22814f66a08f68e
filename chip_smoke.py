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
  5. golden: the f64 precise path on the card equals its CPU run word
     for word (4 blocks); the kernel equals precise on the card with
     array_equal at 4 blocks and within the short gate (>= 1-2e-6
     exact, max err <= 8) on a 300-block superframe; the tiled path on
     the card equals its CPU run (4 blocks) and tracks precise (>= 0.999
     exact, SNR >= 70 dB) over the 300 blocks; both paths timed;
  6. Monte-Carlo, held: B=4 receivers a few metres apart, 8 blocks from
     0.4 s before a 30 s boundary; each receiver's rows equal a solo
     IqStream(mode="kernel") on the card word for word;
  7. Monte-Carlo, full width: B=256 receivers within +-2 km of Tokyo x
     300 blocks at 2.6 MHz (76,800 rows), chunks of 3,000 rows consumed
     on the card by an int64 sum; the first chunk equals the twin run on
     the card; 0 patch words dropped;
  8. receiver: the CLI writes 40 s on the card with --selfcheck, and the
     software receiver's fix from that file lands within 8 m with every
     planned PRN and a static velocity under 0.15 m/s;
  9. io: -d 3 --realtime to a file is paced by the native ring writer
     (>= 2.7 s) and writes the bytes of an unpaced run; --profile writes
     a Chrome trace that holds the kernel;
 10. a JSON line per the kernels, the card line, and the result line.

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
FS = 2_600_000.0
MC_B, MC_CHUNK = 256, 3000  # the full-width Monte-Carlo batch


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


def _precise_iq(dp, device):
    from pluto_gps_sim_tpu_torch.ops.synth_torch import (
        synth_superframe_precise_async)
    return synth_superframe_precise_async(dp, device)


def _kernel_iq(dp):
    """The kernel's int16 IQ [M, N, 2] for one DevicePlan, on the card."""
    import torch

    from pluto_gps_sim_tpu_torch.ops import synth_cuda as sc
    bp, ca, sf_map, n = _inputs([dp])
    assert bp.patch_dropped == 0
    packed = sc.synth_blocks(*_to("cuda", bp, ca, sf_map), n)
    return torch.stack([(packed << 16) >> 16, packed >> 16],
                       dim=-1).to(torch.int16)


def _exact_err(a, b) -> tuple[float, int]:
    """Exact fraction and max |difference| of two int16 IQ tensors."""
    import torch
    d = (a.to(torch.int32) - b.to(torch.int32)).abs()
    return float((d == 0).double().mean()), int(d.max())


def _snr_db(ref, got) -> float:
    import torch
    ref = ref.to(torch.float64)
    err = ref - got.to(torch.float64)
    return float(10 * torch.log10((ref ** 2).mean()
                                  / (err ** 2).mean().clamp_min(1e-30)))


def phase_golden(scen) -> dict:
    """The f64 precise path as the golden reference on the card."""
    import numpy as np
    import torch

    from pluto_gps_sim_tpu_torch.ops.synth_torch import (
        pack_plan, synth_superframe_tiled_async)
    from pluto_gps_sim_tpu_torch.runtime.scheduler import Scheduler
    from pluto_gps_sim_tpu_torch.runtime.stream import IqStream
    rin, g0, ieph, xyz = scen
    t0 = time.perf_counter()
    dp4 = pack_plan(Scheduler(rin, g0, ieph, xyz, fs=FS).plan(4))
    p4 = _precise_iq(dp4, "cuda")
    p4_cpu = _precise_iq(dp4, "cpu")
    if not np.array_equal(p4.cpu().numpy(), p4_cpu.numpy()):
        raise AssertionError("precise on the card differs from precise on "
                             "the CPU (4 blocks)")
    k4 = _kernel_iq(dp4)
    ex4, err4 = _exact_err(k4, p4)
    if not torch.equal(k4, p4):
        raise AssertionError(f"kernel vs precise, 4 blocks: exact {ex4:.6%}"
                             f", max err {err4} (array_equal required)")
    t4 = synth_superframe_tiled_async(dp4, "cuda")
    if not np.array_equal(t4.cpu().numpy(),
                          synth_superframe_tiled_async(dp4, "cpu").numpy()):
        raise AssertionError("tiled on the card differs from tiled on the "
                             "CPU (4 blocks)")
    for mode in ("tiled", "precise"):     # the stream's planner path
        got = IqStream(rin, g0, ieph, xyz, fs=FS, mode=mode,
                       device="cuda").generate(4)
        if not np.array_equal(got, p4_cpu.numpy()):
            raise AssertionError(f"IqStream(mode={mode!r}) on the card "
                                 "differs from precise (4 blocks)")
    _phase("golden 4 blocks", t0, "precise cuda == cpu, kernel == precise, "
           "tiled cuda == cpu, stream tiled/precise == precise (word for "
           "word)")

    t0 = time.perf_counter()
    dp = pack_plan(Scheduler(rin, g0, ieph, xyz, fs=FS).plan(TIMED_BLOCKS))
    prec = _precise_iq(dp, "cuda")
    kern = _kernel_iq(dp)
    tiled = synth_superframe_tiled_async(dp, "cuda")
    ex_k, err_k = _exact_err(kern, prec)
    ex_t, _ = _exact_err(tiled, prec)
    snr_t = _snr_db(prec, tiled)
    if ex_k < 1 - 2e-6 or err_k > 8:
        raise AssertionError(f"kernel vs precise, {TIMED_BLOCKS} blocks: "
                             f"exact {ex_k:.8%}, max err {err_k}")
    if ex_t < 0.999 or snr_t < 70.0:
        raise AssertionError(f"tiled vs precise: exact {ex_t:.6%}, "
                             f"SNR {snr_t:.1f} dB")
    del prec, kern, tiled
    precise_ms = _time_ms(lambda: _precise_iq(dp, "cuda"), reps=3)
    tiled_ms = _time_ms(lambda: synth_superframe_tiled_async(dp, "cuda"),
                        reps=3)
    _phase(f"golden {TIMED_BLOCKS} blocks", t0,
           f"kernel vs precise exact {ex_k:.8%} max err {err_k}; tiled vs "
           f"precise exact {ex_t:.6%} SNR {snr_t:.1f} dB; precise "
           f"{precise_ms:.1f} ms, tiled {tiled_ms:.1f} ms per superframe")
    return {"kernel_vs_precise_exact": ex_k, "kernel_vs_precise_max_err":
            err_k, "tiled_vs_precise_exact": ex_t, "tiled_snr_db": snr_t,
            "precise_ms": precise_ms, "tiled_ms": tiled_ms}


def _scattered_receivers(b: int):
    """B receivers a few metres apart around Tokyo (the JAX package's
    Monte-Carlo tests' seed and spread)."""
    import numpy as np

    from pluto_gps_sim_tpu_torch.constants import R2D
    from pluto_gps_sim_tpu_torch.models.geodesy import llh2xyz
    rng = np.random.RandomState(5)
    base = np.array([35.681298 / R2D, 139.766247 / R2D, 10.0])
    return np.stack([np.asarray(llh2xyz(base + np.array(
        [rng.uniform(-1e-4, 1e-4), rng.uniform(-1e-4, 1e-4),
         rng.uniform(0, 100)]))) for _ in range(b)])


def phase_mc_held(scen) -> None:
    """Batch rows == solo kernel streams, across a 30 s boundary."""
    import numpy as np

    from pluto_gps_sim_tpu_torch.models.gpstime import inc_gps_time
    from pluto_gps_sim_tpu_torch.parallel import MonteCarloBatch
    from pluto_gps_sim_tpu_torch.runtime.stream import IqStream
    rin, g0, ieph, _ = scen
    t0 = time.perf_counter()
    rem = (30.0 - (g0.sec % 30.0)) % 30.0
    g0b = inc_gps_time(g0, rem + 30.0 - 0.4)
    xyz = _scattered_receivers(4)
    mc = MonteCarloBatch(rin, g0b, ieph, xyz, fs=FS)
    batch = mc.generate(8, "cuda")
    assert mc.nav_cache.hits > 0 and mc.patch_dropped == 0
    for b in range(xyz.shape[0]):
        solo = IqStream(rin, g0b, ieph, xyz[b], fs=FS, mode="kernel",
                        device="cuda").generate(8)
        if not np.array_equal(batch[b], solo):
            raise AssertionError(
                f"receiver {b}: batch rows differ from the solo stream in "
                f"{int((batch[b] != solo).sum())} components")
    _phase("montecarlo held B=4 x 8 blocks", t0,
           "every receiver == its solo kernel stream across the boundary")


def phase_mc_full(scen) -> tuple[int, int, dict]:
    """B=256 x 300 blocks through the kernel, consumed on the card."""
    import numpy as np
    import torch

    from pluto_gps_sim_tpu_torch.ops import synth_cuda as sc
    from pluto_gps_sim_tpu_torch.parallel import MonteCarloBatch
    rin, g0, ieph, xyz0 = scen
    xyz = xyz0[None, :] + np.random.RandomState(0).uniform(
        -2000.0, 2000.0, (MC_B, 3))
    t0 = time.perf_counter()
    mc = MonteCarloBatch(rin, g0, ieph, xyz, fs=FS)
    init_s = time.perf_counter() - t0
    planned = {}
    plan_blocks = mc.plan_blocks

    def keep_plan(n):
        planned["args"] = plan_blocks(n)
        return planned["args"]
    mc.plan_blocks = keep_plan

    torch.cuda.synchronize()
    sc.reset_launch_count()
    t1 = time.perf_counter()
    rows, total, first, pending = 0, 0, None, None
    for off, dev in mc.superframes(TIMED_BLOCKS, "cuda",
                                   chunk_blocks=MC_CHUNK, as_device=True):
        if first is None:
            first = dev
        s = dev.sum(dtype=torch.int64)
        if pending is not None:
            total += int(pending)      # lag-1: chunk k-1's sum
        pending = s
        rows += dev.shape[0]
    total += int(pending)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t1
    launches = sc.launch_count()
    n_rows = MC_B * TIMED_BLOCKS
    assert rows == n_rows, (rows, n_rows)
    assert launches > 0, "the Monte-Carlo path never launched the kernel"
    assert mc.patch_dropped == 0, mc.patch_dropped
    assert total != 0, "all-zero Monte-Carlo output"

    prmi, prmf, ca2, sf_map = planned["args"]
    args = [torch.from_numpy(a[:MC_CHUNK] if a is not ca2 else a).to("cuda")
            for a in (prmi, prmf, ca2, sf_map)]
    twin = sc.synth_blocks_plain(*args, mc.block_samples)
    bad = int((twin != first).sum())
    err = _dev_max_abs_err(first, twin)
    if bad:
        raise AssertionError(f"Monte-Carlo chunk 0 differs from the twin "
                             f"on the card in {bad} words (max err {err})")
    dev_s = loop_s - mc.control_seconds
    gsps = n_rows * TIMED_SAMPLES / loop_s / 1e9
    _phase(f"montecarlo B={MC_B} x {TIMED_BLOCKS} blocks", t0,
           f"rows={rows} launches={launches} tables={ca2.shape[0]} "
           f"patch_dropped={mc.patch_dropped} chunk0 == twin; init "
           f"{init_s:.3f} s, control {mc.control_seconds:.3f} s, device+"
           f"consume {dev_s:.3f} s, aggregate {gsps:.2f} Gsample/s")
    return launches, err, {"init_s": init_s,
                           "control_s": mc.control_seconds,
                           "device_consume_s": dev_s,
                           "aggregate_gsps": gsps}


def phase_receiver(scen) -> dict:
    """A 40 s file written on the card, fixed by the software receiver."""
    import numpy as np

    from pluto_gps_sim_tpu_torch.runtime.scheduler import Scheduler
    from pluto_gps_sim_tpu_torch.utils.receiver import receive_and_fix
    rin, g0, ieph, xyz = scen
    t0 = time.perf_counter()
    plan = Scheduler(rin, g0, ieph, xyz, fs=FS).plan(1)
    planned = sorted(int(p) for p, act in zip(plan.prn, plan.active[0])
                     if p > 0 and act)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "out40.bin")
        rc, err = _cli(["-e", str(RINEX), "-l", LLH, "-s", "2600000",
                        "-d", "40", "-o", path, "--device", "cuda",
                        "--selfcheck"])
        assert rc == 0, f"CLI exited {rc}"
        assert "selfcheck: PASS" in err, "selfcheck did not pass"
        t1 = time.perf_counter()
        sol, _ = receive_and_fix(np.fromfile(path, dtype=np.int16), FS,
                                 ref_week=g0.week,
                                 measure_sample=int(round(FS)))
        rx_s = time.perf_counter() - t1
    fix_err = float(np.linalg.norm(sol.xyz - xyz))
    speed = float(np.linalg.norm(sol.velocity.vel))
    if sorted(sol.prns) != planned:
        raise AssertionError(f"fix used PRNs {sorted(sol.prns)}, planned "
                             f"{planned}")
    if fix_err >= 8.0 or speed >= 0.15:
        raise AssertionError(f"fix error {fix_err:.2f} m, |v| "
                             f"{speed:.3f} m/s")
    _phase("receiver 40 s", t0,
           f"selfcheck PASS; fix error {fix_err:.2f} m with PRNs "
           f"{sol.prns}, |v| {speed:.4f} m/s, receiver {rx_s:.1f} s")
    return {"fix_err_m": fix_err, "speed_m_s": speed, "receiver_s": rx_s}


def phase_io() -> float:
    """--realtime paces through the native ring writer, same bytes;
    --profile traces the kernel on the card."""
    t0 = time.perf_counter()
    base = ["-e", str(RINEX), "-l", LLH, "-s", "2600000", "-d", "3",
            "--device", "cuda"]
    with tempfile.TemporaryDirectory() as tmp:
        paced, plain = (os.path.join(tmp, f) for f in ("rt.bin", "no.bin"))
        t1 = time.perf_counter()
        rc, err = _cli(base + ["-o", paced, "--realtime"])
        wall = time.perf_counter() - t1
        assert rc == 0, f"CLI exited {rc}"
        assert "WARNING" not in err, "the native ring writer was not used"
        assert wall >= 2.7, f"3 s of signal written in {wall:.2f} s"
        prof = os.path.join(tmp, "prof")
        rc, _ = _cli(base + ["-o", plain, "--profile", prof])
        assert rc == 0, f"CLI exited {rc}"
        same = Path(paced).read_bytes() == Path(plain).read_bytes()
        if not same:
            raise AssertionError("the paced file differs from the unpaced")
        events = json.loads(Path(prof, "trace.json").read_text())
        kernels = [e for e in events["traceEvents"]
                   if e.get("cat") == "kernel"
                   and "synth_blocks" in e.get("name", "")]
        assert kernels, "the profiler trace holds no synth_blocks kernel"
    _phase("io -d 3 --realtime, --profile", t0,
           f"paced wall {wall:.3f} s, bytes equal the unpaced run's; "
           f"trace holds {len(kernels)} synth_blocks kernel(s)")
    return wall


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
    golden = phase_golden(scen)
    phase_mc_held(scen)
    mc_launches, mc_err, mc = phase_mc_full(scen)
    receiver = phase_receiver(scen)
    realtime_wall = phase_io()
    assert "jax" not in sys.modules, "the port imported jax"

    kernels = {"kernels": [{
        "name": "synth_blocks", "route": "cuda",
        "source": "pluto_gps_sim_tpu_torch/ops/csrc/synth_blocks.cu",
        "replaces": "pluto_gps_sim_tpu/ops/synth_pallas.py:194",
        "paths": ["stream", "montecarlo"],
        "path_launches": {"stream": launches, "montecarlo": mc_launches},
        "launches": launches + mc_launches,
        "max_abs_err": max(max_err, mc_err),
        "ms": ms, "plain_ms": plain_ms}]}
    (OUT_DIR / "result.json").write_text(json.dumps(
        {**kernels, "card": card, "realtime_factor": rtf,
         "golden": golden, "montecarlo": mc, "receiver": receiver,
         "realtime_wall_s": realtime_wall,
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
