#!/usr/bin/env python3
"""On-card smoke test of pluto_gps_sim_tpu_torch on one CUDA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints one line with its wall time; any failure raises and
exits non-zero):
  1. the card's name and power limit; build the CUDA synthesis kernel
     from ops/csrc/ with nvcc (sm_90a) and time the build; dump its SASS
     (cuobjdump) and print the K1 channel loop's instruction counts;
  2. the kernel against its plain PyTorch twin (synth_blocks_plain, on
     the CPU), word for word: the fixture scenario at 2.6 MHz, 1 MHz
     (the most chips per sample), 5 MHz (n reaches 499,999), a 10 MHz
     plan split into 2 sub-blocks, a patch-carrying nudge=False plan,
     and the packed=False epilogue; then kernel and twin both on the
     card at every dispatch group of phase 3's main path (1, 2, 4 and 3
     superframes, multi-superframe sf_map), word for word; then both
     timed on the card at 300 blocks x 260,000 samples x 12 channels
     (CUDA events), with their words compared again, beside the least
     time the card could take for that work (kernel_bound) and the SM
     clock under load;
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
  8. mesh: 4 gloo ranks (one process each) on this card run the
     parallel/{mesh,shard} path (mesh_rank): a 12-channel nudge=False
     plan with patch words in two channel shards, 8 x 260,000, over 1x4
     and 2x2 meshes; IqStream(mode="kernel", mesh=2x2) over one 30 s
     superframe (300 blocks, 2.6 MHz, CRC32 printed); a 10 MHz plan
     split into sub-blocks (2 blocks); MonteCarloBatch B=4 x 30 blocks —
     each equal word for word to the single-device kernel run on the
     card — and the packed=False kernel equals its twin at each rank's
     shard; then the port's run_multiprocess_dryrun and
     dryrun_multichip (4 gloo ranks on the card).  Only with >= 4
     cards: the same over nccl (one rank per card), and make_mesh must
     refuse two nccl ranks on one card;
  9. receiver: the CLI writes 40 s on the card with --selfcheck, and the
     software receiver's fix from that file lands within 8 m with every
     planned PRN and a static velocity under 0.15 m/s;
 10. io: -d 3 --realtime to a file is paced by the native ring writer
     (>= 2.7 s) and writes the bytes of an unpaced run; --profile writes
     a Chrome trace that holds the kernel;
 11. a JSON line per the kernels, the card line, and the result line.

Uses only this package (never jax) and the tracked RINEX fixture
tests/data/brdc_test.23n.  Extra logs go to chiprun_out/chip_smoke/.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RINEX = ROOT / "tests" / "data" / "brdc_test.23n"
LLH = "35.681298,139.766247,10.0"
OUT_DIR = ROOT / "chiprun_out" / "chip_smoke"
KERNEL_SRC = (ROOT / "pluto_gps_sim_tpu_torch" / "ops" / "csrc"
              / "synth_blocks.cu")
TIMED_BLOCKS = 300          # one 30 s superframe at 2.6 MHz
TIMED_SAMPLES = 260_000
FS = 2_600_000.0
MC_B, MC_CHUNK = 256, 3000  # the full-width Monte-Carlo batch

# The least time the card could take for the kernel's work (kernel_bound):
# the larger of the operations the function needs over the SMs' 32-bit
# issue rate and the bytes over the memory rate.  Each term counts the
# least Hopper instruction sequence that computes it, where a multiply-add,
# a shift-and-add (LEA.HI) and a three-input logic op (LOP3) are one each;
# address arithmetic is not counted.  Per (active channel or patch word,
# sample): the carrier index 6 (two ramp multiply-adds, the f32 residual
# product and its truncation, an add, a shift-and-add), the chip 9 (three
# ramp multiply-adds, the f32 product and its truncation, an add, two
# shift-and-adds, a shift), the key, lookup and add 3 (phase >> 23 added
# to the sign bit in one shift-and-add, a shared load, an add); and the
# spreading sign, the cheaper of 7 per sample (chip // 1023 and its
# remainder 2, the nav bit 3, the C/A bit's load 1, their XOR at bit 9 1)
# and 1 per sample (a load from a window of the chips' signs) plus those
# 7 and the window's store per chip the channel reaches.  Per sample 4 (n
# to f32, un-bias I and Q, pack).  Chips per sample come from the inputs
# (vq / 2^12).  The per-row tables (~0.1 % more) are left out.  Over 128
# 32-bit lanes per clock and SM, the most any SM issues (the H100 SXM's
# published float32 rate, 67 TFLOP/s, is the same lanes counting a
# multiply-add twice), at the card's maximum SM clock; bytes over the H100
# SXM's 3.35 TB/s, each input read once and each output written once.
OPS_PER_CHANNEL_SAMPLE = 6 + 9 + 3
OPS_SIGN_PER_SAMPLE = 7
OPS_SIGN_WINDOW = (1, OPS_SIGN_PER_SAMPLE + 1)   # per sample, per chip
OPS_PER_SAMPLE = 4
LANES_PER_CLK_SM = 128
HBM_BYTES_PER_S = 3.35e12


def _phase(name: str, t0: float, msg: str = "") -> None:
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s {msg}".rstrip(),
          flush=True)


def _smi(query: str) -> str:
    """nvidia-smi's --query-gpu line for card 0."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()
    return out[0]


def _card_line() -> str:
    return _smi("name,power.limit")


def _mhz(v: str) -> float:
    return float(v.split()[0])


# ---------------------------------------------------------------------------
# the kernel's SASS: instruction counts of its K1 channel loop
# ---------------------------------------------------------------------------

_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_]*)(?:\.[A-Z0-9_]+)*\s*([^;]*);")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_SASS_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b")


def sass_listing(lib_path: str, out: Path) -> str:
    """cuobjdump -sass of a built library, also written to `out`."""
    from pluto_gps_sim_tpu_torch.ops.cuda_build import find_nvcc
    cuobjdump = str(Path(find_nvcc()).with_name("cuobjdump"))
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    out.write_text(text)
    return text


def sass_loops(text: str, kernel: str = "synth_blocks_kernel") -> list[dict]:
    """The kernel's innermost loops (a backward branch and its target,
    with no other loop inside), each with its opcode counts."""
    insns, labels, pending, inside = [], {}, [], False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        if not inside:
            continue
        m = _SASS_LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _SASS_INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            labels.update((lab, addr) for lab in pending)
            pending = []
            insns.append((addr, m.group(2), m.group(3)))
    spans = []
    for addr, op, args in insns:
        m = _SASS_TARGET.search(args) if op == "BRA" else None
        if m:
            tgt = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
            if tgt is not None and tgt <= addr:
                spans.append((tgt, addr))
    inner = [s for s in spans if not any(
        o != s and s[0] <= o[0] and o[1] <= s[1] for o in spans)]
    return [{"start": hex(lo), "end": hex(hi),
             "ops": dict(collections.Counter(
                 op for a, op, _ in insns if lo <= a <= hi))}
            for lo, hi in sorted(set(inner))]


def k1_loop_counts(text: str, samples_per_thread: int) -> dict:
    """Counts of the K1 channel loop: the first innermost loop that reads
    shared memory and neither reads device memory nor writes shared
    memory (one channel x samples_per_thread samples per iteration)."""
    loop = next((lp for lp in sass_loops(text)
                 if lp["ops"].get("LDS") and not lp["ops"].get("LDG")
                 and not lp["ops"].get("STS")), None)
    if loop is None:
        raise ValueError("no loop of the kernel's SASS looks like K1")
    ops = loop["ops"]
    total = sum(ops.values())
    i2f = sum(v for k, v in ops.items() if k.startswith("I2F"))
    f2i = sum(v for k, v in ops.items() if k.startswith("F2I"))
    per = float(samples_per_thread)
    return {"loop": f"{loop['start']}-{loop['end']}",
            "per_iteration": {"all": total, "I2F": i2f, "F2I": f2i,
                              "LDS": ops.get("LDS", 0)},
            "per_channel_sample": {"all": total / per,
                                   "conversions": (i2f + f2i) / per,
                                   "LDS": ops.get("LDS", 0) / per}}


def samples_per_thread(src: Path) -> int:
    return int(re.search(r"kSamplesPerThread = (\d+)",
                         src.read_text()).group(1))


def kernel_bound(prmi, prmf, ca, sf_map, n: int, packed: bool,
                 n_sm: int, clock_hz: float) -> dict:
    """The least time the card could take for synth_blocks on these
    inputs: the larger of the operations they need over the SMs' 32-bit
    issue rate and the bytes over the memory rate (see the constants)."""
    import numpy as np

    from pluto_gps_sim_tpu_torch.ops import synth_cuda as sc
    vq_slot = sc._LANES + sc._SLOT_I[sc._P_VQ]
    chans = prmf[:, sc._F_GAIN:sc._F_GAIN + sc._C] != 0
    words = prmf[:, [sc.patch_word_lane(k) for k in range(sc._N_PATCH)]] != 0
    vq = np.concatenate([
        prmi[:, sc._P_VQ:sc._P_VQ + sc._C][chans],
        prmi[:, [vq_slot + sc._SLOT_I_W * k
                 for k in range(sc._N_PATCH)]][words]])
    chips_per_sample = vq.astype(np.uint32) / 4096.0
    sign = np.minimum(OPS_SIGN_PER_SAMPLE,
                      OPS_SIGN_WINDOW[0] + OPS_SIGN_WINDOW[1] * chips_per_sample)
    ops = float((OPS_PER_CHANNEL_SAMPLE * vq.size + sign.sum()
                 + OPS_PER_SAMPLE * prmi.shape[0]) * n)
    nbytes = (prmi.shape[0] * n * (4 if packed else 8) + prmi.nbytes
              + prmf.nbytes + ca.nbytes + sf_map.nbytes + sc._PAIRTAB.nbytes)
    ops_ms = ops / (LANES_PER_CLK_SM * n_sm * clock_hz) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"ops": ops, "ops_per_channel_sample": ops / (max(vq.size, 1) * n),
            "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


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


def phase_build() -> dict:
    from pluto_gps_sim_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    lib = cuda_build.load_kernel("synth_blocks")
    log = cuda_build.build_logs.get("synth_blocks", "(loaded from cache)")
    (OUT_DIR / "nvcc_synth_blocks.log").write_text(log)
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    _phase("build synth_blocks.cu", t0, "; ".join(regs))
    sass = sass_listing(lib._name, OUT_DIR / "synth_blocks.sass")
    (OUT_DIR / "sass_loops.json").write_text(
        json.dumps(sass_loops(sass), indent=1))
    k1 = k1_loop_counts(sass, samples_per_thread(KERNEL_SRC))
    print(f"[sass] K1 loop {k1['loop']}: per iteration "
          f"{json.dumps(k1['per_iteration'])}, per channel-sample "
          f"{json.dumps(k1['per_channel_sample'])}", flush=True)
    return k1


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

    dp1 = pack_plan(Scheduler(rin, g0, ieph, xyz, fs=1e6).plan(4),
                    tables=False)
    errs.append(_compare_case("fs=1MHz 4 blocks", *_inputs([dp1])))

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


def phase_timing() -> dict:
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
    for _ in range(300):            # the SM clock under load
        sc.synth_blocks(*args, n)
    clock = _smi("clocks.sm")
    torch.cuda.synchronize()
    max_clock = _mhz(_smi("clocks.max.sm"))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    bound = kernel_bound(bp.prmi, bp.prmf, ca, sf_map, n, True, n_sm,
                         max_clock * 1e6)
    gsps = TIMED_BLOCKS * TIMED_SAMPLES / (ms * 1e-3) / 1e9
    share = bound["bound_ms"] / ms
    _phase("time 300x260000x12ch", t0,
           f"kernel {ms:.4f} ms ({gsps:.2f} Gsample/s), "
           f"plain twin on the card {plain_ms:.3f} ms, words equal")
    print(f"[bound] bytes {bound['bytes']} -> {bound['bytes_ms']:.4f} ms; "
          f"operations {bound['ops']:.6g} "
          f"({bound['ops_per_channel_sample']:.3f} per channel-sample) on "
          f"{n_sm} SMs at {max_clock:.0f} MHz -> {bound['ops_ms']:.4f} ms; "
          f"bound {bound['bound_ms']:.4f} ms by {bound['bound_by']}, kernel "
          f"at {share:.1%} of it; clocks.sm under load {clock}", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "sm_clock_under_load": clock,
            "max_sm_clock_mhz": max_clock, "bound_share": share, **bound}


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


MESH_RANKS = 4
MESH_SYN_BLOCKS = 8          # the patch-carrying synthetic plan
MESH_MC_B, MESH_MC_BLOCKS = 4, 30
BOUNDARY_GAIN = 0.9086419713826426   # 405*g straddles an integer in f32


def mesh_rank(rank: int, world: int, out_dir: str, device: str,
              n_blocks: str) -> None:
    """One rank of the mesh phase, in a process spawned by
    parallel.multiproc_dryrun.spawn_world (the process group is up).

    Over 1x4 and 2x2 meshes on `device` (rank_device names it): a
    12-channel nudge=False plan carrying patch words in two channel
    shards; IqStream(mode="kernel", mesh=2x2) over n_blocks at 2.6 MHz;
    a 10 MHz plan split into sub-blocks (2 blocks); a Monte-Carlo batch.
    Each equals the single-device run on the same device word for word;
    the kernel's packed=False output at this rank's shard of the stream
    equals its plain twin.  Launches of the sharded runs are counted
    apart from the references'.  Writes rank<r>.json into out_dir."""
    import zlib

    import numpy as np
    import torch

    from pluto_gps_sim_tpu_torch.ops import synth_cuda as sc
    from pluto_gps_sim_tpu_torch.ops.synth_torch import pack_plan
    from pluto_gps_sim_tpu_torch.parallel import MonteCarloBatch, make_mesh
    from pluto_gps_sim_tpu_torch.parallel.multiproc_dryrun import (
        rank_device, single_device)
    from pluto_gps_sim_tpu_torch.parallel.shard import (
        launch_on_mesh, local_inputs, pad_time_shards, shard_channel_params)
    from pluto_gps_sim_tpu_torch.runtime.scheduler import Scheduler
    from pluto_gps_sim_tpu_torch.runtime.stream import IqStream

    n_blocks = int(n_blocks)
    dev = rank_device(device, rank)
    rin, g0, ieph, xyz = _scenario()
    meshes = {"1x4": make_mesh(1, 4, device=dev),
              "2x2": make_mesh(2, 2, device=dev)}
    mesh = meshes["2x2"]
    res: dict = {"rank": rank, "coord": list(mesh.coord),
                 "device": str(mesh.device), "backend": mesh.backend}
    launches = 0

    def sharded(fn):
        """fn's result, its kernel launches counted as the mesh path's."""
        nonlocal launches
        sc.reset_launch_count()
        out = fn()
        launches += sc.launch_count()
        return out

    def same(name, got, want):
        got, want = np.asarray(got), np.asarray(want)
        if got.shape != want.shape or not np.array_equal(got, want):
            bad = int((got != want).sum()) if got.shape == want.shape \
                else "shape"
            raise AssertionError(f"rank {rank} {name}: sharded differs from "
                                 f"the single-device run ({bad})")

    # a. the patch-carrying 12-channel plan over 1x4 and 2x2
    gain = np.full((MESH_SYN_BLOCKS, 12), 0.5)
    gain[:, [1, 7]] = BOUNDARY_GAIN
    dp = pack_plan(_synthetic_plan(MESH_SYN_BLOCKS, TIMED_SAMPLES, FS,
                                   seed=7, gain=gain), tables=False)
    bp, ca, sf_map, n = _inputs([dp], nudge=False)
    words = np.stack([bp.prmf[:, sc.patch_word_lane(k)]
                      for k in range(sc._N_PATCH)]).astype(np.int64)
    chans = sorted({int(c) for c in ((words[words != 0] >> 2) & 15)})
    assert chans == [1, 7], chans
    arrays = (bp.prmi, bp.prmf, ca, sf_map)
    want = single_device(dev, arrays, n)
    for name, m in meshes.items():
        same(f"synthetic {name}", sharded(
            lambda: launch_on_mesh(m, arrays, n).cpu().numpy()), want)
    res["patch_words_per_block"] = int((words != 0).sum(axis=0).max())

    # b. one full superframe through IqStream(mesh=2x2)
    kw = dict(fs=FS, device=dev)
    stats0 = dict(mesh.stats)
    t0 = time.perf_counter()
    got = sharded(lambda: IqStream(rin, g0, ieph, xyz, mesh=mesh,
                                   **kw).generate(n_blocks))
    res["stream_wall_s"] = time.perf_counter() - t0
    for k in ("reduce_s", "pack_s", "gather_s"):
        res[f"stream_{k}"] = mesh.stats[k] - stats0[k]
    t0 = time.perf_counter()
    want = IqStream(rin, g0, ieph, xyz, **kw).generate(n_blocks)
    res["single_wall_s"] = time.perf_counter() - t0
    same("stream", got, want)
    res["stream_crc32"] = f"{zlib.crc32(got.tobytes()):08x}"
    res["single_crc32"] = f"{zlib.crc32(want.tobytes()):08x}"
    del got, want

    # c. a 10 MHz plan split into sub-blocks, through the mesh
    kw10 = dict(fs=10e6, device=dev)
    s10 = IqStream(rin, g0, ieph, xyz, mesh=mesh, **kw10)
    assert s10.split_k == 2, s10.split_k
    same("10 MHz split", sharded(lambda: s10.generate(2)),
         IqStream(rin, g0, ieph, xyz, **kw10).generate(2))

    # d. the Monte-Carlo batch through the mesh
    xyz_b = _scattered_receivers(MESH_MC_B)
    mc_blocks = min(MESH_MC_BLOCKS, n_blocks)
    same("montecarlo", sharded(lambda: MonteCarloBatch(
        rin, g0, ieph, xyz_b, fs=FS).generate(mc_blocks, dev, mesh=mesh)),
        MonteCarloBatch(rin, g0, ieph, xyz_b, fs=FS).generate(mc_blocks, dev))
    res["launches"] = launches

    # e. the kernel against its twin at this rank's shard of the stream
    dps = [pack_plan(Scheduler(rin, g0, ieph, xyz, fs=FS).plan(n_blocks),
                     tables=False)]
    bp, ca, sf_map, n = _inputs(dps)
    prmi, prmf, sf_map = pad_time_shards(bp.prmi, bp.prmf, sf_map, 2)
    args = local_inputs(mesh, prmi, shard_channel_params(prmf, 2), ca,
                         sf_map)
    kern = sc.synth_blocks(*args, n, packed=False)
    plain = sc.synth_blocks_plain(*args, n, packed=False)
    err = max(int((k.to(torch.int64) - p).abs().max())
              for k, p in zip(kern, plain))
    if err:
        raise AssertionError(f"rank {rank}: packed=False kernel differs "
                             f"from the twin on its shard (max err {err})")
    res["shard_rows"] = int(args[0].shape[0])
    res["kernel_vs_twin_max_abs_err"] = err
    assert "jax" not in sys.modules, "the port imported jax"
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))
    print(f"[mesh] rank {rank} at {tuple(mesh.coord)} on {mesh.device}: "
          f"{json.dumps(res)}", flush=True)


def mesh_refuse(rank: int, world: int) -> None:
    """Two nccl ranks on card 0: make_mesh must refuse them (NCCL
    refuses duplicate GPUs); exits 0 only after the refusal."""
    from pluto_gps_sim_tpu_torch.parallel import make_mesh
    try:
        make_mesh(device="cuda:0")
    except ValueError as e:
        print(f"[mesh] rank {rank} refused: {e}", flush=True)
        raise SystemExit(0)
    raise AssertionError("make_mesh accepted two nccl ranks on one card")


def phase_mesh() -> tuple[int, dict]:
    """The mesh path: 4 gloo ranks on this card (each rank a process),
    then the port's two dryruns; an nccl world only with >= 4 cards."""
    import torch

    from pluto_gps_sim_tpu_torch.parallel import multiproc_dryrun as mpd
    t0 = time.perf_counter()
    out = OUT_DIR / "mesh"
    out.mkdir(parents=True, exist_ok=True)
    logs = mpd.spawn_world(MESH_RANKS, "gloo", "chip_smoke:mesh_rank",
                           (str(out), "cuda", TIMED_BLOCKS), timeout=400.0)
    (out / "gloo_ranks.log").write_text("\n".join(logs))
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(MESH_RANKS)]
    for r in ranks:
        assert r["launches"] > 0, f"rank {r['rank']} never launched"
        assert r["stream_crc32"] == r["single_crc32"] == \
            ranks[0]["stream_crc32"], r
    launches = sum(r["launches"] for r in ranks)
    wall = time.perf_counter() - t0
    reduce_s = max(r["stream_reduce_s"] for r in ranks)
    _phase("mesh gloo 4 ranks on one card", t0,
           f"1x4 and 2x2 patch plan, {TIMED_BLOCKS}-block stream (crc32 "
           f"{ranks[0]['stream_crc32']}), 10 MHz split, Monte-Carlo B="
           f"{MESH_MC_B} x {MESH_MC_BLOCKS} all == single-device; "
           f"launches per rank {[r['launches'] for r in ranks]}; "
           f"stream {max(r['stream_wall_s'] for r in ranks):.3f} s sharded"
           f" vs {max(r['single_wall_s'] for r in ranks):.3f} s single; "
           f"all-reduce {reduce_s:.3f} s, pack + copy to the host "
           f"{max(r['stream_pack_s'] for r in ranks):.3f} s, gather "
           f"{max(r['stream_gather_s'] for r in ranks):.3f} s per "
           f"superframe")

    t1 = time.perf_counter()
    dry = mpd.run_multiprocess_dryrun(MESH_RANKS, "gloo", "cuda",
                                      timeout=300.0)
    multi = mpd.dryrun_multichip(MESH_RANKS, "gloo", "cuda", timeout=300.0)
    (out / "dryruns.log").write_text(dry + "\n" + multi)
    _phase("mesh dryruns gloo on one card", t1,
           f"{dry.count(mpd.OK_TAG)} {mpd.OK_TAG} tags, "
           f"{multi.count(mpd.MULTICHIP_TAG)} {mpd.MULTICHIP_TAG} tags")

    n_cards = torch.cuda.device_count()
    if n_cards >= MESH_RANKS:
        t2 = time.perf_counter()
        nout = out / "nccl"
        nout.mkdir(exist_ok=True)
        mpd.spawn_world(MESH_RANKS, "nccl", "chip_smoke:mesh_rank",
                        (str(nout), "cuda:rank", TIMED_BLOCKS),
                        timeout=400.0)
        nlaunch = [json.loads((nout / f"rank{r}.json").read_text())
                   ["launches"] for r in range(MESH_RANKS)]
        mpd.run_multiprocess_dryrun(MESH_RANKS, "nccl", "cuda:rank",
                                    timeout=300.0)
        mpd.dryrun_multichip(MESH_RANKS, "nccl", "cuda:rank", timeout=300.0)
        refused = mpd.spawn_world(2, "nccl", "chip_smoke:mesh_refuse",
                                  timeout=120.0)
        assert all("refused" in o for o in refused), refused
        _phase("mesh nccl", t2, f"{MESH_RANKS} ranks, one card each, all "
               f"== single-device; launches per rank {nlaunch}; both "
               f"dryruns pass; two ranks on one card refused")
    else:
        print(f"[phase] mesh nccl: not run, {n_cards} card(s)", flush=True)
    return launches, {
        "wall_s": wall, "launches_per_rank": [r["launches"] for r in ranks],
        "stream_wall_s": [r["stream_wall_s"] for r in ranks],
        "single_wall_s": [r["single_wall_s"] for r in ranks],
        "allreduce_s_per_superframe": [r["stream_reduce_s"] for r in ranks],
        "pack_s_per_superframe": [r["stream_pack_s"] for r in ranks],
        "gather_s_per_superframe": [r["stream_gather_s"] for r in ranks],
        "stream_crc32": ranks[0]["stream_crc32"],
        "kernel_vs_twin_max_abs_err": max(
            r["kernel_vs_twin_max_abs_err"] for r in ranks),
        "dryruns_s": time.perf_counter() - t1, "nccl_cards": n_cards}


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
    k1 = phase_build()
    scen = _scenario()
    max_err = max(phase_compare(scen), phase_groups(scen))
    timing = phase_timing()
    launches, rtf = phase_main_path()
    phase_file(scen)
    golden = phase_golden(scen)
    phase_mc_held(scen)
    mc_launches, mc_err, mc = phase_mc_full(scen)
    mesh_launches, mesh = phase_mesh()
    receiver = phase_receiver(scen)
    realtime_wall = phase_io()
    assert "jax" not in sys.modules, "the port imported jax"

    kernels = {"kernels": [{
        "name": "synth_blocks", "route": "cuda",
        "source": "pluto_gps_sim_tpu_torch/ops/csrc/synth_blocks.cu",
        "replaces": "pluto_gps_sim_tpu/ops/synth_pallas.py:194",
        "paths": ["stream", "montecarlo", "mesh"],
        "path_launches": {"stream": launches, "montecarlo": mc_launches,
                          "mesh": mesh_launches},
        "launches": launches + mc_launches + mesh_launches,
        "max_abs_err": max(max_err, mc_err,
                           mesh["kernel_vs_twin_max_abs_err"]),
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}]}
    (OUT_DIR / "result.json").write_text(json.dumps(
        {**kernels, "card": card, "timing": timing, "k1_sass": k1,
         "realtime_factor": rtf,
         "golden": golden, "montecarlo": mc, "mesh": mesh,
         "receiver": receiver, "realtime_wall_s": realtime_wall,
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
