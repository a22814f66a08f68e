"""The frozen operation model, counted from the scenario's work."""

import numpy as np

from harness import opmodel

# chip_smoke.kernel_bound at chip_smoke's timing shape (PERF.md, PR 5
# review count): 300 blocks x 260,000 samples, 12 active channels,
# Dopplers uniform in +-4,500 Hz, counted from the parameter planes
SMOKE_OPS = 2.104e10
SMOKE_PER_CHANNEL_SAMPLE = 22.48
SMOKE_OPS_MS = 0.6290


def test_work_count_at_chip_smokes_timing_shape():
    rng = np.random.RandomState(3)
    f_carr = rng.uniform(-4500.0, 4500.0, 12)
    cps = np.repeat(((1_023_000.0 + f_carr / 1540.0) / 2.6e6)[None], 300, 0)
    w = opmodel.work(cps, 260_000)
    per = w["ops"] / w["channel_samples"]
    ms = opmodel.bound_seconds(w) * 1e3
    print(f"\nwork-based: {w['ops']:.6g} operations, {per:.4f} per "
          f"channel-sample, {ms:.4f} ms at the published peak; "
          f"chip_smoke.kernel_bound: {SMOKE_OPS:.4g}, "
          f"{SMOKE_PER_CHANNEL_SAMPLE}, {SMOKE_OPS_MS} ms")
    assert abs(w["ops"] / SMOKE_OPS - 1) < 5e-4
    assert abs(per - SMOKE_PER_CHANNEL_SAMPLE) < 0.005
    assert abs(ms - SMOKE_OPS_MS) < 5e-4
    assert ms * 1e-3 == w["ops"] / opmodel.PEAK_LANE_OPS_PER_S  # ops-bound


def test_idle_slots_do_no_channel_work():
    full = opmodel.work(np.full((10, 12), 0.4), 1000)
    part = opmodel.work(np.where(np.arange(12) < 8, 0.4, 0.0)
                        * np.ones((10, 1)), 1000)
    assert part["channel_samples"] == full["channel_samples"] * 8 / 12
    per_sample = opmodel.OPS_PER_SAMPLE * 10 * 1000
    assert (part["ops"] - per_sample) * 12 == \
        (full["ops"] - per_sample) * 8


def test_peaks_are_the_data_sheets():
    assert abs(opmodel.PEAK_LANE_OPS_PER_S * 2 / 1e12 - 66.9) < 0.1
    assert opmodel.PEAK_BYTES_PER_S == 3.35e12
