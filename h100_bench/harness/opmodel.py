"""The synthesis kernel's work, counted from the scenario, and the card's
published peaks.

A frozen copy of the per-term operation model of the repository's first
kernel bound, counted from what the scenario asks for (rows x samples,
the active channels of each block, each channel's chips per sample)
rather than from the program's parameter planes, so the count is the
same whatever implements the synthesis.  Each term is the least Hopper
instruction sequence that computes it, where a multiply-add, a
shift-and-add and a three-input logic op are one each:

  per (active channel, sample)
    carrier index 6   two ramp multiply-adds, the f32 residual product
                      and its truncation, an add, a shift-and-add
    chip 9            three ramp multiply-adds, the f32 product and its
                      truncation, an add, two shift-and-adds, a shift
    mix 3             key, shared-memory lookup, accumulate
    spreading sign    min(7, 1 + 8 x chips per sample): chip // 1023
                      and its remainder 2, the nav bit 3, the C/A bit 1,
                      their XOR 1; or 1 from a window of chip signs plus
                      those 7 and the window's store per chip reached
  per sample 4        n to f32, un-bias I and Q, pack

Bytes: each active channel's per-block quantities (carrier and code
phase and rate, the word, bit and code counters, the gain: 8 numbers
of 8 bytes) read once, and each output word written once.
"""

from __future__ import annotations

import numpy as np

OPS_PER_CHANNEL_SAMPLE = 6 + 9 + 3
OPS_SIGN_PER_SAMPLE = 7
OPS_SIGN_WINDOW = (1, OPS_SIGN_PER_SAMPLE + 1)   # per sample, per chip
OPS_PER_SAMPLE = 4
PARAM_BYTES_PER_CHANNEL = 8 * 8                 # per active channel, block
OUT_BYTES_PER_SAMPLE = 4                        # one packed I/Q word

# NVIDIA H100 SXM data sheet: 67 TFLOP/s FP32 outside the tensor cores
# (128 lanes per clock and SM x 132 SMs x 1,980 MHz, a multiply-add
# counted twice) and 3.35 TB/s of HBM3
PEAK_LANE_OPS_PER_S = 128 * 132 * 1.980e9
PEAK_BYTES_PER_S = 3.35e12


def work(active_chips_per_sample: np.ndarray, n_samples: int) -> dict:
    """Operations and bytes of synthesizing rows of n_samples samples.

    active_chips_per_sample: [rows, C] chips per sample of each active
    channel, 0 where the slot is idle."""
    cps = np.asarray(active_chips_per_sample, np.float64)
    active = cps > 0
    sign = np.minimum(OPS_SIGN_PER_SAMPLE,
                      OPS_SIGN_WINDOW[0] + OPS_SIGN_WINDOW[1] * cps[active])
    rows = cps.shape[0]
    ops = float((OPS_PER_CHANNEL_SAMPLE * active.sum() + sign.sum()
                 + OPS_PER_SAMPLE * rows) * n_samples)
    nbytes = float(rows * n_samples * OUT_BYTES_PER_SAMPLE
                   + active.sum() * PARAM_BYTES_PER_CHANNEL)
    return {"ops": ops, "bytes": nbytes,
            "channel_samples": float(active.sum() * n_samples)}


def bound_seconds(w: dict) -> float:
    """The least time the card could take: the larger of the operations
    over the lanes' peak rate and the bytes over the memory's."""
    return max(w["ops"] / PEAK_LANE_OPS_PER_S,
               w["bytes"] / PEAK_BYTES_PER_S)
