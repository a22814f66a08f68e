"""Fixed lookup tables: 512-entry int sin/cos LUTs and receiver antenna pattern.

The reference mixes carrier with 512-entry integer tables of amplitude ~512
(plutogpssim.c:93-161). Matching its IQ output within quantization SNR
requires the *identical* integer tables; substituting float sin/cos changes
every sample slightly. The reference tables follow the closed form

    table[k] = trunc(511 * sin(2*pi*k/512)) + 1        (sinTable512)
    table[k] = trunc(511 * cos(2*pi*k/512)) + 1        (cosTable512)

verified entry-by-entry against plutogpssim.c:93-161, with a single quirk:
cosTable512[384] is 0 in the reference (the formula gives 1).  We generate
the tables from the formula and patch that one entry.

The antenna pattern (attenuation in dB vs boresight angle 0:5:180 deg,
plutogpssim.c:164-169) is replicated verbatim as numeric data.
"""

import numpy as np

__all__ = ["SIN_TABLE_512", "COS_TABLE_512", "ANT_PAT_DB", "ant_pat_linear"]


def _make_trig_tables() -> tuple[np.ndarray, np.ndarray]:
    k = np.arange(512, dtype=np.float64)
    ang = 2.0 * np.pi * k / 512.0
    sin_t = np.trunc(511.0 * np.sin(ang)).astype(np.int32) + 1
    cos_t = np.trunc(511.0 * np.cos(ang)).astype(np.int32) + 1
    cos_t[384] = 0  # reference table quirk (plutogpssim.c:153 first entry)
    return sin_t, cos_t


SIN_TABLE_512, COS_TABLE_512 = _make_trig_tables()

# Receiver antenna attenuation [dB] for boresight angle = 0:5:180 deg
# (plutogpssim.c:164-169)
ANT_PAT_DB = np.array([
    0.00, 0.00, 0.22, 0.44, 0.67, 1.11, 1.56, 2.00, 2.44, 2.89, 3.56, 4.22,
    4.89, 5.56, 6.22, 6.89, 7.56, 8.22, 8.89, 9.78, 10.67, 11.56, 12.44,
    13.33, 14.44, 15.56, 16.67, 17.78, 18.89, 20.00, 21.33, 22.67, 24.00,
    25.56, 27.33, 29.33, 31.56,
], dtype=np.float64)


def ant_pat_linear() -> np.ndarray:
    """Linear antenna gain table: 10^(-dB/20) (plutogpssim.c:2645-2646)."""
    return np.power(10.0, -ANT_PAT_DB / 20.0)
