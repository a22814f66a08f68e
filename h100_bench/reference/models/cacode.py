"""C/A (coarse/acquisition) Gold-code generation for GPS PRN 1..32.

Behavioral parity with the reference LFSR generator (plutogpssim.c:207-244):
two 10-stage registers, G1 taps at stages 3 & 10, G2 taps at stages
2,3,6,8,9,10, chips emitted as 0/1 via (1 - g1*g2)/2 with the per-PRN G2
delay table.  TPU-native plan per SURVEY.md #5: the sequential LFSR runs
once at import time on the host; the hot path only ever sees the
precomputed int8 table CA_TABLE[32, 1023].
"""

import numpy as np

__all__ = ["CA_TABLE", "G2_DELAY", "ca_code"]

# Per-PRN G2 delay (chips), PRN 1..32 (plutogpssim.c:208-213)
G2_DELAY = np.array([
    5, 6, 7, 8, 17, 18, 139, 140, 141, 251,
    252, 254, 255, 256, 257, 258, 469, 470, 471, 472,
    473, 474, 509, 512, 513, 514, 515, 516, 859, 860,
    861, 862,
], dtype=np.int32)

_CA_SEQ_LEN = 1023


def _lfsr_sequences() -> tuple[np.ndarray, np.ndarray]:
    """Run the G1/G2 maximal-length sequences once (±1 convention)."""
    r1 = -np.ones(10, dtype=np.int64)
    r2 = -np.ones(10, dtype=np.int64)
    g1 = np.empty(_CA_SEQ_LEN, dtype=np.int64)
    g2 = np.empty(_CA_SEQ_LEN, dtype=np.int64)
    for i in range(_CA_SEQ_LEN):
        g1[i] = r1[9]
        g2[i] = r2[9]
        c1 = r1[2] * r1[9]
        c2 = r2[1] * r2[2] * r2[5] * r2[7] * r2[8] * r2[9]
        r1[1:] = r1[:-1]
        r2[1:] = r2[:-1]
        r1[0] = c1
        r2[0] = c2
    return g1, g2


def _build_table() -> np.ndarray:
    g1, g2 = _lfsr_sequences()
    table = np.empty((32, _CA_SEQ_LEN), dtype=np.int8)
    for prn in range(1, 33):
        shift = _CA_SEQ_LEN - int(G2_DELAY[prn - 1])
        g2d = np.roll(g2, -shift)  # g2[(i + shift) % 1023]
        table[prn - 1] = ((1 - g1 * g2d) // 2).astype(np.int8)
    return table


# chips are 0/1, shape [32 PRNs, 1023 chips]
CA_TABLE = _build_table()
CA_TABLE.setflags(write=False)


def ca_code(prn: int) -> np.ndarray:
    """Return the 1023-chip 0/1 C/A sequence for PRN in 1..32."""
    if not 1 <= prn <= 32:
        raise ValueError(f"PRN must be in 1..32, got {prn}")
    return CA_TABLE[prn - 1]
