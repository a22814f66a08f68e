"""User-motion CSV ingest (dynamic receiver trajectories).

Equivalent of readUserMotion (plutogpssim.c:1794-1818): CSV rows
`t,x,y,z` in ECEF meters at 10 Hz, at most USER_MOTION_SIZE rows; the
time column is parsed but ignored, and playback wraps at EOF
(c:2802-2805) — the wrap is handled by the scenario runner.
"""

from __future__ import annotations

import numpy as np

from ..constants import USER_MOTION_SIZE

__all__ = ["read_user_motion"]


def read_user_motion(filename: str,
                     max_points: int = USER_MOTION_SIZE) -> np.ndarray:
    """Return ECEF positions [numd, 3] float64; raises on unreadable file."""
    rows = []
    with open(filename, "rt") as fp:
        for line in fp:
            if len(rows) >= max_points:
                break
            parts = line.strip().split(",")
            if len(parts) < 4:
                break
            try:
                vals = [float(p) for p in parts[:4]]
            except ValueError:
                break
            rows.append(vals[1:4])
    if not rows:
        raise ValueError(f"no user motion data in {filename}")
    return np.asarray(rows, dtype=np.float64)
