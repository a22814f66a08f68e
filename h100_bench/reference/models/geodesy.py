"""WGS-84 geodesy: ECEF <-> LLH, local-tangent frames, az/el.

Pure-numpy equivalents of the reference's leaf math
(plutogpssim.c:178-434).  All functions are pure and operate on float64
arrays with full leading-axis broadcasting; the reference's
data-dependent xyz2llh `while` loop (c:323-334) becomes a
fixed-iteration Bowring-style loop (converges in <6 iterations at its
1e-3 m tolerance; extra iterations only tighten the estimate, keeping us
within the reference's own tolerance).

History: this module was jnp (jit/vmap-safe) through round 4.  Every
caller is the host control plane (the scheduler's range solve, the
allocator, the CLI, the receiver) and the pipelined stream is
HOST-bound, so round 5 ported it to numpy — the same move
ops.epoch.ranges_to_params made in round 3 — dropping the per-call jit
dispatch and device->host conversions.  numpy's SIMD transcendentals
differ from XLA's libm calls by <=1-2 ulp, nanometers at range scale;
every internal bit-exactness chain shares this one implementation, and
the golden A/B gates (SNR-level vs the reference oracle) are six orders
of magnitude above it.
"""

from __future__ import annotations

import numpy as np

from ..constants import PI, WGS84_ECCENTRICITY, WGS84_RADIUS

__all__ = ["xyz2llh", "llh2xyz", "ltcmat", "ecef2neu", "neu2azel"]

_XYZ2LLH_ITERS = 10


def xyz2llh(xyz: np.ndarray) -> np.ndarray:
    """ECEF [...,3] -> lat/lon/height [...,3] (rad, rad, m).

    Mirrors plutogpssim.c:296-341 including the degenerate near-origin
    branch (llh = (0, 0, -a))."""
    a = WGS84_RADIUS
    e2 = WGS84_ECCENTRICITY * WGS84_ECCENTRICITY

    xyz = np.asarray(xyz, dtype=np.float64)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    rho2 = x * x + y * y

    # the exact-origin input (the allocator's earth-center reference
    # solve, c:1959) divides 0/0 here; the degenerate branch below
    # replaces the NaNs, matching the old jnp semantics — silence the
    # numpy warning for that one legitimate case
    with np.errstate(invalid="ignore", divide="ignore"):
        dz = e2 * z
        for _ in range(_XYZ2LLH_ITERS):
            zdz = z + dz
            nh = np.sqrt(rho2 + zdz * zdz)
            slat = zdz / nh
            n = a / np.sqrt(1.0 - e2 * slat * slat)
            dz = n * e2 * slat
        zdz = z + dz
        nh = np.sqrt(rho2 + zdz * zdz)
        slat = zdz / nh
        n = a / np.sqrt(1.0 - e2 * slat * slat)

    lat = np.arctan2(zdz, np.sqrt(rho2))
    lon = np.arctan2(y, x)
    hgt = nh - n

    degenerate = np.sqrt(rho2 + z * z) < 1.0e-3
    lat = np.where(degenerate, 0.0, lat)
    lon = np.where(degenerate, 0.0, lon)
    hgt = np.where(degenerate, -a, hgt)
    return np.stack([lat, lon, hgt], axis=-1)


def llh2xyz(llh: np.ndarray) -> np.ndarray:
    """lat/lon/height [...,3] -> ECEF [...,3] (plutogpssim.c:347-378)."""
    a = WGS84_RADIUS
    e = WGS84_ECCENTRICITY
    e2 = e * e

    llh = np.asarray(llh, dtype=np.float64)
    clat = np.cos(llh[..., 0])
    slat = np.sin(llh[..., 0])
    clon = np.cos(llh[..., 1])
    slon = np.sin(llh[..., 1])
    d = e * slat

    n = a / np.sqrt(1.0 - d * d)
    nph = n + llh[..., 2]

    tmp = nph * clat
    return np.stack([
        tmp * clon,
        tmp * slon,
        ((1.0 - e2) * n + llh[..., 2]) * slat,
    ], axis=-1)


def ltcmat(llh: np.ndarray) -> np.ndarray:
    """Local-tangent-coordinate rotation matrix [...,3,3] (c:384-404)."""
    llh = np.asarray(llh, dtype=np.float64)
    slat = np.sin(llh[..., 0])
    clat = np.cos(llh[..., 0])
    slon = np.sin(llh[..., 1])
    clon = np.cos(llh[..., 1])
    zeros = np.zeros_like(slat)
    row0 = np.stack([-slat * clon, -slat * slon, clat], axis=-1)
    row1 = np.stack([-slon, clon, zeros], axis=-1)
    row2 = np.stack([clat * clon, clat * slon, slat], axis=-1)
    return np.stack([row0, row1, row2], axis=-2)


def ecef2neu(xyz: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Rotate an ECEF vector into North-East-Up (c:411-417)."""
    return np.einsum("...ij,...j->...i", t, xyz)


def neu2azel(neu: np.ndarray) -> np.ndarray:
    """NEU -> (azimuth, elevation) [rad] (c:423-434)."""
    az = np.arctan2(neu[..., 1], neu[..., 0])
    az = np.where(az < 0.0, az + 2.0 * PI, az)
    ne = np.sqrt(neu[..., 0] ** 2 + neu[..., 1] ** 2)
    el = np.arctan2(neu[..., 2], ne)
    return np.stack([az, el], axis=-1)
