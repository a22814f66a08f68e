"""Broadcast-ephemeris orbit propagation, Klobuchar iono, range model.

Numpy equivalents of the reference's L4 propagation layer, broadcasting
over arbitrary leading axes x the [32] satellite axis:

  * satpos   — Kepler solve + harmonic corrections + velocity + SV clock
               (plutogpssim.c:443-546).  The data-dependent Newton loop
               (c:483-487, tol 1e-14) becomes a fixed 6-iteration loop;
               Newton converges quadratically from M_k for GPS
               eccentricities (<0.03) in <6 iterations, after which the
               iterate is inside a <=1-ulp 2-cycle of the f64 map
               (measured: 6 and 8 iterations agree bit-for-bit with 16
               over a 300k-point sweep to ecc 0.05), so results agree
               with the reference to ~nanometers.
  * ionospheric_delay — Klobuchar with the reference's three branches
               (disabled / invalid-params fallback / full model)
               (c:1612-1683); the day-wrap while loops become exact
               floor-mod (subtracting the exactly-representable 86400.0
               is lossless either way).
  * compute_range — light-time extrapolation, Sagnac correction, az/el,
               iono (c:1691-1747).
  * check_visibility — elevation vs mask (c:1896-1916).

All functions take one SoA Ephemerides pytree and broadcast over [32].

History: jnp + cpu_jit through round 4.  Every caller is host
control-plane code and the pipelined stream is HOST-bound, so round 5
ported this layer to numpy (the ops.epoch.ranges_to_params precedent):
the range solve dropped ~2x (no jit dispatch, no device->host
conversions, numpy SIMD transcendentals).  numpy vs XLA libm differ by
<=1-2 ulp — nanometers of range — and every internal bit-exactness
chain (plan_group == plan loop, skip == plan, MC batch == per-receiver
schedulers, precise == tiled == pallas) shares this one implementation.
"""

from __future__ import annotations

import numpy as np

from ..constants import (
    OMEGA_EARTH,
    PI,
    R2D,
    SECONDS_IN_DAY,
    SECONDS_IN_HALF_WEEK,
    SECONDS_IN_WEEK,
    SPEED_OF_LIGHT,
)
from . import geodesy
from ..types import Ephemerides, IonoUtc

__all__ = ["satpos", "ionospheric_delay", "compute_range",
           "check_visibility"]

# even on purpose: past convergence (<6 iterations) the f64 Newton map
# sits in a <=1-ulp 2-cycle for some anomalies, so the parity of the
# count — not just its size — pins the exact iterate every caller shares
# (measured: 6 == 8 == 16 bit-for-bit over a 300k-anomaly sweep to
# ecc 0.05; 5 and 7 differ by the cycle)
_KEPLER_ITERS = 6


def _wrap_half_week(tk: np.ndarray) -> np.ndarray:
    tk = np.where(tk > SECONDS_IN_HALF_WEEK, tk - SECONDS_IN_WEEK, tk)
    tk = np.where(tk < -SECONDS_IN_HALF_WEEK, tk + SECONDS_IN_WEEK, tk)
    return tk


def satpos(eph: Ephemerides, g_sec: np.ndarray):
    """Satellite position/velocity/clock at GPS second-of-week g_sec.

    Returns (pos [.,3], vel [.,3], clk [.,2]); broadcasts g_sec's shape
    against the [32] satellite axis of `eph` (plutogpssim.c:443-546)."""
    g_sec = np.asarray(g_sec, dtype=np.float64)
    tk = _wrap_half_week(g_sec - np.asarray(eph.toe_sec))

    mk = eph.m0 + eph.n * tk

    # Newton from M_k; sin/cos of the final iterate fall out of the last
    # pass (the returned sek/cek ARE the loop's own values — computing
    # them again after the loop would just repeat two transcendentals)
    ek = mk
    sek = np.sin(ek)
    cek = np.cos(ek)
    for _ in range(_KEPLER_ITERS):
        one_minus = 1.0 - eph.ecc * cek
        ek = ek + (mk - ek + eph.ecc * sek) / one_minus
        sek = np.sin(ek)
        cek = np.cos(ek)
    one_minus_ecos_e = 1.0 - eph.ecc * cek

    ekdot = eph.n / one_minus_ecos_e

    relativistic = -4.442807633e-10 * eph.ecc * eph.sqrta * sek

    pk = np.arctan2(eph.sq1e2 * sek, cek - eph.ecc) + eph.aop
    pkdot = eph.sq1e2 * ekdot / one_minus_ecos_e

    s2pk = np.sin(2.0 * pk)
    c2pk = np.cos(2.0 * pk)

    uk = pk + eph.cus * s2pk + eph.cuc * c2pk
    suk = np.sin(uk)
    cuk = np.cos(uk)
    ukdot = pkdot * (1.0 + 2.0 * (eph.cus * c2pk - eph.cuc * s2pk))

    rk = eph.A * one_minus_ecos_e + eph.crc * c2pk + eph.crs * s2pk
    rkdot = eph.A * eph.ecc * sek * ekdot \
        + 2.0 * pkdot * (eph.crs * c2pk - eph.crc * s2pk)

    ik = eph.inc0 + eph.idot * tk + eph.cic * c2pk + eph.cis * s2pk
    sik = np.sin(ik)
    cik = np.cos(ik)
    ikdot = eph.idot + 2.0 * pkdot * (eph.cis * c2pk - eph.cic * s2pk)

    xpk = rk * cuk
    ypk = rk * suk
    xpkdot = rkdot * cuk - ypk * ukdot
    ypkdot = rkdot * suk + xpk * ukdot

    ok = eph.omg0 + tk * eph.omgkdot - OMEGA_EARTH * np.asarray(eph.toe_sec)
    sok = np.sin(ok)
    cok = np.cos(ok)

    pos = np.stack([
        xpk * cok - ypk * cik * sok,
        xpk * sok + ypk * cik * cok,
        ypk * sik,
    ], axis=-1)

    tmp = ypkdot * cik - ypk * sik * ikdot
    vel = np.stack([
        -eph.omgkdot * pos[..., 1] + xpkdot * cok - tmp * sok,
        eph.omgkdot * pos[..., 0] + xpkdot * sok + tmp * cok,
        ypk * cik * ikdot + ypkdot * sik,
    ], axis=-1)

    tk_c = _wrap_half_week(g_sec - np.asarray(eph.toc_sec))
    clk0 = eph.af0 + tk_c * (eph.af1 + tk_c * eph.af2) + relativistic - eph.tgd
    clk1 = eph.af1 + 2.0 * tk_c * eph.af2
    clk = np.stack(np.broadcast_arrays(clk0, clk1), axis=-1)

    return pos, vel, clk


def ionospheric_delay(ionoutc: IonoUtc, g_sec: np.ndarray, llh: np.ndarray,
                      azel: np.ndarray) -> np.ndarray:
    """Klobuchar ionospheric delay [m] (plutogpssim.c:1612-1683)."""
    E = azel[..., 1] / PI
    phi_u = llh[..., 0] / PI
    lam_u = llh[..., 1] / PI

    F = 1.0 + 16.0 * (0.53 - E) ** 3

    fallback = F * 5.0e-9 * SPEED_OF_LIGHT

    psi = 0.0137 / (E + 0.11) - 0.022
    phi_i = phi_u + psi * np.cos(azel[..., 0])
    phi_i = np.clip(phi_i, -0.416, 0.416)
    lam_i = lam_u + psi * np.sin(azel[..., 0]) / np.cos(phi_i * PI)
    phi_m = phi_i + 0.064 * np.cos((lam_i - 1.617) * PI)
    phi_m2 = phi_m * phi_m
    phi_m3 = phi_m2 * phi_m

    amp = ionoutc.alpha0 + ionoutc.alpha1 * phi_m \
        + ionoutc.alpha2 * phi_m2 + ionoutc.alpha3 * phi_m3
    amp = np.maximum(amp, 0.0)
    per = ionoutc.beta0 + ionoutc.beta1 * phi_m \
        + ionoutc.beta2 * phi_m2 + ionoutc.beta3 * phi_m3
    per = np.maximum(per, 72000.0)

    t = SECONDS_IN_DAY / 2.0 * lam_i + g_sec
    t = t - SECONDS_IN_DAY * np.floor(t / SECONDS_IN_DAY)

    x = 2.0 * PI * (t - 50400.0) / per
    x2 = x * x
    x4 = x2 * x2
    full = F * (5.0e-9 + amp * (1.0 - x2 / 2.0 + x4 / 24.0)) * SPEED_OF_LIGHT
    model = np.where(np.abs(x) < 1.57, full, fallback)

    delay = np.where(ionoutc.vflg, model, fallback)
    return np.where(ionoutc.enable, delay, 0.0)


def compute_range(eph: Ephemerides, ionoutc: IonoUtc, g_sec: np.ndarray,
                  xyz: np.ndarray, lean: bool = False, sat_pvc=None):
    """Pseudorange/rate/az-el/iono at receiver ECEF `xyz` [..., 3]
    (plutogpssim.c:1691-1747).

    g_sec broadcasts over leading axes (scalar, [n_epochs], or
    [B, n_epochs]) with xyz [..., 3] matching; a [32] satellite axis is
    appended.  Returns dict with keys: range, d, azel [..,2] (plus rate
    and iono_delay unless lean=True — the planning path consumes only
    the lean keys; values are identical either way, lean just skips the
    rate dot product the reference also computes-but-drops, c:1731).

    sat_pvc: optional precomputed satpos(eph, g_sec[..., None]) triple —
    satellite states are receiver-independent, so batched callers
    (ops.epoch.solve_ranges_batch*) hoist them out of the per-receiver
    chunk loop."""
    g = np.asarray(g_sec, dtype=np.float64)[..., None]   # [..., 1] vs [32]
    xyz = np.asarray(xyz, dtype=np.float64)
    x = xyz[..., None, :]                                # [..., 1, 3]
    pos, vel, clk = satpos(eph, g) if sat_pvc is None else sat_pvc

    los = pos - x
    tau = np.linalg.norm(los, axis=-1) / SPEED_OF_LIGHT

    # Extrapolate SV position back to transmission time
    pos = pos - vel * tau[..., None]

    # Earth-rotation (Sagnac) correction
    xrot = pos[..., 0] + pos[..., 1] * OMEGA_EARTH * tau
    yrot = pos[..., 1] - pos[..., 0] * OMEGA_EARTH * tau
    pos = np.stack([xrot, yrot, pos[..., 2]], axis=-1)

    los = pos - x
    d = np.linalg.norm(los, axis=-1)

    prange = d - SPEED_OF_LIGHT * clk[..., 0]
    # (the reference leaves the SV clock-drift term commented out, c:1731)

    llh = geodesy.xyz2llh(xyz)
    tmat = geodesy.ltcmat(llh)
    neu = geodesy.ecef2neu(los, tmat[..., None, :, :])
    azel = geodesy.neu2azel(neu)

    iono = ionospheric_delay(ionoutc, g, llh[..., None, :], azel)
    prange = prange + iono

    if lean:
        return {"range": prange, "d": d, "azel": azel}
    # d = 0 only for the degenerate exact-origin receiver with the SV at
    # the origin too (never a real geometry); NaN matches jnp semantics
    with np.errstate(invalid="ignore", divide="ignore"):
        rate = np.sum(vel * los, axis=-1) / d
    return {"range": prange, "rate": rate, "d": d, "azel": azel,
            "iono_delay": iono}


def check_visibility(eph: Ephemerides, g_sec: np.ndarray, xyz: np.ndarray,
                     elv_mask_deg: float = 0.0):
    """Visibility mask + az/el for all 32 SVs (plutogpssim.c:1896-1916).

    The reference hardcodes the mask to 0 deg at the allocateChannel call
    site (c:1930); we keep the parameter but default it identically.
    Broadcasts like compute_range: g_sec [...] with xyz [..., 3]."""
    xyz = np.asarray(xyz, dtype=np.float64)
    llh = geodesy.xyz2llh(xyz)
    tmat = geodesy.ltcmat(llh)

    pos, _, _ = satpos(eph, np.asarray(g_sec, np.float64)[..., None])
    los = pos - xyz[..., None, :]
    neu = geodesy.ecef2neu(los, tmat[..., None, :, :])
    azel = geodesy.neu2azel(neu)

    visible = (azel[..., 1] * R2D > elv_mask_deg) & np.asarray(eph.vflg)
    return visible, azel
