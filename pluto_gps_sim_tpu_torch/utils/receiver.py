"""Software GPS receiver: track, decode LNAV, and position-fix from IQ.

A copy of the JAX package's ``utils/receiver.py:1-604`` (command line entry
``_main``, receiver.py:566-604, included).  It reads host int16 IQ only.

The reference's only system-level validation was hardware: feed its RF
output through an attenuator to a real GPS receiver and check that it
decodes the navigation message and obtains a position fix (its README
bench-setup section; SURVEY.md §4).  This module is that receiver in
software, closing the same loop against our synthesized IQ with no
dependence on the golden oracle:

  acquisition (utils/acquisition.py)  ->  per-PRN Doppler + code phase
  scalar tracking loops (this file)   ->  Costas PLL + carrier-aided DLL
  bit & frame sync                    ->  50 bit/s LNAV stream
  LNAV decode (utils/lnav_decode.py)  ->  ephemeris, iono/UTC, TOW/WN
  pseudoranges + least squares        ->  receiver position and clock

A correct fix proves every layer end-to-end: C/A spreading and the
carrier convention (acquisition), phase/frequency dynamics (tracking
stays locked), nav-message packing and parity (decode), and the
geometric/clock/iono range model (the fix lands on the simulated
receiver position using ONLY broadcast-decoded parameters).

Numpy-only host code; the tracking loops are sequential by nature
(the loop filter state carries sample to sample) and run at ~30x real
time per channel on one CPU core — this is a validation harness, not a
production receiver.

Usage as a tool:  python -m pluto_gps_sim_tpu_torch.utils.receiver out.bin \
    --fs 2600000 --week 2241
prints the acquisition table, per-channel decode status, and the fix.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..constants import (
    CA_SEQ_LEN,
    CARR_TO_CODE,
    CODE_FREQ,
    SPEED_OF_LIGHT,
)
from ..models.cacode import CA_TABLE
from .acquisition import AcqResult, acquire
from .lnav_decode import (
    PREAMBLE,
    build_ephemerides,
    build_ionoutc,
    decode_frame,
    decode_how,
    parity_check,
)

__all__ = ["TrackResult", "track", "frame_sync", "transmit_time",
           "refine_code_phase", "NavSolution", "solve_fix",
           "measured_doppler", "VelSolution", "solve_velocity",
           "receive_and_fix"]


def _loop_coef(lbw: float, zeta: float, k: float) -> tuple[float, float]:
    """2nd-order loop filter time constants (tau1, tau2) from noise
    bandwidth `lbw` Hz, damping `zeta`, gain `k` (standard PLL/DLL
    design, e.g. Kaplan & Hegarty ch. 5)."""
    wn = lbw * 8.0 * zeta / (4.0 * zeta * zeta + 1.0)
    return k / (wn * wn), 2.0 * zeta / wn


@dataclass
class TrackResult:
    """Per-channel tracking history at one-entry-per-code-period."""

    prn: int
    fs: float
    block_start: np.ndarray      # [P] int64  first sample of each period
    rem_code_phase: np.ndarray   # [P] f64    chips at that sample
    f_code: np.ndarray           # [P] f64    chips/s used for the period
    f_carr: np.ndarray           # [P] f64    carrier Doppler (Hz)
    i_p: np.ndarray              # [P] f64    prompt in-phase
    q_p: np.ndarray              # [P] f64    prompt quadrature
    # filled by frame_sync():
    bit_offset: int = -1         # period index where a data bit begins
    polarity: int = 0            # +1/-1 bit-sign convention that decoded
    bits: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int8))
    subframes: dict = field(default_factory=dict)   # id -> [10 x data24]
    sbf_start_bit: int = -1      # bit index of the first decoded subframe
    tow: int = -1                # HOW Z-count of the NEXT subframe
    decoded: dict = field(default_factory=dict)     # merged frame fields

    @property
    def locked_ratio(self) -> float:
        """Fraction of periods where prompt energy is carrier-locked
        (|I| dominating |Q|) over the last half of the run."""
        h = len(self.i_p) // 2
        return float(np.mean(np.abs(self.i_p[h:]) > 2.0 *
                             np.abs(self.q_p[h:])))


def track(iq, fs: float, prn: int, acq: AcqResult, n_ms: int,
          pll_bw: float = 25.0, dll_bw: float = 2.0) -> TrackResult:
    """Closed-loop tracking of one PRN for n_ms code periods.

    Costas PLL (atan discriminator, 2nd-order filter at `pll_bw` Hz) for
    the carrier; normalized early-late power DLL (±0.5 chip, 2nd-order
    at `dll_bw` Hz, carrier-aided) for the code.  Starts from the
    acquisition's code offset and Doppler; `iq` is any int16 IQ layout
    `utils.acquisition._to_complex` accepts.
    """
    from .acquisition import _to_complex
    z = _to_complex(iq)

    chips = (CA_TABLE[prn - 1].astype(np.float64) * 2.0 - 1.0)
    tau1c, tau2c = _loop_coef(pll_bw, 0.7, 0.25)
    tau1d, tau2d = _loop_coef(dll_bw, 0.7, 1.0)

    ptr = int(math.ceil(acq.code_offset))
    rem_code = ((ptr - acq.code_offset) * CODE_FREQ / fs) % CA_SEQ_LEN
    f_carr = acq.doppler_hz
    carr_phase = 0.0
    nco_carr = 0.0
    nco_code = 0.0
    err_p_old = 0.0
    err_c_old = 0.0
    spc = 0.5                      # early-late spacing, chips

    out = {k: [] for k in ("bs", "rcp", "fco", "fca", "ip", "qp")}
    pdi = CA_SEQ_LEN / CODE_FREQ   # integration time per period (1 ms)

    for _ in range(n_ms):
        f_code = CODE_FREQ + f_carr * CARR_TO_CODE + nco_code
        step = f_code / fs
        blk = int(math.ceil((CA_SEQ_LEN - rem_code) / step))
        if ptr + blk > z.size:
            break
        x = z[ptr:ptr + blk]
        n = np.arange(blk)

        out["bs"].append(ptr)
        out["rcp"].append(rem_code)
        out["fco"].append(f_code)
        out["fca"].append(f_carr)

        # carrier wipe
        v = x * np.exp(-2j * np.pi * (carr_phase + (f_carr / fs) * n))
        # code replicas: prompt at tc, early advanced +spc, late -spc
        tc = rem_code + n * step
        p_ = chips[np.floor(tc).astype(np.int64) % CA_SEQ_LEN]
        e_ = chips[np.floor(tc + spc).astype(np.int64) % CA_SEQ_LEN]
        l_ = chips[np.floor(tc - spc).astype(np.int64) % CA_SEQ_LEN]
        cp = v @ p_
        ce = v @ e_
        cl = v @ l_
        i_p, q_p = cp.real, cp.imag
        out["ip"].append(i_p)
        out["qp"].append(q_p)

        # Costas discriminator (cycles) + 2nd-order PLL.  atan(Q/I),
        # NOT atan2: the discriminator must be invariant to the nav-bit
        # sign, so its range is (-pi/2, pi/2]
        err_p = math.atan(q_p / (i_p if i_p != 0.0 else 1e-12)) \
            / (2 * np.pi)
        nco_carr += (tau2c / tau1c) * (err_p - err_p_old) \
            + err_p * (pdi / tau1c)
        err_p_old = err_p
        f_carr = acq.doppler_hz + nco_carr

        # normalized early-late power + 2nd-order DLL (carrier-aided)
        e_pow = abs(ce)
        l_pow = abs(cl)
        err_c = 0.0 if e_pow + l_pow == 0.0 else \
            0.5 * (e_pow - l_pow) / (e_pow + l_pow)
        nco_code += (tau2d / tau1d) * (err_c - err_c_old) \
            + err_c * (pdi / tau1d)
        err_c_old = err_c

        carr_phase = (carr_phase + (f_carr / fs) * blk) % 1.0
        rem_code = tc[-1] + step - CA_SEQ_LEN
        ptr += blk

    return TrackResult(
        prn=prn, fs=fs,
        block_start=np.array(out["bs"], np.int64),
        rem_code_phase=np.array(out["rcp"]),
        f_code=np.array(out["fco"]), f_carr=np.array(out["fca"]),
        i_p=np.array(out["ip"]), q_p=np.array(out["qp"]))


def _bit_sync(i_p: np.ndarray, skip: int = 100) -> int:
    """Bit boundary phase in [0,20): the period index (mod 20) where
    sign transitions of the prompt correlator cluster."""
    s = np.sign(i_p[skip:])
    flips = np.flatnonzero(s[1:] != s[:-1]) + skip + 1
    if not len(flips):
        return 0      # no transitions: any phase works
    hist = np.bincount(flips % 20, minlength=20)
    return int(np.argmax(hist))


def frame_sync(tr: TrackResult, skip_ms: int = 100) -> TrackResult:
    """Bit sync + preamble search + parity-verified subframe decode.

    Fills tr.bit_offset/polarity/bits/subframes/sbf_start_bit/tow and,
    when subframes {1,2,3} are all present, tr.decoded.  Raises
    ValueError when no parity-verified subframe exists in the stream
    (e.g. the track was too short or never locked).
    """
    n_p = len(tr.i_p)
    tr.bit_offset = _bit_sync(tr.i_p, skip_ms)
    nbits = (n_p - tr.bit_offset) // 20
    if nbits < 62:
        raise ValueError(f"only {nbits} bits tracked; need >= 62")
    acc = tr.i_p[tr.bit_offset:tr.bit_offset + nbits * 20]
    bits = np.sign(acc.reshape(nbits, 20).sum(axis=1)).astype(np.int8)
    bits[bits == 0] = 1
    tr.bits = bits

    b01 = (bits > 0).astype(np.int64)   # trial polarity: +1 == bit 1

    def words_at(k0: int, pol_bits: np.ndarray):
        """Parse 10 words from bit k0; word w needs bits[k0-2 ...]."""
        prev = 0
        if k0 >= 2:
            prev = int(pol_bits[k0 - 2] << 1 | pol_bits[k0 - 1])
        datas = []
        for w in range(10):
            seg = pol_bits[k0 + 30 * w:k0 + 30 * (w + 1)]
            word = 0
            for b in seg:
                word = (word << 1) | int(b)
            ok, data = parity_check(word, prev)
            if not ok:
                return None
            prev = word
            datas.append(data)
        return datas

    for pol in (1, -1):
        pb = b01 if pol == 1 else 1 - b01
        # candidate subframe starts: preamble match with >= 300 bits of
        # stream from them (k0 == nbits-300 is the last valid start)
        # and >= 2 bits before (for D29*/D30*)
        for k0 in range(2, nbits - 299):
            pre = 0
            for b in pb[k0:k0 + 8]:
                pre = (pre << 1) | int(b)
            if pre != PREAMBLE:
                continue
            datas = words_at(k0, pb)
            if datas is None:
                continue
            tow, sid = decode_how(datas[1])
            if not (1 <= sid <= 5):
                continue
            # verified subframe: walk forward collecting the rest
            tr.polarity = pol
            tr.sbf_start_bit = k0
            tr.tow = tow
            tr.subframes[sid] = datas
            k = k0 + 300
            t = tow
            while k + 300 <= nbits:
                d2 = words_at(k, pb)
                if d2 is None:
                    break
                t2, s2 = decode_how(d2[1])
                if t2 != (t + 1) % 100800:   # Z-count wraps at week end
                    break
                tr.subframes[s2] = d2
                k += 300
                t = t2
            if {1, 2, 3} <= tr.subframes.keys():
                try:
                    tr.decoded = decode_frame(tr.subframes)
                except ValueError:
                    # e.g. IODE/IODC mismatch when the capture spans an
                    # ephemeris upload: frame sync still succeeded, the
                    # channel's transmit_time is still usable
                    tr.decoded = {}
            return tr
    raise ValueError(f"PRN {tr.prn}: no parity-verified subframe found")


def transmit_time(tr: TrackResult, n_sample: int) -> float:
    """GPS seconds-of-week being transmitted by tr's satellite at
    receiver sample `n_sample` (must lie inside the tracked span)."""
    if tr.sbf_start_bit < 0:
        raise ValueError("frame_sync() required first")
    p = int(np.searchsorted(tr.block_start, n_sample, "right")) - 1
    if p < 0 or p >= len(tr.block_start):
        raise ValueError("sample outside tracked span")
    chips = tr.rem_code_phase[p] + \
        (n_sample - tr.block_start[p]) * tr.f_code[p] / tr.fs
    p0 = tr.bit_offset + 20 * tr.sbf_start_bit   # period of subframe start
    # HOW holds the Z-count of the NEXT subframe: this one began at
    # (tow-1)*6 s.  tow == 0 means the subframe started 6 s before the
    # week rollover; the modulo keeps the result in seconds-of-week
    # (a fix with measurements straddling the rollover epoch itself
    # would mix weeks in solve_fix and is out of scope).
    t_sbf = ((tr.tow - 1) * 6.0) % 604800.0
    return t_sbf + (p - p0) * 1e-3 + chips * (1e-3 / CA_SEQ_LEN)


def refine_code_phase(tr: TrackResult, z: np.ndarray, n_sample: int,
                      n_avg: int = 16, spacing_bits: int = 10,
                      n_coh_ms: int = 18, half: float = 0.6,
                      k: int = 13) -> float:
    """Open-loop code-phase correction (chips) for the tracked state
    around receiver sample `n_sample`.

    The closed-loop DLL (0.5-chip early-late on floor-sampled replicas)
    carries a per-channel bias of a few thousandths of a chip (metres).
    This measures it directly: coherent `n_coh_ms` correlations against
    replicas offset by a grid of sub-chip lags, then a two-line fit of
    the C/A correlation triangle whose apex is the true lag.  Averaged
    over `n_avg` bit-aligned windows so cross-channel interference
    (which decorrelates across windows unless two PRNs sit at the same
    Doppler) averages down.  Returns the signed apex offset in chips;
    add `apex / CODE_FREQ` to transmit_time()'s result.
    """
    chips_pm = CA_TABLE[tr.prn - 1].astype(np.float64) * 2.0 - 1.0
    offs = np.linspace(-half, half, k)
    left = offs < -0.08
    right = offs > 0.08

    p0 = int(np.searchsorted(tr.block_start, n_sample, "right")) - 1
    b0 = (p0 - tr.bit_offset) // 20
    apexes = []
    for j in range(n_avg):
        b = b0 + (j - n_avg // 2) * spacing_bits
        ps = tr.bit_offset + 20 * b + 1      # inside one nav bit
        if ps < 0 or ps + n_coh_ms + 1 >= len(tr.block_start):
            continue
        s0 = int(tr.block_start[ps])
        blk = int(tr.block_start[ps + n_coh_ms] - s0)
        n = np.arange(blk)
        v = z[s0:s0 + blk] * np.exp(
            -2j * np.pi * (tr.f_carr[ps] / tr.fs) * n)
        tc = tr.rem_code_phase[ps] + n * (tr.f_code[ps] / tr.fs)
        mags = np.array([
            abs(v @ chips_pm[np.floor(tc + d).astype(np.int64)
                             % CA_SEQ_LEN]) for d in offs])
        al, bl = np.polyfit(offs[left], mags[left], 1)
        ar, br = np.polyfit(offs[right], mags[right], 1)
        if al - ar == 0.0 or not np.isfinite(mags).all():
            continue
        apexes.append((br - bl) / (al - ar))
    return float(np.mean(apexes)) if apexes else 0.0


@dataclass
class NavSolution:
    """Receiver position/clock solution and its diagnostics."""

    xyz: np.ndarray          # [3] ECEF meters
    t_rx: float              # GPS seconds-of-week at the solution epoch
    residuals: np.ndarray    # [n_sv] post-fit range residuals (m)
    prns: list
    n_iter: int
    velocity: "VelSolution | None" = None   # filled by receive_and_fix

    @property
    def rms_residual(self) -> float:
        return float(np.sqrt(np.mean(self.residuals ** 2)))


def solve_fix(eph, ionoutc, t_tx: dict, x0=None, t0=None,
              n_iter: int = 8) -> NavSolution:
    """Iterated least squares on (x, y, z, t_rx) from measured transmit
    times {prn: seconds-of-week}.

    The forward model is `models.orbits.compute_range` — the ICD
    pseudorange model (Kepler orbit, SV clock incl. relativistic + tgd,
    Sagnac, Klobuchar) evaluated from the DECODED `eph`/`ionoutc`.  The
    residual for satellite i is  c*(t_rx - t_tx_i) - prange_i(x, t_rx);
    the Jacobian is taken by finite differences so the solver stays
    agnostic to the model internals.
    """
    from ..models import orbits

    prns = sorted(t_tx)
    if len(prns) < 4:
        raise ValueError(f"need >= 4 satellites, have {len(prns)}")
    tt = np.array([t_tx[p] for p in prns])
    idx = np.array([p - 1 for p in prns])

    x = np.zeros(3) if x0 is None else np.asarray(x0, np.float64).copy()
    t_rx = (float(np.max(tt)) + 0.075) if t0 is None else float(t0)

    def prange(xv, tv):
        # compute_range is pure numpy f64 on the host (models/orbits.py)
        r = orbits.compute_range(eph, ionoutc, tv, xv)
        return np.asarray(r["range"])[idx]

    it = 0
    for it in range(1, n_iter + 1):
        r0 = SPEED_OF_LIGHT * (t_rx - tt) - prange(x, t_rx)
        cols = []
        h = 1.0
        for j in range(3):
            dx = x.copy()
            dx[j] += h
            cols.append((SPEED_OF_LIGHT * (t_rx - tt)
                         - prange(dx, t_rx) - r0) / h)
        ht = 1e-6
        cols.append((SPEED_OF_LIGHT * (t_rx + ht - tt)
                     - prange(x, t_rx + ht) - r0) / ht)
        jac = np.stack(cols, axis=1)
        delta, *_ = np.linalg.lstsq(jac, -r0, rcond=None)
        x += delta[:3]
        t_rx += delta[3]
        if np.max(np.abs(delta[:3])) < 1e-4 and abs(delta[3]) < 1e-12:
            break
    res = SPEED_OF_LIGHT * (t_rx - tt) - prange(x, t_rx)
    return NavSolution(xyz=x, t_rx=t_rx, residuals=res, prns=prns,
                       n_iter=it)


def measured_doppler(tr: TrackResult, n_sample: int,
                     window_ms: int = 200) -> float:
    """Carrier Doppler (Hz) at receiver sample `n_sample`, averaged over
    the `window_ms` code periods centered there.

    The PLL's per-period NCO frequency (tr.f_carr) is an unbiased but
    noisy estimate of the incoming Doppler; the synthesized Doppler is
    piecewise-constant per 0.1 s block (epoch.py), so a centered mean
    over ~200 periods averages loop jitter down to the sub-Hz level
    while staying centered on the instantaneous value (the quadratic
    Doppler-rate term over 0.2 s is mm/s-class)."""
    p0 = int(np.searchsorted(tr.block_start, n_sample, "right")) - 1
    lo = max(tr.bit_offset if tr.bit_offset > 0 else 0,
             p0 - window_ms // 2)
    hi = min(len(tr.f_carr), p0 + window_ms // 2)
    if hi <= lo:
        raise ValueError("measurement epoch outside the tracked span")
    return float(np.mean(tr.f_carr[lo:hi]))


@dataclass
class VelSolution:
    """Receiver velocity/clock-drift solution and its diagnostics."""

    vel: np.ndarray          # [3] ECEF m/s
    cbdot: float             # receiver clock drift * c (m/s)
    residuals: np.ndarray    # [n_sv] post-fit range-rate residuals (m/s)
    prns: list

    @property
    def rms_residual(self) -> float:
        return float(np.sqrt(np.mean(self.residuals ** 2)))


def solve_velocity(eph, ionoutc, fd: dict, sol: NavSolution) -> VelSolution:
    """Least-squares receiver velocity from measured carrier Dopplers
    {prn: Hz}, around a position solution `sol` (solve_fix output).

    The simulator's carrier Doppler is the full pseudorange rate,
    f_carr = -d(rho)/dt / lambda (plutogpssim.c:1760-1763, epoch.py:88),
    where rho includes SV motion, Sagnac, SV clock drift, and iono rate
    — so the model here is the time/position derivative of the SAME
    compute_range forward model solve_fix uses, taken by finite
    differences:  -lambda*fd_i = d_t(rho_i) + grad_x(rho_i)@v + c*bdot.
    Solving the linear system for (v[3], c*bdot) validates the
    synthesized Doppler chain end-to-end: a sign error, a lambda-scale
    error, or a rate-term omission in epoch.py would land the velocity
    hundreds of m/s off, not cm/s."""
    from ..constants import LAMBDA_L1
    from ..models import orbits

    prns = sorted(fd)
    if len(prns) < 4:
        raise ValueError(f"need >= 4 satellites, have {len(prns)}")
    idx = np.array([p - 1 for p in prns])
    x, t = sol.xyz, sol.t_rx

    def prange(xv, tv):
        r = orbits.compute_range(eph, ionoutc, tv, xv)
        return np.asarray(r["range"])[idx]

    h = 0.05
    dt_part = (prange(x, t + h) - prange(x, t - h)) / (2.0 * h)
    r0 = prange(x, t)
    cols = []
    for j in range(3):
        dx = x.copy()
        dx[j] += 1.0
        cols.append(prange(dx, t) - r0)
    jac = np.stack(cols + [np.ones(len(prns))], axis=1)
    rhs = np.array([-LAMBDA_L1 * fd[p] for p in prns]) - dt_part
    u, *_ = np.linalg.lstsq(jac, rhs, rcond=None)
    res = rhs - jac @ u
    return VelSolution(vel=u[:3], cbdot=float(u[3]), residuals=res,
                       prns=prns)


def receive_and_fix(iq, fs: float, ref_week: int, n_ms: int | None = None,
                    measure_sample: int | None = None,
                    prns=range(1, 33), refine: bool = True,
                    verbose: bool = False):
    """Full receiver chain: acquire -> track -> decode -> fix.

    Returns (NavSolution, {prn: TrackResult}); the solution also
    carries a Doppler velocity solve as `sol.velocity` (VelSolution, or
    None if it failed).  `ref_week` resolves the
    broadcast 10-bit week.  `measure_sample` (default: 1 s in) is the
    common receiver epoch the pseudoranges are formed at; it must be
    late enough that every channel has frame-synced (>= 1 subframe into
    the stream) — transmit_time() covers any tracked sample, so the
    epoch itself only needs to be inside the tracked span.  `refine`
    applies the open-loop apex correction (refine_code_phase), removing
    most of the DLL's per-channel metre-level bias.
    """
    from .acquisition import _to_complex
    z = _to_complex(iq)            # convert the capture once for all PRNs
    n_per_code = int(round(fs * CA_SEQ_LEN / CODE_FREQ))
    if n_ms is None:
        n_ms = z.size // n_per_code - 2
    if measure_sample is None:
        measure_sample = int(round(fs))

    tracks: dict[int, TrackResult] = {}
    eph = None
    iono = None
    t_tx: dict[int, float] = {}
    for prn in prns:
        a = acquire(z, fs, prn)
        if not a.detected:
            continue
        tr = track(z, fs, prn, a, n_ms)
        try:
            frame_sync(tr)
        except ValueError:
            if verbose:
                print(f"PRN {prn:2d}: acquired but no frame sync")
            continue
        tracks[prn] = tr
        if tr.decoded:
            eph = build_ephemerides(tr.decoded, prn - 1, ref_week,
                                    eph_factory=eph)
            if iono is None and tr.decoded.get("sf4_page") == 56:
                iono = build_ionoutc(tr.decoded)
        t_tx[prn] = transmit_time(tr, measure_sample)
        if refine:
            t_tx[prn] += refine_code_phase(tr, z, measure_sample) \
                / CODE_FREQ
        if verbose:
            d = tr.decoded
            print(f"PRN {prn:2d}: tow={tr.tow} "
                  f"subframes={sorted(tr.subframes)} "
                  f"eph={'yes' if d else 'no'} lock={tr.locked_ratio:.2f}")
    if eph is None:
        raise ValueError("no channel decoded a full ephemeris")
    if iono is None:
        iono = build_ionoutc({})
    usable = {p: t for p, t in t_tx.items() if bool(eph.vflg[p - 1])}
    sol = solve_fix(eph, iono, usable)
    try:
        fd = {p: measured_doppler(tracks[p], measure_sample)
              for p in usable}
        sol.velocity = solve_velocity(eph, iono, fd, sol)
    except ValueError:
        sol.velocity = None
    return sol, tracks


def _main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Software GPS receiver for int16 interleaved IQ "
                    "(gps-sdr-sim / pluto_gps_sim_tpu_torch .bin layout)")
    ap.add_argument("binfile")
    ap.add_argument("--fs", type=float, default=2_600_000.0)
    ap.add_argument("--week", type=int, required=True,
                    help="reference GPS week (resolves the broadcast "
                         "10-bit week number)")
    ap.add_argument("--measure-sec", type=float, default=1.0,
                    help="receiver epoch for the fix, seconds into file")
    a = ap.parse_args(argv)

    iq = np.fromfile(a.binfile, dtype=np.int16)
    sol, tracks = receive_and_fix(
        iq, a.fs, a.week,
        measure_sample=int(round(a.measure_sec * a.fs)), verbose=True)
    from ..models.geodesy import xyz2llh
    from ..constants import R2D
    llh = np.asarray(xyz2llh(sol.xyz))
    print(f"\nFIX: ECEF {sol.xyz.round(1).tolist()} m")
    print(f"     LLH  {llh[0]*R2D:.6f} deg, {llh[1]*R2D:.6f} deg, "
          f"{llh[2]:.1f} m")
    print(f"     t_rx {sol.t_rx:.9f} s-of-week, "
          f"rms residual {sol.rms_residual:.2f} m, "
          f"{len(sol.prns)} SVs {sol.prns}")
    v = sol.velocity
    if v is not None:
        print(f"     VEL  {v.vel.round(3).tolist()} m/s "
              f"(|v| {float(np.linalg.norm(v.vel)):.3f}), "
              f"clk drift {v.cbdot:.3f} m/s, "
              f"rms rate residual {v.rms_residual:.3f} m/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
