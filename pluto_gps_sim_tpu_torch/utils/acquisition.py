"""Software GPS acquisition: validate that synthesized IQ is receivable.

A copy of the JAX package's ``utils/acquisition.py:1-150`` (numpy only; the
receiver never sees a device tensor).

The reference was validated end-to-end by feeding its RF output to a real
GPS receiver and checking it obtained a fix (its README describes the
attenuator/DC-block bench setup; there is no in-repo test).  This module
is the software equivalent of that receiver front-end: classic
parallel-code-phase FFT acquisition (1 ms coherent integration, circular
correlation against a local C/A replica over a Doppler grid).  It closes
the loop the golden A/B cannot: the oracle comparison proves we match the
reference bit-for-bit, this proves the signal itself carries each PRN at
the planned Doppler and code phase with receiver-usable correlation
margin — a wrong sign convention, conjugated carrier, or swapped I/Q
would pass a power-spectrum check but fail here.

Conventions (ops/synth_torch.py module docstring): complex baseband for a
channel is  bit(n)·chip(n)·gain·exp(+j·2π·(c0 + u·n)),  so acquisition
wipes the carrier with exp(-j·2π·f_d·t) and correlates against the ±1
chip replica.  At the flagship rates one C/A period is an integer number
of samples (2600 at fs=2.6 MHz, 3000 at 3 MHz), which makes the 1-period
circular correlation exact at zero code Doppler.

Numpy-only: runs on any host against IQ from any synthesis path or a
recorded .bin file (int16 interleaved, gps-sdr-sim layout).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import CA_SEQ_LEN, CODE_FREQ
from ..models.cacode import CA_TABLE

__all__ = ["AcqResult", "acquire", "acquire_all"]


@dataclass
class AcqResult:
    """One PRN's acquisition verdict."""

    prn: int
    detected: bool
    doppler_hz: float        # carrier Doppler at the correlation peak
    code_offset: float       # samples from IQ start to the next chip-0 edge
    metric: float            # peak power / mean power (diagnostic only)
    peak_ratio: float        # peak / strongest sidelobe outside ±1 chip
                             # on the winning Doppler row (the detector)

    def __repr__(self) -> str:  # compact, table-friendly
        return (f"AcqResult(prn={self.prn:2d} "
                f"{'HIT ' if self.detected else 'miss'} "
                f"dopp={self.doppler_hz:+7.1f} Hz "
                f"code@{self.code_offset:7.1f} samp "
                f"metric={self.metric:6.1f} ratio={self.peak_ratio:4.1f})")


def _to_complex(iq: np.ndarray, limit: int | None = None) -> np.ndarray:
    """[..., 2] int16 (or interleaved flat int16) -> flat complex128.

    Already-complex input passes through flattened (so callers that
    process many PRNs can convert a long capture once).  `limit` bounds
    the number of complex samples converted."""
    iq = np.asarray(iq)
    if np.iscomplexobj(iq):
        z = iq.reshape(-1)
        return z if limit is None else z[:limit]
    if iq.ndim >= 2 and iq.shape[-1] == 2:
        flat = iq.reshape(-1, 2)
    else:
        flat = iq.reshape(-1)[: iq.size // 2 * 2].reshape(-1, 2)
    if limit is not None:
        flat = flat[:limit]
    flat = flat.astype(np.float64)
    return flat[:, 0] + 1j * flat[:, 1]


def _replica_fft(prn: int, n_per_code: int, fs: float) -> np.ndarray:
    """conj(FFT) of one code period of the ±1 C/A replica at nominal rate."""
    n = np.arange(n_per_code, dtype=np.float64)
    chip = (n * (CODE_FREQ / fs)).astype(np.int64) % CA_SEQ_LEN
    r = (CA_TABLE[prn - 1][chip] * 2 - 1).astype(np.float64)
    return np.conj(np.fft.fft(r))


def acquire(iq: np.ndarray, fs: float, prn: int,
            doppler_max: float = 6000.0, doppler_step: float = 250.0,
            n_windows: int = 2, detect_ratio: float = 3.0) -> AcqResult:
    """Acquire one PRN from int16 IQ (any shape; first samples are used).

    Searches n_windows consecutive 1 ms windows (a nav-bit edge can land
    inside any single window and split its correlation energy; bits are
    20 ms so two adjacent windows cannot both straddle one) over a
    ±doppler_max Hz grid and returns the best window's peak.  detected
    requires peak_ratio >= detect_ratio: the peak against the strongest
    sidelobe outside ±1 chip on the winning Doppler row.  Calibrated on
    the 7-channel fixture scenario: present PRNs measure 4.5-23, absent
    ones <=2.4 (the peak/mean `metric` can NOT detect — the max of the
    ~10^5 search cells sits ~ln(cells)≈12x the mean for pure noise, the
    same order as a weak low-elevation channel; it is kept as a
    diagnostic only).
    """
    n_per_code = int(round(fs * CA_SEQ_LEN / CODE_FREQ))   # 1 ms of samples
    z = _to_complex(iq, limit=n_windows * n_per_code)
    if z.size < n_windows * n_per_code:
        raise ValueError(f"need >= {n_windows * n_per_code} samples "
                         f"({n_windows} ms at fs={fs:.0f}), got {z.size}")
    rep_f = _replica_fft(prn, n_per_code, fs)
    dopplers = np.arange(-doppler_max, doppler_max + 0.5 * doppler_step,
                         doppler_step)
    t = np.arange(n_per_code, dtype=np.float64) / fs

    # best = (peak_pow, doppler_idx, sample_idx, window, mean_pow, row_pow)
    best = None
    for w in range(n_windows):
        zw = z[w * n_per_code:(w + 1) * n_per_code]
        # wipe every Doppler at once: [D, L]
        y = zw[None, :] * np.exp(-2j * np.pi * dopplers[:, None] * t[None, :])
        corr = np.fft.ifft(np.fft.fft(y, axis=1) * rep_f[None, :], axis=1)
        p = np.abs(corr) ** 2
        d_i, n_i = np.unravel_index(int(np.argmax(p)), p.shape)
        pk = float(p[d_i, n_i])
        if best is None or pk > best[0]:
            best = (pk, d_i, int(n_i), w, float(np.mean(p)), p[d_i])

    pk, d_i, n0, w_best, mean_p, row = best
    # sidelobe floor on the winning Doppler row, excluding ±1 chip
    excl = max(1, int(round(fs / CODE_FREQ)))
    mask = np.ones(n_per_code, bool)
    mask[np.arange(n0 - excl, n0 + excl + 1) % n_per_code] = False
    side = float(row[mask].max()) if mask.any() else 0.0
    metric = pk / mean_p if mean_p > 0 else 0.0
    # pk == 0 means the IQ is silent (all-zero samples): report ratio 0,
    # NOT inf — otherwise a gain/mask bug that writes a silent file would
    # "detect" every PRN and --selfcheck would pass on exactly the
    # failure class it exists to catch
    ratio = (pk / side) if side > 0 else (np.inf if pk > 0 else 0.0)

    # the peak index is the code start within ITS window; chip-0 edges
    # repeat every code period, so it is also the offset from IQ start
    # modulo one period
    return AcqResult(prn=prn, detected=ratio >= detect_ratio,
                     doppler_hz=float(dopplers[d_i]), code_offset=float(n0),
                     metric=metric, peak_ratio=ratio)


def acquire_all(iq: np.ndarray, fs: float,
                prns=range(1, 33), **kw) -> list[AcqResult]:
    """Acquisition sweep over a set of PRNs (default: all 32)."""
    return [acquire(iq, fs, p, **kw) for p in prns]
